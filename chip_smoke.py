#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch`` and
builds the CUDA kernels from the sources there).  Phases, each fatal on
failure -- nothing is caught, and nothing falls back to a plain version:

1. The card: fail at once without CUDA; print ``nvidia-smi``'s name and
   power limit.
2. Build every kernel of the path with ``nvcc`` (sm_90a) and print the
   seconds it took.
3. Hold each q8 kernel bitwise against its plain PyTorch version on
   the card, at every layout the main paths give it (the codec's leaf
   layouts of qwen3-0.6b, rwkv6-3b, qwen2-moe-a2.7b and the last three
   families' paths of 9f; the ring's chunk layouts for
   4 positions, every chunk id), and time both with CUDA events (median
   of 20) at the largest qwen3-0.6b layout (the embedding's).  Hold the
   WKV6 forward and backward kernels against their plain versions
   within WKV_TOL (not bitwise: the sums run in another order) at the
   RWKV-6 path's shape, at a long T that no chunk divides, at T = 1, at
   one row and at 13, at every pair of head widths, with extreme decays,
   and forward with bf16 inputs; each twice, bitwise equal from call to
   call, and through views that start off a 16-byte boundary, bitwise
   equal to fresh tensors; print their registers, shared memory and spills from the
   build's ptxas report; time them at the path's shape.
3b. The q8 kernels at the layouts of the production layout and the MoE
   path (``phase_moe_pod_layouts``): the chunk quantize (both ids) and the
   accumulating dequant at every 2-position ring chunk of each
   qwen2-moe-a2.7b leaf, of each leaf of 9f's paths and of each
   ``model`` shard of each qwen3-0.6b
   leaf, the quantize and dequant at each shard's pod-stage tiles, all
   bitwise against the plain versions (the MoE leaf layouts themselves
   are phase 3's); each timed with its bound at the largest expert leaf
   (60 x 2048 x 1408) and its chunk, and at the largest and smallest
   pod-layout tile and chunk (the ``at_moe_pod_layouts`` rows of the
   ``kernels`` line).
4. Cross-check, for qwen3-0.6b (DIANA + q8) in the ``dense`` and the
   ``q8_ring_fused`` mode and for rwkv6-3b in ``dense``: one step of
   the smoke config on the card (kernels) and on the CPU (plain
   versions) from one state and one set of uniforms, drawn on the CPU
   by address (``HostNoise``); bits exactly,
   the loss to f32 precision, the shifts within a stated number of
   lattice steps and the params within 2 lr, each with a bound on the
   share of elements beyond f32 noise.
5. The dense main path: 3 steps of full-size qwen3-0.6b (float32)
   through ``init_state``/``build_train_step`` -- DIANA + the blockwise
   q8 codec + dense aggregation, 4 workers, batch 8, seq 128, AdamW lr
   3e-4.  Loss finite, ``bits`` equal to the structural count recomputed
   from the leaf shapes, and each kernel's launch count exactly what the
   leaves, workers and steps give.  (The step's phases are timed where
   they run, by the program's spans under the benchmark's profiler:
   ``perfbench/spans.py``.)
6. The ring main path: the same 3 steps in ``q8_ring_fused`` mode on a
   ``HostMesh(data=4)`` -- 4 ring positions on the one card -- with the
   same checks; the ring's launches are counted too (the chunk
   quantize, the accumulating dequant, the all-gather decode), and the
   params and shifts after the 3 steps digested leaf by leaf (9b).
7. The RWKV-6 main path: the same 3 dense steps of rwkv6-3b at full
   width and RWKV_LAYERS of its 32 layers, with the same checks; each
   layer launches one WKV6 forward and one backward per worker and step:
   in step 1 from the host, in steps 2-3 from the graph of a worker's
   pass (``dist.worker_grads``), counted as the capture's issues times
   the graph's launches.
8. The natural and top-k kernels (``shifted_natural_2d``,
   ``block_topk_2d``) bitwise against their plain versions at every
   qwen3-0.6b leaf layout their wrappers give (f32) and on an edge set
   (zeros, subnormals, NaN, infinities, powers of two and the floats just
   below them, bf16; for top-k also ties, a NaN in a block, k = 1, k = the
   whole block, a padded last block); both timed at the embedding leaf,
   and beside top-k its selection alone (``torch.topk`` of the
   magnitudes, a row a block: not the function); the top-k kernel's
   registers, shared memory and spills from ptxas.
   Cross-checks as in 4 for DIANA + ``natural``, for ``ef21`` +
   ``topk``, for the overlap runtime (``q8_ring_overlap`` with DIANA,
   ``efbv_overlap``), for the fused backward encode
   (``q8_ring_fused_vjp`` with DIANA), all three with the q8 codec over
   the 4-position ring, and for ``vr_gdci`` + ``randk`` (Algorithm 2:
   the round mixes the params, AdamW is bypassed).  And for
   qwen2-moe-a2.7b and deepseek-v2-lite-16b in ``q8_ring_fused`` with
   both their wires q8 (a flipped activation would carry through the
   rest of the step, so the card runs first, and the CPU compares its
   own encode of each wire send with the card's -- at most RARE_RING of
   the int8 elements flipped, none by more than one step, every scale
   within f32 noise -- and forwards the card's payloads: the rest of the
   step is held to the bounds of 4; the same check is then shown to
   catch a faulty card encode, one int8 row negated or one scale
   doubled, ``phase_wire_rehearsal``), for llava-next-34b (its vision
   prefix) dense, for
   zamba2-1.2b in ``q8_ring_fused`` and for seamless-m4t-large-v2
   dense.
9. Three more full-size qwen3-0.6b paths, 3 steps each with the checks
   of 5: DIANA + ``natural`` + dense (the reference's default
   configuration), ``ef21`` + ``topk`` (q = 0.1) and ``rand_diana``
   (p = 0.05) + ``randk`` (q = 0.1), whose bits add one dense f32
   message for each refresh drawn (the round's aux draws, counted).
   Then EF-BV + q8 in ``q8_ring_fused`` mode: 3 steps, the reference
   of ``efbv_overlap`` below.
9b. The overlap runtime and the fused backward encode at full size over
   the 4-position ring, 3 steps each with the checks of 5 (bits summed
   in the buckets' order, each q8 kernel's launches those of 6) and
   their bucket count: ``q8_ring_overlap`` (DIANA, the default 4 MiB
   buckets), ``efbv_overlap`` and ``q8_ring_fused_vjp`` (DIANA, one
   bucket per leaf).  After the 3 steps each path's params, shifts and
   master shift equal, by per-leaf SHA-256 digests of host copies,
   those of the ``q8_ring_fused`` path of its rule from the same seed
   (6, or 9's EF-BV run).
9c. The production layout and the rest of the step's communication,
   each 3 full-size qwen3-0.6b steps with the checks of 5:
   ``q8_ring_fused`` over ``HostMesh(pod=2, data=2, model=2)`` -- each
   ``model`` shard of a leaf its own ring of 2 positions, the pod stage
   a q8 encode and decode of each pod's sum -- its launches derived
   from the channel's specs before the run (``ring_counts``), then one
   more round run with the kernels and again with their plain versions
   in their place, bitwise equal (``phase_plain_round``: the kernels at
   every per-shard and pod-stage shape); ``HostMesh(pod=1, data=4)``
   bitwise the ``data=4`` ring by digests; ``randk_shared`` (q = 0.05)
   with DIANA + ``natural`` and the step's four diagnostics, its digests
   equal to the same run without them; the five codecs ported last, one
   uplink each over the 13 full-size leaves, bits the structural count
   (``BernoulliP``'s its fired messages, beside its expectation)
   (``phase_codecs``); and DIANA + ``natural_dithering`` (the paper's
   Fig. 1 ND) dense.
9d. The MoE family at full width (``MOE_LAYERS`` of qwen2-moe-a2.7b's
   24 layers: d_model 2048, 60 experts top-4 plus 4 shared, expert
   d_ff 1408, vocab 151,936, capacity factor 1.25, group size 4096 --
   1,192,890,368 params in 19 leaves), ``MOE_W`` workers over
   ``HostMesh(data=MOE_W)``, ``q8_ring_fused``, DIANA + ``q8_block``
   and both the moe and act wires q8, batch 8, seq 128 (512 tokens a
   worker: one group, capacity 48): the checks of 5 at those workers;
   each wire's bits a step (``Transport.per_wire_bits``) equal to the
   count from the shapes (``wire_bits_from_shapes``) and to the sends
   the steps made (counted); one more round held bitwise against its
   plain round
   (``phase_plain_round``).
9e. The dense 20-32B configs and the VLM at full width and
   CONFIG_LAYERS layer (``phase_configs``): internlm2-20b, qwen1.5-32b,
   qwen2.5-32b and llava-next-34b (seq 640: 576 prefix and 64 text
   positions), and seamless-m4t-large-v2 at full depth (24 + 24
   layers), one loss and backward each (finite), then 8 decode
   ticks against the forward within DECODE_TOL.
9f. The last three families at full width, each with the checks of 9d
   (``MOE_W`` workers over ``HostMesh(data=MOE_W)``, ``q8_ring_fused``,
   DIANA + ``q8_block``, batch 8, seq 128, one more round bitwise its
   plain round): deepseek-v2-lite-16b (MLA and MoE, 64
   experts top-6 plus 2 shared) cut to DEEPSEEK_LAYERS = 2 of its 27
   layers, its leading dense layer and one MoE layer (1,085,287,424
   params in 29 leaves), both wires q8 (512 tokens a worker: one group
   of capacity 64, an expert buffer (64, 64, 2048)); zamba2-1.2b at full
   depth, 38 Mamba-2 layers and the shared attention block after every
   6 (1,170,473,856 params in 21 leaves; seq 128 is one SSD chunk);
   seamless-m4t-large-v2 cut to SEAMLESS_LAYERS = 6 decoder and 6
   encoder layers (902,228,992 params in 26 leaves).  After each, its
   decode against the forward (``phase_family_decode``): MLA's absorbed
   decode against the expanded forward; zamba2 at 6 layers and one use
   of the shared block, 128 ticks of the sequential scan against the
   forward through one SSD chunk; seamless with its encoder keys and
   values filled from each layer's ``cross_attention_kv`` of the
   encoder's output.
10. The entry points of the two kernels, ``shifted_natural(rand, g, h)``
   and ``block_topk(g, q=0.1)``, over all 13 full-size qwen3-0.6b
   leaves, with g worker 0's gradient of a fourth step of the natural
   path and h its DIANA shift then: each kernel launched exactly 13
   times, every output bitwise equal to its plain version, and the
   natural output equal to ``h + NaturalCompression`` of ``g - h`` with
   the same uniforms wherever ``|g - h| >= 2^-126``.
11. The serve entry point (``launch.serve``, ``serving``): the CLI's
   greedy path on full-size qwen3-0.6b (batch 4, 16 + 32 ticks) with a
   ``q8_block`` model broadcast, each q8 kernel launched exactly once a
   leaf (13) and the broadcast's bits the structural count; its decode
   logits at every position against ``forward_train``'s within
   DECODE_TOL, and its greedy tokens against their argmax by the margin
   rule.  rwkv6-3b (full width, RWKV_LAYERS layers): the greedy path
   timed, every layer's WKV6 kernel forward held against the plain
   ``wkv_step`` chain on its inputs within WKV_TOL, decode against the
   forward in f64.  The engine: 6 requests over 2 slots, each output
   against the request decoded alone by the margin rule.  The delta
   stream at full size (qwen3-0.6b trainer, 1 worker, batch 4, seq 64,
   6 steps, a publish every 2 to 2 replicas, K = 4) for the dense, q8
   and natural model wires: bytes a publish the structural count, every
   replica bitwise the trainer (dense) or the publisher's ``h_bar`` by
   per-leaf digests.  Then the smoke ``run_fleet_demo`` of each wire
   against the structural row of the reference's ``BENCH_serve_delta``.
12. The convex path (``core.simulate``): the theorem tests' runs on the
   paper's ridge instance (m = 100, d = 80, 10 workers, noise 10) and
   Rand-DIANA on logistic regression (m = 300, d = 60), each with its
   test's step size and step count, on the card from a recorded
   ``GeneratorNoise``, timed with CUDA events over the run; each
   theorem's conclusion checked on the card's traces; each run then
   replayed on the CPU from the recorded draws and x0, its bits trace
   equal to the card's.  No kernel: the codecs are plain PyTorch, as
   the reference's are plain jnp.
13. Observability (``phase_obs``): the trainer CLI on full-size
   qwen3-0.6b (``q8_ring_fused``, DIANA + ``q8_block``, ``--mesh-data 4``,
   batch 8, seq 128, 2 steps) without and with ``--metrics_out --trace``:
   final params and shifts bitwise equal, the q8 launches exactly as the
   steps and the run header's probes give (the ``qwen3-0.6b train
   --metrics_out --trace`` entry of ``launches_by_path``); the JSONL
   through ``export --check``, the grad wire's bits and payload bytes
   the layouts' count, positive encode and decode seconds, ``omega_hat``
   within the q8 certificate, a hide fraction in [0, 1], a positive
   predicted step time, a step record a step and ``host/step`` around
   the step's spans; ``calibrate_rates`` no more than 1.05 x the card's
   f32 and memory peaks, ``calibrate_link``'s fit printed;
   ``tree_distortion`` of the q8 codec over the 13 W-stacked leaves
   bitwise equal with the kernels and with their plain versions; a
   checkpoint of the final state saved and restored onto the card
   bitwise equal.
14. The tuner (``phase_tune``): the trainer CLI on full-size qwen3-0.6b
   (DIANA + ``q8_block``, ``--mesh-data 4``, batch 8, seq 128, 2 steps)
   with ``--comm_mode auto``, a fresh ``--tune-cache`` and the full
   default grid.  The first run searches (``tune: searched``): one
   strict-JSON plan, at least one measured candidate, exactly one
   chosen, a finite predicted step time with a nonzero compute half (the
   dense step's cost pass at full width); its rows, the choice, the
   calibrated rates and link, the hide and omega probes and the pass's
   flops and bytes are printed, with each supplier's seconds.  The
   second run hits the cache (``tune: cache hit``) and calls no supplier
   and no measurement (counted by wrappers); a ``--tune-plan`` run (with
   ``--metrics_out``) and ``build_train_step`` with ``apply_plan`` run
   in-process end bitwise equal to it; the run record carries the plan's
   predicted step time, printed against the measured steps.  Then
   ``launch.dryrun`` of qwen3-0.6b x train_4k and qwen2-moe-a2.7b x
   decode_32k each end ``ok``, qwen3's ``useful_flops_frac`` in (0.3,
   1.05].  The searched run's launches are the ``qwen3-0.6b train
   --comm_mode auto`` entry of ``launches_by_path``.

The second-to-last line is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --wkv6-against OTHER.cu

runs only the card's phase and a comparison of two versions of the WKV6
kernels: ``OTHER.cu``, another version of
``src/repro_torch/kernels/wkv6/csrc/wkv6.cu`` with the same C interface
(an earlier commit's, written out with ``git show``), and the
checkout's.  At the RWKV-6 path's shape, at a quarter of its rows and at
half its K, both builds are held against the plain versions within
WKV_TOL, then timed in turns (other, this, this, other) with
``time_ms``; one JSON line a shape, then the card's name and power
limit.

    python3 chip_smoke.py --topk-against OTHER.cu [MORE.cu ...]

does the same for the top-k kernel: each ``OTHER.cu`` another version
of ``src/repro_torch/kernels/topk/csrc/topk.cu``; every build held
bitwise against the plain version (the embedding leaf, a 28-row block
layout, the edge set in f32 and bf16), then timed in turns (the others,
the checkout's twice, the others in reverse) at the embedding leaf
(1,215,488 x 128 f32, blocks of 64 rows, k = 819) and at 28-row blocks
(k = 358), beside ``clone()`` of the same tensor (a plain device copy
of the same bytes).
"""

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
W, BATCH, SEQ, STEPS, LR = 4, 8, 128, 3, 3e-4
RING = 4                    # positions of the emulated data axis
RWKV_LAYERS = 6             # rwkv6-3b's 32 layers cut to fit one 80 GB card
MOE_LAYERS = 1              # qwen2-moe-a2.7b's 24 layers cut to fit one card
MOE_W = 2                   # its workers (and ring positions): at 4 one
                            # layer's state would not fit 80 GB
CONFIG_LAYERS = 1           # the 20-34B configs' layers on the card
CONFIG_BATCH, CONFIG_TICKS = 2, 8
DEEPSEEK_LAYERS = 2         # deepseek-v2-lite-16b's 27 layers cut to its
                            # leading dense layer and one MoE layer
ZAMBA_LAYERS = 38           # zamba2-1.2b at full depth (cut, if at all, in
                            # multiples of its attn_every = 6)
SEAMLESS_LAYERS = 6         # seamless-m4t-large-v2's 24 + 24 layers cut to
                            # 6 + 6: at full depth W = 2 workers' shifts and
                            # AdamW would not fit 80 GB
ZAMBA_DECODE_TICKS = 128    # zamba2's decode against one SSD chunk
SLEEP_CYCLES = 1_000_000    # ~0.5 ms at the H100's clocks (time_ms)
WKV_TOL = 1e-4              # rtol and atol of the WKV6 kernels vs plain
                            # (du: atol relative to its largest entry)
WKV_LONG_T = 1003           # divided by neither the 8-step checkpoint chunk
                            # nor the forward's 16-step stage
TOPK_Q = 0.1                # keep fraction of the top-k codec and wrapper
TINY = 2.0 ** -126          # smallest normal f32
TOPK_OPS = 18               # block_topk_2d's integer operations an element


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, iters=20):
    """Median device time of ``fn`` over ``iters`` calls (CUDA events),
    after one warm-up call.  Each call's start event waits behind a
    sleeping kernel (~0.5 ms) while the host enqueues the call, so a call
    whose host side (checks, allocation, launch) is shorter than that is
    timed on the device alone."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bits_of(t):
    return t.contiguous().view(torch.int32)


def same_bits(a, b):
    """Elementwise (as f32): equal bit patterns, or both NaN (a NaN's
    payload is not part of any contract here)."""
    a, b = a.float(), b.float()
    return (bits_of(a) == bits_of(b)) | (a.isnan() & b.isnan())


def finite_err(a, b):
    """max |a - b| over the elements where both are finite (0 if none)."""
    a, b = a.float(), b.float()
    both = a.isfinite() & b.isfinite()
    return (a[both] - b[both]).abs().max().item() if both.any() else 0.0


def lanes(x, rows_pad):
    """``x`` flattened and zero-padded to the kernels' (rows_pad, 128)."""
    flat = x.reshape(-1)
    return torch.nn.functional.pad(
        flat, (0, rows_pad * 128 - flat.numel())).reshape(rows_pad, 128)


class HostNoise:
    """Uniforms drawn on the CPU by address (``AddressedNoise``, so in any
    order of the calls), handed to any device: the GPU and CPU runs of
    the cross-check consume identical draws."""

    def __init__(self, seed, device):
        from repro_torch.comm.wire import AddressedNoise

        self.source, self.device = AddressedNoise(seed, "cpu"), device

    def uniform(self, *args, **kw):
        return self.source.uniform(*args, **kw).to(self.device)

    def permutation(self, *args, **kw):
        return self.source.permutation(*args, **kw).to(self.device)

    def aux_uniform(self, shape):
        return self.source.aux_uniform(shape).to(self.device)

    def ring_uniform(self, *args):
        return self.source.ring_uniform(*args).to(self.device)

    def pod_uniform(self, *args):
        return self.source.pod_uniform(*args).to(self.device)

    def shared_permutation(self, *args):
        return self.source.shared_permutation(*args).to(self.device)

    def send_uniform(self, *args):
        return self.source.send_uniform(*args).to(self.device)

    def send_permutation(self, *args):
        return self.source.send_permutation(*args).to(self.device)

    @property
    def round(self):
        return self.source.round

    def stream(self, name):
        """A wire's stream (the moe and act wires' sends), drawn on the
        CPU too."""
        return HostNoise.of(self.source.stream(name), self.device)

    def at_round(self, r):
        return HostNoise.of(self.source.at_round(r), self.device)

    @classmethod
    def of(cls, source, device):
        out = cls.__new__(cls)
        out.source, out.device = source, device
        return out

    def next_round(self):
        self.source.next_round()


def phase_card():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return card


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    secs = time.perf_counter() - t0
    log(f"build: {len(_build.SOURCES)} CUDA source(s) in {secs:.2f} s")
    for name, report in _build.BUILD_LOG.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def main_path_layouts(cfg):
    """{(rows_pad, block)} of every leaf of the main path, largest first."""
    from repro_torch.kernels.q8ring.ops import DEFAULT_BLOCK_ROWS, q8_layout
    from repro_torch.models.model import param_specs

    layouts = {}
    for _, shape, _ in param_specs(cfg):
        _, block, rows_pad = q8_layout(math.prod(shape), DEFAULT_BLOCK_ROWS)
        layouts[(rows_pad, block)] = None
    return sorted(layouts, reverse=True)


def ring_layouts(cfg):
    """{(rows_c, block)} of every leaf's ring chunk at RING positions,
    largest first."""
    from repro_torch.kernels.q8ring.ops import ring_chunk_layout
    from repro_torch.models.model import param_specs

    return sorted({ring_chunk_layout(math.prod(shape), RING)
                   for _, shape, _ in param_specs(cfg)}, reverse=True)


def phase_kernels(cfg, also=()):
    """The codec kernels bitwise against their plain versions at every
    leaf layout of ``cfg`` and of the configs in ``also``; timed at
    ``cfg``'s largest."""
    from repro_torch.kernels.q8ring import kernel as K
    from repro_torch.kernels.q8ring.ref import (q8_dequant_add_ref,
                                                q8_quantize_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    layouts = sorted({lay for c in (cfg, *also)
                      for lay in main_path_layouts(c)}, reverse=True)
    errs = {"q8_quantize_2d": 0.0, "q8_dequant_add_2d": 0.0}
    for rows, block in layouts:
        x = torch.randn((rows, 128), generator=gen, device=dev) * 0.02
        x[:block] = 0.0                         # one all-zero tile
        u = torch.rand((rows, 128), generator=gen, device=dev)
        q, s = K.q8_quantize_2d(x, u, block_rows=block)
        qr, sr = q8_quantize_ref(x, u, block=block)
        torch.cuda.synchronize()
        check(torch.equal(q, qr) and torch.equal(bits_of(s), bits_of(sr)),
              f"q8_quantize_2d differs from its plain version at "
              f"({rows}, 128) block {block}")
        errs["q8_quantize_2d"] = max(
            errs["q8_quantize_2d"],
            (q.int() - qr.int()).abs().max().item(),
            (s - sr).abs().max().item())
        acc = torch.randn((rows, 128), generator=gen, device=dev)
        for a in (None, acc):
            out = K.q8_dequant_add_2d(q, s, a, block_rows=block)
            ref = q8_dequant_add_ref(q, s, a, block=block)
            torch.cuda.synchronize()
            check(torch.equal(bits_of(out), bits_of(ref)),
                  f"q8_dequant_add_2d (acc={'yes' if a is not None else 'no'})"
                  f" differs from its plain version at ({rows}, 128) block "
                  f"{block}")
            errs["q8_dequant_add_2d"] = max(errs["q8_dequant_add_2d"],
                                            (out - ref).abs().max().item())
        log(f"kernels: bitwise equal to plain at ({rows}, 128) block {block}")
        del x, u, q, s, qr, sr, acc, out, ref

    # timing at cfg's largest layout (qwen3-0.6b's tied embedding)
    rows, block = main_path_layouts(cfg)[0]
    n = rows * 128
    nb = rows // block
    x = torch.randn((rows, 128), generator=gen, device=dev) * 0.02
    u = torch.rand((rows, 128), generator=gen, device=dev)
    acc = torch.randn((rows, 128), generator=gen, device=dev)
    q, s = K.q8_quantize_2d(x, u, block_rows=block)

    # the one PyTorch call that computes decode's form (no accumulator):
    # int8 promotes to f32 exactly, then one rounded product per element
    def deq_library():
        return torch.mul(q.view(nb, block * 128), s)

    lib = deq_library().view(rows, 128)
    deq = K.q8_dequant_add_2d(q, s, None, block_rows=block)
    torch.cuda.synchronize()
    check(torch.equal(bits_of(lib), bits_of(deq)),
          "torch.mul(q, scale) differs from q8_dequant_add_2d without an "
          "accumulator")
    del lib, deq
    t = {
        "quant": time_ms(lambda: K.q8_quantize_2d(x, u, block_rows=block)),
        "quant_plain": time_ms(lambda: q8_quantize_ref(x, u, block=block)),
        "deq": time_ms(lambda: K.q8_dequant_add_2d(q, s, None,
                                                   block_rows=block)),
        "deq_plain": time_ms(lambda: q8_dequant_add_ref(q, s, None,
                                                        block=block)),
        "deq_library": time_ms(deq_library),
        "deq_acc": time_ms(lambda: K.q8_dequant_add_2d(q, s, acc,
                                                       block_rows=block)),
        "deq_acc_plain": time_ms(lambda: q8_dequant_add_ref(q, s, acc,
                                                            block=block)),
    }
    # bytes: each input read once, each output written once
    qb, qby = bound_ms(9 * n + 4 * nb, 7 * n)       # abs,max,div,floor,sub,cmp,add
    db, dby = bound_ms(5 * n + 4 * nb, n)           # one multiply
    dab, _ = bound_ms(9 * n + 4 * nb, 2 * n)        # one fma
    log(f"timing at ({rows}, 128) block {block}, median of 20 (ms): "
        f"quantize {t['quant']:.4f} (plain {t['quant_plain']:.4f}, bound "
        f"{qb:.4f}, no library call); dequant without accumulator "
        f"{t['deq']:.4f} (plain {t['deq_plain']:.4f}, library torch.mul "
        f"{t['deq_library']:.4f} bitwise equal, bound {db:.4f}); dequant "
        f"with accumulator {t['deq_acc']:.4f} (plain "
        f"{t['deq_acc_plain']:.4f}, bound {dab:.4f}, no library call)")
    del x, u, acc, q, s
    torch.cuda.empty_cache()
    return [
        {"name": "q8_quantize_2d", "route": "cuda",
         "source": "src/repro_torch/kernels/q8ring/csrc/q8ring.cu",
         "replaces": "src/repro/kernels/q8ring/kernel.py:75",
         "max_abs_err": errs["q8_quantize_2d"], "ms": t["quant"],
         "plain_ms": t["quant_plain"], "bound_ms": qb, "bound_by": qby,
         "library_ms": None},
        {"name": "q8_dequant_add_2d", "route": "cuda",
         "source": "src/repro_torch/kernels/q8ring/csrc/q8ring.cu",
         "replaces": "src/repro/kernels/q8ring/kernel.py:136",
         "max_abs_err": errs["q8_dequant_add_2d"], "ms": t["deq"],
         "plain_ms": t["deq_plain"], "bound_ms": db, "bound_by": dby,
         "library_ms": t["deq_library"]},
    ]


def phase_ring_kernels(cfg):
    """The ring's hop kernels at every ring chunk layout of the main
    path: the chunk quantize at every chunk id, and the dequant with an
    accumulator (the receive side), bitwise against their plain
    versions; then the chunk quantize timed at the embedding's chunk."""
    from repro_torch.kernels.q8ring import kernel as K
    from repro_torch.kernels.q8ring.ref import (q8_dequant_add_ref,
                                                q8_quantize_chunk_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    layouts = ring_layouts(cfg)
    ids = torch.arange(RING, dtype=torch.int32, device=dev)
    err = 0.0
    for rows, block in layouts:
        chunks = torch.randn((RING, rows, 128), generator=gen, device=dev)
        chunks *= 0.02
        chunks[1, :block] = 0.0                 # one all-zero tile
        u = torch.rand((rows, 128), generator=gen, device=dev)
        acc = torch.randn((rows, 128), generator=gen, device=dev)
        for cid in range(RING):
            q, s = K.q8_quantize_chunk_3d(chunks, u, ids[cid:cid + 1],
                                          block_rows=block)
            qr, sr = q8_quantize_chunk_ref(chunks, u, cid, block=block)
            torch.cuda.synchronize()
            check(torch.equal(q, qr) and torch.equal(bits_of(s), bits_of(sr)),
                  f"q8_quantize_chunk_3d differs from its plain version at "
                  f"({RING}, {rows}, 128) block {block} chunk {cid}")
            err = max(err, (q.int() - qr.int()).abs().max().item(),
                      (s - sr).abs().max().item())
            out = K.q8_dequant_add_2d(q, s, acc, block_rows=block)
            ref = q8_dequant_add_ref(q, s, acc, block=block)
            torch.cuda.synchronize()
            check(torch.equal(bits_of(out), bits_of(ref)),
                  f"q8_dequant_add_2d (acc=yes) differs from its plain "
                  f"version at ({rows}, 128) block {block}")
        log(f"ring kernels: bitwise equal to plain at ({RING}, {rows}, 128) "
            f"block {block}, chunk ids 0..{RING - 1}")
        del chunks, u, acc, q, s, qr, sr, out, ref

    rows, block = layouts[0]
    n = rows * 128
    nb = rows // block
    chunks = torch.randn((RING, rows, 128), generator=gen, device=dev) * 0.02
    u = torch.rand((rows, 128), generator=gen, device=dev)
    acc = torch.randn((rows, 128), generator=gen, device=dev)
    cid = 2
    q, s = K.q8_quantize_chunk_3d(chunks, u, ids[cid:cid + 1],
                                  block_rows=block)
    t = {
        "chunk": time_ms(lambda: K.q8_quantize_chunk_3d(
            chunks, u, ids[cid:cid + 1], block_rows=block)),
        "chunk_plain": time_ms(lambda: q8_quantize_chunk_ref(
            chunks, u, cid, block=block)),
        # the same tiles through the 2-D kernel: what the chunk read costs
        "quant_2d": time_ms(lambda: K.q8_quantize_2d(
            chunks[cid], u, block_rows=block)),
        # the receive side at the same chunk
        "deq_acc": time_ms(lambda: K.q8_dequant_add_2d(q, s, acc,
                                                       block_rows=block)),
    }
    # the card does not raise on an id outside [0, n): it reads nothing and
    # writes q = 0 and NaN scales
    q, s = K.q8_quantize_chunk_3d(
        chunks, u, torch.tensor([RING], dtype=torch.int32, device=dev),
        block_rows=block)
    check(not q.any().item() and s.isnan().all().item(),
          "q8_quantize_chunk_3d with an id out of range did not give q = 0 "
          "and NaN scales")
    # bytes: the chunk, u and the id read once, q and the scales written once
    cb, cby = bound_ms(9 * n + 4 * nb + 4, 7 * n)
    dab, _ = bound_ms(9 * n + 4 * nb, 2 * n)
    log(f"timing at the ring chunk ({RING}, {rows}, 128) block {block}, "
        f"median of 20 (ms): chunk quantize {t['chunk']:.4f} (plain "
        f"{t['chunk_plain']:.4f}, bound {cb:.4f}, no library call); "
        f"q8_quantize_2d on the same chunk {t['quant_2d']:.4f}; dequant "
        f"with accumulator {t['deq_acc']:.4f} (bound {dab:.4f})")
    del chunks, u, acc, q, s
    torch.cuda.empty_cache()
    return {"name": "q8_quantize_chunk_3d", "route": "cuda",
            "source": "src/repro_torch/kernels/q8ring/csrc/q8ring.cu",
            "replaces": "src/repro/kernels/q8ring/kernel.py:98",
            "max_abs_err": err, "ms": t["chunk"],
            "plain_ms": t["chunk_plain"], "bound_ms": cb, "bound_by": cby,
            "library_ms": None}


def _time_q8(K, plain, x, u, block):
    """quantize and dequant (without and with an accumulator) of one
    (rows, 128) layout: {name: (ms, plain ms, bound ms, bound by)}."""
    qref, dref = plain
    rows = x.shape[0]
    n, nb = rows * 128, rows // block
    acc = torch.randn_like(x)
    q, s = K.q8_quantize_2d(x, u, block_rows=block)
    out = {
        "q8_quantize_2d": (
            time_ms(lambda: K.q8_quantize_2d(x, u, block_rows=block)),
            time_ms(lambda: qref(x, u, block=block)),
            *bound_ms(9 * n + 4 * nb, 7 * n)),
        "q8_dequant_add_2d": (
            time_ms(lambda: K.q8_dequant_add_2d(q, s, None, block_rows=block)),
            time_ms(lambda: dref(q, s, None, block=block)),
            *bound_ms(5 * n + 4 * nb, n)),
        "q8_dequant_add_2d acc": (
            time_ms(lambda: K.q8_dequant_add_2d(q, s, acc, block_rows=block)),
            time_ms(lambda: dref(q, s, acc, block=block)),
            *bound_ms(9 * n + 4 * nb, 2 * n)),
    }
    del acc, q, s
    return out


def phase_moe_pod_layouts(moe, qwen, also=()):
    """The q8 kernels at the layouts of the MoE path and of the pod
    layout (phase 9c), bitwise against their plain versions: the chunk quantize (at
    both chunk ids) and the accumulating dequant at every 2-position
    ring chunk -- of each leaf of ``moe`` and of the configs in ``also``
    (the 2-worker paths over ``HostMesh(data=2)``) and of
    each ``model`` shard of each qwen3-0.6b leaf (``HostMesh(pod=2,
    data=2, model=2)``) -- and the quantize and the dequant (without and
    with an accumulator) at each shard's pod-stage tiles (the MoE leaf
    layouts are ``phase_kernels``').  Then each timed with its bound at
    the largest expert leaf and its 2-position chunk, and at the largest
    and the smallest pod-layout chunk and tile.  Returns ``{kernel name:
    [{"at", "ms", "plain_ms", "bound_ms", "bound_by"}, ...]}``."""
    from repro_torch.dist.sharding import worker_stacked_pspecs
    from repro_torch.kernels.q8ring import kernel as K
    from repro_torch.kernels.q8ring.ops import q8_layout, ring_chunk_layout
    from repro_torch.kernels.q8ring.ref import (q8_dequant_add_ref,
                                                q8_quantize_chunk_ref,
                                                q8_quantize_ref)
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.train import params_like
    from repro_torch.models.model import param_specs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    pod = HostMesh(pod=2, data=2, model=2, device=dev)
    like = params_like(qwen)
    shard_d = []
    for k, spec in worker_stacked_pspecs(pod, like, W).items():
        d = math.prod(like[k].shape)
        shard_d.append(d // 2 if any(a is not None for a in spec[1:]) else d)
    moe_d = {path: math.prod(shape) for path, shape, _ in param_specs(moe)}
    two = [math.prod(shape) for c in also for _, shape, _ in param_specs(c)]
    chunks = sorted({ring_chunk_layout(d, 2)
                     for d in list(moe_d.values()) + two + shard_d},
                    reverse=True)
    tiles = sorted({(q8_layout(d)[2], q8_layout(d)[1]) for d in shard_d},
                   reverse=True)
    ids = torch.arange(2, dtype=torch.int32, device=dev)
    for rows, block in chunks:
        c = torch.randn((2, rows, 128), generator=gen, device=dev) * 0.02
        c[0, :block] = 0.0                      # one all-zero tile
        u = torch.rand((rows, 128), generator=gen, device=dev)
        acc = torch.randn((rows, 128), generator=gen, device=dev)
        for cid in range(2):
            q, sc = K.q8_quantize_chunk_3d(c, u, ids[cid:cid + 1],
                                           block_rows=block)
            qr, sr = q8_quantize_chunk_ref(c, u, cid, block=block)
            out = K.q8_dequant_add_2d(q, sc, acc, block_rows=block)
            ref = q8_dequant_add_ref(q, sc, acc, block=block)
            torch.cuda.synchronize()
            check(torch.equal(q, qr) and torch.equal(bits_of(sc),
                                                     bits_of(sr))
                  and torch.equal(bits_of(out), bits_of(ref)),
                  f"a q8 ring kernel differs from its plain version at the "
                  f"2-position chunk (2, {rows}, 128) block {block} id {cid}")
        del c, u, acc, q, sc, qr, sr, out, ref
    for rows, block in tiles:
        x = torch.randn((rows, 128), generator=gen, device=dev) * 0.02
        u = torch.rand((rows, 128), generator=gen, device=dev)
        q, sc = K.q8_quantize_2d(x, u, block_rows=block)
        qr, sr = q8_quantize_ref(x, u, block=block)
        check(torch.equal(q, qr) and torch.equal(bits_of(sc), bits_of(sr)),
              f"q8_quantize_2d differs from plain at the pod tile ({rows}, "
              f"128) block {block}")
        for a in (None, torch.randn_like(x)):
            check(torch.equal(bits_of(K.q8_dequant_add_2d(
                q, sc, a, block_rows=block)), bits_of(q8_dequant_add_ref(
                    q, sc, a, block=block))),
                f"q8_dequant_add_2d differs from plain at the pod tile "
                f"({rows}, 128) block {block}")
        del x, u, q, sc, qr, sr
    log(f"moe/pod layouts: the q8 kernels bitwise equal to plain at "
        f"{len(chunks)} 2-position ring chunk layouts (both ids) and "
        f"{len(tiles)} pod-stage tile layouts")

    out = {"q8_quantize_2d": [], "q8_dequant_add_2d": [],
           "q8_quantize_chunk_3d": []}

    def row(name, at, t):
        ms, plain_ms, b, by = t
        if name.endswith(" acc"):
            at += ", with an accumulator"
        rec = {"at": at, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
               "bound_by": by}
        out[name.split(" ")[0]].append(rec)
        log(f"moe/pod layouts: {name} at {at}: {ms:.4f} ms (plain "
            f"{plain_ms:.4f}, bound {b:.4f} by {by}, {b / ms:.0%} of it)")

    expert = max((d, p) for p, d in moe_d.items() if "/moe/w_" in p)
    plain = (q8_quantize_ref, q8_dequant_add_ref)
    for what, d in ((f"the expert leaf {expert[1]} ({expert[0]:,})",
                     expert[0]),
                    ("the largest pod tile", max(shard_d)),
                    ("the smallest pod tile", min(shard_d))):
        _, block, rows = q8_layout(d)
        x = torch.randn((rows, 128), generator=gen, device=dev) * 0.02
        u = torch.rand((rows, 128), generator=gen, device=dev)
        for name, t in _time_q8(K, plain, x, u, block).items():
            row(name, f"{what}, ({rows}, 128) block {block}", t)
        del x, u
    for what, d in ((f"the expert leaf's 2-position chunk", expert[0]),
                    ("the largest pod chunk", max(shard_d)),
                    ("the smallest pod chunk", min(shard_d))):
        rows, block = ring_chunk_layout(d, 2)
        n, nb = rows * 128, rows // block
        c = torch.randn((2, rows, 128), generator=gen, device=dev) * 0.02
        u = torch.rand((rows, 128), generator=gen, device=dev)
        t = (time_ms(lambda: K.q8_quantize_chunk_3d(c, u, ids[1:2],
                                                    block_rows=block)),
             time_ms(lambda: q8_quantize_chunk_ref(c, u, 1, block=block)),
             *bound_ms(9 * n + 4 * nb + 4, 7 * n))
        row("q8_quantize_chunk_3d", f"{what}, (2, {rows}, 128) block "
                                    f"{block}", t)
        del c, u
    torch.cuda.empty_cache()
    return out


def wkv6_inputs(gen, bh, t, dk, dv):
    """f32 unit-normal r, k, v, u and decays exp(-exp(N(0, 1))), as the
    reference's kernel test draws them."""
    dev = torch.device("cuda")

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = normal(bh, t, dk), normal(bh, t, dk), normal(bh, t, dv)
    return r, k, v, torch.exp(-torch.exp(normal(bh, t, dk))), normal(bh, dk)


def _wkv_compare(what, got, ref, *, summed_over_t=False):
    """|got - ref| <= WKV_TOL (1 + |ref|) elementwise; for an output that
    sums T f32 terms (``du``, whose rounding grows with T and whose small
    elements sit far below the magnitude summed) WKV_TOL (|ref| + max
    |ref|) instead.  Returns (max |diff|, max |diff| / allowed)."""
    d = (got - ref).abs()
    atol = ref.abs().max() if summed_over_t else 1.0
    allowed = WKV_TOL * (ref.abs() + atol)
    worst = (d / allowed).max().item()
    form = "|plain| + max |plain|" if summed_over_t else "1 + |plain|"
    check(worst <= 1.0, f"{what}: |kernel - plain| beyond {WKV_TOL} ({form})"
                        f": worst ratio {worst:.3f}, max |diff| "
                        f"{d.max().item():.3e}")
    return d.max().item(), worst


def extreme_decays(w):
    """``w`` with its first five rows' decays set to the recurrence's
    extremes: all 0, all 1e-30 (a product far below 1 but normal), all 1 -
    2^-24 (the largest f32 below 1), all 1 (no decay), and the four mixed
    along K in one row."""
    values = torch.tensor([0.0, 1e-30, 1.0 - 2.0 ** -24, 1.0],
                          device=w.device)
    w = w.clone()
    for row, x in enumerate(values):
        w[row] = x
    w[4] = values.repeat(w.shape[-1] // 4)
    return w


def ptxas_report(log_text):
    """``[(kernel, registers, spill stores, spill loads, smem bytes)]`` for
    every entry function that ``nvcc -Xptxas=-v`` reported in
    ``log_text``, its name shortened to ``name<K, V[, type]>``."""
    import re

    out, name, spills = [], None, (None, None)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw = m.group(1)
            head = raw.split("EEv")[0]           # the template arguments
            base = re.search(r"\d+((?:wkv6_\w+?|block_topk)_kernel)I",
                             head)
            args = re.findall(r"Li(\d+)E", head)
            kind = ("bf16" if "bfloat16" in head or "BF16" in head
                    else "f32" if "wkv6_fwd" in head or "F32" in head
                    else "")
            name = (f"{base.group(1)}<{', '.join(args + ([kind] if kind else []))}>"
                    if base else raw)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spills,
                        int(m.group(2) or 0)))
            name, spills = None, (None, None)
    return out


def wkv6_bwd_smem_bytes(dk, dv):
    """Dynamic shared memory of a backward block, as ``bwd_smem_floats``
    in wkv6.cu lays it out: two stages of inputs, the row and the column
    partials of a checkpoint chunk, two scalars a step and ``u``."""
    c = 8                                       # kCkptEvery
    col_pitch = (dv + 31) // 32 * 32 + 16
    floats = (2 * c * (3 * dk + 2 * dv) + c * 3 * (dv // 4) * (dk + 8)
              + c * (dk // 2) * col_pitch + 2 * c + dk)
    return 4 * floats


def misaligned(x):
    """A copy of ``x`` in a view whose data starts one element past a
    16-byte boundary."""
    view = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return view.view(x.shape).copy_(x)


def phase_wkv6_kernels(cfg):
    """The WKV6 forward and backward kernels against their plain versions
    on the card: at the main path's shape (one worker's batch times the
    heads, SEQ steps, f32), at a long T that no chunk divides, at T = 1,
    at one row and at a row count no block split divides, at every pair
    of built head widths (K, V), with and without a final-state gradient,
    with extreme decays, and forward with bf16 inputs; each kernel run
    twice on the same inputs must give the same bits, and views that start
    off a 16-byte boundary the same bits as fresh tensors.  Then both
    timed at the path's shape."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import kernel as WK
    from repro_torch.kernels.wkv6.ref import (wkv6_bwd_ref, wkv6_fwd_ref,
                                              wkv6_ref)

    if "wkv6" in _build.BUILD_LOG:
        for name, regs, st, ld, smem in ptxas_report(_build.BUILD_LOG["wkv6"]):
            log(f"wkv6 ptxas: {name}: {regs} registers, {smem} bytes static "
                f"smem, spill stores {st} B, spill loads {ld} B")
    else:
        log("wkv6 ptxas: the library was built before this run; no report")
    log("wkv6 backward dynamic shared memory (bytes a block): " + ", ".join(
        f"<{dk}, {dv}> {wkv6_bwd_smem_bytes(dk, dv)}"
        for dk in WK.DIMS for dv in WK.DIMS))
    gen = torch.Generator(device="cuda").manual_seed(2)
    hd = cfg.rwkv_head_dim
    bh = BATCH // W * (cfg.d_model // hd)
    # (rows, T, K, V, final-state gradient, extreme decays)
    cases = [(bh, SEQ, hd, hd, False, False), (bh, WKV_LONG_T, hd, hd, True,
                                                False),
             (bh, SEQ, hd, hd, True, True), (1, SEQ, hd, hd, True, False),
             (13, 37, hd, hd, False, True), (5, 1, hd, hd, True, False),
             (2, 1, 16, 32, False, False)]
    cases += [(3 + n, 29 + 6 * n, dk, dv, n % 2 == 1, n == 4)
              for n, (dk, dv) in enumerate(
                  (dk, dv) for dk in WK.DIMS for dv in WK.DIMS)]
    err = {"wkv6_forward": 0.0, "wkv6_backward": 0.0}
    worst = dict(err)
    for n_bh, t, dk, dv, with_ds, extreme in cases:
        r, k, v, w, u = wkv6_inputs(gen, n_bh, t, dk, dv)
        if extreme:
            w = extreme_decays(w)
        y, s, ckpt = WK.wkv6_forward(r, k, v, w, u, checkpoints=True)
        yr, sr, cr = wkv6_fwd_ref(r, k, v, w, u, checkpoints=True)
        dy = torch.randn((n_bh, t, dv), generator=gen, device="cuda")
        ds = (torch.randn((n_bh, dk, dv), generator=gen, device="cuda")
              if with_ds else None)
        grads = WK.wkv6_backward(r, k, v, w, u, ckpt, dy, ds)
        grads_ref = wkv6_bwd_ref(r, k, v, w, u, dy, ds)
        again = (*WK.wkv6_forward(r, k, v, w, u, checkpoints=True),
                 *WK.wkv6_backward(r, k, v, w, u, ckpt, dy, ds))
        torch.cuda.synchronize()
        shape = (f"(BH={n_bh}, T={t}, K={dk}, V={dv}"
                 f"{', extreme decays' if extreme else ''})")
        for name, a, b in zip(("y", "s_final", "ckpt", "dr", "dk", "dv",
                               "dw", "du"), (y, s, ckpt, *grads), again):
            check(bool(same_bits(a, b).all()),
                  f"wkv6 {name} at {shape}: two calls on the same inputs "
                  f"gave different bits")
        for name, kind, got, ref in [
                ("y", "wkv6_forward", y, yr),
                ("s_final", "wkv6_forward", s, sr),
                ("ckpt", "wkv6_forward", ckpt, cr),
                *((f"d{x}", "wkv6_backward", g, gr)
                  for x, g, gr in zip("rkvwu", grads, grads_ref))]:
            e, q = _wkv_compare(f"{kind} {name} at {shape}", got, ref,
                                summed_over_t=name == "du")
            err[kind] = max(err[kind], e)
            worst[kind] = max(worst[kind], q)
        rb, kb, vb, wb = (x.to(torch.bfloat16) for x in (r, k, v, w))
        yb, sb, _ = WK.wkv6_forward(rb, kb, vb, wb, u)
        ybr, sbr = wkv6_ref(rb, kb, vb, wb, u)
        torch.cuda.synchronize()
        for name, got, ref in (("y", yb, ybr), ("s_final", sb, sbr)):
            e, q = _wkv_compare(f"wkv6_forward bf16 {name} at {shape}", got,
                                ref)
            err["wkv6_forward"] = max(err["wkv6_forward"], e)
            worst["wkv6_forward"] = max(worst["wkv6_forward"], q)
        log(f"wkv6 kernels: within {WKV_TOL} (1 + |plain|; du: |plain| + "
            f"max |plain|) of plain at {shape}, f32 forward + backward"
            f"{' with a final-state gradient' if with_ds else ''}, bf16 "
            f"forward; bitwise equal over two calls")
    log(f"wkv6 kernels: largest |kernel - plain| forward "
        f"{err['wkv6_forward']:.3e} ({worst['wkv6_forward']:.3f} of the "
        f"tolerance), backward {err['wkv6_backward']:.3e} "
        f"({worst['wkv6_backward']:.3f} of it)")

    # views that start off a 16-byte boundary: the wrappers copy them and
    # launch the kernels as usual, to the same bits
    r, k, v, w, u = wkv6_inputs(gen, bh, SEQ, hd, hd)
    dy = torch.randn((bh, SEQ, hd), generator=gen, device="cuda")
    y, s, ckpt = WK.wkv6_forward(r, k, v, w, u, checkpoints=True)
    grads = WK.wkv6_backward(r, k, v, w, u, ckpt, dy)
    mr, mk, mv, mw, mckpt, mdy = map(misaligned, (r, k, v, w, ckpt, dy))
    got = (*WK.wkv6_forward(mr, mk, mv, mw, u, checkpoints=True),
           *WK.wkv6_backward(mr, mk, mv, mw, u, mckpt, mdy))
    for name, a, b in zip(("y", "s_final", "ckpt", "dr", "dk", "dv", "dw",
                           "du"), (y, s, ckpt, *grads), got):
        check(bool(same_bits(a, b).all()),
              f"wkv6 {name}: misaligned views gave other bits")
    log("wkv6 kernels: views 4 bytes off a 16-byte boundary give the same "
        "bits as fresh tensors")
    del y, s, grads, mr, mk, mv, mw, mckpt, mdy, got

    # timing at the path's shape: the forward as training runs it (saving
    # its checkpoints), the backward from them
    t = {
        "fwd": time_ms(lambda: WK.wkv6_forward(r, k, v, w, u,
                                               checkpoints=True)),
        "fwd_plain": time_ms(lambda: wkv6_ref(r, k, v, w, u)),
        "bwd": time_ms(lambda: WK.wkv6_backward(r, k, v, w, u, ckpt, dy)),
        "bwd_plain": time_ms(lambda: wkv6_bwd_ref(r, k, v, w, u, dy)),
    }
    # bytes: r, k, v, w, u read once and y, s_final written once (forward);
    # r, k, v, w, u, dy read once and dr, dk, dv, dw, du written once
    # (backward).  Operations (an fma is 2): forward, per state element
    # and step, k v 1, r (.) S 2, w S + kv 2: 5, and per step the bonus
    # as one scalar, (sum_i r_i u_i k_i) v_j: 3 K + 2 V; backward, per
    # state element and step, the state recompute 3, the three sums over
    # j 6, the dv partial 1, dS 3, the sum over i 1: 14.
    seq = bh * SEQ * hd * 4
    n_state = bh * SEQ * hd * hd
    fb, fby = bound_ms(5 * seq + bh * hd * 4 + bh * hd * hd * 4,
                       5 * n_state + bh * SEQ * (3 * hd + 2 * hd))
    bb, bby = bound_ms(9 * seq + 2 * bh * hd * 4, 14 * n_state)
    log(f"wkv6 timing at (BH={bh}, T={SEQ}, K=V={hd}) f32, median of 20 "
        f"(ms): forward {t['fwd']:.4f} (plain {t['fwd_plain']:.4f}, bound "
        f"{fb:.4f} by {fby}); backward {t['bwd']:.4f} (plain "
        f"{t['bwd_plain']:.4f}, bound {bb:.4f} by {bby}); no single "
        f"PyTorch call computes either")
    del r, k, v, w, u, dy, ckpt
    torch.cuda.empty_cache()
    src = "src/repro_torch/kernels/wkv6/csrc/wkv6.cu"
    return [
        {"name": "wkv6_forward", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/wkv6/kernel.py:68",
         "max_abs_err": err["wkv6_forward"], "ms": t["fwd"],
         "plain_ms": t["fwd_plain"], "bound_ms": fb, "bound_by": fby,
         "library_ms": None},
        {"name": "wkv6_backward", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/wkv6/kernel.py:68 (its gradient; "
                     "the TPU kernel has no backward)",
         "max_abs_err": err["wkv6_backward"], "ms": t["bwd"],
         "plain_ms": t["bwd_plain"], "bound_ms": bb, "bound_by": bby,
         "library_ms": None},
    ]


def wkv6_against(other):
    """The WKV6 kernels built from ``other`` against the checkout's: at
    the RWKV-6 path's shape, at a quarter of its rows and at half its K,
    both held against the plain versions, then timed in turns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv6 import kernel as WK
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_fwd_ref

    cfg = get_config("rwkv6-3b")
    hd = cfg.rwkv_head_dim
    bh = BATCH // W * (cfg.d_model // hd)
    builds = {"other": str(other), "this": None}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for n_bh, dk in ((bh, hd), (bh // 4, hd), (bh, hd // 2)):
        shape = f"(BH={n_bh}, T={SEQ}, K={dk}, V={hd})"
        r, k, v, w, u = wkv6_inputs(gen, n_bh, SEQ, dk, hd)
        dy = torch.randn((n_bh, SEQ, hd), generator=gen, device="cuda")
        ref = (*wkv6_fwd_ref(r, k, v, w, u, checkpoints=True),
               *wkv6_bwd_ref(r, k, v, w, u, dy))
        ckpt = {}
        for label, src in builds.items():
            y, s, ckpt[label] = WK.wkv6_forward(r, k, v, w, u,
                                                checkpoints=True, source=src)
            got = (y, s, ckpt[label],
                   *WK.wkv6_backward(r, k, v, w, u, ckpt[label], dy,
                                     source=src))
            for name, a, b in zip(("y", "s_final", "ckpt", "dr", "dk", "dv",
                                   "dw", "du"), got, ref):
                _wkv_compare(f"{label} build's {name} at {shape}", a, b,
                             summed_over_t=name == "du")
        ms = {label: {"forward": [], "backward": []} for label in builds}
        for label in ("other", "this", "this", "other"):
            src = builds[label]
            ms[label]["forward"].append(time_ms(lambda: WK.wkv6_forward(
                r, k, v, w, u, checkpoints=True, source=src)))
            ms[label]["backward"].append(time_ms(lambda: WK.wkv6_backward(
                r, k, v, w, u, ckpt[label], dy, source=src)))
        log(json.dumps({"shape": {"bh": n_bh, "t": SEQ, "k": dk, "v": hd},
                        "other": str(other), "ms": ms}))


def topk_against(others):
    """The top-k kernel built from each of ``others`` against the
    checkout's: all held bitwise against the plain version (the embedding
    leaf, a 28-row block layout, the edge set, bf16), then timed in turns
    (others, this, this, others reversed) at the embedding leaf and at
    the 28-row layout, beside a plain device copy of the same bytes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.topk.kernel import block_topk_2d
    from repro_torch.kernels.topk.ops import topk_layout
    from repro_torch.kernels.topk.ref import block_topk_bisect_ref
    from repro_torch.models.model import param_specs

    cfg = get_config("qwen3-0.6b")
    block, rows, k = max((topk_layout(math.prod(shape), TOPK_Q)
                          for _, shape, _ in param_specs(cfg)),
                         key=lambda t: t[1])
    block28, k28 = 28, topk_layout(28 * 128, TOPK_Q)[2]
    rows28 = rows // block28 * block28
    builds = {str(o): str(o) for o in others}
    builds["this"] = None
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((rows, 128), generator=gen, device="cuda") * 1e-3
    x28 = x[:rows28]
    cases = [("embedding leaf", x, k, block), ("28-row", x28, k28, block28),
             ("bf16", x[:4096].bfloat16(), k, block)]
    cases += [(f"{name} block {b} k {kk}", t, kk, b)
              for name, t, kk, b in topk_edges(gen)]
    cases += [(f"bf16 {name} block {b} k {kk}", t.bfloat16(), kk, b)
              for name, t, kk, b in topk_edges(gen)]
    for what, t, kk, b in cases:
        ref = block_topk_bisect_ref(t, k=kk, block=b)
        for label, src in builds.items():
            out = block_topk_2d(t, k=kk, block_rows=b, source=src)
            torch.cuda.synchronize()
            check(bool(same_bits(out, ref).all()),
                  f"{label} build of block_topk_2d differs from its plain "
                  f"version: {what}")
        del ref
    log(f"topk builds: both bitwise equal to plain on {len(cases)} cases")
    for what, t, kk, b in (("embedding leaf", x, k, block),
                           ("28-row", x28, k28, block28)):
        ms = {label: [] for label in builds}
        order = [str(o) for o in others]
        for label in order + ["this", "this"] + order[::-1]:
            src = builds[label]
            ms[label].append(time_ms(lambda: block_topk_2d(
                t, k=kk, block_rows=b, source=src)))
        log(json.dumps({"shape": {"rows": t.shape[0], "block_rows": b,
                                  "k": kk, "dtype": "float32"},
                        "what": what, "ms": ms,
                        "copy_ms": time_ms(lambda: t.clone()),
                        "bound_ms": bound_ms(8 * t.numel(),
                                             TOPK_OPS * t.numel())[0]}))


def natural_edges():
    """Zeros, +-subnormals, NaN, +-inf and normal values against each
    other, and 2^e and one and two ulps below it for every exponent of a
    normal f32 (both signs; h = 0 and h unit normal): (g, h) (R, 128) f32
    on the card."""
    f32 = np.float32
    special = np.array([0.0, -0.0, 1e-39, -1e-39, 1e-38, 3e-38, -2e-38,
                        1.5e-38, TINY, np.nan, np.inf, -np.inf, 1.0, -2.5,
                        3.0e38], f32)
    gs, hs = (a.ravel() for a in np.meshgrid(special, special))
    p2 = np.ldexp(f32(1), np.arange(-126, 128)).astype(f32)
    below1 = np.nextafter(p2, f32(0))
    lat = np.concatenate([p2, below1, np.nextafter(below1, f32(0))])
    lat = np.concatenate([lat, -lat, lat])
    lat_h = np.concatenate([np.zeros(2 * lat.size // 3, f32),
                            np.random.default_rng(4).standard_normal(
                                lat.size // 3).astype(f32)])
    g, h = np.concatenate([gs, lat]), np.concatenate([hs, lat_h])
    rows = -(-g.size // 128)
    return tuple(lanes(torch.from_numpy(a).cuda(), rows) for a in (g, h))


def topk_edges(gen):
    """(name, x (R, 128) f32 on the card, k, block_rows) cases beyond the
    leaf layouts: exact ties across the k-th magnitude, one NaN in a
    block, infinities with subnormals and tiny and huge blocks, k = 1 and
    k = the whole block, block_rows 1, 8 and 28."""
    dev = torch.device("cuda")
    x = torch.randn((128, 128), generator=gen, device=dev)
    ties = torch.round(x * 2.0)
    nan = x.clone()
    nan[0, 5] = float("nan")
    special = x.clone()
    special[0, :3] = torch.tensor([float("inf"), float("-inf"), 1e-39])
    special[1:64] *= 1e-30
    special[64:] *= 1e37
    cases = []
    for name, t in (("ties", ties), ("nan", nan), ("special", special)):
        for k, block in ((819, 64), (1, 64), (8192, 64), (102, 8), (358, 28),
                         (13, 1), (128, 1)):
            rows = 128 if 128 % block == 0 else 2 * block
            cases.append((name, t[:rows].contiguous(), k, block))
    return cases


def phase_natural_topk_kernels(cfg):
    """``shifted_natural_2d``, ``natural_message`` and ``block_topk_2d``
    bitwise against their plain versions on the card: at every leaf
    layout their wrappers give ``cfg``'s leaves (f32, gradient-sized g and
    h; ``natural_message`` at every leaf's size, also as an unaligned
    worker row), on the edge sets (``natural_message`` also cut to 1, 3,
    127 and 129 elements and at offsets), in bf16; then each timed at the
    largest layout (the embedding's)."""
    from repro_torch.core.compressors import NaturalCompression
    from repro_torch.kernels.natural.kernel import (natural_message,
                                                    shifted_natural_2d)
    from repro_torch.kernels.natural.ops import natural_layout
    from repro_torch.kernels.natural.ref import shifted_natural_ref
    from repro_torch.kernels.topk.kernel import block_topk_2d
    from repro_torch.kernels.topk.ops import block_topk, topk_layout
    from repro_torch.kernels.topk.ref import block_topk_bisect_ref
    from repro_torch.models.model import param_specs

    from repro_torch.kernels import _build

    if "topk" in _build.BUILD_LOG:
        for name, regs, st, ld, smem in ptxas_report(_build.BUILD_LOG["topk"]):
            log(f"topk ptxas: {name}: {regs} registers, {smem} bytes static "
                f"smem, spill stores {st} B, spill loads {ld} B")
    else:
        log("topk ptxas: the library was built before this run; no report")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    err = {"shifted_natural_2d": 0.0, "block_topk_2d": 0.0,
           "natural_message": 0.0}
    codec = NaturalCompression()

    def nat(g, h, u, block, what):
        out = shifted_natural_2d(g, h, u, block_rows=block)
        ref = shifted_natural_ref(g, h, u)
        torch.cuda.synchronize()
        check(bool(same_bits(out, ref).all()) and out.dtype == ref.dtype,
              f"shifted_natural_2d differs from its plain version: {what}")
        err["shifted_natural_2d"] = max(err["shifted_natural_2d"],
                                        finite_err(out, ref))

    def msg(g, h, u, what, out=None):
        got = natural_message(g, h, u, out=out)
        ref = codec(lambda shape: u, g - h)
        torch.cuda.synchronize()
        check(bool(same_bits(got, ref).all()) and got.dtype == ref.dtype,
              f"natural_message differs from the codec's round trip: {what}")
        err["natural_message"] = max(err["natural_message"],
                                     finite_err(got, ref))

    def topk(x, k, block, what):
        out = block_topk_2d(x, k=k, block_rows=block)
        ref = block_topk_bisect_ref(x, k=k, block=block)
        torch.cuda.synchronize()
        check(bool(same_bits(out, ref).all()) and out.dtype == ref.dtype,
              f"block_topk_2d differs from its plain version: {what}")
        err["block_topk_2d"] = max(err["block_topk_2d"], finite_err(out, ref))

    sizes = [math.prod(shape) for _, shape, _ in param_specs(cfg)]
    nat_layouts = sorted({natural_layout(n)[1:] for n in sizes}, reverse=True)
    topk_layouts = sorted({topk_layout(n, TOPK_Q) for n in sizes},
                          key=lambda t: t[1], reverse=True)
    for block, rows in nat_layouts:
        g = torch.randn((rows, 128), generator=gen, device=dev) * 1e-3
        h = torch.randn((rows, 128), generator=gen, device=dev) * 1e-3
        u = torch.rand((rows, 128), generator=gen, device=dev)
        nat(g, h, u, block, f"({rows}, 128) block {block}")
        if rows <= 256:
            nat(g.bfloat16(), h.bfloat16(), u, block,
                f"bf16 ({rows}, 128) block {block}")
        del g, h, u
    for n in sorted(set(sizes), reverse=True):
        g = torch.randn(n, generator=gen, device=dev) * 1e-3
        h = torch.randn(n, generator=gen, device=dev) * 1e-3
        u = torch.rand(n, generator=gen, device=dev)
        msg(g, h, u, f"{n} elements")
        if n <= 1 << 20:
            msg(g.bfloat16(), h.bfloat16(), u, f"bf16 {n} elements")
            # worker 1's row of a 2-row stack of n + 1: starts unaligned
            gw = torch.randn((2, n + 1), generator=gen, device=dev)
            hw = torch.randn((2, n + 1), generator=gen, device=dev)
            uw = torch.rand(n + 1, generator=gen, device=dev)
            out = torch.empty_like(gw)
            msg(gw[1], hw[1], uw, f"unaligned row of {n + 1}", out=out[1])
        del g, h, u
    for block, rows, k in topk_layouts:
        x = torch.randn((rows, 128), generator=gen, device=dev) * 1e-3
        topk(x, k, block, f"({rows}, 128) block {block} k {k}")
        if rows <= 256:
            topk(x.bfloat16(), k, block, f"bf16 ({rows}, 128) block {block}")
        del x
    log(f"natural/topk kernels: bitwise equal to plain at every qwen3-0.6b "
        f"leaf layout (natural {nat_layouts}; natural_message at every "
        f"leaf's size {sorted(set(sizes))}; topk (block, rows, k) "
        f"{topk_layouts}), f32, and bf16 and unaligned rows at the small "
        f"ones")

    g, h = natural_edges()
    for seed in range(3):
        u = torch.rand(g.shape, generator=gen, device=dev)
        nat(g, h, u, 1, f"edge set, u draw {seed}")
        nat(g.bfloat16(), h.bfloat16(), u, 1, f"bf16 edge set, draw {seed}")
        u[:, ::3] = 0.0
        u[:, 1::3] = 1.0 - 2.0 ** -24          # the largest f32 below 1
        for dt in (torch.float32, torch.bfloat16):
            gd, hd = g.to(dt).reshape(-1), h.to(dt).reshape(-1)
            msg(gd, hd, u.reshape(-1), f"{dt} edge set, draw {seed}")
            for n in (1, 3, 127, 129):
                for at in (0, 1, 2, 5):
                    msg(gd[at:at + n], hd[at:at + n], u.reshape(-1)[:n],
                        f"{dt} edge set, {n} elements at {at}")
    for name, x, k, block in topk_edges(gen):
        topk(x, k, block, f"{name} block {block} k {k}")
        topk(x.bfloat16(), k, block, f"bf16 {name} block {block} k {k}")
    # a padded last block through the wrapper: 10,000 elements are 79 rows,
    # padded to 128 (two blocks of 64, the second 49 rows of zeros)
    x = torch.randn(10_000, generator=gen, device=dev)
    out = block_topk(x, q=TOPK_Q)
    block, rows_pad, k = topk_layout(x.numel(), TOPK_Q)
    ref = block_topk_bisect_ref(lanes(x, rows_pad), k=k, block=block)
    torch.cuda.synchronize()
    check(bool(same_bits(out, ref.reshape(-1)[:x.numel()]).all()),
          "block_topk differs from its plain version on a padded last block")
    log("natural/topk kernels: bitwise equal to plain on the edge sets "
        "(zeros, subnormals, NaN, inf, 2^e and 1-2 ulps below for every "
        "exponent, bf16; natural_message also with u = 0 and u just under "
        "1, cut to 1, 3, 127 and 129 elements at offsets 0, 1, 2 and 5; "
        "ties, a NaN block, k = 1, k = block, block rows 1, 8, 28, a "
        "padded last block)")

    # timing at the embedding's layout, no padding
    block, rows = nat_layouts[0]
    n = rows * 128
    g = torch.randn((rows, 128), generator=gen, device=dev) * 1e-3
    h = torch.randn((rows, 128), generator=gen, device=dev) * 1e-3
    u = torch.rand((rows, 128), generator=gen, device=dev)
    out = torch.empty_like(g)
    tblock, trows, k = topk_layouts[0]
    t = {
        "nat": time_ms(lambda: shifted_natural_2d(g, h, u, block_rows=block)),
        "nat_plain": time_ms(lambda: shifted_natural_ref(g, h, u)),
        "msg": time_ms(lambda: natural_message(g, h, u, out=out)),
        "msg_plain": time_ms(lambda: codec(lambda shape: u, g - h)),
        "topk": time_ms(lambda: block_topk_2d(g, k=k, block_rows=tblock)),
        "topk_plain": time_ms(lambda: block_topk_bisect_ref(g, k=k,
                                                            block=tblock)),
    }
    a = g.abs()
    t["selection"] = time_ms(lambda: torch.topk(
        a.view(-1, tblock * 128), k, dim=1))
    # natural: g, h, u read once and out written once (16 bytes an
    # element); ~15 operations an element (subtract, abs, the exponent
    # and mantissa masks, compare, select, doubling, sign, add, three
    # flush tests); natural_message the same bytes and fewer operations.
    # top-k: x read once, out written once (8 bytes);
    # TOPK_OPS integer operations an element at the f32 rate (the key:
    # a mask, a flush test and select, a max; 4 radix passes of a shift,
    # a compare and an atomic add; the write's compare and select)
    nb, nby = bound_ms(16 * n, 15 * n)
    tb, tby = bound_ms(8 * n, TOPK_OPS * n)
    log(f"natural/topk timing at ({rows}, 128) f32 (the embedding leaf), "
        f"median of 20 (ms): shifted_natural_2d {t['nat']:.4f} (plain "
        f"{t['nat_plain']:.4f}, bound {nb:.4f} by {nby}); natural_message "
        f"{t['msg']:.4f} ({100 * nb / t['msg']:.1f}% of the bound; the "
        f"codec's round trip {t['msg_plain']:.4f}); block_topk_2d "
        f"block {tblock} k {k} {t['topk']:.4f} (plain {t['topk_plain']:.4f}"
        f", bound {tb:.4f} by {tby}); no single PyTorch call computes "
        f"any of the three; the selection alone, torch.topk of |g| in rows "
        f"of {tblock * 128} (k {k}; not the function): "
        f"{t['selection']:.4f}")
    check(nb / t["msg"] >= 0.8, f"natural_message at {t['msg']:.4f} ms, "
          f"under 80% of its {nb:.4f} ms bound")
    del g, h, u, a, out
    torch.cuda.empty_cache()
    return [
        {"name": "shifted_natural_2d", "route": "cuda",
         "source": "src/repro_torch/kernels/natural/csrc/natural.cu",
         "replaces": "src/repro/kernels/natural/kernel.py:51",
         "max_abs_err": err["shifted_natural_2d"], "ms": t["nat"],
         "plain_ms": t["nat_plain"], "bound_ms": nb, "bound_by": nby,
         "library_ms": None},
        {"name": "natural_message", "route": "cuda",
         "source": "src/repro_torch/kernels/natural/csrc/natural.cu",
         "replaces": None,
         "max_abs_err": err["natural_message"], "ms": t["msg"],
         "plain_ms": t["msg_plain"], "bound_ms": nb, "bound_by": nby,
         "library_ms": None},
        {"name": "block_topk_2d", "route": "cuda",
         "source": "src/repro_torch/kernels/topk/csrc/topk.cu",
         "replaces": "src/repro/kernels/topk/kernel.py:51",
         "max_abs_err": err["block_topk_2d"], "ms": t["topk"],
         "plain_ms": t["topk_plain"], "bound_ms": tb, "bound_by": tby,
         "library_ms": None, "selection_ms": t["selection"]},
    ]


def phase_entry_points(g0, h0):
    """The slice's entry points over every leaf: ``shifted_natural(rand,
    g, h)``, ``natural_message(g, h, u)`` and ``block_topk(g,
    q=TOPK_Q)``, g worker 0's gradient and h its DIANA shift (full-size
    qwen3-0.6b, from the natural path).  The launch counts are reset just
    before and read just after; then every output is held bitwise
    against the plain versions (``natural_message`` against the codec's
    ``decode(encode(g - h))`` with the same uniforms, at every element),
    and the shifted output against ``h + NaturalCompression.decode(
    encode(g - h))`` with the same uniforms wherever ``|g - h| >=
    2^-126`` (the kernel and the codec floor log2 differently below that)
    and neither h nor the output is subnormal (the kernel flushes
    them)."""
    from repro_torch.core.compressors import NaturalCompression, ShapeDtype
    from repro_torch.kernels.natural.kernel import (natural_message,
                                                    shifted_natural_2d)
    from repro_torch.kernels.natural.ops import natural_layout, shifted_natural
    from repro_torch.kernels.natural.ref import shifted_natural_ref
    from repro_torch.kernels.topk.kernel import block_topk_2d
    from repro_torch.kernels.topk.ops import block_topk, topk_layout
    from repro_torch.kernels.topk.ref import block_topk_bisect_ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    drawn, nat_out, topk_out, msg_u, msg_out = {}, {}, {}, {}, {}

    def draw(key):
        def rand(shape):
            drawn[key] = torch.rand(shape, generator=gen, device="cuda")
            return drawn[key]
        return rand

    for key, g in g0.items():
        msg_u[key] = torch.rand(g.shape, generator=gen, device="cuda")
    torch.cuda.synchronize()
    shifted_natural_2d.launches = block_topk_2d.launches = 0
    natural_message.launches = 0
    t0 = time.perf_counter()
    for key in g0:
        nat_out[key] = shifted_natural(draw(key), g0[key], h0[key])
        msg_out[key] = natural_message(g0[key], h0[key], msg_u[key])
        topk_out[key] = block_topk(g0[key], q=TOPK_Q)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"shifted_natural_2d": shifted_natural_2d.launches,
                "block_topk_2d": block_topk_2d.launches,
                "natural_message": natural_message.launches}
    leaves = len(g0)
    check(launches == dict.fromkeys(launches, leaves),
          f"entry points: launches {launches}, expected {leaves} each")

    codec = NaturalCompression()
    compared = total = kept = 0
    for key, g in g0.items():
        h, n = h0[key], g.numel()
        _, block, rows_pad = natural_layout(n)
        ref = shifted_natural_ref(lanes(g, rows_pad), lanes(h, rows_pad),
                                  drawn[key]).reshape(-1)[:n]
        check(bool(same_bits(nat_out[key].reshape(-1), ref).all()),
              f"shifted_natural differs from its plain version at {key}")
        x = g - h
        u = drawn[key].reshape(-1)[:n].reshape(g.shape)
        payload, meta = codec.encode(lambda shape: u, x)
        via = h + codec.decode(payload, meta, ShapeDtype.of(x))
        mask = ((x.abs() >= TINY) & ((h == 0) | (h.abs() >= TINY))
                & ((via == 0) | (via.abs() >= TINY)))
        check(bool(same_bits(nat_out[key][mask], via[mask]).all()),
              f"shifted_natural differs from h + NaturalCompression(g - h) "
              f"at {key}")
        plain = codec(lambda shape: msg_u[key], g - h)
        check(bool(same_bits(msg_out[key], plain).all()),
              f"natural_message differs from NaturalCompression's "
              f"decode(encode(g - h)) at {key}")
        msg_out[key] = msg_u[key] = plain = None
        compared += int(mask.sum())
        total += n
        tblock, trows, k = topk_layout(n, TOPK_Q)
        tref = block_topk_bisect_ref(lanes(g, trows), k=k,
                                     block=tblock).reshape(-1)[:n]
        check(bool(same_bits(topk_out[key].reshape(-1), tref).all()),
              f"block_topk differs from its plain version at {key}")
        kept += int((topk_out[key] != 0).sum())
        del payload, via, mask, x, u, ref, tref
    log(f"entry points over {leaves} full-size qwen3-0.6b leaves ({total:,} "
        f"elements, worker 0's gradient and DIANA shift): launches "
        f"{launches} (as expected), {secs:.4f} s for the three wrappers; "
        f"outputs bitwise equal to the plain versions (natural_message to "
        f"the codec's round trip at every element); natural equal to h + "
        f"NaturalCompression(g - h) at {compared:,} of {total:,} elements "
        f"(the rest below 2^-126); top-k kept {kept:,} ({kept / total:.4f})")
    return launches


def _slice_configs(cfg, comm_mode="dense", codec="q8_block", rule="diana",
                   wires=("none", "none")):
    """``rule`` (or the comm mode's own rule: ``ef21``) with ``codec``;
    top-k keeps TOPK_Q, randk its default q = 0.1, Rand-DIANA the
    config's p = 0.05; ``wires`` the moe and act wires' codec flags."""
    from repro_torch.configs.base import CompressionConfig, TrainConfig

    comp = CompressionConfig(
        enabled=True, compressor=codec,
        compressor_kwargs=(("q", TOPK_Q),) if codec == "topk" else (),
        shift_rule=rule, comm_mode=comm_mode, moe_wire=wires[0],
        act_wire=wires[1])
    return TrainConfig(learning_rate=LR, total_steps=STEPS,
                       warmup_steps=1, compression=comp)


def shift_rate(comp):
    """How much of a message the shift integrates: DIANA's alpha, EF21's 1,
    EF-BV's eta."""
    rule = comp.effective_shift_rule
    return {"ef21": 1.0, "efbv": comp.efbv_eta}.get(rule, comp.shift_alpha)


def ring_mode(comm_mode):
    """Whether ``comm_mode`` aggregates through the q8 ring (the overlap
    and fused-VJP modes do, in the ``q8_ring_fused`` format)."""
    from repro_torch.comm.channel import aggregation_mode_of

    return aggregation_mode_of(comm_mode) in ("q8_ring", "q8_ring_fused")


def lattice(msg, block_rows=64):
    """Per-element lattice step of W-stacked decoded q8 messages: each
    worker's leaf flattened and tiled as FusedQ8 tiles it, max|m| / 127
    per tile (the tile's largest element quantizes to +-127)."""
    from repro_torch.kernels.q8ring.ops import LANE, q8_layout

    w, d = msg.shape[0], msg[0].numel()
    _, block, rows_pad = q8_layout(d, block_rows)
    flat = torch.nn.functional.pad(msg.reshape(w, d).abs(),
                                   (0, rows_pad * LANE - d))
    step = flat.reshape(w, -1, block * LANE).amax(dim=2, keepdim=True) / 127
    return (step.expand(-1, -1, block * LANE).reshape(w, -1)[:, :d]
            .reshape(msg.shape))


def message_step(msg, codec, block_rows=64):
    """Per element, how far one flipped rounding (or, for top-k, one
    traded place at a leaf's k-th magnitude) can move a W-stacked decoded
    message: the q8 lattice step; for natural the message's own
    magnitude (a neighbouring power of two is at most that far); for
    top-k the worker's k-th magnitude."""
    if codec == "q8_block":
        return lattice(msg, block_rows)
    if codec == "natural":
        return msg.abs()
    if codec == "randk":
        return torch.zeros_like(msg)
    w = msg.shape[0]
    flat = msg.reshape(w, -1).abs()
    k = max(1, round(TOPK_Q * flat.shape[1]))
    kth = torch.topk(flat, k, dim=1).values[:, -1]
    return kth.reshape((w,) + (1,) * (msg.dim() - 1)).expand(msg.shape)


def ring_tile_max(step, n, block_rows=64):
    """Per element, the largest ``step`` over its ring tile: the leaf
    flattened, zero-padded and cut into n chunks and (block, 128) tiles
    as the fused ring cuts its buffers (``ring_chunk_layout``)."""
    from repro_torch.kernels.q8ring.ops import LANE, ring_chunk_layout

    d = step.numel()
    rows_c, block = ring_chunk_layout(d, n, block_rows)
    flat = torch.nn.functional.pad(step.reshape(-1),
                                   (0, n * rows_c * LANE - d))
    tile = flat.reshape(-1, block * LANE).amax(dim=1, keepdim=True)
    return (tile.expand(-1, block * LANE).reshape(-1)[:d]
            .reshape(step.shape))


def phase_cross_check(arch, comm_mode, codec="q8_block", rule="diana",
                      wires=("none", "none"), card_fault=None):
    """One smoke-config step on the card and on the CPU, same state and
    uniforms: the GPU path (kernels, cuBLAS) against the plain CPU path.

    The gradients differ by f32 rounding (cuBLAS against the CPU's
    products), and where ``frac(x / scale)`` lies that close to its
    uniform the two sides round to neighbouring lattice points.  So:
    every shift element within alpha lattice steps of its tile (plus f32
    noise), at most RARE of them that far off; every param within 2 lr
    (AdamW's first step normalises g / (|g| + eps)), at most 1e-3 of
    them off by more than f32 noise.

    The ring (``q8_ring_fused``) quantizes the partial sums of the
    messages once per hop and once for the all-gather, n times in all,
    and each may round the other way where a message flipped or the
    sums differ by f32 rounding.  Let L be the largest message step over
    the elements of one ring tile.  The tile's partial sums hold at most
    W messages, each within 127 of its steps, plus the rounding error
    carried from earlier hops, at most n - 1 ring steps; so the tile's
    ring step is at most W * L / (1 - (n - 1) / 127).  Each quantization
    leaves either side within one of its own steps of what it was
    given, so it parts them by at most two.  So an ``h_bar`` element
    (alpha times the ring sum over W) moves by at most alpha * (2n + 1)
    * L / (1 - (n - 1) / 127): 2n ring steps over W, plus the flipped
    messages' one step each over W.  A flip at a ring tile's maximum
    moves that tile's scale and so re-rounds much of the tile, so the
    share of ``h_bar`` elements allowed off is RARE_RING.

    With the ``natural`` and ``topk`` codecs the lattice step is
    ``message_step``'s: a flipped natural rounding moves a message
    element by at most its own magnitude, a top-k place traded at the
    k-th magnitude by at most that magnitude; the shift integrates the
    message at DIANA's alpha or EF21's 1 (``shift_rate``).  ``randk``
    draws its coordinates from the same stream on both sides, so its
    messages flip nothing: shifts within f32 noise.  With ``vr_gdci``
    the round mixes the params itself (VR-GDCI's alpha integrates the
    messages into the shifts).  ``wires``: the moe and act wires' codec
    flags; their sends draw on the CPU by address too, so both sides
    send the same bits but where the activations they quantize differ
    by f32 rounding across a rounding boundary.  Such a wire flip moves
    one activation by a whole int8 step, which the rest of that worker's
    forward and backward carry: its gradients then differ far beyond f32
    noise wherever the token reaches (on the CPU, one side's params
    perturbed by 1e-7 flipped 16 of 393,216 qwen2-moe wire elements, then
    0.75% of the h elements and 1.05% of h_bar's through the ring; on
    deepseek's smoke config 7.8% of h_bar and some h elements beyond their
    lattice bound, up to twice it).  So the card runs first and its wire
    payloads are recorded; the CPU encodes each send itself, holds it
    against the card's (``wire_verdict``), and forwards the card's
    payload, so the rest of the step is held to the bounds above.

    ``card_fault(send, payload)``: alters the card's payload of each wire
    send in place before it is recorded and forwarded (a faulty card
    encode).  With it the step runs on both sides, and the wire
    verdict ``(faults, stats)`` is returned unchecked, the rest not
    compared (``phase_wire_rehearsal``)."""
    from repro_torch.comm import channel as CH
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.train import build_train_step, init_state

    TIGHT, RARE, RARE_RING = 1e-5, 1e-4, 1e-3
    ring = ring_mode(comm_mode)
    cfg = get_smoke_config(arch).with_(dtype="float32")
    tcfg = _slice_configs(cfg, comm_mode, codec, rule, wires)
    alpha = shift_rate(tcfg.compression)
    what = f"cross-check {arch} {comm_mode} {codec} {rule}" + (
        "" if wires == ("none", "none") else
        f" moe_wire={wires[0]} act_wire={wires[1]}")
    block_rows = tcfg.compression.q8_block_rows
    ring_growth = (2 * RING + 1) / (1 - (RING - 1) / 127)
    batch = TokenStream(cfg, 32, BATCH).batch(0)
    s0 = init_state(0, cfg, tcfg, W, "cpu")

    def on(tree, dev):   # a copy: h and h_bar are updated in place
        return {k: v.to(dev, copy=True) for k, v in tree.items()}

    results, sent, card_payloads = [], [], []
    encode = CH.encode_meta_free
    for dev in ("cuda", "cpu"):
        state = s0._replace(
            params=on(s0.params, dev),
            opt=type(s0.opt)(0, on(s0.opt.m, dev), on(s0.opt.v, dev)),
            h=on(s0.h, dev), h_bar=on(s0.h_bar, dev),
            noise=HostNoise(1, dev))
        mesh = HostMesh(data=RING if ring else 1, device=dev)
        sent.append([])

        def recorded(codec, rand, x, _sent=sent[-1], dev=dev):  # wire sends
            payload = encode(codec, rand, x)
            if dev == "cuda" and card_fault is not None:
                card_fault(len(_sent), payload)
            _sent.append((payload["q"].cpu(), payload["scale"].cpu()))
            if dev == "cuda":
                card_payloads.append(payload)
                return payload
            # the CPU forwards the card's payload (its own only counted)
            return {k: v.cpu() for k, v in
                    card_payloads[len(_sent) - 1].items()}

        CH.encode_meta_free = recorded
        try:
            state, m = build_train_step(cfg, tcfg, W, mesh)(
                state, {k: v.to(dev) for k, v in batch.items()})
        finally:
            CH.encode_meta_free = encode
        results.append((state, m))
    check(len(sent[0]) == len(sent[1]),
          f"{what}: the sides sent {len(sent[0])} and {len(sent[1])} wire "
          f"payloads")
    faults, wire = wire_verdict(*sent, TIGHT, RARE_RING)
    if card_fault is not None:
        return faults, wire
    check(not faults, f"{what}: wire payloads, card against CPU: "
                      + "; ".join(faults))
    del card_payloads
    (sg, mg), (sc, mc) = results
    check(mg["bits"].item() == mc["bits"].item(),
          f"{what}: bits differ")
    lc, lg = mc["loss"].item(), mg["loss"].item()
    check(abs(lg - lc) <= 1e-5 * abs(lc),
          f"{what}: loss {lg} vs {lc}")

    counts, worst_share = {}, {}
    for name in ("h", "h_bar"):
        flipped = total = 0
        worst_share[name] = 0.0
        for k, h1 in sc.h.items():
            lat = message_step((h1 - s0.h[k]) / alpha, codec,   # CPU's msgs
                               block_rows)
            if name == "h_bar":      # a flip moves the mean by lat / W
                lat = lat.amax(dim=0)
                if ring:
                    lat = ring_growth * ring_tile_max(lat, RING, block_rows)
            ref = getattr(sc, name)[k]
            d = (getattr(sg, name)[k].cpu() - ref).abs()
            noise = TIGHT * ref.abs().max().item()
            bound = alpha * lat * 1.001 + noise
            check(bool((d <= bound).all()),
                  f"{what}: {name}[{k}] beyond its "
                  f"lattice bound")
            worst_share[name] = max(worst_share[name], torch.where(
                bound > 0, d / bound, 0.0).max().item())
            flipped += int((d > noise).sum())
            total += d.numel()
        share = RARE_RING if ring and name == "h_bar" else RARE
        check(flipped <= share * total,
              f"{what}: {flipped} of {total} "
              f"{name} elements flipped")
        counts[name] = (flipped, total)
    off = total = 0
    worst = 0.0
    for k, ref in sc.params.items():
        d = (sg.params[k].cpu() - ref).abs()
        worst = max(worst, d.max().item())
        off += int((d > TIGHT * ref.abs().max().item()).sum())
        total += d.numel()
    check(worst <= 2 * LR, f"{what}: params differ "
                           f"by {worst}")
    check(off <= 1e-3 * total,
          f"{what}: {off} of {total} params beyond "
          f"f32 noise")
    log(f"{what} (smoke config, 1 step, GPU vs CPU): "
        f"loss {lg:.6f} vs {lc:.6f}, bits {mg['bits'].item():.0f} equal; "
        f"elements off: h {counts['h'][0]} of {counts['h'][1]}, h_bar "
        f"{counts['h_bar'][0]} of {counts['h_bar'][1]}; largest |diff| / "
        f"bound: h {worst_share['h']:.3f}, h_bar {worst_share['h_bar']:.3f}"
        f"; params beyond f32 "
        f"noise {off} of {total}, max |diff| {worst:.3e}"
        + (f"; wire int8 payloads flipped {wire['flips']} of "
           f"{wire['elems']}, largest scale |diff| / the send's largest "
           f"{wire['scale_off']:.3e} ({len(sent[0])} sends; the CPU "
           f"forwarded the card's)" if sent[0] else ""))


def wire_verdict(card, cpu, tight, rare):
    """The card's wire payloads against the CPU's own encode of the same
    sends, each send ``(q, scale)`` on the host.  Both sides quantize the
    same activations up to f32 rounding with the same uniforms, so an
    int8 element may round to the neighbouring step (a flip), at most
    ``rare`` of them, and a scale (``Int8Stochastic``'s: the send's
    largest magnitude over 127) may differ by f32 noise, at most
    ``tight`` times the send's largest scale.  Returns ``(faults,
    stats)``: the bounds broken, as text."""
    flips = elems = jump = 0
    scale_off = 0.0
    for (qa, sa), (qb, sb) in zip(card, cpu):
        d = (qa.int() - qb.int()).abs()
        flips += int((d != 0).sum())
        elems += d.numel()
        jump = max(jump, int(d.max()))
        big = sb.abs().max().item()
        scale_off = max(scale_off,
                        (sa - sb).abs().max().item() / big if big else
                        float((sa != sb).any()))
    faults = []
    if jump > 1:
        faults.append(f"an int8 element {jump} steps off (a flip is one)")
    if flips > rare * elems:
        faults.append(f"{flips} of {elems} int8 elements differ")
    if scale_off > tight:
        faults.append(f"a scale off by {scale_off:.3e} of its send's "
                      f"largest")
    return faults, dict(flips=flips, elems=elems, jump=jump,
                        scale_off=scale_off)


#: faulty card encodes of the wire sends, each applied to the first send
#: (a row: d_model int8 elements, the last axis)
WIRE_FAULTS = {
    "one int8 row negated":
        lambda i, p: i == 0 and p["q"].view(-1, p["q"].shape[-1])[0].neg_(),
    "its scale doubled": lambda i, p: i == 0 and p["scale"].mul_(2),
}


def phase_wire_rehearsal(arch):
    """The wired cross-check of ``arch`` (``q8_ring_fused``, both wires
    q8) with each of ``WIRE_FAULTS`` in the card's encode: the CPU
    forwards the card's payloads, so the rest of its step carries the
    fault too, and only the wire verdict can see it.  Each fault must
    break one of its bounds."""
    for name, fault in WIRE_FAULTS.items():
        faults, wire = phase_cross_check(arch, "q8_ring_fused",
                                         wires=("q8", "q8"),
                                         card_fault=fault)
        check(faults, f"wire rehearsal {arch}, {name} in the card's "
                      f"encode: the cross-check passed it ({wire})")
        log(f"wire rehearsal {arch}, {name} in the card's encode: caught "
            f"({'; '.join(faults)}; {wire['flips']} of {wire['elems']} "
            f"int8 elements differ, the largest by {wire['jump']}; "
            f"scale off {wire['scale_off']:.3e})")


RANDK_Q = 0.1               # keep fraction of the randk codec (its default)


def q8_message_counts(d, w):
    """(wire bits, payload bytes) of w workers' q8 messages of one
    d-element leaf, from its layout: the int8 lanes block and one f32
    scale per tile."""
    from repro_torch.kernels.q8ring.ops import q8_layout

    _, block, rows_pad = q8_layout(d)
    tiles = rows_pad // block
    return (w * (rows_pad * 128 * 8 + tiles * 32),
            w * (rows_pad * 128 + tiles * 4))


def structural_bits(cfg, steps, codec="q8_block", refreshes=None,
                    reverse=False, w=W):
    """The f32 bit counter the step must report, from leaf shapes alone:
    per leaf and worker, q8 the int8 lanes block and one f32 scale per
    tile; natural 9 bits an element (8-bit exponent, 1-bit sign); natural
    dithering (s = 8) 5 bits an element and an f32 norm; top-k
    and randk k = round(q d) values of 32 bits and indices of
    ceil(log2 d) bits.  ``refreshes``: Rand-DIANA's refreshing workers of
    each step, each charged one dense f32 message of every param.
    ``reverse``: the leaves summed last first, as the overlap runtime's
    rounds sum them (its buckets' order)."""
    from repro_torch.models.model import param_specs

    step_bits = np.float32(0)
    dense = 0
    specs = param_specs(cfg)
    for _, shape, _ in (specs[::-1] if reverse else specs):
        d = math.prod(shape)
        dense += 32 * d
        if codec == "natural":
            leaf = w * 9 * d
        elif codec == "natural_dithering":   # 4-bit code, 1-bit sign, norm
            leaf = w * (5 * d + 32)
        elif codec in ("topk", "randk"):
            k = max(1, round((TOPK_Q if codec == "topk" else RANDK_Q) * d))
            leaf = w * k * (32 + math.ceil(math.log2(max(d, 2))))
        else:
            leaf = q8_message_counts(d, w)[0]
        step_bits = np.float32(step_bits + np.float32(leaf))
    total = np.float32(0)
    for i in range(steps):
        extra = np.float32(0) if refreshes is None else (
            np.float32(refreshes[i]) * np.float32(dense))
        total = np.float32(total + np.float32(step_bits + extra))
    return float(total)


class RefreshCount:
    """Hands a noise source's draws through, keeping the round's aux
    draws (Rand-DIANA's refresh uniforms) to count the refreshes."""

    def __init__(self, source):
        self.source, self.aux = source, []

    def uniform(self, *args, **kw):
        return self.source.uniform(*args, **kw)

    def permutation(self, *args, **kw):
        return self.source.permutation(*args, **kw)

    def ring_uniform(self, *args):
        return self.source.ring_uniform(*args)

    def pod_uniform(self, *args):
        return self.source.pod_uniform(*args)

    def shared_permutation(self, *args):
        return self.source.shared_permutation(*args)

    def aux_uniform(self, shape):
        self.aux.append(self.source.aux_uniform(shape))
        return self.aux[-1]

    @property
    def round(self):
        return self.source.round

    def stream(self, name):
        return self.source.stream(name)

    def next_round(self):
        self.source.next_round()


def tree_digests(tree, prefix=""):
    """Per-leaf SHA-256 of host copies of a tree's leaves, leaf by leaf
    (two full states do not fit beside a step on the card), each leaf
    hashed in 8 pieces on 8 threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    out = {}
    with ThreadPoolExecutor(8) as pool:
        for k, v in tree.items():
            host = v.detach().cpu().reshape(-1).view(torch.uint8).numpy()
            parts = [pool.submit(lambda a: hashlib.sha256(a).hexdigest(),
                                 piece)
                     for piece in np.array_split(host, 8)]
            out[prefix + k] = tuple(f.result() for f in parts)
            del host
    return out


def state_digests(state):
    """``tree_digests`` of the params, the shifts and the master shift."""
    out = {}
    for name in ("params", "h", "h_bar"):
        out.update(tree_digests(getattr(state, name), name + "/"))
    return out


def reset_launches():
    """Every kernel wrapper by name, each launch count set to 0 (and the
    dequant's accumulating count)."""
    from repro_torch.kernels.natural.kernel import (natural_message,
                                                    shifted_natural_2d)
    from repro_torch.kernels.q8ring import kernel as K
    from repro_torch.kernels.topk.kernel import block_topk_2d
    from repro_torch.kernels.wkv6 import kernel as WK

    wrappers = {"q8_quantize_2d": K.q8_quantize_2d,
                "q8_quantize_chunk_3d": K.q8_quantize_chunk_3d,
                "q8_dequant_add_2d": K.q8_dequant_add_2d,
                "wkv6_forward": WK.wkv6_forward,
                "wkv6_backward": WK.wkv6_backward,
                "shifted_natural_2d": shifted_natural_2d,
                "block_topk_2d": block_topk_2d,
                "natural_message": natural_message}
    for fn in wrappers.values():
        fn.launches = 0
    K.q8_dequant_add_2d.acc_launches = 0
    return wrappers


def ring_counts(cfg, mesh, w=W):
    """Per step, from the channel's specs (``build_channel``): the rings
    the aggregation runs (one per pod and per ``model`` shard of a leaf;
    a leaf replicated over ``model`` is reduced once) and the pod stage's
    encodes (one per pod and shard, each decoded once)."""
    from repro_torch.dist.sharding import worker_stacked_pspecs
    from repro_torch.launch.train import params_like

    rings = stage = 0
    for spec in worker_stacked_pspecs(mesh, params_like(cfg), w).values():
        sharded = mesh.model > 1 and any(a is not None for a in spec[1:])
        shards = mesh.model if sharded else 1
        rings += mesh.pods * shards
        stage += mesh.pods * shards if mesh.pods > 1 else 0
    return rings, stage


def wire_bits_from_shapes(cfg, w, wires):
    """Each wire's bits a step from the shapes alone, with the q8 codecs:
    the grad wire's q8_block messages (``structural_bits``' count of one
    step, summed exactly); the moe wire two sends a token group (dispatch
    and combine) of the (E, C, D) expert buffer, C GShard's capacity
    (``capacity_factor`` x group x k / E, up to a multiple of 8), per MoE
    layer and worker; the act wire one (tokens, D) send a layer and
    worker; an ``Int8Stochastic`` send 8 bits an element and one f32
    scale."""
    from repro_torch.kernels.q8ring.ops import q8_layout
    from repro_torch.models.model import param_specs

    check(set(wires) <= {"none", "q8"}, f"wires {wires}: q8 or none")
    tokens = (BATCH // w) * SEQ
    grad = 0
    for _, shape, _ in param_specs(cfg):
        _, block, rows_pad = q8_layout(math.prod(shape))
        grad += w * (rows_pad * 128 * 8 + (rows_pad // block) * 32)
    out = {"grad": float(grad)}
    if wires[0] == "q8":
        g = min(cfg.moe_group_size, tokens)
        c = math.ceil(cfg.capacity_factor * g * cfg.experts_per_token
                      / cfg.n_experts)
        c = max(8, -(-c // 8) * 8)
        sends = 2 * -(-tokens // g) * (cfg.n_layers - cfg.first_dense_layers)
        out["moe"] = float(sends * w * (8 * cfg.n_experts * c * cfg.d_model
                                        + 32))
    if wires[1] == "q8":
        out["act"] = float(cfg.n_layers * w * (8 * tokens * cfg.d_model + 32))
    return out


def mesh_name(mesh_kw):
    return "" if not mesh_kw else " " + " ".join(
        f"{k}={v}" for k, v in mesh_kw.items())


def phase_main_path(cfg, comm_mode, codec="q8_block", keep=False,
                    rule="diana", digest=False,
                    mesh_kw=None, diag=False, plain_round=False, w=W,
                    wires=("none", "none")):
    """3 steps of ``cfg`` in ``comm_mode`` with ``codec`` and ``rule``:
    ``dense``, ``ef21`` or ``randk_shared``, or a ring mode
    (``q8_ring_fused``, the overlap modes ``q8_ring_overlap``/
    ``efbv_overlap``, ``q8_ring_fused_vjp``) over a
    ``HostMesh(data=RING)`` on the card, or over ``HostMesh(**mesh_kw)``
    (its pod stage and ``model`` shards).  Returns the kernels' launch
    counts of those steps: a kernel inside the workers' passes, of which
    step 2 records one worker's as a CUDA graph and steps 2-3 replay it
    once a worker (``dist.worker_grads``; wired and fused-VJP passes stay
    eager), counts the launches it issued outside the capture plus those
    it issued in the capture times the graph's launches, ``w`` a
    ``grads/replay`` span.  With
    ``digest``, per-leaf digests of the params and shifts after them
    (else None); with ``keep``, worker 0's
    gradient of a fourth step and its shift before it (the entry-point
    phase's inputs), else None.  ``diag``: the step's diagnostics on,
    logged a step.  ``plain_round``: one more round run with the kernels
    and again with their plain versions, bitwise equal
    (``phase_plain_round``).  ``w``: the workers.  ``wires``: the moe
    and act wires' codec flags; with either set, every send of the steps
    is counted, and each wire's bits a step -- the transport's
    structural count -- must equal the count recomputed from the shapes
    (``wire_bits_from_shapes``) and the sends the steps made."""
    from repro_torch.comm import transport as TR
    from repro_torch.comm.channel import SimChannel
    from repro_torch.comm.channel import FUSED_VJP_MODES, OVERLAP_MODES
    from repro_torch.comm.overlap import plan_buckets
    from repro_torch.core.compressors import ShapeDtype
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist import worker_grads as WG
    from repro_torch.kernels.q8ring import kernel as K
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.train import build_train_step, init_state
    from repro_torch.models.model import param_specs
    from repro_torch.spans import SpanRecorder, recording

    ring = ring_mode(comm_mode)
    async_mode = comm_mode in OVERLAP_MODES + FUSED_VJP_MODES
    tcfg = _slice_configs(cfg, comm_mode, codec, rule, wires)
    wired = wires != ("none", "none")
    mesh = HostMesh(**(mesh_kw or {"data": RING if ring else 1}),
                    device="cuda")
    n = mesh.data
    # leaves x workers x steps for the q8 message encode and decode (in the
    # fused mode inside the backward pass); per ring (a leaf's, or one per
    # pod and model shard of it) and step n chunk quantizes at each of its
    # n positions, n - 1 accumulating dequants at each, and one all-gather
    # decode per owner, in any bucket plan; the pod stage one q8 encode
    # and one decode per pod and shard; an RWKV-6 layer runs one WKV6
    # forward and one backward per worker and step (no recompute), each
    # launched in step 1 and by the graph of a worker's pass in steps 2-3
    # (the capture issues a worker's once, each replay launches them).  The
    # natural codec's DIANA message is one natural_message a leaf, worker
    # and step; the dithering and top-k codecs are plain PyTorch, as the
    # reference's are: no kernel.  Counted before the run, from the code's
    # specs and layouts
    leaves = len(param_specs(cfg))
    rings, stage = ring_counts(cfg, mesh, w) if ring else (0, 0)
    msgs = leaves * w * STEPS if codec == "q8_block" else 0
    wkv = cfg.n_layers * w * STEPS if cfg.arch_type == "ssm" else 0
    expect = {"q8_quantize_2d": msgs + stage * STEPS,
              "q8_quantize_chunk_3d": rings * n * n * STEPS,
              "q8_dequant_add_2d": msgs + (rings * n * n + stage) * STEPS,
              "wkv6_forward": wkv, "wkv6_backward": wkv,
              "shifted_natural_2d": 0, "block_topk_2d": 0,
              "natural_message": leaves * w * STEPS if codec == "natural"
              else 0}
    expect_acc = rings * n * (n - 1) * STEPS
    what = f"main path {cfg.name} {comm_mode} {codec}" + (
        "" if rule == "diana" else f" {rule}") + mesh_name(mesh_kw) + (
        " diag" if diag else "") + ("" if not wired else
                                   f" moe_wire={wires[0]} act_wire={wires[1]}")
    if mesh_kw or wired:
        log(f"{what}: expected launches {expect} (accumulating dequant "
            f"{expect_acc}): {rings} rings of {n} positions and {stage} pod "
            f"stage encodes a step")

    torch.cuda.reset_peak_memory_stats()
    state = init_state(0, cfg, tcfg, w)            # on the CUDA device
    counter = RefreshCount(state.noise)
    state = state._replace(noise=counter)
    step = build_train_step(cfg, tcfg, w, mesh, diag=diag)
    stream = TokenStream(cfg, SEQ, BATCH)
    batches = [stream.batch(i, "cuda") for i in range(STEPS + 1)]
    torch.cuda.synchronize()

    sends, send = [], TR.Wire.send

    def counted_send(self, draw, x, e=None):     # the wires' live sends
        sends.append((self.name, tuple(x.shape)))
        return send(self, draw, x, e)

    wrappers = reset_launches()
    captured, capture = [], WG._capture

    def counted_capture(run, pool):     # the launches the capture records
        before = {name: fn.launches for name, fn in wrappers.items()}
        out = capture(run, pool)
        captured.append({name: fn.launches - before[name]
                         for name, fn in wrappers.items()})
        return out

    step_s, losses, diags = [], [], []
    rec = SpanRecorder()
    TR.Wire.send, WG._capture = counted_send, counted_capture
    try:
        with recording(rec):
            for i in range(STEPS):
                t0 = time.perf_counter()
                state, metrics = step(state, batches[i])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(metrics["loss"].item())
                if diag:
                    diags.append({k: metrics[k].item() for k in DIAG})
    finally:
        TR.Wire.send, WG._capture = send, capture
    replays = rec.snapshot().get("grads/replay", {}).get("count", 0)
    eager = wired or comm_mode in FUSED_VJP_MODES
    check((len(captured), replays) == ((0, 0) if eager else (1, STEPS - 1)),
          f"{what}: the workers' passes recorded {len(captured)} times and "
          f"replayed {replays} times in {STEPS} steps"
          + (" (wired or fused-VJP: eager)" if eager else ""))
    recorded = captured[0] if captured else {}
    # a recorded launch is issued once, in the capture, and launched by
    # each of the graph's launches, one a worker in a replay
    launches = {name: fn.launches
                + recorded.get(name, 0) * (replays * w - 1)
                for name, fn in wrappers.items()}
    acc_launches = K.q8_dequant_add_2d.acc_launches
    peak = torch.cuda.max_memory_allocated()

    check(all(math.isfinite(v) for v in losses), f"loss not finite: {losses}")
    check(all(torch.isfinite(p).all().item() for p in state.params.values()),
          "params not finite")
    refreshes = None
    if rule == "rand_diana":
        p = tcfg.compression.shift_p
        refreshes = [int((u < p).sum()) for u in counter.aux[:STEPS]]
    want = structural_bits(cfg, STEPS, codec, refreshes, reverse=async_mode,
                           w=w)
    check(metrics["bits"].item() == want,
          f"bits {metrics['bits'].item()} != structural {want}")
    check(not sends or wired, f"{what}: wires sent without being set")
    if wired:
        from repro_torch.launch.train import params_like

        acct = TR.build_transport(
            tcfg.compression, cfg, SimChannel(), w=w,
            params_like=params_like(cfg),
            tokens_per_worker=(BATCH // w) * SEQ).per_wire_bits()
        derived = wire_bits_from_shapes(cfg, w, wires)
        live = {}
        for name, shape in sends:     # an int8 block and one f32 scale
            live[name] = live.get(name, 0) + (8 * math.prod(shape) + 32)
        live = {k: v / STEPS for k, v in live.items()}
        check(acct == derived,
              f"{what}: the transport's bits a step {acct} differ from "
              f"those derived from the shapes {derived}")
        check(live == {k: v for k, v in derived.items() if k != "grad"},
              f"{what}: the steps' sends carried {live} bits a step, the "
              f"transport declares {acct}")
        log(f"{what}: bits a step by wire {acct} = the count from the "
            f"shapes = the live sends' ({len(sends) // STEPS} sends a step)")
    check(launches == expect, f"{what}: launches {launches}, expected "
                              f"{expect}")
    check(acc_launches == expect_acc,
          f"{what}: accumulating q8_dequant_add_2d launched "
          f"{acc_launches} times, expected {expect_acc}")
    for d in diags:
        check(all(math.isfinite(v) and v >= 0 for v in d.values()),
              f"{what}: diagnostics {d}")
    plan = ""
    if async_mode:
        like = {k: ShapeDtype((w, *v.shape), v.dtype, v.device)
                for k, v in state.params.items()}
        budget = tcfg.compression.overlap_bucket_bytes
        per_leaf = comm_mode in FUSED_VJP_MODES
        plan = (f", buckets {len(plan_buckets(like, budget, per_leaf=per_leaf))}"
                f" ({'one per leaf' if per_leaf else f'{budget} B budget'})")
    log(f"{what}: {cfg.n_layers} layers, "
        f"{sum(p.numel() for p in state.params.values()):,} params, "
        f"{leaves} leaves, w={w}, mesh {mesh.shape}, batch {BATCH}, seq "
        f"{SEQ}{plan}")
    log(f"{what}: losses {losses}; bits {metrics['bits'].item():.0f} "
        f"(structural" + (", summed in bucket order" if async_mode else "")
        + ("" if refreshes is None else
           f"; workers refreshed per step {refreshes}")
        + f"); launches {launches}, of which accumulating dequant "
        f"{acc_launches} (as expected)")
    for i, d in enumerate(diags):
        log(f"{what}: step {i} diagnostics " + ", ".join(
            f"{k} {v:.6e}" for k, v in d.items()))
    log(f"{what}: step seconds {[round(t, 4) for t in step_s]}; peak "
        f"memory allocated {peak / 2**30:.2f} GiB")
    digests = None
    if digest:
        t0 = time.perf_counter()
        digests = state_digests(state)
        log(f"{what}: digests of {len(digests)} leaves (params, h, h_bar) "
            f"in {time.perf_counter() - t0:.1f} s")
    h0 = {k: h[0].clone() for k, h in state.h.items()} if keep else None
    g0 = None
    if keep:    # plain gradients of one more batch: worker 0's
        from repro_torch.dist.worker_grads import per_worker_grads, split_batch
        from repro_torch.launch.train import worker_loss

        grads = per_worker_grads(
            worker_loss(cfg.with_(attn_q_chunk=tcfg.train_attn_chunk)),
            state.params, split_batch(batches[STEPS], w))[0]
        g0 = {k: g[0].clone() for k, g in grads.items()}
        del grads
    if plain_round:
        # the round takes the state's only reference; the step goes too:
        # its graph of the workers' passes holds their gradient buffers
        # and memory pool while it lives (``dist.worker_grads``)
        box, state, metrics, step = [state], None, None, None
        phase_plain_round(cfg, tcfg, box, batches[STEPS], mesh, what, w)
    return launches, digests, (g0, h0) if keep else None


DIAG = ("ef_err_norm", "grad_sq", "shift_residual_sq", "h_bar_drift")


def plain_q8():
    """The q8 kernels' plain versions behind the wrappers' signatures, and
    where the round calls them (the codec's module and the ring's)."""
    from repro_torch.dist import collectives as C
    from repro_torch.kernels.q8ring import ops as O
    from repro_torch.kernels.q8ring.ref import (q8_dequant_add_ref,
                                                q8_quantize_chunk_ref,
                                                q8_quantize_ref)

    def quantize(x, u, *, block_rows):
        return q8_quantize_ref(x, u, block=block_rows)

    def chunk(chunks, u, chunk_id, *, block_rows):
        return q8_quantize_chunk_ref(chunks, u, int(chunk_id.item()),
                                     block=block_rows)

    def dequant(q, s, acc, *, block_rows):
        return q8_dequant_add_ref(q, s, acc, block=block_rows)

    return [(O, "q8_quantize_2d", quantize), (O, "q8_dequant_add_2d", dequant),
            (C, "q8_quantize_chunk_3d", chunk), (C, "q8_dequant_add_2d",
                                                  dequant)]


def phase_plain_round(cfg, tcfg, box, batch, mesh, what, w=W):
    """One more round of the path (gradients of ``batch``, the round's
    noise at the next round) run twice from the same shifts: with the
    kernels, and with their plain versions in their place (``plain_q8``)
    -- the chunk quantize and the dequant at every per-shard ring chunk,
    the quantize and dequant at every pod-stage shard.  ``g_bar``, ``h``
    and ``h_bar`` bitwise equal.  ``box`` is a list holding the state,
    its only reference: the state is taken out of it, and the params and
    the optimizer state are dropped once the gradients are computed, and
    the kernel round's results wait on the host, to make room."""
    from repro_torch.dist.worker_grads import per_worker_grads, split_batch
    from repro_torch.kernels.q8ring import kernel as K
    from repro_torch.launch.train import build_channel, worker_loss

    cfg = cfg.with_(attn_q_chunk=tcfg.train_attn_chunk)
    comp = tcfg.compression
    q, rule = comp.make()
    channel = build_channel(comp, cfg, mesh, w)
    state = box.pop()
    grads = per_worker_grads(worker_loss(cfg), state.params,
                             split_batch(batch, w))[0]
    h, h_bar, noise = state.h, state.h_bar, state.noise
    state = None
    gc.collect()
    torch.cuda.empty_cache()
    outs = []
    for plain in (False, True):
        swapped = plain_q8() if plain else []
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swapped]
        for mod, name, fn in swapped:
            setattr(mod, name, fn)
        before = K.q8_quantize_chunk_3d.launches
        try:
            t0 = time.perf_counter()
            g_bar, h1, hb1, _ = rule.round(
                q, noise, grads, {k: v.clone() for k, v in h.items()},
                {k: v.clone() for k, v in h_bar.items()}, channel)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        check((K.q8_quantize_chunk_3d.launches == before) == plain,
              f"{what}: the plain round launched a kernel, or the kernel "
              f"round none")
        if not plain:
            g_bar, h1, hb1 = ({k: v.cpu() for k, v in t.items()}
                              for t in (g_bar, h1, hb1))
        outs.append((g_bar, h1, hb1, secs))
        g_bar = h1 = hb1 = None
        torch.cuda.empty_cache()
    for name, a, b in zip(("g_bar", "h", "h_bar"), outs[0], outs[1]):
        off = [k for k in a
               if not torch.equal(bits_of(a[k]), bits_of(b[k].cpu()))]
        check(not off, f"{what}: the kernel round's {name} differs from the "
                       f"plain round's at {off[:4]}")
    log(f"{what}: one round with the kernels ({outs[0][3]:.3f} s) bitwise "
        f"equal to the round with their plain versions ({outs[1][3]:.3f} "
        f"s): g_bar, h, h_bar of {len(outs[0][0])} leaves")
    del outs, grads
    torch.cuda.empty_cache()


NEW_CODECS = ("bernoulli", "natural_dithering", "terngrad",
              "induced_topk_randk", "induced_topk_natural")


def phase_codecs(cfg):
    """The codecs ported last, one round each on the 13 full-size leaves
    of ``cfg``: W workers' gradient-scale normal values (seed 7) through
    ``MeshChannel("dense").push_mean`` -- each worker's encode and decode,
    then the exact worker mean.  Bits: the structural codecs' equal the
    leaves' ``aot_wire_bits`` times W, added in f32 leaf by leaf as the
    uplink adds them; ``BernoulliP``'s the live count (each fired
    message's values, one flag bit a message), its ``aot_wire_bits``
    expectation beside it.  Messages and mean finite.  No kernel: the
    codecs are plain PyTorch, as the reference's are plain jnp.  Returns
    the launches (all 0)."""
    from repro_torch.comm.channel import MeshChannel
    from repro_torch.comm.wire import AddressedNoise
    from repro_torch.core.compressors import aot_wire_bits, make_compressor
    from repro_torch.models.model import param_specs

    gen = torch.Generator(device="cuda").manual_seed(7)
    g = {path: torch.randn((W, *shape), generator=gen, device="cuda") * 0.02
         for path, shape, _ in param_specs(cfg)}
    channel = MeshChannel(mode="dense")
    wrappers = reset_launches()
    for name in NEW_CODECS:
        q = make_compressor(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, mean, bits = channel.push_mean(q, AddressedNoise(3, "cuda"), g)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(all(torch.isfinite(v).all().item() for v in m.values()) and
              all(torch.isfinite(v).all().item() for v in mean.values()),
              f"codec {name}: messages not finite")
        expect = np.float32(0)
        aot = 0.0
        for k, v in g.items():
            one = aot_wire_bits(q, tuple(v.shape[1:]))
            aot += W * one
            if name == "bernoulli":
                d = v[0].numel()
                fired = int(sum(bool(m[k][j].any()) for j in range(W)))
                leaf = np.float32(fired * 32 * d + W)
            else:
                leaf = np.float32(W * one)
            expect = np.float32(expect + leaf)
        check(bits.item() == float(expect),
              f"codec {name}: bits {bits.item()} != {float(expect)}")
        extra = (f" (aot expectation {aot:.6e})" if name == "bernoulli"
                 else " (aot_wire_bits x W)")
        log(f"codec {name} over {len(g)} full-size leaves, w={W}: bits "
            f"{bits.item():.0f}{extra}; push_mean {secs:.3f} s")
        del m, mean
    launches = {k: fn.launches for k, fn in wrappers.items()}
    check(not any(launches.values()),
          f"codecs: the plain codecs launched kernels {launches}")
    del g
    torch.cuda.empty_cache()
    return launches


# -- the convex path (Algorithm 1 and 2 on the paper's problems) ------------


SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32
DECODE_TOL = 1e-4           # decode logits vs a full-sequence forward's
                            # on the same tokens, relative to the decode
                            # logits (RWKV-6: in f64, against the forward
                            # through the plain recurrence; its WKV6 kernel
                            # is held layer by layer within WKV_TOL)
FLEET_WIRES = ("dense", "q8", "natural")
FLEET = dict(steps=6, publish_every=2, replicas=2, stale_k=4, batch=4,
             seq=64, lr=1e-2, requests=6, gen_len=8, max_batch=2,
             cache_len=64)
#: BENCH_serve_delta's structural row (experiments/obs/baseline.json) at
#: the smoke size, model-wire bytes per publish
SMOKE_DELTA_BYTES = {"dense": 1444864.0, "q8": 361268.0,
                     "natural": 406368.0}
SMOKE_SYNC_BYTES, SMOKE_GRAD_BYTES = 406368.0, 1444864.0


def decode_logits(cfg, params, tokens, frames=None):
    """Teacher-forced decode of ``tokens`` (B, T) through a cache of T
    slots: every position's logits, (B, T, V).  For an encoder-decoder,
    ``frames`` (B, S_src, D): the state's encoder keys and values
    (``xkv``) are each decoder layer's ``cross_attention_kv`` of the
    encoder's output over them."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    state = M.make_decode_state(
        cfg, tokens.shape[0], tokens.shape[1], tokens.device,
        enc_len=0 if frames is None else frames.shape[1])
    if frames is not None:
        enc = M._encode(params, M._family(cfg), cfg, {"frames": frames})
        for layer, p in enumerate(M._layers(params, "blocks/xattn/",
                                            cfg.n_layers)):
            k, v = L.cross_attention_kv(p, enc, cfg)
            state["xkv/k"][layer] = k
            state["xkv/v"][layer] = v
        del enc
    out = []
    for t in range(tokens.shape[1]):
        logits, state = M.decode_step(params, cfg, tokens[:, t:t + 1], state,
                                      t)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def check_decode_against_forward(what, cfg, params, tokens, fwd=None,
                                 frames=None):
    """Decode's logits at every position against the full-sequence
    forward's on the same tokens (``fwd``, default ``forward_train``'s;
    an encoder-decoder's over ``frames``, ``decode_logits``):
    |forward - decode| <= DECODE_TOL (1 + |decode|).  Returns the decode
    logits."""
    from repro_torch.models import model as M

    with torch.no_grad():
        dec = decode_logits(cfg, params, tokens, frames)
        if fwd is None:
            batch = {"tokens": tokens}
            if frames is not None:
                batch["frames"] = frames
            fwd, _ = M.forward_train(params, cfg, batch)
    err = (fwd - dec).abs()
    share = (err / (DECODE_TOL * (1 + dec.abs()))).max().item()
    check(share <= 1 and bool(torch.isfinite(dec).all()),
          f"{what}: decode logits off the forward's at "
          f"{int((err > DECODE_TOL * (1 + dec.abs())).sum())} of "
          f"{dec.numel()} entries (max |diff| {err.max().item():.3e})")
    log(f"{what}: decode logits at all {tokens.shape[1]} positions x "
        f"{tokens.shape[0]} rows equal the forward's within "
        f"{DECODE_TOL} (1 + |decode|): max |diff| {err.max().item():.3e} at "
        f"|logits| <= {dec.abs().max().item():.3f}, at most {share:.3f} of "
        f"the bound")
    return dec


def wkv_plain_scan(r, k, v, w, u):
    """The WKV recurrence from a zero state as decode runs it: the plain
    ``wkv_step`` chain (f32, as the reference's)."""
    from repro_torch.models import rwkv6 as R6

    b, t, h, dk = r.shape
    st = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                     device=r.device)
    ys = []
    for i in range(t):
        y, st = R6.wkv_step(r[:, i], k[:, i], v[:, i], w[:, i], u, st)
        ys.append(y)
    return torch.stack(ys, 1), st


def forward_with_scan(cfg, params, tokens, scan):
    """``forward_train``'s logits with the model's WKV recurrence
    (``models.rwkv6.wkv_scan``) replaced by ``scan`` for the call."""
    from repro_torch.models import model as M
    from repro_torch.models import rwkv6 as R6

    kernel_scan = R6.wkv_scan
    try:
        R6.wkv_scan = scan
        with torch.no_grad():
            return M.forward_train(params, cfg, {"tokens": tokens})[0]
    finally:
        R6.wkv_scan = kernel_scan


def top2_margin(logits):
    """(top-1 minus top-2 logit, |top-1|) along the last axis."""
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1], top[..., 0].abs()


def margin_rule(got, want, margin, scale):
    """The margin rule: generated tokens must agree wherever the
    reference run's top-2 margin exceeds 2 DECODE_TOL (1 + |top-1|) (no
    two sets of logits within the tolerance of each other can pick
    differently there); at the first near tie where they differ, the
    two trajectories part and the comparison stops.  Returns (tokens
    compared, whether it stopped at a near tie); fails on a token that
    differs past a clear margin."""
    for t, (g, w) in enumerate(zip(got, want)):
        if g != w:
            check(margin[t] <= 2 * DECODE_TOL * (1 + scale[t]),
                  f"token {t}: {g} != {w} at a top-2 margin of "
                  f"{margin[t]:.3e}")
            return t, True
    return len(want), False


def offline_greedy(cfg, params, prompt, n_new, cache_len=64):
    """One request decoded alone (batch 1): its generated tokens and, at
    each, the top-2 margin and |top-1| of the logits that chose it."""
    from repro_torch.models import model as M

    state = M.make_decode_state(cfg, 1, cache_len, "cuda")
    out, margins, scales = [], [], []
    for t in range(len(prompt) + n_new - 1):
        cur = prompt[t] if t < len(prompt) else out[-1]
        logits, state = M.decode_step(
            params, cfg, torch.tensor([[cur]], device="cuda"), state, t)
        if t >= len(prompt) - 1:
            m, sc = top2_margin(logits[0, -1])
            out.append(int(logits[0, -1].argmax()))
            margins.append(m.item())
            scales.append(sc.item())
    return out, margins, scales


def live_publish_bits(codec, cfg):
    """A publish's bits as the stream counts them: each leaf's structural
    payload bits (``payload_like``) added to an f32 counter in leaf
    order, as the reference's counter adds them."""
    from repro_torch.core.compressors import ShapeDtype, f32_bits
    from repro_torch.models.model import param_specs

    bits = f32_bits()
    for _, shape, _ in param_specs(cfg):
        like = ShapeDtype(shape, torch.float32, torch.device("meta"))
        bits = bits + f32_bits(codec.wire_bits(codec.payload_like(like)))
    return bits.item()


def phase_family_decode(cfg):
    """Decode against the forward for one of the last three families at
    full width, random params from seed 0, batch CONFIG_BATCH: ``cfg``'s
    depth and CONFIG_TICKS ticks (deepseek-v2-lite-16b: MLA's absorbed
    decode against its expanded forward; seamless-m4t-large-v2: the
    encoder keys and values from the batch's frames), or for the hybrid
    ``attn_every`` Mamba-2 layers and one use of the shared block over
    ZAMBA_DECODE_TICKS ticks: the sequential scan, a tick at a time,
    against the forward through one SSD chunk (its calls counted)."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import model as M

    ticks = CONFIG_TICKS
    if cfg.arch_type == "hybrid":
        cfg, ticks = cfg.with_(n_layers=cfg.attn_every), ZAMBA_DECODE_TICKS
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, generator=gen, device="cuda")
    batch = TokenStream(cfg, ticks, CONFIG_BATCH).batch(0, "cuda")
    chunked, calls = M2._ssd_chunked, []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return chunked(*args, **kw)

    M2._ssd_chunked = counted
    try:
        check_decode_against_forward(
            f"decode {cfg.name} (full width, {cfg.n_layers} layers)", cfg,
            params, batch["tokens"], frames=batch.get("frames"))
    finally:
        M2._ssd_chunked = chunked
    if cfg.arch_type == "hybrid":
        check(len(calls) == cfg.n_layers and all(
            c[1] == M2.CHUNK for c in calls),
            f"decode {cfg.name}: the forward ran {len(calls)} chunked SSD "
            f"calls {calls[:2]}, expected one chunk a layer")
    log(f"decode {cfg.name}: {ticks} ticks x {CONFIG_BATCH} rows"
        + (f", the forward through {len(calls)} SSD chunks of {M2.CHUNK}"
           if calls else "") + f"; {time.perf_counter() - t0:.1f} s")
    del params, batch
    torch.cuda.empty_cache()


def phase_configs():
    """The dense 20-32B configs and the VLM at full width, cut to
    CONFIG_LAYERS layer: internlm2-20b, qwen1.5-32b, qwen2.5-32b (seq
    SEQ) and llava-next-34b (seq 640: its 576 prefix positions and 64
    text positions); and seamless-m4t-large-v2 at full depth (24 + 24
    layers, seq SEQ over SEQ frames); batch CONFIG_BATCH, random params
    from seed 0.  Per config one loss and backward, no optimizer state:
    loss and every gradient finite; then CONFIG_TICKS teacher-forced
    decode ticks, their logits against the forward's within DECODE_TOL
    (the VLM's forward with an empty prefix: it decodes as the dense
    family; the audio decoder with its encoder keys and values from the
    batch's frames, ``decode_logits``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import model as M

    cut = dict(n_layers=CONFIG_LAYERS)
    for arch, seq, layers in (("internlm2-20b", SEQ, cut),
                              ("qwen1.5-32b", SEQ, cut),
                              ("qwen2.5-32b", SEQ, cut),
                              ("llava-next-34b", 640, cut),
                              ("seamless-m4t-large-v2", SEQ, {})):
        cfg = get_config(arch).with_(dtype="float32", **layers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = M.init_params(cfg, generator=gen, device="cuda")
        batch = TokenStream(cfg, seq, CONFIG_BATCH).batch(0, "cuda")
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, _ = M.train_loss(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lv = loss.item()
        check(math.isfinite(lv), f"config {arch}: loss {lv}")
        bad = [k for k, g in zip(leaves, grads) if not torch.isfinite(g).all()]
        check(not bad, f"config {arch}: gradients not finite at {bad[:4]}")
        peak = torch.cuda.max_memory_allocated()
        del grads, leaves, loss
        params = {k: v.detach() for k, v in params.items()}
        text = batch["tokens"][:, :CONFIG_TICKS]
        fwd = None
        if cfg.modality == "vision_prefix":
            with torch.no_grad():
                fwd = M.forward_train(params, cfg, {
                    "tokens": text, "prefix": torch.zeros(
                        (CONFIG_BATCH, 0, cfg.d_model), device="cuda")})[0]
        check_decode_against_forward(f"config {arch}", cfg, params, text, fwd,
                                     frames=batch.get("frames"))
        depth = (f"{cfg.n_layers} + {cfg.n_enc_layers} encoder layers"
                 if cfg.is_encoder_decoder else f"{cfg.n_layers} layer")
        log(f"config {arch} (full width, {depth}, "
            f"{sum(p.numel() for p in params.values()):,} params, batch "
            f"{CONFIG_BATCH}, seq {seq}, tokens {tuple(batch['tokens'].shape)}"
            f"{', prefix ' + str(tuple(batch['prefix'].shape)) if 'prefix' in batch else ''}): "
            f"loss {lv:.4f}, "
            f"gradients finite; init {t1 - t0:.2f} s, loss and backward "
            f"{t2 - t1:.3f} s; peak {peak / 2**30:.2f} GiB")
        del params, batch, fwd
        torch.cuda.empty_cache()


def phase_serve(qwen, rwkv):
    """The serve entry point on the card: the CLI's greedy path on
    full-size qwen3-0.6b with a ``q8_block`` model broadcast (the two q8
    kernels, counted), decode against the training forward for qwen3 and
    rwkv6-3b, the continuous-batching engine against requests decoded
    alone, and the trainer -> fleet delta stream at full size for the
    dense, q8 and natural model wires, then the smoke ``run_fleet_demo``
    against the baseline's structural row.  Returns the serve path's
    kernel launches."""
    from repro_torch.comm.channel import SimChannel
    from repro_torch.comm.transport import build_transport, wire_flag_codec
    from repro_torch.comm.wire import AddressedNoise
    from repro_torch.configs.base import CompressionConfig, TrainConfig
    from repro_torch.core.compressors import ShapeDtype, make_compressor
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.q8ring import kernel as K
    from repro_torch.kernels.wkv6 import kernel as WK
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.train import build_train_step, init_state
    from repro_torch.models import model as M
    from repro_torch.models import rwkv6 as R6
    from repro_torch.models.model import param_specs
    from repro_torch.serving import (
        Engine,
        Request,
        TrainerFleetBridge,
        run_fleet_demo,
    )

    t_phase = time.perf_counter()
    # -- 1. the CLI's greedy path, qwen3-0.6b full size --------------------
    torch.cuda.synchronize()
    wrappers = reset_launches()
    res = serve.main(["--arch", "qwen3-0.6b", "--batch", str(SERVE_BATCH),
                      "--prompt-len", str(SERVE_PROMPT), "--gen-len",
                      str(SERVE_GEN), "--broadcast-compressor", "q8_block"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    leaves = len(res.params)
    expect = dict.fromkeys(wrappers, 0)
    expect.update(q8_quantize_2d=leaves, q8_dequant_add_2d=leaves)
    check(launches == expect and K.q8_dequant_add_2d.acc_launches == 0,
          f"serve: launches {launches}, expected {expect}")
    want_bits = live_publish_bits(make_compressor("q8_block"), qwen)
    check(res.bits == want_bits,
          f"serve: broadcast bits {res.bits} != structural {want_bits}")
    ticks = SERVE_PROMPT + SERVE_GEN
    log(f"serve qwen3-0.6b (full size, {leaves} leaves): q8_block broadcast "
        f"{res.bits:.0f} bits (structural), launches {launches} (as "
        f"expected); greedy batch {SERVE_BATCH}, {ticks} ticks: "
        f"{1e3 * res.seconds / ticks:.3f} ms a tick, {SERVE_BATCH * ticks / res.seconds:.1f} "
        f"tok/s (host clock over the loop, first tick included)")
    fed = res.tokens[:, :ticks]
    dec = check_decode_against_forward("serve qwen3-0.6b", qwen,
                                       res.params, fed)
    margin, scale = top2_margin(dec)
    agree = [margin_rule(res.tokens[b, 1:].tolist(),
                         dec[b].argmax(-1).tolist(), margin[b].tolist(),
                         scale[b].tolist())[0] for b in range(SERVE_BATCH)]
    log(f"serve qwen3-0.6b: the greedy tokens equal the teacher-forced "
        f"decode's argmax by the margin rule ({agree} of {ticks} a row)")
    del dec, margin, scale

    # -- 2. rwkv6-3b, full width, RWKV_LAYERS layers -----------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    rparams = M.init_params(rwkv, generator=gen, device="cuda")
    rtoks, rsecs = serve.greedy_decode(rwkv, rparams, SERVE_BATCH, ticks,
                                       "cuda")
    log(f"serve rwkv6-3b ({rwkv.n_layers} layers, full width): greedy batch "
        f"{SERVE_BATCH}, {ticks} ticks: {1e3 * rsecs / ticks:.3f} ms a tick, "
        f"{SERVE_BATCH * ticks / rsecs:.1f} tok/s")
    rtoks = rtoks[:, :ticks]
    # the WKV6 kernel, layer by layer: its output and final state against
    # the plain wkv_step chain on the same inputs, within WKV_TOL
    worst, kernel_scan = [0.0], R6.wkv_scan

    def held_scan(r, k, v, w, u):
        got, want = kernel_scan(r, k, v, w, u), wkv_plain_scan(r, k, v, w, u)
        for g, p in zip(got, want):
            err = (g - p).abs()
            check(bool((err <= WKV_TOL * (1 + p.abs())).all()),
                  f"WKV6 kernel forward off the wkv_step chain by "
                  f"{err.max().item():.3e} at {tuple(r.shape)}")
            worst[0] = max(worst[0], err.max().item())
        return got

    WK.wkv6_forward.launches = 0
    kern = forward_with_scan(rwkv, rparams, rtoks, held_scan)
    check(WK.wkv6_forward.launches == rwkv.n_layers,
          f"rwkv6-3b forward launched WKV6 {WK.wkv6_forward.launches} "
          f"times, expected {rwkv.n_layers}")
    log(f"serve rwkv6-3b: every layer's WKV6 kernel forward equals the "
        f"plain wkv_step chain on its inputs within {WKV_TOL} (1 + |plain|) "
        f"(y and final state; max |diff| {worst[0]:.3e})")
    # decode against the forward: in f32 the products at M = 4 and at
    # M = 192 round apart, and the per-head group norm divides by
    # sqrt(var + 1e-5) with var down to ~1e-10 at the first tokens, so
    # the logits part by up to ~1e-3 (PERF.md, Findings); f64 (the
    # recurrence itself stays f32, as the reference's) shows the two are
    # one function
    plain = forward_with_scan(rwkv, rparams, rtoks, wkv_plain_scan)
    with torch.no_grad():
        dec32 = decode_logits(rwkv, rparams, rtoks)
    check(all(bool(torch.isfinite(t).all()) for t in (kern, plain, dec32)),
          "rwkv6-3b logits not finite")
    log(f"serve rwkv6-3b in f32: decode logits against the forward through "
        f"the plain chain max |diff| {(plain - dec32).abs().max().item():.3e}"
        f", through the WKV6 kernel {(kern - dec32).abs().max().item():.3e};"
        f" |logits| <= {dec32.abs().max().item():.3f}")
    del kern, plain, dec32
    p64 = {k: v.double() for k, v in rparams.items()}
    r64 = rwkv.with_(dtype="float64")
    check_decode_against_forward(
        "serve rwkv6-3b in f64 (the forward through the plain chain)", r64,
        p64, rtoks, fwd=forward_with_scan(r64, p64, rtoks, wkv_plain_scan))
    del p64
    del rparams, rtoks
    torch.cuda.empty_cache()

    # -- 3. the engine at full size: each request as if decoded alone ------
    pgen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, qwen.vocab_size, (2 + i % 3,),
                             generator=pgen).tolist() for i in range(6)]
    eng = Engine(qwen, res.params, max_batch=2, cache_len=64)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=FLEET["gen_len"]))
    t0 = time.perf_counter()
    done = sorted(eng.run(), key=lambda r: r.uid)
    eng_s = time.perf_counter() - t0
    check(len(done) == 6, f"engine finished {len(done)} of 6 requests")
    compared, stops = 0, 0
    for r, p in zip(done, prompts):
        want, margins, scales = offline_greedy(qwen, res.params, p,
                                               FLEET["gen_len"])
        n, stopped = margin_rule(r.output, want, margins, scales)
        compared += n
        stops += stopped
    log(f"engine (qwen3-0.6b full size, 6 requests over 2 slots, "
        f"{eng.clock} ticks in {eng_s:.3f} s): outputs equal each request "
        f"decoded alone on {compared} of {6 * FLEET['gen_len']} tokens by "
        f"the margin rule ({stops} stopped at a near tie)")
    del eng, res
    torch.cuda.empty_cache()

    # -- 4. the trainer -> fleet delta stream at full size -----------------
    like = {path: ShapeDtype(shape, torch.float32, torch.device("meta"))
            for path, shape, _ in param_specs(qwen)}
    nat_bits = live_publish_bits(wire_flag_codec("natural"), qwen)
    structural = {"dense": float(sum(math.prod(v.shape) * 32
                                     for v in like.values())),
                  "q8": live_publish_bits(wire_flag_codec("q8"), qwen),
                  "natural": nat_bits}
    for wire in FLEET_WIRES:
        torch.cuda.reset_peak_memory_stats()
        comp = CompressionConfig(enabled=False, model_wire=wire,
                                 publish_every=FLEET["publish_every"])
        tcfg = TrainConfig(learning_rate=FLEET["lr"],
                           total_steps=FLEET["steps"], warmup_steps=1,
                           compression=comp)
        transport = build_transport(comp, qwen, SimChannel(), w=1,
                                    params_like=like)
        state = init_state(0, qwen, tcfg, 1, "cuda")
        step_fn = build_train_step(qwen, tcfg, 1, HostMesh(data=1,
                                                           device="cuda"))
        stream = TokenStream(qwen, FLEET["seq"], FLEET["batch"])
        bridge = TrainerFleetBridge(
            qwen, state.params, transport["model"],
            n_replicas=FLEET["replicas"],
            publish_every=FLEET["publish_every"], stale_k=FLEET["stale_k"],
            noise=AddressedNoise(1, "cuda"), max_batch=FLEET["max_batch"],
            cache_len=FLEET["cache_len"],
            sync_codec=wire_flag_codec("natural"))
        timed = {"publish": [], "apply": []}

        def timer(fn, key):
            """``fn`` timed on the host clock, synchronised, where it did
            work (an apply pass that applied nothing is not kept)."""
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                if out != 0:
                    timed[key].append(time.perf_counter() - t0)
                return out
            return run

        bridge.publisher.publish = timer(bridge.publisher.publish, "publish")
        for rep in bridge.fleet.replicas:
            rep.apply_pending = timer(rep.apply_pending, "apply")
        rgen = torch.Generator().manual_seed(2)
        for i in range(FLEET["requests"]):
            prompt = torch.randint(0, qwen.vocab_size, (2 + i % 3,),
                                   generator=rgen).tolist()
            bridge.fleet.submit(Request(uid=i, prompt=prompt,
                                        max_new_tokens=FLEET["gen_len"]))
        losses = []
        t0 = time.perf_counter()
        for i in range(FLEET["steps"]):
            state, metrics = step_fn(state, stream.batch(i, "cuda"))
            losses.append(metrics["loss"].item())
            bridge.on_step(state.params, i + 1)
        bridge.drain()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        st = bridge.stats()
        want = structural[wire] / 8
        n_pub = FLEET["steps"] // FLEET["publish_every"]
        check(all(math.isfinite(v) for v in losses),
              f"fleet {wire}: loss not finite: {losses}")
        check(st["delta_bytes"] == [want] * n_pub,
              f"fleet {wire}: delta bytes {st['delta_bytes']}, structural "
              f"{want} a publish")
        check(st["sync_bytes"] == nat_bits / 8,
              f"fleet {wire}: sync bytes {st['sync_bytes']} != "
              f"{nat_bits / 8}")
        per_step = transport.per_wire_bits()
        codec = wire_flag_codec(wire)
        aot = sum(codec.wire_bits(codec.payload_like(v)) for v in like.values())
        check(per_step == {"grad": structural["dense"],
                           "model": aot / FLEET["publish_every"]},
              f"fleet {wire}: per-step wire bits {per_step}")
        check((st["publishes"], st["resyncs"], st["requests_done"],
               st["tokens_served"], st["max_staleness"])
              == (n_pub, 0, FLEET["requests"],
                  FLEET["requests"] * FLEET["gen_len"], 0),
              f"fleet {wire}: publishes/resyncs/requests/tokens/staleness "
              f"{st['publishes']}, {st['resyncs']}, {st['requests_done']}, "
              f"{st['tokens_served']}, {st['max_staleness']}")
        # lockstep: a replica holds the publisher's h_bar bitwise; on the
        # lossless stream that is the trainer's params
        target = state.params if wire == "dense" else bridge.publisher.h_bar
        want_d = tree_digests(target)
        for rep in bridge.fleet.replicas:
            got_d = tree_digests(rep.params)
            off = [k for k in want_d if got_d[k] != want_d[k]]
            check(not off, f"fleet {wire}: replica {rep.rid} differs from "
                           f"the {'trainer' if wire == 'dense' else 'h_bar'}"
                           f" at {off[:4]}")
        log(f"fleet qwen3-0.6b full size, wire {wire}: {n_pub} publishes of "
            f"{want:.0f} bytes (structural; AOT per step model "
            f"{per_step['model'] / 8:.0f}, grad {per_step['grad'] / 8:.0f}), "
            f"sync {st['sync_bytes']:.0f} bytes; replicas bitwise the "
            f"{'trainer' if wire == 'dense' else 'publisher h_bar'} by "
            f"{len(want_d)} leaf digests; losses {losses}; publish s "
            f"{[round(t, 4) for t in timed['publish']]}; apply s "
            f"{[round(t, 4) for t in timed['apply']]}; err_rel "
            f"{st['err_rel']}; max staleness {st['max_staleness']}, resyncs "
            f"{st['resyncs']}, {st['tokens_served']} tokens served; "
            f"{run_s:.2f} s in all; peak {peak / 2**30:.2f} GiB")
        # the timers on the publisher and replicas close over their bound
        # methods: a cycle, which only the collector frees
        del bridge, state, step_fn, transport
        gc.collect()
        torch.cuda.empty_cache()

    # -- 5. the smoke demo against the baseline's structural row -----------
    for wire in FLEET_WIRES:
        row = run_fleet_demo("qwen3-0.6b", n_replicas=2, model_wire=wire,
                             publish_every=2, stale_k=4, steps=4,
                             n_requests=4, gen_len=8, device="cuda")
        got = (row["delta_bytes"], row["sync_bytes"],
               row["wire_bytes_per_step"], row["publishes"], row["resyncs"],
               row["requests_done"], row["tokens_served"],
               row["max_staleness"])
        want = ([SMOKE_DELTA_BYTES[wire]] * 2, SMOKE_SYNC_BYTES,
                {"grad": SMOKE_GRAD_BYTES,
                 "model": SMOKE_DELTA_BYTES[wire] / 2}, 2, 0, 4, 32, 0)
        check(got == want, f"smoke run_fleet_demo {wire}: {got} != the "
                           f"baseline's {want}")
        log(f"smoke run_fleet_demo {wire} on the card: the baseline's "
            f"structural row exactly; err_rel {row['err_rel']}, final loss "
            f"{row['final_loss']:.6f}")
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


OBS_STEPS = 2               # the trainer CLI's steps in phase_obs
#: each span of the trainer's steps on the card and the span it is opened
#: in (None: the step's): the first step's passes run eagerly, the
#: second records one worker's pass as a CUDA graph and replays it once a
#: worker (``dist.worker_grads``), so the passes' spans open in the first
#: step's ``train/grads`` and in the capture
OBS_SPANS = {"train/grads": None, "grads/capture": "train/grads",
             "grads/replay": "train/grads",
             "grads/forward": "grads/capture|train/grads",
             "grads/backward": "grads/capture|train/grads",
             "train/round": None, "round/message": "train/round",
             "round/aggregate": "train/round", "round/apply": "train/round",
             "train/apply": None}
OBS_RATE_SLACK = 1.05       # calibrated rates may exceed the peaks by this


def _bitwise(a, b):
    """Two tensors of one dtype and shape equal bit for bit."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def _tree_bitwise(a, b):
    """The leaves of two ``{path: tensor}`` trees that differ bitwise."""
    return [k for k in a if not _bitwise(a[k], b[k])]


def phase_obs(cfg):
    """Observability on the card (phase 13): the trainer CLI
    (``launch.train.main``) on full-size ``cfg``, ``q8_ring_fused``, DIANA
    + ``q8_block``, W workers over ``--mesh-data W`` ring positions, batch
    BATCH, seq SEQ, OBS_STEPS steps, run without observability and then
    with ``--metrics_out`` and ``--trace``:

    (a) the final params, shifts and master shift of the two runs bitwise
        equal, and each q8 kernel launched exactly as the steps (and,
        with observability, the run header's codec probes) give;
    (b) the JSONL passes ``export --check``; its run record's grad wire
        reports the structural wire bits and payload bytes counted from
        the leaf layouts, positive encode and decode seconds and an
        ``omega_hat`` within the q8 codec's certificate, a hide fraction
        in [0, 1] and a finite positive predicted step time; one step
        record a step, with positive ``step_s``; the span table holds
        ``host/step`` OBS_STEPS times and inside it every span of the
        step (``OBS_SPANS``, each under its parent, self time within its
        total; the passes eager in the first step, recorded in the second
        and replayed from then on), and besides at most ``host/gc``;
    (c) ``calibrate_rates`` reads no more than the card's f32 and memory
        peaks (times OBS_RATE_SLACK; a higher reading would mean the
        clock did not wait for the device), ``calibrate_link`` fitted;
    (d) ``tree_distortion`` of the q8 codec over the W-stacked leaves,
        run with the kernels and with their plain versions in their
        place: ``err_sq`` and ``norm_sq`` bitwise equal;
    (e) a checkpoint of the final state (params, AdamW moments, shifts)
        saved and restored onto the card, bitwise equal to it.

    Returns the kernels' launch counts of the observed run."""
    import os
    import tempfile

    from repro_torch import tune
    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.comm.channel import SimChannel
    from repro_torch.comm.transport import build_transport
    from repro_torch.comm.wire import AddressedNoise
    from repro_torch.configs.base import CompressionConfig
    from repro_torch.core.compressors import ShapeDtype, make_compressor
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models.model import param_specs
    from repro_torch.obs import check_jsonl, export, read_jsonl
    from repro_torch.obs.quality import tree_distortion

    t_phase = time.perf_counter()
    what = f"obs {cfg.name} q8_ring_fused q8_block"
    mesh = HostMesh(data=W, device="cuda")
    flags = ["--arch", cfg.name, "--steps", str(OBS_STEPS), "--batch",
             str(BATCH), "--seq", str(SEQ), "--comm-mode", "q8_ring_fused",
             "--compressor", "q8_block", "--mesh-data", str(W)]
    # launches, from the leaves and the ring: the steps' message encodes
    # and decodes and the ring's chunks; with observability, the run
    # header's probes of one W-stacked grad-wire payload add codec_timings'
    # encode (once, then a warm-up and 2 timed calls) and decode (a
    # warm-up and 2 timed calls) and codec_quality's encode and decode
    leaves = len(param_specs(cfg))
    rings, _ = ring_counts(cfg, mesh, W)
    msgs = leaves * W * OBS_STEPS
    chunks = rings * W * W * OBS_STEPS
    expect_off = {"q8_quantize_2d": msgs, "q8_quantize_chunk_3d": chunks,
                  "q8_dequant_add_2d": msgs + chunks, "wkv6_forward": 0,
                  "wkv6_backward": 0, "shifted_natural_2d": 0,
                  "block_topk_2d": 0, "natural_message": 0}
    expect_on = dict(expect_off, q8_quantize_2d=msgs + 5 * W,
                     q8_dequant_add_2d=msgs + chunks + 4 * W)

    build = T.build_train_step
    step_s = {}

    def run(obs_flags, key):
        """One CLI run, each step timed between device synchronisations
        (outside the program: the obs-off run has no clock of its own)."""
        times = step_s.setdefault(key, [])

        def timed_build(*args, **kw):
            step = build(*args, **kw)

            def timed(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                return out

            return timed

        wrappers = reset_launches()
        T.build_train_step = timed_build
        try:
            state = T.main(flags + obs_flags)
        finally:
            T.build_train_step = build
        torch.cuda.synchronize()
        return state, {name: fn.launches for name, fn in wrappers.items()}

    t0 = time.perf_counter()
    off, launches_off = run([], "off")
    t_off = time.perf_counter() - t0
    check(launches_off == expect_off,
          f"{what} (obs off): launches {launches_off}, expected {expect_off}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    jsonl = os.path.join(tmp, "run.jsonl")
    try:
        t0 = time.perf_counter()
        on, launches_on = run(["--metrics_out", jsonl, "--trace"], "on")
        t_on = time.perf_counter() - t0
        check(launches_on == expect_on,
              f"{what} (obs on): launches {launches_on}, expected "
              f"{expect_on}")
        # (a) observability changes nothing of the state
        for part in ("params", "h", "h_bar"):
            off_part = _tree_bitwise(getattr(off, part), getattr(on, part))
            check(not off_part, f"{what}: {part} differ with --metrics_out "
                                f"--trace at {off_part[:4]}")
        check(_bitwise(off.bits, on.bits), f"{what}: bits differ")
        log(f"{what}: params, h and h_bar after {OBS_STEPS} steps bitwise "
            f"equal with and without --metrics_out --trace; launches "
            f"{launches_on} with, {launches_off} without (as expected)")
        del off
        torch.cuda.empty_cache()

        # (b) the records
        n, errors = check_jsonl(jsonl)
        check(not errors, f"{what}: invalid records {errors[:4]}")
        check(export.main(["--check", jsonl]) == 0, f"{what}: export --check")
        recs = read_jsonl(jsonl)
        run_rec = recs[0]["data"]
        grad = run_rec["wires"]["grad"]
        counts = [q8_message_counts(math.prod(shape), W)
                  for _, shape, _ in param_specs(cfg)]
        bits = sum(c[0] for c in counts)
        nbytes = sum(c[1] for c in counts)
        acct = build_transport(
            CompressionConfig(comm_mode="q8_ring_fused",
                              compressor="q8_block"), cfg, SimChannel(),
            w=W, params_like=T.params_like(cfg))["grad"]
        check(grad["wire_bits"] == bits,
              f"{what}: grad wire_bits {grad['wire_bits']} != structural "
              f"{bits}")
        check(grad["payload_bytes"] == nbytes == acct.payload_nbytes(),
              f"{what}: grad payload_bytes {grad['payload_bytes']} != "
              f"{nbytes} from the layouts")
        check(grad["encode_s"] > 0 and grad["decode_s"] > 0,
              f"{what}: encode_s {grad['encode_s']} decode_s "
              f"{grad['decode_s']}")
        within = [math.prod(s[1:]) for s in
                  ((W, *shape) for _, shape, _ in param_specs(cfg))
                  if 4 * math.prod(s) <= 1 << 18]
        probe_d = max(within)   # codec_quality's probe: the largest leaf
        cert = make_compressor("q8_block").omega(probe_d)
        check(0 < grad["omega_hat"] <= cert,
              f"{what}: omega_hat {grad['omega_hat']} vs certificate {cert}")
        check(0.0 <= run_rec["hide_fraction"] <= 1.0,
              f"{what}: hide_fraction {run_rec['hide_fraction']}")
        pred = run_rec["predicted_step_s"]
        check(pred is not None and math.isfinite(pred) and pred > 0,
              f"{what}: predicted_step_s {pred}")
        steps = [r for r in recs if r["kind"] == "step"]
        check([r["step"] for r in steps] == list(range(OBS_STEPS))
              and all(r["data"]["step_s"] > 0 for r in steps),
              f"{what}: step records {steps}")
        # every span of the step under host/step; a garbage collection
        # (host/gc) may or may not fall inside the run
        spans = recs[-1]["data"]["spans"]
        check(set(spans) - {"host/gc"} == {"host/step", *OBS_SPANS}
              and spans["host/step"]["count"] == OBS_STEPS
              and spans["grads/forward"]["count"] == W + 1
              and spans["grads/capture"]["count"] == 1
              and spans["grads/replay"]["count"] == OBS_STEPS - 1
              and all(0.0 <= sp["self_s"] <= sp["total_s"]
                      for sp in spans.values())
              and all(spans[n]["parent"] == (p or "host/step")
                      for n, p in OBS_SPANS.items()),
              f"{what}: span table {spans}")
        rec_s = [r["data"]["step_s"] for r in steps]
        log(f"{what}: {n} records, export --check OK; grad wire "
            f"{grad['wire_bits']:.0f} bits = structural, "
            f"{grad['payload_bytes']:.0f} B payload = the layouts'; "
            f"encode_s {grad['encode_s']:.6e} decode_s "
            f"{grad['decode_s']:.6e} (one ({W}, ...) payload of "
            f"<= 1 MiB); omega_hat {grad['omega_hat']:.6e} <= certificate "
            f"{cert:.6e} (d = {probe_d}); hide_fraction "
            f"{run_rec['hide_fraction']:.6f} ({run_rec['hide_source']}); "
            f"predicted_step_s {pred:.6e} (nominal link, comm only)")
        log(f"{what}: step_s by the records {rec_s}; by the script's "
            f"synchronised clock, obs on {step_s['on']}, obs off "
            f"{step_s['off']}; whole CLI run {t_on:.2f} s on, {t_off:.2f} "
            f"s off")
    finally:
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)

    # (c) honest clocks
    rates = tune.calibrate_rates()
    wlike = {k: ShapeDtype((W, *v.shape), v.dtype, v.device)
             for k, v in T.params_like(cfg).items()}
    link = tune.calibrate_link(mesh, wlike)
    log(f"{what}: calibrate_rates {rates.flops_per_s:.6e} FLOP/s (f32) "
        f"{rates.hbm_bytes_per_s:.6e} B/s; calibrate_link alpha "
        f"{link.alpha_s:.6e} s beta {link.beta_s_per_byte:.6e} s/B "
        f"({1 / max(link.beta_s_per_byte, 1e-30):.6e} B/s)")
    check(rates.flops_per_s <= OBS_RATE_SLACK * F32_OPS_PER_S
          and rates.hbm_bytes_per_s <= OBS_RATE_SLACK * HBM_BYTES_PER_S,
          f"{what}: calibrated rates above the card's peaks: {rates}")

    # (d) the q8 kernels through the distortion probe vs their plain ones
    tree = tune.synth_wtree(5, wlike, device="cuda")
    q8 = make_compressor("q8_block")
    wrappers = reset_launches()
    got = tree_distortion(q8, AddressedNoise(21, "cuda"), tree)
    launched = {k: wrappers[k].launches for k in ("q8_quantize_2d",
                                                  "q8_dequant_add_2d")}
    check(launched == {"q8_quantize_2d": leaves * W,
                       "q8_dequant_add_2d": leaves * W},
          f"{what}: tree_distortion launches {launched}")
    swaps = plain_q8()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        want = tree_distortion(q8, AddressedNoise(21, "cuda"), tree)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    del tree
    for k in ("err_sq", "norm_sq", "omega_hat", "nmse"):
        check(_bitwise(got[k], want[k]),
              f"{what}: tree_distortion {k} {got[k].item()} with the "
              f"kernels, {want[k].item()} with their plain versions")
    log(f"{what}: tree_distortion over {leaves} ({W}, ...) leaves: "
        f"omega_hat {got['omega_hat'].item():.6e} nmse "
        f"{got['nmse'].item():.6e}; err_sq and norm_sq bitwise equal with "
        f"the kernels ({launched}) and with their plain versions")

    # (e) checkpoint of the final state: one file a part, the parts
    # saved side by side and restored side by side (zipfile's CRC and the
    # writes and reads let go of the interpreter)
    from concurrent.futures import ThreadPoolExecutor

    state = {"params": on.params, "m": on.opt.m, "v": on.opt.v, "h": on.h,
             "h_bar": on.h_bar}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    paths = {k: os.path.join(tmp, f"{k}.npz") for k in state}
    try:
        with ThreadPoolExecutor(len(state)) as pool:
            t0 = time.perf_counter()
            for f in [pool.submit(save, paths[k], v, step=on.step)
                      for k, v in state.items()]:
                f.result()
            t_save = time.perf_counter() - t0
            size = sum(os.path.getsize(p) for p in paths.values())
            t0 = time.perf_counter()
            back = {k: pool.submit(restore, paths[k], v, device="cuda")
                    for k, v in state.items()}
            back = {k: f.result() for k, f in back.items()}
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
    finally:
        for p in paths.values():
            if os.path.exists(p):
                os.remove(p)
        os.rmdir(tmp)
    off_leaves = [f"{k}/{leaf}" for k in state
                  for leaf in _tree_bitwise(state[k], back[k])]
    check(not off_leaves, f"{what}: checkpoint differs at {off_leaves[:4]}")
    check(all(t.device.type == "cuda" for t in back["params"].values()),
          f"{what}: restore did not land on the card")
    check(all(latest_step(p) is None for p in paths.values()),
          f"{what}: checkpoint files left behind")
    log(f"{what}: checkpoint of params, AdamW moments, h and h_bar "
        f"({size / 2**30:.2f} GiB in {len(paths)} files) saved in "
        f"{t_save:.1f} s, restored onto the card in {t_restore:.1f} s, "
        f"bitwise equal")
    del back, state, on
    torch.cuda.empty_cache()
    log(f"the obs phase: {time.perf_counter() - t_phase:.1f} s")
    return launches_on


def check_same_state(what, name, got, want):
    """Fail unless two train states' params, shifts, master shift and
    bits are bitwise equal (compared on the card)."""
    for part in ("params", "h", "h_bar"):
        off = _tree_bitwise(getattr(got, part), getattr(want, part))
        check(not off, f"{what}: {name} differs in {part} at {off[:4]}")
    check(_bitwise(got.bits, want.bits), f"{what}: {name} bits differ")


def io_capture(fn):
    """``(fn(), its standard output)``; the output's ``tune:`` lines are
    logged."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith("tune:"):
            log(line)
    return out, text


TUNE_STEPS = 2              # steps of each --comm_mode auto run
DRYRUNS = (("qwen3-0.6b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"))
USEFUL_FRAC = (0.3, 1.05)   # qwen3 train_4k's 6 N D over the pass's flops


def phase_tune(cfg):
    """The tuner on the card (phase 14): the trainer CLI
    (``launch.train.main``) on full-size ``cfg``, DIANA + ``q8_block``, W
    workers over ``--mesh-data W``, batch BATCH, seq SEQ, TUNE_STEPS
    steps, ``--comm_mode auto`` with a fresh ``--tune-cache`` and the full
    default grid:

    (a) the first run prints ``tune: searched`` and writes one strict-JSON
        plan with at least one measured candidate and exactly one chosen,
        a finite ``predicted_step_s`` with a nonzero compute half (the
        cost pass of the dense step at full width); its rows, choice,
        calibrated rates and link, hide fraction, omega and the pass's
        flops and bytes are printed;
    (b) a second run with the same flags prints ``tune: cache hit`` and
        calls none of the suppliers and no measurement (each counted by
        a wrapper here);
    (c) a run with ``--tune-plan`` (and ``--metrics_out``) ends bitwise
        equal to (b), and both to ``build_train_step`` run in-process
        with ``apply_plan(comp, plan)``;
    (d) that run's record carries the plan's ``predicted_step_s``,
        printed against the steps' measured ``step_s``;
    (e) ``launch.dryrun`` of qwen3-0.6b x train_4k and qwen2-moe-a2.7b x
        decode_32k (the cost pass on the meta device) each end ``ok``,
        qwen3's ``useful_flops_frac`` within USEFUL_FRAC.

    Returns the kernels' launch counts of run (a)."""
    import os
    import shutil
    import tempfile

    from repro_torch import tune
    from repro_torch.configs.base import CompressionConfig, TrainConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.obs import read_jsonl
    from repro_torch.tune import search

    t_phase = time.perf_counter()
    what = f"tune {cfg.name} auto q8_block"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    cache = os.path.join(tmp, "cache")
    flags = ["--arch", cfg.name, "--steps", str(TUNE_STEPS), "--batch",
             str(BATCH), "--seq", str(SEQ), "--compressor", "q8_block",
             "--mesh-data", str(W), "--comm_mode", "auto"]
    calls, secs, results = {}, {}, {}
    # every supplier and measurement of the search, by the attribute its
    # caller reads it through, counted and timed
    suppliers = [(T, "dense_step_analysis"), (tune, "calibrate_rates"),
                 (tune, "measure_overlap_hide"), (tune, "measure_omega"),
                 (search, "calibrate_link"), (search, "measure_candidate")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in suppliers]

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
            results[name] = out
            return out
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    captured = {}
    analyze = T.step_cost

    def kept_cost(*args, **kw):
        captured["analysis"] = out = analyze(*args, **kw)
        return out

    T.step_cost = kept_cost
    try:
        # (a) the search
        wrappers = reset_launches()
        t0 = time.perf_counter()
        state, text = io_capture(lambda: T.main(flags + ["--tune-cache",
                                                         cache]))
        t_search_run = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        check("tune: searched" in text, f"{what}: no 'tune: searched' in "
                                        f"{text[-600:]}")
        files = os.listdir(cache)
        check(len(files) == 1, f"{what}: plan cache holds {files}")
        plan_path = os.path.join(cache, files[0])
        raw = open(plan_path).read()
        check("NaN" not in raw and "Infinity" not in raw,
              f"{what}: the plan is not strict JSON")
        plan = tune.load_plan(plan_path)
        rows = plan.candidates
        measured = [r for r in rows if r["measured_step_s"] is not None]
        check(len(measured) >= 1 and sum(r["chosen"] for r in rows) == 1,
              f"{what}: {len(measured)} measured rows, "
              f"{sum(r['chosen'] for r in rows)} chosen")
        chosen = next(r for r in rows if r["chosen"])
        check(math.isfinite(plan.predicted_step_s)
              and chosen["compute_s"] > 0,
              f"{what}: predicted_step_s {plan.predicted_step_s}, compute "
              f"half {chosen['compute_s']}")
        analysis = captured["analysis"]
        for name in ("dense_step_analysis", "calibrate_rates",
                     "measure_overlap_hide", "measure_omega",
                     "calibrate_link"):
            check(calls.get(name) == 1, f"{what}: {name} called "
                                        f"{calls.get(name)} times")
        check(calls.get("measure_candidate") == len(measured),
              f"{what}: measure_candidate called "
              f"{calls.get('measure_candidate')} times for {len(measured)} "
              f"measured rows")
        ring_rows = [r["comm_mode"] for r in measured] + [plan.comm_mode]
        fused_ring = any(m not in ("dense", "randk_shared", "q8_ring", "ef21",
                                   "efbv") for m in ring_rows)
        check(launches["q8_quantize_2d"] > 0
              and launches["q8_dequant_add_2d"] > 0
              and (launches["q8_quantize_chunk_3d"] > 0) == fused_ring,
              f"{what}: launches {launches} (a fused-ring mode measured or "
              f"chosen: {fused_ring})")
        for r in rows:
            log(f"{what}: rank {r['rank']:2d} {r['label']:<44s} predicted "
                f"{r['predicted_step_s']:.6e} s (comm "
                f"{r['predicted_comm_s']:.6e}, compute {r['compute_s']:.6e}, "
                f"encode "
                f"{r['encode_s']:.6e}; {r['n_buckets']} buckets, "
                f"{r['wire_bytes']:.6e} B/worker)  measured comm "
                f"{r['measured_comm_s']}  step {r['measured_step_s']}"
                f"{'  CHOSEN' if r['chosen'] else ''}")
        log(f"{what}: chose {plan.comm_mode} (bucket "
            f"{plan.overlap_bucket_bytes}, randk_q {plan.randk_q}, block "
            f"{plan.q8_block_rows}); predicted_step_s "
            f"{plan.predicted_step_s:.6e} measured_step_s "
            f"{plan.measured_step_s}; hide {plan.hide_fraction} "
            f"({plan.hide_source}); omega {plan.omega} ({plan.omega_source})")
        log(f"{what}: the dense step's cost pass (W = {W}, batch {BATCH}, "
            f"seq {SEQ}): flops {analysis['flops']:.6e} bytes "
            f"{analysis['bytes']:.6e} transcendentals "
            f"{analysis['transcendentals']:.6e} collectives "
            f"{analysis['collective_bytes_by_kind']}; 6 N D = "
            f"{6 * cfg.param_count() * BATCH * SEQ:.6e}")
        log(f"{what}: the search's suppliers, seconds: "
            + ", ".join(f"{k} {v:.3f} ({calls[k]}x)" for k, v in
                        sorted(secs.items()))
            + f"; the whole first CLI run {t_search_run:.2f} s")
        searched = state      # held on the card beside the next run
        del state
        mesh = HostMesh(data=W, device="cuda")
        rates, link = results["calibrate_rates"], results["calibrate_link"]
        hide, omega = (results["measure_overlap_hide"],
                       results["measure_omega"])
        log(f"{what}: the search's calibrated rates {rates.flops_per_s:.6e} "
            f"FLOP/s {rates.hbm_bytes_per_s:.6e} B/s; link alpha "
            f"{link.alpha_s:.6e} s beta {link.beta_s_per_byte:.6e} s/B; "
            f"hide probe {hide}; omega probe {omega}")

        # (b) the cache
        before = dict(calls)
        t0 = time.perf_counter()
        state, text = io_capture(lambda: T.main(flags + ["--tune-cache",
                                                         cache]))
        t_hit_run = time.perf_counter() - t0
        check("tune: cache hit" in text, f"{what}: no 'tune: cache hit' in "
                                         f"{text[-600:]}")
        check(calls == before, f"{what}: the cache hit called "
                               f"{ {k: calls[k] - before.get(k, 0) for k in calls} }")
        cached = state
        del state
        check_same_state(what, "the cached run", cached, searched)
        del searched
        torch.cuda.empty_cache()

        # (c) the plan file, and the plan applied in-process
        jsonl = os.path.join(tmp, "run.jsonl")
        state, text = io_capture(lambda: T.main(
            flags + ["--tune-plan", plan_path, "--metrics_out", jsonl]))
        check(f"tune: plan file {plan_path}" in text,
              f"{what}: --tune-plan not used")
        check(calls == before, f"{what}: --tune-plan measured")
        check_same_state(what, "--tune-plan", state, cached)
        del state
        torch.cuda.empty_cache()
        comp = tune.apply_plan(CompressionConfig(compressor="q8_block",
                                                 comm_mode="auto"), plan)
        tcfg = TrainConfig(learning_rate=LR, total_steps=TUNE_STEPS,
                           warmup_steps=max(1, TUNE_STEPS // 10),
                           compression=comp)
        state = T.init_state(0, cfg, tcfg, W, "cuda")
        step = T.build_train_step(cfg, tcfg, W, mesh)
        stream = TokenStream(cfg, SEQ, BATCH)
        for i in range(TUNE_STEPS):
            state, _ = step(state, stream.batch(i, "cuda"))
        check_same_state(what, "build_train_step(apply_plan)", state,
                         cached)
        n_leaves = len(cached.params)
        del state, step, cached
        torch.cuda.empty_cache()
        log(f"{what}: searched, cache-hit, --tune-plan and in-process "
            f"apply_plan runs bitwise equal after {TUNE_STEPS} steps "
            f"(params, h and h_bar, {n_leaves} leaves each); the cache hit "
            f"called no supplier and measured nothing ({t_hit_run:.2f} s)")

        # (d) the prediction against the steps
        recs = read_jsonl(jsonl)
        run_rec = recs[0]["data"]
        check(run_rec["predicted_step_s"] == plan.predicted_step_s
              and run_rec["hide_fraction"] == plan.hide_fraction
              and run_rec["omega"] == plan.omega,
              f"{what}: the run record {run_rec['predicted_step_s']}, "
              f"{run_rec['hide_fraction']}, {run_rec['omega']} is not the "
              f"plan's")
        step_s = [r["data"]["step_s"] for r in recs if r["kind"] == "step"]
        check(len(step_s) == TUNE_STEPS and all(t > 0 for t in step_s),
              f"{what}: step records {step_s}")
        log(f"{what}: predicted_step_s {plan.predicted_step_s:.6e} (the "
            f"plan's, in the run record) vs measured step_s {step_s}: "
            f"ratio predicted/measured "
            f"{plan.predicted_step_s / step_s[-1]:.6e} (last step)")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        T.step_cost = analyze
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) the dry-run
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        for arch, shape in DRYRUNS:
            t0 = time.perf_counter()
            rc = dryrun.main(["--arch", arch, "--shape", shape, "--out",
                              out_dir])
            rec = json.load(open(os.path.join(
                out_dir, f"{arch}_{shape}_pod256_dense.json")))
            check(rc == 0 and rec["status"] == "ok",
                  f"dryrun {arch} x {shape}: {rec.get('error')}")
            r = rec["roofline"]
            log(f"dryrun {arch} x {shape}: ok in "
                f"{time.perf_counter() - t0:.1f} s; flops "
                f"{r['hlo_flops']:.6e} bytes {r['hlo_bytes']:.6e} "
                f"useful_flops_frac {r['useful_flops_frac']:.6f} "
                f"dominant {r['dominant']}")
            if shape == "train_4k":
                lo, hi = USEFUL_FRAC
                check(lo < r["useful_flops_frac"] <= hi,
                      f"dryrun {arch} x {shape}: useful_flops_frac "
                      f"{r['useful_flops_frac']} outside ({lo}, {hi}]")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"the tune phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


class RecordingNoise:
    """A noise source that keeps every draw it hands out, tagged as
    ``repro_torch.comm.wire`` tags them, for a replay elsewhere."""

    def __init__(self, source):
        self.source, self.tags, self.draws = source, [], []

    def _keep(self, tag, t):
        self.tags.append(tag)
        self.draws.append(t)
        return t

    def uniform(self, leaf, worker, shape, part=None):
        return self._keep(("uniform", leaf, worker, part),
                          self.source.uniform(leaf, worker, shape, part))

    def permutation(self, leaf, worker, d, part=None):
        return self._keep(("permutation", leaf, worker, part),
                          self.source.permutation(leaf, worker, d, part))

    def aux_uniform(self, shape):
        return self._keep(("aux", None, None, None),
                          self.source.aux_uniform(shape))

    def replay(self, device):
        """The draws as a ``ReplayNoise`` on ``device``: each dtype's
        draws moved in one copy."""
        flat = {}
        for i, t in enumerate(self.draws):
            flat.setdefault(t.dtype, []).append(i)
        out = [None] * len(self.draws)
        for idx in flat.values():
            parts = torch.cat([self.draws[i].reshape(-1) for i in idx]).to(
                device).split([self.draws[i].numel() for i in idx])
            for i, p in zip(idx, parts):
                out[i] = p.view(self.draws[i].shape)
        return ReplayNoise(list(zip(self.tags, out)))


class ReplayNoise:
    """Hands back recorded draws in order, checking each one's tag."""

    def __init__(self, draws):
        self.draws, self.at = draws, 0

    def _pop(self, tag):
        want, t = self.draws[self.at]
        check(tag == want, f"replay: draw {self.at} asked as {tag}, "
                           f"recorded as {want}")
        self.at += 1
        return t

    def uniform(self, leaf, worker, shape, part=None):
        return self._pop(("uniform", leaf, worker, part))

    def permutation(self, leaf, worker, d, part=None):
        return self._pop(("permutation", leaf, worker, part))

    def aux_uniform(self, shape):
        return self._pop(("aux", None, None, None))


def convex_runs(P):
    """The convex runs: name -> (problem, runner, method, gamma, steps,
    seed, use_star), each with its theorem test's compressor, step size,
    step count and seed (tests/test_theorems.py on the paper's ridge
    instance; tests/test_algorithms.py's Rand-DIANA on logistic
    regression, here at fig4_logreg's m = 300, d = 60).  ``P`` is the
    problems on one device."""
    from repro_torch import core as C

    r = P["ridge"]
    n, d = r.n_workers, r.d
    q = C.RandK(0.25)
    om = q.omega(d)
    c = C.TopK(0.1)
    alpha, g_d = C.stepsize_diana(r.L_max, om, 0.0, n)
    alpha_c, g_dc = C.stepsize_diana(r.L_max, om, C.TopK(0.25).delta(d), n)
    p = C.rand_diana_default_p(om)
    g_ef = 16.0 * C.stepsize_ef21(r.L, r.L_max, c.delta(d))
    eta_c, nu_c = C.efbv_params(delta=c.delta(d))
    g_bvc = 16.0 * C.stepsize_efbv(r.L, r.L_max, delta=c.delta(d), eta=eta_c,
                                   nu=nu_c)
    eta_u, nu_u = C.efbv_params(omega=om)
    g_bvu = 16.0 * C.stepsize_efbv(r.L, r.L_max, omega=om, eta=eta_u,
                                   nu=nu_u)
    q5 = C.RandK(0.5)
    eta_g, gamma_g = C.stepsize_gdci(r.L, r.L_max, r.mu, q5.omega(d), n)
    a_v, eta_v, gamma_v = C.stepsize_vr_gdci(r.L, r.L_max, r.mu,
                                             q5.omega(d), n)
    lg = P["logreg"]
    p_l = C.rand_diana_default_p(q.omega(lg.d))
    g_l = C.stepsize_rand_diana(lg.L_max, q.omega(lg.d), lg.n_workers, p_l)[1]
    D = C.DCGDShift
    return {
        "fixed": (r, "dcgd", D(q, C.FixedShift()),
                  C.stepsize_dcgd_fixed(r.L, r.L_max, om, n), 4000, 0, False),
        "star": (r, "dcgd", D(q, C.StarShift()),
                 C.stepsize_dcgd_star(r.L, r.L_max, om, 0.0, n), 6000, 0,
                 True),
        "diana": (r, "dcgd", D(q, C.DianaShift(alpha=alpha)), g_d, 8000, 0,
                  False),
        "diana_topk": (r, "dcgd", D(q, C.DianaShift(alpha=alpha_c,
                                                    c=C.TopK(0.25))),
                       g_dc, 8000, 0, False),
        "rand_diana": (r, "dcgd", D(q, C.RandDianaShift(p=p)),
                       C.stepsize_rand_diana(r.L_max, om, n, p)[1], 20000, 0,
                       False),
        "ef21_topk": (r, "dcgd", D(c, C.EF21Shift()), g_ef, 12000, 0, False),
        "fixed_topk": (r, "dcgd", D(c, C.FixedShift()), g_ef, 12000, 0,
                       False),
        "efbv_topk": (r, "dcgd", D(c, C.EFBVShift(eta=eta_c, nu=nu_c)),
                      g_bvc, 12000, 0, False),
        "efbv_randk": (r, "dcgd", D(q, C.EFBVShift(eta=eta_u, nu=nu_u)),
                       g_bvu, 12000, 0, False),
        "gdci": (r, "gdci", C.GDCI(q5, gamma=gamma_g, eta=eta_g), None,
                 20000, 0, False),
        "vr_gdci": (r, "gdci", C.VRGDCI(q5, gamma=gamma_v, eta=eta_v,
                                        alpha=a_v), None, 20000, 0, False),
        "logreg_rand_diana": (lg, "dcgd", D(q, C.RandDianaShift(p=p_l)), g_l,
                              15000, 9, False),
    }


def convex_claims(tr):
    """Each theorem test's assertions on the card's traces ``tr``
    (name -> Trace): name -> (holds, what).  Runs of 6000 and 3000 steps
    in the tests are prefixes of the longer runs here (same seed, same
    draws)."""
    e = {k: t.rel_err for k, t in tr.items()}
    med = float(np.median(e["fixed_topk"][-1000:]))
    return {
        "thm1 DCGD neighborhood": (1e-12 < e["fixed"][-500:].mean() < 1e-2,
                                   e["fixed"][-500:].mean()),
        "thm2 STAR exact": (e["star"][-1] < 1e-9, e["star"][-1]),
        "thm2 STAR beats DCGD": (e["star"][2999] < 1e-2 * e["fixed"][2999],
                                 (e["star"][2999], e["fixed"][2999])),
        "thm3 DIANA exact": (e["diana"][-1] < 1e-6 and e["diana"][-1]
                             < 0.05 * e["diana"][4000], e["diana"][-1]),
        "thm3 DIANA + TopK exact": (
            e["diana_topk"][-1] < 1e-6
            and e["diana_topk"][-1] < 0.05 * e["diana_topk"][4000],
            e["diana_topk"][-1]),
        "thm4 Rand-DIANA exact": (
            e["rand_diana"][-1] < 1e-6
            and e["rand_diana"][-1] < 0.05 * e["rand_diana"][8000],
            e["rand_diana"][-1]),
        "EF21 + TopK exact, DCGD + TopK stalls": (
            e["ef21_topk"][-1] < 1e-8
            and e["ef21_topk"][-1] < 0.05 * e["ef21_topk"][6000]
            and med > 1e-4 and e["ef21_topk"][-1] < 1e-3 * med,
            (e["ef21_topk"][-1], med)),
        "EF-BV + TopK exact": (
            e["efbv_topk"][-1] < 1e-8
            and e["efbv_topk"][-1] < 0.05 * e["efbv_topk"][6000],
            e["efbv_topk"][-1]),
        "EF-BV + RandK exact": (
            tr["efbv_randk"].steps_to_tol(1e-6) < 4000
            and e["efbv_randk"][-1] < 1e-10, e["efbv_randk"][-1]),
        "thm5 GDCI neighborhood": (
            1e-14 < e["gdci"][5800:6000].mean() < 1e-1,
            e["gdci"][5800:6000].mean()),
        "thm6 VR-GDCI exact, below GDCI": (
            e["vr_gdci"][-1] < 1e-8 and e["vr_gdci"][-1] < e["gdci"][-1],
            (e["vr_gdci"][-1], e["gdci"][-1])),
        "Rand-DIANA on logreg": (e["logreg_rand_diana"][-1] < 1e-2,
                                 e["logreg_rand_diana"][-1]),
    }


def phase_convex(card):
    """Algorithm 1 and 2 on the card (``core.simulate``), every run of
    ``convex_runs`` from the port's own draws (a ``GeneratorNoise`` on
    the card, recorded), timed with CUDA events over the whole run; each
    theorem test's conclusion checked on the card's traces; then every
    run again on the CPU with the card's draws and x0 replayed, its bits
    trace equal to the card's, element for element.  Returns the µs per
    step by run."""
    from repro_torch.comm.wire import GeneratorNoise
    from repro_torch.core.simulate import default_x0, run_dcgd_shift, run_gdci
    from repro_torch.data.problems import make_logreg, make_ridge

    def problems(dev):
        return {"ridge": make_ridge(m=100, d=80, n_workers=10, seed=0,
                                    noise=10.0, device=dev),
                "logreg": make_logreg(m=300, d=60, n_workers=10,
                                      device=dev)}

    def run(spec, noise, x0):
        prob, runner, method, gamma, steps, seed, star = spec
        if runner == "gdci":
            return run_gdci(prob, method, steps, x0=x0, noise=noise)
        return run_dcgd_shift(prob, method, gamma, steps, x0=x0,
                              use_star=star, noise=noise)

    on_card, on_cpu = convex_runs(problems("cuda")), convex_runs(
        problems("cpu"))
    traces, us, worst = {}, {}, {}
    for name, spec in on_card.items():
        prob, steps, seed = spec[0], spec[4], spec[5]
        noise = RecordingNoise(GeneratorNoise(seed, "cuda"))
        x0 = default_x0(prob, seed)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        tr = run(spec, noise, x0)          # reads the traces back: syncs
        end.record()
        torch.cuda.synchronize()
        us[name] = start.elapsed_time(end) * 1e3 / steps
        check(np.isfinite(tr.rel_err).all(), f"convex {name}: rel_err not "
                                             f"finite")
        replay = noise.replay("cpu")
        tr_cpu = run(on_cpu[name], replay, x0.cpu())
        check(replay.at == len(replay.draws),
              f"convex {name}: the CPU run used {replay.at} of "
              f"{len(replay.draws)} draws")
        check(np.array_equal(tr.bits, tr_cpu.bits),
              f"convex {name}: bits trace differs from the CPU's")
        hi = tr_cpu.rel_err > 1e-9
        worst[name] = float((np.abs(tr.rel_err[hi] - tr_cpu.rel_err[hi])
                             / tr_cpu.rel_err[hi]).max(initial=0.0))
        traces[name] = tr
        log(f"convex {name} ({prob.name}, {steps} steps): final rel_err "
            f"{tr.rel_err[-1]:.4e}, bits {tr.bits[-1]:.0f} (equal to the "
            f"CPU replay's, every step), {us[name]:.1f} us/step on the card; "
            f"rel_err vs CPU replay: largest relative difference above "
            f"1e-9 {worst[name]:.2e}  [{card}]")
    for claim, (ok, value) in convex_claims(traces).items():
        check(bool(ok), f"convex: {claim} does not hold: {value}")
        log(f"convex claim holds: {claim} ({value})")
    return us


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wkv6-against", type=Path, metavar="OTHER.cu",
                    help="only time another version of wkv6.cu against "
                         "the checkout's")
    ap.add_argument("--topk-against", type=Path, nargs="+",
                    metavar="OTHER.cu",
                    help="only time other versions of topk.cu against "
                         "the checkout's")
    args = ap.parse_args(argv)
    card = phase_card()
    if args.wkv6_against is not None or args.topk_against is not None:
        if args.wkv6_against is not None:
            wkv6_against(args.wkv6_against)
        if args.topk_against is not None:
            topk_against(args.topk_against)
        log(card)
        return
    from repro_torch.configs import get_config

    qwen = get_config("qwen3-0.6b").with_(dtype="float32")
    rwkv = get_config("rwkv6-3b").with_(dtype="float32", n_layers=RWKV_LAYERS)
    moe = get_config("qwen2-moe-a2.7b").with_(dtype="float32",
                                              n_layers=MOE_LAYERS)
    deepseek = get_config("deepseek-v2-lite-16b").with_(
        dtype="float32", n_layers=DEEPSEEK_LAYERS)
    zamba = get_config("zamba2-1.2b").with_(dtype="float32",
                                            n_layers=ZAMBA_LAYERS)
    seamless = get_config("seamless-m4t-large-v2").with_(
        dtype="float32", n_layers=SEAMLESS_LAYERS,
        n_enc_layers=SEAMLESS_LAYERS)
    families = [(deepseek, ("q8", "q8")), (zamba, ("none", "none")),
                (seamless, ("none", "none"))]
    phase_build()
    kernels = (phase_kernels(qwen, also=(rwkv, moe, deepseek, zamba,
                                         seamless))
               + [phase_ring_kernels(qwen)]
               + phase_wkv6_kernels(rwkv) + phase_natural_topk_kernels(qwen))
    for k, rows in phase_moe_pod_layouts(
            moe, qwen, also=(deepseek, zamba, seamless)).items():
        next(r for r in kernels if r["name"] == k)["at_moe_pod_layouts"] = rows
    paths = [(qwen, "dense", "q8_block", "diana"),
             (qwen, "q8_ring_fused", "q8_block", "diana"),
             (rwkv, "dense", "q8_block", "diana"),
             (qwen, "dense", "natural", "diana"),
             (qwen, "ef21", "topk", "diana"),
             (qwen, "dense", "randk", "rand_diana")]
    # the overlap runtime and the fused backward encode, each held by
    # digest against the q8_ring_fused path of its rule (EF-BV's run only
    # for that)
    efbv_ring = (qwen, "q8_ring_fused", "q8_block", "efbv")
    overlap_paths = [(qwen, "q8_ring_overlap", "q8_block", "diana"),
                     (qwen, "efbv_overlap", "q8_block", "diana"),
                     (qwen, "q8_ring_fused_vjp", "q8_block", "diana")]
    for cfg, mode, codec, rule in (paths[:5] + overlap_paths
                                   + [(qwen, "dense", "randk", "vr_gdci")]):
        phase_cross_check(cfg.name, mode, codec, rule)
    phase_cross_check(moe.name, "q8_ring_fused", wires=("q8", "q8"))
    phase_cross_check("llava-next-34b", "dense")
    t0 = time.perf_counter()
    phase_cross_check(deepseek.name, "q8_ring_fused", wires=("q8", "q8"))
    phase_wire_rehearsal(deepseek.name)
    phase_cross_check(zamba.name, "q8_ring_fused")
    phase_cross_check(seamless.name, "dense")
    log(f"the last three families' cross-checks: "
        f"{time.perf_counter() - t0:.1f} s")
    by_path, digests = {}, {}
    for cfg, mode, codec, rule in paths + [efbv_ring] + overlap_paths:
        name = f"{cfg.name} {mode} {codec}" + (
            "" if rule == "diana" else f" {rule}")
        by_path[name], digests[name], kept = phase_main_path(
            cfg, mode, codec, keep=codec == "natural", rule=rule,
            digest=cfg is qwen and ring_mode(mode))
        if kept is not None:
            entry_inputs = kept
        del kept
        torch.cuda.empty_cache()
    for _, mode, codec, _ in overlap_paths:
        ref = f"qwen3-0.6b q8_ring_fused {codec}" + (
            " efbv" if mode == "efbv_overlap" else "")
        got, want = digests[f"qwen3-0.6b {mode} {codec}"], digests[ref]
        off = [k for k in want if got[k] != want[k]]
        check(not off, f"{mode}: {len(off)} leaves differ from {ref} after "
                       f"{STEPS} steps: {off[:4]}")
        log(f"{mode}: params, h and h_bar after {STEPS} steps bitwise equal "
            f"to {ref} ({len(want)} leaf digests)")
    # the production layout on one card: the pod stage and the model
    # shards' rings, their kernels held against the plain versions in one
    # round; a mesh of one pod is the data ring
    pod_mesh = dict(pod=2, data=2, model=2)
    name = "qwen3-0.6b q8_ring_fused q8_block" + mesh_name(pod_mesh)
    by_path[name], _, _ = phase_main_path(
        qwen, "q8_ring_fused", mesh_kw=pod_mesh, plain_round=True)
    torch.cuda.empty_cache()
    one_pod = dict(pod=1, data=4, model=1)
    name = "qwen3-0.6b q8_ring_fused q8_block" + mesh_name(one_pod)
    by_path[name], got, _ = phase_main_path(
        qwen, "q8_ring_fused", mesh_kw=one_pod, digest=True)
    want = digests["qwen3-0.6b q8_ring_fused q8_block"]
    off = [k for k in want if got[k] != want[k]]
    check(not off, f"{name}: {len(off)} leaves differ from the data ring's")
    log(f"{name}: params, h and h_bar after {STEPS} steps bitwise equal to "
        f"HostMesh(data=4)'s ({len(want)} leaf digests)")
    torch.cuda.empty_cache()
    # shared-pattern Rand-K with the diagnostics on, against the same run
    # without them
    runs = {}
    for diag in (True, False):
        name = "qwen3-0.6b randk_shared natural" + (" diag" if diag else "")
        by_path[name], runs[diag], _ = phase_main_path(
            qwen, "randk_shared", "natural", digest=True, diag=diag)
        torch.cuda.empty_cache()
    off = [k for k in runs[False] if runs[True][k] != runs[False][k]]
    check(not off, f"randk_shared: the diag run's state differs at {off[:4]}")
    log(f"randk_shared: params, h and h_bar after {STEPS} steps with the "
        f"diagnostics bitwise equal to the run without ({len(off)} of "
        f"{len(runs[False])} leaf digests differ)")
    del runs
    # the MoE family at full width, cut in depth, both wires on the ring
    t0 = time.perf_counter()
    name = f"{moe.name} q8_ring_fused q8_block moe_wire=q8 act_wire=q8"
    by_path[name], _, _ = phase_main_path(
        moe, "q8_ring_fused", mesh_kw=dict(data=MOE_W), plain_round=True,
        w=MOE_W, wires=("q8", "q8"))
    torch.cuda.empty_cache()
    log(f"the MoE path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_configs()
    log(f"the configs phase: {time.perf_counter() - t0:.1f} s")
    # the last three families at full width, cut in depth, over the ring
    for cfg, wires in families:
        t0 = time.perf_counter()
        name = f"{cfg.name} q8_ring_fused q8_block" + (
            "" if wires == ("none", "none") else
            f" moe_wire={wires[0]} act_wire={wires[1]}")
        by_path[name], _, _ = phase_main_path(
            cfg, "q8_ring_fused", mesh_kw=dict(data=MOE_W), plain_round=True,
            w=MOE_W, wires=wires)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        phase_family_decode(cfg)
        log(f"the {cfg.name} path: {t1 - t0:.1f} s, its decode "
            f"{time.perf_counter() - t1:.1f} s")
    by_path["qwen3-0.6b codecs"] = phase_codecs(qwen)
    by_path["qwen3-0.6b dense natural_dithering"], _, _ = phase_main_path(
        qwen, "dense", "natural_dithering")
    torch.cuda.empty_cache()
    by_path["qwen3-0.6b entry points"] = phase_entry_points(*entry_inputs)
    del entry_inputs
    torch.cuda.empty_cache()
    by_path["qwen3-0.6b serve"] = phase_serve(qwen, rwkv)
    torch.cuda.empty_cache()
    by_path["qwen3-0.6b train --metrics_out --trace"] = phase_obs(qwen)
    torch.cuda.empty_cache()
    by_path["qwen3-0.6b train --comm_mode auto"] = phase_tune(qwen)
    torch.cuda.empty_cache()
    phase_convex(card)
    # each kernel's launches on the path of the slice that ported it: the
    # q8 kernels on the ring path (which runs all three), WKV6 on RWKV-6's,
    # the natural and top-k kernels on their entry points, the natural
    # message on DIANA + natural's
    own_path = {"wkv6_forward": "rwkv6-3b dense q8_block",
                "wkv6_backward": "rwkv6-3b dense q8_block",
                "shifted_natural_2d": "qwen3-0.6b entry points",
                "block_topk_2d": "qwen3-0.6b entry points",
                "natural_message": "qwen3-0.6b dense natural"}
    for k in kernels:
        k["launches"] = by_path[own_path.get(
            k["name"], "qwen3-0.6b q8_ring_fused q8_block")][k["name"]]
        k["launches_by_path"] = {m: c.get(k["name"], 0)
                                 for m, c in by_path.items()}
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
