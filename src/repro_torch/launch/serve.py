"""Serving: batched single-token decode -- the port of the reference's
``repro/launch/serve.py``.

``build_serve_step`` returns the decode function; ``broadcast_params``
routes the model broadcast (the downlink) through the same ``comm``
Channel the trainer uses for its uplink, so a quantized weight broadcast
(``int8``, ``q8_block`` -- the q8 kernels on the card -- or ``natural``)
shares the codecs and their structural wire accounting.

Decode-shape policy (the reference's): ``decode_32k`` uses the
full-length cache; ``long_500k`` the native O(1) state for ssm and an
8192-token sliding-window ring cache for every attention-bearing arch;
the audio enc-dec skips ``long_500k``.  ``decode_state_pspecs`` gives the
decode state's partition specs on a mesh (``dist.sharding``);
``decode_specs`` the dry-run's decode inputs, on the meta device.

CLI:  PYTHONPATH=src python -m repro_torch.launch.serve --arch ARCH \\
          [--smoke] [--batch B] [--prompt-len P] [--gen-len G] \\
          [--broadcast-compressor identity|int8|q8_block|natural] \\
          [--serve_fleet N [--model_wire dense|q8|natural|...] \\
           [--publish_every K] [--stale_k K] [--trainer_steps N]] \\
          [--device cuda|cpu]

``ARCH`` is any id of ``repro_torch.configs.ARCH_IDS``: qwen3-0.6b,
internlm2-20b, qwen1.5-32b, qwen2.5-32b, llava-next-34b (its text
decoder: the vision prefix is a training-time input), qwen2-moe-a2.7b
(the ``kv_moe`` caches), deepseek-v2-lite-16b (MLA's latent caches),
rwkv6-3b, zamba2-1.2b (the Mamba-2 states and the shared block's caches)
or seamless-m4t-large-v2 (its decoder over ``prompt_len`` zero encoder
positions, as the reference's CLI); or the port-only zamba2-7b (the
grouped Mamba-2 states, and each hybrid layer's cache of its shared
block, ``n_heads x head_dim`` = 7168 wide).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.comm.wire import AddressedNoise
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M

LONG_WINDOW = 8192


def serving_config(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Arch variant actually served for a given decode shape."""
    if shape_name == "long_500k" and cfg.arch_type != "ssm":
        if cfg.arch_type == "audio":
            raise ValueError("long_500k is skipped for the audio enc-dec "
                             "(see DESIGN.md)")
        return cfg.with_(sliding_window=LONG_WINDOW)
    return cfg


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window > 0:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def build_serve_step(cfg: ModelConfig):
    def serve_step(params, state, tok, pos: int):
        return M.decode_step(params, cfg, tok, state, pos)
    return serve_step


def decode_specs(cfg: ModelConfig, seq_len: int, global_batch: int):
    """``(params, state, tok, pos)`` for one decode step at ``seq_len`` --
    the dry-run's inputs: params and state as meta tensors (the
    reference's ``ShapeDtypeStruct`` specs), ``tok`` (B, 1) int64 on meta,
    and ``pos`` the host int the port's decode step takes (the last
    position of the cache, ``seq_len - 1``; the reference's is a traced
    scalar)."""
    meta = torch.device("meta")
    cache_len = cache_len_for(cfg, seq_len)
    enc_len = seq_len if cfg.is_encoder_decoder else 0
    params = {path: torch.empty(shape, dtype=M.leaf_dtype(cfg, init),
                                device=meta)
              for path, shape, init in M.param_specs(cfg)}
    state = M.make_decode_state(cfg, global_batch, cache_len, meta,
                                enc_len=enc_len)
    tok = torch.empty((global_batch, 1), dtype=torch.int64, device=meta)
    return params, state, tok, seq_len - 1


def decode_state_pspecs(state_shapes, mesh) -> dict:
    """Cache sharding: batch over the worker axes, sequence over
    ``model``, by the last part of each leaf's path
    (``models.model.make_decode_state``):

      attention ``k``/``v``  (L, B, C, KV, Dh) -> (None, data, model, ...)
      mla ``ckv``/``kr``     (L, B, C, r)      -> (None, data, model, None)
      ``kpos``               (L, C)            -> replicated
      recurrent states       (L, B, ...)       -> batch over data

    validated against the mesh (``dist.sharding.validate_pspecs``)."""
    from repro_torch.dist.sharding import PSpec, validate_pspecs

    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    data = data_axes if data_axes else None
    specs = {}
    for path, leaf in state_shapes.items():
        nd = len(leaf.shape)
        last = path.split("/")[-1]
        if last == "kpos":
            specs[path] = PSpec()
            continue
        if last in ("k", "v", "ckv", "kr"):
            dims = [None, data, "model"] + [None] * (nd - 3)
        else:
            dims = [None, data] + [None] * (nd - 2)
        specs[path] = PSpec(*dims[:nd])
    return validate_pspecs(state_shapes, specs, mesh)


def broadcast_params(params, compressor: str = "identity", *, noise=None,
                     channel=None, comm_mode: str = "sim"):
    """Model broadcast through the Channel downlink: each leaf encoded
    with the named codec and decoded on the receiving side.  Returns
    ``(params_received, wire_bits)``, the bits structural.  ``comm_mode``
    builds the channel when none is passed, through ``make_channel``, so
    ``auto`` or a typo fails here, naming the accepted modes.  ``noise``
    defaults to ``AddressedNoise(0)`` on the params' device."""
    from repro_torch.comm.channel import make_channel
    from repro_torch.core.compressors import make_compressor

    channel = channel if channel is not None else make_channel(comm_mode)
    q = make_compressor(compressor)
    if noise is None:
        noise = AddressedNoise(0, next(iter(params.values())).device)
    return channel.broadcast(q, noise, params)


def greedy_decode(cfg: ModelConfig, params, batch: int, ticks: int, device,
                  enc_len: int = 0):
    """Batched greedy decode for ``ticks`` ticks from one random token a
    row (drawn on the CPU from seed 1), through a cache of ``ticks``
    slots (an encoder-decoder's state with ``enc_len`` zero encoder
    positions, as the reference's CLI has it).  Returns ``(tokens (B, 1 + ticks), seconds)``: the first
    token, then each tick's greedy token; the loop's seconds on the host
    clock, synchronised.  The next tokens stay on the device: a tick
    never waits for the one before."""
    state = M.make_decode_state(cfg, batch, ticks, device, enc_len=enc_len)
    step = build_serve_step(cfg)
    toks = torch.randint(0, cfg.vocab_size, (batch, 1),
                         generator=torch.Generator().manual_seed(1)
                         ).to(device)
    t0 = time.perf_counter()
    out = [toks[:, 0]]
    for t in range(ticks):
        logits, state = step(params, state, toks, t)
        toks = logits[:, -1:].argmax(dim=-1)
        out.append(toks[:, 0])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return torch.stack(out, 1), time.perf_counter() - t0


class ServeResult(NamedTuple):
    tokens: torch.Tensor     # (B, 1 + prompt_len + gen_len): the random
    #                          first token, then each tick's greedy token
    params: dict             # the params served (after the broadcast)
    bits: float              # the broadcast's structural wire bits
    seconds: float           # the decode loop, host clock, synchronised


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--broadcast-compressor", "--broadcast_compressor",
                    dest="broadcast_compressor", default="identity",
                    help="codec for the model-broadcast downlink "
                         "(identity = exact, int8/q8_block/natural = "
                         "quantized)")
    ap.add_argument("--serve_fleet", "--serve-fleet", dest="serve_fleet",
                    type=int, default=0,
                    help="N > 0: run the trainer->fleet delta-stream demo "
                         "with N continuous-batching replicas instead of "
                         "the single-host greedy loop")
    ap.add_argument("--model_wire", "--model-wire", dest="model_wire",
                    default="q8",
                    help="model-downlink codec flag for the fleet demo "
                         "(dense = lossless bit-delta, q8/natural/topk/...)")
    ap.add_argument("--publish_every", "--publish-every",
                    dest="publish_every", type=int, default=2,
                    help="trainer steps between delta publishes")
    ap.add_argument("--stale_k", "--stale-k", dest="stale_k", type=int,
                    default=4, help="staleness bound K (steps behind the "
                                    "trainer) before a dense resync")
    ap.add_argument("--trainer_steps", "--trainer-steps",
                    dest="trainer_steps", type=int, default=6,
                    help="trainer steps to run in the fleet demo")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.serve_fleet > 0:
        from repro_torch.serving import run_fleet_demo

        stats = run_fleet_demo(
            args.arch, n_replicas=args.serve_fleet,
            model_wire=args.model_wire, publish_every=args.publish_every,
            stale_k=args.stale_k, steps=args.trainer_steps,
            n_requests=2 * args.serve_fleet, gen_len=args.gen_len,
            device=device)
        print(json.dumps(stats, indent=2, default=float))
        print(f"fleet[{args.serve_fleet}x {args.arch}] wire={args.model_wire}:"
              f" {stats['bytes_fraction']:.3f} of dense bytes/publish,"
              f" max staleness {stats['max_staleness']} (K={args.stale_k}),"
              f" {stats['resyncs']} resyncs,"
              f" {stats['tokens_served']} tokens served")
        return stats

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.with_(dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, generator=gen, device=device)
    params, bits = broadcast_params(params, args.broadcast_compressor,
                                    noise=AddressedNoise(17, device))
    del gen
    print(f"model broadcast [{args.broadcast_compressor}]: "
          f"{float(bits) / 8e6:.2f} MB on the wire")
    ticks = args.prompt_len + args.gen_len
    enc_len = args.prompt_len if cfg.is_encoder_decoder else 0
    tokens, dt = greedy_decode(cfg, params, args.batch, ticks, device,
                               enc_len=enc_len)
    total = args.batch * ticks
    print(f"{args.arch}: {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s batched greedy, "
          f"{1e3 * dt / ticks:.2f} ms a tick)")
    return ServeResult(tokens, params, float(bits), dt)


if __name__ == "__main__":
    main()
