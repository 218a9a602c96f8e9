"""The Zamba2 family's plain reference (``reference/zamba2.py``) on the CPU:

* its SSD, the paper's chunked form with a shorter last chunk, against
  the step-by-step recurrence (two groups, sequences that are and are
  not a multiple of the chunk), within 1e-5 (1 + |y|);
* against transformers' ``Zamba2ForCausalLM`` (where transformers is
  installed) at a tiny size, the same weights carried over: the logits
  within 1e-5 of their scale (the two sum in other orders);
* against the program at smoke size on the benchmark's seeded weights,
  at seq 16 (the program's exact scan) and 256 (its chunked form at 128
  against the reference's chunks of 12): the loss within 1e-5 and each
  leaf's gradient within 1e-4 of its largest entry, both blocks and
  block 0 used twice (its gradient the sum over its uses on both sides);
* the cell's layout and FLOPs at full size pinned: 1,014,709,808
  parameters and the step's FLOPs, and the full configuration's count.

The cell-parametrised tests (``test_perfbench_reference.py``,
``test_perfbench_faults.py``) run the cell itself at smoke size."""

import json
import math
from pathlib import Path

import pytest
import torch

from perfbench import harness, inputs
from perfbench.smoke import smoke_cell

ROOT = Path(__file__).resolve().parent
CELL = "zamba2-7b-q8ring-s2048"


def _family():
    cell = smoke_cell(CELL)
    return cell, cell.family, cell.family.model_of(cell.config)


def _recurrence(x, dt, a, b, c):
    """y_t = C_t . S_t, S_t = exp(a dt_t) S_{t-1} + B_t (dt_t x_t)^T."""
    bsz, s, h, p = x.shape
    rep = h // b.shape[2]
    bh, ch = b.repeat_interleave(rep, 2), c.repeat_interleave(rep, 2)
    state = torch.zeros(bsz, h, p, b.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(s):
        decay = torch.exp(a * dt[:, t])                       # (B, H)
        state = decay[..., None, None] * state + torch.einsum(
            "bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None], bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("seq, chunk", [(24, 8), (29, 8), (7, 16)])
def test_reference_ssd_is_the_recurrence(seq, chunk):
    _, fam, _ = _family()
    gen = torch.Generator().manual_seed(seq)
    b, h, p, g, n = 2, 6, 4, 2, 5
    x = torch.randn(b, seq, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, seq, h, generator=gen))
    a = -torch.linspace(0.5, 3.0, h)
    bm = torch.randn(b, seq, g, n, generator=gen)
    cm = torch.randn(b, seq, g, n, generator=gen)
    got = fam.ssd(x, dt, a, bm, cm, chunk)
    want = _recurrence(*(t.double() for t in (x, dt, a, bm, cm))).float()
    assert torch.all((got - want).abs() <= 1e-5 * (1 + want.abs()))


def _to_transformers(params, m, hf):
    """Carry the reference's leaves into ``hf`` (Zamba2ForCausalLM)."""
    def put(dst, src):
        with torch.no_grad():
            dst.copy_(src)

    model = hf.model
    put(model.embed_tokens.weight, params["embed/table"])
    put(model.final_layernorm.weight, params["final_norm/scale"])
    for i, layer in enumerate(model.layers):
        p = {k[len("blocks/"):]: v[i] for k, v in params.items()
             if k.startswith("blocks/")}
        dec = layer.mamba_decoder if i in m.ids else layer
        mx = dec.mamba
        put(dec.input_layernorm.weight, p["norm/scale"])
        put(mx.in_proj.weight, p["m2/w_in"].T)
        put(mx.conv1d.weight, p["m2/conv_w"].T[:, None, :])
        put(mx.conv1d.bias, p["m2/conv_b"])
        put(mx.A_log, p["m2/a_log"])
        put(mx.D, p["m2/d_skip"])
        put(mx.dt_bias, p["m2/dt_bias"])
        put(mx.norm.weight, p["m2/norm/scale"])
        put(mx.out_proj.weight, p["m2/w_out"].T)
        if i not in m.ids:
            continue
        j = m.ids.index(i)
        s = {k[len("shared_blocks/"):]: v[j % m.mem_blocks]
             for k, v in params.items() if k.startswith("shared_blocks/")}
        u = {k[len("hybrid_blocks/"):]: v[j] for k, v in params.items()
             if k.startswith("hybrid_blocks/")}
        put(layer.linear.weight, u["linear"].T)
        blk = layer.shared_transformer
        for w in ("q", "k", "v", "o"):
            put(getattr(blk.self_attn, f"{w}_proj").weight, s[f"attn/w{w}"].T)
        put(blk.input_layernorm.weight, s["attn_norm/scale"])
        put(blk.pre_ff_layernorm.weight, s["mlp_norm/scale"])
        ff = blk.feed_forward
        put(ff.gate_up_proj.weight,
            torch.cat([s["mlp/w_gate"], s["mlp/w_up"]], 1).T)
        put(ff.down_proj.weight, s["mlp/w_down"].T)
        adapter = ff.gate_up_proj_adapter_list[j]
        put(adapter[0].weight, u["adapter/a"].T)
        put(adapter[1].weight,
            torch.cat([u["adapter/b_gate"], u["adapter/b_up"]], 1).T)


def test_reference_agrees_with_transformers():
    transformers = pytest.importorskip("transformers")
    cell, fam, m = _family()
    c = cell.config
    hf_cfg = transformers.Zamba2Config(
        vocab_size=m.vocab, hidden_size=m.d, num_hidden_layers=m.n_layers,
        layers_block_type=c["layers_block_type"], mamba_d_state=m.d_state,
        mamba_d_conv=m.d_conv, mamba_expand=c["mamba_expand"],
        mamba_ngroups=m.groups, n_mamba_heads=m.m_heads,
        num_attention_heads=m.heads, num_key_value_heads=m.kv_heads,
        num_mem_blocks=c["num_mem_blocks"], use_mem_rope=True,
        use_shared_attention_adapter=False, adapter_rank=m.rank,
        intermediate_size=m.d_ff, chunk_size=m.chunk,
        rms_norm_eps=m.eps, rope_theta=m.theta, hidden_act="gelu",
        tie_word_embeddings=True, attn_implementation="eager")
    hf = transformers.Zamba2ForCausalLM(hf_cfg).eval()
    params = inputs.make_params(fam.param_specs(m), 2**32 + 11, "cpu")
    _to_transformers(params, m, hf)
    tokens = inputs.batch(2**32 + 11, 0, 2, 20, m.vocab, "cpu")["tokens"]
    with torch.no_grad():
        want = hf(tokens).logits
        got = fam.logits(params, m, tokens)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("seq", [16, 256])
def test_program_agrees_with_reference(seq):
    from repro_torch.models.model import train_loss

    cell, fam, m = _family()
    cfg = harness.program_config(cell)
    specs = fam.param_specs(m)
    harness.check_layout(cfg, specs)
    params = inputs.make_params(specs, 2**31 + 3, "cpu")
    tokens = inputs.batch(2**31 + 3, 0, 1, seq, m.vocab, "cpu")["tokens"]
    out = {}
    for side in ("program", "reference"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        if side == "program":
            loss, _ = train_loss(leaves, cfg, {"tokens": tokens})
        else:
            loss, _ = fam.loss(leaves, m, tokens)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[side] = float(loss.detach()), dict(zip(leaves, grads))
    (lp, gp), (lr, gr) = out["program"], out["reference"]
    assert abs(lp - lr) <= 1e-5 * abs(lr)
    for k, want in gr.items():
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((gp[k] - want).abs().max()) <= 1e-4 * scale, k
    # block 0 serves uses 0 and 2; block 1 use 1
    assert gr["shared_blocks/attn/wq"].shape[0] == 2


LAYOUT = [
    ("blocks/m2/a_log", (7, 112)), ("blocks/m2/conv_b", (7, 7424)),
    ("blocks/m2/conv_w", (7, 4, 7424)), ("blocks/m2/d_skip", (7, 112)),
    ("blocks/m2/dt_bias", (7, 112)), ("blocks/m2/norm/scale", (7, 7168)),
    ("blocks/m2/w_in", (7, 3584, 14704)), ("blocks/m2/w_out", (7, 7168, 3584)),
    ("blocks/norm/scale", (7, 3584)), ("embed/table", (32000, 3584)),
    ("final_norm/scale", (3584,)),
    ("hybrid_blocks/adapter/a", (1, 3584, 128)),
    ("hybrid_blocks/adapter/b_gate", (1, 128, 14336)),
    ("hybrid_blocks/adapter/b_up", (1, 128, 14336)),
    ("hybrid_blocks/linear", (1, 3584, 3584)),
    ("shared_blocks/attn/wk", (1, 7168, 7168)),
    ("shared_blocks/attn/wo", (1, 7168, 3584)),
    ("shared_blocks/attn/wq", (1, 7168, 7168)),
    ("shared_blocks/attn/wv", (1, 7168, 7168)),
    ("shared_blocks/attn_norm/scale", (1, 7168)),
    ("shared_blocks/mlp/w_down", (1, 14336, 3584)),
    ("shared_blocks/mlp/w_gate", (1, 3584, 14336)),
    ("shared_blocks/mlp/w_up", (1, 3584, 14336)),
    ("shared_blocks/mlp_norm/scale", (1, 3584))]


def test_layout_and_flops_are_pinned():
    cell = harness.load_cell(CELL)
    fam = cell.family
    m = fam.model_of(cell.config)
    specs = fam.param_specs(m)
    assert sum(math.prod(s) for _, s, _ in specs) == 1_014_709_808
    assert [(p, tuple(s)) for p, s, _ in specs] == LAYOUT
    harness.check_layout(harness.program_config(cell), specs)
    tr = cell.traffic
    assert fam.step_flops(m, tr["batch"], tr["seq"]) == 25774081966080.0
    full = json.loads((ROOT / "configs" / "zamba2-7b-7l.json").read_text())
    assert full["cut"] and set(full["reduced"]) == {
        "num_hidden_layers", "layers_block_type", "hybrid_layer_ids"}
    from repro_torch.configs import get_config
    from repro_torch.models.model import count_params_analytic

    assert count_params_analytic(get_config(full["program_arch"])) == \
        7_356_749_648
