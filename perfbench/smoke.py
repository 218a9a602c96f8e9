"""Smoke-sized cells for the tests on the CPU: each of the benchmark's
cells with its configuration cut to a few small widths and its traffic
to short sequences and its limits to ``LIMITS``, everything else
(workers, codec, aggregation, wires, optimizer) as committed."""

from perfbench import harness

#: at smoke sizes on the CPU the program and the reference agree to f32
#: rounding: every number is compared, far below what a fault reads (the
#: cells' own limits are set from chip readings at their own sizes)
LIMITS = {"loss": 1e-6, "grad1": 1e-4, "change": 1e-4, "bits": 0.0}

CELLS = ["qwen3-natural-s128", "dsv2lite-wires-s128", "qwen3-q8ring-s1024",
         "dsv2lite-q8ring-s128"]

SIZES = {
    "dense": dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=32, intermediate_size=256,
                  vocab_size=512),
    "moe": dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=2,
                num_key_value_heads=2, intermediate_size=256, vocab_size=512,
                kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
                v_head_dim=32, n_routed_experts=4, num_experts_per_tok=2,
                n_shared_experts=1, moe_intermediate_size=64),
}


def smoke_cell(name: str, seq: int = 16) -> harness.Cell:
    cell = harness.load_cell(name)
    family = "moe" if "n_routed_experts" in cell.config else "dense"
    cell.config.update(SIZES[family])
    cell.traffic.update(seq=seq)
    cell.limits = dict(LIMITS)
    return cell
