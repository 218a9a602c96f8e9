"""Port parity: checkpointing (``repro_torch.checkpoint.store``) in the
reference's file format, against the reference's ``save`` / ``restore``
/ ``latest_step``, in-process.

* A checkpoint the reference writes of its smoke qwen3-0.6b params (f32)
  and of a bf16 tree (stored as f32) restores into the port's flat
  ``{path: tensor}`` dict (``weights.flatten_tree`` names) bitwise, in
  the dtypes of the port's ``like``.
* A checkpoint the port writes (f32 and bf16 leaves, a named tuple of
  trees as its train state holds them) restores in the reference
  bitwise.
* A wrong shape raises ``ValueError``, a missing key ``KeyError``;
  ``latest_step`` reads the step (None without one, or without a file);
  no ``.tmp`` file is left behind.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as R
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.core.compressors import ShapeDtype
from repro_torch.weights import flatten_tree


def _bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes()
    return t.numpy().tobytes()


def _np_bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16).tobytes()
    return a.tobytes()


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke qwen3-0.6b params tree, numpy-seeded values
    (its init traced for the shapes only)."""
    cfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_reference_checkpoint_restores_in_port(tmp_path, ref_params):
    path = str(tmp_path / "ref.npz")
    R.save(path, ref_params, step=7)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_params))
    like = {k: torch.zeros(v.shape) for k, v in want.items()}
    got = restore(path, like, device="cpu")
    assert list(got) == list(like)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert _bits(got[k]) == _np_bits(v), k
    assert latest_step(path) == R.latest_step(path) == 7
    # bf16 leaves travel as f32 and come back bf16
    rng = np.random.default_rng(0)
    tree = {"a": {"w": jnp.asarray(rng.standard_normal((5, 3)),
                                   jnp.bfloat16)},
            "b": jnp.asarray(rng.standard_normal(4), jnp.float32)}
    R.save(str(tmp_path / "bf16.npz"), tree)
    like = {"a/w": ShapeDtype((5, 3), torch.bfloat16, torch.device("meta")),
            "b": torch.zeros(4)}
    got = restore(str(tmp_path / "bf16.npz"), like, device="cpu")
    assert got["a/w"].dtype == torch.bfloat16
    assert _bits(got["a/w"]) == _np_bits(tree["a"]["w"])
    assert _bits(got["b"]) == _np_bits(tree["b"])
    assert latest_step(str(tmp_path / "bf16.npz")) is None


class _State(NamedTuple):
    params: dict
    h: list
    skip: object


def test_port_checkpoint_restores_in_reference(tmp_path):
    gen = torch.Generator().manual_seed(1)
    params = {"blocks/w": torch.randn(2, 3, generator=gen),
              "emb": torch.randn(4, generator=gen).to(torch.bfloat16)}
    h = [torch.randn(3, generator=gen), None, torch.randn(1, generator=gen)]
    state = _State(params, h, None)
    path = str(tmp_path / "port.npz")
    save(path, state, step=11)
    assert not (tmp_path / "port.npz.tmp").exists()
    like_j = _State({"blocks": {"w": jnp.zeros((2, 3))},
                     "emb": jnp.zeros(4, jnp.bfloat16)},
                    [jnp.zeros(3), None, jnp.zeros(1)], None)
    got = R.restore(path, like_j)
    assert _np_bits(got.params["blocks"]["w"]) == _bits(params["blocks/w"])
    assert got.params["emb"].dtype == jnp.bfloat16
    assert _np_bits(got.params["emb"]) == _bits(params["emb"])
    assert _np_bits(got.h[0]) == _bits(h[0])
    assert _np_bits(got.h[2]) == _bits(h[2])
    assert R.latest_step(path) == latest_step(path) == 11
    back = restore(path, state, device="cpu")
    assert isinstance(back, _State) and back.skip is None
    assert back.h[1] is None
    for k in params:
        assert _bits(back.params[k]) == _bits(params[k]), k
    for a, b in ((back.h[0], h[0]), (back.h[2], h[2])):
        assert _bits(a) == _bits(b)


def test_restore_errors_and_latest_step(tmp_path):
    path = str(tmp_path / "c.npz")
    save(path, {"a": torch.zeros(2, 2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="checkpoint shape"):
        restore(path, {"a": torch.zeros(4)}, device="cpu")
    with pytest.raises(KeyError, match="checkpoint missing 'c'"):
        restore(path, {"c": torch.zeros(1)}, device="cpu")
    with pytest.raises(ValueError) as want:
        R.restore(path, {"a": jnp.zeros(4)})
    with pytest.raises(ValueError) as got:
        restore(path, {"a": torch.zeros(4)}, device="cpu")
    assert str(got.value) == str(want.value)
    assert latest_step(path) is None
    assert latest_step(str(tmp_path / "missing.npz")) is None
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    assert latest_step(str(tmp_path / "junk.npz")) is None
    assert R.latest_step(str(tmp_path / "junk.npz")) is None
