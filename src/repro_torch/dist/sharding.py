"""Parameter partition specs for a mesh -- the port of the reference's
``repro/dist/sharding.py``.

The port's trees are flat dicts whose keys are ``/``-joined paths
(``blocks/attn/wq``, ``embed/table``, ``final_norm/scale``); the rules
match the reference's on those path parts.  ``params_pspecs`` assigns
tensor-parallel specs over the ``model`` axis by parameter NAME:
column-parallel for input projections (d, fused_out), row-parallel for
output projections (fused_in, d), expert-sharded for 3-D MoE weights,
vocab-sharded for the embedding table.  Anything unmatched (norm scales,
biases, small LoRA factors, SSM scalars) stays replicated.

Leaves under a layer-stacked top-level key (``blocks``,
``dense_blocks``, ``moe_blocks``, ``enc_blocks``) carry a leading layer
axis that is never sharded: rules are written against the TRAILING dims
and left-padded with ``None``.

``validate_pspecs`` downgrades any dim whose mesh-axis product does not
divide the dim size (or whose axes are absent from the mesh) to
replicated, so every returned spec is legal on the given mesh.
``worker_stacked_pspec`` prepends the worker axes (pod x data) to a
parameter spec for the ``(W, *shape)`` stacked gradient and shift
leaves.  A mesh is anything with ``axis_names`` and a ``shape``
(``{axis: size}``): a ``launch.mesh.HostMesh``.

The port runs one process on one device, so a spec places nothing: it
tells the q8 ring which inner dim each ``model`` shard's ring reduces
(``dist.collectives.q8_ring_tree_mean``).
"""

from __future__ import annotations

from typing import Dict, Tuple

#: top-level keys whose leaves are layer-stacked (a leading layer axis)
_STACKED_KEYS = {"blocks", "dense_blocks", "moe_blocks", "enc_blocks"}

# Column-parallel 2-D weights (d_in, fused_out) -> shard the output dim.
_COL_2D = {
    "wq", "wk", "wv", "wg", "wr", "w_gate", "w_up", "w_in", "w", "w_kr",
}
# Row-parallel 2-D weights (fused_in, d_out) -> shard the input dim.
_ROW_2D = {"wo", "w_down", "w_out"}
# Replicated by name regardless of rank (small / latent / router).
_REPLICATED = {"router", "w_lora_a", "w_lora_b", "w_dkv", "conv_w"}


class PSpec(tuple):
    """A partition spec: one entry per leading dim of a leaf, each None
    (replicated), an axis name, or a tuple of axis names (the reference's
    ``PartitionSpec``, which the port cannot import).  Dims past its
    length are replicated.  As the reference's, an entry of one axis is
    that axis and an empty entry None."""

    def __new__(cls, *dims):
        def norm(d):
            if isinstance(d, (tuple, list)):
                d = tuple(d)
                return None if not d else d[0] if len(d) == 1 else d
            return d

        return super().__new__(cls, tuple(norm(d) for d in dims))

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"


def _tail_spec(names, tail_shape) -> Tuple:
    """Spec for the unstacked (trailing) dims of one leaf."""
    name = names[-1]
    nd = len(tail_shape)
    parent = names[-2] if len(names) > 1 else ""

    if name in _REPLICATED or nd <= 1:
        return (None,) * nd
    if name == "table":  # embedding (V, D): vocab-sharded
        return ("model",) + (None,) * (nd - 1)
    if nd == 2:
        # rwkv channel-mix stores its down-projection under "wv" (f, d)
        if parent == "channel" and name == "wv":
            return ("model", None)
        if name in _ROW_2D:
            return ("model", None)
        if name in _COL_2D:
            return (None, "model")
        return (None,) * nd
    if nd == 3:
        if name in ("w_gate", "w_up", "w_down"):
            # MoE expert weights (E, d, f) / (E, f, d): shard experts
            return ("model", None, None)
        if name == "wo":
            # MLA output (H, dv, d): shard heads
            return ("model", None, None)
        if name in ("wq", "w_ukv"):
            # MLA projections (d|r, H, dh'): shard heads
            return (None, "model", None)
        return (None,) * nd
    return (None,) * nd


def params_pspecs(params, *, fsdp: bool = False) -> Dict[str, PSpec]:
    """Specs for a params(-like) tree ``{path: anything with .shape}``,
    by parameter name.

    With ``fsdp=True`` the first still-replicated trailing dim of every
    >=2-D leaf is additionally sharded over ``data`` (fully sharded
    storage); ``validate_pspecs`` downgrades whatever does not divide
    the mesh."""
    out = {}
    for path, leaf in params.items():
        names = path.split("/")
        n_stack = 1 if names[0] in _STACKED_KEYS else 0
        shape = tuple(leaf.shape)
        dims = (None,) * n_stack + _tail_spec(names, shape[n_stack:])
        if fsdp and len(shape) - n_stack >= 2:
            dims = list(dims)
            for i in range(n_stack, len(dims)):
                if dims[i] is None:
                    dims[i] = "data"
                    break
        out[path] = PSpec(*dims)
    return out


def validate_pspecs(shapes, specs, mesh) -> Dict[str, PSpec]:
    """Downgrade spec dims that are illegal on ``mesh``.

    For every leaf dim: axes not present in the mesh are dropped; if the
    remaining axis-size product does not divide the dim size, the dim
    falls back to None (replicated).  Returns one legal spec per leaf of
    ``shapes``, as many entries as the leaf has dims."""
    sizes = dict(mesh.shape)

    def one(leaf, sp):
        dims = list(sp) + [None] * (len(leaf.shape) - len(sp))
        out = []
        for size, ax in zip(leaf.shape, dims):
            if ax is None:
                out.append(None)
                continue
            axs = ax if isinstance(ax, tuple) else (ax,)
            axs = tuple(a for a in axs if a in sizes)
            n = 1
            for a in axs:
                n *= sizes[a]
            if not axs or size % n != 0:
                out.append(None)
            elif len(axs) == 1:
                out.append(axs[0])
            else:
                out.append(axs)
        return PSpec(*out)

    if set(shapes) != set(specs):
        raise ValueError("validate_pspecs: the shapes and the specs name "
                         "different leaves")
    return {k: one(leaf, specs[k]) for k, leaf in shapes.items()}


def worker_stacked_pspec(mesh, inner_spec) -> PSpec:
    """Spec for a worker-stacked leaf ``(W, *shape)``: the worker axes
    (pod x data) on the leading dim, ``inner_spec`` on the rest.  Any
    worker axis already in ``inner_spec`` is stripped from it (an axis
    may shard only one dim)."""
    waxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def strip(ax):
        if ax is None:
            return None
        axs = ax if isinstance(ax, tuple) else (ax,)
        axs = tuple(a for a in axs if a not in waxes)
        if not axs:
            return None
        return axs if len(axs) > 1 else axs[0]

    inner = tuple(strip(a) for a in inner_spec)
    if not waxes:
        return PSpec(None, *inner)
    return PSpec(waxes if len(waxes) > 1 else waxes[0], *inner)


def worker_stacked_pspecs(mesh, params_like, w: int) -> Dict[str, PSpec]:
    """The worker-stacked specs of the ``(w, *shape)`` gradient leaves of
    ``params_like``, validated against ``mesh`` (the reference's
    ``build_channel`` assembly): each leaf's validated parameter spec
    behind the worker axes."""
    inner = validate_pspecs(params_like, params_pspecs(params_like), mesh)
    stacked = {k: worker_stacked_pspec(mesh, sp) for k, sp in inner.items()}
    wshapes = {k: _Shape((w, *p.shape)) for k, p in params_like.items()}
    return validate_pspecs(wshapes, stacked, mesh)


class _Shape:
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)
