"""Checkpointing: flat-key npz save/restore of trees of tensors -- the
port of the reference's ``repro/checkpoint/store.py``, in its file
format.

Keys are the reference's '/'-joined tree paths: a mapping's keys in
sorted order (the port's flat ``{path: tensor}`` dicts, e.g. the params
of ``weights.flatten_tree``, keep their names), a sequence's indices, a
named tuple's fields as ``.name``; ``None`` leaves are skipped.  A
``__meta__`` entry holds the sorted keys and the step.  bf16 is stored
as f32 (npz has no bf16) and cast back on restore.  The file is written
to ``path + ".tmp"`` and moved into place, so a reader never sees half
a file.  So a file the reference writes restores into the port's tree
of the same names, and the other way round.

``restore(path, like, device=...)`` puts each tensor on the caller's
device (default: the CUDA device) in ``like``'s dtype.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _named(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` in the reference's order and names (module
    docstring)."""
    if tree is None:
        return {}
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return {prefix[:-1]: tree}
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix[:-1]: tree}
    out = {}
    for name, v in items:
        out.update(_named(v, f"{prefix}{name}/"))
    return out


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:   # npz has no bf16: store as f32
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(v)


def save(path: str, tree: Any, *, step: Optional[int] = None) -> None:
    """Write ``tree``'s leaves (tensors, arrays or numbers) to ``path``,
    atomically (module docstring)."""
    arrays = {k: _to_np(v) for k, v in _named(tree).items()}
    meta = {"keys": sorted(arrays), "step": step}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        ), **arrays)
    os.replace(tmp, path)


def _dtype(ref) -> torch.dtype:
    dt = ref.dtype
    return dt if isinstance(dt, torch.dtype) else torch.from_numpy(
        np.zeros(0, dtype=dt)).dtype


def _rebuild(like, leaves: Dict[str, Any], prefix: str = ""):
    if like is None:
        return None
    if hasattr(like, "shape") and hasattr(like, "dtype"):
        return leaves[prefix[:-1]]
    if isinstance(like, Mapping):
        return type(like)((k, _rebuild(v, leaves, f"{prefix}{k}/"))
                          for k, v in like.items())
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves,
                                     f"{prefix}.{f}/")
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def restore(path: str, like: Any, *, device=None) -> Any:
    """Restore into the structure of ``like`` (its leaves anything with
    ``.shape`` and ``.dtype``: tensors, ``ShapeDtype``, arrays), each
    leaf a tensor of ``like``'s dtype on ``device`` (default: the CUDA
    device).  A missing key raises ``KeyError``, a wrong shape
    ``ValueError``."""
    dev = resolve_device(device)
    leaves = {}
    with np.load(path) as z:
        for name, ref in _named(like).items():
            if name not in z:
                raise KeyError(f"checkpoint missing {name!r}")
            arr = z[name]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {arr.shape} != expected "
                    f"{tuple(ref.shape)}"
                )
            leaves[name] = torch.from_numpy(arr).to(device=dev,
                                                    dtype=_dtype(ref))
    return _rebuild(like, leaves)


def latest_step(path: str) -> Optional[int]:
    """The step a checkpoint was saved at (None when the file is missing
    or unreadable, or was saved without one)."""
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            return meta.get("step")
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None
