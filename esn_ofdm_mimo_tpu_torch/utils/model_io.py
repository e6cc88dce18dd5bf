"""Save and load nested structures of tensors (port of
esn_ofdm_mimo_tpu/utils/model_io.py).

A structure is a tensor (or an array or a number) or a dict, list, tuple or
NamedTuple of structures: an ESN reservoir and its readouts, calibrators,
RNG keys, counters. `save_pytree` writes one `.npz` holding the leaves as
numpy arrays and a structure string, through a `.tmp.npz` file and
`os.replace`, so a run that is cut leaves the old file whole.
`load_pytree(path, like)` rebuilds the structure of `like` from the file
and raises where the stored structure string differs from `like`'s.

The structure string is this package's own (containers, keys and field
names, leaf kinds; not shapes). The JAX package stores a `PyTreeDef`
repr, so a file written by either package does not load in the other.
"""
from __future__ import annotations

import os
from typing import Any, List

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, leaves: List) -> str:
    """Append the leaves of `tree` in order; return its structure string."""
    if _is_namedtuple(tree):
        inner = ", ".join(f"{f}={_flatten(v, leaves)}"
                          for f, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                          for k in sorted(tree, key=repr))
        return f"{{{inner}}}"
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def _unflatten(like: Any, leaves) -> Any:
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves)
                for k in sorted(like, key=repr)}
    if like is None:
        return None
    leaf = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(leaf, device=like.device)
    if isinstance(like, (int, float, bool)):
        return type(like)(leaf.item())
    return leaf


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: Any) -> None:
    """Write the leaves of `tree` and its structure string to `path`."""
    leaves: List = []
    structure = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _as_numpy(x) for i, x in enumerate(leaves)}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, os.path.basename(path) + ".tmp.npz")
    np.savez(tmp, __structure__=np.array(structure), **arrays)
    os.replace(tmp, path)


def load_pytree(path: str, like: Any) -> Any:
    """Restore the file at `path` into the structure of `like` (tensors
    onto the device of `like`'s tensors)."""
    leaves_like: List = []
    structure = _flatten(like, leaves_like)
    with np.load(path, allow_pickle=False) as data:
        stored = str(data["__structure__"])
        if stored != structure:
            raise ValueError(f"checkpoint structure mismatch:\n saved: "
                             f"{stored}\n expected: {structure}")
        leaves = [data[f"leaf_{i}"] for i in range(len(leaves_like))]
    return _unflatten(like, iter(leaves))
