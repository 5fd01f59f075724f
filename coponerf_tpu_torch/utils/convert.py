"""JAX/flax variables (as numpy) -> the port's ``state_dict``, and back to
the flax path of each port key.

The port's module tree mirrors the flax tree name for name, so each leaf
maps by a layout change only:

    Dense kernel (in, out)            -> <path>.weight (out, in)
    Conv kernel (kh, kw, I, O)        -> <path>.weight (O, I, kh, kw)
    LayerNorm/GroupNorm/BatchNorm scale -> <path>.weight
    bias, pos_embed                   -> same name
    batch_stats mean / var            -> <path>.running_mean / running_var

Load the result with ``load_state_dict(strict=True)``: every leaf is then
consumed exactly once.  The inverse direction of
``coponerf_tpu/utils/torch_import.py``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _to_torch_layout(collection: str, path: Tuple[str, ...], arr: np.ndarray):
    name = path[-1]
    base = ".".join(path[:-1])
    if collection == "batch_stats":
        return f"{base}.{_STATS[name]}", arr
    if name == "kernel":
        if arr.ndim == 2:
            return f"{base}.weight", arr.T
        if arr.ndim == 4:
            return f"{base}.weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {arr.shape}")
    if name == "scale":
        return f"{base}.weight", arr
    if name in ("bias", "pos_embed"):
        return ".".join(path), arr
    raise ValueError(f"unknown leaf {'/'.join(path)}")


def convert(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} nested dicts of arrays ->
    {torch key: f32 tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            key, val = _to_torch_layout(collection, path, arr)
            if key in out:
                raise ValueError(f"two leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32))
    return out


def flax_path(key: str, shape: Tuple[int, ...]) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Port key and tensor shape -> (flax path incl. collection, flax shape)."""
    *mods, leaf = key.split(".")
    mods = tuple(mods)
    if leaf in ("running_mean", "running_var"):
        return ("batch_stats",) + mods + (leaf.split("_")[1],), shape
    if leaf == "weight":
        if len(shape) == 2:
            return ("params",) + mods + ("kernel",), (shape[1], shape[0])
        if len(shape) == 4:
            o, i, kh, kw = shape
            return ("params",) + mods + ("kernel",), (kh, kw, i, o)
        return ("params",) + mods + ("scale",), shape
    return ("params",) + mods + (leaf,), shape
