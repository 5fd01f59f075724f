"""The ray-sharded render: the query rays of one image split over the ranks
of a mesh's ``rays`` axis.

Counterpart of the JAX package's render under a ``rays`` mesh
(``tests/test_sharded_render.py``), where the query-ray axis is sharded
and XLA gathers the outputs.  Each rank renders its contiguous slice of
the rays in ``chunk``-ray renders, then every rank receives the whole
image's outputs in ray order (an all-reduce of zero-filled full-size
buffers; adding zeros is exact).  Where the slice is a whole number of
chunks, each chunk is the one a single process renders, and the image is
the single process's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.distributed as dist

from coponerf_tpu_torch import trace
from coponerf_tpu_torch.eval.harness import _RAY_AXIS, _chunk_query
from coponerf_tpu_torch.parallel.mesh import Mesh


def _gather_along(group, part: torch.Tensor, full_shape, dim: int, start: int) -> torch.Tensor:
    """Every rank's ``part`` placed at ``start`` along ``dim`` of a
    ``full_shape`` tensor, on every rank of ``group``: an all-reduce of a
    zero-filled buffer (adding zeros is exact)."""
    full = part.new_zeros(tuple(full_shape))
    full.narrow(dim, start, part.shape[dim]).copy_(part)
    if group is not None:
        dist.all_reduce(full, group=group)
        trace.count("collectives")
    return full


@torch.no_grad()
def render_ray_sharded(model, batch: Dict[str, Any], state, mesh: Mesh, chunk: int = 4096,
                       keys: Sequence[str] = ("rgb", "depth_ray", "at_wt")) -> Dict[str, torch.Tensor]:
    """``model.render(batch, state, val=True)``'s ``keys`` (each a key of
    ``eval.harness._RAY_AXIS``) for all the query rays of ``batch``, on
    every rank of the mesh's ``rays`` group, each rank rendering its
    1/R of the rays.  ``batch`` and ``state`` are the same on those ranks
    (on a mesh that also has ``data``, each data row renders its own
    batch).  Raises where the rays do not split into equal slices."""
    n_rays = batch["query"]["uv"].shape[2]
    n_r, r = mesh.size("rays"), mesh.coord("rays")
    if n_rays % n_r:
        raise ValueError(f"{n_rays} query rays do not split into {n_r} equal slices")
    per = n_rays // n_r
    lo = r * per
    parts = {k: [] for k in keys}
    for start in range(lo, lo + per, chunk):
        out = model.render(_chunk_query(batch, start, min(start + chunk, lo + per)), state, val=True)
        for k in keys:
            parts[k].append(out[k])
    full = {}
    for k, v in parts.items():
        mine = torch.cat(v, dim=_RAY_AXIS[k])
        shape = list(mine.shape)
        shape[_RAY_AXIS[k]] = n_rays
        full[k] = _gather_along(mesh.group("rays"), mine, shape, _RAY_AXIS[k], lo)
    return full
