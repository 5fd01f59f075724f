"""Process meshes, batch shards and the collectives of data-parallel training.

Counterpart of ``coponerf_tpu/parallel/mesh.py:24-51``.  The JAX package
runs ONE global train step over a device mesh: the batch is sharded on its
``data`` axis, the query rays also on a ``rays`` axis where the mesh has
one, the parameters are replicated, and XLA inserts the collectives.  So
its step on N devices is the single-device step on the global batch.

Here each rank is one process of an initialised ``torch.distributed``
group and computes on its shard; explicit collectives (``all_reduce`` and
``broadcast`` only) make the N-rank step the one-rank step on the
concatenated batch:
  - the BatchNorm statistics are the global batch's (``models/resnet.py``,
    over the ``data`` group, through ``all_reduce_sum``, which is
    differentiable);
  - the masked means of the losses divide by the global mask sums
    (``training/losses.py``);
  - the gradients are averaged over every rank in one flat buffer
    (``average_gradients``) before the norm, the finite check, the clip
    and Adam, so every rank takes the same branch and the same update.

Ranks lie on the mesh in row-major order, as ``make_mesh`` lays JAX's
devices: on a ``(data, rays)`` mesh of shape (D, R) rank ``d * R + r``
holds data row ``d`` and ray slice ``r``.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# what a rank waits in a collective before it gives up: a rank that raised
# leaves the others blocked there
DEFAULT_TIMEOUT_S = 60.0
# what the other ranks wait for rank 0's checkpoints and validation
RANK0_TIMEOUT_S = 3600.0
# the signals of rank 0 to the others, numbered alike on every rank
_RANK0_SIGNALS = itertools.count()
# the leaves cut along the rays axis (``__graft_entry__.py:134-138``)
RAY_KEYS = (("query", "uv"), ("query", "rgb"))


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a mesh of processes: the mesh's ``shape`` and
    ``axes``, this ``rank`` and the ``world_size``, and one process group
    per axis (``groups[axis]``: the ranks that differ from this one only
    along ``axis``; the default group where the axis spans every rank,
    None where it holds this rank alone)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int
    world_size: int
    groups: Dict[str, Any]

    def size(self, axis: str) -> int:
        """The mesh's extent along ``axis``; 1 for an axis it lacks."""
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``; 0 for an axis it lacks."""
        if axis not in self.axes:
            return 0
        return int(np.unravel_index(self.rank, self.shape)[self.axes.index(axis)])

    def group(self, axis: str):
        return self.groups.get(axis)


def init_distributed(backend: str, rank: int, world_size: int, init_method: str, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a process group: ``backend`` is ``"nccl"`` (one CUDA device a
    rank) or ``"gloo"`` (CPU tensors, or CUDA tensors of ranks that share a
    device).  ``device`` (a CUDA device) becomes this process's current
    device.  Raises where NCCL or CUDA is missing; never picks another
    backend."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl" and not (torch.cuda.is_available() and dist.is_nccl_available()):
        raise RuntimeError("the nccl backend needs CUDA and a PyTorch built with NCCL")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_from_env(backend: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[int, int]:
    """Join the group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); with NCCL the rank's device is ``cuda:LOCAL_RANK``.
    Returns (rank, world size)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    init_distributed(backend, rank, world, "env://", device=f"cuda:{local}" if backend == "nccl" else None,
                     timeout_s=timeout_s)
    return rank, world


def in_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("data",)) -> Mesh:
    """The mesh of the initialised default group; one ``-1`` in ``shape``
    takes what the others leave, as in the JAX package.  Every rank calls
    it, in the same order as its other group creations."""
    world, rank = dist.get_world_size(), dist.get_rank()
    shape, axes = list(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = world // known
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} does not cover {world} ranks")
    layout = np.arange(world).reshape(shape)
    groups: Dict[str, Any] = {}
    for i, axis in enumerate(axes):
        if shape[i] == world:
            groups[axis] = dist.group.WORLD
            continue
        if shape[i] == 1:
            groups[axis] = None
            continue
        # every rank creates every group of the axis, in the same order
        lines = np.moveaxis(layout, i, -1).reshape(-1, shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(shape=tuple(shape), axes=axes, rank=rank, world_size=world, groups=groups)


def _leaf_shard(mesh: Mesh, path: Tuple[str, ...], x):
    d, n_d = mesh.coord("data"), mesh.size("data")
    if x.shape[0] % n_d:
        raise ValueError(f"batch leaf {'/'.join(path)} of {x.shape[0]} rows does not split into {n_d} equal shards")
    rows = x.shape[0] // n_d
    x = x[d * rows:(d + 1) * rows]
    if path in RAY_KEYS:
        r, n_r = mesh.coord("rays"), mesh.size("rays")
        if x.shape[2] % n_r:
            raise ValueError(f"batch leaf {'/'.join(path)} of {x.shape[2]} rays does not split into {n_r} equal "
                             "shards")
        per = x.shape[2] // n_r
        x = x[:, :, r * per:(r + 1) * per]
    return x


def shard_batch(mesh: Mesh, batch: Dict[str, Any], _path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """This rank's share of a global batch (numpy arrays or tensors in the
    ``data.synthetic.make_batch`` schema): its rows along ``data`` and,
    on a mesh with a ``rays`` axis, its slice of ``query/uv`` and
    ``query/rgb`` along the ray axis.  Raises where a leaf does not split
    into equal shards."""
    return {k: (shard_batch(mesh, v, _path + (k,)) if isinstance(v, dict) else _leaf_shard(mesh, _path + (k,), v))
            for k, v in batch.items()}


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers (in place)."""
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the cotangent of each rank's input is the sum of
    every rank's cotangent of the result."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (differentiable); ``x``
    itself where ``group`` is None (a group of one)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def average_gradients(mesh: Mesh, grads: Sequence[torch.Tensor]) -> None:
    """Replace each gradient by its mean over every rank, in place, through
    one flat buffer (one all-reduce)."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(mesh.world_size)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def average_over_world(mesh: Mesh, values: torch.Tensor) -> torch.Tensor:
    """``values`` averaged over every rank (not differentiable)."""
    out = values.detach().clone()
    dist.all_reduce(out)
    return out.div_(mesh.world_size)


def _signal_key() -> str:
    return f"coponerf_rank0_done/{next(_RANK0_SIGNALS)}"


def rank0_done(mesh: Mesh) -> None:
    """Rank 0: tell the other ranks, through the group's store, that its
    own work (checkpoints, validation) is done; they wait in
    ``wait_for_rank0``.  Every rank makes these calls in the same order."""
    key = _signal_key()
    if mesh.world_size > 1:
        dist.distributed_c10d._get_default_store().set(key, "1")


def wait_for_rank0(mesh: Mesh) -> None:
    """The other ranks: wait up to ``RANK0_TIMEOUT_S`` for rank 0's matching
    ``rank0_done`` on the group's store, in no collective, so that rank 0's
    work may outlast the collectives' timeout; raises past it."""
    key = _signal_key()
    if mesh.world_size > 1:
        dist.distributed_c10d._get_default_store().wait([key], datetime.timedelta(seconds=RANK0_TIMEOUT_S))


def attach_batch_norm(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Make every BatchNorm of ``module`` take its training statistics over
    the mesh's ``data`` group (the global batch), or over the local batch
    alone where ``mesh`` is None."""
    from coponerf_tpu_torch.models.resnet import BatchNorm

    group = None if mesh is None else mesh.group("data")
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.stats_group = group
