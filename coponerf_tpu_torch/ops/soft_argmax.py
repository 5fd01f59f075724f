"""K5: the fused dual-axis soft-argmax over a flat correlation volume.

Counterpart of ``coponerf_tpu/ops/pallas/soft_argmax.py``.  The UFC head
extracts both flow directions from the same (B, Q, S) f32 correlation:
softmax over S -> expected source coordinate per q row (``mapping_fwd``),
softmax over Q -> expected coordinate per s column (``mapping_bwd``).
``soft_argmax_both`` equals ``ops/correlation.py:soft_argmax_flat(c, 2)`` and
``soft_argmax_flat(c, 1)`` to f32 round-off, in values and gradients.

Wrappers around ``csrc/soft_argmax.cu``:

- ``soft_argmax_stats`` replaces ``_stats`` (kernel ``_fwd_kernel``): per
  row the max, partition and unnormalised x/y expectations over S, per
  column the same over Q, in one launch that reads the volume once and
  merges its partial statistics across blocks itself (arrival counters
  that each launch leaves at zero, one set per shape and stream);
- ``soft_argmax_bwd`` replaces ``_bwd`` (kernel ``_bwd_kernel``): the
  softmax-expectation derivative of both directions in one elementwise pass.

On a CPU tensor each wrapper runs its plain version (f32 or f64, so
``gradcheck`` can run in f64); on a CUDA tensor it launches its kernel
(f32 only) or raises, and counts the launch.
"""

from __future__ import annotations

import functools

import torch

from coponerf_tpu_torch.ops import _build
from coponerf_tpu_torch.ops.bilinear_sample import _kernel_device

# csrc/soft_argmax.cu's forward chunk rows and strip columns: a launch counts
# at most B * (Q / _ROWS + S / _STRIP) merge groups (rounded up), and two
# more counters share out its work
_ROWS, _STRIP = 32, 256


def grid_shape(n: int):
    """(hs, ws) of n tokens on a row-major grid, hs = round(sqrt(n)); raises
    unless hs * ws == n (the model's grids are square)."""
    hs = int(round(n ** 0.5))
    ws = n // hs
    if hs * ws != n:
        raise ValueError(f"{n} tokens do not form a grid of {hs} rows")
    return hs, ws


@functools.lru_cache(maxsize=32)
def coord_vectors(n: int, dtype=torch.float32, device=None):
    """Row-major grid coordinates of n = hs * ws tokens in [-1, 1]: (xv (n,),
    yv (n,), hs, ws), as ``soft_argmax.py:_coord_vectors``.  Cached per
    (n, dtype, device): they are read, never written, and building them
    takes more host time than the kernels that read them."""
    hs, ws = grid_shape(n)
    with torch.inference_mode(False):
        ar = torch.arange(n, device=device)
        xv = torch.linspace(-1.0, 1.0, ws, dtype=dtype, device=device)[ar % ws]
        yv = torch.linspace(-1.0, 1.0, hs, dtype=dtype, device=device)[ar // ws]
    return xv, yv, hs, ws


def _on_card(c: torch.Tensor) -> bool:
    """Checks the volume; True for a CUDA tensor (launch the kernel), False
    for a CPU one (run the plain version)."""
    if c.dim() != 3:
        raise ValueError(f"expected a (B, Q, S) volume, got {tuple(c.shape)}")
    grid_shape(c.shape[1])
    grid_shape(c.shape[2])
    if not _kernel_device(c):
        if not c.is_floating_point():
            raise TypeError(f"unsupported dtype {c.dtype}")
        return False
    if c.dtype != torch.float32:
        raise TypeError(f"unsupported dtype {c.dtype} (f32 only)")
    if not c.is_contiguous():
        raise ValueError("c must be contiguous")
    return True


def _coords(c: torch.Tensor):
    """(xs, ys, xq, yq): the coordinates of the S and Q grids on c's device."""
    B, Q, S = c.shape
    xs, ys, _, _ = coord_vectors(S, c.dtype, c.device)
    xq, yq, _, _ = coord_vectors(Q, c.dtype, c.device)
    return xs, ys, xq, yq


def soft_argmax_stats_plain(c: torch.Tensor, beta: float):
    """Plain PyTorch version: whole-tensor max, exp and coordinate sums in
    the input dtype, the division deferred.  Returns row (B, 4, Q) and col
    (B, 4, S) statistics (m, z, sum e*x, sum e*y)."""
    xs, ys, xq, yq = _coords(c)
    m1 = torch.amax(c, dim=2)
    e1 = torch.exp((c - m1[:, :, None]) / beta)
    row = torch.stack([m1, e1.sum(dim=2), e1 @ xs, e1 @ ys], dim=1)
    del e1
    m2 = torch.amax(c, dim=1)
    e2 = torch.exp((c - m2[:, None, :]) / beta)
    col = torch.stack([m2, e2.sum(dim=1), torch.einsum("bqs,q->bs", e2, xq),
                       torch.einsum("bqs,q->bs", e2, yq)], dim=1)
    return row, col


@functools.lru_cache(maxsize=32)
def _stats_workspace(B: int, Q: int, S: int, device: torch.device, stream: int):
    """What a forward launch of one shape on one stream needs besides c and
    its outputs, kept for the next call (a call's host time matters at B 1):
    the coordinates, the f32 scratch for the partial statistics and the
    arrival counters, zeroed once: each launch leaves them at zero, and
    only launches on this stream, which run one after another, use them.
    Returns the tensors, the launcher, and their pointers and sizes in
    its argument order."""
    n = _build.lib().k5_stats_scratch_floats(B, Q, S)
    if n < 0:
        raise ValueError(f"soft_argmax_stats takes no volume of shape {(B, Q, S)}")
    xs, ys, _, _ = coord_vectors(S, torch.float32, device)
    xq, yq, _, _ = coord_vectors(Q, torch.float32, device)
    scratch = torch.empty(n, dtype=torch.float32, device=device)
    counters = torch.zeros(B * (-(-Q // _ROWS) + -(-S // _STRIP)) + 2, dtype=torch.int32, device=device)
    tensors = (xs, ys, xq, yq, scratch, counters)
    coords = (xs.data_ptr(), ys.data_ptr(), xq.data_ptr(), yq.data_ptr())
    work = (scratch.data_ptr(), n, counters.data_ptr(), counters.numel())
    return tensors, _build.lib().k5_soft_argmax_stats, coords, work


def soft_argmax_stats(c: torch.Tensor, beta: float = 0.02):
    """c (B, Q, S) -> (row (B, 4, Q), col (B, 4, S)): per row over S and per
    column over Q, the max m, the partition z = sum exp((c - m) / beta) and
    the sums of exp((c - m) / beta) times the other axis's x and y
    coordinates.  Q and S must form grids (``grid_shape``)."""
    if not _on_card(c):
        return soft_argmax_stats_plain(c, beta)
    B, Q, S = c.shape
    stream = torch._C._cuda_getCurrentRawStream(c.device.index)  # _build.stream_of's, in a tenth of its time
    _, launch, coords, work = _stats_workspace(B, Q, S, c.device, stream)
    row = torch.empty((B, 4, Q), dtype=torch.float32, device=c.device)
    col = torch.empty((B, 4, S), dtype=torch.float32, device=c.device)
    code = launch(c.data_ptr(), *coords, row.data_ptr(), col.data_ptr(), *work, B, Q, S, float(beta), stream)
    _build.check(code, "k5_soft_argmax_stats")
    soft_argmax_stats.launches += 1
    return row, col


soft_argmax_stats.launches = 0


def soft_argmax_bwd_plain(c, rowf, colf, dr, dcol, beta: float):
    """Plain PyTorch version of the backward on whole tensors:

        dc = p1/beta * ((xs-gx1)*dgx1 + (ys-gy1)*dgy1)
           + p2/beta * ((xq-gx2)*dgx2 + (yq-gy2)*dgy2)

    with p1, p2 the row and column softmaxes rebuilt from the finalized
    statistics rowf (B, 4, Q) and colf (B, 4, S) = (m, z, gx, gy)."""
    xs, ys, xq, yq = _coords(c)
    m1, z1, gx1, gy1 = (t[:, :, None] for t in rowf.unbind(1))
    m2, z2, gx2, gy2 = (t[:, None, :] for t in colf.unbind(1))
    dgx1, dgy1 = (t[:, :, None] for t in dr.unbind(1))
    dgx2, dgy2 = (t[:, None, :] for t in dcol.unbind(1))
    p1 = torch.exp((c - m1) / beta) / z1
    p2 = torch.exp((c - m2) / beta) / z2
    t1 = (xs - gx1) * dgx1 + (ys - gy1) * dgy1
    t2 = (xq[:, None] - gx2) * dgx2 + (yq[:, None] - gy2) * dgy2
    return (p1 * t1 + p2 * t2) / beta


def soft_argmax_bwd(c, rowf, colf, dr, dcol, beta: float = 0.02) -> torch.Tensor:
    """The gradient dc (B, Q, S) of both mappings: c (B, Q, S), finalized
    statistics rowf (B, 4, Q) and colf (B, 4, S) = (m, z, gx, gy), and the
    mappings' cotangents dr (B, 2, Q) and dcol (B, 2, S).  Written out of
    place."""
    on_card = _on_card(c)
    B, Q, S = c.shape
    want = {"rowf": (B, 4, Q), "colf": (B, 4, S), "dr": (B, 2, Q), "dcol": (B, 2, S)}
    for name, t in (("rowf", rowf), ("colf", colf), ("dr", dr), ("dcol", dcol)):
        if tuple(t.shape) != want[name] or t.device != c.device or t.dtype != c.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {want[name]} {c.dtype} on {c.device}")
    if not on_card:
        return soft_argmax_bwd_plain(c, rowf, colf, dr, dcol, beta)
    rowf, colf, dr, dcol = (t.contiguous() for t in (rowf, colf, dr, dcol))
    xs, ys, xq, yq = _coords(c)
    out = torch.empty_like(c)
    code = _build.lib().k5_soft_argmax_bwd(
        c.data_ptr(), rowf.data_ptr(), colf.data_ptr(), dr.data_ptr(), dcol.data_ptr(),
        xs.data_ptr(), ys.data_ptr(), xq.data_ptr(), yq.data_ptr(), out.data_ptr(),
        B, Q, S, float(beta), _build.stream_of(c),
    )
    _build.check(code, "k5_soft_argmax_bwd")
    soft_argmax_bwd.launches += 1
    return out


soft_argmax_bwd.launches = 0


class _SoftArgmaxBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, beta):
        B, Q, S = c.shape
        row, col = soft_argmax_stats(c, beta)
        gx1, gy1 = row[:, 2] / row[:, 1], row[:, 3] / row[:, 1]
        gx2, gy2 = col[:, 2] / col[:, 1], col[:, 3] / col[:, 1]
        rowf = torch.stack([row[:, 0], row[:, 1], gx1, gy1], dim=1)
        colf = torch.stack([col[:, 0], col[:, 1], gx2, gy2], dim=1)
        ctx.save_for_backward(c, rowf, colf)
        ctx.beta = beta
        mapping_fwd = torch.stack([gx1, gy1], dim=1).reshape(B, 2, *grid_shape(Q))
        mapping_bwd = torch.stack([gx2, gy2], dim=1).reshape(B, 2, *grid_shape(S))
        return mapping_fwd, mapping_bwd

    @staticmethod
    def backward(ctx, dfwd, dbwd):
        c, rowf, colf = ctx.saved_tensors
        B, Q, S = c.shape
        dc = soft_argmax_bwd(c, rowf, colf, dfwd.reshape(B, 2, Q), dbwd.reshape(B, 2, S), ctx.beta)
        return dc, None


def soft_argmax_both(c: torch.Tensor, beta: float = 0.02):
    """c (B, Q, S) -> (mapping_fwd (B, 2, hq, wq), mapping_bwd (B, 2, hs, ws)),
    equal to (soft_argmax_flat(c, 2), soft_argmax_flat(c, 1)).  Saves c and
    the finalized statistics for the backward, which is one K5 backward
    pass; ``beta`` gets no gradient."""
    return _SoftArgmaxBoth.apply(c, beta)
