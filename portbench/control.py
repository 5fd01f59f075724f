"""The comparison's control: the plain reference put in the program's place
and computed in the precision below the configuration's bf16, fp8.

``fp8_model`` runs the reference's ``encode``, ``render`` and ``forward``
under ``Fp8Products``, which rounds both operands of every matrix product
and convolution to float8 e4m3 with one scale a tensor (its largest
magnitude to e4m3's largest, 448), as an fp8 product with f32 accumulation
computes them.  In training the rounding passes gradients straight through.
Only the calibration (``calibrate.py``) and the tests use it; a benchmark
run never does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
PRODUCTS = {
    F.linear, F.conv1d, F.conv2d, F.conv3d, torch.matmul, torch.mm, torch.bmm, torch.einsum,
    torch.Tensor.__matmul__, torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm, torch.addmm,
}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    if not (torch.is_tensor(x) and x.is_floating_point()) or x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / E4M3_MAX
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()


class Fp8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            args = tuple(fp8_round(a) if torch.is_tensor(a) else a for a in args)
            if func is torch.einsum and len(args) == 2 and isinstance(args[1], (list, tuple)):
                args = (args[0], [fp8_round(a) for a in args[1]])
        return func(*args, **kwargs)


def fp8_model(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` (the reference), its ``encode``, ``render`` and ``forward``
    run with every product in fp8; patched in place, so that its
    parameters keep their names."""
    for name in ("encode", "render", "forward"):
        setattr(model, name, _under_fp8(getattr(model, name)))
    return model


def _under_fp8(fn):
    def wrapped(*a, **kw):
        with Fp8Products():
            return fn(*a, **kw)
    return wrapped
