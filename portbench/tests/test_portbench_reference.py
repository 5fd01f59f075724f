"""The plain reference against the port (``coponerf_tpu_torch``) at 64^2 on
the CPU, on the same weights and scenes: the exact f32 configuration to
f32 rounding (encode, the val-mode render, the training forward's losses
and gradients), and the two-stage fast render, whose port samples bf16
tables even in f32, to bf16 rounding."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from conftest import REPO

sys.path.insert(0, REPO)

from portbench import scenes  # noqa: E402
from portbench.drivers.render import reference_render  # noqa: E402
from portbench.weights import load_weights  # noqa: E402

SIZE = 64


def _pair(cfg_kw, seed=11):
    from coponerf_tpu_torch.config import ModelConfig as PortConfig
    from coponerf_tpu_torch.models import CoPoNeRF as Port

    from portbench.reference.config import ModelConfig
    from portbench.reference.models import CoPoNeRF

    cpu = torch.device("cpu")
    port = load_weights(Port(PortConfig(**cfg_kw), image_size=SIZE), seed, cpu)
    ref = load_weights(CoPoNeRF(ModelConfig(**cfg_kw), image_size=SIZE), seed, cpu)
    return port, ref


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("fast", [False, True])
def test_reference_renders_as_the_port(fast):
    kw = dict(compute_dtype="float32", fast_sampling=fast)
    if fast:
        kw.update(coarse_samples=16, fine_samples=4)
    port, ref = _pair(kw)
    port.eval(), ref.eval()
    batch = scenes.make_batch(5, [0], SIZE, 0, "cpu", full_query_image=True)
    n = SIZE * SIZE
    tol = 2e-2 if fast else 1e-4     # the port's fast render samples bf16 tables
    with torch.no_grad():
        ps, rs = port.encode(batch), ref.encode(batch)
        for zp, zr in zip(ps.z, rs.z):
            assert _rel(zp, zr) < 1e-4
        for fp, fr in zip(ps.flows, rs.flows):
            assert _rel(fp, fr) < 1e-4
        assert _rel(ps.rel_pose, rs.rel_pose) < 1e-4
        out = port.render(batch, ps, val=True)
    rgb, at = reference_render(ref, batch, rs, n, 1024)
    assert _rel(out["rgb"].reshape(-1, 3), rgb) < tol
    assert _rel(out["at_wt"], at) < tol * 10


def test_reference_trains_as_the_port():
    from coponerf_tpu_torch.training.losses import lf_loss as port_loss
    from coponerf_tpu_torch.config import LossConfig as PortLoss

    from portbench.reference.config import LossConfig
    from portbench.reference.losses import lf_loss

    port, ref = _pair(dict(compute_dtype="float32"))
    batch = scenes.make_batch(5, [0, 1], SIZE, 32, "cpu")
    lp = port_loss(PortLoss(pose=True, cycle=True, ssim=True), batch, port(batch, val=False, train=True),
                   batch["query"])[0]
    lr = lf_loss(LossConfig(pose=True, cycle=True, ssim=True), batch, ref(batch, val=False, train=True),
                 batch["query"])
    assert set(lp) == set(lr)
    for k in lr:
        a, b = float(lp[k].detach()), float(lr[k].detach())
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-6, k
    # gradients of the terms the pose head does not amplify
    sum(v for k, v in lp.items() if k != "pose_loss").backward()
    sum(v for k, v in lr.items() if k != "pose_loss").backward()
    rp = dict(port.named_parameters())
    gaps = [_rel(rp[n].grad, p.grad) for n, p in ref.named_parameters()
            if p.grad is not None and float(p.grad.norm()) > 0]
    assert len(gaps) > 100 and np.median(gaps) < 1e-4 and max(gaps) < 1e-2
