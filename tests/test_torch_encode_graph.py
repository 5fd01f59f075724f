"""The inference encode's constants and CUDA graphs
(``models/encode_graph.py``).

On the CPU: ``ops/resize.py``'s interpolation matrices and the encode's
constants are made once a key, bit for bit what they were, so a repeated
encode or train step waits only where the host reads the device; encodes
that cannot replay a graph (CPU inputs, gradients on, ``train=True``) run
eagerly with today's bits; the benchmark's ``encode_graph_share`` reader.
The test marked ``cuda`` holds the graphed encode to the eager one on the
card."""

from __future__ import annotations

import copy
import importlib.util
import os
import sys
import warnings

import pytest
import torch

from coponerf_tpu_torch import flow as flow_ops
from coponerf_tpu_torch import geometry as G
from coponerf_tpu_torch import trace
from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.models import CoPoNeRF, SceneState, batch_to_torch
from coponerf_tpu_torch.models.coponerf import IMAGENET_MEAN, IMAGENET_STD
from coponerf_tpu_torch.ops import resize
from coponerf_tpu_torch.training import trainer
from coponerf_tpu_torch.utils.init import init_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
CFG = ModelConfig(mask_upsample=SIZE, npoints=4, ufc_layer_nums=(1, 1, 1), fast_sampling=True,
                  compute_dtype="bfloat16", coarse_samples=4, fine_samples=2)
TCFG = Config(model=CFG, loss=LossConfig(pose=True, cycle=True, ssim=True), train=TrainConfig(lr=1e-4))


@pytest.fixture(scope="module")
def model():
    return init_weights(CoPoNeRF(CFG, image_size=SIZE), seed=0).eval()


@pytest.fixture(scope="module")
def batch():
    return batch_to_torch(make_batch(batch_size=1, image_size=SIZE, n_rays=64, seed=2)[0], "cpu")


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset()
    yield
    trace.reset()


def _contract_before(x, ax, out_size, align_corners):
    """``ops/resize.py:_contract`` as it was: a new matrix copied every call."""
    w = torch.from_numpy(resize._linear_weights_np(x.shape[ax], out_size, align_corners))
    w = w.to(device=x.device, dtype=x.dtype)
    return torch.movedim(torch.tensordot(w, x, dims=([1], [ax])), 0, ax)


def _encode_before(model, batch, train):
    """``CoPoNeRF.encode`` as it was before its constants were cached and
    its stages split out (run with ``_contract_before`` in place)."""
    ctx = batch["context"]
    rgb = ctx["rgb"]
    B, V, H, W, _ = rgb.shape
    rgb = rgb.reshape(B * V, H, W, 3)
    mean = torch.tensor(IMAGENET_MEAN, dtype=rgb.dtype, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, dtype=rgb.dtype, device=rgb.device)
    rgb = ((rgb + 1.0) / 2.0 - mean) / std
    cd = torch.bfloat16 if model.cfg.compute_dtype == "bfloat16" else torch.float32
    z_feats = model.encoder(rgb.to(cd), train=train)
    z_conv = model.conv_map(rgb)
    feat_list, flows, c = model.feature_cost_aggregation(z_feats, V)
    intr = ctx["intrinsics"]
    fx = intr[:, 0, 0, 0][:, None] / H
    fy = intr[:, 0, 1, 1][:, None] / H
    cx = intr[:, 0, 0, 2][:, None] / H
    cy = intr[:, 0, 1, 2][:, None] / H
    tokens = feat_list[-1].reshape(B * V, -1, feat_list[-1].shape[-1]).float()
    pose_feat = model.cross_attention(tokens, c, (fx, fy, cx, cy)).reshape(B, -1)
    pose_latent = model.pose_regressor(pose_feat)[:, :128]
    rot = model.rotation_regressor(pose_latent)
    tran = model.translation_regressor(pose_latent)
    R = G.r6d2mat(rot)[:, :3, :3]
    top = torch.cat([R, tran[..., None]], dim=-1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype, device=top.device)
    rel_pose = torch.cat([top, bottom.expand(B, 1, 4)], dim=1)
    z = tuple(t.contiguous() for t in (*feat_list, z_conv))
    up = model.cfg.mask_upsample
    _, _, _, mask_bwd = flow_ops.cyclic_consistency_masks(flows[0], flows[1], out_size=up, scale=up / W)
    kps_flow_bwd = resize.resize_nchw(flows[1], (up, up), align_corners=False) * (up / flows[1].shape[-2])
    z0_bf16 = None
    if model.cfg.fast_sampling and not train:
        for zl in z:
            if zl.shape[1] * zl.shape[2] > 4096:
                z0_bf16 = zl.to(torch.bfloat16)
    return SceneState(z=z, rel_pose=rel_pose, flows=tuple(flows), mask_bwd=mask_bwd.float(),
                      kps_flow_bwd=kps_flow_bwd, z0_bf16=z0_bf16)


def _tensors(state):
    return [t for t in (*state.z, state.rel_pose, *state.flows, state.mask_bwd, state.kps_flow_bwd, state.z0_bf16)
            if t is not None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align_corners", [False, True])
def test_contract_matrix_is_made_once_a_key_bit_for_bit(align_corners, dtype):
    """Sizes no model here resizes between, so each key is new to this process."""
    for in_size, out_size in ((13, 53), (53, 13), (7, 7)):
        before = trace.counters["host_syncs"]
        w = resize._linear_weights(in_size, out_size, align_corners, torch.device("cpu"), dtype)
        ref = torch.from_numpy(resize._linear_weights_np(in_size, out_size, align_corners)).to(dtype)
        assert w.dtype == dtype and torch.equal(w, ref)
        assert resize._linear_weights(in_size, out_size, align_corners, torch.device("cpu"), dtype) is w
        assert trace.counters["host_syncs"] - before == 1      # the one copy, on the key's first use
        x = torch.randn(2, in_size, 5, dtype=torch.float64).to(dtype)
        assert torch.equal(resize._contract(x, 1, out_size, align_corners),
                           _contract_before(x, 1, out_size, align_corners))


@pytest.mark.parametrize("case", ["eval_encode", "train_step"])
def test_a_second_call_waits_only_where_the_host_reads(model, batch, case):
    """The second eval encode waits nowhere; the second train step only at
    ``ps_rows``, the four ``linalg.inv`` sites, the finite check and the clip."""
    if case == "eval_encode":
        span, expected = "encode", 0

        def call():
            with torch.no_grad():
                model.encode(batch)
    else:
        span, expected = "train_step", 7
        state = trainer.create_train_state(TCFG, SIZE, "cpu", model=copy.deepcopy(model).train())
        tbatch = batch_to_torch(make_batch(batch_size=2, image_size=SIZE, n_rays=8, seed=1)[0], "cpu")

        def call():
            trainer.train_step(state, tbatch, TCFG)
    for _ in range(2):
        trace.reset()
        with trace.collecting():
            call()
    assert trace.summary()["spans"][span]["host_syncs"] == expected


@pytest.mark.parametrize("case", ["no_grad", "grad", "train"])
def test_an_encode_that_cannot_replay_runs_eagerly_with_todays_bits(model, batch, case, monkeypatch):
    """CPU inputs under ``no_grad``, gradients on, and ``train=True``."""
    train = case == "train"
    grad = torch.no_grad() if case == "no_grad" else torch.enable_grad()
    m_now, m_before = (copy.deepcopy(model) for _ in range(2))    # train=True moves BatchNorm's statistics
    with grad:
        now = m_now.encode(batch, train=train)
        with monkeypatch.context() as mp:
            mp.setattr(resize, "_contract", _contract_before)
            before = _encode_before(m_before, batch, train)
    assert trace.counters["encode_graph_replays"] == 0
    assert len(m_now._encode_graphs._captured) == 0
    for a, b in zip(_tensors(now), _tensors(before)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
    for a, b in zip(m_now.buffers(), m_before.buffers()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change,moves", [
    ("in_place_update", False), ("to_same_device", False), ("to_new_storage", True),
    ("assigning_load_state_dict", True), ("copying_load_state_dict", False),
])
def test_observe_sees_what_moves_the_storage(model, change, moves):
    """What ``EncodeGraphs`` checks a call: a captured graph reads the
    parameters and buffers where they lay at capture."""
    from coponerf_tpu_torch.models.encode_graph import _observe

    m = copy.deepcopy(model)
    before, hooked = _observe(m)
    assert not hooked and len(before) == len(list(m.parameters())) + len(list(m.buffers()))
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    with torch.no_grad():
        if change == "in_place_update":
            for p in m.parameters():
                p.add_(1.0)
        elif change == "to_same_device":
            m.to("cpu")
        elif change == "to_new_storage":
            m.to(torch.float64).to(torch.float32)
        elif change == "assigning_load_state_dict":
            m.load_state_dict(sd, assign=True)
        else:
            m.load_state_dict(sd)
    assert (_observe(m)[0] != before) == moves


def test_observe_sees_forward_hooks_and_copies_start_empty(model):
    from coponerf_tpu_torch.models.encode_graph import EncodeGraphs, _observe

    m = copy.deepcopy(model)
    assert isinstance(m._encode_graphs, EncodeGraphs) and m._encode_graphs is not model._encode_graphs
    h = m.feature_cost_aggregation.layers_0_0.register_forward_pre_hook(lambda mod, args: None)
    assert _observe(m)[1]
    h.remove()
    assert not _observe(m)[1]
    h = torch.nn.modules.module.register_module_forward_hook(lambda mod, args, out: None)
    try:
        assert _observe(m)[1]
    finally:
        h.remove()
    assert not _observe(m)[1]


def _share_reader():
    path = os.path.join(REPO, "portbench", "metrics", "encode_graph_share.py")
    spec = importlib.util.spec_from_file_location("reader_encode_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _enc_summary(calls, replays):
    span = {"calls": calls, "host_ms": 1.0, "device_ms": 1.0, "host_syncs": 0, "collectives": 0}
    if replays is not None:
        span["encode_graph_replays"] = replays
    return {"spans": {"spans": {"encode": span}, "counters": {}, "dropped": 0}}


@pytest.mark.parametrize("case,rec,expected", [
    ("no_tracer", {}, None),
    ("a_tracer_without_the_counter", _enc_summary(4, None), None),
    ("no_encode", {"spans": {"spans": {}, "counters": {}, "dropped": 0}}, None),
    ("every_encode_replayed", _enc_summary(4, 4), 100.0),
    ("half_replayed", _enc_summary(4, 2), 50.0),
])
def test_encode_graph_share_reader(case, rec, expected, monkeypatch):
    if case == "no_tracer":
        monkeypatch.setitem(sys.modules, "coponerf_tpu_torch.trace", None)    # its import then fails
    assert _share_reader()(rec) == expected


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture and replay on a card only")
    return torch.device("cuda")


def _waits(fn):
    """(the waits CUDA's sync debug mode reports in ``fn``, the ``host_syncs``
    counted there, the warnings' sites).  The mode's first switch on
    reports a wait of its own, taken here first."""
    with warnings.catch_warnings(record=True):
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    before = trace.counters["host_syncs"]
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    hits = [w for w in got if "synchroniz" in str(w.message)]
    return len(hits), trace.counters["host_syncs"] - before, sorted({f"{w.filename}:{w.lineno}" for w in hits})


@pytest.mark.cuda
@pytest.mark.parametrize("fused_argmax", [None, True])
def test_graphed_encode_on_the_card(cuda, fused_argmax):
    """A 256^2 cf[16,4] model: two pairs encoded in turn through the graphs,
    each bit for bit the eager encode; the first state unchanged by the
    second encode; no wait in a replay; one replay a call; a move of the
    weights' storage captures anew; a forward hook runs the encode eagerly.
    With ``fused_argmax`` K5 runs inside the UFC's graph and its launch
    counter gains one a replay."""
    from coponerf_tpu_torch.ops.soft_argmax import soft_argmax_stats

    cfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=16, fine_samples=4,
                      fused_argmax=fused_argmax)
    model = init_weights(CoPoNeRF(cfg, image_size=256), seed=0).to(cuda).eval()
    pairs = [batch_to_torch(make_batch(batch_size=1, image_size=256, n_rays=16, seed=s)[0], cuda) for s in (0, 1)]

    def eager(b):
        with torch.no_grad():
            return _tensors(model._encode_eager(b["context"]["rgb"], b["context"]["intrinsics"]))

    def graphed(b):
        with torch.no_grad():
            return model.encode(b)

    def same(state, ref):
        return all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(_tensors(state), ref))

    refs = [eager(b) for b in pairs]
    k5 = soft_argmax_stats.launches
    states = [graphed(b) for b in pairs]
    assert trace.counters["encode_graph_replays"] == 2
    assert soft_argmax_stats.launches - k5 == (3 if fused_argmax else 0)   # the warm-up's and two replays'
    assert len(model._encode_graphs._captured) == 1
    assert same(states[0], refs[0]) and same(states[1], refs[1])
    again = graphed(pairs[0])
    assert same(again, refs[0]) and same(states[1], refs[1])      # the kept state did not move
    assert trace.counters["encode_graph_replays"] == 3

    n, counted, sites = _waits(lambda: graphed(pairs[1]))
    assert (n, counted) == (0, 0), sites
    assert trace.counters["encode_graph_replays"] == 4

    first = next(iter(model._encode_graphs._captured.values()))
    model.to("cpu").to(cuda)              # new storage for every parameter and buffer
    assert same(graphed(pairs[1]), refs[1])
    assert next(iter(model._encode_graphs._captured.values())) is not first
    assert trace.counters["encode_graph_replays"] == 5

    seen = []
    hook = model.feature_cost_aggregation.register_forward_hook(lambda mod, args, out: seen.append(out[2]))
    try:
        assert same(graphed(pairs[0]), refs[0])
    finally:
        hook.remove()
    assert len(seen) == 1 and trace.counters["encode_graph_replays"] == 5
