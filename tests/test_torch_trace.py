"""The port's tracer (``coponerf_tpu_torch/trace.py``): off, a span is one
shared no-op context and the outputs are those of the untraced code; on,
under ``trace.collecting()`` or a ``torch.profiler`` session, an encode, a
chunked render and a train step give the span tree README's "Tracing"
lists, with self times that add up; the summary reports the kernel
wrappers' launch counters; records stop at the cap.  The test marked
``cuda`` holds the ``host_syncs`` counter to the waits that CUDA's sync
debug mode reports on the card."""

from __future__ import annotations

import copy
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coponerf_tpu_torch import trace
from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.eval.harness import make_renderer
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.training import trainer
from coponerf_tpu_torch.utils.init import init_weights

SIZE = 32
CFG = ModelConfig(mask_upsample=SIZE, npoints=4, ufc_layer_nums=(1, 1, 1), fast_sampling=True,
                  compute_dtype="bfloat16", coarse_samples=4, fine_samples=2)
TCFG = Config(model=CFG, loss=LossConfig(pose=True, cycle=True, ssim=True), train=TrainConfig(lr=1e-4))
# each span's parent: eval (encode, then the image's chunks) and the train step
EVAL_TREE = {"encode": None, "encode.backbone": "encode", "encode.ufc": "encode", "encode.pose": "encode",
             "render_image": None, "render": "render_image", "render.stage_a": "render",
             "render.stage_b": "render", "render.attention": "render", "render.decode": "render"}
TRAIN_TREE = {"train_step": None, "train.forward": "train_step", "train.loss": "train_step",
              "train.backward": "train_step", "train.update": "train_step", "encode": "train.forward",
              "encode.backbone": "encode", "encode.ufc": "encode", "encode.pose": "encode",
              "render": "train.forward", "render.stage_a": "render", "render.attention": "render",
              "render.decode": "render"}


@pytest.fixture(scope="module")
def model():
    """The tiny model with seeded weights: norm scales 1, biases 0, the rest
    normal over sqrt(fan-in) (``utils/init.py``'s rule, drawn by torch)."""
    m = CoPoNeRF(CFG, image_size=SIZE).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in m.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bias", "running_mean"):
                t.zero_()
            elif leaf == "running_var" or t.dim() == 1:
                t.fill_(1.0)
            else:
                t.copy_(torch.randn(t.shape, generator=g) / t[0].numel() ** 0.5)
    return m


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset()
    yield
    trace.reset()


def _eval(model, chunk=512):
    """One 32^2 request: the encode and the image in 1024 / ``chunk`` chunks."""
    batch = batch_to_torch(make_batch(batch_size=1, image_size=SIZE, n_rays=SIZE * SIZE, seed=2,
                                      full_query_image=True)[0], "cpu")
    encode, render_image = make_renderer(model, chunk=chunk)
    return render_image(batch, encode(batch), SIZE * SIZE)


def _train(model):
    """One train step from a copy of ``model``: (its metrics, its parameters)."""
    state = trainer.create_train_state(TCFG, SIZE, "cpu", model=copy.deepcopy(model).train())
    batch = batch_to_torch(make_batch(batch_size=2, image_size=SIZE, n_rays=8, seed=1)[0], "cpu")
    metrics = trainer.train_step(state, batch, TCFG)
    assert state.updates == 1
    return metrics, [p.detach().clone() for p in state.model.parameters()]


def _check_tree(summary, tree, calls):
    spans = summary["spans"]
    assert set(spans) == set(tree), sorted(spans)
    for name, parent in tree.items():
        s = spans[name]
        assert s["calls"] == calls.get(name, 1), (name, s["calls"])
        assert s["parents"] == {parent or "": s["calls"]}, (name, s["parents"])
        assert s["device_ms"] is None and s["self_device_ms"] is None     # no CUDA events on a CPU
        assert 0.0 <= s["self_host_ms"] <= s["host_ms"]
    for name in spans:
        kids = [k for k, p in tree.items() if p == name]
        if kids:
            below = sum(spans[k]["host_ms"] for k in kids)
            assert below <= spans[name]["host_ms"]
            assert spans[name]["self_host_ms"] == pytest.approx(spans[name]["host_ms"] - below, abs=1e-6)


def test_off_spans_record_nothing_and_change_nothing(model, monkeypatch):
    """Off (no collecting, no profiler): the shared no-op context, no record,
    no ``record_function``; on, the same outputs bit for bit."""
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name) or real(name))
    assert trace.span("encode") is trace.span("render")
    off = _eval(model)
    off_metrics, off_params = _train(model)
    assert entered == [] and trace.summary()["spans"] == {}
    with trace.collecting():
        on = _eval(model)
        on_metrics, on_params = _train(model)
    assert "render.attention" in entered and "train.update" in entered
    for k in off:
        assert torch.equal(off[k], on[k]), k
    for k in off_metrics:
        assert torch.equal(off_metrics[k], on_metrics[k]), k
    assert all(torch.equal(a, b) for a, b in zip(off_params, on_params))


def test_collecting_gives_the_span_tree(model):
    with trace.collecting():
        _eval(model, chunk=512)
    s = trace.summary()
    _check_tree(s, EVAL_TREE, {"render": 2, "render.stage_a": 2, "render.stage_b": 2, "render.attention": 2,
                               "render.decode": 2})
    spans = s["spans"]
    # the counted waits of a request lie in its encode and its image
    assert s["counters"]["host_syncs"] == spans["encode"]["host_syncs"] + spans["render_image"]["host_syncs"] > 0
    assert spans["render_image"]["host_syncs"] == spans["render"]["host_syncs"]
    assert s["counters"]["collectives"] == 0 and s["dropped"] == 0
    trace.reset()
    with trace.collecting():
        _train(model)
    s = trace.summary()
    _check_tree(s, TRAIN_TREE, {})
    assert s["spans"]["train.update"]["host_syncs"] == 2        # the finite check and the clip's norm


def test_a_profiler_session_turns_the_spans_on(model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _eval(model, chunk=1024)
    _check_tree(trace.summary(), EVAL_TREE, {})
    names = {e.name for e in prof.events()}
    assert set(EVAL_TREE) <= names           # each stage is a record_function in the profile


def test_summary_reports_the_launch_counters():
    from coponerf_tpu_torch.ops.split_matmul import split_dense_relu
    from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_smaj

    counts = trace.summary()["counters"]
    assert sum(k.startswith("launches.") for k in counts) == 12
    assert counts["launches.split_dense_relu"] == split_dense_relu.launches
    assert counts["launches.weighted_sum_smaj"] == weighted_sum_smaj.launches
    with trace.collecting(), trace.span("outer"):
        split_dense_relu.launches += 3       # as three launches would
        trace.count("host_syncs")
        with trace.span("inner"):
            trace.count("collectives", 2)
    split_dense_relu.launches -= 3
    spans = trace.summary()["spans"]
    assert spans["outer"]["launches"] == {"split_dense_relu": 3}
    assert (spans["outer"]["host_syncs"], spans["outer"]["collectives"]) == (1, 2)
    assert (spans["inner"]["host_syncs"], spans["inner"]["collectives"]) == (0, 2)
    assert spans["inner"]["parents"] == {"outer": 1}


def test_records_stop_at_the_cap(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with trace.collecting():
        for _ in range(5):
            with trace.span("s"):
                pass
    s = trace.summary()
    assert s["spans"]["s"]["calls"] == 3 and s["dropped"] == 2
    trace.reset()
    s = trace.summary()
    assert s["spans"] == {} and s["dropped"] == 0 and s["counters"]["host_syncs"] == 0


def test_a_mesh_step_counts_its_collectives(model, tmp_path):
    """A one-rank gloo mesh: the gradient all-reduce is its own span with
    one collective; BatchNorm's and the losses' all-reduces fall in the
    forward, the loss and the backward."""
    from coponerf_tpu_torch.parallel import mesh as pmesh

    pmesh.init_distributed("gloo", 0, 1, f"file://{tmp_path}/rendezvous")
    try:
        mesh = pmesh.make_mesh()
        state = trainer.create_train_state(TCFG, SIZE, "cpu", model=copy.deepcopy(model).train())
        batch = batch_to_torch(make_batch(batch_size=2, image_size=SIZE, n_rays=8, seed=1)[0], "cpu")
        with trace.collecting():
            trainer.train_step(state, batch, TCFG, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    spans = trace.summary()["spans"]
    assert spans["train.allreduce"]["calls"] == 1 and spans["train.allreduce"]["collectives"] == 1
    assert spans["train.allreduce"]["parents"] == {"train_step": 1}
    n_bn = sum(type(m).__name__ == "BatchNorm" for m in model.modules())
    assert spans["train.forward"]["collectives"] == n_bn
    assert spans["train.backward"]["collectives"] == n_bn
    assert spans["train.loss"]["collectives"] == 3          # the SSIM pair's mask sums and the cycle's
    # and the metrics' average over the ranks, in the step's own time
    assert spans["train_step"]["collectives"] == 2 * n_bn + 3 + 1 + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA's sync debug mode reports waits on a card only")
    return torch.device("cuda")


def _waits(fn):
    """(the waits CUDA's sync debug mode reports in ``fn``, the
    ``host_syncs`` counted there, the warnings' sites)."""
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


def _quiet_first_switch():
    """The mode's first switch on reports a wait of its own; take it here."""
    with warnings.catch_warnings(record=True):
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_host_syncs_count_every_wait_on_the_card(cuda):
    """The benchmark's paths at full width: one cf[16,4] evaluation request
    at 256^2 (encode and two 32768-ray chunks), one camera-path frame, one
    single-stage train step of two pairs; each after a warm-up."""
    from coponerf_tpu_torch.eval.trajectory import interpolate_poses

    cfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=16, fine_samples=4)
    model = init_weights(CoPoNeRF(cfg, image_size=256), seed=0).to(cuda).eval()
    encode, render_image = make_renderer(model, chunk=32768)
    np_batch = make_batch(batch_size=1, image_size=256, n_rays=256 * 256, seed=0, full_query_image=True)[0]
    batch = batch_to_torch(np_batch, cuda)
    pose = interpolate_poses(np_batch["context"]["cam2world"][0, 0], np_batch["context"]["cam2world"][0, 1], 3)[1]
    frame = dict(batch, query=dict(batch["query"], cam2world=torch.as_tensor(pose, device=cuda)[None, None]))

    def request():
        render_image(batch, encode(batch), 256 * 256)

    state = encode(batch)
    _quiet_first_switch()
    for fn in (request, lambda: render_image(frame, state, 256 * 256)):
        fn()
        n, counted, sites = _waits(fn)
        assert n == counted > 0, (n, counted, sites)
    del model, encode, render_image, state
    scfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16")       # the train cell's single stage
    tcfg = Config(model=scfg, loss=LossConfig(pose=True, cycle=True, ssim=True), train=TrainConfig())
    tstate = trainer.create_train_state(tcfg, 256, cuda, model=init_weights(CoPoNeRF(scfg, image_size=256), seed=0))
    tbatch = batch_to_torch(make_batch(batch_size=2, image_size=256, n_rays=192, seed=1)[0], cuda)
    trainer.train_step(tstate, tbatch, tcfg)
    n, counted, sites = _waits(lambda: trainer.train_step(tstate, tbatch, tcfg))
    assert n == counted > 0, (n, counted, sites)
