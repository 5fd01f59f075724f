"""In-training validation and evaluation summaries of the port on the CPU:
``training/validation.py:make_val_fn`` and ``eval/harness.py:evaluate(
logger=...)`` against the JAX package's on the same narrow weights (exact
config, 32^2 full-image synthetic pairs, 512-ray chunks).  The loop's
``val_fn`` cadence and the ``train`` entry with ``--val_root`` are
``tests/test_torch_train_entry.py``'s.

Bounds: every logged ``val_*`` loss term and summary scalar at 1e-4
relative (1e-5 absolute; the exact slice matches JAX at 1e-4,
``tests/test_torch_slice_exact.py``), the prediction, context, query and
warped panels at 1e-4 absolute.  The depth panel is a 256-entry colour
table: a depth within round-off of a table edge takes the neighbouring
entry, so at most 1 % of its values may differ by one entry's step (at
most 0.02 in jet), the rest at 1e-4.  The JAX references are computed
once per module.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coponerf_tpu.config import Config as JConfig
from coponerf_tpu.config import LossConfig as JLossConfig
from coponerf_tpu.config import ModelConfig as JModelConfig
from coponerf_tpu.config import TrainConfig as JTrainConfig
from coponerf_tpu.data.synthetic import make_batch
from coponerf_tpu.eval.harness import evaluate as j_evaluate
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.training.trainer import TrainState as JTrainState
from coponerf_tpu.training.trainer import make_optimizer as j_make_optimizer
from coponerf_tpu.training.validation import make_val_fn as j_make_val_fn
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
from coponerf_tpu_torch.eval.harness import evaluate
from coponerf_tpu_torch.models import CoPoNeRF
from coponerf_tpu_torch.training import trainer
from coponerf_tpu_torch.training.validation import make_val_fn
from coponerf_tpu_torch.utils.convert import convert

torch.set_num_threads(2)

IMG = 32
CHUNK = 512
CFG_KW = dict(npoints=4, ufc_layer_nums=(1, 1, 1), mask_upsample=IMG)
LOSS_KW = dict(pose=True, cycle=True, ssim=True)


class RecordingLogger:
    def __init__(self):
        self.scalars, self.images, self.steps = {}, {}, []

    def log(self, step, metrics):
        self.steps.append(step)
        self.scalars.update(metrics)

    def log_image(self, step, tag, img):
        self.images[tag] = np.asarray(img)


def _full_pair(seed):
    b, g = make_batch(batch_size=1, image_size=IMG, n_rays=IMG * IMG, seed=seed, full_query_image=True)
    return b, g


class _EvalSet:
    def __init__(self, seeds):
        self.items = []
        for s in seeds:
            b, g = _full_pair(s)
            self.items.append(({k: {kk: vv[0] for kk, vv in v.items()} for k, v in b.items()},
                               {k: v[0] for k, v in g.items()}, np.float32(0.6)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def setup():
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=16, seed=0)
    jm = JaxCoPoNeRF(JModelConfig(**CFG_KW))
    variables = fast_init(jm, jax.tree.map(jnp.asarray, batch_np), val=False, train=False)
    jcfg = JConfig(model=JModelConfig(**CFG_KW), loss=JLossConfig(**LOSS_KW), train=JTrainConfig())
    jstate = JTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                batch_stats=variables.get("batch_stats", {}),
                                tx=j_make_optimizer(jcfg, steps_per_epoch=10))
    val_batches = [_full_pair(s) for s in (0, 1)]
    ref_val = RecordingLogger()
    j_make_val_fn(jcfg, val_batches, chunk=CHUNK, image_size=IMG)(jstate, step=4, logger=ref_val)
    ref_eval = RecordingLogger()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_evaluate(jm, variables, _EvalSet((5,)), batch_size=1, chunk=CHUNK, image_size=IMG, verbose=False,
                   logger=ref_eval)
    cfg = Config(model=ModelConfig(**CFG_KW), loss=LossConfig(**LOSS_KW), train=TrainConfig())
    port = CoPoNeRF(cfg.model, image_size=IMG)
    port.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    state = trainer.create_train_state(cfg, IMG, "cpu", model=port)
    return cfg, state, val_batches, ref_val, ref_eval


def _assert_panel(tag, got, want):
    assert got.shape == want.shape, tag
    d = np.abs(got - want)
    if tag.endswith("depth_images"):
        assert d.max() <= 0.02 and (d > 1e-4).mean() <= 0.01, (tag, d.max(), (d > 1e-4).mean())
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=tag)


def _assert_scalars(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-5), (k, got[k], v)


def test_val_fn_matches_jax(setup):
    """Every enabled term (img, ssim, cycle, pose) as ``val_<term>``, the
    mean over the two pairs, and the last pair's summaries."""
    cfg, state, val_batches, ref, _ = setup
    got = RecordingLogger()
    state.model.train()
    make_val_fn(cfg, val_batches, chunk=CHUNK, image_size=IMG)(state, 4, got)
    assert state.model.training            # put back in train mode
    for term in ("val_img_loss", "val_ssim_loss", "val_cycle_loss", "val_pose_loss"):
        assert term in got.scalars
    _assert_scalars(got.scalars, ref.scalars)
    assert sorted(got.images) == sorted(ref.images)
    for tag in ("val_predictions", "val_depth_images", "val_context_images", "val_query_images"):
        _assert_panel(tag, got.images[tag], ref.images[tag])
    assert set(got.steps) == {4}


def test_val_fn_keeps_max_batches(setup):
    cfg, state, val_batches, _, _ = setup
    one = RecordingLogger()
    make_val_fn(cfg, val_batches, chunk=CHUNK, image_size=IMG, max_batches=1)(state, 0, one)
    first = RecordingLogger()
    make_val_fn(cfg, val_batches[:1], chunk=CHUNK, image_size=IMG)(state, 0, first)
    assert one.scalars == first.scalars


def test_evaluate_logs_panels_as_jax(setup):
    """``evaluate(logger=...)``: the panels and pose scalars of each batch
    under ``val_`` at step = the batch index, as the JAX package's."""
    _, state, _, _, ref = setup
    got = RecordingLogger()
    model = state.model.eval()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        evaluate(model, _EvalSet((5,)), batch_size=1, chunk=CHUNK, image_size=IMG, verbose=False, logger=got)
    _assert_scalars(got.scalars, ref.scalars)
    assert sorted(got.images) == sorted(ref.images) and got.steps == [0]
    for tag in ("val_predictions", "val_depth_images", "val_warped_img"):
        _assert_panel(tag, got.images[tag], ref.images[tag])
