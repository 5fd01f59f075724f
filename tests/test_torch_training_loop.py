"""The port's training loop on the CPU, without JAX: a batch with NaN
gradients applies nothing, a checkpointed run resumes bit for bit, and the
``python -m coponerf_tpu_torch.train`` entry point trains and refuses to
start without a CUDA device unless given ``--device cpu``."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from coponerf_tpu_torch import train as train_entry

from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.training import checkpoint as ckpt_lib
from coponerf_tpu_torch.training import trainer
from coponerf_tpu_torch.utils.init import init_weights

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32


def _cfg(**model):
    return Config(model=ModelConfig(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1), **model),
                  loss=LossConfig(pose=True, cycle=True, ssim=True),
                  train=TrainConfig(lr=1e-4, steps_per_epoch=2))


def _state(cfg, seed):
    model = init_weights(CoPoNeRF(cfg.model, image_size=IMG), seed=seed)
    return trainer.create_train_state(cfg, IMG, "cpu", model=model)


def _batch(seed):
    return batch_to_torch(make_batch(batch_size=2, image_size=IMG, n_rays=16, seed=seed)[0], "cpu")


def _snapshot(state):
    params = {k: v.clone() for k, v in state.model.named_parameters()}
    opt = {id_: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
           for id_, st in state.optimizer.state_dict()["state"].items()}
    return params, opt


def test_nan_batch_skips_update():
    """The port's copy of ``tests/test_model.py:130``: after a clean step, a
    batch whose context images hold NaN leaves the parameters, the Adam
    state and the update count bitwise unchanged and counts a skip; the next
    clean step updates again and resets the consecutive count."""
    cfg = _cfg()
    state = _state(cfg, seed=2)
    trainer.train_step(state, _batch(2), cfg)
    params, opt = _snapshot(state)
    poisoned = _batch(2)
    poisoned["context"]["rgb"][..., 0] = float("nan")
    metrics = trainer.train_step(state, poisoned, cfg)
    assert not torch.isfinite(metrics["grad_norm"])
    assert (state.step, state.updates, state.notfinite_count, state.total_notfinite) == (2, 1, 1, 1)
    params2, opt2 = _snapshot(state)
    for k in params:
        assert torch.equal(params[k], params2[k]), k
    assert opt.keys() == opt2.keys()
    for i in opt:
        for k, v in opt[i].items():
            assert torch.equal(v, opt2[i][k]) if torch.is_tensor(v) else v == opt2[i][k], (i, k)
    trainer.train_step(state, _batch(3), cfg)
    assert (state.updates, state.notfinite_count, state.total_notfinite) == (2, 0, 1)
    assert any(not torch.equal(params[k], p) for k, p in state.model.named_parameters())


@pytest.mark.parametrize("debug_nans", [False, True], ids=["skip", "debug_nans"])
def test_debug_nans_raises_where_the_step_would_skip(debug_nans):
    """With ``TrainConfig.debug_nans`` (the ``train`` entry's
    ``--debug_nans``) a batch whose context images hold NaN raises
    ``FloatingPointError`` at the first module whose output holds one,
    and applies nothing; without it the step is skipped.  On a clean batch
    the flag changes no bit of the step."""
    cfg = _cfg()
    dcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, debug_nans=True))
    clean = {}
    for c in (cfg, dcfg):
        state = _state(c, seed=2)
        metrics = trainer.train_step(state, _batch(2), c)
        clean[c.train.debug_nans] = (metrics, _snapshot(state)[0])
    for k, v in clean[False][0].items():
        assert torch.equal(v, clean[True][0][k]), k
    for k, v in clean[False][1].items():
        assert torch.equal(v, clean[True][1][k]), k
    run = dcfg if debug_nans else cfg
    params, _ = _snapshot(state)
    poisoned = _batch(2)
    poisoned["context"]["rgb"][..., 0] = float("nan")
    if debug_nans:
        with pytest.raises(FloatingPointError, match="NaN in the output of encoder"):
            trainer.train_step(state, poisoned, run)
        assert (state.step, state.updates, state.notfinite_count) == (1, 1, 0)
    else:
        trainer.train_step(state, poisoned, run)
        assert (state.step, state.updates, state.notfinite_count) == (2, 1, 1)
    for k, p in state.model.named_parameters():
        assert torch.equal(params[k], p), k
    flags = train_entry.build_parser().parse_args(["--experiment_name", "x"] + (["--debug_nans"] if debug_nans else []))
    assert train_entry.build_config(flags, IMG, 0).train.debug_nans is debug_nans


def test_resume_is_bit_exact(tmp_path):
    """The port's copy of ``tests/test_checkpoint.py:79``: three steps in one
    go equal two steps, a save, a restore into a fresh state (other seed),
    and a third step, bit for bit: weights, BN buffers, Adam state and the
    counters, across an epoch boundary of the lr schedule."""
    cfg = _cfg(fast_sampling=True, compute_dtype="bfloat16")
    batches = [_batch(s) for s in (4, 5, 6)]
    ref = _state(cfg, seed=0)
    for b in batches:
        trainer.train_step(ref, b, cfg)
    run = _state(cfg, seed=0)
    for b in batches[:2]:
        trainer.train_step(run, b, cfg)
    path = ckpt_lib.save(str(tmp_path), run, step=run.step)
    resumed = ckpt_lib.restore_into(_state(cfg, seed=1), path)
    os.remove(path)             # about 1.2 GB
    assert (resumed.step, resumed.updates) == (2, 2)
    trainer.train_step(resumed, batches[2], cfg)
    for (k, a), (_, b) in zip(ref.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = ref.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert (ref.step, ref.updates) == (resumed.step, resumed.updates) == (3, 3)


def test_resume_fills_the_adam_state_an_older_file_lacks(tmp_path):
    """A ``.pt`` without Adam state for the parameters that no loss reaches
    (the port's step left them out of Adam until it gave them optax's zero
    gradient) resumes with zero moments at Adam's step = ``updates``: the
    next step equals the uninterrupted run's bit for bit, and every
    parameter's Adam step stays ``updates``, the one count a JAX ``.npz``
    keeps (``utils/jax_checkpoint.py:save`` refuses a state otherwise)."""
    cfg = _cfg(fast_sampling=True, compute_dtype="bfloat16")
    batches = [_batch(s) for s in (4, 5)]
    ref = _state(cfg, seed=0)
    for b in batches:
        trainer.train_step(ref, b, cfg)
    run = _state(cfg, seed=0)
    trainer.train_step(run, batches[0], cfg)
    path = ckpt_lib.save(str(tmp_path), run, step=run.step)
    payload = torch.load(path, weights_only=True)
    os.remove(path)             # about 1.2 GB
    states = payload["optimizer"]["state"]
    gradless = [i for i, st in states.items() if not st["exp_avg"].any() and not st["exp_avg_sq"].any()]
    assert gradless
    for i in gradless:
        del states[i]
    old = str(tmp_path / "older.pt")
    torch.save(payload, old)
    resumed = ckpt_lib.restore_into(_state(cfg, seed=1), old)
    os.remove(old)
    for p in resumed.model.parameters():
        st = resumed.optimizer.state[p]
        assert int(st["step"]) == resumed.updates == 1
    trainer.train_step(resumed, batches[1], cfg)
    for (k, a), (_, b) in zip(ref.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = ref.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert all(int(st["step"]) == resumed.updates == 2 for st in resumed.optimizer.state.values())


def _run_train(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "coponerf_tpu_torch.train", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def test_train_entry_point_runs_on_the_cpu(tmp_path):
    args = ["--device", "cpu", "--dataset", "synthetic", "--experiment_name", "smoke",
            "--logging_root", str(tmp_path), "--batch_size", "1", "--image_size", str(IMG),
            "--query_sparsity", "8", "--max_steps", "2", "--fast", "--compute_dtype", "bfloat16",
            "--pose", "--cycle", "--ssim", "--seed", "3"]
    res = _run_train(args, {"OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stdout + res.stderr
    ckpt = tmp_path / "smoke" / "checkpoints" / "model_final.pt"
    assert ckpt.exists()
    lines = (tmp_path / "smoke" / "summaries" / "metrics.jsonl").read_text().splitlines()
    first = json.loads(lines[0])
    assert first["step"] == 0 and all(k in first for k in ("img_loss", "pose_loss", "grad_norm"))
    payload = torch.load(ckpt, weights_only=True)
    os.remove(ckpt)             # about 1.2 GB
    assert payload["step"] == 2


def test_train_entry_point_needs_cuda_or_device_cpu(tmp_path):
    res = _run_train(["--experiment_name", "x", "--logging_root", str(tmp_path)], {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert not (tmp_path / "x").exists()
