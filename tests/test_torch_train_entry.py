"""The training loop's validation hook and ``python -m
coponerf_tpu_torch.train`` on real-dataset readers, on the CPU.

``train(val_fn=...)`` calls ``val_fn`` after the rolling ``model_current``
checkpoint at every ``steps_til_summary``-th step.  The entry takes two
steps on a fabricated RealEstate10K archive through the port's readers
and loader, validates on it (``--val_root``), and writes checkpoints and
finite losses and ``val_*`` terms.  What ``make_val_fn`` computes is held
to the JAX package's in ``tests/test_torch_validation.py``.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import torch
from scipy.io import savemat

from coponerf_tpu_torch import config as tconfig
from coponerf_tpu_torch import train as train_entry
from coponerf_tpu_torch.config import Config, ModelConfig, TrainConfig
from coponerf_tpu_torch.data.scene_dataset import SceneDataset, SceneDatasetConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.training import checkpoint as ckpt_lib
from coponerf_tpu_torch.training import trainer

torch.set_num_threads(2)

IMG = 32
CFG_KW = dict(npoints=4, ufc_layer_nums=(1, 1, 1), mask_upsample=IMG)


def test_train_calls_val_fn_every_summary_interval(tmp_path):
    """``train(val_fn=...)`` calls it after the rolling ``model_current``
    checkpoint at every ``steps_til_summary``-th step, with the loop's logger."""
    cfg = Config(model=ModelConfig(**CFG_KW), train=TrainConfig(steps_til_summary=1, epochs_til_ckpt=0,
                                                                 iters_til_ckpt=0),
                 logging_root=str(tmp_path), experiment_name="val")
    state = trainer.create_train_state(cfg, IMG, "cpu")
    seen = []

    def val_fn(st, step, logger):
        assert st is state and hasattr(logger, "log_image")
        assert os.path.exists(tmp_path / "val" / "checkpoints" / "model_current.pt")
        seen.append((step, st.step))

    batches = [make_batch(batch_size=1, image_size=IMG, n_rays=8, seed=s)[0] for s in (1, 2)]
    trainer.train(cfg, batches, num_steps=3, state=state, device="cpu", val_fn=val_fn)
    shutil.rmtree(tmp_path / "val" / "checkpoints")        # about 1.2 GB a file
    assert seen == [(1, 2), (2, 3)]


def _fabricate(root, n_frames=120, hw=(32, 57)):
    img_root = root / "train"
    rng = np.random.RandomState(0)
    tables = {}
    for s in range(2):
        name = f"scene{s:03d}"
        (img_root / name).mkdir(parents=True)
        frames, rows = {}, []
        for i in range(n_frames):
            frames[f"{1000 * i}.png"] = rng.randint(0, 255, (*hw, 3), np.uint8)
            w2c = np.eye(4)
            w2c[0, 3] = 0.0137 * i
            rows.append([1000 * i, 0.9, 0.9, 0.5, 0.5, 0, 0, *w2c[:3].reshape(-1)])
        np.savez(img_root / name / "data.npz", **frames)
        tables[name] = np.array(rows, np.float64)
    savemat(root / "train.mat", tables)
    return str(img_root), str(root / "train.mat")


def test_train_entry_on_a_realestate_archive(tmp_path, monkeypatch):
    """Two steps on a fabricated RealEstate10K archive of 32 x 57 frames
    (32^2 images; the readers' config and the model narrowed by
    monkeypatching, the entry has no such flags) with validation after
    step 1: checkpoints, the loss log and the ``val_*`` terms."""
    img_root, pose_root = _fabricate(tmp_path)

    def small(img_root, pose_root, num_ctxt_views=2, num_query_views=1, query_sparsity=None, augment=True):
        return SceneDataset(SceneDatasetConfig(img_root=img_root, pose_root=pose_root, num_ctxt_views=num_ctxt_views,
                                               num_query_views=num_query_views, query_sparsity=query_sparsity,
                                               augment=augment, image_size=IMG, base_hw=(32, 57), seed=0))

    monkeypatch.setattr(train_entry, "_dataset_class", lambda name: small)
    monkeypatch.setattr(tconfig, "ModelConfig", lambda **kw: ModelConfig(**kw, npoints=4, ufc_layer_nums=(1, 1, 1)))
    argv = ["--device", "cpu", "--dataset", "realestate10k", "--data_root", img_root, "--pose_root", pose_root,
            "--val_root", img_root, "--val_batches", "1", "--experiment_name", "re10k", "--logging_root",
            str(tmp_path / "logs"), "--batch_size", "1", "--query_sparsity", "16", "--max_steps", "2",
            "--steps_til_summary", "1", "--num_workers", "0", "--pose", "--cycle", "--ssim", "--l2_coeff", "0.1",
            "--depth", "--num_epochs", "3"]
    assert train_entry.main(argv) == 0
    run = tmp_path / "logs" / "re10k"
    assert sorted(os.listdir(run / "checkpoints")) == ["model_current.pt", "model_final.pt"]
    logged = [json.loads(line) for line in open(run / "summaries" / "metrics.jsonl")]
    steps = {row["step"]: row for row in logged if "total_train_loss" in row}
    assert sorted(steps) == [0] and np.isfinite(steps[0]["total_train_loss"])
    val = {k: v for row in logged for k, v in row.items() if k.startswith("val_")}
    for term in ("val_img_loss", "val_ssim_loss", "val_cycle_loss", "val_pose_loss", "val_ent"):
        assert np.isfinite(val[term]), term
    ck = torch.load(run / "checkpoints" / "model_final.pt", weights_only=True)
    shutil.rmtree(run / "checkpoints")
    assert ck["step"] == 2 and ck["updates"] + ck["total_notfinite"] == 2


def test_synthetic_pool_cycles_its_first_batches():
    """``synthetic_batches(pool=2)`` yields the seed-1 and seed-2 batches of
    the unpooled stream, then the same two again, bit for bit."""
    pooled = train_entry.synthetic_batches(1, IMG, 8, pool=2)
    got = [next(pooled) for _ in range(4)]
    fresh = train_entry.synthetic_batches(1, IMG, 8)
    want = [next(fresh) for _ in range(2)]
    for g, w in zip(got, want + want):
        for k in w:
            for kk in w[k]:
                np.testing.assert_array_equal(g[k][kk], w[k][kk])
    assert not np.array_equal(got[0]["query"]["rgb"], got[1]["query"]["rgb"])


def test_train_entry_with_a_synthetic_pool(tmp_path, monkeypatch):
    """``--dataset synthetic --synthetic_pool 1`` takes three steps on one
    batch (narrow model by monkeypatching) and logs finite losses."""
    monkeypatch.setattr(tconfig, "ModelConfig", lambda **kw: ModelConfig(**kw, npoints=4, ufc_layer_nums=(1, 1, 1)))
    argv = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_pool", "1", "--image_size", str(IMG),
            "--experiment_name", "pool", "--logging_root", str(tmp_path), "--batch_size", "1",
            "--query_sparsity", "8", "--max_steps", "3", "--steps_til_summary", "100"]
    assert train_entry.main(argv) == 0
    logged = [json.loads(line) for line in open(tmp_path / "pool" / "summaries" / "metrics.jsonl")]
    assert [row["step"] for row in logged] == [0] and np.isfinite(logged[0]["total_train_loss"])
    ck = torch.load(tmp_path / "pool" / "checkpoints" / "model_final.pt", weights_only=True)
    shutil.rmtree(tmp_path / "pool" / "checkpoints")
    assert ck["step"] == 3


def test_metric_logger_writes_pngs_without_tensorboard(tmp_path, monkeypatch):
    """Where ``torch.utils.tensorboard`` does not import, ``log_image``
    writes ``images/<tag>_<step>.png`` holding the bytes TensorBoard would
    keep: the image scaled by 255, clipped and truncated, as
    ``torch.utils.tensorboard.summary.image`` encodes it."""
    import io
    import sys

    from PIL import Image

    img = np.random.RandomState(0).uniform(-0.1, 1.1, (20, 30, 3)).astype(np.float32)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = trainer.MetricLogger(str(tmp_path))
    logger.log(4, {"a": 1.5})
    logger.log_image(4, "val_predictions", img)
    logger.close()
    monkeypatch.undo()
    got = np.asarray(Image.open(tmp_path / "images" / "val_predictions_00000004.png"))
    from torch.utils.tensorboard import summary

    tb = summary.image("t", img, dataformats="HWC").value[0].image.encoded_image_string
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(tb))))
    assert [json.loads(line) for line in open(tmp_path / "metrics.jsonl")] == [{"step": 4, "a": 1.5}]


def _synthetic_argv(tmp_path, name, gpus, batch_size=2):
    return ["--device", "cpu", "--dataset", "synthetic", "--image_size", str(IMG), "--experiment_name", name,
            "--logging_root", str(tmp_path), "--batch_size", str(batch_size), "--query_sparsity", "8",
            "--max_steps", "2", "--steps_til_summary", "100", "--cycle", "--ssim", "--gpus", str(gpus)]


def test_train_entry_on_two_cpu_ranks_is_the_one_rank_run(tmp_path, monkeypatch):
    """``--gpus 2 --device cpu``: two gloo ranks each train on their row of
    every synthetic global batch of 2; rank 0 alone writes the log (one row
    for step 0) and the checkpoints, and the final weights are those of a
    ``--gpus 1`` run on the same global batches: the mean |difference| of
    the parameters is held below 1 % of lr (0.10 %; f32 sums in another
    order, which can flip the sign of Adam's first update where a gradient
    entry is near 0), the BatchNorm statistics to 1e-4 of their largest
    value (3.3e-5).  The two ranks' checkpoint restores into a one-rank
    state, and two ranks resume from the one-rank run's."""
    build = train_entry.build_config

    def narrow(*args):          # the ranks are handed the parent's configuration
        cfg = build(*args)
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, npoints=4, ufc_layer_nums=(1, 1, 1)))

    monkeypatch.setattr(train_entry, "build_config", narrow)
    final = {}
    for gpus in (2, 1):
        name = f"gpus{gpus}"
        assert train_entry.main(_synthetic_argv(tmp_path, name, gpus)) == 0
        logged = [json.loads(line) for line in open(tmp_path / name / "summaries" / "metrics.jsonl")]
        assert [row["step"] for row in logged] == [0] and np.isfinite(logged[0]["total_train_loss"])
        assert sorted(os.listdir(tmp_path / name / "checkpoints")) == ["model_final.pt"]
        final[gpus] = torch.load(tmp_path / name / "checkpoints" / "model_final.pt", weights_only=True)
    assert final[2]["step"] == final[1]["step"] == 2 and final[2]["updates"] == final[1]["updates"] == 2
    assert final[2]["model"].keys() == final[1]["model"].keys()
    assert final[2]["optimizer"]["state"].keys() == final[1]["optimizer"]["state"].keys()
    diff, count = 0.0, 0
    for k, v in final[1]["model"].items():
        got = final[2]["model"][k]
        if "running_" in k:
            assert float((got - v).abs().max()) <= 1e-4 * float(v.abs().max()), k
        elif v.is_floating_point():
            diff += float((got - v).abs().sum())
            count += v.numel()
    lr = TrainConfig().lr
    assert diff / count <= 0.01 * lr, diff / count / lr
    # the checkpoints cross: two ranks' into one state, one rank's into two ranks
    state = trainer.create_train_state(narrow(train_entry.build_parser().parse_args(_synthetic_argv(tmp_path, "x", 1)),
                                              IMG, 0), IMG, "cpu")
    ckpt_lib.restore_into(state, str(tmp_path / "gpus2" / "checkpoints" / "model_final.pt"))
    assert state.step == state.updates == 2
    argv = _synthetic_argv(tmp_path, "resumed", 2) + ["--checkpoint_path",
                                                      str(tmp_path / "gpus1" / "checkpoints" / "model_final.pt")]
    argv[argv.index("--max_steps") + 1] = "1"
    assert train_entry.main(argv) == 0
    resumed = torch.load(tmp_path / "resumed" / "checkpoints" / "model_final.pt", weights_only=True)
    for name in ("gpus2", "gpus1", "resumed"):
        shutil.rmtree(tmp_path / name / "checkpoints")
    assert resumed["step"] == resumed["updates"] == 3


def test_train_entry_resumes_from_a_jax_npz(tmp_path, monkeypatch):
    """``--checkpoint_path X.npz``, a JAX checkpoint (written here by
    ``utils/jax_checkpoint.py:save`` from a state with seeded Adam moments,
    step 12, count 7, 2 and 5 steps skipped), resumes the run whole: one
    step later the counters are step 13, updates 8, none skipped in a row,
    5 in all; every parameter's Adam step is 8, and the update took the
    learning rate of count 7 (epoch 2 of 3-step epochs: lr x 0.95^2)."""
    from coponerf_tpu_torch.utils import jax_checkpoint

    monkeypatch.setattr(tconfig, "ModelConfig", lambda **kw: ModelConfig(**kw, npoints=4, ufc_layer_nums=(1, 1, 1)))
    argv = _synthetic_argv(tmp_path, "npz", 1, batch_size=1)
    argv[argv.index("--max_steps") + 1] = "1"
    argv[argv.index("--steps_til_summary") + 1] = "3"          # synthetic data: 3-step epochs
    cfg = train_entry.build_config(train_entry.build_parser().parse_args(argv), IMG, 0)
    src = trainer.create_train_state(cfg, IMG, "cpu")
    gen = torch.Generator().manual_seed(0)
    for p in src.model.parameters():
        mu = 1e-4 * torch.randn(p.shape, generator=gen)
        src.optimizer.state[p] = {"step": torch.tensor(7.0), "exp_avg": mu, "exp_avg_sq": mu * mu + 1e-8}
    src.step, src.updates, src.notfinite_count, src.total_notfinite = 12, 7, 2, 5
    npz = jax_checkpoint.save(str(tmp_path / "jax"), src, step=12)
    try:
        assert train_entry.main(argv + ["--checkpoint_path", npz]) == 0
    finally:
        os.remove(npz)
    ck = torch.load(tmp_path / "npz" / "checkpoints" / "model_final.pt", weights_only=True)
    assert (ck["step"], ck["updates"], ck["notfinite_count"], ck["total_notfinite"]) == (13, 8, 0, 5)
    assert {float(st["step"]) for st in ck["optimizer"]["state"].values()} == {8.0}
    assert len(ck["optimizer"]["state"]) == len(list(src.model.parameters()))
    assert ck["optimizer"]["param_groups"][0]["lr"] == trainer.learning_rate(cfg, 7) == cfg.train.lr * 0.95 ** 2
    shutil.rmtree(tmp_path / "npz")         # about 1.2 GB


def test_train_entry_with_flat_opt_and_ufc_scan(tmp_path, monkeypatch):
    """``--flat_opt --ufc_scan``: two steps with Adam over one vector, the
    checkpoints written as the JAX package's ``.npz`` in the ``ufc_scan`` +
    ``flat_optimizer`` layout (7 optimizer leaves, the flat moments one
    vector each, stacked UFC layers).  JAX's own ``restore_into`` takes the
    entry's ``model_final.npz`` into a JAX state of that configuration
    (its trees' structure, the counts, and every weight, unstacked by JAX's
    ``unstack_ufc_params``, bit for bit the port's read of the file), and
    a run resumed from the file takes one more step."""
    import jax

    from coponerf_tpu.config import Config as JConfig
    from coponerf_tpu.config import ModelConfig as JModelConfig
    from coponerf_tpu.config import TrainConfig as JTrainConfig
    from coponerf_tpu.models.ufc import stack_ufc_params, unstack_ufc_params
    from coponerf_tpu.training import checkpoint as jckpt
    from coponerf_tpu.training.trainer import TrainState, make_optimizer
    from coponerf_tpu_torch.utils import jax_checkpoint
    from coponerf_tpu_torch.utils.convert import flax_path, to_flax
    from torch_step_helpers import leaf, to_flax_layout

    layers = (2, 1, 1)
    monkeypatch.setattr(tconfig, "ModelConfig", lambda **kw: ModelConfig(**kw, npoints=4, ufc_layer_nums=layers))
    argv = _synthetic_argv(tmp_path, "flat", 1, batch_size=1) + ["--flat_opt", "--ufc_scan"]
    assert train_entry.main(argv) == 0
    assert sorted(os.listdir(tmp_path / "flat" / "checkpoints")) == ["model_final.npz"]
    npz = str(tmp_path / "flat" / "checkpoints" / "model_final.npz")
    cfg = train_entry.build_config(train_entry.build_parser().parse_args(argv), IMG, 0)
    assert cfg.train.flat_optimizer and cfg.model.ufc_scan
    try:
        port = ckpt_lib.restore_into(trainer.create_train_state(cfg, IMG, "cpu"), npz)
        n_values = port.flat.param.numel()
        with np.load(npz) as data:
            opt_keys = [k for k in data.files if k.startswith("__opt__/")]
            assert len(opt_keys) == 7 and data["__opt__/00004"].shape == (n_values,)
            assert "params/feature_cost_aggregation/layers_0/layer/q_proj/Dense_0/kernel" in data.files
            assert not any("layers_0_0" in k for k in data.files)
        # a JAX state of the configuration, its structure from the port's model
        variables = {}
        for key, t in port.model.state_dict().items():
            path, arr = to_flax(key, t.numpy())
            node = variables
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = arr
        params = {**variables["params"], "feature_cost_aggregation": stack_ufc_params(
            variables["params"]["feature_cost_aggregation"], layers)}
        jcfg = JConfig(model=JModelConfig(npoints=4, ufc_layer_nums=layers, ufc_scan=True),
                       train=JTrainConfig(flat_optimizer=True))
        target = TrainState.create(apply_fn=None, params=params, batch_stats=variables["batch_stats"],
                                   tx=make_optimizer(jcfg, steps_per_epoch=100))
        got = jckpt.restore_into(target, npz)
        assert jax.tree_util.tree_structure(got.params) == jax.tree_util.tree_structure(target.params)
        assert jax.tree_util.tree_structure(got.opt_state) == jax.tree_util.tree_structure(target.opt_state)
        assert int(got.step) == port.step == port.updates == 2
        assert int(got.opt_state.inner_state[1][0].count) == 2
        restored = {"params": dict(jax.device_get(got.params)), "batch_stats": jax.device_get(got.batch_stats)}
        restored["params"]["feature_cost_aggregation"] = unstack_ufc_params(
            restored["params"]["feature_cost_aggregation"], layers)
        for key, t in port.model.state_dict().items():
            path, _ = flax_path(key, tuple(t.shape))
            np.testing.assert_array_equal(to_flax_layout(key, t.numpy()), leaf(restored, path), err_msg=key)
        del got, target, restored, variables, params, port
        argv = _synthetic_argv(tmp_path, "resumed", 1, batch_size=1) + ["--flat_opt", "--ufc_scan",
                                                                         "--checkpoint_path", npz]
        argv[argv.index("--max_steps") + 1] = "1"
        assert train_entry.main(argv) == 0
    finally:
        shutil.rmtree(tmp_path / "flat")        # each file about 1.2 GB: one on the disk at a time
    resumed = jax_checkpoint.restore_into(trainer.create_train_state(cfg, IMG, "cpu"),
                                          str(tmp_path / "resumed" / "checkpoints" / "model_final.npz"))
    shutil.rmtree(tmp_path / "resumed")
    assert resumed.step == resumed.updates == 3


def test_train_entry_refuses_more_ranks_than_cards_or_an_uneven_batch(tmp_path, monkeypatch):
    """``--gpus`` above the visible card count, or a global batch that does
    not divide by it, exits 2 before any rank starts."""
    assert train_entry.main(_synthetic_argv(tmp_path, "uneven", 2, batch_size=3)) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = _synthetic_argv(tmp_path, "cards", 2)
    argv[argv.index("--device") + 1] = "cuda"
    assert train_entry.main(argv) == 2
    assert not os.path.exists(tmp_path / "uneven") and not os.path.exists(tmp_path / "cards")
