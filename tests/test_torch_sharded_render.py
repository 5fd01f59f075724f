"""The port's ray-sharded render (``coponerf_tpu_torch/parallel/render.py``)
on gloo ranks on the CPU: the counterpart of ``tests/test_sharded_render.py``.

Each rank renders its slice of one request's query rays in ``chunk``-ray
renders and every rank receives the whole image.  With slices of whole
chunks each chunk is one that a single process renders, so the image is
the single process's bit for bit, over 2 and 4 ranks in the exact config
and over 2 in the fast config (cf[4, 2]).  The single process's image is
held to JAX's single-device render at the exact slice's 1e-4
(``tests/test_torch_slice_exact.py``).
"""

import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from coponerf_tpu.config import ModelConfig as JaxModelConfig
from coponerf_tpu.data.synthetic import make_batch as j_make_batch
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.eval.harness import make_renderer
from coponerf_tpu_torch.models import batch_to_torch
from coponerf_tpu_torch.parallel.mesh import Mesh
from coponerf_tpu_torch.parallel.render import render_ray_sharded
from coponerf_tpu_torch.utils.convert import convert
from torch_dist_helpers import launch, load_model, render_rank

torch.set_num_threads(2)

IMG = 32
CHUNK = 16
BATCH = dict(batch_size=1, image_size=IMG, n_rays=64, seed=0)
EXACT = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
FAST = dict(EXACT, fast_sampling=True, compute_dtype="bfloat16", coarse_samples=4, fine_samples=2)
KEYS = ("rgb", "depth_ray", "at_wt")
# name -> (model, ranks)
RUNS = {"exact-2": (EXACT, 2), "exact-4": (EXACT, 4), "fast-2": (FAST, 2)}


def one_process(cfg_kw, weights):
    """The single process's render of the request, in ``CHUNK``-ray chunks,
    on one thread as each rank (the CPU's sums split by thread)."""
    model = load_model(ModelConfig(**cfg_kw), IMG, weights).eval()
    encode, render_image = make_renderer(model, chunk=CHUNK, keys=KEYS)
    batch = batch_to_torch(j_make_batch(**BATCH)[0], "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {k: v.numpy() for k, v in render_image(batch, encode(batch), BATCH["n_rays"]).items()}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_render")
    batch_np = j_make_batch(**BATCH)[0]
    batch = jax.tree.map(jnp.asarray, batch_np)
    jm = JaxCoPoNeRF(JaxModelConfig(**EXACT))
    variables = fast_init(jm, batch, val=False, train=False)
    weights = str(tmp / "weights.pt")
    torch.save(convert(jax.tree.map(np.asarray, variables)), weights)

    def launch_all():
        return {name: launch(render_rank, world, tmp, ModelConfig(**kw), IMG, weights, BATCH, CHUNK)
                for name, (kw, world) in RUNS.items()}

    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(launch_all)
        state = jm.apply(variables, batch, train=False, method="encode")
        ref = jm.apply(variables, batch, state, val=True, method="render")
        single = {name: one_process(kw, weights) for name, kw in (("exact", EXACT), ("fast", FAST))}
        sharded = launched.result()
    yield {k: np.asarray(ref[k]) for k in KEYS}, single, sharded
    shutil.rmtree(tmp)


@pytest.mark.parametrize("run", list(RUNS))
def test_ray_sharded_render_is_the_single_process_render_bit_for_bit(renders, run):
    _, single, sharded = renders
    want = single[run.split("-")[0]]
    assert len(sharded[run]) == RUNS[run][1]
    for rank_out in sharded[run]:            # the whole image on every rank
        for k in KEYS:
            np.testing.assert_array_equal(rank_out[k], want[k], err_msg=k)


@pytest.mark.parametrize("key", KEYS)
def test_single_process_render_matches_jax_single_device(renders, key):
    ref, single, _ = renders
    np.testing.assert_allclose(single["exact"][key], ref[key], atol=1e-4, rtol=1e-4)


def test_ray_sharded_render_refuses_unequal_slices():
    mesh = Mesh(shape=(3,), axes=("rays",), rank=0, world_size=3, groups={})
    batch = batch_to_torch(j_make_batch(**BATCH)[0], "cpu")
    with pytest.raises(ValueError):
        render_ray_sharded(None, batch, None, mesh, chunk=CHUNK)
