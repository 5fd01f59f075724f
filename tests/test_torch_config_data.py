"""The port's own configuration dataclasses and synthetic batches equal the
JAX package's: each field the port keeps has the JAX field's name and
default, and ``make_batch`` gives the same arrays for the same arguments."""

import dataclasses

import numpy as np
import pytest

from coponerf_tpu import config as jconfig
from coponerf_tpu.data.synthetic import make_batch as j_make_batch
from coponerf_tpu_torch import config as tconfig
from coponerf_tpu_torch.data.synthetic import make_batch


@pytest.mark.parametrize("name", ["ModelConfig", "LossConfig", "TrainConfig"])
def test_config_fields_and_defaults_match_jax(name):
    port, ref = getattr(tconfig, name), getattr(jconfig, name)
    jf = {f.name: f.default for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        assert f.name in jf and f.default == jf[f.name], f.name
    kept = dataclasses.asdict(port())
    assert kept == {k: v for k, v in dataclasses.asdict(ref()).items() if k in kept}


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, image_size=32, n_rays=16, seed=0),
    dict(batch_size=3, image_size=24, n_rays=7, seed=5, baseline=0.5, plane_z=2.0),
    dict(batch_size=1, image_size=16, seed=2, full_query_image=True),
])
def test_make_batch_matches_jax(kw):
    got, got_gt = make_batch(**kw)
    ref, ref_gt = j_make_batch(**kw)
    for part in ("context", "query"):
        assert got[part].keys() == ref[part].keys()
        for k in ref[part]:
            assert got[part][k].dtype == ref[part][k].dtype, (part, k)
            np.testing.assert_array_equal(got[part][k], ref[part][k], err_msg=f"{part}/{k}")
    assert got_gt.keys() == ref_gt.keys()


def test_formulation_fields_build_with_jax_names_and_defaults():
    """The train step's four formulations: ``conv4d_impl``, ``remat_policy``
    and ``ufc_scan`` on ``ModelConfig``, ``flat_optimizer`` on
    ``TrainConfig``, each with the JAX field's default; each non-default
    value builds, and a value outside the two a field takes raises."""
    for cls, names in (("ModelConfig", ("conv4d_impl", "remat_policy", "ufc_scan")),
                       ("TrainConfig", ("flat_optimizer",))):
        port = {f.name: f.default for f in dataclasses.fields(getattr(tconfig, cls))}
        ref = {f.name: f.default for f in dataclasses.fields(getattr(jconfig, cls))}
        for name in names:
            assert name in port and port[name] == ref[name], (cls, name)
    assert tconfig.ModelConfig(conv4d_impl="3d").conv4d_impl == "3d"
    assert tconfig.ModelConfig(remat_policy="dots").remat_policy == "dots"
    assert tconfig.ModelConfig(ufc_scan=True).ufc_scan
    assert tconfig.TrainConfig(flat_optimizer=True).flat_optimizer
    with pytest.raises(ValueError, match="conv4d_impl"):
        tconfig.ModelConfig(conv4d_impl="3D")
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(tconfig.ModelConfig(), remat_policy="nothing")
