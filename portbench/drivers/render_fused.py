"""Render traffic through a render fusion that the program's model carries.

The traffic, the request, the timed path, the failure checks, the profiled
slice and the comparison are ``render.py``'s (its docstring gives the
parameters).  The one difference: the program's model is built with the
configuration's top-level ``"fusion"`` (``CoPoNeRF(cfg, image_size,
fusion=...)``), so every inference render of the timed path runs through
it.  The plain reference and the fp8 control are built from the same
``model`` keys and never take a fusion.

``make_model``, ``make_renderer``, ``reference_model`` and ``compare`` are
this module's names, looked up when ``run`` is called, so that
``calibrate.py`` plants its control and faults here as it does in
``render.py``.
"""

from __future__ import annotations

from portbench.drivers import render
from portbench.drivers.render import compare, make_renderer, reference_model  # noqa: F401
from portbench.harness import Context, Outcome
from portbench.weights import load_weights

_LOOKED_UP = ("make_model", "make_renderer", "reference_model", "compare")


def make_model(ctx: Context):
    """The program: the port's model at the cell's configuration, carrying
    the configuration's fusion, its weights drawn from the seed."""
    from coponerf_tpu_torch.config import ModelConfig
    from coponerf_tpu_torch.models import CoPoNeRF

    model = CoPoNeRF(ModelConfig(**ctx.config["model"]), image_size=ctx.config["image_size"],
                     fusion=ctx.config["fusion"])
    return load_weights(model, ctx.seed, ctx.device).eval()


def run(ctx: Context) -> Outcome:
    """``render.run`` with this module's ``_LOOKED_UP`` functions in place of
    ``render.py``'s own for the length of the call."""
    saved = {name: getattr(render, name) for name in _LOOKED_UP}
    for name in _LOOKED_UP:
        setattr(render, name, globals()[name])
    try:
        return render.run(ctx)
    finally:
        for name, fn in saved.items():
            setattr(render, name, fn)
