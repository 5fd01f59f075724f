"""render.stage_a_ms: device time (CUDA events) of the render's first sampling stage,
``render.stage_a``, summed over an image's chunks, per image in the profiled slice."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("render.stage_a",), "device_ms", "render_image")
