"""render.stage_b_ms: device time (CUDA events) of the render's fine stage with its argmax,
``render.stage_b``, summed over an image's chunks, per image in the profiled slice."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("render.stage_b",), "device_ms", "render_image")
