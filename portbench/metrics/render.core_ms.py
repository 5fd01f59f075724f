"""render.core_ms: device time (CUDA events) of K6, the fused render core (``render.core``,
inside ``render.attention``), summed over an image's chunks, per image in the profiled
slice; None where the program has no such span."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("render.core",), "device_ms", "render_image")
