"""host_ms_per_image: host time of the ``encode`` and ``render_image`` spans, per image
in the profiled slice (the profiler's own overhead included)."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("encode", "render_image"), "host_ms", "render_image")
