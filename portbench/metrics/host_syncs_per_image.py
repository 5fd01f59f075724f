"""host_syncs_per_image: the program's counted waits for the device (``host_syncs``) inside
the ``encode`` and ``render_image`` spans, per image in the profiled slice."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("encode", "render_image"), "host_syncs", "render_image")
