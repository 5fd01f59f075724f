"""render.decode_ms: device time (CUDA events) of the light-field decoder phi and the
whitening, ``render.decode``, summed over an image's chunks, per image in the profiled
slice."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("render.decode",), "device_ms", "render_image")
