"""render.attention_ms: device time (CUDA events) of the joint softmax, the second attention
round and the weighted sums (K3), ``render.attention``, summed over an image's chunks,
per image in the profiled slice."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("render.attention",), "device_ms", "render_image")
