"""encode.backbone_ms: device time (CUDA events) of the encode's ResNet-34 and conv_map span,
``encode.backbone``, per encode in the profiled slice."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("encode.backbone",), "device_ms", "encode")
