"""encode.pose_ms: device time (CUDA events) of the encode's pose span (cross block,
regressors, r6d2mat, cycle masks, flow upsampling), ``encode.pose``, per encode in
the profiled slice."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("encode.pose",), "device_ms", "encode")
