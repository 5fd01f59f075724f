"""encode.ufc_ms: device time (CUDA events) of the encode's UFC span (the correlation
aggregation and its flows), ``encode.ufc``, per encode in the profiled slice."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("encode.ufc",), "device_ms", "encode")
