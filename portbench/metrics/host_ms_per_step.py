"""host_ms_per_step: host time of the ``train_step`` span per step in the traced slice
(on one card the profiler's own overhead included; on a mesh rank 0's, with no profiler)."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("train_step",), "host_ms", "train_step")
