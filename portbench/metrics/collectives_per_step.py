"""collectives_per_step: the program's all-reduces and broadcasts (``collectives``) inside the
``train_step`` span, per step in the traced slice (rank 0's): BatchNorm's forward and
backward, the losses' normalisers, the gradients and the metrics."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("train_step",), "collectives", "train_step")
