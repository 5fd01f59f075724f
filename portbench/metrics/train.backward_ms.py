"""train.backward_ms: device time (CUDA events) of the train step's backward,
``train.backward``, per step in the traced slice (rank 0's on a mesh)."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("train.backward",), "device_ms", "train_step")
