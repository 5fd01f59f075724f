"""train.update_ms: device time (CUDA events) of the train step's norm, finite check, clip
and Adam step, ``train.update``, per step in the traced slice (rank 0's on a
mesh)."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("train.update",), "device_ms", "train_step")
