"""train.allreduce_ms: device time (CUDA events) of the mesh step's gradient all-reduce,
``train.allreduce``, per step in the traced slice (rank 0's): NCCL's reduction and the
wait for the slowest rank to reach it."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("train.allreduce",), "device_ms", "train_step")
