"""host_syncs_per_step: the program's counted waits for the device (``host_syncs``) inside
the ``train_step`` span, per step in the traced slice (rank 0's on a mesh)."""

from portbench.metrics._spans import per_unit


def read(rec):
    return per_unit(rec, ("train_step",), "host_syncs", "train_step")
