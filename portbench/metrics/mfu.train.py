"""mfu.train: model FLOPs of the window's steps (three times the forward with its
losses, ``flops.py``) over the window's seconds and the bf16 dense peak, in %."""

from portbench import flops
from portbench.metrics._common import peaks


def read(rec):
    p = peaks(rec)
    if p is None or "pairs" not in rec:
        return None
    c, tr = rec["config"], rec["traffic"]
    step = flops.train_flops(c["model"], c["loss"], c["image_size"], tr["batch"], tr["rays"])
    return 100.0 * step * (rec["pairs"] / tr["batch"]) / rec["window_s"] / p["bf16_flops_per_s"]
