"""k2_roofline: K2's bound time over its device time under the profiler, in %.

The bound is the larger of the operations over the bf16 peak and the bytes over
the HBM rate, for the K2 calls of the profiled images (``flops.k2_calls``); the
device time is that of the kernels named ``split_dense_relu_bf16``."""

from portbench import flops
from portbench.metrics._common import peaks

KERNEL = "split_dense_relu_bf16"


def read(rec):
    p, prof = peaks(rec), rec.get("profile")
    if p is None or prof is None:
        return None
    t = sum(s for name, s in prof["kernel_s"].items() if KERNEL in name)
    if t <= 0:
        return None
    model, size, chunk = rec["config"]["model"], rec["config"]["image_size"], rec["traffic"]["chunk"]
    bound = prof["requests"] * flops.k2_bound_s(flops.k2_calls(model, size * size, chunk), p)
    return 100.0 * bound / t
