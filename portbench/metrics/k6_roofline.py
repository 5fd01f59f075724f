"""k6_roofline: K6's bound time over its device time under the profiler, in %.

The bound is the larger of the operations over the bf16 peak and the bytes over
the HBM rate, for the ``render_core`` calls of the profiled images
(``flops_k6.py``); the device time is that of the kernels named
``render_core_kernel``."""

from portbench import flops_k6
from portbench.metrics._common import peaks

KERNEL = "render_core_kernel"


def read(rec):
    p, prof = peaks(rec), rec.get("profile")
    if p is None or prof is None:
        return None
    t = sum(s for name, s in prof["kernel_s"].items() if KERNEL in name)
    if t <= 0:
        return None
    model, size, chunk = rec["config"]["model"], rec["config"]["image_size"], rec["traffic"]["chunk"]
    return 100.0 * prof["requests"] * flops_k6.k6_bound_s(model, size * size, chunk, p) / t
