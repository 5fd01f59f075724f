"""mfu.render: model FLOPs of the window's requests (encodes and images, ``flops.py``)
over the window's seconds and the bf16 dense peak, in %."""

from portbench.metrics._common import peaks, render_request_flops


def read(rec):
    p = peaks(rec)
    if p is None or "images" not in rec:
        return None
    work = render_request_flops(rec, rec["encodes"], rec["images"])
    return 100.0 * work / rec["window_s"] / p["bf16_flops_per_s"]
