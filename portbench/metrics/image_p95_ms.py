"""image_p95_ms: 95th percentile of every request's latency in the window, from its start
to its rgb on the host, in ms (host clock; linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    if "images" not in rec or not rec["latencies_s"]:
        return None
    return float(np.percentile(np.asarray(rec["latencies_s"]) * 1e3, 95))
