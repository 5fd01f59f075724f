"""idle_share.train: the share of the profiled window in which no operation ran on the
device, in % (1 - the union of device activity over the window)."""


def read(rec):
    prof = rec.get("profile")
    if prof is None or "pairs" not in rec:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
