"""launches_per_step: device kernel launches in the profiled window over its steps."""


def read(rec):
    prof = rec.get("profile")
    if prof is None or "pairs" not in rec:
        return None
    return prof["launches"] / prof["steps"]
