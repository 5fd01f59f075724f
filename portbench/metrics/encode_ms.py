"""encode_ms: mean device time of an encode in the traced run's window (CUDA events around
each ``encode`` call)."""


def read(rec):
    ms = rec.get("encode_ms")
    return sum(ms) / len(ms) if ms else None
