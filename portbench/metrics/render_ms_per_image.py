"""render_ms_per_image: mean device time of a ``render_image`` call in the traced run's
window (CUDA events around each call)."""


def read(rec):
    ms = rec.get("render_ms")
    return sum(ms) / len(ms) if ms else None
