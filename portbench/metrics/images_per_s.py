"""images_per_s: whole images completed in the window over its seconds (host clock)."""


def read(rec):
    if "images" not in rec:
        return None
    return rec["images"] / rec["window_s"]
