"""launches_per_image: device kernel launches in the profiled window over its images."""


def read(rec):
    prof = rec.get("profile")
    if prof is None or "images" not in rec:
        return None
    return prof["launches"] / prof["requests"]
