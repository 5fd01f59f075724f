"""setup_s: seconds from process start to the first timed request or step (host clock)."""


def read(rec):
    return rec["setup_s"]
