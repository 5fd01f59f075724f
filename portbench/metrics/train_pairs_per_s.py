"""train_pairs_per_s: pairs in the steps completed in the window over its seconds (host clock)."""


def read(rec):
    if "pairs" not in rec:
        return None
    return rec["pairs"] / rec["window_s"]
