"""k6_group_fill: the share of K6's value-product row slots that held a ray (the
program's counters ``k6_value_rows`` over ``k6_value_slots`` inside the
``render.core`` spans), in %.  None where the program has no such counters, or
launched no K6."""

from portbench.metrics._spans import summary


def read(rec):
    s = summary(rec)
    core = None if s is None else s["spans"].get("render.core")
    if not core or not core.get("k6_value_slots"):
        return None
    return 100.0 * core["k6_value_rows"] / core["k6_value_slots"]
