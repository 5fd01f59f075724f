"""encode_graph_share: the share of the profiled slice's encodes that replayed the
program's CUDA graphs (its counter ``encode_graph_replays`` inside the ``encode`` spans,
over the spans' calls), in %.  None where the program's tracer has no such counter."""

from portbench.metrics._spans import summary


def read(rec):
    s = summary(rec)
    enc = None if s is None else s["spans"].get("encode")
    if not enc or not enc["calls"] or "encode_graph_replays" not in enc:
        return None
    return 100.0 * enc["encode_graph_replays"] / enc["calls"]
