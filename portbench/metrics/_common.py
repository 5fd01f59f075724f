"""Helpers the metric readers share: the card's peaks and the model FLOPs
of a run's work."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from portbench import flops

_PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks.json")


def peaks(rec: Dict) -> Optional[Dict[str, float]]:
    """The peaks of the run's card, or None (no card, or one not in the table)."""
    dev = rec["device"]
    if dev.type != "cuda":
        return None
    import torch

    with open(_PEAKS) as f:
        return json.load(f).get(torch.cuda.get_device_name(dev))


def render_request_flops(rec: Dict, encodes: int, images: int) -> int:
    model, size, chunk = rec["config"]["model"], rec["config"]["image_size"], rec["traffic"]["chunk"]
    return encodes * flops.encode_flops(model, size) + images * flops.render_flops(model, size * size, chunk)
