"""The least work of a request, counted from the request itself, and the
published peaks it is priced at.

A compression request's least work is memory traffic: its input read
once and its output written once. No operation count is taken, since
any count of compression operations is that of one implementation. The
count is made from the bytes the request takes and returns, not from
the program's tensors, so it reads the same whatever implements it.
"""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def least_bytes(inputs, outputs) -> int:
    """Bytes a request must move at least: every input byte read once,
    every output byte written once."""
    return sum(len(b) for b in inputs) + sum(len(b) for b in outputs)


def hbm_bytes_per_s(kind: str):
    """The published memory bandwidth of the card named `kind` (as
    `torch.cuda.get_device_name()` gives it), or None for a card the
    table lacks: no other card's peak stands in for it."""
    with open(PEAKS) as f:
        card = json.load(f).get(kind)
    return None if card is None else card["hbm_bytes_per_s"]
