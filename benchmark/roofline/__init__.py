"""The yardstick of the device metrics: the cards' published peaks
(peaks.json) and the bytes each kernel call must move (ntt.py)."""

from __future__ import annotations

import json
from pathlib import Path


def peaks(kind: str) -> dict | None:
    """Published peaks of the card named `kind` (torch.cuda.
    get_device_name), or None for a card the table lacks."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    return table.get(kind)
