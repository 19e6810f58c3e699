"""Frozen arithmetic of the rooflines: the card's peaks (``bench/peaks.json``
by the name ``torch.cuda.get_device_name`` gives) and the least bytes of
an Anderson round.

``taa_round_bytes`` is the fused count of the program's
``roofline/analysis.py::taa_round_traffic`` as it stood when the benchmark
was written, copied so that a later change to the program cannot move the
yardstick: the Gram pass reads dF and R, the apply pass reads dX, dF, x
and R and writes the (T, D) output, each (m, T, D) history and (T, D)
sheet once, for each lane.  The staged round moves more (its Gram blocks
and gammas through memory); the least the round needs is the fused count.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def peaks(kind: str) -> Optional[dict]:
    """The card's peaks, or None for a card the table does not hold."""
    return json.loads(PEAKS.read_text()).get(kind)


def taa_round_bytes(lanes: int, T: int, D: int, m: int,
                    itemsize: int = 4) -> int:
    sheet = T * D * itemsize
    history = m * sheet
    return lanes * ((history + sheet) + (2 * history + 3 * sheet))
