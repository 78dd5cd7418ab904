"""What the per-layer metrics' readers share: the table of peaks and the
window's steps as the runner recorded them (``(start, loaded, returned,
synchronised, traced)`` host times per step)."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1]
                    / "peaks.json").read_text())


def peak(run, key: str):
    """The card's peak ``key``, or None for a card not in the table."""
    return PEAKS.get(run.device_name, {}).get(key)


def untraced(run) -> list:
    """The window's steps that ran without the profiler."""
    return [s for s in run.spans if not s[4]]
