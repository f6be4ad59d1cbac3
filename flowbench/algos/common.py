"""Arithmetic that the checks of every algorithm share."""

from __future__ import annotations

import math

import numpy as np


def worst(a: float, b: float) -> float:
    """The larger of two readings, a NaN reading as infinity (so that a
    non-finite answer can never compare as good)."""
    a, b = (x if math.isfinite(x) else math.inf for x in (a, b))
    return max(a, b)


def field_gaps(out: dict, got, want) -> None:
    """Fold the gaps between the program's (u, v, m) and the reference's
    into ``out``: ``flow_gap_px`` the largest |u| or |v| difference,
    ``lum_gap`` the largest |m| difference, ``field_rel`` the largest
    relative L2 gap of one field."""
    diffs = [np.asarray(g, np.float64) - np.asarray(w, np.float64)
             for g, w in zip(got, want)]
    out["flow_gap_px"] = worst(out["flow_gap_px"], float(max(
        np.max(np.abs(diffs[0])), np.max(np.abs(diffs[1])))))
    out["lum_gap"] = worst(out["lum_gap"], float(np.max(np.abs(diffs[2]))))
    for d, w in zip(diffs, want):
        rel = float(np.linalg.norm(d) / max(np.linalg.norm(w), 1e-300))
        out["field_rel"] = worst(out["field_rel"], rel)
