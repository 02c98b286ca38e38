"""The numbers that decide `correct`, and their limits.

Each cell's limits live in `portbench/limits/<cell>.json` as
``{"<number>": {"limit": x, "lower": a, "upper": b, ...}}``: the limit and
the two readings it was set from (PERF.md gives how). A run is correct when
every number is finite and at most its limit."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

LIMITS = Path(__file__).resolve().parent.parent / "limits"
# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by round-off alone: it is left out of the leaf comparisons
DEAD_LEAF = 1e-3


def load_limits(cell: str) -> dict:
    with open(LIMITS / f"{cell}.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limited number; a
    number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def prob_gap(served: np.ndarray, reference: np.ndarray) -> float:
    """Widest gap between served and reference probabilities."""
    return float(np.max(np.abs(np.asarray(served, np.float64)
                               - np.asarray(reference, np.float64))))


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def leaf_gaps(program: dict, reference: dict, ref_grads: dict) -> dict:
    """{leaf: |program norm - reference norm| / max(reference norm, the
    median leaf's reference norm)}, leaves whose reference gradient norm is
    under DEAD_LEAF of the median leaf's left out."""
    med_g = float(np.median(list(ref_grads.values())))
    med = float(np.median(list(reference.values())))
    return {k: abs(program[k] - r) / max(r, med) for k, r in reference.items()
            if ref_grads[k] >= DEAD_LEAF * med_g}


def worst_leaf_gap(program: dict, reference: dict, ref_grads: dict) -> float:
    """The largest of `leaf_gaps`."""
    return max(leaf_gaps(program, reference, ref_grads).values())
