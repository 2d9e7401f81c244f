"""The one fixed decision rule of the closed compression loop.

Copy of `bflc_demo_tpu/control/loop.py` (:1-117), bit for bit.  Every
function is a pure map over IEEE float32 / int64 values: the writer
computes it once to propose a genome-update op, and every replica
recomputes it inside `PyLedger.apply_op` to accept or refuse that op, so
two honest hosts can never disagree.

It stays numpy on the host, on purpose: `score_disagreement` takes
`np.percentile` in float64 and `model_telemetry` sums with `np.sum`'s
pairwise order in float64, each rounded once to float32 at the end.  A
reduction on the card would sum in another order, and the genome op's
bytes would differ from the reference's.  The writer's model flats
reach `model_telemetry` as host numpy arrays.

Telemetry: ``disagreement`` (the mean per-candidate inter-quartile range
of the committee's score rows, re-derived by every replica from the
certified score ops); ``update_norm`` / ``drift`` (the L2 of the
committed step and its size relative to the model: the writer's claims,
which replicas check for finiteness and the rederive plane holds to the
committed bytes).  ``decide`` moves the knobs on a x2 ladder, clamped
to the genome's bounds.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# rule thresholds (protocol law: changing one is a protocol change)
DISAGREE_HIGH = np.float32(0.25)   # committee conflict: back off
DISAGREE_LOW = np.float32(0.05)    # committee consensus: compress more
DRIFT_HIGH = np.float32(2.0)       # step >> model: training unstable


def score_disagreement(rows: Sequence[Sequence[float]]) -> np.float32:
    """Mean per-candidate inter-quartile range over the committee's
    score rows (f64 percentiles, one f32 round at the end); empty or
    ragged input scores 0.0."""
    if not rows:
        return np.float32(0.0)
    k = len(rows[0])
    if k == 0 or any(len(r) != k for r in rows):
        return np.float32(0.0)
    a = np.asarray([[float(s) for s in r] for r in rows], np.float64)
    q75, q25 = np.percentile(a, [75.0, 25.0], axis=0)
    return np.float32(np.mean(q75 - q25))


def model_telemetry(old_flat, new_flat) -> Tuple[np.float32, np.float32]:
    """(update_norm, drift) of a committed step: ||new - old||_2 and
    that over ||old||_2 + 1e-12, accumulated in f64 over the float leaves
    in sorted key order, one f32 round each."""
    sq_step = 0.0
    sq_old = 0.0
    for key in sorted(new_flat.keys()):
        n = np.asarray(new_flat[key])
        if not np.issubdtype(n.dtype, np.floating):
            continue
        o = np.asarray(old_flat[key], np.float64)
        d = np.asarray(n, np.float64) - o
        sq_step += float(np.sum(d * d))
        sq_old += float(np.sum(o * o))
    norm = np.float32(np.sqrt(sq_step))
    drift = np.float32(np.sqrt(sq_step) / (np.sqrt(sq_old) + 1e-12))
    return norm, drift


def decide(eff_density: float, eff_staleness: int,
           update_norm: float, drift: float, disagreement: float, *,
           density_floor: float, density_cap: float,
           staleness_cap: int) -> Tuple[np.float32, int]:
    """(new_density, new_staleness) from the effective knobs and one
    round's telemetry.

    - Unhealthy (non-finite telemetry, disagreement above DISAGREE_HIGH
      or drift above DRIFT_HIGH): density doubles toward the cap,
      staleness halves toward 1.
    - Converging (disagreement below DISAGREE_LOW): density halves
      toward the floor, staleness doubles toward the cap.
    - Otherwise: hold.

    Density moves on an f32 ladder clamped to [density_floor,
    density_cap]; staleness is exact integer arithmetic in [1,
    staleness_cap], and staleness_cap <= 0 (sync) leaves it alone."""
    d = np.float32(eff_density)
    s = int(eff_staleness)
    floor = np.float32(density_floor)
    cap = np.float32(density_cap)
    unhealthy = (not np.isfinite(np.float32(update_norm))
                 or not np.isfinite(np.float32(drift))
                 or not np.isfinite(np.float32(disagreement))
                 or np.float32(disagreement) > DISAGREE_HIGH
                 or np.float32(drift) > DRIFT_HIGH)
    if unhealthy:
        d = np.float32(min(np.float32(d * np.float32(2.0)), cap))
        if staleness_cap > 0:
            s = max(s // 2, 1)
    elif np.float32(disagreement) < DISAGREE_LOW:
        d = np.float32(max(np.float32(d * np.float32(0.5)), floor))
        if staleness_cap > 0:
            s = min(max(s * 2, 1), int(staleness_cap))
    return np.float32(d), int(s)
