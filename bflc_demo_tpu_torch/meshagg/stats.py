"""Batched per-delta statistics — the health plane's arithmetic.

Port of `bflc_demo_tpu/meshagg/stats.py`: one pass over the round's
stacked ``(N, P)`` delta matrix (the engine's `flatten_delta` rows)
gives every per-delta statistic the health plane reads:

- ``l2``        — L2 norm of the delta (nonfinite entries read as 0);
- ``max_abs``   — largest finite magnitude;
- ``nonfinite`` — NaN/Inf entry count;
- ``zero_frac`` — fraction of exactly-zero entries;
- ``cos_ref``   — cosine against a reference row (last round's aggregate
  direction).

``per_leaf_stats`` gives L2 and cosine per (delta, leaf);
``weighted_mean_row`` the next round's reference row.

The host leg is the reference's numpy, unchanged.  The reference's opt-in
jitted leg (``BFLC_HEALTH_STATS_JIT=1``, batches >= the engine's
``BFLC_MESH_AGG_MIN``) is plain float32 torch on `device` (None: `cuda`);
where it fails it RAISES, where the reference latched itself off and fell
back to numpy (:26-33, :138-140).  Nothing here is certified or hashed,
so no kernel: float32 on the device against float64 on the host differs
in the last digits only.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from bflc_demo_tpu_torch.device import DeviceLike, resolve_device

_EPS = 1e-12
_KEYS = ("l2", "max_abs", "nonfinite", "zero_frac", "cos_ref")


def _device_min_batch() -> int:
    """Smallest batch routed to the device leg — opt-in via
    BFLC_HEALTH_STATS_JIT=1, then the engine's min-batch and legacy pin."""
    if not os.environ.get("BFLC_HEALTH_STATS_JIT"):
        return 1 << 62
    from bflc_demo_tpu_torch.meshagg.engine import _legacy, _min_batch
    return 1 << 62 if _legacy() else _min_batch()


def _host_stats(mat: np.ndarray,
                ref: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    a = np.asarray(mat, np.float32)
    n, p = a.shape
    finite = np.isfinite(a)
    clean = np.where(finite, a, np.float32(0.0)).astype(np.float64)
    l2 = np.sqrt(np.einsum("np,np->n", clean, clean))
    max_abs = (np.abs(clean).max(axis=1) if p else np.zeros(n))
    nonfinite = (~finite).sum(axis=1).astype(np.float64)
    zero_frac = ((a == 0.0).sum(axis=1) / p if p
                 else np.ones(n)).astype(np.float64)
    if ref is None or p == 0:
        cos = np.zeros(n)
    else:
        r = np.where(np.isfinite(ref), ref, 0.0).astype(np.float64)
        rn = float(np.sqrt(r @ r))
        denom = np.maximum(l2 * rn, _EPS)
        cos = np.clip((clean @ r) / denom, -1.0, 1.0)
        if rn <= _EPS:
            cos[:] = 0.0
    return {"l2": l2, "max_abs": max_abs, "nonfinite": nonfinite,
            "zero_frac": zero_frac, "cos_ref": cos}


def _device_stats(mat: np.ndarray, ref: Optional[np.ndarray],
                  device: torch.device) -> Dict[str, np.ndarray]:
    """The reference's jitted `stats_fn` (:91-104) in float32 torch."""
    m = torch.as_tensor(mat, device=device)
    finite = torch.isfinite(m)
    clean = torch.where(finite, m, torch.zeros((), device=device))
    l2 = torch.sqrt((clean * clean).sum(1))
    max_abs = clean.abs().amax(1)
    nonfinite = (~finite).sum(1).to(torch.float32)
    zero_frac = (m == 0.0).to(torch.float32).mean(1)
    if ref is None:
        cos = torch.zeros_like(l2)
    else:
        r = torch.as_tensor(np.asarray(ref, np.float32), device=device)
        r = torch.where(torch.isfinite(r), r, torch.zeros((), device=device))
        rn = torch.sqrt(r @ r)
        cos = torch.clamp((clean @ r) / torch.clamp(l2 * rn, min=_EPS),
                          -1.0, 1.0)
        if float(rn) <= _EPS:
            cos = torch.zeros_like(l2)
    return {k: v.cpu().numpy().astype(np.float64) for k, v in
            zip(_KEYS, (l2, max_abs, nonfinite, zero_frac, cos))}


def batch_delta_stats(mat: np.ndarray,
                      ref: Optional[np.ndarray] = None,
                      device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """All per-delta stats for a stacked ``(N, P)`` float32 delta matrix
    in one batched pass.  ``ref`` is the cosine reference row (``(P,)``)
    or None (cos_ref = 0).  Returns ``(N,)`` float64 arrays keyed l2 /
    max_abs / nonfinite / zero_frac / cos_ref.  `device` is the opt-in
    device leg's (see the module docstring)."""
    mat = np.asarray(mat, np.float32)
    if mat.ndim != 2:
        raise ValueError(f"expected an (N, P) matrix, got {mat.shape}")
    n, p = mat.shape
    if n == 0:
        z = np.zeros(0)
        return {k: z for k in _KEYS}
    if n >= _device_min_batch() and p:
        return _device_stats(mat, ref, resolve_device(device))
    return _host_stats(mat, ref)


def per_leaf_stats(mat: np.ndarray, layout,
                   ref: Optional[np.ndarray] = None
                   ) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-(delta, LEAF) L2 and cosine-vs-reference.  ``layout`` is
    engine._leaf_layout's ``[(key, offset, size, ...)]``; returns
    ``{key: {"l2": (N,), "cos": (N,)}}``."""
    a = np.asarray(mat, np.float32)
    n = a.shape[0]
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for entry in layout:
        key, off, size = entry[0], int(entry[1]), int(entry[2])
        seg = a[:, off:off + size]
        clean = np.where(np.isfinite(seg), seg,
                         np.float32(0.0)).astype(np.float64)
        l2 = (np.sqrt(np.einsum("np,np->n", clean, clean))
              if size else np.zeros(n))
        if ref is None or size == 0:
            cos = np.zeros(n)
        else:
            r = np.asarray(ref[off:off + size], np.float64)
            r = np.where(np.isfinite(r), r, 0.0)
            rn = float(np.sqrt(r @ r))
            denom = np.maximum(l2 * rn, _EPS)
            cos = np.clip((clean @ r) / denom, -1.0, 1.0)
            if rn <= _EPS:
                cos = np.zeros(n)
        out[key] = {"l2": l2, "cos": cos}
    return out


def weighted_mean_row(mat: np.ndarray, weights, selected) -> np.ndarray:
    """The round's aggregate-direction row: the weighted mean of the
    SELECTED rows (float64, observability only).  The next round's
    ``cos_ref``."""
    mat = np.asarray(mat, np.float64)
    n, p = mat.shape
    w = np.zeros(n)
    for s in selected:
        w[int(s)] = float(weights[int(s)])
    tot = w.sum()
    if tot <= 0 or p == 0:
        return np.zeros(p)
    return (w / tot) @ np.where(np.isfinite(mat), mat, 0.0)
