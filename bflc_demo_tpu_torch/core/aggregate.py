"""Apply a ledger-decided selection: `global -= lr * wmean(selected deltas)`.

Port of `bflc_demo_tpu/core/aggregate.py:apply_selection` (:116-138).  The
ledger decides which slots merge (medians, order and selection live in
its op log); the compute plane does the tensor math.  Weights are
`n_samples * sel` in float32 with their sum clamped at 1e-12.  The
reference's `median_scores`, `rank_desc_stable`, `aggregate` and
`elect_committee` (the mesh runtime's on-device decision) are still to
port with that runtime (ROADMAP A7); the host round takes those decisions
from the ledger.
"""

from __future__ import annotations

import torch

from bflc_demo_tpu_torch.models.base import Params


@torch.no_grad()
def apply_selection(global_params: Params, deltas: Params,
                    n_samples: torch.Tensor, sel_mask: torch.Tensor,
                    lr: float) -> Params:
    """deltas: stacked leading axis K; n_samples (K,) int; sel_mask (K,)
    bool."""
    w = n_samples.to(torch.float32) * sel_mask.to(torch.float32)
    wsum = w.sum().clamp_min(1e-12)
    out = {}
    for k, g in global_params.items():
        d = deltas[k]
        wb = w.reshape((-1,) + (1,) * (d.ndim - 1)).to(d.dtype)
        mean = (d * wb).sum(0) / wsum.to(d.dtype)
        out[k] = g - lr * mean
    return out
