"""Committee scoring of the collected candidate updates.

Port of `bflc_demo_tpu/core/scoring.py:score_candidates` (:28-46): each
candidate model is `global - lr * delta_k`, scored by its accuracy on the
committee member's own shard.  The reference `vmap`s the model over the
stacked candidate axis; `torch.func.vmap` cannot batch through the flash
kernels' ctypes calls (they have no batching rule), so the candidate axis
is written out as a loop — one forward per candidate.
"""

from __future__ import annotations

import torch

from bflc_demo_tpu_torch.core.losses import accuracy
from bflc_demo_tpu_torch.models.base import Model, Params


@torch.no_grad()
def score_candidates(model: Model, global_params: Params, deltas: Params,
                     lr: float, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """(K,) accuracies; `deltas` carries a stacked leading axis K."""
    n_cand = next(iter(deltas.values())).shape[0]
    scores = []
    for i in range(n_cand):
        candidate = {k: g - lr * deltas[k][i]
                     for k, g in global_params.items()}
        scores.append(accuracy(model.apply(candidate, x), y))
    return torch.stack(scores)
