"""Median-rank + top-k sample-weighted FedAvg + committee election.

Port of `bflc_demo_tpu/core/aggregate.py` — `median_scores` (:38-59),
`rank_desc_stable` (:62-69), `topk_selection_mask` (:72-80), `aggregate`
(:91-113), `apply_selection` (:116-138) and `elect_committee`
(:141-153) — the decision the mesh round takes on the device, which the
ledger re-takes on the recorded scores.  The decision is bit-exact with
the reference's:
- absent committee rows go to +inf before the per-column sort, and the
  median of an even count is the mean of the two middle values;
- the order is score descending with ascending index as the tiebreak,
  from a stable sort; invalid entries take -inf and sort last;
- the top-k mask is `rank < k & valid`.
`apply_selection` is float arithmetic: weights `n_samples * sel` in
float32 with their sum clamped at 1e-12; given the trained models, on
CPU tensors it takes the order of the reference's round program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from bflc_demo_tpu_torch.core.losses import (f32_reciprocal, fma32_,
                                             xla_cpu_order)
from bflc_demo_tpu_torch.models.base import Params


def median_scores(score_matrix: torch.Tensor,
                  scored_mask: torch.Tensor) -> torch.Tensor:
    """(K,) medians over the present rows of a (C, K) score matrix;
    scored_mask (C,) bool marks the rows that arrived."""
    c = score_matrix.shape[0]
    masked = torch.where(scored_mask[:, None], score_matrix,
                         torch.full_like(score_matrix, float("inf")))
    ordered = torch.sort(masked, dim=0).values
    n = scored_mask.to(torch.int32).sum().clamp_min(1)
    idx = torch.arange(c, device=score_matrix.device)[:, None]
    zero = torch.zeros_like(ordered)
    take_lo = torch.where(idx == (n - 1) // 2, ordered, zero).sum(0)
    take_hi = torch.where(idx == n // 2, ordered, zero).sum(0)
    return 0.5 * (take_lo + take_hi)


def rank_desc_stable(scores: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """(K,) permutation: score desc, index asc tiebreak; invalid last."""
    keyed = torch.where(valid, -scores,
                        torch.full_like(scores, float("inf")))
    # -0.0 and 0.0 tie, as in XLA's sort; a radix sort (CUDA) would not
    keyed = torch.where(keyed == 0, torch.zeros_like(keyed), keyed)
    return torch.sort(keyed, stable=True).indices


def _rank_of(order: torch.Tensor) -> torch.Tensor:
    """The inverse permutation: each entry's rank position."""
    return torch.sort(order, stable=True).indices


def topk_selection_mask(scores: torch.Tensor, valid: torch.Tensor,
                        k: int) -> torch.Tensor:
    """(K,) bool mask of the top-k valid entries under the order."""
    return (_rank_of(rank_desc_stable(scores, valid)) < k) & valid


class AggregateResult(NamedTuple):
    params: Params               # new global model
    global_loss: torch.Tensor    # scalar: mean avg_cost of the selected
    medians: torch.Tensor        # (K,) median committee score per update
    selected: torch.Tensor       # (K,) bool — which updates were merged
    order: torch.Tensor          # (K,) permutation, best first


@torch.no_grad()
def apply_selection(global_params: Params, deltas: Params,
                    n_samples: torch.Tensor, sel_mask: torch.Tensor,
                    lr: float, trained: Params = None) -> Params:
    """global -= lr * wmean(selected deltas).  deltas: stacked leading
    axis K; n_samples (K,) int; sel_mask (K,) bool.

    `trained`, the stacked trained models the deltas were made from in
    the same program (the mesh round, `_psum_fedavg_body` in the
    reference's round), lets the merge take the order XLA:CPU compiles
    there (`losses.xla_cpu_order`): the algebraic simplifier folds each
    delta's 1/lr into its weight, so every client adds (global -
    trained) * (w * f32(1/lr)) by one FMA, in slot order; the sum is
    divided by the weights' sum; `global - lr * mean` is one FMA."""
    w = n_samples.to(torch.float32) * sel_mask.to(torch.float32)
    wsum = w.sum().clamp_min(1e-12)
    if trained is not None and xla_cpu_order(w):
        return _folded_merge(global_params, trained, w, wsum, lr)
    out = {}
    for k, g in global_params.items():
        d = deltas[k]
        wb = w.reshape((-1,) + (1,) * (d.ndim - 1)).to(d.dtype)
        mean = (d * wb).sum(0) / wsum.to(d.dtype)
        out[k] = g - lr * mean
    return out


def _folded_merge(global_params: Params, trained: Params, w: torch.Tensor,
                  wsum: torch.Tensor, lr: float) -> Params:
    scaled = w * f32_reciprocal(lr)
    out = {}
    for k, g in global_params.items():
        diff = g[None] - trained[k]
        acc = torch.zeros_like(g)
        for i in range(diff.shape[0]):
            fma32_(acc, diff[i], scaled[i])
        out[k] = fma32_(g.clone(), -lr, acc / wsum)
    return out


def decide(score_matrix: torch.Tensor, scored_mask: torch.Tensor,
           valid: torch.Tensor, avg_costs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """(medians, order, selected, global_loss): the decision both
    `aggregate` and the mesh round take (reference :102-112)."""
    med = median_scores(score_matrix, scored_mask)
    order = rank_desc_stable(med, valid)
    sel = (_rank_of(order) < k) & valid
    sel_f = sel.to(avg_costs.dtype)
    n_sel = sel_f.sum().clamp_min(1.0)
    return med, order, sel, (avg_costs * sel_f).sum() / n_sel


@torch.no_grad()
def aggregate(global_params: Params, deltas: Params,
              n_samples: torch.Tensor, avg_costs: torch.Tensor,
              score_matrix: torch.Tensor, scored_mask: torch.Tensor,
              valid: torch.Tensor, lr: float, k: int) -> AggregateResult:
    """One aggregation step over K stacked updates.  score_matrix (C, K);
    scored_mask (C,) rows present; valid (K,) updates present; k the
    merge count (AGGREGATE_COUNT)."""
    med, order, sel, loss = decide(score_matrix, scored_mask, valid,
                                   avg_costs, k)
    new_params = apply_selection(global_params, deltas, n_samples, sel, lr)
    return AggregateResult(new_params, loss, med, sel, order)


def elect_committee(order: torch.Tensor, valid: torch.Tensor,
                    comm_count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next round's committee: ((comm_count,) slot indices best-first,
    (comm_count,) bool mask of which of them held a real update)."""
    electees = order[:comm_count]
    return electees, valid[electees]
