"""Local SGD on one client shard, and held-out accuracy.

Port of `bflc_demo_tpu/core/local_train.py` (`local_train_impl` :40-99,
`_evaluate_impl`).  Same semantics:
- floor(n / batch_size) minibatches per epoch, the remainder dropped;
- plain SGD, `p -= lr * g`, for `local_epochs` passes;
- returns `delta = (p_in - p_out) / lr` (the wire format, so the
  coordinator's `global -= lr * wmean(delta)` is exact FedAvg) and
  `avg_cost`, the mean of the per-epoch mean minibatch losses.

The reference compiles the whole loop into one XLA program (`lax.scan`);
PyTorch runs it eagerly, one autograd step per minibatch, updating the
working copy in place under `no_grad`.  Only `optimizer=None` (the
reference's plain SGD) is ported; any other optimizer raises.

`local_train_stacked` is the one SGD loop, the counterpart of
`vmap(local_train_impl)` (`bflc_demo_tpu/parallel/fedavg.py:360-381`):
all N clients step in lockstep, one autograd step per minibatch for all
of them through `Model.apply_stacked`; `local_train` is that loop at
N = 1.  The loss is the sum over models
of each model's mean cross-entropy; the models share no parameter, so
each slice of a stacked leaf receives exactly its own model's gradient.

Where XLA:CPU's program rounds differently from the straight PyTorch
transcription, the loop takes XLA's rounding (ROADMAP C2): the mean loss
sums the batch in XLA's order (`losses.xla_mean_ordered`), the
log-softmax is XLA:CPU's with its backward (`losses.log_softmax`), the
SGD step is one FMA (`losses.fma32_`; on the card torch's in-place
`w -= lr * g`), and the delta multiplies by the float32 reciprocal of
lr, which is what XLA makes of the division by a constant.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bflc_demo_tpu_torch.core.losses import (accuracy, f32_reciprocal,
                                             fma32_, log_softmax, xla_mean,
                                             xla_mean_ordered)
from bflc_demo_tpu_torch.models.base import Model, Params


def _num_batches(n: int, batch_size: int) -> int:
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"shard of {n} examples < batch_size {batch_size}")
    return nb


def local_train(model: Model, params: Params, x: torch.Tensor,
                y: torch.Tensor, lr: float, batch_size: int,
                local_epochs: int = 1,
                optimizer=None) -> Tuple[Params, torch.Tensor]:
    """(delta, avg_cost) of `local_epochs` SGD passes over (x, y).

    x: (n, ...) features, y: (n, classes) one-hot; params is not modified.
    """
    if optimizer is not None:
        raise NotImplementedError(
            "only plain SGD (optimizer=None) is ported; optax-style local "
            "optimizers are still to port (ROADMAP queue A)")
    deltas, costs = local_train_stacked(model, params, x[None], y[None], lr,
                                        batch_size, local_epochs)
    return {k: v[0] for k, v in deltas.items()}, costs[0]


def local_train_stacked(model: Model, params: Params, xs: torch.Tensor,
                        ys: torch.Tensor, lr: float, batch_size: int,
                        local_epochs: int = 1) -> Tuple[Params, torch.Tensor]:
    """(deltas with a leading axis N, avg_costs (N,)) of N clients that all
    start from `params`.  xs: (N, S_pad, ...) padded shards, ys: (N, S_pad,
    classes) one-hot; the minibatches are the first floor(S_pad /
    batch_size) * batch_size rows of each shard."""
    trained, costs = sgd_stacked(model, params, xs, ys, lr, batch_size,
                                 local_epochs)
    return wire_deltas(params, trained, lr), costs


def wire_deltas(params: Params, trained: Params, lr: float) -> Params:
    """(params - trained) / lr of stacked trained models, as XLA computes
    it: times the float32 reciprocal of lr."""
    inv_lr = f32_reciprocal(lr)
    return {k: (params[k][None] - trained[k]) * inv_lr for k in params}


def sgd_stacked(model: Model, params: Params, xs: torch.Tensor,
                ys: torch.Tensor, lr: float, batch_size: int,
                local_epochs: int = 1) -> Tuple[Params, torch.Tensor]:
    """(trained params with a leading axis N, avg_costs (N,)): the SGD
    loop of `local_train_stacked`."""
    n = xs.shape[0]
    nb = _num_batches(xs.shape[1], batch_size)
    work = {k: v.detach().unsqueeze(0).repeat((n,) + (1,) * v.ndim)
            .requires_grad_(True) for k, v in params.items()}
    leaves = list(work.values())
    epoch_costs = []
    for _ in range(local_epochs):
        costs = []
        for i in range(nb):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            logits = model.apply_stacked(work, xs[:, sl])
            logp = log_softmax(logits)
            per_model = -xla_mean_ordered((ys[:, sl] * logp).sum(-1), 1)
            grads = torch.autograd.grad(per_model.sum(), leaves)
            with torch.no_grad():
                for w, g in zip(leaves, grads):
                    fma32_(w, -lr, g)            # w -= lr * g
            costs.append(per_model.detach())
        epoch_costs.append(xla_mean(torch.stack(costs), dim=0))
    return ({k: v.detach() for k, v in work.items()},
            xla_mean(torch.stack(epoch_costs), dim=0))


@torch.no_grad()
def evaluate(model: Model, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Accuracy of `params` on (x, y)."""
    return accuracy(model.apply(params, x), y)
