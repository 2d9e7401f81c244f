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
"""

from __future__ import annotations

from typing import Tuple

import torch

from bflc_demo_tpu_torch.core.losses import (accuracy, softmax_cross_entropy,
                                            xla_mean)
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
    nb = _num_batches(x.shape[0], batch_size)
    work = {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}
    leaves = list(work.values())
    epoch_costs = []
    for _ in range(local_epochs):
        costs = []
        for i in range(nb):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            loss = softmax_cross_entropy(model.apply(work, x[sl]), y[sl])
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for w, g in zip(leaves, grads):
                    w.sub_(lr * g)
            costs.append(loss.detach())
        epoch_costs.append(xla_mean(torch.stack(costs)))
    delta = {k: (params[k] - work[k].detach()) / lr for k in params}
    return delta, xla_mean(torch.stack(epoch_costs))


@torch.no_grad()
def evaluate(model: Model, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Accuracy of `params` on (x, y)."""
    return accuracy(model.apply(params, x), y)
