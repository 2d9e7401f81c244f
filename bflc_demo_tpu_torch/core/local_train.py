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
working copy in place under `no_grad`.  `optimizer=None` is the
reference's plain SGD; any other is an optax-style transform
(`core/optim.py`: `sgd`, `sgd` with momentum, `adam`), its state fresh
each call and stacked like the params (one state a client), each step
`p += update(g)`.  The delta stays `(p_in - p_out) / lr` with the
protocol's lr, whatever the optimizer (reference :72-90).  A bfloat16
leaf (the bfloat16 MLP's) steps as jax rounds `w - lr * g` in
bfloat16: lr in the leaf's dtype, the product and the difference each
rounded.

`local_train_stacked` is the one SGD loop, the counterpart of
`vmap(local_train_impl)` (`bflc_demo_tpu/parallel/fedavg.py:360-381`):
all N clients step in lockstep, one autograd step per minibatch for all
of them through `Model.apply_stacked`; `local_train` is that loop at
N = 1.  The loss is the sum over models
of each model's mean cross-entropy; the models share no parameter, so
each slice of a stacked leaf receives exactly its own model's gradient.

`client_chunk` and `remat` are the mesh round's memory controls
(`bflc_demo_tpu/parallel/fedavg.py:294-297`, `:344-358`): the N clients
train in sequential chunks of `client_chunk` (peak activations scale
with the chunk, not N), and `remat` recomputes each step's forward in
its backward (`torch.utils.checkpoint`, non-reentrant) instead of
keeping its activations.  The models share no parameter and a chunk's
arithmetic is its slots' own, so neither changes a result.

Where XLA:CPU's program rounds differently from the straight PyTorch
transcription, the loop takes XLA's rounding (ROADMAP C2): the mean loss
sums the batch in XLA's order (`losses.xla_mean_ordered`), and so do
the means over an epoch's batches and over the epochs (torch's own sum
over the minibatch axis of an (nb, N) stack depends on N, so a chunk of
slots would round otherwise than the whole), the
log-softmax is XLA:CPU's with its backward (`losses.log_softmax`), the
SGD step is one FMA (`losses.fma32_`; on the card torch's in-place
`w -= lr * g`), and the delta multiplies by the float32 reciprocal of
lr, which is what XLA makes of the division by a constant in the
vmapped program.  The per-client program (`local_train`, the reference's
`jax.jit(local_train)` for one client: the host, threaded and process
runtimes) keeps the true float32 division by lr (ROADMAP C6), and with
it config 1's per-client steps are the reference's bit for bit too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from bflc_demo_tpu_torch.core.losses import (accuracy, f32_reciprocal,
                                             fma32_, log_softmax,
                                             xla_mean_ordered)
from bflc_demo_tpu_torch.core.optim import check_optimizer
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
    check_optimizer(optimizer)
    trained, costs = sgd_stacked(model, params, x[None], y[None], lr,
                                 batch_size, local_epochs,
                                 optimizer=optimizer)
    # the reference's per-client program divides by lr where its vmapped
    # one multiplies by the reciprocal (ROADMAP C6): a true float32 division
    return ({k: (params[k] - trained[k][0]) / _lr_like(lr, params[k])
             for k in params}, costs[0])


def _lr_like(lr: float, leaf: torch.Tensor) -> torch.Tensor:
    """lr as a 0-d tensor in the leaf's dtype (jax's weak-typed scalar)."""
    return torch.tensor(np.float32(lr)).to(leaf.dtype)


def sgd_step_(w: torch.Tensor, lr: float, g: torch.Tensor) -> torch.Tensor:
    """w -= lr * g in place: one FMA for float32 (`losses.fma32_`); for a
    bfloat16 leaf, lr * g and the difference each rounded to bfloat16."""
    if w.dtype == torch.float32:
        return fma32_(w, -lr, g)
    return w.sub_(_lr_like(lr, w).to(w.device) * g)


def local_train_stacked(model: Model, params: Params, xs: torch.Tensor,
                        ys: torch.Tensor, lr: float, batch_size: int,
                        local_epochs: int = 1,
                        optimizer=None) -> Tuple[Params, torch.Tensor]:
    """(deltas with a leading axis N, avg_costs (N,)) of N clients that all
    start from `params`.  xs: (N, S_pad, ...) padded shards, ys: (N, S_pad,
    classes) one-hot; the minibatches are the first floor(S_pad /
    batch_size) * batch_size rows of each shard."""
    trained, costs = sgd_stacked(model, params, xs, ys, lr, batch_size,
                                 local_epochs, optimizer=optimizer)
    return wire_deltas(params, trained, lr), costs


def wire_deltas(params: Params, trained: Params, lr: float) -> Params:
    """(params - trained) / lr of stacked trained models, as XLA computes
    it: times the float32 reciprocal of lr."""
    inv_lr = f32_reciprocal(lr)
    return {k: (params[k][None] - trained[k])
            * (inv_lr if params[k].dtype == torch.float32
               else _lr_like(inv_lr, params[k]).to(params[k].device))
            for k in params}


def sgd_stacked(model: Model, params: Params, xs: torch.Tensor,
                ys: torch.Tensor, lr: float, batch_size: int,
                local_epochs: int = 1, client_chunk: int = 0,
                remat: bool = False,
                optimizer=None) -> Tuple[Params, torch.Tensor]:
    """(trained params with a leading axis N, avg_costs (N,)): the SGD
    loop of `local_train_stacked`, over all N clients at once or, with
    0 < client_chunk < N (a divisor of N), over consecutive chunks of
    `client_chunk` clients one after another; `optimizer` None (plain
    SGD at lr) or a `core.optim` transform."""
    n = xs.shape[0]
    if not client_chunk or client_chunk >= n:
        return _sgd_lockstep(model, params, xs, ys, lr, batch_size,
                             local_epochs, remat, optimizer)
    if n % client_chunk:
        raise ValueError(f"{n} clients not divisible by client_chunk "
                         f"{client_chunk}")
    parts = [_sgd_lockstep(model, params, xs[i:i + client_chunk],
                           ys[i:i + client_chunk], lr, batch_size,
                           local_epochs, remat, optimizer)
             for i in range(0, n, client_chunk)]
    return ({k: torch.cat([t[k] for t, _ in parts]) for k in params},
            torch.cat([c for _, c in parts]))


def _sgd_lockstep(model: Model, params: Params, xs: torch.Tensor,
                  ys: torch.Tensor, lr: float, batch_size: int,
                  local_epochs: int, remat: bool, optimizer=None
                  ) -> Tuple[Params, torch.Tensor]:
    """The SGD loop of `xs.shape[0]` clients in lockstep."""
    n = xs.shape[0]
    nb = _num_batches(xs.shape[1], batch_size)
    work = {k: v.detach().unsqueeze(0).repeat((n,) + (1,) * v.ndim)
            .requires_grad_(True) for k, v in params.items()}
    leaves = list(work.values())
    if optimizer is not None:
        # fresh each call, one state a client (the leading axis)
        opt_state = optimizer.init({k: v.detach() for k, v in work.items()})
    epoch_costs = []
    for _ in range(local_epochs):
        costs = []
        for i in range(nb):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            if remat:
                logits = checkpoint(model.apply_stacked, work, xs[:, sl],
                                    use_reentrant=False)
            else:
                logits = model.apply_stacked(work, xs[:, sl])
            logp = log_softmax(logits)
            per_model = -xla_mean_ordered((ys[:, sl] * logp).sum(-1), 1)
            grads = torch.autograd.grad(per_model.sum(), leaves)
            with torch.no_grad():
                if optimizer is None:
                    for w, g in zip(leaves, grads):
                        sgd_step_(w, lr, g)          # w -= lr * g
                else:
                    updates, opt_state = optimizer.update(
                        dict(zip(work, grads)), opt_state,
                        {k: v.detach() for k, v in work.items()})
                    for k, w in work.items():
                        w.add_(updates[k])           # apply_updates
            costs.append(per_model.detach())
        epoch_costs.append(xla_mean_ordered(torch.stack(costs), 0))
    return ({k: v.detach() for k, v in work.items()},
            xla_mean_ordered(torch.stack(epoch_costs), 0))


@torch.no_grad()
def evaluate(model: Model, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Accuracy of `params` on (x, y)."""
    return accuracy(model.apply(params, x), y)
