"""Local optimizers: the port's copy of the optax transforms the
reference's clients use.

The reference takes any optax `GradientTransformation` for its clients'
local steps (`bflc_demo_tpu/core/local_train.py:72-90`) and its tests
drive `optax.sgd(lr)`, `optax.sgd(lr, momentum)` and `optax.adam(lr)`
(`tests/test_optimizers.py`).  The card's machine has no optax (and no
JAX), so the port keeps its own copy of those three, in optax 0.2.6's
arithmetic order:

- `sgd(lr, momentum=None, nesterov=False)`: `trace(momentum, nesterov)`
  (t = g + momentum * t; with nesterov the update is g + momentum * t)
  then `scale(-lr)`;
- `adam(lr, b1, b2, eps, eps_root)`: mu = (1 - b1) * g + b1 * mu,
  nu = (1 - b2) * g**2 + b2 * nu, count + 1, each moment divided by its
  bias correction 1 - decay**count (float32), the update
  mu_hat / (sqrt(nu_hat + eps_root) + eps), then `scale(-lr)`;
- `apply_updates(params, updates)`: p + u in p's dtype.

A transform is `init(params) -> state` and `update(grads, state,
params) -> (updates, state)` over `Params` dicts (`{keystr: tensor}`);
the state's tensors are shaped like the params, so a stacked leaf
(a leading client axis) carries one state a client.  State is fresh
every round, as the reference rebuilds it (`init` in each local train).
Dropped: the rest of optax (schedules, chains of other transforms,
`mu_dtype`/`accumulator_dtype`, nesterov Adam).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bflc_demo_tpu_torch.models.base import Params

State = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    """optax's pair: init(params) -> state; update(grads, state, params)
    -> (updates, state)."""
    init: Callable[[Params], State]
    update: Callable[[Params, State, Optional[Params]],
                     Tuple[Params, State]]


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """optax.sgd: plain (momentum None) or heavy-ball/Nesterov momentum."""
    lr = float(learning_rate)

    def init(params: Params) -> State:
        return ({} if momentum is None else
                {f"trace{k}": v for k, v in _zeros_like(params).items()})

    def update(grads: Params, state: State, params: Params = None):
        del params
        if momentum is None:
            return {k: (-lr) * g for k, g in grads.items()}, state
        trace = {k: g + momentum * state[f"trace{k}"]
                 for k, g in grads.items()}
        updates = ({k: g + momentum * trace[k] for k, g in grads.items()}
                   if nesterov else trace)
        return ({k: (-lr) * u for k, u in updates.items()},
                {f"trace{k}": t for k, t in trace.items()})

    return GradientTransformation(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    """optax.adam (scale_by_adam, then scale by -lr)."""
    lr = float(learning_rate)

    def init(params: Params) -> State:
        zeros = _zeros_like(params)
        state = {f"mu{k}": v for k, v in zeros.items()}
        state.update({f"nu{k}": v.clone() for k, v in zeros.items()})
        state["count"] = torch.zeros((), dtype=torch.int32)
        return state

    def update(grads: Params, state: State, params: Params = None):
        del params
        count = state["count"] + 1
        n = int(count)
        # 1 - decay**count in float32 (optax's bias_correction)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(n))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(n))
        new: State = {"count": count}
        updates = {}
        for k, g in grads.items():
            mu = (1 - b1) * g + b1 * state[f"mu{k}"]
            nu = (1 - b2) * (g * g) + b2 * state[f"nu{k}"]
            new[f"mu{k}"], new[f"nu{k}"] = mu, nu
            updates[k] = (-lr) * ((mu / bc1)
                                  / (torch.sqrt(nu / bc2 + eps_root) + eps))
        return updates, new

    return GradientTransformation(init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    """optax.apply_updates: p + u, in p's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def check_optimizer(optimizer) -> None:
    """TypeError unless `optimizer` has optax's init/update pair."""
    if optimizer is not None and not (callable(getattr(optimizer, "init",
                                                       None))
                                      and callable(getattr(optimizer,
                                                           "update", None))):
        raise TypeError(f"optimizer must be a GradientTransformation "
                        f"(init, update), got {type(optimizer).__name__}")
