"""Softmax regression — the reference demo's one model, config 1.

Port of `bflc_demo_tpu/models/softmax_regression.py` (:21-40): one dense
layer, 5 features -> 2 classes, `x @ W + b`, zero-initialised (the
contract's genesis model is all zeros, so every seed gives the same
start).  Parameters `['W']` (n_features, n_class) and `['b']` (n_class,).
The bias's gradient sums the batch rows in XLA:CPU's order
(`core.losses.add_bias`), so that local training takes the reference's
steps bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from bflc_demo_tpu_torch.core.losses import add_bias
from bflc_demo_tpu_torch.models.base import Model, Params


class SoftmaxRegression(Model):
    def __init__(self, n_features: int = 5, n_class: int = 2):
        super().__init__()
        self.num_classes = n_class
        self.W = nn.Parameter(torch.zeros(n_features, n_class))
        self.b = nn.Parameter(torch.zeros(n_class))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return add_bias(x.to(torch.float32) @ self.W, self.b, 0)

    def init_params(self, seed: int = 0,
                    device: torch.device | str = "cpu") -> Params:
        del seed  # zero init, matching the reference's genesis model
        return {"['W']": torch.zeros(self.W.shape, device=device),
                "['b']": torch.zeros(self.b.shape, device=device)}

    def apply_stacked(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return add_bias(x.to(torch.float32) @ params["['W']"],
                        params["['b']"], 1)


def make_softmax_regression(n_features: int = 5,
                            n_class: int = 2) -> SoftmaxRegression:
    return SoftmaxRegression(n_features, n_class)
