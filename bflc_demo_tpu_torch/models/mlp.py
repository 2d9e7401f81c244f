"""2-layer MLP (config 0).

Port of `bflc_demo_tpu/models/mlp.py` (:18-40): inputs flattened,
`relu(x @ W1 + b1) @ W2 + b2`, every parameter and the computation in
`dtype` (float32 or bfloat16: the reference's own params are bfloat16
there, so deltas, uploads and fingerprints carry 2-byte leaves).
`init_params(seed)` draws the reference's values with `utils/prng.py`:
`k1, _ = split(PRNGKey(seed))`, W1 = normal(k1, (in_dim, hidden),
dtype) * dtype(sqrt(2 / in_dim)) (He; the bfloat16 draw and product
rounded as jax rounds them), and b1, W2, b2 zero (round 0 starts from
uniform predictions).  `apply_stacked` is a batched matmul.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from bflc_demo_tpu_torch.models.base import Model, Params, compute_dtype
from bflc_demo_tpu_torch.utils import prng


class MLP(Model):
    def __init__(self, input_shape: Tuple[int, ...] = (28, 28, 1),
                 hidden: int = 200, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.input_shape = tuple(input_shape)
        self.in_dim = int(np.prod(input_shape))
        self.dtype = compute_dtype(dtype)
        kw = dict(dtype=self.dtype)
        self.W1 = nn.Parameter(torch.zeros(self.in_dim, hidden, **kw))
        self.b1 = nn.Parameter(torch.zeros(hidden, **kw))
        self.W2 = nn.Parameter(torch.zeros(hidden, num_classes, **kw))
        self.b2 = nn.Parameter(torch.zeros(num_classes, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1).to(self.dtype)
        return torch.relu(h @ self.W1 + self.b1) @ self.W2 + self.b2

    def init_params(self, seed: int = 0,
                    device: torch.device | str = "cpu") -> Params:
        k1, _ = prng.split(prng.PRNGKey(seed))
        scale = np.sqrt(np.float32(2.0 / self.in_dim))
        if self.dtype == torch.bfloat16:
            w1 = prng.round_bf16(prng.normal(k1, tuple(self.W1.shape),
                                             "bfloat16")
                                 * prng.round_bf16(scale))
        else:
            w1 = prng.normal(k1, tuple(self.W1.shape)) * scale
        kw = dict(dtype=self.dtype, device=device)
        return {"['W1']": torch.as_tensor(w1).to(**kw),
                "['b1']": torch.zeros(self.b1.shape, **kw),
                "['W2']": torch.zeros(self.W2.shape, **kw),
                "['b2']": torch.zeros(self.b2.shape, **kw)}

    def apply_stacked(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], x.shape[1], -1).to(self.dtype)
        h = torch.relu(h @ params["['W1']"] + params["['b1']"][:, None])
        return h @ params["['W2']"] + params["['b2']"][:, None]


def make_mlp(input_shape: Tuple[int, ...] = (28, 28, 1), hidden: int = 200,
             num_classes: int = 10, dtype: torch.dtype = torch.float32
             ) -> MLP:
    return MLP(tuple(input_shape), hidden, num_classes, dtype)
