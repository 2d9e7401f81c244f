"""Loss / metric primitives (port of `bflc_demo_tpu/core/losses.py`).

Mean softmax cross-entropy with one-hot labels, `-mean(sum(y * log_softmax))`,
and accuracy as the argmax match rate.

`xla_mean` reproduces `jnp.mean` bit for bit: XLA rewrites the division
by the element count into a multiplication by its float32 reciprocal, so
56/60 comes out as 0.93333339, one ulp above `torch.mean`'s 0.93333334.
Accuracies are committee scores, which the ledger stores as float32
bytes in its hash chain, so the port takes the reference's rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def xla_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """`jnp.mean` of a float32 tensor: sum times the f32 reciprocal."""
    n = x.numel() if dim is None else x.shape[dim]
    total = x.sum() if dim is None else x.sum(dim)
    return total * float(np.float32(1.0) / np.float32(n))


def softmax_cross_entropy(logits: torch.Tensor,
                          labels_onehot: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -xla_mean((labels_onehot * logp).sum(-1))


def accuracy(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(-1)
    true = labels_onehot.argmax(-1)
    return xla_mean((pred == true).to(torch.float32))
