"""Loss / metric primitives (port of `bflc_demo_tpu/core/losses.py`).

Mean softmax cross-entropy with one-hot labels, `-mean(sum(y * log_softmax))`,
and accuracy as the argmax match rate.

`xla_mean` reproduces `jnp.mean` bit for bit: XLA rewrites the division
by the element count into a multiplication by its float32 reciprocal, so
56/60 comes out as 0.93333339, one ulp above `torch.mean`'s 0.93333334.
Accuracies are committee scores, which the ledger stores as float32
bytes in its hash chain, so the port takes the reference's rounding.

`xla_sum` reproduces `jnp.sum`'s order of additions on XLA:CPU, where a
reduction over more than 32 elements is rewritten (XLA's tree-reduction
rewriter) into windows of 32: the axis is zero-padded to a multiple of
32, evenly on both sides, each window is summed in order, and the
window sums are reduced the same way.  The mean training loss and the
gradient of a bias over a batch are such sums; in torch's order they
made config 1's first local step differ from the reference's by an ulp
(ROADMAP C2).  A mean of values whose sum is exact in any order
(accuracies: counts of ones) keeps `torch.sum`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

XLA_REDUCE_WINDOW = 32


def xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.sum(x, axis=dim)` of a float32 tensor, in XLA:CPU's order.
    A CUDA tensor is summed by `torch.sum`: the order mirrored is the CPU
    reference's, and mirroring it costs a launch an element on the card
    (it made config 1's card round ~3x slower)."""
    if x.is_cuda:
        return x.sum(dim)
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n > XLA_REDUCE_WINDOW:
        pad = -n % XLA_REDUCE_WINDOW
        x = F.pad(x, (pad // 2, pad - pad // 2))
        return xla_sum(_sum_in_order(
            x.reshape(*x.shape[:-1], -1, XLA_REDUCE_WINDOW)), -1)
    return _sum_in_order(x)


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one element after another from 0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


class _AddBias(torch.autograd.Function):
    """``x + b.unsqueeze(dim)``; the gradient of b sums the rows of x's
    axis `dim` with `xla_sum`, as the reference's autodiff does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, b: torch.Tensor,
                dim: int) -> torch.Tensor:
        ctx.dim = dim
        return x + b.unsqueeze(dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, xla_sum(g, ctx.dim), None


def add_bias(x: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """x plus b, broadcast along x's axis `dim` (the batch rows)."""
    return _AddBias.apply(x, b, dim)


def f32_reciprocal(x: float) -> float:
    """float32(1) / float32(x): what XLA multiplies by where the program
    divides by the constant x."""
    return float(np.float32(1.0) / np.float32(x))


def xla_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """`jnp.mean` of a float32 tensor: sum times the f32 reciprocal.  The
    sum is torch's: use it where every order gives the same sum."""
    n = x.numel() if dim is None else x.shape[dim]
    total = x.sum() if dim is None else x.sum(dim)
    return total * f32_reciprocal(n)


def xla_mean_ordered(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.mean(x, axis=dim)` with the sum in XLA:CPU's order."""
    return xla_sum(x, dim) * f32_reciprocal(x.shape[dim])


def softmax_cross_entropy(logits: torch.Tensor,
                          labels_onehot: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -xla_mean((labels_onehot * logp).sum(-1))


def accuracy(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(-1)
    true = labels_onehot.argmax(-1)
    return xla_mean((pred == true).to(torch.float32))
