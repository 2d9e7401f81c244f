"""Ring attention and the sequence-parallel transformer on the folded axis.

Port of `bflc_demo_tpu/parallel/ring_attention.py`:

- `ring_attention` (:35-93): exact attention with the KV blocks passed
  around the ring of sequence shards.  impl "einsum" is the plain ring
  (:60-93), one materialised (S/n, S/n) logits block per hop; impl
  "pallas" is `RingAttention`, whose forward runs one `flash_carry`
  kernel per hop (`_ring_pallas_fwd_impl` :104-138) and whose backward
  recomputes with the einsum ring under autograd (:141-158) — the
  reference has no backward kernel here, so neither has the port;
- `make_sp_transformer_forward` (:191-203), `sp_sgd_update` (:206-235)
  and `make_sp_train_step` (:273-312), built on `_sp_local_forward`
  (:161-188).  They take and return `Params` dicts, as `Model.apply`
  does, and their ring is always the carry-kernel one: the port's
  transformer always attends through its flash kernels, the reference's
  `attention_impl="pallas"`.

The axis is a `FoldedAxis` (`parallel/mesh.py`): the n shards live on one
device, folded into the batch axis, and each `flash_carry` launch covers
all shards' resident queries at once.  Shard i sees KV blocks i, i-1, ...,
i-n+1 in that order, as on n devices, so the online softmax accumulates
in the reference's order.

Gradient assembly needs neither of the reference's `psum_exact` nor its
psum of the body gradients over sp (:226-234): there, each device
differentiates its own shard's program, so the pooling psum must pass
replicated cotangents through and the body gradients must be summed
afterwards.  In the folded form the pooling psum is a real sum whose
autograd transpose is exact, and the head and the loss run once on the
(B, d) pooled value, so autograd's gradients are already the totals.
Not ported (ROADMAP A12): the `torch.distributed` ring across cards,
`make_dp_sp_train_step`, sp x tp (`parallel/sp_tp.py`) and the
`psum_exact`/`fanout_exact` collectives that form would need.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from bflc_demo_tpu_torch.core.losses import softmax_cross_entropy
from bflc_demo_tpu_torch.models.base import Params
from bflc_demo_tpu_torch.models.transformer import TransformerClassifier
from bflc_demo_tpu_torch.ops.flash_attention import (NEG_INF, TINY, _scale,
                                                     flash_carry)
from bflc_demo_tpu_torch.parallel.mesh import FoldedAxis

IMPLS = ("einsum", "pallas")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, axis: FoldedAxis,
                   impl: str = "einsum") -> torch.Tensor:
    """Attention of each shard's queries over the whole sequence.

    Folded shapes: q/k/v (n*B, S/n, H, D); kv_mask (n*B, S/n) bool, False
    = PAD.  Returns (n*B, S/n, H, D) in q's dtype; a query row whose keys
    are all PAD gives 0.
    """
    if impl == "pallas":
        return RingAttention.apply(q, k, v, kv_mask, axis)
    if impl != "einsum":
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    nb, s, h, d = q.shape
    scale = _scale(d)
    acc = torch.zeros((nb, h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((nb, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((nb, h, s), dtype=torch.float32, device=q.device)
    kb, vb, mb = k, v, kv_mask
    for hop in range(axis.size):
        if hop:
            kb, vb, mb = (axis.ppermute(t) for t in (kb, vb, mb))
        valid = mb[:, None, None, :]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        # while every logit seen is NEG_INF, exp(NEG_INF - NEG_INF) = 1
        # would resurrect masked keys: zero them explicitly
        p = torch.where(valid, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   vb.float())
        m = m_new
    out = acc / l[..., None].clamp_min(TINY)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _carry_ring(q, k, v, kv_mask, axis: FoldedAxis) -> torch.Tensor:
    """The ring with one `flash_carry` per hop; the (acc, m, l) carry
    crosses hops outside the kernel, K/V tiles stream inside it."""
    nb, s, h, d = q.shape
    # the reference's kernel block for the shard; the CUDA kernel keeps
    # its own tiles, so the block only decides what is accepted
    blk = 128
    while s % blk:
        blk //= 2
    if blk < 8:
        raise ValueError(f"sequence block {s} has no usable kernel tile")
    acc = torch.zeros((nb * h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((nb * h, 1, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((nb * h, 1, s), dtype=torch.float32, device=q.device)
    kb, vb, mb = k, v, kv_mask
    for hop in range(axis.size):
        if hop:
            kb, vb, mb = (axis.ppermute(t) for t in (kb, vb, mb))
        acc, m, l = flash_carry(q, kb, vb, mb, acc, m, l)
    out = acc / l[:, 0, :, None].clamp_min(TINY)
    return out.reshape(nb, h, s, d).permute(0, 2, 1, 3).to(q.dtype)


class RingAttention(torch.autograd.Function):
    """The reference's `custom_vjp` around the carry ring: the forward
    keeps (q, k, v, mask); the backward recomputes the einsum ring under
    autograd (per-hop block logits only) and returns its (dq, dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, axis: FoldedAxis):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.axis = axis
        return _carry_ring(q, k, v, kv_mask, axis)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ring_attention(*leaves, kv_mask, ctx.axis, impl="einsum")
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


ShardForward = Callable[[Params, torch.Tensor], torch.Tensor]


def _sp_local_forward(axis: FoldedAxis,
                      model: TransformerClassifier) -> ShardForward:
    """The one per-shard sp forward both factories build on: the dense
    model's forward with the carry-kernel ring as its attention, each
    row's shard offset into `pos`, and the pool's numerator and count
    summed over the shards."""
    if model.cfg.seq_len % axis.size:
        raise ValueError(f"seq_len {model.cfg.seq_len} not divisible by sp "
                         f"axis {axis.size}")

    def attn_fn(q, k, v, kv_mask):
        return RingAttention.apply(q, k, v, kv_mask, axis)

    def pool(num, den):
        return axis.psum(num) / axis.psum(den).clamp_min(1).to(torch.float32)

    def shard_forward(params: Params, folded: torch.Tensor) -> torch.Tensor:
        return model.forward_hooked(params, folded, attn_fn=attn_fn,
                                    pos_offset=axis.offsets(folded.shape[1]),
                                    pool=pool)

    return shard_forward


def make_sp_transformer_forward(axis: FoldedAxis,
                                model: TransformerClassifier,
                                ) -> Callable[[Params, torch.Tensor],
                                              torch.Tensor]:
    """Sequence-parallel classifier forward: fn(params, tokens (B, S)) ->
    (B, classes) logits, S divisible by the axis size.  Per-token work
    runs on the shards, attention is the ring (the carry kernel on every
    hop), the mean pool sums over the shards."""
    shard_forward = _sp_local_forward(axis, model)

    def forward(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return shard_forward(params, axis.shard(tokens))

    return forward


def sp_sgd_update(shard_forward: ShardForward, params: Params,
                  folded: torch.Tensor, labels: torch.Tensor, lr: float,
                  ) -> Tuple[Params, torch.Tensor]:
    """One SGD step, `w - lr * g`, of the loss of `shard_forward` on the
    folded tokens: (new params, loss).

    The gradients autograd returns are already the totals over the
    sequence (see the module docstring), so no leaf needs the
    reference's psum over sp and none is special-cased as replicated.
    """
    work = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = softmax_cross_entropy(shard_forward(work, folded), labels)
    grads = torch.autograd.grad(loss, list(work.values()))
    with torch.no_grad():
        new = {k: w - lr * g for (k, w), g in zip(work.items(), grads)}
    return new, loss.detach()


def make_sp_train_step(axis: FoldedAxis, model: TransformerClassifier,
                       lr: float,
                       ) -> Callable[[Params, torch.Tensor, torch.Tensor],
                                     Tuple[Params, torch.Tensor]]:
    """One SGD step of the sequence-parallel transformer, gradients
    flowing back through the ring: step(params, tokens (B, S),
    labels_onehot (B, classes)) -> (new_params, loss)."""
    shard_forward = _sp_local_forward(axis, model)

    def step(params: Params, tokens: torch.Tensor, labels: torch.Tensor):
        return sp_sgd_update(shard_forward, params, axis.shard(tokens),
                             labels.to(axis.device), lr)

    return step
