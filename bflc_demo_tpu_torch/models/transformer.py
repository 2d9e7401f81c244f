"""Encoder transformer classifier — the config-5 model.

Port of `bflc_demo_tpu/models/transformer.py` (dense path): the same
parameter tree and orientation (projections are (d, d) and the forward
computes `x @ W`), pre-norm blocks, PAD = 0 key masking and
padding-aware mean pooling.  Attention always goes through the port's
flash attention (`ops/flash_attention.py`): the CUDA kernels on the card,
their plain versions on the CPU — the reference's
`attention_impl="pallas"`.

Matched numerics, each a place a straight transcription goes wrong:
- GELU is the tanh approximation (`jax.nn.gelu`'s default);
- layer norm uses the population variance with eps 1e-6 inside the
  rsqrt (`F.layer_norm(..., eps=1e-6)`);
- the attention block is 128 if it divides S, else the largest of
  64/32/16/8/1 that does (S = 64 gives 64);
- pooling sums over PAD != 0 positions and divides by the count clamped
  to at least 1; the head starts at zero.

The reference's three sequence-parallel hooks of `transformer_forward`
(:171-202) and `block_forward` (:137-150) are `forward_hooked`'s
arguments: `attn_fn(q, k, v, kv_mask)` replaces the attention core,
`pos_offset` gives each row its offset into `pos`, and `pool(num, den)`
replaces the mean pool's division (the sp path sums both over the
sequence shards first, the reference's `pool_psum_axis`).  Without hooks
the forward is the dense path above.

Documented divergences: the initial values come from `torch.Generator`
with the reference's distributions (normal * 0.02 for embeddings and
projections, ones/zeros for norms, zeros for biases and the head), which
cannot reproduce `jax.random` seed for seed — `params_from_jax` loads the
reference's values where a run must match it.  Not ported: the `dtype`
knob (the port computes in float32, as config 5 does) and the mixture-of-
experts MLP.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bflc_demo_tpu_torch.models.base import Model, Params, keystr
from bflc_demo_tpu_torch.ops.flash_attention import flash_attention

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]
PoolFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 1024          # padded to a multiple of 128
    seq_len: int = 64
    num_classes: int = 2
    dim: int = 128
    depth: int = 2
    heads: int = 4
    mlp_ratio: int = 4

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def attention_block(s: int) -> int:
    """The reference's flash block for sequence length s."""
    return 128 if s % 128 == 0 else max(
        b for b in (64, 32, 16, 8, 1) if s % b == 0)


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias,
                            eps=1e-6)


class Block(nn.Module):
    """One pre-norm encoder block (reference `block_forward`)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d, hid = cfg.dim, cfg.mlp_ratio * cfg.dim
        self.heads = cfg.heads
        self.ln1 = LayerNorm(d)
        self.wq = nn.Parameter(torch.empty(d, d))
        self.wk = nn.Parameter(torch.empty(d, d))
        self.wv = nn.Parameter(torch.empty(d, d))
        self.wo = nn.Parameter(torch.empty(d, d))
        self.ln2 = LayerNorm(d)
        self.w1 = nn.Parameter(torch.empty(d, hid))
        self.b1 = nn.Parameter(torch.zeros(hid))
        self.w2 = nn.Parameter(torch.empty(hid, d))
        self.b2 = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, pad: torch.Tensor,
                attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
        b, s, d = x.shape
        shape = (b, s, self.heads, d // self.heads)
        y = self.ln1(x)
        q = (y @ self.wq).reshape(shape)
        k = (y @ self.wk).reshape(shape)
        v = (y @ self.wv).reshape(shape)
        if attn_fn is None:
            blk = attention_block(s)
            o = flash_attention(q, k, v, pad, blk, blk)
        else:
            o = attn_fn(q, k, v, pad)
        x = x + o.reshape(b, s, d) @ self.wo
        y = self.ln2(x)
        y = F.gelu(y @ self.w1 + self.b1, approximate="tanh")
        return x + (y @ self.w2 + self.b2)


class TransformerClassifier(Model):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.num_classes = cfg.num_classes
        d = cfg.dim
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos = nn.Parameter(torch.empty(cfg.seq_len, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.ln_f = LayerNorm(d)
        self.head_w = nn.Parameter(torch.zeros(d, cfg.num_classes))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_classes))

    def forward(self, tokens: torch.Tensor, attn_fn: Optional[AttnFn] = None,
                pos_offset: Optional[torch.Tensor] = None,
                pool: Optional[PoolFn] = None) -> torch.Tensor:
        """tokens: (B, S) integer, 0 = PAD.  Returns (B, classes) f32.
        The hooks are `forward_hooked`'s."""
        pad = tokens != 0
        s = tokens.shape[1]
        if pos_offset is None:
            pos = self.pos[:s][None]
        else:
            pos = self.pos[pos_offset[:, None]
                           + torch.arange(s, device=tokens.device)]
        x = self.embed[tokens] + pos
        for blk in self.blocks:
            x = blk(x, pad, attn_fn)
        x = self.ln_f(x)
        num = (x * pad[..., None]).sum(1)
        den = pad.sum(-1, keepdim=True)
        if pool is None:
            pooled = num / den.clamp_min(1).to(torch.float32)
        else:
            pooled = pool(num, den)
        return pooled @ self.head_w + self.head_b

    def forward_hooked(self, params: Params, tokens: torch.Tensor,
                       attn_fn: Optional[AttnFn] = None,
                       pos_offset: Optional[torch.Tensor] = None,
                       pool: Optional[PoolFn] = None) -> torch.Tensor:
        """Logits of `params` on `tokens`, with the reference's
        sequence-parallel hooks: `attn_fn(q, k, v, kv_mask)` in every block
        in place of flash attention; `pos_offset` (B,) integer, each row's
        first position in `pos`; `pool(num (B, d), den (B, 1) integer
        count of non-PAD tokens)` returning the pooled (B', d) — the
        head then runs on B' rows.  With no hooks this is `apply`."""
        return self.apply(params, tokens, attn_fn=attn_fn,
                          pos_offset=pos_offset, pool=pool)

    def init_params(self, seed: int = 0,
                    device: torch.device | str = "cpu") -> Params:
        gen = torch.Generator().manual_seed(seed)
        params = {}
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                value = torch.ones(p.shape)
            elif leaf in ("bias", "b1", "b2", "head_w", "head_b"):
                value = torch.zeros(p.shape)
            else:
                value = torch.randn(p.shape, generator=gen) * 0.02
            params[keystr(name)] = value.to(device)
        return params


def make_transformer_classifier(vocab_size: int = 1000, seq_len: int = 64,
                                num_classes: int = 2, dim: int = 128,
                                depth: int = 2, heads: int = 4,
                                ) -> TransformerClassifier:
    """Vocabulary padded to a multiple of 128, as in the reference."""
    return TransformerClassifier(TransformerConfig(
        vocab_size=_round_up(vocab_size, 128), seq_len=seq_len,
        num_classes=num_classes, dim=dim, depth=depth, heads=heads))
