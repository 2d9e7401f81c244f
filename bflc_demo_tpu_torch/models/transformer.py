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

`apply_stacked` is the mesh round's forward of G models at once (the
reference's `vmap(apply)`): every leaf carries a leading model axis, the
projections and the MLP are batched products over that axis
(`_per_model`, one bmm per weight, never an expanded copy of it), layer
norm normalises without affine and then applies each model's scale and
bias, the embedding lookup is `embed[g, tokens]`, and attention folds
(G, B) into the flash kernels' batch axis, so one launch of each kernel
serves every model.

`init_params(seed)` draws the reference's initial model from the same
seed: `jax.random`'s key splits and normal draws, reproduced by
`utils/prng.py` (normal within a few float32 ulp).

`dtype` (float32 or bfloat16) is the reference's compute dtype
(:110-115, :139-200): parameters stay float32 and each weight is cast
to `dtype` where it is used; the embeddings, the residual stream, the
projections, attention (the bfloat16 instantiations of the flash
kernels) and the MLP run in `dtype`; layer norm computes in float32 and
casts its output to `dtype`, except the final one, which stays float32
with the pooling and the head.

`moe_experts` E > 0 is the reference's dense mixture of experts (:72-98,
:153-165): each block's MLP becomes E expert MLPs (`we1` (E, d, h),
`wb1` (E, h), `we2` (E, h, d), `wb2` (E, d)) weighted by a softmax
router (`router` (d, E); the gates in float32).  Every expert computes;
the port runs them one after another and sums their gated outputs in
float32, so no (rows, E, hidden) activation is held at once (the
reference's einsum over e contracts the same sum).  Its initial model
splits 7 keys a block (`router`, `we1`, `we2` from keys 4-6); the dense
path keeps its 6, so config 5's initial model does not change.
Dropped: the expert axis's sharding over "ep" (`parallel/ep.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bflc_demo_tpu_torch.models.base import Model, Params, keystr
from bflc_demo_tpu_torch.ops.flash_attention import flash_attention
from bflc_demo_tpu_torch.utils import prng

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
    dtype: torch.dtype = torch.float32
    moe_experts: int = 0

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

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Computed in float32, the result cast to `dtype`."""
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale,
                            self.bias, eps=1e-6).to(dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _moe(y: torch.Tensor, router: torch.Tensor, we1: torch.Tensor,
         wb1: torch.Tensor, we2: torch.Tensor, wb2: torch.Tensor,
         matmul) -> torch.Tensor:
    """The dense mixture of experts on `y` (..., d) in y's dtype:
    sum_e gate_e * (gelu(y @ we1_e + wb1_e) @ we2_e + wb2_e), the gates a
    float32 softmax of `y @ router`.  The weights come cast to y's dtype
    with the expert axis at -3 (`we1` (..., E, d, h)) and -2 for the
    biases; `matmul(x, w)` is the product with one expert's weight."""
    dt = y.dtype
    gates = torch.softmax(matmul(y, router).float(), -1)
    out = None
    for e in range(we1.shape[-3]):
        h = _gelu(matmul(y, we1[..., e, :, :]) + wb1[..., e, :])
        o = (matmul(h, we2[..., e, :, :]) + wb2[..., e, :]).float() \
            * gates[..., e:e + 1].to(dt).float()
        out = o if out is None else out + o
    return out.to(dt)


class Block(nn.Module):
    """One pre-norm encoder block (reference `block_forward`)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d, hid, e = cfg.dim, cfg.mlp_ratio * cfg.dim, cfg.moe_experts
        self.heads = cfg.heads
        self.dtype = cfg.dtype
        self.moe = e > 0
        self.ln1 = LayerNorm(d)
        self.wq = nn.Parameter(torch.empty(d, d))
        self.wk = nn.Parameter(torch.empty(d, d))
        self.wv = nn.Parameter(torch.empty(d, d))
        self.wo = nn.Parameter(torch.empty(d, d))
        self.ln2 = LayerNorm(d)
        if self.moe:
            self.router = nn.Parameter(torch.empty(d, e))
            self.we1 = nn.Parameter(torch.empty(e, d, hid))
            self.wb1 = nn.Parameter(torch.zeros(e, hid))
            self.we2 = nn.Parameter(torch.empty(e, hid, d))
            self.wb2 = nn.Parameter(torch.zeros(e, d))
        else:
            self.w1 = nn.Parameter(torch.empty(d, hid))
            self.b1 = nn.Parameter(torch.zeros(hid))
            self.w2 = nn.Parameter(torch.empty(hid, d))
            self.b2 = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, pad: torch.Tensor,
                attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
        b, s, d = x.shape
        dt = self.dtype
        shape = (b, s, self.heads, d // self.heads)
        y = self.ln1(x, dt)
        q = (y @ self.wq.to(dt)).reshape(shape)
        k = (y @ self.wk.to(dt)).reshape(shape)
        v = (y @ self.wv.to(dt)).reshape(shape)
        if attn_fn is None:
            blk = attention_block(s)
            o = flash_attention(q, k, v, pad, blk, blk)
        else:
            o = attn_fn(q, k, v, pad)
        x = x + o.reshape(b, s, d) @ self.wo.to(dt)
        y = self.ln2(x, dt)
        if self.moe:
            return x + _moe(y, *(w.to(dt) for w in (
                self.router, self.we1, self.wb1, self.we2, self.wb2)),
                torch.matmul)
        y = _gelu(y @ self.w1.to(dt) + self.b1.to(dt))
        return x + (y @ self.w2.to(dt) + self.b2.to(dt))


def _per_model(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (G, B, S, a) times each model's own w (G, a, c): (G, B, S, c)."""
    g, b, s, a = x.shape
    return (x.reshape(g, b * s, a) @ w).reshape(g, b, s, w.shape[-1])


def _stacked_ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Layer norm of (G, ..., d) with each model's (G, d) scale and bias,
    in float32, cast to `dtype`."""
    bcast = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6)
    return (y * scale.reshape(bcast) + bias.reshape(bcast)).to(dtype)


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
        dt = self.cfg.dtype
        if pos_offset is None:
            pos = self.pos[:s][None]
        else:
            pos = self.pos[pos_offset[:, None]
                           + torch.arange(s, device=tokens.device)]
        x = self.embed[tokens].to(dt) + pos.to(dt)
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

    def apply_stacked(self, params: Params,
                      tokens: torch.Tensor) -> torch.Tensor:
        """Logits (G, B, classes) of G models on tokens (G, B, S)."""
        cfg = self.cfg
        dt = cfg.dtype
        g, b, s = tokens.shape
        tokens = tokens.long()
        pad = tokens != 0
        models = torch.arange(g, device=tokens.device)[:, None, None]
        x = params["['embed']"][models, tokens].to(dt) \
            + params["['pos']"][:, None, :s].to(dt)
        blk = attention_block(s)
        shape = (g * b, s, cfg.heads, cfg.head_dim)
        for i in range(cfg.depth):
            p = {k[len(f"['blocks'][{i}]"):]: v for k, v in params.items()
                 if k.startswith(f"['blocks'][{i}]")}

            def w(name):
                return p[f"['{name}']"].to(dt)
            y = _stacked_ln(x, p["['ln1']['scale']"], p["['ln1']['bias']"],
                            dt)
            q, k, v = (_per_model(y, w(n)).reshape(shape)
                       for n in ("wq", "wk", "wv"))
            o = flash_attention(q, k, v, pad.reshape(g * b, s), blk, blk)
            x = x + _per_model(o.reshape(g, b, s, cfg.dim), w("wo"))
            y = _stacked_ln(x, p["['ln2']['scale']"], p["['ln2']['bias']"],
                            dt)
            if cfg.moe_experts:
                # the expert axis after the model axis; each expert's
                # (G, a, c) slice is one batched product
                x = x + _moe(y, w("router"), w("we1"),
                             w("wb1")[:, None, None], w("we2"),
                             w("wb2")[:, None, None], _per_model)
                continue
            y = _gelu(_per_model(y, w("w1")) + w("b1")[:, None, None])
            x = x + _per_model(y, w("w2")) + w("b2")[:, None, None]
        x = _stacked_ln(x, params["['ln_f']['scale']"],
                        params["['ln_f']['bias']"])
        num = (x * pad[..., None]).sum(2)
        den = pad.sum(-1, keepdim=True)
        pooled = num / den.clamp_min(1).to(torch.float32)
        return pooled @ params["['head_w']"] + params["['head_b']"][:, None]

    def init_params(self, seed: int = 0,
                    device: torch.device | str = "cpu") -> Params:
        """The reference's `init_transformer_params(cfg, PRNGKey(seed))`
        (:67-107): its key splits and normal draws (`utils/prng.py`),
        times 0.02, for the embeddings and projections; ones for the norm
        scales; zeros for the biases and the head."""
        keys = prng.split(prng.PRNGKey(seed), 4 + self.cfg.depth)
        drawn = {"['embed']": keys[0], "['pos']": keys[1]}
        names = (("wq", "wk", "wv", "wo", "router", "we1", "we2")
                 if self.cfg.moe_experts else
                 ("wq", "wk", "wv", "wo", "w1", "w2"))
        for i in range(self.cfg.depth):
            ks = prng.split(keys[2 + i], len(names))
            for j, name in enumerate(names):
                drawn[f"['blocks'][{i}]['{name}']"] = ks[j]
        params = {}
        for name, p in self.named_parameters():
            key = keystr(name)
            if key in drawn:
                value = torch.from_numpy(prng.normal(drawn[key],
                                                     tuple(p.shape))
                                         * np.float32(0.02))
            elif name.endswith(".scale"):
                value = torch.ones(p.shape)
            else:
                value = torch.zeros(p.shape)
            params[key] = value.to(device)
        return params


def make_transformer_classifier(vocab_size: int = 1000, seq_len: int = 64,
                                num_classes: int = 2, dim: int = 128,
                                depth: int = 2, heads: int = 4,
                                dtype: torch.dtype = torch.float32,
                                moe_experts: int = 0,
                                ) -> TransformerClassifier:
    """Vocabulary padded to a multiple of 128, as in the reference;
    `dtype` float32 or bfloat16 (also by name)."""
    from bflc_demo_tpu_torch.models.base import compute_dtype
    return TransformerClassifier(TransformerConfig(
        vocab_size=_round_up(vocab_size, 128), seq_len=seq_len,
        num_classes=num_classes, dim=dim, depth=depth, heads=heads,
        dtype=compute_dtype(dtype), moe_experts=int(moe_experts)))
