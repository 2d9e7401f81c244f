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

The rest of config 1's local step, mirrored the same way (ROADMAP C2):
- `fma32` is a float32 fused multiply-add (one rounding), which XLA:CPU
  emits wherever LLVM may contract a product into a sum and torch has
  no CPU op for: the product and sum in float64, whose one wrong case —
  the double sum landing on a float32 midpoint with a nonzero error
  term (TwoSum) — is corrected;
- `xla_exp` and `xla_log` are the Cephes polynomials XLA:CPU emits for
  float32 `exp` and `log`, with its contractions (torch's differ in ~10%
  of values by an ulp);
- `log_softmax` is `jax.nn.log_softmax` with the backward autodiff
  derives from it, `g + (-sum(g) / S) * exp(shifted)` as one FMA;
- `xla_matmul` is `x @ W` over a batch of rows in XLA:CPU's dot order
  (5 features: rounded products added as ((p0+p1)+(p2+p3))+p4; 2-3: an
  FMA chain; other widths: `torch.matmul`), and its W gradient xᵀg the
  FMA chain over the rows in ascending order.
Each mirrors the CPU reference, so each runs only on CPU tensors; on a
CUDA tensor it is the torch op (element-by-element orders cost launches
on the card).  `xla_cpu_order` is that one device choice, for this
module and for the merge (`core.aggregate.apply_selection`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

XLA_REDUCE_WINDOW = 32


def xla_cpu_order(t: torch.Tensor) -> bool:
    """Whether float32 arithmetic on `t` takes XLA:CPU's orders: on a CPU
    tensor, yes (the reference the port is held to runs there); on a
    CUDA tensor, no, the torch op runs: mirroring an order costs a launch
    an element on the card (`xla_sum`'s alone made config 1's card round
    ~3x slower)."""
    return not t.is_cuda


def xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.sum(x, axis=dim)` of a float32 tensor, in XLA:CPU's order
    (`torch.sum` where not `xla_cpu_order`)."""
    if not xla_cpu_order(x):
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


def _f32(v: float) -> float:
    """A Python number rounded to float32."""
    return float(np.float32(v))


_MIN_NORMAL = _f32(1.1754944e-38)


def _f64(v) -> torch.Tensor:
    """A float32 tensor, or a Python number rounded to float32, as float64."""
    if isinstance(v, torch.Tensor):
        return v.double()
    return torch.tensor(_f32(v), dtype=torch.float64)


def fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (a CPU tensor among the operands).
    a * b is exact in float64 and s = a * b + c rounds once; rounding s
    to float32 is then right unless s is a float32 midpoint and the
    exact sum is not, which TwoSum's error term e tells: a nonzero e
    decides the tie toward its own side."""
    p = _f64(a) * _f64(b)
    c64 = _f64(c)
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    rd = r.double()
    toward = torch.where(s > rd, torch.tensor(float("inf")),
                         torch.tensor(float("-inf")))
    q = torch.nextafter(r, toward)       # r's neighbour on s's side
    tie = (s != rd) & ((s - rd) * 2 == q.double() - rd)
    beyond = (e != 0) & ((e > 0) == (s > rd))
    return torch.where(tie & beyond, q, r)


def fma32_(c: torch.Tensor, a, b) -> torch.Tensor:
    """c += a * b in place: rounded once (`fma32`), as XLA:CPU contracts
    it, where `xla_cpu_order`; else torch's `c.add_(a * b)`."""
    if not xla_cpu_order(c):
        return c.add_(a * b)
    return c.copy_(fma32(a, b, c))


_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_LOG2E = 1.44269504088896341
_SQRTHF = 0.707106781186547524


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp` of a float32 tensor as XLA:CPU computes it: n =
    round(x / ln 2), a = x - n ln 2 in two FMA steps, e^a by a degree-6
    Horner polynomial of FMAs, times 2^n built in the exponent bits; a
    subnormal result flushed to 0 (XLA:CPU runs with denormals off)."""
    if not xla_cpu_order(x):
        return torch.exp(x)
    x = x.clamp(_f32(-87.8), _f32(88.8))
    n = torch.floor(fma32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    a = fma32(-_f32(_EXP_C1), n, x)
    a = fma32(-_f32(_EXP_C2), n, a)
    z = fma32(a, _EXP_P[0], _EXP_P[1])
    for coeff in _EXP_P[2:]:
        z = fma32(z, a, coeff)
    z = fma32(z, a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = (1.0 + z) * pow2
    return torch.where(out < _MIN_NORMAL, torch.zeros_like(out), out)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log` of a float32 tensor as XLA:CPU computes it: the mantissa
    m in [sqrt(1/2), sqrt(2)) and exponent e, log(1 + t) of t = m - 1 by
    a degree-8 polynomial in three FMA Horner parts, then e ln 2 added
    in two parts (ln 2 = Q2 - Q1)."""
    if not xla_cpu_order(x):
        return torch.log(x)
    t = torch.maximum(x, torch.tensor(_MIN_NORMAL))
    bits = t.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).to(torch.float32)
    t = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)
    low = t < _f32(_SQRTHF)
    t = (t - 1.0) + torch.where(low, t, torch.zeros_like(t))
    e = e - low.to(torch.float32)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma32(fma32(t, p[0], p[1]), t, p[2])
    y1 = fma32(fma32(t, p[3], p[4]), t, p[5])
    y2 = fma32(fma32(t, p[6], p[7]), t, p[8])
    y = fma32(fma32(y, x3, y1), x3, y2)
    y = fma32(y, x3, _f32(_LOG_Q1) * e)
    t = fma32(-0.5, x2, t) + y
    out = fma32(_f32(_LOG_Q2), e, t)
    out = torch.where(x == float("inf"), x, out)
    out = torch.where(x == 0, torch.tensor(float("-inf")), out)
    return torch.where(x < 0, torch.tensor(float("nan")), out)


class _LogSoftmax(torch.autograd.Function):
    """`jax.nn.log_softmax` over the last axis on XLA:CPU: shifted = x -
    max, logp = shifted - log(sum(exp(shifted))); backward
    fma(-sum(g) / S, exp(shifted), g)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        shifted = x - x.amax(-1, keepdim=True)
        e = xla_exp(shifted)
        total = xla_sum(e, -1).unsqueeze(-1)
        ctx.save_for_backward(e, total)
        return shifted - xla_log(total)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        e, total = ctx.saved_tensors
        ds = -xla_sum(g, -1).unsqueeze(-1) / total
        return fma32(ds.expand_as(e), e, g)


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the last axis: XLA:CPU's on a float32 CPU tensor
    (another dtype, such as the bfloat16 MLP's logits, takes torch's)."""
    if not xla_cpu_order(logits) or logits.dtype != torch.float32:
        return F.log_softmax(logits, dim=-1)
    return _LogSoftmax.apply(logits)


# feature counts whose dot order `xla_matmul` takes (measured on XLA:CPU)
DOT_ORDER_FEATURES = (2, 3, 5)


def _dot_in_order(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., B, F) @ w (..., F, C) in XLA:CPU's order for F."""
    def term(k):
        return x[..., :, k, None], w[..., None, k, :]
    if x.shape[-1] == 5:
        p = [a * b for a, b in map(term, range(5))]
        return ((p[0] + p[1]) + (p[2] + p[3])) + p[4]
    a, b = term(0)
    acc = a * b
    for k in range(1, x.shape[-1]):
        acc = fma32(*term(k), acc)
    return acc


def _rows_fma_chain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """xᵀ g over the rows (axis -2), one FMA a row in ascending order."""
    acc = torch.zeros(x.shape[:-2] + (x.shape[-1], g.shape[-1]),
                      dtype=torch.float32)
    for i in range(x.shape[-2]):
        acc = fma32(x[..., i, :, None], g[..., i, None, :], acc)
    return acc


class _XlaMatmul(torch.autograd.Function):
    """x @ w and its w gradient in XLA:CPU's orders (CPU tensors)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        if x.shape[-1] in DOT_ORDER_FEATURES:
            return _dot_in_order(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = g @ w.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            if w.ndim == 2:              # one model over any leading axes
                x, g = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
            gw = _rows_fma_chain(x, g)
        return gx, gw


def xla_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., B, F) @ w ((..., F, C), or (F, C) for every row): on a CPU
    tensor in XLA:CPU's dot order at F in DOT_ORDER_FEATURES (else
    `torch.matmul`, an order not matched), its w gradient the FMA chain
    over the rows; on a CUDA tensor `torch.matmul`."""
    if not xla_cpu_order(x):
        return x @ w
    return _XlaMatmul.apply(x, w)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels_onehot: torch.Tensor) -> torch.Tensor:
    logp = log_softmax(logits)
    return -xla_mean((labels_onehot * logp).sum(-1))


def accuracy(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(-1)
    true = labels_onehot.argmax(-1)
    return xla_mean((pred == true).to(torch.float32))
