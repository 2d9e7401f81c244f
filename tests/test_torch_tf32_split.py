"""The accuracy argument of the kernels' 3xTF32 products, on the CPU.

The four flash kernels (`bflc_demo_tpu_torch/ops/csrc/
flash_attention.cu`) multiply float32 operands on the tensor cores as
3xTF32: x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
hi), and a . b = hi.lo + lo.hi + hi.hi, each product exact and the sums
in float32.  Here that arithmetic is emulated with numpy bit operations
(TF32 rounding) and float32 torch products, and attention and its
gradients built from it are held against the port's plain versions
(`flash_fwd_plain`, `flash_carry_plain`, `flash_dkdv_plain`,
`flash_dq_plain`, full float32) within the float32 tolerance
`chip_smoke.py` holds the kernels to: 1e-4 x max(1, max |plain|).  TF32
alone (hi.hi) errs at least 10x more, on a par with that tolerance,
which is why the kernels split every float32 operand.  The kernels'
launch geometry (`block_warps` and `launch_warps`, pure functions of the
shape) is checked here too.

Shapes: config 5's training batch (16, 64, 4, 32) and a 1024-key shard
(2, 1024, 4, 32) with ragged keys and one fully masked 64-key tile.
"""

import numpy as np
import pytest
import torch

from bflc_demo_tpu_torch.ops import flash_attention as fa

SMOKE_F32_TOL = 1e-4                     # chip_smoke.py's TOL["float32"]
SHAPES = [(16, 64, 4, 32), (2, 1024, 4, 32)]


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with
    ties away from zero (adding half of the dropped 13 bits' unit to the
    magnitude, then truncating)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x.numpy())
    lo = tf32_rna(x.numpy() - hi)
    return torch.from_numpy(hi), torch.from_numpy(lo)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int):
    """einsum(eq, a, b) as the tensor cores run it: 3 passes = 3xTF32
    (small terms first), 1 pass = TF32 alone."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)) \
        + torch.einsum(eq, ah, bh)


def emulated_step(q, k, v, kv_mask, acc, m, l, passes: int):
    """flash_carry_plain's arithmetic with emulated TF32 products."""
    b, sq, h, d = q.shape
    s = product("bqhd,bkhd->bhqk", q, k, passes) * fa._scale(d)
    valid = kv_mask[:, None, None, :]
    s = torch.where(valid, s, fa.NEG_INF)
    m = m.reshape(b, h, sq)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l.reshape(b, h, sq) * corr + p.sum(-1)
    acc_new = acc.reshape(b, h, sq, d) * corr[..., None] + product(
        "bhqk,bkhd->bhqd", p, v, passes)
    return acc_new, m_new, l_new


def emulated_forward(q, k, v, kv_mask, passes: int):
    b, sq, h, d = q.shape
    acc, m, l = emulated_step(q, k, v, kv_mask,
                              torch.zeros(b * h, sq, d),
                              torch.full((b * h, 1, sq), fa.NEG_INF),
                              torch.zeros(b * h, 1, sq), passes)
    l = l.clamp_min(fa.TINY)
    out = (acc / l[..., None]).permute(0, 2, 1, 3)
    return out, (m + torch.log(l)).reshape(b * h, 1, sq)


def emulated_backward(q, k, v, kv_mask, do, lse, delta, passes: int):
    """flash_dkdv_plain's and flash_dq_plain's arithmetic with emulated
    TF32 products, dS rounded to q's dtype before the products that take
    it: (dK, dV, dQ)."""
    b, sq, h, d = q.shape
    scale = fa._scale(d)
    s = product("bqhd,bkhd->bhqk", q, k, passes) * scale
    p = torch.where(kv_mask[:, None, None, :],
                    torch.exp(s - lse.reshape(b, h, sq, 1)), 0.0)
    dp = product("bqhd,bkhd->bhqk", do, v, passes)
    ds = (p * (dp - delta.reshape(b, h, sq, 1)) * scale).to(q.dtype)
    return (product("bhqk,bqhd->bkhd", ds, q, passes),
            product("bhqk,bqhd->bkhd", p.to(do.dtype), do, passes),
            product("bhqk,bkhd->bqhd", ds, k, passes))


def _inputs(shape, seed):
    b, s, _, _ = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)) for _ in range(3))
    mask = np.arange(s)[None, :] < rng.integers(s // 2, s + 1, b)[:, None]
    if s > 64:
        mask[0, 64:128] = False
    return q, k, v, torch.from_numpy(mask)


def _err_and_tol(got, want):
    err = scale = 0.0
    for a, w in zip(got, want):
        err = max(err, float((a - w).abs().max()))
        scale = max(scale, float(w[w > fa.NEG_INF / 2].abs().max()))
    return err, SMOKE_F32_TOL * max(1.0, scale)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                 # TF32's unit at 1.0
    x = np.array([1.0, 1 + one_ulp / 2, -(1 + one_ulp / 2),
                  1 + one_ulp / 4, 1 + 3 * one_ulp / 4, 0.0, -3.5],
                 np.float32)
    np.testing.assert_array_equal(
        tf32_rna(x), np.array([1.0, 1 + one_ulp, -(1 + one_ulp), 1.0,
                               1 + one_ulp, 0.0, -3.5], np.float32))
    y = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi = tf32_rna(y)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert np.abs(hi - y).max() <= 2.0 ** -11 * np.abs(y).max()
    lo = tf32_rna(y - hi)
    # hi + lo keeps ~22 significant bits
    assert np.abs(hi.astype(np.float64) + lo - y).max() \
        <= 2.0 ** -21 * np.abs(y).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_3xtf32_within_tolerance_tf32_alone_10x_worse(shape):
    q, k, v, mask = _inputs(shape, seed=21)
    want = fa.flash_fwd_plain(q, k, v, mask)
    err3, tol = _err_and_tol(emulated_forward(q, k, v, mask, 3), want)
    err1, _ = _err_and_tol(emulated_forward(q, k, v, mask, 1), want)
    assert err3 <= tol
    assert err1 >= 10 * err3


@pytest.mark.parametrize("shape", SHAPES)
def test_carry_3xtf32_within_tolerance_tf32_alone_10x_worse(shape):
    b, s, h, d = shape
    q, k1, v1, m1 = _inputs(shape, seed=22)
    _, k2, v2, m2 = _inputs(shape, seed=23)
    m2[-1] = False                       # a hop with no valid key
    carry = fa.flash_carry_plain(
        q, k1, v1, m1, torch.zeros(b * h, s, d),
        torch.full((b * h, 1, s), fa.NEG_INF), torch.zeros(b * h, 1, s))
    want = fa.flash_carry_plain(q, k2, v2, m2, *carry)
    want = (want[0].reshape(b, h, s, d), want[1].reshape(b, h, s),
            want[2].reshape(b, h, s))
    err3, tol = _err_and_tol(emulated_step(q, k2, v2, m2, *carry, 3), want)
    err1, _ = _err_and_tol(emulated_step(q, k2, v2, m2, *carry, 1), want)
    assert err3 <= tol
    assert err1 >= 10 * err3


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_3xtf32_within_tolerance_tf32_alone_10x_worse(shape):
    q, k, v, mask = _inputs(shape, seed=24)
    do = torch.from_numpy(np.random.default_rng(25).standard_normal(shape)
                          .astype(np.float32))
    out, lse = fa.flash_fwd_plain(q, k, v, mask)
    delta = fa.attention_delta(do, out)
    want = fa.flash_dkdv_plain(q, k, v, mask, do, lse, delta) + (
        fa.flash_dq_plain(q, k, v, mask, do, lse, delta),)
    args = (q, k, v, mask, do, lse, delta)
    err3, tol = _err_and_tol(emulated_backward(*args, 3), want)
    err1, _ = _err_and_tol(emulated_backward(*args, 1), want)
    assert err3 <= tol
    assert err1 >= 10 * err3


@pytest.mark.parametrize("batch_heads,s_q,warps", [
    (64, 64, 1),                         # config-5 training: 256 blocks
    (640, 64, 4),                        # config-5 scoring (B = 160)
    (128, 1024, 4),                      # the sp training shard
    (16, 8192, 4),                       # the 8k sequence unsharded
    (8, 1024, 2),                        # 4 warps would give 128 blocks
    (64, 512, 4),
    (16, 256, 1),
    (1, 64, 1),                          # too small to fill the card
])
def test_fwd_warps_by_shape(batch_heads, s_q, warps):
    assert fa.block_warps(batch_heads, s_q, 132) == warps


def test_config5_training_grid_fills_the_card():
    warps = fa.block_warps(16 * 4, 64, 132)
    blocks = 16 * 4 * -(-64 // (fa.WARP_ROWS * warps))
    assert blocks >= 132                 # the first body's grid gave 64


@pytest.mark.parametrize("kernel,q_shape,s_kv,warps", [
    # config-5 training: 256 one-warp blocks each
    ("flash_dkdv", (16, 64, 4, 32), 64, 1),
    ("flash_dq", (16, 64, 4, 32), 64, 1),
    # the sp dense oracle's sequence: 2048 four-warp blocks each
    ("flash_dkdv", (4, 8192, 4, 32), 8192, 4),
    ("flash_dq", (4, 8192, 4, 32), 8192, 4),
    # four warps would give 128 blocks
    ("flash_dkdv", (2, 1024, 4, 32), 1024, 2),
    ("flash_dq", (2, 1024, 4, 32), 1024, 2),
    # S_kv != S_q: dK/dV's warps own keys, dQ's and the forward's queries
    ("flash_dkdv", (2, 64, 4, 32), 4096, 4),
    ("flash_dq", (2, 64, 4, 32), 4096, 1),
    ("flash_fwd", (2, 64, 4, 32), 4096, 1),
    ("flash_dkdv", (2, 4096, 4, 32), 64, 1),
    ("flash_dq", (2, 4096, 4, 32), 64, 4),
])
def test_backward_warps_by_shape(kernel, q_shape, s_kv, warps):
    assert fa.launch_warps(kernel, q_shape, s_kv, 132) == warps


@pytest.mark.parametrize("kernel", ["flash_dkdv", "flash_dq"])
def test_config5_backward_grid_fills_the_card(kernel):
    b, s, h, d = 16, 64, 4, 32
    warps = fa.launch_warps(kernel, (b, s, h, d), s, 132)
    blocks = b * h * -(-s // (fa.WARP_ROWS * warps))
    assert blocks >= 132                 # the first design's grid gave 64
