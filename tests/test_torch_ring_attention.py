"""The port's carry step and ring attention against the JAX package.

- `flash_carry_plain` (the CPU side of the carry kernel's wrapper)
  against the reference's `flash_attention_carry` in interpret mode, as
  tests/test_pallas_attention.py runs it: from a zero carry and chained
  over two hops, float32 and bfloat16, with a fully masked key tile and
  with more keys than queries.
- The folded `ring_attention` (impl "einsum", and "pallas" whose hops run
  `flash_carry`, its plain version here) against the reference's
  `ring_attention` under `shard_map` on the virtual CPU mesh, for n_sp in
  {2, 4}, as tests/test_ring_attention.py:50-69 does.
- The `RingAttention` backward's (dq, dk, dv) against `jax.vjp` of the
  reference's pallas ring (its custom vjp recomputes with the einsum
  ring, as the port's backward does).

Inputs come from a numpy seed and reach both sides as the same arrays.
Tolerances: float32 results differ only in summation order — the kernel
streams key tiles, the plain version sums all keys at once — so the
reference's own ring bounds hold (2e-5 forward, 1e-4 gradients,
tests/test_ring_attention.py:69, :94).  In bfloat16 both round p to
bfloat16 before the PV product, the reference against each tile's
running max and the plain version against the hop's, so they agree to a
couple of bf16 ulps (2e-2, the port's kernel tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bflc_demo_tpu.ops import pallas_attention as ref_pa
from bflc_demo_tpu.parallel.mesh import make_mesh
from bflc_demo_tpu.parallel.ring_attention import SP_AXIS as SP
from bflc_demo_tpu.parallel.ring_attention import \
    ring_attention as ref_ring_attention
from bflc_demo_tpu.utils.compat import shard_map
from bflc_demo_tpu_torch.ops import flash_attention as fa
from bflc_demo_tpu_torch.parallel import FoldedAxis
from bflc_demo_tpu_torch.parallel.ring_attention import (RingAttention,
                                                         ring_attention)

F32_FWD = dict(rtol=2e-5, atol=2e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _carry_inputs(seed, b=2, sq=32, skv=32, h=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32)
            for _ in range(2))
    mask = np.ones((b, skv), bool)
    mask[0, 16:32] = False              # one fully masked 16-key tile
    mask[1, skv - 5:] = False           # a ragged tail
    return q, k, v, mask


def _zero_carry(b, sq, h, d):
    return (np.zeros((b * h, sq, d), np.float32),
            np.full((b * h, 1, sq), fa.NEG_INF, np.float32),
            np.zeros((b * h, 1, sq), np.float32))


def _port_hop(q, k, v, mask, carry, dtype):
    qt, kt, vt = (torch.as_tensor(a).to(dtype) for a in (q, k, v))
    out = fa.flash_carry(qt, kt, vt, torch.as_tensor(mask),
                         *(torch.as_tensor(np.array(c)) for c in carry))
    return [o.numpy() for o in out]


def _ref_hop(q, k, v, mask, carry, dtype, block=16):
    out = ref_pa.flash_attention_carry(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), jnp.asarray(mask),
        *(jnp.asarray(c) for c in carry), block_q=block, block_k=block,
        interpret=True)
    return [np.asarray(o) for o in out]


def _close_carry(got, want, tol):
    """acc, m and l; m holds NEG_INF exactly where no key was valid."""
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


class TestCarryStep:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("skv", [32, 48])      # S_kv = S_q and > S_q
    def test_zero_carry_matches_pallas(self, dtype, skv):
        q, k, v, mask = _carry_inputs(0, skv=skv)
        carry = _zero_carry(2, 32, 2, 16)
        got = _port_hop(q, k, v, mask, carry, getattr(torch, dtype))
        want = _ref_hop(q, k, v, mask, carry, getattr(jnp, dtype))
        _close_carry(got, want, F32_FWD if dtype == "float32" else BF16)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_chained_two_hops_match_pallas(self, dtype):
        """Hop 2 resumes from hop 1's carry (the reference's, on both
        sides, so each hop is held on equal inputs)."""
        q, k1, v1, m1 = _carry_inputs(1, skv=48)
        _, k2, v2, m2 = _carry_inputs(2, skv=48)
        m2[1, :] = False                           # a fully masked hop
        tol = F32_FWD if dtype == "float32" else BF16
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        carry = _zero_carry(2, 32, 2, 16)
        want1 = _ref_hop(q, k1, v1, m1, carry, jdt)
        _close_carry(_port_hop(q, k1, v1, m1, carry, tdt), want1, tol)
        want2 = _ref_hop(q, k2, v2, m2, want1, jdt)
        _close_carry(_port_hop(q, k2, v2, m2, want1, tdt), want2, tol)
        # batch row 1 saw no key in hop 2: its m and l carry over
        rows = slice(2, 4)
        np.testing.assert_array_equal(want2[1][rows], want1[1][rows])

    def test_all_masked_then_real_hop(self):
        """A hop with no valid key leaves m at NEG_INF and l, acc at 0
        (p selected to 0, never exp(0) = 1); the next real hop rescales
        through corr = 0 and ends finite."""
        q, k, v, mask = _carry_inputs(3)
        carry = _zero_carry(2, 32, 2, 16)
        empty = np.zeros_like(mask)
        got = _port_hop(q, k, v, empty, carry, torch.float32)
        np.testing.assert_array_equal(got[1], carry[1])
        assert not got[0].any() and not got[2].any()
        got2 = _port_hop(q, k, v, mask, got, torch.float32)
        want2 = _ref_hop(q, k, v, mask, _ref_hop(q, k, v, empty, carry,
                                                 jnp.float32), jnp.float32)
        _close_carry(got2, want2, F32_FWD)
        assert all(np.isfinite(t).all() for t in got2)

    def test_bad_carry_rejected(self):
        q, k, v, mask = _carry_inputs(4)
        acc, m, l = (torch.as_tensor(c) for c in _zero_carry(2, 32, 2, 16))
        args = [torch.as_tensor(a) for a in (q, k, v, mask)]
        with pytest.raises(ValueError, match="acc must be float32"):
            fa.flash_carry(*args, acc.double(), m, l)
        with pytest.raises(ValueError, match="m must be float32"):
            fa.flash_carry(*args, acc, m[:, :, :16], l)


def _ring_qkv(seed, b=2, s=64, h=2, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), bool)
    mask[:, 50:] = False                # the last shard(s) partly or all PAD
    mask[1, 5:20] = False
    return q, k, v, mask


def _fold(a, n):
    """(B, S, ...) -> (n*B, S/n, ...), shard-major, as FoldedAxis.shard."""
    b, s = a.shape[:2]
    return np.ascontiguousarray(
        a.reshape(b, n, s // n, *a.shape[2:]).swapaxes(0, 1)
        .reshape(n * b, s // n, *a.shape[2:]))


def _unfold(a, n):
    nb, sb = a.shape[:2]
    b = nb // n
    return a.reshape(n, b, sb, *a.shape[2:]).swapaxes(0, 1).reshape(
        b, n * sb, *a.shape[2:])


def _ref_ring_fn(n_sp, impl):
    mesh = make_mesh((n_sp,), (SP,))

    def body(q_, k_, v_, m_):
        return ref_ring_attention(q_, k_, v_, m_, SP, impl=impl)
    spec = P(None, SP)
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                             out_specs=spec, check_vma=False))


class TestRing:
    @pytest.mark.parametrize("impl,ref_impl", [("einsum", "einsum"),
                                               ("pallas", "pallas_interpret")])
    @pytest.mark.parametrize("n_sp", [2, 4])
    def test_folded_ring_matches_shard_map(self, n_sp, impl, ref_impl):
        q, k, v, mask = _ring_qkv(13)
        want = np.asarray(_ref_ring_fn(n_sp, ref_impl)(
            *(jnp.asarray(a) for a in (q, k, v, mask))))
        axis = FoldedAxis(n_sp, 2, "cpu")
        got = ring_attention(*(torch.as_tensor(_fold(a, n_sp))
                               for a in (q, k, v, mask)), axis, impl=impl)
        np.testing.assert_allclose(_unfold(got.numpy(), n_sp), want,
                                   **F32_FWD)

    def test_pallas_ring_uses_the_carry_step_per_hop(self, monkeypatch):
        calls = []
        inner = fa.flash_carry

        def counted(*args):
            calls.append(args[0].shape)
            return inner(*args)
        monkeypatch.setattr(
            "bflc_demo_tpu_torch.parallel.ring_attention.flash_carry",
            counted)
        q, k, v, mask = (torch.as_tensor(_fold(a, 4))
                         for a in _ring_qkv(3))
        ring_attention(q, k, v, mask, FoldedAxis(4, 2, "cpu"), impl="pallas")
        assert calls == [(8, 16, 2, 16)] * 4

    def test_backward_matches_jax_vjp(self):
        n_sp = 2
        q, k, v, mask = _ring_qkv(14, s=32)
        g = np.random.default_rng(15).standard_normal(q.shape) \
            .astype(np.float32)
        fn = _ref_ring_fn(n_sp, "pallas_interpret")
        _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, jnp.asarray(mask)),
                         *(jnp.asarray(a) for a in (q, k, v)))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]

        leaves = [torch.as_tensor(_fold(a, n_sp)).requires_grad_(True)
                  for a in (q, k, v)]
        out = RingAttention.apply(*leaves, torch.as_tensor(_fold(mask, n_sp)),
                                  FoldedAxis(n_sp, 2, "cpu"))
        got = torch.autograd.grad(out, leaves,
                                  torch.as_tensor(_fold(g, n_sp)))
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(_unfold(a.numpy(), n_sp), b,
                                       err_msg=f"d{name}", **F32_GRAD)

    def test_bad_impl_rejected(self):
        t = torch.zeros((1, 8, 1, 8))
        with pytest.raises(ValueError, match="impl"):
            ring_attention(t, t, t, torch.ones((1, 8), dtype=torch.bool),
                           FoldedAxis(1, 1, "cpu"), impl="nope")

    @pytest.mark.parametrize("s", [4, 12])
    def test_shard_without_usable_tile_rejected(self, s):
        """The reference's block rule: 128 halved until it divides the
        shard; below 8 there is no kernel tile (4 -> 4, 12 -> 4)."""
        t = torch.zeros((2, s, 1, 8))
        with pytest.raises(ValueError, match="no usable kernel tile"):
            ring_attention(t, t, t, torch.ones((2, s), dtype=torch.bool),
                           FoldedAxis(2, 1, "cpu"), impl="pallas")
