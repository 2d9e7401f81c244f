"""The port's flash attention against the reference Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode, as
tests/test_pallas_attention.py does.  Same numpy-seeded inputs go through
both.  Tolerances: float32 results differ only in summation order, so
the reference test's own 2e-5 (forward) and 1e-4 (gradients) hold;
bfloat16 results round p, dS and the outputs to 8 mantissa bits at the
same places in both, so they agree to a couple of bf16 ulps (2e-2).

The kernels themselves run only on a card: tests/test_torch_kernels_cuda.py
compares each CUDA kernel with its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.ops import pallas_attention as ref
from bflc_demo_tpu_torch.ops import flash_attention as fa

F32_FWD = dict(rtol=2e-5, atol=2e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, b=2, s=64, h=4, d=32, pad_from=None):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((b, s), bool)
    for i, start in enumerate(pad_from or []):
        mask[i, start:] = False
    return q, k, v, g, mask


def _t(x, dtype=torch.float32):
    t = torch.tensor(np.array(x))
    return t if t.dtype == torch.bool else t.to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype) if x.dtype != bool else jnp.asarray(x)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _port_vjp(q, k, v, mask, g, block, dtype=torch.float32):
    qt, kt, vt = (_t(a, dtype).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, _t(mask), block, block)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), _t(g, dtype))
    return out, dq, dk, dv


def _ref_vjp(q, k, v, mask, g, block, dtype=jnp.float32):
    fn = lambda q_, k_, v_: ref.flash_attention(  # noqa: E731
        q_, k_, v_, _j(mask), block, block, True)
    out, vjp = jax.vjp(fn, _j(q, dtype), _j(k, dtype), _j(v, dtype))
    return (out, *vjp(_j(g, dtype)))


class TestForward:
    @pytest.mark.parametrize("block", [16, 32, 64])
    def test_out_and_lse_match_pallas(self, block):
        q, k, v, _, mask = _inputs(0, pad_from=[50, 23])
        out, lse = fa.flash_fwd(_t(q), _t(k), _t(v), _t(mask))
        want_out, want_lse = ref._flash_fwd_impl(
            _j(q), _j(k), _j(v), _j(mask), block, block, True)
        assert lse.shape == want_lse.shape == (8, 1, 64)
        np.testing.assert_allclose(_f32(out), _f32(want_out), **F32_FWD)
        np.testing.assert_allclose(_f32(lse), _f32(want_lse), **F32_FWD)

    def test_padding_mask(self):
        """PAD keys excluded exactly; a PAD key's value is invisible."""
        q, k, v, _, mask = _inputs(1, pad_from=[40, 40])
        got, _ = fa.flash_fwd(_t(q), _t(k), _t(v), _t(mask))
        want = ref.flash_attention(_j(q), _j(k), _j(v), _j(mask), 16, 16,
                                   True)
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_FWD)
        k[:, 50], v[:, 50] = 999.0, -999.0
        got2, _ = fa.flash_fwd(_t(q), _t(k), _t(v), _t(mask))
        np.testing.assert_array_equal(_f32(got2), _f32(got))

    def test_block_fully_masked(self):
        """A whole 16-key block of PAD: finite, equal to the reference."""
        q, k, v, _, mask = _inputs(2)
        mask[:, 16:32] = False
        out, lse = fa.flash_fwd(_t(q), _t(k), _t(v), _t(mask))
        want_out, want_lse = ref._flash_fwd_impl(
            _j(q), _j(k), _j(v), _j(mask), 16, 16, True)
        assert np.isfinite(_f32(out)).all()
        np.testing.assert_allclose(_f32(out), _f32(want_out), **F32_FWD)
        np.testing.assert_allclose(_f32(lse), _f32(want_lse), **F32_FWD)

    def test_row_fully_masked(self):
        """Every key of a batch row is PAD: out is 0 and lse sits at the
        clamp floor, as in the reference, with no NaN anywhere."""
        q, k, v, g, mask = _inputs(3, b=2, s=32, h=2, d=16)
        mask[1, :] = False
        out, dq, dk, dv = _port_vjp(q, k, v, mask, g, 16)
        _, want_lse = ref._flash_fwd_impl(_j(q), _j(k), _j(v), _j(mask),
                                          16, 16, True)
        _, lse = fa.flash_fwd(_t(q), _t(k), _t(v), _t(mask))
        assert np.all(_f32(out)[1] == 0.0)
        np.testing.assert_allclose(_f32(lse), _f32(want_lse), rtol=1e-6)
        for grad in (dq, dk, dv):
            assert np.isfinite(_f32(grad)).all()
            assert np.all(_f32(grad)[1] == 0.0)

    def test_bf16_forward(self):
        q, k, v, _, mask = _inputs(4, b=1, s=32, h=2, d=16, pad_from=[27])
        out, lse = fa.flash_fwd(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                _t(v, torch.bfloat16), _t(mask))
        want_out, want_lse = ref._flash_fwd_impl(
            _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
            _j(mask), 16, 16, True)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        np.testing.assert_allclose(_f32(out), _f32(want_out), **BF16)
        np.testing.assert_allclose(_f32(lse), _f32(want_lse), **BF16)

    def test_bad_block_size_rejected(self):
        q, k, v, _, _ = _inputs(5, s=60)
        with pytest.raises(ValueError, match="must divide blocks"):
            fa.flash_attention(_t(q), _t(k), _t(v),
                               torch.ones((2, 60), dtype=torch.bool), 16, 16)

    def test_bad_inputs_rejected(self):
        q, k, v, _, mask = _inputs(6, b=1, s=16, h=2, d=16)
        with pytest.raises(ValueError, match="kv_mask"):
            fa.flash_fwd(_t(q), _t(k), _t(v), _t(mask).int())
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fa.flash_fwd(_t(q, torch.float64), _t(k, torch.float64),
                         _t(v, torch.float64), _t(mask))


class TestBackward:
    def test_dkdv_and_dq_kernels_match_pallas(self):
        """K2 and K3 on the reference's residuals (out, lse, dO)."""
        q, k, v, g, mask = _inputs(7, pad_from=[50, 23])
        out, lse = ref._flash_fwd_impl(_j(q), _j(k), _j(v), _j(mask),
                                       16, 16, True)
        want_dq, want_dk, want_dv = ref._flash_bwd_impl(
            _j(q), _j(k), _j(v), _j(mask), out, lse, _j(g), 16, 16, True)
        out_t, lse_t = _t(np.asarray(out)), _t(np.asarray(lse))
        delta = fa.attention_delta(_t(g), out_t)
        dk, dv = fa.flash_dkdv(_t(q), _t(k), _t(v), _t(mask), _t(g), lse_t,
                               delta)
        dq = fa.flash_dq(_t(q), _t(k), _t(v), _t(mask), _t(g), lse_t, delta)
        for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
            np.testing.assert_allclose(_f32(got), _f32(want), **F32_GRAD)

    def test_gradients_match_jax_vjp_multiblock(self):
        """Blockwise dq/dk/dv across 4x4 16-blocks with ragged padding,
        through the autograd Function, against jax.vjp of the kernel."""
        q, k, v, g, mask = _inputs(8, pad_from=[50, 23])
        got = _port_vjp(q, k, v, mask, g, 16)
        want = _ref_vjp(q, k, v, mask, g, 16)
        np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), **F32_FWD)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(_f32(a), _f32(b), **F32_GRAD)

    def test_pad_positions_get_zero_grad(self):
        q, k, v, g, mask = _inputs(9, b=1, s=32, h=2, d=16, pad_from=[16])
        _, dq, dk, dv = _port_vjp(q, k, v, mask, g, 16)
        assert np.all(_f32(dk)[:, 16:] == 0.0)
        assert np.all(_f32(dv)[:, 16:] == 0.0)
        assert np.isfinite(_f32(dq)).all()

    def test_gradients_bf16(self):
        q, k, v, g, mask = _inputs(10, b=1, s=32, h=2, d=16)
        got = _port_vjp(q, k, v, mask, g, 16, torch.bfloat16)
        want = _ref_vjp(q, k, v, mask, g, 16, jnp.bfloat16)
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(_f32(a), _f32(b), **BF16)
