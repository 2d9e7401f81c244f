"""The port's transformer against the reference model on the same params.

The reference params come from `init_params` (jax.random) and enter the
port through `params_from_jax`; tokens are numpy-seeded.  Tolerance: the
two run the same float32 arithmetic in different orders (XLA vs ATen
matmuls, layer norm and softmax), which agrees to ~1e-6 relative at these
widths; 5e-4 relative / 5e-5 absolute is the reference's own bound for
its pallas-vs-einsum logits (tests/test_pallas_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.core.losses import softmax_cross_entropy as ref_ce
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.utils.serialization import unpack_pytree, pack_pytree
from bflc_demo_tpu_torch.core.losses import softmax_cross_entropy
from bflc_demo_tpu_torch.models import make_transformer_classifier

LOGITS = dict(rtol=5e-4, atol=5e-5)
SMALL = dict(vocab_size=100, seq_len=32, num_classes=3, dim=32, depth=1,
             heads=2)


def _tokens(seed, n=4, s=32, vocab=100):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (n, s)).astype(np.int32)
    for i, length in enumerate(rng.integers(s // 2, s + 1, n)):
        toks[i, length:] = 0
    return toks


def _pair(impl="einsum", **kw):
    cfg = dict(SMALL, **kw)
    ref = ref_transformer(attention_impl=impl, **cfg)
    port = make_transformer_classifier(**cfg)
    params = ref.init_params(0)
    return ref, port, params, port.params_from_jax(params)


@pytest.mark.parametrize("impl", ["einsum", "pallas_interpret"])
def test_logits_match_reference(impl):
    ref, port, params, flat = _pair(impl)
    # a non-zero head, so the logits carry the whole network
    rng = np.random.default_rng(1)
    head = rng.standard_normal(params["head_w"].shape).astype(np.float32)
    params = dict(params, head_w=jnp.asarray(head))
    flat["['head_w']"] = torch.as_tensor(head)
    toks = _tokens(2)
    want = np.asarray(jax.jit(ref.apply)(params, jnp.asarray(toks)))
    got = port.apply(flat, torch.as_tensor(toks).long())
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGITS)


def test_odd_sequence_length_uses_the_reference_block():
    """S = 24 takes block 8 in both; logits still agree."""
    ref, port, params, flat = _pair(seq_len=24)
    toks = _tokens(3, s=24)
    want = np.asarray(jax.jit(ref.apply)(params, jnp.asarray(toks)))
    got = port.apply(flat, torch.as_tensor(toks).long())
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGITS)


def test_loss_gradient_matches_jax_grad():
    ref, port, params, flat = _pair()
    toks = _tokens(4)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(5)
                                    .integers(0, 3, len(toks))]
    grads = jax.jit(jax.grad(lambda p: ref_ce(
        ref.apply(p, jnp.asarray(toks)), jnp.asarray(y))))(params)
    want = unpack_pytree(pack_pytree(grads))
    work = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss = softmax_cross_entropy(port.apply(work, torch.as_tensor(toks)
                                            .long()), torch.as_tensor(y))
    got = dict(zip(work, torch.autograd.grad(loss, list(work.values()))))
    assert set(got) == set(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def test_own_init_follows_reference_distributions():
    """The port's own init: the reference's shapes, ones and zeros where
    it has them, N(0, 0.02) elsewhere; its values are the reference's
    (tests/test_torch_prng.py)."""
    ref, port, params, flat = _pair()
    mine = port.init_params(0)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in flat.items()}
    for k, v in mine.items():
        if k.endswith("['scale']"):
            assert torch.all(v == 1)
        elif k.endswith(("['bias']", "['b1']", "['b2']", "['head_w']",
                         "['head_b']")):
            assert torch.all(v == 0)
        else:
            assert abs(float(v.std()) - 0.02) < 0.004, k
    again = port.init_params(0)
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    other = port.init_params(1)
    assert not torch.equal(mine["['embed']"], other["['embed']"])
