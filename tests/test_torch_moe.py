"""The port's mixture-of-experts transformer against the reference's.

At test_ep_pp's size (vocab 100, seq 16, dim 32, depth 2, 2 heads, 4
experts): the init's keys bit for bit (`utils/prng.split(key, 7)` is
`jax.random.split(key, 7)`) and its values within the normal draw's few
float32 ulp (`tests/test_torch_prng.py`); the dense path's initial
model unchanged (its 6-key split, byte for byte the model the port drew
before the expert bank existed); the forward's logits against the
reference's einsum and `pallas_interpret` paths within 5e-4 relative /
5e-5 absolute (the reference's own pallas-vs-einsum bound; 7e-7 is
measured); one local step's delta within 1e-4 of each leaf's largest
reference value, and its cost within 1e-5 relative (1.4e-6 measured);
`apply_stacked` equal to separate applies (5e-6) and config 5's MoE
parameter count, 1,326,594.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.core.local_train import local_train as ref_local_train
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.utils.serialization import pack_pytree, unpack_pytree
from bflc_demo_tpu_torch.core.local_train import local_train
from bflc_demo_tpu_torch.models import make_transformer_classifier
from bflc_demo_tpu_torch.utils import prng
from bflc_demo_tpu_torch.utils.serialization import hash_pytree

EP = dict(vocab_size=100, seq_len=16, num_classes=2, dim=32, depth=2,
          heads=2, moe_experts=4)
LOGITS = dict(rtol=5e-4, atol=5e-5)
INIT = dict(rtol=2e-6, atol=1e-7)        # prng.normal's few float32 ulp
# the dense config-5 model `init_params(0)` drew before the expert bank
# existed (hash_pytree of its values), which must not move
CONFIG5_INIT_SHA256 = \
    "2194a91b5ff47613fdca56a1ff1a19788cd6ff1a7bcc294cdf46a987e9089ed7"


def _tokens(seed, n=8, s=16, vocab=100):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (n, s)).astype(np.int32)
    for i, length in enumerate(rng.integers(s // 2, s + 1, n)):
        toks[i, length:] = 0
    return toks


def _pair(impl="einsum", seed_head=True):
    ref = ref_transformer(attention_impl=impl, **EP)
    port = make_transformer_classifier(**EP)
    params = ref.init_params(0)
    if seed_head:
        # a non-zero head, so the logits carry the whole network
        head = np.random.default_rng(1).standard_normal(
            params["head_w"].shape).astype(np.float32)
        params = dict(params, head_w=jnp.asarray(head))
    return ref, port, params, port.params_from_jax(params)


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
@pytest.mark.parametrize("num", [6, 7])
def test_split_matches_jax(seed, num):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.key_data(jax.random.split(key, num)))
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num), want)


def test_moe_init_matches_reference():
    ref = ref_transformer(**EP)
    port = make_transformer_classifier(**EP)
    want = unpack_pytree(pack_pytree(ref.init_params(0)))
    got = port.init_params(0)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        np.testing.assert_allclose(v.numpy(), want[k], **INIT, err_msg=k)
    blk = "['blocks'][1]"
    assert got[f"{blk}['we1']"].shape == (4, 32, 128)
    assert got[f"{blk}['router']"].shape == (32, 4)
    assert not got[f"{blk}['wb1']"].any() and not got[f"{blk}['wb2']"].any()
    # the expert bank comes from the block's keys 4-6, the dense MLP's
    # w1/w2 from keys 4-5 of a 6-way split
    blk_key = prng.split(prng.split(prng.PRNGKey(0), 4 + 2)[3], 7)
    np.testing.assert_allclose(
        got[f"{blk}['we2']"].numpy(),
        prng.normal(blk_key[6], (4, 128, 32)) * np.float32(0.02), **INIT)


def test_dense_init_is_unchanged():
    port = make_transformer_classifier()
    params = port.init_params(0)
    assert "['blocks'][0]['w1']" in params
    assert not any("we1" in k for k in params)
    assert hashlib.sha256(hash_pytree(params)).hexdigest() == \
        CONFIG5_INIT_SHA256


def test_moe_parameter_count():
    port = make_transformer_classifier(moe_experts=4)
    assert sum(v.numel() for v in port.init_params(0).values()) == 1_326_594
    ref = ref_transformer(moe_experts=4)
    assert sum(np.size(v) for v in jax.tree_util.tree_leaves(
        ref.init_params(0))) == 1_326_594


@pytest.mark.parametrize("impl", ["einsum", "pallas_interpret"])
def test_moe_logits_match_reference(impl):
    ref, port, params, flat = _pair(impl)
    toks = _tokens(2)
    want = np.asarray(jax.jit(ref.apply)(params, jnp.asarray(toks)))
    got = port.apply(flat, torch.as_tensor(toks).long())
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGITS)


def test_moe_local_step_matches_reference():
    ref, port, params, flat = _pair()
    toks = _tokens(4)
    y = np.eye(2, dtype=np.float32)[np.random.default_rng(5)
                                    .integers(0, 2, len(toks))]
    want, want_cost = ref_local_train(ref.apply, params, jnp.asarray(toks),
                                      jnp.asarray(y), lr=0.05,
                                      batch_size=4)
    want = unpack_pytree(pack_pytree(want))
    got, cost = local_train(port, flat, torch.as_tensor(toks).long(),
                            torch.as_tensor(y), 0.05, 4)
    for k, v in got.items():
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=1e-5)


def test_moe_apply_stacked_equals_separate_applies():
    _, port, _, flat = _pair()
    rng = np.random.default_rng(7)
    models = [{k: v + torch.as_tensor(rng.standard_normal(tuple(v.shape))
                                      .astype(np.float32)) * 0.01
               for k, v in flat.items()} for _ in range(3)]
    toks = torch.as_tensor(np.stack([_tokens(s, n=5) for s in range(3)]))
    stacked = {k: torch.stack([m[k] for m in models]) for k in flat}
    got = port.apply_stacked(stacked, toks.long())
    for g, m in enumerate(models):
        np.testing.assert_allclose(
            got[g].detach().numpy(),
            port.apply(m, toks[g].long()).detach().numpy(),
            rtol=5e-6, atol=5e-6)
