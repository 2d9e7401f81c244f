"""The port's FL math against `bflc_demo_tpu.core` on the same inputs:
local training (delta and avg_cost), candidate scoring, held-out
accuracy, and the ledger-decided weighted merge.

Tolerances: one SGD step agrees to float32 rounding (~1e-7 relative);
`delta = (p_in - p_out) / lr` divides that by lr = 0.05 and ten steps
compound it, so deltas are held to 1e-4 absolute against entries of
order 0.1-1.  Accuracies are fractions of a shard and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu import core as ref_core
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.utils.serialization import pack_pytree, unpack_pytree
from bflc_demo_tpu_torch import core
from bflc_demo_tpu_torch.models import make_transformer_classifier

CFG = dict(vocab_size=64, seq_len=16, num_classes=2, dim=16, depth=1,
           heads=2)


@pytest.fixture(scope="module")
def setup():
    ref = ref_transformer(attention_impl="einsum", **CFG)
    port = make_transformer_classifier(**CFG)
    params = ref.init_params(0)
    rng = np.random.default_rng(0)
    x = rng.integers(1, 64, (40, 16)).astype(np.int32)
    x[::3, 10:] = 0
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 40)]
    return ref, port, params, port.params_from_jax(params), x, y


def _flat(tree):
    return unpack_pytree(pack_pytree(tree))


def test_local_train_delta_and_cost(setup):
    ref, port, params, flat, x, y = setup
    want_delta, want_cost = ref_core.local_train(
        ref.apply, params, jnp.asarray(x), jnp.asarray(y), lr=0.05,
        batch_size=8, local_epochs=2)
    delta, cost = core.local_train(port, flat, torch.as_tensor(x).long(),
                                   torch.as_tensor(y), lr=0.05,
                                   batch_size=8, local_epochs=2)
    want = _flat(want_delta)
    assert set(delta) == set(want)
    for k in want:
        np.testing.assert_allclose(delta[k].numpy(), want[k], atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=1e-5)
    # the input params are untouched
    assert all(torch.equal(flat[k], v) for k, v in
               port.params_from_jax(params).items())


def test_local_train_rejects_what_is_not_ported(setup):
    _, port, _, flat, x, y = setup
    xt, yt = torch.as_tensor(x).long(), torch.as_tensor(y)
    with pytest.raises(ValueError, match="batch_size"):
        core.local_train(port, flat, xt[:4], yt[:4], 0.05, 8)
    # local optimizers are ported (core/optim.py); a non-optimizer raises
    with pytest.raises(TypeError, match="GradientTransformation"):
        core.local_train(port, flat, xt, yt, 0.05, 8, optimizer=object())


def test_score_candidates_and_evaluate(setup):
    ref, port, params, flat, x, y = setup
    rng = np.random.default_rng(1)
    deltas = {k: rng.standard_normal((3,) + tuple(v.shape))
              .astype(np.float32) * 2.0 for k, v in flat.items()}
    # the reference's stacked pytree with the same values
    tree = _unflatten_like(params, {k: jnp.asarray(v)
                                    for k, v in deltas.items()})
    want = ref_core.score_candidates(ref.apply, params, tree, 0.05,
                                     jnp.asarray(x), jnp.asarray(y))
    got = core.score_candidates(port, flat, {k: torch.as_tensor(v) for k, v
                                             in deltas.items()}, 0.05,
                                torch.as_tensor(x).long(),
                                torch.as_tensor(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = core.evaluate(port, flat, torch.as_tensor(x).long(),
                        torch.as_tensor(y))
    want_acc = ref_core.evaluate(ref.apply, params, jnp.asarray(x),
                                 jnp.asarray(y))
    assert float(acc) == float(want_acc)


def _unflatten_like(template, flat):
    """Rebuild the reference's nested tree from keystr-keyed leaves."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [flat[jax.tree_util.keystr(p)] for p, _ in paths])


@pytest.mark.parametrize("sel", [[1, 0, 1, 1], [0, 0, 0, 0]])
def test_apply_selection(setup, sel):
    _, _, params, flat, _, _ = setup
    rng = np.random.default_rng(2)
    deltas = {k: rng.standard_normal((4,) + tuple(v.shape))
              .astype(np.float32) for k, v in flat.items()}
    n = np.array([16, 7, 30, 12], np.int32)
    want = ref_core.apply_selection(
        params, _unflatten_like(params, {k: jnp.asarray(v)
                                         for k, v in deltas.items()}),
        jnp.asarray(n), jnp.asarray(sel, bool), 0.05)
    got = core.apply_selection(flat, {k: torch.as_tensor(v) for k, v in
                                      deltas.items()}, torch.as_tensor(n),
                               torch.as_tensor(sel, dtype=torch.bool), 0.05)
    for k, w in _flat(want).items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
