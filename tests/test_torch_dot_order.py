"""Config 1's local step and merge in XLA:CPU's orders, bit for bit.

The port's CPU mirrors of the reference's float32 program (ROADMAP C2,
`bflc_demo_tpu_torch/core/losses.py`, `core/local_train.py`,
`core/aggregate.py:apply_selection` given the trained models) against
the JAX package on seeded numpy inputs: 5 features, batch 100, 20
clients, as config 1 trains.
- `fma32`: one rounding, also where float64's sum lands on a float32
  midpoint (operands built for it; the exact answer from fractions);
- `xla_exp`, `xla_log` against `jax.jit(jnp.exp / jnp.log)`;
- the log-softmax and its backward at nonzero logits;
- the forward `x @ W` (5 features; 2 and 3: the FMA chain) against
  `jax.jit(jax.vmap(apply))`, and the W and b gradients against
  `jax.jit(jax.vmap(jax.grad(...)))`;
- every client's local training (four steps from nonzero params) against
  `jax.jit(jax.vmap(local_train_impl))`;
- one config-1 round's merge against the reference's round program on a
  one-device mesh: the new model's bytes and its fingerprint.
All on the CPU, all bit for bit.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.core.local_train import local_train_impl
from bflc_demo_tpu.core.losses import softmax_cross_entropy as ref_ce
from bflc_demo_tpu.models import make_softmax_regression as ref_softmax
from bflc_demo_tpu.parallel.fedavg import make_sharded_protocol_round \
    as ref_round
from bflc_demo_tpu.parallel.mesh import client_axis_mesh
from bflc_demo_tpu_torch import core
from bflc_demo_tpu_torch.client.staging import stage_padded_arrays
from bflc_demo_tpu_torch.core.losses import (add_bias, fma32, log_softmax,
                                             xla_exp, xla_log, xla_matmul,
                                             xla_mean_ordered)
from bflc_demo_tpu_torch.data import occupancy
from bflc_demo_tpu_torch.data.partition import iid_shards
from bflc_demo_tpu_torch.models import make_softmax_regression
from bflc_demo_tpu_torch.parallel.fedavg import make_sharded_protocol_round

T = torch.as_tensor
CLIENTS, BATCH = 20, 100


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _f32(x: float) -> np.float32:
    return np.float32(x)


def _exact_fma(a, b, c) -> np.float32:
    """float32(a * b + c) rounded once, from the exact rational."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(exact))           # within an ulp of exact
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(v.view(np.uint32)) & 1))


@pytest.mark.parametrize("sign", [1, -1])
def test_fma32_rounds_once_at_a_float32_midpoint(sign):
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 is the midpoint between two
    # float32 neighbours; c = +-2^-60 is below float64's half ulp there,
    # so float64's sum is the midpoint itself and float32(sum) would tie
    # to even — wrong for c > 0
    a = b = _f32(1 + 2.0 ** -12)
    c = _f32(sign * 2.0 ** -60)
    want = _exact_fma(a, b, c)
    got = fma32(T([a]), T([b]), T([c]))
    assert _bits(got.numpy())[0] == want.view(np.uint32)
    naive = np.float32(float(a) * float(b) + float(c))
    assert (naive != want) == (sign > 0)     # the case is a real one
    # and on random operands, against the exact rational
    rng = np.random.default_rng(3 + sign)
    x = (rng.standard_normal((3, 200)) * 10.0 ** rng.integers(-5, 5, (3, 1))
         ).astype(np.float32)
    got = fma32(T(x[0]), T(x[1]), T(x[2])).numpy()
    want = np.array([_exact_fma(*x[:, i]) for i in range(200)], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_xla_exp_and_log_match_xla_cpu():
    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.random(20000) * 90, rng.random(2000) * 88,
                        [0.0, -0.0, -87.9, 88.9, -1e-8]]).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(xla_exp(T(x)).numpy()), _bits(jax.jit(jnp.exp)(x)))
    s = np.concatenate([1 + rng.random(20000), rng.random(2000) * 1e4,
                        [1.0, 2.0, 0.5, 1e-30]]).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(xla_log(T(s)).numpy()), _bits(jax.jit(jnp.log)(s)))


def test_log_softmax_and_its_backward_match_xla_cpu():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((CLIENTS, BATCH, 2)) * 4).astype(
        np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (CLIENTS, BATCH))]
    want = jax.jit(jax.vmap(jax.nn.log_softmax))(logits)
    want_g = jax.jit(jax.vmap(jax.grad(ref_ce)))(logits, y)
    lt = T(logits).requires_grad_(True)
    logp = log_softmax(lt)
    np.testing.assert_array_equal(_bits(logp.detach().numpy()),
                                  _bits(want))
    loss = -xla_mean_ordered((T(y) * logp).sum(-1), 1)
    (g,) = torch.autograd.grad(loss.sum(), lt)
    np.testing.assert_array_equal(_bits(g.numpy()), _bits(want_g))


@pytest.mark.parametrize("features", [5, 2, 3])
def test_product_and_its_gradients_match_xla_cpu(features):
    rng = np.random.default_rng(features)
    ref = ref_softmax(n_features=features)
    w = (rng.standard_normal((CLIENTS, features, 2)) * 0.05).astype(
        np.float32)
    b = (rng.standard_normal((CLIENTS, 2)) * 0.05).astype(np.float32)
    x = (rng.standard_normal((CLIENTS, BATCH, features))
         * rng.choice([0.01, 30.0, 700.0], features)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (CLIENTS, BATCH))]
    params = {"W": w, "b": b}
    want = jax.jit(jax.vmap(ref.apply))(params, x)
    want_g = jax.jit(jax.vmap(jax.grad(
        lambda p, bx, by: ref_ce(ref.apply(p, bx), by))))(params, x, y)
    wt, bt = T(w).requires_grad_(True), T(b).requires_grad_(True)
    logits = add_bias(xla_matmul(T(x), wt), bt, 1)
    np.testing.assert_array_equal(_bits(logits.detach().numpy()),
                                  _bits(want))
    loss = -xla_mean_ordered((T(y) * log_softmax(logits)).sum(-1), 1)
    gw, gb = torch.autograd.grad(loss.sum(), [wt, bt])
    np.testing.assert_array_equal(_bits(gw.numpy()), _bits(want_g["W"]))
    np.testing.assert_array_equal(_bits(gb.numpy()), _bits(want_g["b"]))


def _config1_staged():
    xtr, ytr, _, _ = occupancy.load_occupancy()
    shards = iid_shards(xtr, ytr, CLIENTS)
    return stage_padded_arrays([a for a, _ in shards],
                               [b for _, b in shards], 2)


def test_every_clients_local_steps_match_xla_cpu():
    xs, ys, _ = _config1_staged()
    rows = (xs.shape[1] // BATCH) * BATCH
    assert rows // BATCH >= 3                  # several steps a client
    rng = np.random.default_rng(2)
    params = {"W": (rng.standard_normal((5, 2)) * 0.01).astype(np.float32),
              "b": (rng.standard_normal(2) * 0.01).astype(np.float32)}
    ref = ref_softmax()
    want_d, want_c = jax.jit(jax.vmap(lambda x, y: local_train_impl(
        ref.apply, params, x, y, lr=0.001, batch_size=BATCH)))(
            jnp.asarray(xs[:, :rows]), jnp.asarray(ys[:, :rows]))
    model = make_softmax_regression()
    got_d, got_c = core.local_train_stacked(
        model, model.params_from_jax(params), T(xs[:, :rows]),
        T(ys[:, :rows]), lr=0.001, batch_size=BATCH)
    np.testing.assert_array_equal(_bits(got_d["['W']"].numpy()),
                                  _bits(want_d["W"]))
    np.testing.assert_array_equal(_bits(got_d["['b']"].numpy()),
                                  _bits(want_d["b"]))
    np.testing.assert_array_equal(_bits(got_c.numpy()), _bits(want_c))


def test_config1_round_merge_matches_the_round_program():
    xs, ys, ns = _config1_staged()
    rng = np.random.default_rng(4)
    params = {"W": (rng.standard_normal((5, 2)) * 0.01).astype(np.float32),
              "b": (rng.standard_normal(2) * 0.01).astype(np.float32)}
    up = np.zeros(CLIENTS, bool)
    up[rng.choice(CLIENTS, 10, replace=False)] = True
    comm = np.zeros(CLIENTS, bool)
    comm[rng.choice(np.flatnonzero(~up), 4, replace=False)] = True
    geometry = dict(client_num=CLIENTS, lr=0.001, batch_size=BATCH,
                    local_epochs=1, aggregate_count=6, comm_count=4,
                    needed_update_count=10)
    want = ref_round(client_axis_mesh(1), ref_softmax().apply, **geometry)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(ns, jnp.int32), jnp.asarray(up),
        jnp.asarray(comm))
    model = make_softmax_regression()
    got = make_sharded_protocol_round(model, **geometry)(
        model.params_from_jax(params), T(xs), T(ys),
        T(ns.astype(np.int32)), up, comm)
    assert np.asarray(want.selected).sum() == 6
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(want.selected))
    for name in ("W", "b"):
        np.testing.assert_array_equal(
            _bits(got.params[f"['{name}']"].numpy()),
            _bits(want.params[name]))
    np.testing.assert_array_equal(
        got.params_fp.numpy().astype(np.int64),
        np.asarray(want.params_fp).astype(np.int64))
    np.testing.assert_array_equal(
        got.delta_fps.numpy().astype(np.int64),
        np.asarray(want.delta_fps).astype(np.int64))
