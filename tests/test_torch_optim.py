"""Local optimizers: `core/optim.py` against optax 0.2.6, and the
reference's `tests/test_optimizers.py` scenarios on both packages.

Tolerances (float32 both sides, the same arithmetic in another order):
20 steps of each transform on seeded params and gradients within 1e-6
relative / 1e-7 absolute of optax's (Adam's bias correction is a float32
power, computed by numpy here and by XLA there); a local train with an
optimizer within 1e-5 of the reference's delta and cost; protocol runs'
final models within 1e-4 of the reference's and the same accuracies to
1e-6 (the occupancy synthetic stand-in, seeded).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

optax = pytest.importorskip("optax")

from bflc_demo_tpu.client import run_federated as ref_run_federated
from bflc_demo_tpu.client.mesh_runtime import \
    run_federated_mesh as ref_run_mesh
from bflc_demo_tpu.core import local_train as ref_local_train
from bflc_demo_tpu.models import make_softmax_regression as ref_softmax
from bflc_demo_tpu.protocol import ProtocolConfig as RefProtocolConfig
from bflc_demo_tpu_torch.client.mesh_runtime import run_federated_mesh
from bflc_demo_tpu_torch.client.simulation import run_federated
from bflc_demo_tpu_torch.core import local_train, optim
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.models import make_softmax_regression
from bflc_demo_tpu_torch.protocol import ProtocolConfig

STEP = dict(rtol=1e-6, atol=1e-7)
MODEL = make_softmax_regression()
REF_MODEL = ref_softmax()
PAIRS = {
    "sgd": (lambda: optim.sgd(0.05), lambda: optax.sgd(0.05)),
    "momentum": (lambda: optim.sgd(0.05, momentum=0.9),
                 lambda: optax.sgd(0.05, momentum=0.9)),
    "nesterov": (lambda: optim.sgd(0.05, momentum=0.9, nesterov=True),
                 lambda: optax.sgd(0.05, momentum=0.9, nesterov=True)),
    "adam": (lambda: optim.adam(1e-2), lambda: optax.adam(1e-2)),
    "adam_eps_root": (lambda: optim.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6,
                                         eps_root=1e-8),
                      lambda: optax.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6,
                                         eps_root=1e-8)),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_transform_matches_optax_over_20_steps(name):
    rng = np.random.default_rng(len(name))
    shapes = {"['a']": (5, 3), "['b']": (7,), "['c']['d']": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    mine, theirs = PAIRS[name][0](), PAIRS[name][1]()
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    q = {k: jnp.asarray(v) for k, v in params.items()}
    s_mine, s_theirs = mine.init(p), theirs.init(q)
    for _ in range(20):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        u, s_mine = mine.update({k: torch.as_tensor(v) for k, v in
                                 g.items()}, s_mine, p)
        p = optim.apply_updates(p, u)
        v, s_theirs = theirs.update({k: jnp.asarray(x) for k, x in
                                     g.items()}, s_theirs, q)
        q = optax.apply_updates(q, v)
        for k in shapes:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(q[k]),
                                       **STEP, err_msg=k)


def _xy(seed, n=200):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y


def test_none_matches_plain_sgd():
    """optimizer=None is optim.sgd(lr)'s trajectory (the reference's
    scenario), and both equal the reference's."""
    x, y = _xy(0)
    p = MODEL.init_params(0)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    d_none, c_none = local_train(MODEL, p, xt, yt, lr=0.01, batch_size=100)
    d_sgd, c_sgd = local_train(MODEL, p, xt, yt, lr=0.01, batch_size=100,
                               optimizer=optim.sgd(0.01))
    np.testing.assert_allclose(d_none["['W']"].numpy(),
                               d_sgd["['W']"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(c_none), float(c_sgd), rtol=1e-6)
    want, _ = ref_local_train(REF_MODEL.apply, REF_MODEL.init_params(0),
                              jnp.asarray(x), jnp.asarray(y), lr=0.01,
                              batch_size=100, optimizer=optax.sgd(0.01))
    np.testing.assert_allclose(d_sgd["['W']"].numpy(),
                               np.asarray(want["W"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_delta_encodes_final_model_for_any_optimizer(name):
    """delta == (params_in - params_out) / lr whatever the optimizer, so
    global - lr * delta is the client's final model; the delta and the
    cost equal the reference's with optax's optimizer."""
    x, y = _xy(1)
    make = {"adam": (lambda: optim.adam(1e-2), lambda: optax.adam(1e-2)),
            "momentum": (lambda: optim.sgd(1e-2, momentum=0.9),
                         lambda: optax.sgd(1e-2, momentum=0.9))}[name]
    p = MODEL.init_params(0)
    delta, cost = local_train(MODEL, p, torch.as_tensor(x),
                              torch.as_tensor(y), lr=0.001, batch_size=100,
                              optimizer=make[0]())
    recon = {k: p[k] - 0.001 * delta[k] for k in p}
    opt = make[0]()
    state, q = opt.init(p), dict(p)
    for b in range(2):
        bx = torch.as_tensor(x[b * 100:(b + 1) * 100])
        by = torch.as_tensor(y[b * 100:(b + 1) * 100])
        work = {k: v.clone().requires_grad_(True) for k, v in q.items()}
        loss = -(by * torch.log_softmax(MODEL.apply(work, bx), -1)).sum(
            -1).mean()
        g = dict(zip(work, torch.autograd.grad(loss, list(work.values()))))
        u, state = opt.update(g, state, q)
        q = optim.apply_updates(q, u)
    np.testing.assert_allclose(recon["['W']"].numpy(), q["['W']"].numpy(),
                               rtol=1e-4, atol=1e-6)
    want, want_cost = ref_local_train(
        REF_MODEL.apply, REF_MODEL.init_params(0), jnp.asarray(x),
        jnp.asarray(y), lr=0.001, batch_size=100, optimizer=make[1]())
    for k, ref_k in (("['W']", "W"), ("['b']", "b")):
        np.testing.assert_allclose(delta[k].numpy(), np.asarray(want[ref_k]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=1e-5)


def _occupancy(n_train, n_test, clients):
    xtr, ytr, xte, yte = load_occupancy()
    return (iid_shards(xtr[:n_train], ytr[:n_train], clients),
            (xte[:n_test], yte[:n_test]))


def _close_runs(got, want):
    np.testing.assert_allclose(got.final_params["['W']"].numpy(),
                               np.asarray(want.final_params["W"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose([a for _, a in got.accuracy_history],
                               [a for _, a in want.accuracy_history],
                               atol=1e-6)


def test_momentum_protocol_run():
    """The host runtime with a momentum optimizer converges on the
    reference workload, as the reference's does, and to its model."""
    kw = dict(client_num=8, comm_count=2, aggregate_count=2,
              needed_update_count=3, learning_rate=0.001, batch_size=50)
    shards, test = _occupancy(2000, 500, 8)
    res = run_federated(MODEL, shards, test, ProtocolConfig(**kw),
                        rounds=5, device="cpu",
                        local_optimizer=optim.sgd(0.001, momentum=0.9))
    assert res.rounds_completed == 5
    assert res.best_accuracy() > 0.75
    ref = ref_run_federated(REF_MODEL, shards, test, RefProtocolConfig(**kw),
                            rounds=5, ledger_backend="python",
                            local_optimizer=optax.sgd(0.001, momentum=0.9))
    _close_runs(res, ref)


def test_mesh_runtime_local_optimizer():
    """local_optimizer drives the mesh round's per-client steps: the run
    completes with its audit green, differs from plain SGD, and lands
    on the reference's model."""
    kw = dict(client_num=8, comm_count=2, aggregate_count=2,
              needed_update_count=3, learning_rate=0.05, batch_size=16,
              local_epochs=1)
    shards, test = _occupancy(1200, 400, 8)

    def run(opt):
        return run_federated_mesh(MODEL, shards, test, ProtocolConfig(**kw),
                                  rounds=2, seed=5, local_optimizer=opt,
                                  device="cpu")

    plain = run(None)
    mom = run(optim.sgd(0.05, momentum=0.9))
    assert mom.rounds_completed == 2 and mom.ledger.verify_log()
    assert all(np.isfinite(a) for _, a in mom.accuracy_history)
    assert mom.best_accuracy() > 0.5
    assert not np.allclose(mom.final_params["['W']"].numpy(),
                           plain.final_params["['W']"].numpy())
    ref = ref_run_mesh(REF_MODEL, shards, test, RefProtocolConfig(**kw),
                       rounds=2, seed=5, ledger_backend="python",
                       local_optimizer=optax.sgd(0.05, momentum=0.9))
    _close_runs(mom, ref)


def test_mesh_runtime_optimizer_rejects_batched():
    cfg = ProtocolConfig(client_num=8, comm_count=2, aggregate_count=2,
                         needed_update_count=3, learning_rate=0.05,
                         batch_size=16, local_epochs=1)
    shards, test = _occupancy(800, 200, 8)
    with pytest.raises(ValueError, match="rounds_per_dispatch"):
        run_federated_mesh(MODEL, shards, test, cfg, rounds=4,
                           rounds_per_dispatch=2, device="cpu",
                           local_optimizer=optim.sgd(0.05, momentum=0.9))


def test_stacked_state_is_one_state_a_client():
    """Two clients in one lockstep program train as each would alone."""
    from bflc_demo_tpu_torch.core.local_train import sgd_stacked
    xa, ya = _xy(2, 100)
    xb, yb = _xy(3, 100)
    p = {k: v + 0.1 for k, v in MODEL.init_params(0).items()}
    xs = torch.as_tensor(np.stack([xa, xb]))
    ys = torch.as_tensor(np.stack([ya, yb]))
    both, _ = sgd_stacked(MODEL, p, xs, ys, 0.01, 25,
                          optimizer=optim.adam(1e-2))
    for i in range(2):
        alone, _ = sgd_stacked(MODEL, p, xs[i:i + 1], ys[i:i + 1], 0.01, 25,
                               optimizer=optim.adam(1e-2))
        for k in p:
            np.testing.assert_allclose(both[k][i].numpy(),
                                       alone[k][0].numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_not_an_optimizer_raises():
    x, y = _xy(0, 20)
    with pytest.raises(TypeError, match="GradientTransformation"):
        local_train(MODEL, MODEL.init_params(0), torch.as_tensor(x),
                    torch.as_tensor(y), 0.05, 10, optimizer=object())
