"""The port's mesh round and mesh runtime against the JAX package's.

Same numpy inputs (made from a seed) through both:
- the decision functions (`median_scores`, `rank_desc_stable`,
  `topk_selection_mask`, `aggregate`, `elect_committee`) with ties,
  partial `scored_mask` and partial `valid`: bit for bit;
- `stage_padded_arrays` on ragged shards: equal arrays;
- `audit_round` fed one reference round's artifacts: the reference
  ledger's log head;
- stacked local SGD against N separate `local_train` calls: within 1e-5
  (the same float32 steps; only the products' batching differs);
- one round of `make_sharded_protocol_round` against the reference's on
  the CPU, for softmax regression and a small transformer (the
  reference's einsum attention, the port's plain flash), both from the
  reference's initial params: score matrix, medians, order and selection
  equal; params within rtol 1e-4 / atol 1e-5, costs within 1e-5 —
  training is float32 arithmetic in another order (XLA's fused vmapped
  program vs PyTorch's batched products), ~1e-7 relative a step, which
  the delta's division by lr and the merge carry into the params;
- 3 rounds of `run_federated_mesh` on config 1: equal committees and
  selections every round, sponsor accuracies within 0.005.
Plus the CLI's new defaults and the refusals of what is not ported.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.client import mesh_runtime as ref_mesh_runtime
from bflc_demo_tpu.client import staging as ref_staging
from bflc_demo_tpu.data import occupancy as ref_occupancy
from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.models import make_softmax_regression as ref_softmax
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.ops import fingerprint as ref_fp
from bflc_demo_tpu.parallel.fedavg import make_sharded_protocol_round \
    as ref_round
from bflc_demo_tpu.parallel.mesh import client_axis_mesh
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch import core
from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.client import mesh_runtime
from bflc_demo_tpu_torch.client import staging
from bflc_demo_tpu_torch.data import occupancy
from bflc_demo_tpu_torch.data.partition import iid_shards
from bflc_demo_tpu_torch.eval.configs import run_with_runtime
from bflc_demo_tpu_torch.ledger import make_ledger
from bflc_demo_tpu_torch.models import (make_softmax_regression,
                                        make_transformer_classifier)
from bflc_demo_tpu_torch.ops import fingerprint as fp
from bflc_demo_tpu_torch.parallel.fedavg import make_sharded_protocol_round
from bflc_demo_tpu_torch.protocol import ProtocolConfig

# the module, not the `aggregate` function bflc_demo_tpu.core exports
ref_agg = importlib.import_module("bflc_demo_tpu.core.aggregate")
T = torch.as_tensor
TRANSFORMER = dict(vocab_size=64, seq_len=16, num_classes=2, dim=16,
                   depth=1, heads=2)
GEOMETRY = dict(client_num=6, comm_count=2, aggregate_count=2,
                needed_update_count=3, batch_size=8)
UPLOADERS = np.array([1, 0, 1, 0, 1, 0], bool)
COMMITTEE = np.array([0, 1, 0, 0, 0, 1], bool)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _unflatten_like(template, flat):
    """The reference's nested tree from keystr-keyed leaves."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(flat[jax.tree_util.keystr(p)]))
                  for p, _ in paths])


# ------------------------------------------------------------- decisions
@pytest.mark.parametrize("seed", range(5))
def test_decisions_match_reference_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    scores = rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], (5, 9)) \
        .astype(np.float32)                       # many ties
    scored = np.ones(5, bool) if seed == 0 else rng.random(5) < 0.6
    if seed == 4:
        scored[:] = False                         # no row arrived
    valid = np.ones(9, bool) if seed == 1 else rng.random(9) < 0.7
    med = core.median_scores(T(scores), T(scored))
    want_med = ref_agg.median_scores(jnp.asarray(scores),
                                     jnp.asarray(scored))
    np.testing.assert_array_equal(_bits(med), _bits(want_med))
    order = core.rank_desc_stable(med, T(valid))
    want_order = ref_agg.rank_desc_stable(want_med, jnp.asarray(valid))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    for k in (1, 4, 9):
        np.testing.assert_array_equal(
            core.topk_selection_mask(med, T(valid), k).numpy(),
            np.asarray(ref_agg.topk_selection_mask(
                want_med, jnp.asarray(valid), k)))
    electees, ok = core.elect_committee(order, T(valid), 3)
    want_e, want_ok = ref_agg.elect_committee(want_order,
                                              jnp.asarray(valid), 3)
    np.testing.assert_array_equal(electees.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_matches_reference(seed):
    rng = np.random.default_rng(10 + seed)
    k = 7
    params = {"W": rng.standard_normal((5, 2)).astype(np.float32),
              "b": rng.standard_normal(2).astype(np.float32)}
    deltas = {n: rng.standard_normal((k,) + v.shape).astype(np.float32)
              for n, v in params.items()}
    n_samples = rng.integers(5, 40, k).astype(np.int32)
    costs = rng.random(k).astype(np.float32)
    scores = rng.choice([0.5, 0.6, 0.9], (4, k)).astype(np.float32)
    scored = np.array([1, 1, seed != 1, 1], bool)
    valid = rng.random(k) < 0.8
    want = ref_agg.aggregate(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, deltas), jnp.asarray(n_samples),
        jnp.asarray(costs), jnp.asarray(scores), jnp.asarray(scored),
        jnp.asarray(valid), 0.05, k=3)
    got = core.aggregate({f"['{n}']": T(v) for n, v in params.items()},
                         {f"['{n}']": T(v) for n, v in deltas.items()},
                         T(n_samples), T(costs), T(scores), T(scored),
                         T(valid), 0.05, k=3)
    np.testing.assert_array_equal(_bits(got.medians), _bits(want.medians))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(want.selected))
    np.testing.assert_allclose(float(got.global_loss),
                               float(want.global_loss), rtol=1e-6)
    for n in params:
        np.testing.assert_allclose(got.params[f"['{n}']"].numpy(),
                                   np.asarray(want.params[n]), rtol=1e-6,
                                   atol=1e-7)


# --------------------------------------------------------------- staging
@pytest.mark.parametrize("integer", [False, True])
def test_stage_padded_arrays_matches_reference(integer):
    rng = np.random.default_rng(3)
    sizes = [3, 7, 5, 1]
    xs = [rng.integers(0, 50, (n, 4)) if integer
          else rng.standard_normal((n, 4)) for n in sizes]
    ys = [rng.integers(0, 3, n) for n in sizes]
    got = staging.stage_padded_arrays(xs, ys, 3)
    want = ref_staging.stage_padded_arrays(xs, ys, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="empty"):
        staging.stage_padded_arrays(xs + [xs[0][:0]], ys + [ys[0][:0]], 3)


# ------------------------------------------------------------ the round
def _softmax_setup():
    rng = np.random.default_rng(0)
    params = {"W": rng.standard_normal((5, 2)).astype(np.float32) * 0.1,
              "b": np.zeros(2, np.float32)}
    x = rng.standard_normal((130, 5)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5, 0.0, 1.5]) > 0).astype(np.int32)
    return ref_softmax(), make_softmax_regression(), params, x, y, 0.5


def _transformer_setup():
    rng = np.random.default_rng(1)
    ref = ref_transformer(attention_impl="einsum", **TRANSFORMER)
    x = rng.integers(1, 64, (130, 16)).astype(np.int32)
    x[::3, 11:] = 0
    y = (x[:, 0] > 31).astype(np.int32)
    return (ref, make_transformer_classifier(**TRANSFORMER),
            ref.init_params(0), x, y, 0.05)


SETUPS = {"softmax": _softmax_setup, "transformer": _transformer_setup}


def _staged(x, y, nc):
    """Six ragged shards (17-24 rows), staged as the runtimes stage them."""
    cuts = np.cumsum([20, 24, 17, 24, 22])
    shards = list(zip(np.split(x[:129], cuts), np.split(y[:129], cuts)))
    return staging.stage_padded_arrays([a for a, _ in shards],
                                       [b for _, b in shards], nc)


def _ref_round(ref_model, params, xs, ys, ns, lr):
    fn = ref_round(client_axis_mesh(1), ref_model.apply, lr=lr,
                   local_epochs=1, **GEOMETRY)
    return fn(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs),
              jnp.asarray(ys), jnp.asarray(ns, jnp.int32),
              jnp.asarray(UPLOADERS), jnp.asarray(COMMITTEE))


def _port_round(model, params, xs, ys, ns, lr):
    fn = make_sharded_protocol_round(model, lr=lr, local_epochs=1,
                                     **GEOMETRY)
    xt = T(xs).long() if xs.dtype == np.int32 else T(xs)
    return fn(model.params_from_jax(params), xt, T(ys),
              T(ns.astype(np.int32)), UPLOADERS, COMMITTEE)


@pytest.mark.parametrize("name", list(SETUPS))
def test_one_mesh_round_matches_reference(name):
    ref_model, model, params, x, y, lr = SETUPS[name]()
    xs, ys, ns = _staged(x, y, model.num_classes)
    want = _ref_round(ref_model, params, xs, ys, ns, lr)
    got = _port_round(model, params, xs, ys, ns, lr)
    # the scored region is real (both classes of outcome occur)
    region = np.asarray(want.score_matrix)[np.ix_(COMMITTEE, UPLOADERS)]
    assert region.min() > 0.0
    np.testing.assert_array_equal(_bits(got.score_matrix),
                                  _bits(want.score_matrix))
    np.testing.assert_array_equal(_bits(got.medians), _bits(want.medians))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(want.selected))
    np.testing.assert_allclose(got.avg_costs.numpy(),
                               np.asarray(want.avg_costs), rtol=1e-5)
    np.testing.assert_allclose(float(got.global_loss),
                               float(want.global_loss), rtol=1e-5)
    new = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(want.params)[0]}
    assert set(new) == set(got.params)
    for k, v in new.items():
        np.testing.assert_allclose(got.params[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the ids: the port's equal the reference's fingerprints of the
    # port's own new model and deltas
    tree = _unflatten_like(want.params, got.params)
    assert fp.fingerprint_to_bytes(got.params_fp) == \
        ref_fp.fingerprint_to_bytes(ref_fp.fingerprint_pytree(tree))
    deltas, _ = core.local_train_stacked(
        model, model.params_from_jax(params),
        T(xs).long() if xs.dtype == np.int32 else T(xs), T(ys), lr=lr,
        batch_size=GEOMETRY["batch_size"])
    stacked = _unflatten_like(jax.tree_util.tree_map(
        lambda v: np.zeros((6,) + np.shape(v)), params), deltas)
    np.testing.assert_array_equal(
        got.delta_fps.numpy(), np.asarray(ref_fp.fingerprint_stacked(
            stacked)).astype(np.int64))


@pytest.mark.parametrize("name", list(SETUPS))
def test_stacked_sgd_equals_separate_local_train(name):
    _, model, params, x, y, lr = SETUPS[name]()
    xs, ys, _ = _staged(x, y, model.num_classes)
    p = model.params_from_jax(params)
    xt = T(xs).long() if xs.dtype == np.int32 else T(xs)
    deltas, costs = core.local_train_stacked(model, p, xt, T(ys), lr=lr,
                                             batch_size=8, local_epochs=2)
    for i in range(xs.shape[0]):
        d, c = core.local_train(model, p, xt[i], T(ys[i]), lr=lr,
                                batch_size=8, local_epochs=2)
        for k in d:
            np.testing.assert_allclose(deltas[k][i].numpy(), d[k].numpy(),
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(costs[i]), float(c), atol=1e-5)


def test_audit_round_of_reference_artifacts_gives_reference_head():
    ref_model, _, params, x, y, lr = _softmax_setup()
    xs, ys, ns = _staged(x, y, 2)
    cfg = dict(GEOMETRY, learning_rate=lr)
    cfg.pop("batch_size")
    ref_ledger = ref_make_ledger(RefConfig(**cfg), backend="python")
    port_ledger = make_ledger(ProtocolConfig(**cfg))
    addr = mesh_runtime._addr
    for i in range(6):
        ref_ledger.register_node(addr(i))
        port_ledger.register_node(addr(i))
    # the round's masks are the ledger's own first committee
    comm = sorted(int(a, 16) for a in port_ledger.committee())
    assert comm == sorted(int(a, 16) for a in ref_ledger.committee())
    ups = [i for i in range(6) if i not in comm][:3]
    up_mask, comm_mask = np.zeros(6, bool), np.zeros(6, bool)
    up_mask[ups], comm_mask[comm] = True, True
    res = ref_round(client_axis_mesh(1), ref_model.apply, lr=lr,
                    local_epochs=1, **GEOMETRY)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(ns, jnp.int32), jnp.asarray(up_mask),
        jnp.asarray(comm_mask))
    args = (0, ups, comm, ups, comm, np.asarray(res.delta_fps),
            lambda cid: ns[cid], np.asarray(res.avg_costs),
            np.asarray(res.score_matrix),
            np.flatnonzero(np.asarray(res.selected)),
            np.asarray(res.params_fp))
    ref_staging.audit_round(ref_ledger, addr, *args)
    staging.audit_round(port_ledger, addr, *args)
    assert port_ledger.log_head() == ref_ledger.log_head()
    assert port_ledger.verify_log() and port_ledger.epoch == 1
    # a device selection the ledger did not take is refused
    other = make_ledger(ProtocolConfig(**cfg))
    for i in range(6):
        other.register_node(addr(i))
    bad = list(args)
    bad[9] = np.setdiff1d(np.arange(6), args[9])[:2]
    with pytest.raises(RuntimeError, match="divergence"):
        staging.audit_round(other, addr, *bad)


def test_config1_three_mesh_rounds_match_reference(monkeypatch, tmp_path):
    # the two loaders agree on a CSV that both reach through the variable,
    # and on the seeded synthetic stand-in
    rng = np.random.default_rng(5)
    csv = tmp_path / "datatraining.txt"
    csv.write_text('"date","Temperature","Humidity","Light","CO2",'
                   '"HumidityRatio","Occupancy"\n' + "".join(
                       f'"{i}","2015-02-04 17:{i % 60:02d}:00",'
                       + ",".join(f"{v:.6g}" for v in rng.random(5) * 100)
                       + f",{i % 3 == 0:d}\n" for i in range(1, 41)))
    with monkeypatch.context() as env:
        env.setenv("BFLC_TPU_OCCUPANCY", str(csv))
        assert occupancy.occupancy_source() == "csv"
        assert ref_occupancy.occupancy_source() == "csv"
        for a, b in zip(occupancy.load_occupancy(),
                        ref_occupancy.load_occupancy()):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(occupancy.synthesize_occupancy(),
                    ref_occupancy.synthesize_occupancy()):
        np.testing.assert_array_equal(a, b)
    logs, got, want = _config1_mesh_runs(monkeypatch, 3)
    assert len(logs[1]) == 3 and logs[1] == logs[0]
    for (_, a), (_, b) in zip(got.accuracy_history, want.accuracy_history):
        assert abs(a - b) <= 0.005
    assert got.ledger_log_size == want.ledger_log_size == 20 + 3 * 15
    assert got.ledger.verify_log() and got.n_devices == 1


def _config1_mesh_runs(monkeypatch, rounds, devices=1):
    """Both packages' mesh runtimes on the port's config-1 data: each
    round's (epoch, uploaders, committee, selection), and the results.
    The port's round is one program on one device, so the reference runs
    on a one-device mesh by default (`devices`; None: its default mesh):
    on D devices (conftest's 8 virtual CPU devices
    give D = 5 for 20 clients) its merge psums D per-device partial sums,
    another order of the same float adds."""
    xtr, ytr, xte, yte = occupancy.load_occupancy()
    shards = iid_shards(xtr, ytr, 20)

    def recorder(module, log):
        inner = module.audit_round

        def wrapped(ledger, addr_of, epoch, ups, comm, *rest):
            inner(ledger, addr_of, epoch, ups, comm, *rest)
            log.append((epoch, list(ups), list(comm),
                        sorted(int(s) for s in rest[6])))
        monkeypatch.setattr(module, "audit_round", wrapped)

    ref_log, port_log = [], []
    recorder(ref_mesh_runtime, ref_log)
    recorder(mesh_runtime, port_log)
    want = ref_mesh_runtime.run_federated_mesh(
        ref_softmax(), shards, (xte, yte), RefConfig(), rounds=rounds,
        mesh=devices and client_axis_mesh(devices), seed=0,
        ledger_backend="python")
    got = mesh_runtime.run_federated_mesh(
        make_softmax_regression(), shards, (xte, yte), ProtocolConfig(),
        rounds=rounds, seed=0, device="cpu")
    return (ref_log, port_log), got, want


@pytest.mark.parametrize("rounds", [9, 10])
def test_config1_mesh_rounds_match_reference(monkeypatch, rounds):
    """C2 closed: every round of the preset's 10 is the reference's.  On
    CPU tensors local training takes XLA:CPU's orders (the dot, the
    log-softmax and its backward with XLA's exp and log, the FMA-chain
    W gradient, the bias and loss sums, the SGD update as one FMA, the
    delta times the f32 reciprocal of lr) and the merge is the round
    program's (`apply_selection` given the trained models), so each
    round's model is the reference's
    bit for bit: decisions, accuracies and the ledger's log equal in
    every round, nine of them and the preset's ten."""
    logs, got, want = _config1_mesh_runs(monkeypatch, rounds)
    assert len(logs[1]) == rounds and logs[1] == logs[0]
    assert got.accuracy_history == want.accuracy_history
    assert got.ledger_log_size == want.ledger_log_size == 20 + rounds * 15
    assert got.ledger.log_head() == want.ledger.log_head()


def test_config1_mesh_decisions_match_the_default_mesh_reference(
        monkeypatch):
    """Against the reference on its default mesh (D = 5 under conftest),
    whose merge adds D per-device partial sums: another order, so the
    models differ in their last bits, yet the nine rounds' decisions are
    the reference's."""
    logs, got, want = _config1_mesh_runs(monkeypatch, 9, devices=None)
    assert want.n_devices == 5
    assert len(logs[1]) == 9 and logs[1] == logs[0]
    assert got.ledger_log_size == want.ledger_log_size == 20 + 9 * 15


# ------------------------------------------------------- entry points
def test_cli_defaults_to_config1_on_the_mesh_runtime(capsys):
    assert cli(["--device", "cpu", "--rounds", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config"] == "config1" and out["rounds"] == 2
    assert out["ledger_log_size"] == 20 + 2 * 15
    assert set(out) == {"config", "rounds", "final_acc", "best_acc",
                        "wall_time_s", "ledger_log_size", "ledger_log_head"}


def _tiny_run(**kw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((60, 5)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                         needed_update_count=3, batch_size=5)
    return mesh_runtime.run_federated_mesh(
        make_softmax_regression(), iid_shards(x, y, 6), (x, y), cfg,
        rounds=1, device="cpu", **kw)


def test_tiny_mesh_run_completes():
    res = _tiny_run()
    assert res.rounds_completed == 1 and res.ledger.verify_log()


@pytest.mark.parametrize("kw,item", [
    (dict(participation="active"), "A7"),
    (dict(rounds_per_dispatch=2), "A7"),
    (dict(secure_aggregation=True), "A12"),
    (dict(attest_scores=True), "A9"),
    (dict(checkpoint_dir="ckpt", checkpoint_every=1), "A11"),
    (dict(estimate_flops=True), "A11"),
    (dict(client_chunk=2), "A7"),
    (dict(remat=True), "A7"),
    (dict(local_optimizer=object()), "A11"),
])
def test_unported_mesh_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _tiny_run(**kw)


def test_round_factory_guards():
    model = make_softmax_regression()
    base = dict(client_num=6, lr=0.1, batch_size=5, local_epochs=1,
                aggregate_count=2)
    for kw in (dict(scoring="ring", comm_count=2, needed_update_count=3),
               dict()):                      # auto without counts = ring
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            make_sharded_protocol_round(model, **base, **kw)
    counts = dict(comm_count=2, needed_update_count=3)
    for kw, item in ((dict(secure=True), "A12"),
                     (dict(expose_candidates=True), "A9")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            make_sharded_protocol_round(model, **base, **counts, **kw)
    with pytest.raises(ValueError, match="half-specified"):
        make_sharded_protocol_round(model, **base, comm_count=2)
    fn = make_sharded_protocol_round(model, **base, comm_count=2,
                                     needed_update_count=3)
    xs = torch.zeros((6, 10, 5))
    ys = torch.zeros((6, 10, 2))
    with pytest.raises(ValueError, match="static count"):
        fn(model.init_params(), xs, ys, torch.full((6,), 10), UPLOADERS,
           np.ones(6, bool))


@pytest.mark.parametrize("runtime,kw", [
    ("mesh", dict(standbys=1)), ("mesh", dict(bft_validators=4)),
    ("mesh", dict(tls_dir="certs")), ("host", dict(attest_scores=True)),
    ("host", dict(participation="full")), ("threaded", dict()),
])
def test_run_with_runtime_refuses_what_does_not_apply(runtime, kw):
    # options of runtimes not ported yet are unexpected keywords of the
    # mesh runtime; the mesh-only options are refused on 'host'
    unported = {"standbys", "bft_validators", "tls_dir"}
    exc = TypeError if unported & set(kw) else ValueError
    with pytest.raises(exc):
        run_with_runtime(make_softmax_regression(), [], ([], []),
                         ProtocolConfig(), runtime=runtime, device="cpu",
                         **kw)


def test_softmax_regression_apply_matches_reference():
    rng = np.random.default_rng(4)
    params = {"W": rng.standard_normal((5, 2)).astype(np.float32),
              "b": rng.standard_normal(2).astype(np.float32)}
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    model = make_softmax_regression()
    assert all(float(v.abs().max()) == 0
               for v in model.init_params(3).values())
    p = model.params_from_jax(params)
    want = jax.vmap(ref_softmax().apply, in_axes=(None, 0))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    stacked = {k: v[None].repeat((3,) + (1,) * v.ndim) for k, v in p.items()}
    np.testing.assert_allclose(model.apply_stacked(stacked, T(x)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(model.apply(p, T(x[0])).numpy(),
                               np.asarray(want[0]), rtol=1e-6, atol=1e-6)
