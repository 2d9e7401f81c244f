"""R rounds a dispatch and ring scoring, against the JAX package's.

- `make_multi_round_program`'s guards (the reference's :557-580) and
  `run_federated_mesh`'s (full participation, no local optimizer,
  `rounds % R == 0`, `estimate_flops`).
- Config 1 on the mesh runtime, 10 rounds at R = 5 and at R = 2, against
  the reference's batched runtime on a one-device mesh: every op of the
  ledger byte for byte (committees, uploader sets, selections, payload
  ids, commits), the sponsor's accuracies and the head equal — the
  reference's `lax.scan` program rounds as its one-round program does.
  With `client_chunk` the reference's `lax.map` takes another float
  order (as on the one-round path), so there the decisions are held;
  with `remat` the chain again bit for bit.
- `chip_smoke.py`'s config-1 dispatch bar: over seeds 0-4 both
  packages' R = 5 trajectories equal, with 4 or more evaluations to
  spare after the first at the bar.
- Attested R = 2: the attestation rows byte for byte.
- The audit: a device decision the ledger does not take raises.
- Ring scoring: one round of `make_sharded_protocol_round(scoring=
  "ring")` against the reference's on a one-device mesh (the dense
  score matrix bit for bit, softmax regression and a small transformer),
  and a ring multi-round dispatch against the reference's.
- `to_host`: one copy, every dtype back.
All on the CPU.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.client import mesh_runtime as ref_mesh_runtime
from bflc_demo_tpu.comm.identity import \
    provision_wallets as ref_provision_wallets
from bflc_demo_tpu.models import make_softmax_regression as ref_softmax
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.parallel.fedavg import make_multi_round_program \
    as ref_multi
from bflc_demo_tpu.parallel.fedavg import make_sharded_protocol_round \
    as ref_round
from bflc_demo_tpu.parallel.mesh import client_axis_mesh
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.client import mesh_runtime, staging
from bflc_demo_tpu_torch.comm.identity import provision_wallets
from bflc_demo_tpu_torch.data import occupancy
from bflc_demo_tpu_torch.data.partition import iid_shards, one_hot
from bflc_demo_tpu_torch.ledger.base import decode_op
from bflc_demo_tpu_torch.models import (make_softmax_regression,
                                        make_transformer_classifier)
from bflc_demo_tpu_torch.parallel import fedavg
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import prng

T = torch.as_tensor
GEOMETRY = dict(client_num=6, comm_count=2, aggregate_count=2,
                needed_update_count=3, batch_size=8)
COMMITTEE = np.array([0, 1, 0, 0, 0, 1], bool)
UPLOADERS = np.array([1, 0, 1, 0, 1, 0], bool)
TRANSFORMER = dict(vocab_size=64, seq_len=16, num_classes=2, dim=16,
                   depth=1, heads=2)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _ops(led):
    return [led.log_op(i) for i in range(led.log_size())]


def _decisions(led):
    """Each op with its float-derived fields (payload and model ids,
    costs) dropped: who uploaded, who scored, who was elected."""
    out = []
    for op in _ops(led):
        d = decode_op(op)
        for k in ("payload_hash", "model_hash", "avg_cost", "scores"):
            d.pop(k, None)
        out.append(d)
    return out


_RUNS = {}


def _config1(rounds, dispatch, package, seed=0, **kw):
    key = (rounds, dispatch, package, seed, tuple(sorted(kw.items())))
    if key not in _RUNS:
        xtr, ytr, xte, yte = occupancy.load_occupancy()
        shards = iid_shards(xtr, ytr, 20)
        if package == "ref":
            _RUNS[key] = ref_mesh_runtime.run_federated_mesh(
                ref_softmax(), shards, (xte, yte), RefConfig(),
                rounds=rounds, mesh=client_axis_mesh(1), seed=seed,
                ledger_backend="python", rounds_per_dispatch=dispatch, **kw)
        else:
            _RUNS[key] = mesh_runtime.run_federated_mesh(
                make_softmax_regression(), shards, (xte, yte),
                ProtocolConfig(), rounds=rounds, seed=seed, device="cpu",
                rounds_per_dispatch=dispatch, **kw)
    return _RUNS[key]


# --------------------------------------------------------------- guards
def test_multi_round_program_guards():
    model = make_softmax_regression()
    base = dict(client_num=6, lr=0.1, batch_size=5, local_epochs=1,
                aggregate_count=2, rounds_per_dispatch=2)
    with pytest.raises(ValueError, match=r"must be >= comm_count"):
        fedavg.make_multi_round_program(model, **base, comm_count=3,
                                        needed_update_count=2)
    with pytest.raises(ValueError, match="excludes committee members"):
        fedavg.make_multi_round_program(model, **base, comm_count=3,
                                        needed_update_count=4)
    with pytest.raises(ValueError, match="scoring must be"):
        fedavg.make_multi_round_program(model, **base, comm_count=2,
                                        needed_update_count=3,
                                        scoring="auto")
    # the secure program (ported) takes its trailing mask argument
    secure_fn = fedavg.make_multi_round_program(
        model, **base, comm_count=2, needed_update_count=3, secure=True)
    with pytest.raises(TypeError, match="trailing mask"):
        secure_fn(model.init_params(), torch.zeros((6, 10, 5)),
                  torch.zeros((6, 10, 2)), torch.full((6,), 10),
                  np.array([1, 1, 0, 0, 0, 0], bool), prng.PRNGKey(0),
                  torch.zeros((2, 5)), torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="client_chunk"):
        fedavg.make_multi_round_program(model, **base, comm_count=2,
                                        needed_update_count=3,
                                        client_chunk=4)
    fn = fedavg.make_multi_round_program(model, **base, comm_count=2,
                                         needed_update_count=3)
    xs, ys = torch.zeros((6, 10, 5)), torch.zeros((6, 10, 2))
    with pytest.raises(ValueError, match="committee_mask0"):
        fn(model.init_params(), xs, ys, torch.full((6,), 10),
           np.ones(6, bool), prng.PRNGKey(0), xs[0], ys[0])


def _tiny(**kw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((60, 5)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                         needed_update_count=3, batch_size=5)
    return mesh_runtime.run_federated_mesh(
        make_softmax_regression(), iid_shards(x, y, 6), (x, y), cfg,
        device="cpu", **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(rounds=2, rounds_per_dispatch=2, participation="active"),
     "participation='full'"),
    (dict(rounds=3, rounds_per_dispatch=2), "multiple of"),
    (dict(rounds=2, rounds_per_dispatch=2, local_optimizer=object()),
     "local_optimizer requires"),
    (dict(rounds=2, rounds_per_dispatch=2, estimate_flops=True),
     "estimate_flops"),
])
def test_batched_runtime_guards(kw, match):
    with pytest.raises(ValueError, match=match):
        _tiny(**kw)


@pytest.mark.parametrize("what", ["checkpoint", "secure"])
def test_batched_runtime_still_refuses_a11_a12(what, tmp_path):
    """Both ported: dispatch-granular checkpoints, and secure rounds a
    dispatch (one fresh mask key, each round re-keyed by its counter)
    committing the plain dispatch's model within the fixed point's
    quantisation."""
    if what == "checkpoint":
        # checkpoints are ported (A11): dispatch-granular, as in the
        # reference, the directory holds the state at the dispatch's end
        from bflc_demo_tpu_torch.utils.checkpoint import load_checkpoint
        d = str(tmp_path / "ckpt")
        res = _tiny(rounds=2, rounds_per_dispatch=2, checkpoint_dir=d,
                    checkpoint_every=1)
        _, ledger, meta = load_checkpoint(d, ProtocolConfig(
            client_num=6, comm_count=2, aggregate_count=2,
            needed_update_count=3, batch_size=5))
        assert meta["epoch"] == ledger.epoch == 2
        assert ledger.log_head() == res.ledger_log_head
        return
    plain = _tiny(rounds=2, rounds_per_dispatch=2)
    masked = _tiny(rounds=2, rounds_per_dispatch=2, secure_aggregation=True)
    assert masked.rounds_completed == 2 and masked.ledger.verify_log()
    assert masked.ledger_log_size == plain.ledger_log_size
    for k in plain.final_params:
        np.testing.assert_allclose(masked.final_params[k].numpy(),
                                   plain.final_params[k].numpy(), atol=5e-3)


# ------------------------------------------------------------ config 1
@pytest.mark.parametrize("dispatch", [5, 2])
def test_config1_dispatches_match_reference_bit_for_bit(dispatch):
    got = _config1(10, dispatch, "port")
    want = _config1(10, dispatch, "ref")
    assert got.ledger.backend == "native"
    assert got.ledger_log_size == want.ledger_log_size == 20 + 10 * 15
    assert _ops(got.ledger) == _ops(want.ledger)
    assert got.ledger.log_head() == want.ledger.log_head()
    assert got.accuracy_history == want.accuracy_history
    assert [e for e, _ in got.loss_history] == list(range(10))
    assert len(got.round_times_s) == 10


@pytest.mark.parametrize("seed", range(5))
def test_config1_dispatch_bar_has_evaluations_to_spare(seed):
    """Rule 8 for `chip_smoke.py`'s `dispatch_config1` bar (0.85, the
    stand-in's): over seeds 0-4 both packages' trajectories at R = 5 are
    equal and first reach the bar at least 4 evaluations before the
    last (evaluation 2 of 10, 7 to spare, when written)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    bar = cs.DISPATCH_C1_MIN_BEST[occupancy.occupancy_source()]
    got = _config1(10, 5, "port", seed=seed)
    want = _config1(10, 5, "ref", seed=seed)
    history = [a for _, a in got.accuracy_history]
    assert history == [a for _, a in want.accuracy_history]
    hit = [i for i, a in enumerate(history) if a >= bar]
    assert hit and len(history) - 1 - hit[0] >= 4, (history, bar)


def test_config1_dispatch_sizes_draw_differently():
    # the draw is one key a dispatch: R = 5 and R = 2 see other uploaders
    a, b = _config1(10, 5, "port"), _config1(10, 2, "port")
    assert _decisions(a.ledger)[:20] == _decisions(b.ledger)[:20]
    assert _decisions(a.ledger) != _decisions(b.ledger)


def test_config1_client_chunk_holds_the_decisions():
    got = _config1(4, 2, "port", client_chunk=4)
    want = _config1(4, 2, "ref", client_chunk=4)
    assert _decisions(got.ledger) == _decisions(want.ledger)
    for (e1, a1), (e2, a2) in zip(got.accuracy_history,
                                  want.accuracy_history):
        assert e1 == e2 and abs(a1 - a2) <= 0.005
    # chunking changes no bit of the port's own run
    plain = _config1(4, 2, "port")
    assert _ops(got.ledger) == _ops(plain.ledger)


def test_config1_remat_matches_reference():
    got = _config1(4, 2, "port", remat=True)
    want = _config1(4, 2, "ref", remat=True)
    assert _decisions(got.ledger) == _decisions(want.ledger)
    assert _ops(got.ledger) == _ops(_config1(4, 2, "port").ledger)
    assert _ops(got.ledger) == _ops(want.ledger)
    assert got.accuracy_history == want.accuracy_history


def test_attested_dispatch_rows_byte_for_byte():
    seed = b"dispatch-attest-01"
    got = _config1(4, 2, "port",
                   attest_wallets=tuple(provision_wallets(20, seed)[0]))
    want = _config1(4, 2, "ref",
                    attest_wallets=tuple(ref_provision_wallets(20, seed)[0]))
    assert got.attest_log == want.attest_log
    assert sorted(got.attest_log) == [0, 1, 2, 3]
    assert all(len(rows) == 4 for rows in got.attest_log.values())
    assert _ops(got.ledger) == _ops(want.ledger)


@pytest.mark.parametrize("field", ["selected", "committee_masks"])
def test_audit_refuses_a_divergent_dispatch(monkeypatch, field):
    real = fedavg.make_multi_round_program

    def lying(*a, **kw):
        fn = real(*a, **kw)

        def run(*args):
            res = fn(*args)
            t = getattr(res, field).clone()
            t[0] = t[0].roll(1)                  # another set, same size
            return res._replace(**{field: t})
        return run
    monkeypatch.setattr(mesh_runtime, "make_multi_round_program", lying)
    with pytest.raises(RuntimeError, match="divergence at epoch 0"):
        _tiny(rounds=2, rounds_per_dispatch=2)


# -------------------------------------------------------------- ring
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
    cuts = np.cumsum([20, 24, 17, 24, 22])
    shards = list(zip(np.split(x[:129], cuts), np.split(y[:129], cuts)))
    return staging.stage_padded_arrays([a for a, _ in shards],
                                       [b for _, b in shards], nc)


def _feat(xs):
    return T(xs).long() if xs.dtype == np.int32 else T(xs)


@pytest.mark.parametrize("name", list(SETUPS))
def test_ring_round_matches_reference(name):
    ref_model, model, params, x, y, lr = SETUPS[name]()
    xs, ys, ns = _staged(x, y, model.num_classes)
    want = ref_round(client_axis_mesh(1), ref_model.apply, lr=lr,
                     local_epochs=1, scoring="ring", **GEOMETRY)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(ns, jnp.int32),
        jnp.asarray(UPLOADERS), jnp.asarray(COMMITTEE))
    port = dict(GEOMETRY, comm_count=0, needed_update_count=0)
    got = fedavg.make_sharded_protocol_round(     # auto, no counts: ring
        model, lr=lr, local_epochs=1, **port)(
        model.params_from_jax(params), _feat(xs), T(ys),
        T(ns.astype(np.int32)), UPLOADERS, COMMITTEE)
    dense = np.asarray(want.score_matrix)
    assert dense.shape == (6, 6) and (dense > 0).all()
    np.testing.assert_array_equal(_bits(got.score_matrix), _bits(dense))
    np.testing.assert_array_equal(_bits(got.medians), _bits(want.medians))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(want.selected))
    # the committee schedule's entries are the ring's, where it scores
    committee = fedavg.make_sharded_protocol_round(
        model, lr=lr, local_epochs=1, **GEOMETRY)(
        model.params_from_jax(params), _feat(xs), T(ys),
        T(ns.astype(np.int32)), UPLOADERS, COMMITTEE)
    region = np.ix_(COMMITTEE, UPLOADERS)
    np.testing.assert_array_equal(
        _bits(committee.score_matrix.numpy()[region]),
        _bits(got.score_matrix.numpy()[region]))
    np.testing.assert_array_equal(committee.selected.numpy(),
                                  got.selected.numpy())


@pytest.mark.parametrize("chunk", [0, 2])
def test_ring_dispatch_matches_reference(chunk):
    ref_model, model, params, x, y, lr = _softmax_setup()
    xs, ys, ns = _staged(x, y, 2)
    xte, yte = x[:40], one_hot(y[:40], 2)
    geo = {k: v for k, v in GEOMETRY.items() if k != "batch_size"}
    want = ref_multi(client_axis_mesh(1), ref_model.apply, lr=lr,
                     batch_size=8, local_epochs=1, rounds_per_dispatch=3,
                     scoring="ring", **geo)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(ns, jnp.int32), jnp.asarray(COMMITTEE),
        jax.random.PRNGKey(3), jnp.asarray(xte), jnp.asarray(yte))
    got = fedavg.make_multi_round_program(
        model, lr=lr, batch_size=8, local_epochs=1, rounds_per_dispatch=3,
        scoring="ring", client_chunk=chunk, **geo)(
        model.params_from_jax(params), T(xs), T(ys),
        T(ns.astype(np.int32)), COMMITTEE, prng.PRNGKey(3), T(xte),
        T(yte))
    for f in ("uploader_masks", "committee_masks", "selected", "orders"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(_bits(got.score_matrices),
                                  _bits(want.score_matrices))
    np.testing.assert_array_equal(_bits(got.test_accs),
                                  _bits(want.test_accs))
    np.testing.assert_array_equal(got.params_fps.numpy(),
                                  np.asarray(want.params_fps)
                                  .astype(np.int64))
    # three rounds, three committees drawn on the device
    assert got.committee_masks.sum(1).tolist() == [2, 2, 2]
    assert got.uploader_masks.sum(1).tolist() == [3, 3, 3]
    assert not (got.uploader_masks & got.committee_masks).any()


def test_draw_is_the_references():
    key = prng.PRNGKey(11)
    want = np.stack([np.asarray(jax.random.uniform(k, (20,)))
                     for k in jax.random.split(jax.random.PRNGKey(11), 5)])
    np.testing.assert_array_equal(_bits(fedavg.draw_uniforms(key, 5, 20)),
                                  _bits(want))


def test_to_host_is_one_copy_of_every_dtype():
    ts = [torch.tensor([[True, False]]), torch.arange(6).reshape(2, 3),
          torch.tensor([1.5, -0.0, float("nan")]),
          torch.tensor(7.25), torch.zeros((0, 3))]
    back = mesh_runtime.to_host(ts)
    for t, b in zip(ts, back):
        assert b.dtype == t.numpy().dtype and b.shape == tuple(t.shape)
        np.testing.assert_array_equal(b.reshape(-1).view(np.uint8),
                                      t.numpy().reshape(-1).view(np.uint8))

