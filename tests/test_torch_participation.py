"""Active participation, client_chunk and remat: the port against the JAX
package's mesh runtime, and against itself.

- An MLP run (cheap, so it tests the runtime's mechanics) with
  `participation="active"`, `client_chunk=2` and `remat=True`, 2 rounds,
  on 10 Dirichlet shards: each round's uploaders, committee and
  selection, the sponsor's accuracies and the ledger's size equal the
  reference's `run_federated_mesh` on a one-device mesh (as
  `tests/test_torch_mesh.py` runs it).  The audit maps device slots
  [uploaders | committee] back to client ids; a wrong mapping changes
  the ledger's ops.
- Chunked and remat runs are the unchunked run of the port bit for bit
  on the CPU (final params, accuracies, ledger head), for the MLP and
  LeNet-5 (a vmapped conv), with full and active participation: chunks
  run the same per-slot arithmetic, remat recomputes the same forward.
- The guards: a chunk that does not divide the slots raises, as in the
  reference; active participation stages every client once (the padding
  is the largest shard of all clients).
- Config 4 through the CLI on the CPU at its preset's data: the preset
  turns the three options on.
"""

import json
import os

import numpy as np
import pytest
import torch

from bflc_demo_tpu.client import mesh_runtime as ref_mesh_runtime
from bflc_demo_tpu.models import make_mlp as ref_mlp
from bflc_demo_tpu.parallel.mesh import client_axis_mesh
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.client import mesh_runtime
from bflc_demo_tpu_torch.core.local_train import sgd_stacked
from bflc_demo_tpu_torch.data import (dirichlet_shards,
                                      synthetic_image_classification)
from bflc_demo_tpu_torch.models import make_lenet5, make_mlp
from bflc_demo_tpu_torch.protocol import ProtocolConfig

GEOMETRY = dict(client_num=10, comm_count=2, aggregate_count=2,
                needed_update_count=4, learning_rate=0.05, batch_size=10,
                local_epochs=2)
SHAPE = (8, 8, 1)


@pytest.fixture(autouse=True, scope="module")
def _share_of_the_cores():
    """The CPU path on this worker's share of the cores: the suite may run
    files in parallel workers (pytest-xdist), and small convolutions
    split over every core in every worker spend their time in thread
    barriers."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)


def _data(shape=SHAPE, n=700, clients=10):
    x, y = synthetic_image_classification(n, shape, 4, seed=0)
    n_train = n * 4 // 5
    return (dirichlet_shards(x[:n_train], y[:n_train], clients, alpha=1.0,
                             seed=0, min_size=GEOMETRY["batch_size"]),
            (x[n_train:], y[n_train:]))


def _record(monkeypatch, module, log):
    inner = module.audit_round

    def wrapped(ledger, addr_of, epoch, ups, comm, *rest):
        inner(ledger, addr_of, epoch, ups, comm, *rest)
        log.append((epoch, list(ups), list(comm),
                    sorted(int(s) for s in rest[6])))
    monkeypatch.setattr(module, "audit_round", wrapped)


def test_active_chunked_remat_mlp_matches_reference(monkeypatch):
    shards, test_set = _data()
    ref_log, port_log = [], []
    _record(monkeypatch, ref_mesh_runtime, ref_log)
    _record(monkeypatch, mesh_runtime, port_log)
    opts = dict(rounds=2, participation="active", client_chunk=2,
                remat=True)
    want = ref_mesh_runtime.run_federated_mesh(
        ref_mlp(SHAPE, 32, 4), shards, test_set, RefConfig(**GEOMETRY),
        mesh=client_axis_mesh(1), ledger_backend="python", **opts)
    got = mesh_runtime.run_federated_mesh(
        make_mlp(SHAPE, 32, 4), shards, test_set, ProtocolConfig(**GEOMETRY),
        device="cpu", **opts)
    assert len(port_log) == 2 and port_log == ref_log
    # the slots are the round's participants only: 4 uploaders, 2 scorers
    assert all(len(ups) == 4 and len(comm) == 2 for _, ups, comm, _ in
               port_log)
    for (_, a), (_, b) in zip(got.accuracy_history, want.accuracy_history):
        assert abs(a - b) <= 1e-4
    assert got.ledger_log_size == want.ledger_log_size == 10 + 2 * (4 + 2 + 1)
    assert got.ledger.verify_log()


def _run(make_model, shape, participation, **kw):
    shards, test_set = _data(shape)
    return mesh_runtime.run_federated_mesh(
        make_model(), shards, test_set, ProtocolConfig(**GEOMETRY),
        rounds=2, participation=participation, device="cpu", **kw)


MODELS = {"mlp": (lambda: make_mlp(SHAPE, 32, 4), SHAPE),
          "lenet5": (lambda: make_lenet5((12, 12, 3), 4), (12, 12, 3))}


@pytest.mark.parametrize("participation", ["full", "active"])
@pytest.mark.parametrize("name", list(MODELS))
def test_chunk_and_remat_change_no_bit(name, participation):
    make_model, shape = MODELS[name]
    base = _run(make_model, shape, participation)
    # active: 6 slots in chunks of 2 or 3; full: 10 slots in chunks of 2
    chunk = 3 if participation == "active" else 2
    for kw in (dict(client_chunk=2), dict(remat=True),
               dict(client_chunk=chunk, remat=True)):
        res = _run(make_model, shape, participation, **kw)
        assert res.accuracy_history == base.accuracy_history, kw
        assert res.ledger.log_head() == base.ledger.log_head(), kw
        for k, v in base.final_params.items():
            assert torch.equal(res.final_params[k], v), (kw, k)


def test_sgd_chunks_must_divide_the_slots():
    model = make_mlp(SHAPE, 8, 4)
    xs = torch.zeros((6, 10) + SHAPE)
    ys = torch.zeros((6, 10, 4))
    with pytest.raises(ValueError, match="client_chunk 4"):
        sgd_stacked(model, model.init_params(0), xs, ys, 0.1, 5,
                    client_chunk=4)
    with pytest.raises(ValueError, match="not divisible by client_chunk"):
        _run(MODELS["mlp"][0], SHAPE, "active", client_chunk=4)


def test_active_slots_take_the_global_padding(monkeypatch):
    """Every client is staged once; a round copies its participants' rows
    of those arrays, so a slot's padded shard is the same whatever the
    round (the reference's `xs_np[active]`, :495-499)."""
    seen = []
    inner = mesh_runtime.make_sharded_protocol_round

    def spy(*args, **kw):
        fn = inner(*args, **kw)

        def round_fn(params, xs, ys, ns, up, comm):
            seen.append((xs.shape, ns.tolist(), np.asarray(up).tolist()))
            return fn(params, xs, ys, ns, up, comm)
        return round_fn
    monkeypatch.setattr(mesh_runtime, "make_sharded_protocol_round", spy)
    shards, _ = _data()
    _run(MODELS["mlp"][0], SHAPE, "active")
    s_pad = max(len(sx) for sx, _ in shards)
    sizes = {len(sx) for sx, _ in shards}
    assert len(seen) == 2
    for shape, ns, up in seen:
        assert shape == (6, s_pad) + SHAPE
        assert set(ns) <= sizes and up == [True] * 4 + [False] * 2


def test_cli_runs_config4_active_chunked_remat(monkeypatch, capsys):
    """`--config config4` through the CLI on the CPU at the preset's data
    (ResNet-18, CIFAR-100 shapes, 32 clients) with a 2 + 2 committee
    geometry: the preset turns on active participation (4 slots),
    client_chunk 4 and remat on the mesh runtime."""
    built = []
    inner = mesh_runtime.make_sharded_protocol_round

    def spy(*args, **kw):
        built.append(kw)
        return inner(*args, **kw)
    monkeypatch.setattr(mesh_runtime, "make_sharded_protocol_round", spy)
    assert cli(["--config", "config4", "--device", "cpu", "--rounds", "1",
                "--client-num", "32", "--comm-count", "2",
                "--aggregate-count", "2", "--needed-update-count", "2",
                "--learning-rate", "0.1", "--batch-size", "16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config"] == "config4"
    assert out["ledger_log_size"] == 32 + 2 + 2 + 1
    assert len(built) == 1
    assert (built[0]["client_num"], built[0]["client_chunk"],
            built[0]["remat"]) == (4, 4, True)
