"""Checkpoints and resume: `utils/checkpoint.py` against the reference's.

Bit for bit: for the same ledger and params the three files
(`model.bflct`, `ledger.oplog`, `meta.json`) equal the reference's byte
for byte; each package loads the other's checkpoint to the same epoch,
head, committee and leaves; a tampered op is refused (ValueError) by
both.  The reference's `tests/test_aux.py:70-111` on the port: a
3-round mesh run, its checkpoint, a resume to epoch 5; the mesh
runtime's own checkpoints every N rounds and at every dispatch's end;
the CLI's `--checkpoint-dir` / `--checkpoint-every` and the line it
prints.
"""

import json
import os

import numpy as np
import pytest
import torch

from bflc_demo_tpu.ledger import make_ledger as ref_make_ledger
from bflc_demo_tpu.protocol import ProtocolConfig as RefProtocolConfig
from bflc_demo_tpu.utils import checkpoint as ref_ckpt
from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.client.mesh_runtime import run_federated_mesh
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.models import make_softmax_regression
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import checkpoint as ckpt

SMALL_KW = dict(client_num=8, comm_count=2, aggregate_count=2,
                needed_update_count=3, learning_rate=0.001, batch_size=50,
                local_epochs=1)
SMALL = ProtocolConfig(**SMALL_KW)
FILES = ("model.bflct", "ledger.oplog", "meta.json")


@pytest.fixture(scope="module")
def small_data():
    xtr, ytr, xte, yte = load_occupancy()
    return iid_shards(xtr[:2000], ytr[:2000], SMALL.client_num), \
        (xte[:500], yte[:500])


@pytest.fixture(scope="module")
def run3(small_data):
    shards, test_set = small_data
    return run_federated_mesh(make_softmax_regression(), shards, test_set,
                              SMALL, rounds=3, seed=0, device="cpu")


def _files(directory):
    return {f: open(os.path.join(directory, f), "rb").read() for f in FILES}


def _ref_ledger_of(port_ledger):
    """The reference's python ledger replaying the port's ops."""
    led = ref_make_ledger(RefProtocolConfig(**SMALL_KW), backend="python")
    for i in range(port_ledger.log_size()):
        assert int(led.apply_op(port_ledger.log_op(i))) == 0
    return led


def test_files_are_the_reference_bytes(tmp_path, run3):
    params = run3.final_params
    ckpt.save_checkpoint(str(tmp_path / "port"), params, run3.ledger,
                         extra={"acc": 0.5})
    ref_ckpt.save_checkpoint(
        str(tmp_path / "ref"), {"W": params["['W']"].numpy(),
                                "b": params["['b']"].numpy()},
        _ref_ledger_of(run3.ledger), extra={"acc": 0.5})
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    for f in FILES:
        assert got[f] == want[f], f
    assert got["ledger.oplog"].startswith(b"BFLCLOG1")
    meta = json.loads(got["meta.json"])
    assert meta == {"epoch": 3, "log_size": run3.ledger_log_size,
                    "log_head": run3.ledger_log_head.hex(), "acc": 0.5}


@pytest.mark.parametrize("backend", ["auto", "python"])
def test_each_package_loads_the_others(tmp_path, run3, backend):
    d = str(tmp_path / "c")
    ckpt.save_checkpoint(d, run3.final_params, run3.ledger)
    flat, ledger, meta = ref_ckpt.load_checkpoint(
        d, RefProtocolConfig(**SMALL_KW), ledger_backend="python")
    assert ledger.epoch == meta["epoch"] == 3
    assert ledger.log_head() == run3.ledger_log_head
    np.testing.assert_array_equal(flat["['W']"],
                                  run3.final_params["['W']"].numpy())
    d2 = str(tmp_path / "r")
    ref_ckpt.save_checkpoint(d2, {"W": flat["['W']"], "b": flat["['b']"]},
                             ledger, extra={"from": "reference"})
    flat2, ledger2, meta2 = ckpt.load_checkpoint(d2, SMALL,
                                                 ledger_backend=backend)
    assert ledger2.backend == ("native" if backend == "auto" else "python")
    assert ledger2.epoch == 3 and meta2["from"] == "reference"
    assert ledger2.log_head() == run3.ledger_log_head
    assert sorted(ledger2.committee()) == sorted(run3.ledger.committee())
    params = ckpt.restore_params_like(make_softmax_regression()
                                      .init_params(0), flat2)
    for k, v in run3.final_params.items():
        assert torch.equal(params[k], v)


@pytest.mark.parametrize("who", ["port", "reference"])
def test_tampered_oplog_rejected_by_both(tmp_path, run3, who):
    d = str(tmp_path / "c")
    ckpt.save_checkpoint(d, run3.final_params, run3.ledger)
    path = os.path.join(d, "ledger.oplog")
    blob = bytearray(open(path, "rb").read())
    blob[40] ^= 0xFF          # flip a byte inside the first op
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError):
        if who == "port":
            ckpt.load_checkpoint(d, SMALL)
        else:
            ref_ckpt.load_checkpoint(d, RefProtocolConfig(**SMALL_KW),
                                     ledger_backend="python")


def test_restore_params_like_checks_keys_and_shapes(run3):
    template = make_softmax_regression().init_params(0)
    flat = {k: v.numpy() for k, v in run3.final_params.items()}
    with pytest.raises(KeyError, match="checkpoint missing leaf"):
        ckpt.restore_params_like(template, {"['W']": flat["['W']"]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_params_like(template, dict(flat, **{
            "['b']": np.zeros(3, np.float32)}))


def test_roundtrip_and_resume(tmp_path, small_data, run3):
    """The reference's test_roundtrip_and_resume on the port."""
    shards, test_set = small_data
    model = make_softmax_regression()
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, run3.final_params, run3.ledger)
    flat, ledger, meta = ckpt.load_checkpoint(d, SMALL)
    assert meta["epoch"] == 3 and ledger.epoch == 3
    assert ledger.log_head() == run3.ledger_log_head
    assert sorted(ledger.committee()) == sorted(run3.ledger.committee())
    params = ckpt.restore_params_like(model.init_params(0), flat)
    np.testing.assert_array_equal(params["['W']"].numpy(),
                                  run3.final_params["['W']"].numpy())
    r2 = run_federated_mesh(model, shards, test_set, SMALL, rounds=2,
                            seed=1, initial_params=params,
                            resume_ledger=ledger, device="cpu")
    assert r2.ledger.epoch == 5 and r2.ledger.verify_log()
    assert r2.ledger_log_size == run3.ledger_log_size + 2 * (3 + 2 + 1)
    assert all(np.isfinite(a) for _, a in r2.accuracy_history)
    with pytest.raises(ValueError, match="initial_params"):
        run_federated_mesh(model, shards, test_set, SMALL, rounds=1,
                           resume_ledger=ledger, device="cpu")


@pytest.mark.parametrize("dispatch", [1, 2])
def test_mesh_runtime_checkpoints_as_it_runs(tmp_path, small_data, dispatch):
    """Every N rounds (one round a dispatch) or at every dispatch's end:
    the directory holds the run's last checkpoint, which resumes."""
    shards, test_set = small_data
    d = str(tmp_path / "ckpt")
    res = run_federated_mesh(make_softmax_regression(), shards, test_set,
                             SMALL, rounds=4, seed=0, checkpoint_dir=d,
                             checkpoint_every=2,
                             rounds_per_dispatch=dispatch, device="cpu")
    flat, ledger, meta = ckpt.load_checkpoint(d, SMALL)
    assert meta["epoch"] == ledger.epoch == 4
    assert ledger.log_head() == res.ledger_log_head
    assert meta["acc"] == pytest.approx(res.accuracy_history[-1][1])
    np.testing.assert_array_equal(flat["['W']"],
                                  res.final_params["['W']"].numpy())


def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "cli")
    assert cli(["--device", "cpu", "--rounds", "4", "--checkpoint-dir", d,
                "--checkpoint-every", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == f"checkpoint (model + ledger oplog) -> {d}"
    run = json.loads(out[-1])
    flat, ledger, meta = ckpt.load_checkpoint(d, ProtocolConfig())
    assert meta["config"] == "config1" and meta["rounds"] == 4
    assert ledger.epoch == 4 and ledger.log_head().hex() == \
        run["ledger_log_head"]
    xtr, ytr, xte, yte = load_occupancy()
    model = make_softmax_regression()
    res = run_federated_mesh(
        model, iid_shards(xtr, ytr, 20), (xte, yte), ProtocolConfig(),
        rounds=2, seed=1, resume_ledger=ledger, device="cpu",
        initial_params=ckpt.restore_params_like(model.init_params(0), flat))
    assert res.ledger.epoch == 6 and res.ledger.verify_log()
