"""The port's whole host round against the reference's, and its guards.

- A small federated run (6 clients, committee 2, 3 admitted, top-2, a
  one-block transformer) goes through `bflc_demo_tpu.client.simulation.
  run_federated` and the port's, from the same initial params (the
  reference's, loaded with `params_from_jax`) and the same numpy data and
  visit order.  Round-1 deltas agree within the local-training tolerance
  of tests/test_torch_core.py; round 1's score ops are identical bytes,
  so the merged selection and the next committee are identical; best
  accuracy agrees within 0.02.
- The port's CPU slice runs in a subprocess that never loads JAX or the
  reference package.
- Without a card the entry points raise unless given the CPU; the CLI
  rejects the native ledger (on any runtime, the executor's too) and
  the process fleet's unported flags with exit 2, and the presets an
  unknown runtime.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bflc_demo_tpu.client import runtime as ref_runtime
from bflc_demo_tpu.client.simulation import run_federated as ref_run
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils.serialization import pack_pytree, unpack_pytree
from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.client import runtime as port_runtime
from bflc_demo_tpu_torch.client.simulation import run_federated
from bflc_demo_tpu_torch.data import iid_shards, synthetic_text_classification
from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2
from bflc_demo_tpu_torch.models import make_transformer_classifier
from bflc_demo_tpu_torch.protocol import ProtocolConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
MODEL = dict(vocab_size=64, seq_len=16, num_classes=2, dim=16, depth=1,
             heads=2)
PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=8)


def _record_deltas(monkeypatch, module, first, to_numpy):
    """Wrap `module.local_train` to keep each client's first delta."""
    inner = module.local_train

    def wrapped(*args, **kw):
        delta, cost = inner(*args, **kw)
        first.append(to_numpy(delta))
        return delta, cost
    monkeypatch.setattr(module, "local_train", wrapped)


def _score_ops(ledger, epoch):
    """The round's score ops (opcode 3) for `epoch`, as bytes."""
    ops = [ledger.log_op(i) for i in range(ledger.log_size())]
    return [op for op in ops if op[0] == 3
            and int.from_bytes(op[9 + op[1]:17 + op[1]], "little") == epoch]


def test_small_run_matches_reference(monkeypatch):
    x, y = synthetic_text_classification(300, seq_len=16, vocab_size=64,
                                         seed=1)
    shards = iid_shards(x[:240], y[:240], 6)
    test_set = (x[240:], y[240:])
    ref_model = ref_transformer(attention_impl="einsum", **MODEL)
    params = ref_model.init_params(0)
    model = make_transformer_classifier(**MODEL)

    ref_first, port_first = [], []
    _record_deltas(monkeypatch, ref_runtime, ref_first,
                   lambda d: unpack_pytree(pack_pytree(d)))
    _record_deltas(monkeypatch, port_runtime, port_first,
                   lambda d: {k: v.numpy() for k, v in d.items()})
    want = ref_run(ref_model, shards, test_set, RefConfig(**PROTO),
                   rounds=3, ledger_backend="python")
    got = run_federated(model, shards, test_set, ProtocolConfig(**PROTO),
                        rounds=3, init_params=model.params_from_jax(params),
                        device="cpu")

    # round 1: four trainers each, in the same seeded visit order
    for a, b in zip(port_first[:4], ref_first[:4]):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=k)
    # round 1's score matrices are identical bytes here (accuracies are
    # exact fractions, and the port rounds their mean as XLA does), so the
    # medians, the merged selection and the election are identical: the
    # next round's scorers are the committee round 1 elected
    round1 = _score_ops(got.ledger, 0)
    assert len(round1) == 2 and round1 == _score_ops(want.ledger, 0)
    senders = lambda ops: [op[9:9 + op[1]] for op in ops]  # noqa: E731
    assert senders(_score_ops(got.ledger, 1)) == \
        senders(_score_ops(want.ledger, 1))
    assert got.rounds_completed == want.rounds_completed == 3
    assert got.ledger.verify_log()
    assert abs(got.best_accuracy() - want.best_accuracy()) <= 0.02


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / "bflc_demo_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "bflc_demo_tpu"), \
                f"{path.relative_to(REPO)} imports {name}"


def test_scan_covers_the_bft_modules():
    """The scan above reaches the BFT layer and its types, and neither
    imports torch: a validator process is ledger and crypto only."""
    for rel in ("comm/bft.py", "protocol/types.py", "comm/identity.py",
                "comm/wire.py", "ledger/pyledger.py"):
        names = {n.split(".")[0] for n in
                 _imports(REPO / "bflc_demo_tpu_torch" / rel)}
        assert names, rel
        assert not names & {"jax", "jaxlib", "flax", "bflc_demo_tpu",
                            "torch"}, (rel, names)


def test_scan_covers_the_hier_modules():
    """The scan above reaches `hier/`; its numpy modules (the cell
    registry check and the #cellmeta codec, which the validators load)
    import no torch, and neither does anything there import JAX or the
    reference package."""
    files = sorted((REPO / "bflc_demo_tpu_torch" / "hier").rglob("*.py"))
    assert {p.name for p in files} >= {"__init__.py", "cells.py",
                                       "partial.py", "aggregator.py",
                                       "runtime.py"}
    for path in files:
        names = {n.split(".")[0] for n in _imports(path)}
        assert not names & {"jax", "jaxlib", "flax", "bflc_demo_tpu"}, \
            (path.name, names)
        if path.name in ("cells.py", "partial.py", "__init__.py"):
            assert "torch" not in names, (path.name, names)


def test_validator_child_holds_no_cuda_context():
    """A spawned validator child (the fleet's `_validator_proc`) starts,
    serves, and never imports torch, so it can hold no CUDA context."""
    import multiprocessing as mp

    from bflc_demo_tpu_torch.client import process_runtime as pr
    from bflc_demo_tpu_torch.comm.bft import (ValidatorClient,
                                              provision_validators)
    _, keys = provision_validators(1, b"slice-validator")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=pr._validator_proc,
                       args=(PROTO, b"slice-validator|bft-validator|"
                             + (0).to_bytes(8, "little"), 0, q, keys,
                             False), daemon=True)
    proc.start()
    try:
        rep = q.get(timeout=120)
        assert rep["torch_imported"] is False
        assert rep["cuda_initialized"] is False
        assert rep["foreign_modules"] == []
        vc = ValidatorClient(("127.0.0.1", rep["port"]), timeout_s=30.0)
        try:
            info = vc.request("info")
        finally:
            vc.close()
        assert info["ok"] and info["log_size"] == 0
    finally:
        proc.terminate()
        proc.join(timeout=10)
    assert not proc.is_alive()


def test_cpu_slice_runs_without_jax():
    code = (
        "import sys\n"
        "from bflc_demo_tpu_torch.eval.configs import "
        "config5_transformer_sst2\n"
        "res = config5_transformer_sst2(rounds=1, n_data=400, "
        "device='cpu')\n"
        "assert res.rounds_completed == 1 and res.ledger.verify_log()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'bflc_demo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', res.ledger_log_size)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = synthetic_text_classification(60, seq_len=16, vocab_size=64)
    model = make_transformer_classifier(**MODEL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_federated(model, iid_shards(x, y, 6), (x, y),
                      ProtocolConfig(**PROTO), rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config5_transformer_sst2(rounds=1, n_data=400)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["--rounds", "1"])


@pytest.mark.parametrize("argv", [["--config", "config2",
                                   "--chaos-seed", "7"]])
def test_cli_rejects_unported_with_exit_2(argv, capsys):
    assert cli(argv) == 2
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("runtime", ["mesh", "host"])
def test_cli_runs_the_native_ledger(runtime, capsys, monkeypatch):
    """`--ledger-backend native` runs where the reference passes it on
    (it used to exit 2): the run's ledger is the native one, and its
    head is the python ledger's."""
    from bflc_demo_tpu_torch.eval import configs
    seen = []
    real = configs.run_with_runtime

    def spy(*a, **kw):
        res = real(*a, **kw)
        seen.append(res.ledger.backend)
        return res
    monkeypatch.setattr(configs, "run_with_runtime", spy)
    heads = []
    for backend in ("native", "python"):
        assert cli(["--runtime", runtime, "--ledger-backend", backend,
                    "--device", "cpu", "--rounds", "1"]) == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        heads.append(json.loads(out)["ledger_log_head"])
    assert seen == ["native", "python"] and heads[0] == heads[1]


def test_preset_rejects_unported_runtime():
    # every runtime of the reference is ported; an unknown one is refused
    # by name, and the native ledger (once refused here) runs
    with pytest.raises(ValueError, match="runtime must be"):
        config5_transformer_sst2(runtime="mpi", device="cpu")
    with pytest.raises(ValueError, match="ledger backend must be"):
        config5_transformer_sst2(runtime="mesh", device="cpu",
                                 ledger_backend="rust")
    res = config5_transformer_sst2(runtime="mesh", device="cpu", rounds=1,
                                   n_data=400, ledger_backend="native")
    assert res.ledger.backend == "native" and res.ledger.verify_log()
