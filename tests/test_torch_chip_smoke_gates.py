"""`chip_smoke.py`'s gates on the CPU: the accuracy bars of its fleet legs
and what a failing gate does.

- Each config-5 leg holds at least the JAX tests' 0.9 and each drill at
  least the process test's 0.85, or no accuracy bar at all (the sketch
  drill, held on its bytes, drains and certificates); no bar sits at or
  below its test set's majority-class rate, which a constant predictor
  reaches.
- A failing gate prints one `{"phase": "gate_failed", "leg", "gate",
  "value", "bar"}` line before it raises, and every raise in the script
  goes through one.

The script runs its legs only on a card; these tests import it and call
its gate helpers on plain values.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

CONFIG5_BAR = 0.9          # tests/test_configs.py, config 5
DRILL_BAR = 0.85           # tests/test_netledger.py's process test


def _majority_rates():
    from bflc_demo_tpu_torch.data import load_occupancy
    from bflc_demo_tpu_torch.eval.configs import config5_data
    _, _, _, yte = load_occupancy()
    _, (_, y5) = config5_data(0, 4000, cs.CONFIG5_PROTO["client_num"])
    rates = {}
    # the fleets' 500 test rows, config 1's whole test set, config 5's
    for name, y in (("occupancy", np.asarray(yte[:500])),
                    ("occupancy_all", np.asarray(yte)),
                    ("config5", np.asarray(y5))):
        rates[name] = float(np.bincount(y.astype(np.int64)).max() / y.size)
    return rates


def test_config5_legs_hold_the_jax_bar():
    """processes, failover, BFT, TLS and async config-5 legs hold
    MIN_BEST_ACC (config5_check, async_phase); the sparse leg
    SPARSE_MIN_BEST."""
    assert cs.MIN_BEST_ACC >= CONFIG5_BAR
    assert cs.SPARSE_MIN_BEST >= CONFIG5_BAR


def test_drills_hold_the_process_test_bar():
    for name in ("FLEET_MIN_BEST", "FAILOVER_MIN_BEST"):
        assert getattr(cs, name) >= DRILL_BAR, name
    # the sketch drill: no accuracy bar, or at least the drills'
    assert cs.SKETCH_MIN_BEST is None or cs.SKETCH_MIN_BEST >= DRILL_BAR
    assert cs.CONFIG1_MIN_BEST["synthetic"] >= DRILL_BAR


def test_no_bar_at_or_below_the_majority_rate():
    rates = _majority_rates()
    for bar in (cs.FLEET_MIN_BEST, cs.FAILOVER_MIN_BEST, cs.SKETCH_MIN_BEST,
                cs.CONFIG1_MIN_BEST["synthetic"]):
        assert bar is None or bar > max(rates["occupancy"],
                                        rates["occupancy_all"]), (bar, rates)
    for bar in (cs.MIN_BEST_ACC, cs.SPARSE_MIN_BEST):
        assert bar > rates["config5"], (bar, rates)


def _lines(out: str):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_a_failing_gate_prints_its_line_and_raises(capsys):
    with pytest.raises(RuntimeError, match="bft_config5: certified ops 7"):
        raise cs.gate_failed("bft_config5", "certified ops", 7, 9)
    assert _lines(capsys.readouterr().out) == [
        {"phase": "gate_failed", "leg": "bft_config5",
         "gate": "certified ops", "value": 7, "bar": 9}]


def test_hold_passes_quietly_and_raises_at_the_first_failing_gate(capsys):
    cs.hold("sparse_config5", "rounds", True, 9, 9)
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="SPARSE refusals 2, bar 0"):
        cs.hold("sparse_config5", "SPARSE refusals", False, 2, 0)
    assert _lines(capsys.readouterr().out) == [
        {"phase": "gate_failed", "leg": "sparse_config5",
         "gate": "SPARSE refusals", "value": 2, "bar": 0}]


class _Run:
    def __init__(self, history):
        self.accuracy_history = list(enumerate(history))

    def best_accuracy(self):
        return max(a for _, a in self.accuracy_history)


@pytest.mark.parametrize("history, above, first, spare", [
    ([0.52, 0.95, 0.61, 0.99, 0.99], False, 1, 3),
    ([0.52, 0.5, 0.9, 0.7], False, 2, 1),
    ([0.52, 0.5, 0.9, 0.91], True, 3, 0),
])
def test_accuracy_gate_reports_the_evaluations_to_spare(
        capsys, history, above, first, spare):
    cs.accuracy_gate("leg", _Run(history), 0.9, above=above)
    (line,) = _lines(capsys.readouterr().out)
    assert line["phase"] == "accuracy" and line["leg"] == "leg"
    assert (line["first_at_bar"], line["spare"]) == (first, spare)
    assert line["evaluations"] == len(history) and line["bar"] == 0.9


def test_accuracy_gate_below_the_bar_fails(capsys):
    with pytest.raises(RuntimeError, match="best accuracy"):
        cs.accuracy_gate("async_config5", _Run([0.524, 0.479, 0.89]),
                         cs.MIN_BEST_ACC)
    lines = _lines(capsys.readouterr().out)
    assert lines[0]["phase"] == "accuracy" and lines[0]["spare"] is None
    assert lines[1] == {"phase": "gate_failed", "leg": "async_config5",
                        "gate": "best accuracy", "value": 0.89,
                        "bar": cs.MIN_BEST_ACC}


def test_every_raise_goes_through_a_gate():
    """No `raise RuntimeError(...)`: every failure the script raises
    printed its `gate_failed` line first."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    bare = [n.lineno for n in ast.walk(tree)
            if isinstance(n, ast.Raise) and isinstance(n.exc, ast.Call)
            and getattr(n.exc.func, "id", "") == "RuntimeError"]
    assert bare == []
    raised = [n.exc.func.id for n in ast.walk(tree)
              if isinstance(n, ast.Raise) and isinstance(n.exc, ast.Call)
              and isinstance(n.exc.func, ast.Name)]
    assert set(raised) <= {"gate_failed", "RuntimeError"}, set(raised)


def test_a_process_left_running_fails_the_run_and_is_stopped():
    """The run's end stops what it left and fails on it: a child still
    running (here a stopped one) gets a `processes left running` gate
    line and a raise, is killed and reaped, and the next check is
    clean; an orphan re-parents to the script (its subreaper)."""
    code = """
import json, os, subprocess, sys
import chip_smoke as cs
cs.adopt_orphans()
child = subprocess.Popen(["sleep", "300"])
subprocess.run(["sh", "-c", "sleep 300 & kill -STOP $!"], check=True)
try:
    cs.hold_no_processes_left("exit")
except RuntimeError as exc:
    print("raised", exc)
cs.hold_no_processes_left("exit")
print(json.dumps({"child": child.pid, "running": cs.running_children()}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    failed = [json.loads(x) for x in lines if '"gate_failed"' in x]
    assert len(failed) == 1 and failed[0]["gate"] == "processes left running"
    left = failed[0]["value"]
    final = json.loads(lines[-1])
    assert final["child"] in [pid for pid, _, _ in left] and len(left) == 2
    assert "T" in [state for _, state, _ in left]
    assert any(x.startswith("raised exit: processes left running")
               for x in lines)
    assert final["running"] == []
    counts = [json.loads(x)["left"] for x in lines if '"processes"' in x]
    assert counts[1] == []


def test_hier_legs_hold_their_bars_above_the_majority_rates():
    """`hier_config5` holds the JAX tests' 0.9 (or no bar) and the re-home
    drill the process test's 0.85, each above its test set's majority
    rate (config 5 0.52375, occupancy 0.768)."""
    rates = _majority_rates()
    assert cs.HIER_MIN_BEST is None or (
        cs.HIER_MIN_BEST >= CONFIG5_BAR
        and cs.HIER_MIN_BEST > rates["config5"])
    assert cs.HIER_DRILL_MIN_BEST is None or (
        cs.HIER_DRILL_MIN_BEST >= DRILL_BAR
        and cs.HIER_DRILL_MIN_BEST > max(rates["occupancy"],
                                         rates["occupancy_all"]))
    assert cs.HIER_DRILL_ROUNDS >= 3 and cs.HIER_INGRESS_RATIO >= 3.0


class _HierRun:
    def __init__(self, **fields):
        self.__dict__.update(fields)

    def best_accuracy(self):
        return max(a for _, a in self.accuracy_history)


def _hier_result(**over):
    """A hier run's result as `hier_account` and `hier_leg_check` read
    it: 2 cells of 3 on the root under 4 validators, 3 rounds, every
    gate passing unless `over` changes a field."""
    from bflc_demo_tpu_torch.hier.cells import plan_cells
    b5 = {"certified_reduce": 6 + 3, "flash_fwd": 4}
    res = _HierRun(
        cell_plan=plan_cells(6, cells=2), rounds_completed=3,
        accuracy_history=[(0, 0.5), (1, 0.95), (2, 0.97)],
        writer_merges=[{"blocks": 1, "merge_s": 0.01}] * 3,
        writer_engine={"selfcheck_launches": 6},
        kernel_launches={"writer": {"certified_reduce": 9},
                         "cell-0": dict(b5), "cell-1": dict(b5),
                         **{f"client-{i}": {"flash_fwd": 20,
                                            "flash_dkdv": 20,
                                            "flash_dq": 20}
                            for i in range(6)}},
        cell_merges={c: [{"leg": "mesh", "blocks": 1, "merge_s": 0.02,
                          "engine_s": 0.01, "blob_bytes": 100}] * 3
                     for c in (0, 1)},
        cell_engines={c: {"selfcheck_launches": 6} for c in (0, 1)},
        cell_bridge={c: {"upload": {"OK": 2}, "scores": {"OK": 1}}
                     for c in (0, 1)},
        root_ops=([{"op": "register", "sender": f"0xcell{c}",
                    "epoch": None} for c in (0, 1)]
                  + [{"op": op, "sender": s, "epoch": e}
                     for e in range(3)
                     for op, s in (("upload", "0xcell0"),
                                   ("scores", "0xcell1"),
                                   ("commit", None))]),
        final_info={"perf": {"costs": {"wire.bytes_in": 3000.0}}},
        failover=None, certified_size=11, ledger_log_size=11,
        validator_reports={f"validator-{v}": {"torch_imported": False,
                                              "cuda_initialized": False}
                           for v in range(4)},
        epoch_times=[(0, 1.0), (1, 2.0), (2, 3.0)], spawn_s=1.0,
        validator_spawn_s=0.5, killed_cells=[], client_exitcodes=[0] * 6,
        member_addresses=[f"0xmember{i}" for i in range(6)], phase_s={})
    for k, v in over.items():
        setattr(res, k, v)
    return res


def test_hier_account_passes_an_honest_run(capsys):
    total, by_role = cs.hier_account("hier_config5", "card", _hier_result(),
                                     1.0, 30000)
    assert by_role == {"bft_writer": 3, "cell": 6}
    assert total["certified_reduce"] == 9 and total["flash_fwd"] == 128
    cs.hier_leg_check("hier_config5", _hier_result(), 30000, 3)
    lines = _lines(capsys.readouterr().out)
    assert [x["phase"] for x in lines] == ["bft", "hier", "accuracy"]


@pytest.mark.parametrize("over, gate", [
    (dict(certified_size=10), "certified ops"),
    (dict(root_ops=[{"op": "upload", "sender": "0xcell0", "epoch": 0}]
          * 40), "root ops a round"),
    (dict(root_ops=[{"op": "upload", "sender": "0xmember0", "epoch": 0}]),
     "member addresses among the root's senders"),
    (dict(member_addresses=[]), "member addresses known"),
    (dict(cell_engines={0: {"selfcheck_launches": 7},
                        1: {"selfcheck_launches": 6}}),
     "cell B5 launches a partial"),
    (dict(final_info={"perf": {"costs": {"wire.bytes_in": 3000.0,
                                         "bft.refused.SPARSE": 1}}}),
     "validator refusals"),
    (dict(cell_bridge={0: {"upload": {"BAD_ARG": 1}}, 1: {}}),
     "BAD_ARG replies to a bridge"),
])
def test_each_hier_account_gate_raises_through_hold(capsys, over, gate):
    with pytest.raises(RuntimeError, match=gate):
        cs.hier_account("hier_config5", "card", _hier_result(**over), 1.0,
                        30000)
    failed = [x for x in _lines(capsys.readouterr().out)
              if x["phase"] == "gate_failed"]
    assert [x["gate"] for x in failed] == [gate]


@pytest.mark.parametrize("leg, over, gate", [
    ("hier_config5", dict(rounds_completed=2), "rounds"),
    ("hier_config5", dict(accuracy_history=[(0, 0.5), (1, 0.8)]),
     "best accuracy"),
    ("hier_config5", dict(final_info={"perf": {"costs": {
        "wire.bytes_in": 60000.0}}}),
     "root ingress a round below a dense partial's bytes"),
    ("hier_config5", dict(kernel_launches={"cell-0": {}, "cell-1": {}}),
     "aggregator K1 launches"),
    ("hier_rehome_drill", dict(accuracy_history=[(0, 0.85)]),
     "best accuracy above"),
    ("hier_rehome_drill", dict(accuracy_history=[(0, 0.87)],
                               killed_cells=[]), "killed cells"),
    ("hier_rehome_drill", dict(accuracy_history=[(0, 0.87)],
                               killed_cells=[1],
                               client_exitcodes=[0, 0, 0, -15, 0, 0]),
     "orphaned members' exit codes"),
])
def test_each_hier_leg_gate_raises_through_hold(capsys, leg, over, gate):
    with pytest.raises(RuntimeError, match=gate):
        cs.hier_leg_check(leg, _hier_result(**over), 30000, 3)
    failed = [x for x in _lines(capsys.readouterr().out)
              if x["phase"] == "gate_failed"]
    assert [x["gate"] for x in failed] == [gate]
