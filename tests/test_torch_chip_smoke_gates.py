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
