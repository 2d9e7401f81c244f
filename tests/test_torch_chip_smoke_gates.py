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
        member_addresses=[f"0xmember{i}" for i in range(6)], phase_s={},
        writer_backend="native")
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
    (dict(writer_backend="python"), "ledger backend"),
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


# ------------------------------------------------- the rederive legs
def test_rederive_leg_holds_the_jax_bar_with_its_rounds():
    """`rederive_config5` holds the JAX tests' 0.9 above config 5's
    majority rate, over the sync fleets' 9 rounds at least (its CPU
    trajectories first reached 0.9 by round 4, PERF.md section 6), on a
    sparse genome whose closed loop has room to move."""
    rates = _majority_rates()
    assert cs.REDERIVE_MIN_BEST >= CONFIG5_BAR
    assert cs.REDERIVE_MIN_BEST > rates["config5"]
    assert cs.REDERIVE_C5_ROUNDS >= cs.FLEET_C5_ROUNDS
    proto = cs.REDERIVE_PROTO
    assert proto["adapt_every"] > 0
    assert proto["density_floor"] < proto["delta_density"] < 1.0
    assert cs.REDERIVE_FLEET["rederive"] in ("shard", "full")
    assert cs.REDERIVE_LIE_TIMEOUT_S < cs.REDERIVE_DRILL_TIMEOUT_S


_KNOBS = {"eff_density": 0.025, "eff_staleness": 20, "genome_epoch": 4}


def _rederive_result(**over):
    """A `rederive_config5` result as `rederive_account` reads it: 4
    commits on one writer at 8 blocks, 4 armed validators re-deriving
    each on B5, two genome ops; every gate passes unless `over` changes
    a field."""
    blocks = cs.REDERIVE_PROTO["reduce_blocks"]
    validators = {f"validator-{v}": {
        "torch_imported": True, "cuda_initialized": False,
        "rederive": {"ok": 4, "refused": 0, "skipped": 0},
        "engine": {"selfcheck_launches": 6}, "genome": dict(_KNOBS)}
        for v in range(4)}
    res = _HierRun(
        rounds_completed=cs.REDERIVE_C5_ROUNDS,
        accuracy_history=[(0, 0.6), (1, 0.95), (2, 0.97), (3, 0.99)],
        writer_merges=[{"blocks": blocks, "merge_s": 0.02}] * 4,
        writer_engine={"selfcheck_launches": 6}, failover=None,
        kernel_launches={"writer": {"certified_reduce": 6 + 4 * blocks},
                         **{r: {"certified_reduce": 6 + 4 * blocks}
                            for r in validators}},
        validator_reports=validators,
        writer_genomes=[{"new_density": 0.05}, {"new_density": 0.025}],
        final_info=dict(_KNOBS, perf={"costs": {}}),
        replica_report=dict(_KNOBS), certified_size=40,
        ledger_log_size=40, epoch_times=[(0, 1.0), (3, 4.0)],
        spawn_s=1.0, validator_spawn_s=0.5, client_perf={},
        client_counts={})
    for k, v in over.items():
        setattr(res, k, v)
    return res


def test_rederive_account_passes_an_honest_run(capsys):
    total, by_role = cs.rederive_account(
        "rederive_config5", "card", _rederive_result(),
        {"certified_reduce": 5 * 32 + 24}, 1.0)
    assert by_role == {"bft_writer": 32, "validator": 128}
    assert total["certified_reduce"] == 5 * 32
    lines = _lines(capsys.readouterr().out)
    assert [x["phase"] for x in lines] == ["bft", "rederive", "accuracy"]


def _bad_validator(**fields):
    reports = _rederive_result().validator_reports
    reports["validator-2"] = dict(reports["validator-2"], **fields)
    return reports


@pytest.mark.parametrize("over, gate", [
    (dict(rounds_completed=1), "rounds"),
    (dict(accuracy_history=[(0, 0.6)]), "best accuracy"),
    (dict(final_info=dict(_KNOBS, perf={"costs": {
        "bft.refused.REDERIVE": 1}})), "REDERIVE and SPARSE refusals"),
    (dict(validator_reports=_bad_validator(rederive={
        "ok": 3, "refused": 0, "skipped": 0})),
     "every validator re-derived every commit"),
    (dict(validator_reports=_bad_validator(rederive={
        "ok": 4, "refused": 0, "skipped": 1})),
     "every validator re-derived every commit"),
    (dict(validator_reports=_bad_validator(
        engine={"selfcheck_launches": 6 + 32})),
     "B5 launches in every validator"),
    (dict(writer_genomes=[]), "genome ops on the chain"),
    (dict(validator_reports=_bad_validator(genome=dict(
        _KNOBS, eff_density=0.05))), "validators' knobs equal the writer's"),
    (dict(replica_report=dict(_KNOBS, genome_epoch=2)),
     "replica's knobs equal the writer's"),
    (dict(writer_genomes=[{"new_density": cs.REDERIVE_PROTO[
        "delta_density"]}]), "density moved"),
    (dict(validator_reports=_bad_validator(torch_imported=False)),
     "validators with torch"),
])
def test_each_rederive_gate_raises_through_hold(capsys, over, gate):
    with pytest.raises(RuntimeError, match=gate):
        cs.rederive_account("rederive_config5", "card",
                            _rederive_result(**over),
                            {"certified_reduce": 0}, 1.0)
    failed = [x for x in _lines(capsys.readouterr().out)
              if x["phase"] == "gate_failed"]
    assert [x["gate"] for x in failed] == [gate]


# ------------------------------------------------- the executor legs
def test_executor_leg_holds_the_jax_bar_above_the_majority_rate():
    """`executor_config5` holds the JAX tests' 0.9, above config 5's
    majority rate (0.52375), over its rounds."""
    rates = _majority_rates()
    assert cs.EXECUTOR_MIN_BEST >= CONFIG5_BAR
    assert cs.EXECUTOR_MIN_BEST > rates["config5"]
    assert cs.EXECUTOR_C5_ROUNDS >= 5
    assert cs.EXECUTOR_TAMPER_TIMEOUT_S > 0 and cs.EXECUTOR_CLI_ROUNDS == 3


@pytest.mark.parametrize("cfg, rounds, size", [
    (cs.FLEET_PROTO, 3, 6 + 3 * (3 + 2 + 1)),   # test_mesh_executor.py:38
    (cs.CONFIG5_PROTO, 10, 20 + 10 * (10 + 4 + 1)),
    (dict(client_num=20, comm_count=4, needed_update_count=10), 3, 65),
])
def test_executor_log_size_is_registrations_plus_k_c_and_commit(cfg, rounds,
                                                                 size):
    assert cs.executor_log_size(cfg, rounds) == size


def test_executor_per_round_is_the_mesh_round_less_the_sponsor():
    assert cs.EXECUTOR_PER_ROUND == {
        "flash_fwd": 22, "flash_dkdv": 20, "flash_dq": 20,
        "flash_carry": 0, "fingerprint": 2, "certified_reduce": 0}


def _executor_result(rounds: int = 3, **over):
    """An `executor_config5` result as `executor_account` reads it: 20
    thin clients, members 0-3 attesting every round, every evaluation
    seen; every gate passes unless `over` changes a field."""
    members = range(4)
    counts = {f"thin-{i}": {"attested": rounds if i in members else 0,
                            "evaluations": rounds,
                            "attest_launches": (
                                {"flash_fwd": 2 * rounds} if i in members
                                else {})}
              for i in range(20)}
    launches = {"executor": {k: v * rounds
                             for k, v in cs.EXECUTOR_PER_ROUND.items()},
                **{r: {"flash_fwd": 2 * (c["evaluations"] + c["attested"])}
                   for r, c in counts.items()},
                "sponsor": {"flash_fwd": 2 * rounds}}
    res = _HierRun(
        rounds_completed=rounds, ledger_log_size=20 + rounds * 15,
        executor={"rounds_done": rounds, "rounds": [
            {"round_s": 2.0, "device_s": 0.1, "attest_s": 1.9,
             "evidence_bytes": 21_432_170}] * rounds},
        kernel_launches=launches, client_counts=counts,
        accuracy_history=[(e, a) for e, a in
                          enumerate([0.6, 0.95, 0.97][:rounds])],
        client_exitcodes=[0] * 20, spawn_s=9.0, stage_s=9.5,
        epoch_times=[(e, 10.0 + 2 * e) for e in range(rounds)],
        writer_backend="native")
    for k, v in over.items():
        setattr(res, k, v)
    return res


def test_executor_account_passes_an_honest_run(capsys):
    total = cs.executor_account("executor_config5", "card",
                                _executor_result(), cs.CONFIG5_PROTO, 3,
                                1.0)
    assert total["flash_fwd"] == 66 + 2 * (20 * 3 + 12) + 6
    lines = _lines(capsys.readouterr().out)
    assert [x["phase"] for x in lines] == ["executor", "accuracy"]
    assert lines[0]["attest_wait_s"] == [1.9] * 3


def _with_thin(role: str, **fields):
    res = _executor_result()
    counts = dict(res.client_counts)
    counts[role] = dict(counts[role], **fields)
    return counts


@pytest.mark.parametrize("over, gate", [
    (dict(rounds_completed=2, ledger_log_size=50), "rounds"),
    (dict(executor={"rounds_done": 2, "rounds": []}),
     "executor rounds done"),
    (dict(ledger_log_size=64), "ledger log size"),
    (dict(kernel_launches=dict(_executor_result().kernel_launches,
                               executor={"flash_fwd": 66})),
     "executor launches at the mesh round's counts"),
    (dict(client_counts=_with_thin("thin-0", attested=2)),
     "attestations"),
    (dict(client_counts=_with_thin("thin-1", attest_launches={})),
     "member K1 a re-score"),
    (dict(client_counts=_with_thin("thin-9", evaluations=0)),
     "thin client K1"),
    (dict(kernel_launches=dict(_executor_result().kernel_launches,
                               sponsor={})), "sponsor K1"),
    (dict(client_exitcodes=[0] * 19 + [-15]), "thin clients' exit codes"),
    (dict(accuracy_history=[(0, 0.6), (1, 0.8), (2, 0.85)]),
     "best accuracy"),
    (dict(writer_backend="python"), "ledger backend"),
])
def test_each_executor_gate_raises_through_hold(capsys, over, gate):
    with pytest.raises(RuntimeError, match=gate):
        cs.executor_account("executor_config5", "card",
                            _executor_result(**over), cs.CONFIG5_PROTO, 3,
                            1.0)
    failed = [x for x in _lines(capsys.readouterr().out)
              if x["phase"] == "gate_failed"]
    assert [x["gate"] for x in failed] == [gate]


@pytest.mark.parametrize("knobs, compacts, want", [
    (dict(), False, "native"),
    (dict(delta_density=0.01, delta_codec="topk"), False, "native"),
    (dict(async_buffer=10), False, "python"),
    (dict(reduce_blocks=8), False, "python"),
    (dict(delta_density=0.1, adapt_every=2), False, "python"),
    (dict(), True, "python"),
])
def test_reference_backend_follows_the_references_gates(knobs, compacts,
                                                        want, capsys):
    """The writer ledger each leg is held to: native unless the config is
    async, blocked or adaptive or the writer compacts (the reference's
    `make_ledger` and snapshot gates), and the port's `make_ledger`
    agrees; a leg whose writer ran the other backend fails by name."""
    from bflc_demo_tpu_torch.ledger import make_ledger
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    cfg = ProtocolConfig(**dict(cs.CONFIG5_PROTO, **knobs))
    assert cs.reference_backend(cfg, compacts) == want
    if not compacts:
        assert make_ledger(cfg).backend == want
    cs.hold_backend("leg", want, want)
    other = "python" if want == "native" else "native"
    with pytest.raises(RuntimeError, match="ledger backend"):
        cs.hold_backend("leg", other, want)
    failed = [x for x in _lines(capsys.readouterr().out)
              if x["phase"] == "gate_failed"]
    assert [(x["gate"], x["value"], x["bar"]) for x in failed] == \
        [("ledger backend", other, want)]


# ------------------------------------------------------ the secure legs
def _b7_rounds(slots=4, n=300, rounds=2, seed=0):
    """B7's plain rounds (one leaf each), as `B7Tap` keeps them: (leaves,
    wn, packed keys, clip, words, views)."""
    import torch
    from bflc_demo_tpu_torch.ops import secure_mask as sm
    from bflc_demo_tpu_torch.parallel import secure
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        keys = torch.as_tensor(secure.leaf_pair_keys(
            np.array([0, r], np.uint32), slots, 1, False).view(np.int32))
        d = torch.as_tensor((rng.standard_normal((slots, n)) * 30)
                            .astype(np.float32))
        d[0, 5] = float("nan")
        w = torch.as_tensor(rng.random(slots).astype(np.float32))
        w = w / w.sum()
        words, views = sm.masked_encode_leaves_plain([d], w, keys, 64.0)
        out.append(([d], w, keys, 64.0, words, views))
    return out


class _Tap(cs.B7Tap):
    def __init__(self, rounds):
        from bflc_demo_tpu_torch.ops import secure_mask
        self.sm, self.rounds = secure_mask, rounds


def test_b7_gates_pass_on_honest_words(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    tap = _Tap(_b7_rounds())
    merged = cs.b7_merge_hold(torch, "leg", tap)
    assert merged["merges_held"] == 2
    assert merged["max_share_of_fixed_point_bound"] <= 1.0
    held = cs.b7_hold(torch, "leg", tap)
    assert held["words_mismatched"] == 0 and held["leaves"] == 1
    assert held["max_share_equal_unmasked"] <= cs.SECURE_BLIND_SHARE


@pytest.mark.parametrize("fault,gate", [
    ("masks", "slot words blinded"),
    ("word", "sum over slots vs unmasked"),
    ("merge", "masked merge vs plain mean")])
def test_each_b7_gate_raises_through_hold(monkeypatch, capsys, fault, gate):
    """Unmasked words (the masks left out), one flipped word, and a merge
    off by one fixed-point unit in every slot each fail their gate."""
    import torch
    from bflc_demo_tpu_torch.ops import secure_mask as sm
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    (leaves, w, keys, clip, words, _), = _b7_rounds(rounds=1)
    q = sm.encode_plain(leaves[0], w, clip)
    if fault == "masks":
        words = (q - ((q >> 31) << 32)).to(torch.int32)
    elif fault == "word":
        words = words.clone()
        words[1, 7] += 1
    else:
        words = words.clone() + 3
    tap = _Tap([(leaves, w, keys, clip, words, [words])])
    with pytest.raises(RuntimeError, match=gate):
        (cs.b7_merge_hold if fault == "merge" else cs.b7_hold)(
            torch, "leg", tap)
    failed = [x for x in _lines(capsys.readouterr().out)
              if x["phase"] == "gate_failed"]
    assert len(failed) == 1 and gate in failed[0]["gate"]


def test_b7_tap_keeps_each_round_leaf_by_leaf():
    """The tap's rounds read leaf by leaf: every round's leaves in
    `calls`, the last round's in `last`, each with its packed (S(S-1)/2,
    2) keys and its view of the round's words."""
    import torch
    rounds = _b7_rounds(rounds=3)
    tap = _Tap(rounds)
    assert len(tap.calls) == 3 and sorted(tap.last) == [0]
    d, w, keys, clip, words = tap.last[0]
    leaves, _, packed, _, round_words, _ = rounds[-1]
    assert d is leaves[0] and torch.equal(words, round_words)
    assert torch.equal(keys, packed[0])


@pytest.mark.parametrize("lop3,per,words", [
    (42, 2, 2), (84, 2, 4), (21, 1, 1), (42, 1, 2), (40, 2, None),
    (21, 2, None), (0, 1, None)])
def test_b7_mask_words_a_pass_from_lop3(capsys, lop3, per, words):
    """The pair loop's LOP3s (21 a mask word) give the words a pass
    draws, an unrolled loop's too; a count that is no whole number of
    passes at `per` elements a thread fails its gate."""
    loop = {"opcodes": {"LOP3.LUT": lop3, "SHF.L.W.U32.HI": 20 * per}}
    if words is not None:
        assert cs.b7_mask_words_a_pass(loop, per) == words
        return
    with pytest.raises(RuntimeError, match="LOP3"):
        cs.b7_mask_words_a_pass(loop, per)
    failed = [x for x in _lines(capsys.readouterr().out)
              if x["phase"] == "gate_failed"]
    assert [x["value"] for x in failed] == [lop3]


def test_b7_launch_gates_are_one_a_round():
    """B7 is one launch a round: `secure_config4`'s 2 rounds hold it at
    2 (B6 at 2 a round beside it, nothing else), and
    `secure_dispatch_config5`'s 10 rounds at 10 (`dispatch_run` times
    the per-round counts by its rounds)."""
    counts = {"flash_fwd": 7, "fingerprint": 4, "secure_mask": 2}
    want = cs.secure_c4_launches(counts)
    assert want == {"flash_fwd": 0, "fingerprint": 4, "secure_mask": 2}
    assert cs.SECURE_C5_PER_ROUND["secure_mask"] \
        * cs.DISPATCH_ROUNDS == 10
    assert {k: v for k, v in cs.SECURE_C5_PER_ROUND.items()
            if k != "secure_mask"} == cs.MESH_PER_ROUND


def test_b7_bound_counts_each_pair_once():
    ops, moved = cs.b7_work(16, 11_220_132)
    assert ops == 120 * 11_220_132 * cs.B7_OPS_PER_MASK
    assert moved == 16 * 11_220_132 * 8
    assert cs.B7_OPS_PER_MASK == 74
    assert cs.INT_ISSUE_OPS == cs.F32_CUDA_CORE_OPS / 2


@pytest.mark.parametrize("got,want,first", [
    ([1, 2, 3], [1, 2, 3], None), ([1, 2, 4], [1, 2, 3], 2),
    ([0], [1], 0), ([1, 2], [1, 2, 3], 2)])
def test_first_divergence(got, want, first):
    assert cs.first_divergence(got, want) == first


def test_upload_args_read_a_signed_upload():
    from bflc_demo_tpu_torch.comm.identity import _op_bytes
    body = b"\x07" * 32 + __import__("struct").pack("<qd", 137, 0.625)
    args = cs.upload_args(_op_bytes("upload", "0x" + "12" * 20, 9, body))
    assert args == ("0x" + "12" * 20, b"\x07" * 32, 137, 0.625, 9)


def test_counting_keyring_counts_and_keeps_uploads():
    from bflc_demo_tpu_torch.comm.identity import (KeyRing, sign_register,
                                                   sign_upload)
    ring = cs.CountingKeyRing(b"keyring-threaded-master-0001")
    assert ring.mac("0x01", b"x") == KeyRing(
        b"keyring-threaded-master-0001").mac("0x01", b"x")
    tag = sign_upload(ring, "0x01", b"\1" * 32, 5, 1.0, 3)
    from bflc_demo_tpu_torch.comm.identity import _op_bytes
    import struct
    ob = _op_bytes("upload", "0x01", 3,
                   b"\1" * 32 + struct.pack("<qd", 5, 1.0))
    assert ring.verify("0x01", ob, tag)
    assert not ring.verify("0x02", ob, tag)
    assert ring.verify("0x01", _op_bytes("register", "0x01", 0, b""),
                       sign_register(ring, "0x01"))
    assert ring.verified == {"upload": 1, "register": 1}
    assert ring.refused == 1
    assert ring.uploads[("0x01", 3, ("01" * 32))] == (ob, tag)


class _DoneChild:
    def __init__(self, rc):
        self.returncode = rc

    def wait(self, timeout=None):
        return self.returncode

    def kill(self):
        pass


@pytest.mark.parametrize("rc", [0, 1])
def test_keyring_child_line_printed_again_or_its_failure_raised(
        tmp_path, capsys, rc):
    """The keyring leg's child: its leg's line printed again by the
    parent with the child's launches returned, or, when it exited
    non-zero, its failing gate's line printed again and the parent's
    own gate raised."""
    import time
    base = str(tmp_path / "keyring_leg")
    launches = {"flash_fwd": 3, "secure_mask": 0}
    leg = {"phase": "keyring", "path": "keyring_threaded_config5",
           "launches": launches, "t": 4.5}
    gate = {"phase": "gate_failed", "leg": "keyring_threaded_config5",
            "gate": "impostor forged_tag refused", "value": "OK",
            "bar": ["BAD_ARG"]}
    with open(base + ".out", "w") as f:
        f.write("NVIDIA H100\n" + json.dumps(gate if rc else leg) + "\n")
    with open(base + ".err", "w") as f:
        f.write("Traceback: the child's error\n" if rc else "")
    started = (_DoneChild(rc), time.perf_counter(), base)
    if rc == 0:
        assert cs.keyring_child_finish(started) == launches
        (line,) = _lines(capsys.readouterr().out)
        assert line["phase"] == "keyring" and line["child_t"] == 4.5
        assert line["launches"] == launches
        return
    with pytest.raises(RuntimeError, match="child's error"):
        cs.keyring_child_finish(started)
    printed = _lines(capsys.readouterr().out)
    assert printed[0] == gate
    assert printed[1]["gate"] == "child exit code" and printed[1]["value"] == 1
