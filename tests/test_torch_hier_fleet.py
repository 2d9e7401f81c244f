"""The port's hier fleet as OS processes on the CPU
(`bflc_demo_tpu_torch/hier/runtime.run_federated_hier`).

- The reference's two e2e scenarios (`tests/test_hier.py`
  `TestHierFederationE2E`) at softmax scale, 2 cells x 3 members: the
  fleet converges through the root's committed model with every member
  finishing its rounds; with 4 validators at the root every root op is
  certified, a round costs at most 6 root ops and no member address ever
  sends one.
- The re-home drill, `kill_cell_at_epoch` in place of the reference's
  `ChaosCampaign` (`tests/test_chaos.py` `TestCellAggregatorKill`): cell
  1's aggregator is SIGKILLed at root epoch 1 and its two members finish
  their rounds through the ring sibling (exit 0).
- A scaled-down headline (the reference's `TPU_RESULTS.md` hier
  scaling): 2 cells at 6 and at 12 clients give equal root ops a round
  and root egress a round within 1.2x.
- `--cells` through the CLI on `--device cpu`, and the combinations it
  refuses.
"""

import json

import pytest

from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.hier.runtime import run_federated_hier
from bflc_demo_tpu_torch.protocol import ProtocolConfig

E2E = dict(comm_count=2, aggregate_count=2, needed_update_count=2,
           learning_rate=0.05, batch_size=32, local_epochs=2)


def _fleet(n_clients: int, rows: int = 1800):
    cfg = ProtocolConfig(client_num=n_clients, **E2E).validate()
    xtr, ytr, xte, yte = load_occupancy()
    return cfg, iid_shards(xtr[:rows], ytr[:rows], n_clients), \
        (xte[:400], yte[:400])


def test_two_cell_federation_converges():
    cfg, shards, test = _fleet(6)
    res = run_federated_hier("make_softmax_regression", shards, test, cfg,
                             rounds=3, cells=2, timeout_s=200.0,
                             device="cpu")
    assert res.rounds_completed >= 3
    assert res.best_accuracy() > 0.70, res.accuracy_history
    assert all(c == 0 for c in res.client_exitcodes), res.client_exitcodes
    # the partials were computed in both cells, one a cell round
    assert sorted(res.cell_merges) == [0, 1]
    assert all(len(m) >= 3 for m in res.cell_merges.values())
    assert not any(res.child_foreign_modules.values())


def test_bft_root_certifies_o_cells():
    cfg, shards, test = _fleet(6)
    res = run_federated_hier("make_softmax_regression", shards, test, cfg,
                             rounds=2, cells=2, bft_validators=4,
                             timeout_s=200.0, device="cpu")
    info = res.final_info
    assert res.rounds_completed >= 2
    assert info["certified_size"] == info["log_size"]
    # 2 registrations + rounds x (1 upload + 1 score + 1 commit)
    assert (info["log_size"] - 2) / res.rounds_completed <= 2 * 3
    senders = {o["sender"] for o in res.root_ops if o["sender"]}
    assert len(res.member_addresses) == 6
    assert senders and not senders & set(res.member_addresses)
    assert not any(r["torch_imported"]
                   for r in res.validator_reports.values())


def test_rehome_drill_members_finish_through_the_sibling():
    cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                         needed_update_count=3, learning_rate=0.05,
                         batch_size=16).validate()
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr[:1500], ytr[:1500], 6)
    res = run_federated_hier("make_softmax_regression", shards,
                             (xte[:500], yte[:500]), cfg, rounds=3, cells=3,
                             bft_validators=4, kill_cell_at_epoch={1: 1},
                             stall_timeout_s=3.0, root_stall_timeout_s=5.0,
                             timeout_s=200.0, device="cpu")
    assert res.rounds_completed >= 3
    assert res.killed_cells == [1]
    orphans = res.cell_plan.members[1]
    assert len(orphans) == 2
    for i in orphans:
        assert res.client_exitcodes[i] == 0, (i, res.client_exitcodes)
    assert res.final_info["certified_size"] == res.final_info["log_size"]
    assert 1 not in res.cell_merges


def test_scaled_headline_root_cost_is_flat(monkeypatch):
    """2 cells at 6 and at 12 clients: the root's ops a round are equal
    and its egress a round within 1.2x — the root sees cells, not
    clients."""
    monkeypatch.setenv("BFLC_PROC_TRACE", "1")
    out = {}
    for n in (6, 12):
        cfg, shards, test = _fleet(n, rows=300 * n)
        res = run_federated_hier("make_softmax_regression", shards, test,
                                 cfg, rounds=3, cells=2, timeout_s=200.0,
                                 device="cpu")
        rounds = res.rounds_completed
        ops = [o for o in res.root_ops if o["op"] != "register"]
        costs = res.final_info["perf"]["costs"]
        out[n] = (len(ops) / rounds, costs["wire.bytes_out"] / rounds)
        assert len(res.member_addresses) == n
        assert not {o["sender"] for o in res.root_ops} & \
            set(res.member_addresses)
    assert out[6][0] == out[12][0], out
    ratio = out[12][1] / out[6][1]
    assert 1 / 1.2 <= ratio <= 1.2, out


def test_cli_runs_cells_on_the_cpu(capsys):
    assert cli(["--runtime", "processes", "--cells", "2", "--device", "cpu",
                "--rounds", "2", "--client-num", "6", "--comm-count", "2",
                "--aggregate-count", "2", "--needed-update-count", "2",
                "--learning-rate", "0.05", "--batch-size", "32",
                "--bft-validators", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    fleet = out["fleet"]
    assert out["rounds"] == 2
    assert fleet["certified_size"] == out["ledger_log_size"]
    assert fleet["hier"]["cells"] == [[0, 1, 2], [3, 4, 5]]
    assert fleet["hier"]["client_exitcodes"] == [0] * 6


@pytest.mark.parametrize("argv", [
    ["--runtime", "processes", "--cells", "2", "--standbys", "1"],
    ["--runtime", "processes", "--cells", "2", "--quorum", "1",
     "--standbys", "2"],
    ["--runtime", "processes", "--cell-size", "3", "--tls-dir", "t"],
    ["--runtime", "processes", "--cells", "2", "--snapshot-interval", "2"],
    ["--runtime", "mesh", "--cells", "2"],
    ["--runtime", "host", "--cell-size", "5"]])
def test_cli_refuses_cells_with_the_single_tier_options(argv, capsys):
    assert cli(["--device", "cpu", *argv]) == 2
    assert "--cell" in capsys.readouterr().err


def test_preset_refuses_cells_with_the_single_tier_options():
    from bflc_demo_tpu_torch.eval.configs import config1_occupancy
    for kw in (dict(standbys=1), dict(tls_dir="t"),
               dict(snapshot_interval=2), dict(quorum=1)):
        with pytest.raises(ValueError, match="--cells"):
            config1_occupancy(rounds=1, runtime="processes", cells=4,
                              device="cpu", **kw)
    with pytest.raises(ValueError, match="cells"):
        config1_occupancy(rounds=1, runtime="host", cells=4, device="cpu")
    async_cfg = ProtocolConfig(async_buffer=3)
    with pytest.raises(ValueError, match="async_buffer"):
        config1_occupancy(rounds=1, runtime="processes", cells=4,
                          device="cpu", cfg=async_cfg)


def test_cli_cells_without_a_card_raises_before_any_process():
    """The hier fleet runs on `cuda` unless `--device cpu`: without a card
    the entry point raises, naming the CPU switch, before it starts a
    child."""
    import multiprocessing as mp
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["--runtime", "processes", "--cells", "4", "--rounds", "1"])
    assert not mp.active_children()


def test_hier_legacy_pin_runs_the_single_tier(monkeypatch):
    """`BFLC_HIER_LEGACY=1` (the reference benchmark's pin) drops the cell
    tier: the preset reaches the flat fleet, never the hier runtime."""
    from bflc_demo_tpu_torch.client import process_runtime
    from bflc_demo_tpu_torch.eval.configs import config1_occupancy
    from bflc_demo_tpu_torch.hier import runtime as hier_runtime
    calls = []
    monkeypatch.setattr(process_runtime, "run_federated_processes",
                        lambda *a, **kw: calls.append("flat") or "flat")
    monkeypatch.setattr(hier_runtime, "run_federated_hier",
                        lambda *a, **kw: calls.append("hier") or "hier")
    assert config1_occupancy(rounds=1, runtime="processes", cells=4,
                             device="cpu") == "hier"
    monkeypatch.setenv("BFLC_HIER_LEGACY", "1")
    assert config1_occupancy(rounds=1, runtime="processes", cells=4,
                             device="cpu") == "flat"
    assert calls == ["hier", "flat"]
