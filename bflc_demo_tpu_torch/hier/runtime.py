"""Two-tier process federation: root + cell aggregators + member clients.

Port of `bflc_demo_tpu/hier/runtime.py`, `run_federated_hier`:
`client.process_runtime.run_federated_processes` one level up, every
role a real OS process over real sockets —

    sponsor (parent)
      └─ root coordinator (LedgerServer + cell registry)
           ├─ BFT validator fleet (optional; certifies O(cells) ops a
           │    round, each validator holding the cell registry)
           ├─ cell aggregator 0 (CellAggregatorServer) ── member clients
           ├─ cell aggregator 1 ─────────────────────── member clients
           └─ ...

Member clients are the unchanged `_client_proc` state machine of the
single-tier fleet — a member cannot tell its coordinator is a cell.
Each member's endpoint list is [its cell aggregator, the ring sibling],
with the two aggregators' public keys: when a cell aggregator dies
mid-round its members' FailoverClient rotates to the sibling,
re-registers there (TOFU) and keeps contributing — the re-home drill,
`kill_cell_at_epoch` (reference :445-470).  The sponsor evaluates the
ROOT's committed model each round.

Every role that computes runs on the run's device, `cuda` unless the
caller asks for the CPU: the members' training and scoring (K1-K3 in the
transformer), each aggregator's cell partial (B5 on the engine's mesh
leg) and its root-committee score (K1), the root's merge of the partials
(B5) and the sponsor's evaluation (K1).  The root and the aggregators
fork from the port's forkserver (`client/children.py`), and each
aggregator and member leads a process group of its own, as the fleet's
clients do: the drill SIGKILLs an aggregator, and a group orphaned by
that exit could otherwise bring SIGHUP to its members and the parent.
Validators are spawned and import no torch.  On `cuda` the parent builds
every kernel library before the fleet starts.  Before it stops the
fleet, the parent collects the root's and every live aggregator's
`kernels` reply (launch counts, engine report, merge records), the
root's op stream (each op's name, sender and epoch) and the members'
reports.

Not ported, raising with their ROADMAP item when asked for: the chaos
schedule and its directory, telemetry and causal traces (A14), and the
rederive plane with its cell evidence leg (A9 item 9).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.client import children
from bflc_demo_tpu_torch.client.process_runtime import (
    ProcessFederationResult, _child_device, _client_proc, _drain_reports,
    absorb_reports, client_args, client_seed, final_info, join_clients,
    sponsor_rounds, start_validators, stop_processes)
from bflc_demo_tpu_torch.hier.cells import (cell_protocol, cell_seed,
                                            plan_cells, root_protocol)
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig

Endpoint = Tuple[str, int]

# the reference's run_federated_hier options this port has not reached;
# a value other than the reference's default raises
UNPORTED_HIER_OPTIONS = {
    "chaos_schedule": "A14 (chaos)", "chaos_dir": "A14 (chaos)",
    "telemetry_dir": "A14 (telemetry)", "trace_sample": "A14 (telemetry)",
    "rederive": "A9 item 9 (rederive)",
}
_HIER_DEFAULTS = {"rederive": "off"}

# a member's request timeout (the reference's, without chaos)
MEMBER_TIMEOUT_S = 60.0


def _root_proc(cfg_kw: dict, initial_blob: bytes, port_q,
               stall_timeout_s: float, wal_path: str,
               cell_registry: dict, bft_endpoints: list, bft_keys: dict,
               device: str, verbose: bool) -> None:
    """The root coordinator: a plain LedgerServer whose clients are the
    cell aggregators (the cell registry arms the hier admission
    contract); it merges the partials on `device`."""
    _child_device(device)
    from bflc_demo_tpu_torch.comm.ledger_service import LedgerServer
    server = LedgerServer(ProtocolConfig(**cfg_kw), initial_blob,
                          stall_timeout_s=stall_timeout_s,
                          wal_path=wal_path,
                          cell_registry=cell_registry or None,
                          bft_validators=[tuple(e) for e in bft_endpoints]
                          or None,
                          bft_keys=bft_keys or None, device=device,
                          verbose=verbose)
    port_q.put(server.port)
    server.serve_forever()


def _cell_proc(cell_cfg_kw: dict, initial_blob: bytes, cell_index: int,
               wallet_seed: bytes, root_endpoints: list,
               model_factory: str, factory_kw: dict, val_x, val_y,
               root_bft_keys: dict, port_q, stall_timeout_s: float,
               device: str, verbose: bool) -> None:
    """One cell aggregator process (`hier/aggregator.py`): coordinator
    for its members, bridge client of the root, computing on `device`."""
    _child_device(device)
    from bflc_demo_tpu_torch.comm.identity import Wallet
    from bflc_demo_tpu_torch.hier.aggregator import CellAggregatorServer
    val = None
    if val_x is not None and len(val_x):
        val = (np.asarray(val_x), np.asarray(val_y))
    server = CellAggregatorServer(
        ProtocolConfig(**cell_cfg_kw), initial_blob, cell_index,
        Wallet.from_seed(wallet_seed),
        [tuple(e) for e in root_endpoints],
        model_factory=model_factory, factory_kw=factory_kw,
        val_shard=val, root_bft_keys=root_bft_keys or None,
        stall_timeout_s=stall_timeout_s, device=device, verbose=verbose)
    port_q.put(server.port)
    server.serve_forever()


def _cell_val_shard(shards, members: Sequence[int], nc: int,
                    cap: int = 128):
    """The aggregator's validation shard for root-committee scoring: a
    small deterministic sample drawn from its OWN members' data (the
    committee member scores on its own data, one tier up).
    (x, y_onehot) capped at `cap` rows."""
    from bflc_demo_tpu_torch.data.partition import one_hot
    per = max(1, cap // max(len(members), 1))
    xs, ys = [], []
    for i in members:
        sx, sy = shards[i]
        xs.append(np.asarray(sx)[:per])
        ys.append(np.asarray(sy)[:per])
    x = np.concatenate(xs, axis=0)[:cap]
    y = np.concatenate(ys, axis=0)[:cap]
    return x, one_hot(y, nc)


def _root_ops(sponsor, info: dict) -> List[dict]:
    """Every op of the root's chain: its name, sender and epoch."""
    from bflc_demo_tpu_torch.ledger.base import decode_op
    r = sponsor.request("log_range", start=info["log_base"],
                        end=info["log_size"])
    out = []
    for hx in r.get("ops", []):
        d = decode_op(bytes.fromhex(hx))
        out.append({"op": d["op"], "sender": d.get("sender", d.get("addr")),
                    "epoch": d.get("epoch")})
    return out


def _cell_kernels(endpoint: Endpoint) -> Optional[dict]:
    """A live aggregator's `kernels` reply, or None when it is gone."""
    from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
    try:
        probe = CoordinatorClient(*endpoint, timeout_s=30.0)
        try:
            r = probe.request("kernels")
        finally:
            probe.close()
    except (ConnectionError, OSError):
        return None
    return r if r.get("ok") else None


def run_federated_hier(
        model_factory: str,
        shards: Sequence[Tuple[np.ndarray, np.ndarray]],
        test_set: Tuple[np.ndarray, np.ndarray],
        cfg: ProtocolConfig,
        rounds: int = 5, *,
        cells: int = 0,
        cell_size: int = 0,
        factory_kw: Optional[dict] = None,
        master_seed: bytes = b"hier-federation-master-0001",
        stall_timeout_s: float = 6.0,
        root_stall_timeout_s: Optional[float] = None,
        wal_path: str = "",
        bft_validators: int = 0,
        timeout_s: float = 600.0,
        init_seed: int = 0,
        kill_cell_at_epoch: Optional[Dict[int, int]] = None,
        device: Optional[str] = None,
        verbose: bool = False,
        **unported) -> ProcessFederationResult:
    """Run a two-tier federation as OS processes.  Parent = sponsor.

    cells / cell_size: the deterministic cohorting (`hier.cells.
    plan_cells` — pass at least one).  cfg is the GLOBAL protocol genome;
    each cell runs `cell_protocol(cfg, len(members))`, the root runs
    `root_protocol(cfg, n_cells)`.
    bft_validators: BFT commit quorum AT THE ROOT — certificates cover
    O(cells) ops a round through the unchanged `comm.bft` machinery, and
    every validator holds the cell registry (a forged or inflated cell op
    cannot certify).
    kill_cell_at_epoch: {cell_index: root_epoch} — SIGKILL that cell's
    aggregator once the root reaches the epoch (the re-home drill: its
    members fail over to the ring sibling).
    device: where every role computes, `cuda` (None) or `cpu`; the
    validators compute nothing on it.
    """
    for name, default in _HIER_DEFAULTS.items():
        if unported.get(name) == default:
            unported.pop(name)
    from bflc_demo_tpu_torch.comm.ledger_service import refuse_unported
    refuse_unported(unported, UNPORTED_HIER_OPTIONS)
    cfg.validate()
    if len(shards) != cfg.client_num:
        raise ValueError(f"need {cfg.client_num} shards, got {len(shards)}")
    plan = plan_cells(len(shards), cells, cell_size)
    factory_kw = factory_kw or {}
    kill_cell_at_epoch = dict(kill_cell_at_epoch or {})
    t_start = time.monotonic()

    import torch

    import bflc_demo_tpu_torch.models as models
    from bflc_demo_tpu_torch.client.runtime import feature_tensor
    from bflc_demo_tpu_torch.comm.dataplane import ReadRouter
    from bflc_demo_tpu_torch.comm.failover import FailoverClient
    from bflc_demo_tpu_torch.comm.identity import Wallet
    from bflc_demo_tpu_torch.data.partition import one_hot
    from bflc_demo_tpu_torch.device import resolve_device
    from bflc_demo_tpu_torch.utils.serialization import pack_pytree

    dev = resolve_device(device)
    if dev.type == "cuda":
        # every kernel library built once, here, before any child could
        # race another on the same output
        from bflc_demo_tpu_torch.ops.build import build_all
        build_all()
    device_name = dev.type
    model = getattr(models, model_factory)(**factory_kw).to(dev)
    template = model.init_params(0, dev)
    initial_blob = pack_pytree(model.init_params(init_seed, "cpu"))
    nc = model.num_classes

    def kw_of(c: ProtocolConfig) -> dict:
        return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}

    # identities + registry, all derived from (master_seed, plan): the
    # root, the validators and any auditor agree on the membership caps
    agg_seeds = {c: cell_seed(master_seed, c) for c in range(plan.n_cells)}
    agg_wallets = {c: Wallet.from_seed(s) for c, s in agg_seeds.items()}
    cell_registry = {agg_wallets[c].address: (c, len(plan.members[c]))
                     for c in range(plan.n_cells)}
    agg_pubs = {c: w.public_bytes for c, w in agg_wallets.items()}
    root_cfg_kw = kw_of(root_protocol(cfg, plan.n_cells))
    cell_cfg_kw = {c: kw_of(cell_protocol(cfg, len(plan.members[c])))
                   for c in range(plan.n_cells)}
    bft_keys: Dict[int, bytes] = {}
    if bft_validators:
        from bflc_demo_tpu_torch.comm.bft import provision_validators
        _, bft_keys = provision_validators(bft_validators, master_seed)

    vctx = children.spawn_context()
    ctx = children.torch_context()
    host = "127.0.0.1"
    port_of: Dict[str, int] = {}
    t_val = time.monotonic()
    validator_procs, validator_reports, bft_endpoints = start_validators(
        vctx, root_cfg_kw, master_seed, bft_validators, bft_keys, verbose,
        host, cell_registry)
    validator_spawn_s = time.monotonic() - t_val
    for role, rep_v in validator_reports.items():
        port_of[role] = rep_v["port"]
    root = None
    cell_procs: Dict[int, object] = {}
    cell_ports: Dict[int, int] = {}
    clients: List = []
    report_q = ctx.Queue()
    sponsor = router = None
    killed_cells: List[int] = []
    launches: Dict[str, Dict[str, int]] = {}
    cell_merges: Dict[int, List[dict]] = {}
    cell_engines: Dict[int, dict] = {}
    cell_bridge: Dict[int, dict] = {}
    client_reports: List[dict] = []
    client_exitcodes: List[Optional[int]] = []
    marks: Dict[str, float] = {}
    kr: Optional[dict] = None
    root_ops: List[dict] = []
    final = None
    try:
        q = ctx.Queue()
        root = children.process(ctx, _root_proc, (
            root_cfg_kw, initial_blob, q,
            root_stall_timeout_s or max(stall_timeout_s * 2, 8.0),
            wal_path, cell_registry, bft_endpoints, bft_keys, device_name,
            verbose))
        root.start()
        root_port = q.get(timeout=120)
        port_of["writer"] = root_port
        root_endpoints = [(host, root_port)]

        # the aggregators start at once, each reporting its port on its
        # own queue; each leads a process group (the drill kills one)
        cell_qs = {}
        for c in range(plan.n_cells):
            vx, vy = _cell_val_shard(shards, plan.members[c], nc)
            cq = ctx.Queue()
            p = children.process(ctx, _cell_proc, (
                cell_cfg_kw[c], initial_blob, c, agg_seeds[c],
                root_endpoints, model_factory, factory_kw, vx, vy,
                bft_keys, cq, stall_timeout_s, device_name, verbose),
                own_group=True)
            p.start()
            cell_procs[c] = p
            cell_qs[c] = cq
        for c, cq in cell_qs.items():
            cell_ports[c] = cq.get(timeout=120)
            port_of[f"cell-{c}"] = cell_ports[c]

        # members: the unchanged client state machine pointed at [its
        # cell, the ring sibling], the aggregators' public keys as the
        # endpoints' evidence keys
        for i, (sx, sy) in enumerate(shards):
            c = plan.cell_of(i)
            sib = plan.sibling_of(c)
            p = children.process(ctx, _client_proc, client_args(
                [(host, cell_ports[c]), (host, cell_ports[sib])],
                master_seed, i, model_factory, factory_kw, sx, sy, nc,
                cell_cfg_kw[c], rounds, None, device_name, report_q,
                {0: agg_pubs[c], 1: agg_pubs[sib]},
                request_timeout_s=MEMBER_TIMEOUT_S), own_group=True)
            p.start()
            clients.append(p)

        xte, yte = test_set
        xte_t = feature_tensor(xte, dev)
        yte_t = torch.as_tensor(one_hot(np.asarray(yte), nc), device=dev)
        sponsor = FailoverClient(root_endpoints, timeout_s=30.0,
                                 bft_keys=bft_keys or None)
        router = ReadRouter(sponsor, timeout_s=30.0)
        deadline = time.monotonic() + timeout_s

        def drill(info: dict) -> bool:
            """The re-home drill: SIGKILL a cell's aggregator mid-round
            once the root reaches its epoch — its members must rotate to
            the ring sibling."""
            for c, at_epoch in kill_cell_at_epoch.items():
                if c not in killed_cells and info["epoch"] >= at_epoch:
                    cell_procs[c].kill()
                    cell_procs[c].join(timeout=10)
                    killed_cells.append(c)
                    if verbose:
                        print(f"[drill] cell-{c} aggregator killed at "
                              f"root epoch {info['epoch']}", flush=True)
            return False

        history, epoch_times, spawn_s = sponsor_rounds(
            sponsor, router, model, template, (xte_t, yte_t), rounds,
            deadline, t_start, verbose,
            f"hier federation incomplete after {timeout_s}s", drill)
        marks["rounds"] = time.monotonic() - t_start
        client_reports = _drain_reports(report_q, clients, wait_s=60.0)
        marks["client_reports"] = time.monotonic() - t_start
        final = final_info(sponsor, bool(bft_validators), deadline)
        marks["certified"] = time.monotonic() - t_start
        root_ops = _root_ops(sponsor, final)
        kr = sponsor.request("kernels")
        for c, cport in cell_ports.items():
            if c in killed_cells:
                continue
            ck = _cell_kernels((host, cport))
            if ck is not None:
                launches[f"cell-{c}"] = ck["launches"]
                cell_engines[c] = ck["engine"]
                cell_merges[c] = ck["merges"]
                cell_bridge[c] = ck.get("bridge", {})
    finally:
        if router is not None:
            router.close()
        if sponsor is not None:
            sponsor.close()
        client_exitcodes = join_clients(clients)
        stop_processes(([root] if root is not None else [])
                       + list(cell_procs.values()) + validator_procs)
    marks["teardown"] = time.monotonic() - t_start

    result = ProcessFederationResult(
        accuracy_history=history,
        rounds_completed=final["epoch"],
        log_head=final["log_head"],
        log_size=final["log_size"],
        recovered_clients=[],
        replica_report=None,
        wall_time_s=time.monotonic() - t_start,
        final_info=final)
    result.epoch_times = epoch_times
    result.spawn_s = spawn_s
    result.phase_s = marks
    absorb_reports(result, kr, client_reports, launches)
    result.validator_reports = validator_reports
    result.validator_spawn_s = validator_spawn_s
    result.cell_plan = plan
    result.member_addresses = [
        Wallet.from_seed(client_seed(master_seed, i)).address
        for i in range(len(shards))]
    result.client_exitcodes = client_exitcodes
    result.port_of = port_of
    result.root_ops = root_ops
    result.killed_cells = killed_cells
    result.cell_merges = cell_merges
    result.cell_engines = cell_engines
    result.cell_bridge = cell_bridge
    return result
