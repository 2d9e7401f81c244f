"""The snapshot rejoin drill: state-sync past the GC base, then promotion.

The scene of the reference's `tests/test_snapshot.py::TestChaosDrill`
(:645-788) without its chaos `InvariantMonitor` (ROADMAP A14), extended
by a validator restart and a promotion:

1. 4 validator processes (`comm/bft.ValidatorNode`) and a writer
   (`comm/ledger_service.LedgerServer`, in this process, on `device`)
   that emits a certified snapshot after every commit
   (`snapshot_interval=1`), journals to a WAL and GCs behind each one;
2. a standby OS process follows the writer and is SIGKILLed mid-follow;
3. the writer keeps committing until its GC base passes the dead
   standby's resume point;
4. one validator is SIGKILLed and restarted empty on its port: the
   writer's assembler finds it below the GC base and installs the
   certified snapshot on it (`bft_snapshot`);
5. the standby restarts on its port and must state-sync (replay is
   impossible);
6. the writer stops once its chain is certified and the standby acked
   it; the state-synced standby promotes, certifies its fence op and
   merges the next round on `device` (kernel B5 on the card with
   `BFLC_MESH_AGG_MIN=1`).

Every request is signed.  A CPU writer without validators, standby or
snapshots (the plain leg) takes the same requests in lockstep: the
promoted writer's model bytes must equal its bytes, and the promoted
writer's chain head the validators'.  `forged_offer_refused` runs the
reference's `TestLiveStateSync::test_forged_offer_never_installs` scene:
a writer impostor offers a snapshot whose state does not hash to its op's
digest, and the standby refuses it and installs nothing.

`python -m bflc_demo_tpu_torch.eval.snapshot_drill --device cpu` runs it
and prints its account as JSON; `chip_smoke.py` runs it on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import struct
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from bflc_demo_tpu_torch.client import children
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig

PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
             needed_update_count=3, learning_rate=0.05, batch_size=16)
WIDTH = 64                      # the drill's model: W (WIDTH, 2) and b (2,)
MASTER_SEED = b"snapshot-rejoin-drill-0001"
VALIDATORS = 4


def init_blob(width: int = WIDTH) -> bytes:
    from bflc_demo_tpu_torch.utils.serialization import pack_entries
    return pack_entries({"['W']": np.zeros((width, 2), np.float32),
                         "['b']": np.zeros((2,), np.float32)})


def delta_blob(epoch: int, i: int, width: int = WIDTH) -> bytes:
    """Trainer i's delta at `epoch`, drawn from a seed."""
    from bflc_demo_tpu_torch.utils.serialization import pack_entries
    rng = np.random.default_rng(1000 * epoch + i)
    return pack_entries({
        "['W']": rng.standard_normal((width, 2)).astype(np.float32),
        "['b']": rng.standard_normal(2).astype(np.float32)})


class Driver:
    """Signed requests of the drill's six wallets, sent to every writer
    in `clients` in lockstep (each reply must agree on ok/status)."""

    def __init__(self, wallets):
        self.wallets = wallets
        self.by_addr = {w.address: w for w in wallets}

    def _sign(self, w, kind, epoch, payload) -> str:
        from bflc_demo_tpu_torch.comm.identity import _op_bytes
        return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()

    @staticmethod
    def _all(clients, method, **kw) -> dict:
        replies = [c.request(method, **kw) for c in clients]
        key = [(r.get("ok"), r.get("status")) for r in replies]
        if len(set(key)) != 1:
            raise RuntimeError(f"{method}: writers disagree: {key}")
        return replies[0]

    def register(self, clients) -> None:
        for w in self.wallets:
            r = self._all(clients, "register", addr=w.address,
                          pubkey=w.public_bytes.hex(),
                          tag=self._sign(w, "register", 0, b""))
            if not r["ok"]:
                raise RuntimeError(f"register: {r}")

    def round(self, clients) -> int:
        """One round to its commit on every writer; the epoch it was."""
        info = [c.request("info") for c in clients]
        epochs = {i["epoch"] for i in info}
        if len(epochs) != 1:
            raise RuntimeError(f"writers at epochs {epochs}")
        ep = epochs.pop()
        committee = self._all(clients, "committee")["committee"]
        trainers = [w for w in self.wallets if w.address not in committee]
        for i, w in enumerate(trainers[:PROTO["needed_update_count"]]):
            blob = delta_blob(ep, i)
            digest = hashlib.sha256(blob).digest()
            n, cost = 10 + i, 1.0 + 0.25 * i
            tag = self._sign(w, "upload", ep,
                             digest + struct.pack("<qd", n, cost))
            r = self._all(clients, "upload", addr=w.address, blob=blob,
                          hash=digest.hex(), n=n, cost=cost, epoch=ep,
                          tag=tag)
            if not r["ok"]:
                raise RuntimeError(f"upload: {r}")
        for j, addr in enumerate(committee):
            scores = [0.9 - 0.1 * j, 0.5 + 0.05 * j, 0.3]
            r = self._all(clients, "scores", addr=addr, epoch=ep,
                          scores=scores, tag=self._sign(
                              self.by_addr[addr], "scores", ep,
                              struct.pack(f"<{len(scores)}d", *scores)))
            if not r["ok"]:
                raise RuntimeError(f"scores: {r}")
        return ep


def _await(cond, timeout_s: float, what: str, step: float = 0.1) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(step)
    raise TimeoutError(f"snapshot drill: {what} within {timeout_s}s")


def _model_epoch_served(eps) -> int:
    """The highest model epoch any advertised read endpoint serves."""
    from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
    best = -1
    for host, port in eps or []:
        try:
            rc = CoordinatorClient(host, port, timeout_s=5.0)
            try:
                r = rc.request("model", meta=1)
            finally:
                rc.close()
        except (ConnectionError, OSError):
            continue
        if r.get("ok"):
            best = max(best, int(r.get("epoch", -1)))
    return best


def run_snapshot_rejoin(device: str = None, workdir: str = "",
                        verbose: bool = False) -> dict:
    """The drill (module docstring); its account.  Raises on any failed
    gate."""
    from bflc_demo_tpu_torch.client.process_runtime import (
        _drain_now, _standby_proc, _validator_proc)
    from bflc_demo_tpu_torch.comm.bft import provision_validators
    from bflc_demo_tpu_torch.comm.identity import Wallet, provision_wallets
    from bflc_demo_tpu_torch.comm.ledger_service import (CoordinatorClient,
                                                         LedgerServer)
    from bflc_demo_tpu_torch.device import resolve_device
    from bflc_demo_tpu_torch.ledger import make_ledger

    dev = resolve_device(device).type
    workdir = workdir or tempfile.mkdtemp(prefix="snapshot-drill-")
    os.makedirs(workdir, exist_ok=True)
    cfg = ProtocolConfig(**PROTO)
    cfg_kw = dataclasses.asdict(cfg)
    wallets, _ = provision_wallets(cfg.client_num, MASTER_SEED)
    drv = Driver(wallets)
    v_seeds = [MASTER_SEED + b"|bft-validator|" + struct.pack("<q", v)
               for v in range(VALIDATORS)]
    _, vkeys = provision_validators(VALIDATORS, MASTER_SEED)
    sb_seed = MASTER_SEED + b"|standby|" + struct.pack("<q", 1)
    sb_keys = {1: Wallet.from_seed(sb_seed).public_bytes}
    vctx, ctx = children.spawn_context(), children.torch_context()
    host = "127.0.0.1"
    procs: List = []
    account: Dict[str, object] = {"device": dev}

    def spawn_validator(v: int, port: int = 0):
        q = vctx.Queue()
        p = children.process(vctx, _validator_proc,
                             (cfg_kw, v_seeds[v], v, q, vkeys, verbose, port))
        p.start()
        procs.append(p)
        return p, q.get(timeout=120)["port"]

    def spawn_standby(port: int = 0):
        q = ctx.Queue()
        p = children.process(ctx, _standby_proc, (
            cfg_kw, [(host, writer.port)], 1, q, 30.0, sb_seed, sb_keys, 0,
            dev, verbose, [(host, vp) for vp in v_ports], vkeys, "", 1,
            os.path.join(workdir, "snaps", "standby-1"), "", port))
        p.start()
        procs.append(p)
        return p, q, q.get(timeout=180)

    writer = plain = c = pc = None
    try:
        t0 = time.perf_counter()
        vals = [spawn_validator(v) for v in range(VALIDATORS)]
        v_procs, v_ports = [p for p, _ in vals], [pt for _, pt in vals]
        account["validator_spawn_s"] = time.perf_counter() - t0
        writer = LedgerServer(
            cfg, init_blob(), stall_timeout_s=30.0,
            wal_path=os.path.join(workdir, "writer.wal"),
            bft_validators=[(host, p) for p in v_ports], bft_keys=vkeys,
            standby_keys=sb_keys, snapshot_interval=1,
            snapshot_dir=os.path.join(workdir, "snaps", "writer"),
            device=dev, verbose=verbose)
        writer.start()
        # the plain leg: the same signed requests, no BFT, no snapshots
        plain = LedgerServer(cfg, init_blob(), stall_timeout_s=30.0,
                             device="cpu")
        plain.start()
        c = CoordinatorClient(host, writer.port, timeout_s=60.0)
        pc = CoordinatorClient(host, plain.port, timeout_s=60.0)
        drv.register([c, pc])
        sb, sb_q, sb_port = spawn_standby()
        drv.round([c, pc])
        _await(lambda: _model_epoch_served(
            c.request("model", meta=1).get("read_set")) >= 1, 60.0,
            "the standby follows")
        resume_point = c.request("info")["log_size"]
        sb.kill()                                   # mid-follow
        sb.join(timeout=10)
        first_events = _drain_now(sb_q)
        for _ in range(3):
            drv.round([c, pc])
        _await(lambda: c.request("info")["log_base"] > resume_point, 30.0,
               "the writer GCs past the dead standby's resume point")

        # a validator restarted empty installs the certified snapshot
        v_procs[3].kill()
        v_procs[3].join(timeout=10)
        v_procs[3], _ = spawn_validator(3, v_ports[3])
        drv.round([c, pc])
        vc = CoordinatorClient(host, v_ports[3], timeout_s=10.0)
        try:
            _await(lambda: vc.request("info")["log_base"] > 0, 30.0,
                   "the restarted validator installs the snapshot")
        finally:
            vc.close()
        # the writer's account of each install: the bft_snapshot round
        # trip, the validator's checks and install included
        account["validator_installs"] = [
            r for r in c.request("kernels")["snapshot_offers"] if r["ok"]]

        # the standby restarts on its port: only a state-sync brings it back
        sb, sb_q, port2 = spawn_standby(sb_port)
        if port2 != sb_port:
            raise RuntimeError(f"standby restarted on {port2}, not {sb_port}")
        want = c.request("info")["epoch"]
        _await(lambda: _model_epoch_served(
            c.request("model", meta=1).get("read_set")) >= want, 90.0,
            "the restarted standby state-syncs to the tip")

        synced: List[dict] = []

        def settled() -> bool:
            # certified, and the standby holds every op: it acked the last
            # one, or its state-sync installed the snapshot at the tip
            # (nothing streamed after it, so nothing to ack yet)
            synced.extend(_drain_now(sb_q))
            k = c.request("kernels")
            tip = k["log_size"] - 1
            return (k["certified_size"] == k["log_size"]
                    and (k["stream_acked"] >= tip or any(
                        e.get("state_sync", {}).get("i") == tip
                        for e in synced)))

        _await(settled, 30.0, "the chain settles (certified, held)")
        primary = c.request("kernels")
        primary_info = c.request("info")
        account["writer_head_at_stop"] = {
            "log_size": primary_info["log_size"],
            "log_head": primary_info["log_head"]}
        account["writer_base_before_stop"] = primary["log_base"]
        account["writer_snapshots"] = primary["snapshots"]
        account["writer_launches"] = primary["launches"]
        c.close()
        c = None
        writer.close()                              # the writer stops
        t_stop = time.monotonic()

        # the promoted standby merges the next round
        c = CoordinatorClient(host, sb_port, timeout_s=60.0)
        _await(lambda: c.request("info").get("gen") == 1, 60.0,
               "the standby promotes")
        account["promote_s"] = time.monotonic() - t_stop
        ep = drv.round([c, pc])
        _await(lambda: c.request("info")["epoch"] > ep, 30.0,
               "the promoted writer commits")
        _await(lambda: (lambda i: i["certified_size"] == i["log_size"])(
            c.request("info")), 30.0, "the promoted chain certifies")
        info = c.request("info")
        model = c.request("model")["blob"]
        plain_model = pc.request("model")["blob"]
        kern = c.request("kernels")
        heads = []
        for vp in v_ports:
            vc = CoordinatorClient(host, vp, timeout_s=10.0)
            try:
                vi = vc.request("info")
            finally:
                vc.close()
            heads.append((vi["log_size"], vi["log_head"]))
        events = first_events + synced + _drain_now(sb_q)
        syncs = [e["state_sync"] for e in events if "state_sync" in e]
        account.update(
            resume_point=resume_point,
            standby_events=events, state_sync_s=[s["seconds"]
                                                 for s in syncs],
            promoted_info={k: info[k] for k in (
                "epoch", "log_size", "log_head", "log_base",
                "certified_size", "gen")},
            promoted_started_log_base=kern["started_log_base"],
            promoted_merges=kern["merges"],
            promoted_engine=kern["engine"],
            promoted_launches=kern["launches"],
            validator_heads=heads,
            model_bytes_equal_plain=bytes(model) == bytes(plain_model),
            plain_epoch=pc.request("info")["epoch"])
        # the promoted writer's WAL is not armed here; the writer's is
        wal = os.path.join(workdir, "writer.wal")
        with open(wal, "rb") as f:
            account["writer_wal_magic"] = f.read(8).decode()
        # a compacted (BFLCWAL2) journal replays into the python ledger:
        # the native one reads BFLCWAL1 only
        replay = make_ledger(cfg, backend="python")
        replay.replay_wal(wal)
        account["writer_wal_replayed"] = {
            "log_size": replay.log_size(), "log_base": replay.log_base,
            "head": replay.log_head().hex()}
        account["forged_offer_refused"] = forged_offer_refused(dev)
        _check(account)
        return account
    finally:
        for cl in (c, pc):
            if cl is not None:
                cl.close()
        for srv in (writer, plain):
            if srv is not None:
                srv.close()
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


def _check(a: dict) -> None:
    """The drill's gates."""
    info = a["promoted_info"]
    at_head = [h for s, h in a["validator_heads"] if s == info["log_size"]]
    merges = a["promoted_merges"]
    bad = []
    if not a["state_sync_s"]:
        bad.append("the restarted standby never state-synced")
    if not a["validator_installs"]:
        bad.append("the restarted validator installed no snapshot")
    if a["promoted_started_log_base"] <= 0:
        bad.append("the promoted writer did not start from a compacted "
                   "ledger")
    if info["gen"] != 1 or info["certified_size"] != info["log_size"]:
        bad.append(f"promoted info {info}")
    if len(at_head) < 3 or set(at_head) != {info["log_head"]}:
        bad.append(f"validator heads {a['validator_heads']} vs "
                   f"{info['log_head']}")
    if not merges or (a["device"] == "cuda"
                      and merges[0]["leg"] != "mesh"):
        bad.append(f"promoted merges {merges}")
    if not a["model_bytes_equal_plain"] or \
            a["plain_epoch"] != info["epoch"]:
        bad.append("the promoted writer's model bytes differ from the "
                   "plain leg's")
    stop = a["writer_head_at_stop"]
    replayed = a["writer_wal_replayed"]
    if a["writer_wal_magic"] != "BFLCWAL2" or \
            (replayed["log_size"], replayed["head"]) != \
            (stop["log_size"], stop["log_head"]):
        bad.append(f"writer WAL {a['writer_wal_magic']} {replayed}, the "
                   f"writer stopped at {stop}")
    if not a["forged_offer_refused"]:
        bad.append("a forged snapshot offer was not refused")
    if bad:
        raise RuntimeError("snapshot drill: " + "; ".join(bad))


# ------------------------------------------------------ the forged offer
class LyingSnapshotServer:
    """A writer impostor: `info` reports a GC'd base and `snapshot` serves
    state bytes that do not hash to the op's digest (the reference's
    `tests/test_snapshot.py:_LyingSnapshotServer`)."""

    def __init__(self):
        from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
        from bflc_demo_tpu_torch.ledger.snapshot import make_snapshot_op
        led = make_ledger(ProtocolConfig(**PROTO))
        for i in range(PROTO["client_num"]):
            led.register_node(f"0x{i:040x}")
        self.i = led.log_size()
        self.prev = led.log_head()
        self.state = led.encode_state()
        self.op = make_snapshot_op(led)
        if led.apply_op(self.op) != LedgerStatus.OK:
            raise RuntimeError("snapshot op refused by its own ledger")
        self.epoch = led.epoch
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()

    def start(self) -> None:
        threading.Thread(target=self._loop, daemon=True).start()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def _loop(self) -> None:
        from bflc_demo_tpu_torch.comm.wire import recv_msg, send_msg
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                while True:
                    m = recv_msg(conn)
                    if m is None:
                        break
                    if m.get("method") == "info":
                        send_msg(conn, {"ok": True, "epoch": self.epoch,
                                        "gen": 0, "log_size": self.i + 1,
                                        "log_head": "00" * 32,
                                        "log_base": self.i + 1})
                    elif m.get("method") == "snapshot":
                        corrupt = bytearray(self.state)
                        corrupt[-1] ^= 0xFF
                        send_msg(conn, {
                            "ok": True, "i": self.i, "epoch": self.epoch,
                            "gen": 0, "op": self.op.hex(),
                            "prev_head": self.prev.hex(), "cert": None,
                            "state": bytes(corrupt), "model": b"m"})
                    else:
                        send_msg(conn, {"ok": False, "error": "nope"})
            except Exception:       # noqa: BLE001 — an impostor's loop
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass


def forged_offer_refused(device: str = None) -> bool:
    """True when a standby refuses the impostor's corrupt snapshot
    (RuntimeError naming the refusal) and installs nothing."""
    import warnings

    from bflc_demo_tpu_torch.comm.failover import Standby
    from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
    srv = LyingSnapshotServer()
    srv.start()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # a wallet-less standby
            sb = Standby(ProtocolConfig(**PROTO),
                         [(srv.host, srv.port), ("127.0.0.1", 0)], 1,
                         stall_timeout_s=2.0, snapshot_interval=2,
                         device=device)
        ctl = CoordinatorClient(srv.host, srv.port)
        try:
            try:
                sb._state_sync(ctl)
            except RuntimeError as e:
                return ("refusing" in str(e) and sb.ledger.log_size() == 0
                        and sb._model_blob is None)
            return False
        finally:
            ctl.close()
            sb.stop()
    finally:
        srv.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m bflc_demo_tpu_torch.eval.snapshot_drill",
        description="The snapshot rejoin drill (state-sync of a standby "
                    "and a validator past the GC base, then promotion).")
    p.add_argument("--device", default="cuda")
    p.add_argument("--workdir", default="")
    p.add_argument("--verbose", action="store_true")
    opts = p.parse_args(argv)
    acc = run_snapshot_rejoin(opts.device, opts.workdir, opts.verbose)
    print(json.dumps(acc, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
