"""Process-parallel federation: real OS processes over a real socket.

Port of the synchronous fleet of
`bflc_demo_tpu/client/process_runtime.py`: `_server_proc` (:228),
`_validator_proc` (:260), `_client_proc` with its synchronous loop
(:468, :557-705), `_replica_proc` (:709), `_standby_proc` (:723),
`ProcessFederationResult` (:771) and `run_federated_processes` (:807)
with its standbys, the writer-kill drill, quorum-ack, the WAL, the
BFT validator fleet, TLS (`_client_tls`, `_server_tls`, :212-225) and
certified snapshots (per-role snapshot directories, :1045-1072).

- one **writer process** runs `comm/ledger_service.LedgerServer`: the
  ledger, Ed25519 verification, the blob store, the merge through the
  certified merge engine, stall recovery;
- N **client processes** train and score on their private shard and
  speak only the wire frames, every mutation signed by their wallet; a
  crashed client is a dead process, and the writer's failure detector
  carries the round (close_round / reseat_committee / force_aggregate);
- the parent is the **sponsor**: it polls the published model and
  records held-out accuracy after every commit;
- a committee member counts a WRONG_EPOCH reply to its scores as its
  round settled only when the writer has moved past that round
  (`_round_passed`, C13): after a failover that lost the commit opening
  the round, the reference's client marks it scored and the round, with
  its committee live, never closes;
- **replica processes** replay the writer's op stream after the run and
  must reproduce its chained head;
- with `bft_validators` N, N **validator processes** (`comm/bft.py`),
  their identities drawn from the run's master seed
  (`provision_validators`), re-execute and co-sign every op: the writer
  acknowledges only certified ops, the clients, the sponsor and the
  standbys check every certificate, and a promoted standby certifies its
  fence op.  A validator is ledger and crypto only: its process imports
  no torch (each reports what it imported at start, `validator_reports`).

Every role that computes runs on the run's device, `cuda` unless the
caller asks for the CPU: the clients' training (kernels K1-K3 in the
transformer) and scoring (K1), the writer's merge (B5 on the engine's
mesh leg; after a failover, the promoted standby's) and the sponsor's
evaluation (K1).  The reference pins its
children to the CPU because one process owns a TPU; one H100 takes many
processes.  Validators are spawned; every other child forks from a
forkserver that imported torch once and never touched CUDA, under the
parent's environment of the moment (`client/children.py`); each
resolves its own device, only numpy arrays, bytes and plain dicts cross
the boundary, and on the CPU each child runs one torch thread.  On `cuda`
the parent builds every kernel library before it spawns, so the
children only load them.  Before the parent stops its children it
collects every role's kernel launch counts (and the final writer's
engine report), which `ProcessFederationResult.kernel_launches` holds;
on a drill it asks the primary for its `info` and `kernels` just before
the kill, and `failover` holds the kill's time, the promoted writer's
start and first commit on the host's monotonic clock.  Under BFT the
kill waits until the primary certified its whole chain and a follower
acked it: a standby follows certified ops only and cannot promote past
certified ops it never received.

With `tls_dir` the parent provisions the certificates once
(`comm/tls.provision_tls`) and every role speaks TLS: the writer and the
standbys' read fan-out serve it, the clients, the sponsor, the standbys
and the replicas dial with it; validators stay plaintext, as in the
reference.  With `snapshot_interval` K the writer and the standbys
emit, mirror and GC behind a certified snapshot every K rounds, their
artifacts under `snapshot_dir`/writer and `snapshot_dir`/standby-s.  A
standby journals to `wal_path`.standby-s once it promotes (the
reference's standbys journal nothing), so the final writer's chain is on
disk after a failover too.

Async FedBuff (`cfg.async_buffer` K > 0, `ledger/base.async_enabled`;
reference :303-458, :544-556, :919-925) switches every role from the
genome alone: the writer admits staleness-tagged deltas and drains every
K on B5, validators re-execute opcodes 10-12, standbys mirror the
buffer's blobs, and the clients run `_client_async_loop`: a trainer
fetches, trains and `aupload`s against the base epoch it fetched, a
committee member scores the buffered entries it has not scored in one
`score_candidates_batched` call and sends `ascores`.  The sponsor
evaluates each committed epoch as in sync mode.  Each client reports
its trainings, its scored entries, the bytes of the blobs it encoded
and its aupload and ascores replies by status.

The upload codecs (reference :55-150): every upload, sync or async, is
encoded by `_DeltaEncoder` through `_encode_delta` — the genome's sparse
codec (`delta_density` < 1: top-k or count-sketch, then the
`delta_dtype` quantizer) or the quantized/dense pipeline — on a float32
host copy of the delta made once per upload (`_host_delta`).  With
`BFLC_ERROR_FEEDBACK=1` and a lossy encode the encoder keeps, as float32
numpy on the host, what the encode dropped (the delta minus its
`densify_entries(dequantize_entries(...))` decode) and adds it into the
next delta; a jump in base epoch resets it.  Every blob a client
decodes goes through that one decode chain.  With `BFLC_PROC_TRACE=1`
a client charges `client.encode_s` per upload beside `client.train_s`.

Not ported, raising with their ROADMAP item when asked for: the chaos
campaign, telemetry and traces, rederive (A9, A14); the genome's
effective density (A9 item 9: a `state` reply carries none here, so the
encode uses `cfg.delta_density`); the mesh-executor deployment (A9).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import queue
import signal
import struct
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.client import children
from bflc_demo_tpu_torch.ledger.base import async_enabled
from bflc_demo_tpu_torch.ops import launch_counts
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig

# the reference's run_federated_processes options this port has not
# reached; a value other than the reference's default raises
UNPORTED_FLEET_OPTIONS = {
    "chaos_seed": "A14 (chaos)", "chaos_profile": "A14 (chaos)",
    "chaos_duration_s": "A14 (chaos)", "chaos_schedule": "A14 (chaos)",
    "chaos_dir": "A14 (chaos)",
    "telemetry_dir": "A14 (telemetry)", "trace_sample": "A14 (telemetry)",
    "xprof_window": "A11 (the device profiler)",
    "rederive": "A9 (rederive)",
}
_FLEET_DEFAULTS = {"chaos_profile": "standard", "rederive": "off"}

FOREIGN = ("jax", "jaxlib", "flax", "bflc_demo_tpu")


def foreign_modules() -> List[str]:
    """Modules of JAX or the reference package this process imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def process_age_s() -> float:
    """Seconds since this process started (Linux `/proc`; 0.0 where
    there is none): a child's boot time from its spawn on, which no
    timestamp passed from the parent could give across hosts' clocks."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return uptime - ticks / os.sysconf("SC_CLK_TCK")


def _charge_boot(tr, marks: Dict[str, float]) -> None:
    """Charge a child's boot steps (`boot.<step>_s`, seconds between
    successive marks of `process_age_s`) under BFLC_PROC_TRACE=1."""
    if not tr.enabled:
        return
    last = 0.0
    for step, age in marks.items():
        tr.charge(f"boot.{step}_s", age - last)
        last = age


def _child_device(device: str):
    """Resolve the run's device inside a child; on the CPU one torch
    thread, so a fleet of children does not oversubscribe the cores."""
    import torch

    from bflc_demo_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    return dev


def _client_tls(tls_dir: str):
    """The context for dialling the writer and the read set, or None when
    TLS is off: the one construction point of client-side contexts."""
    if not tls_dir:
        return None
    from bflc_demo_tpu_torch.comm.tls import client_context
    return client_context(tls_dir)


def _server_tls(tls_dir: str):
    if not tls_dir:
        return None
    from bflc_demo_tpu_torch.comm.tls import server_context
    return server_context(tls_dir)


def _server_proc(cfg_kw: dict, initial_blob: bytes, port_q,
                 stall_timeout_s: float, device: str,
                 verbose: bool, wal_path: str = "",
                 standby_keys: Optional[dict] = None,
                 quorum: int = 0, bft_endpoints: Sequence = (),
                 bft_keys: Optional[dict] = None, tls_dir: str = "",
                 snapshot_interval: int = 0,
                 snapshot_dir: str = "") -> None:
    boot = {"entry": process_age_s()}
    _child_device(device)
    boot["device"] = process_age_s()
    from bflc_demo_tpu_torch.comm.ledger_service import LedgerServer
    from bflc_demo_tpu_torch.utils import tracing
    server = LedgerServer(ProtocolConfig(**cfg_kw), initial_blob,
                          stall_timeout_s=stall_timeout_s, device=device,
                          wal_path=wal_path, standby_keys=standby_keys,
                          quorum=quorum,
                          bft_validators=[tuple(e) for e in bft_endpoints]
                          or None,
                          bft_keys=bft_keys or None,
                          tls=_server_tls(tls_dir),
                          snapshot_interval=snapshot_interval,
                          snapshot_dir=snapshot_dir, verbose=verbose)
    boot["server"] = process_age_s()
    _charge_boot(tracing.PROC, boot)
    port_q.put(server.port)
    server.serve_forever()


def _validator_proc(cfg_kw: dict, wallet_seed: bytes, index: int,
                    port_q, validator_keys: dict, verbose: bool,
                    port: int = 0,
                    cell_registry: Optional[dict] = None) -> None:
    """One BFT commit-quorum member (`comm/bft.ValidatorNode`): a replica
    and a wallet that re-execute and co-sign every op, with the peers'
    keys to admit certified backlog when it lags (and, at a hier root,
    the cell registry).  Pure ledger and crypto: it resolves no device
    and imports no torch.  Reports its port and what it imported, then
    blocks."""
    from bflc_demo_tpu_torch.comm.bft import ValidatorNode
    from bflc_demo_tpu_torch.comm.identity import Wallet
    node = ValidatorNode(ProtocolConfig(**cfg_kw),
                         Wallet.from_seed(wallet_seed), index, port=port,
                         validator_keys=validator_keys,
                         cell_registry=cell_registry, verbose=verbose)
    torch = sys.modules.get("torch")
    port_q.put({"port": node.port, "torch_imported": torch is not None,
                "cuda_initialized": bool(
                    torch is not None and torch.cuda.is_initialized()),
                "foreign_modules": foreign_modules()})
    node.serve_forever()


def _standby_proc(cfg_kw: dict, endpoints: List[Tuple[str, int]],
                  index: int, port_q, stall_timeout_s: float,
                  wallet_seed: bytes, standby_keys: dict, quorum: int,
                  device: str, verbose: bool, bft_endpoints: Sequence = (),
                  bft_keys: Optional[dict] = None, tls_dir: str = "",
                  snapshot_interval: int = 0, snapshot_dir: str = "",
                  wal_path: str = "", port: int = 0) -> None:
    """Hot standby: follow the writer's op stream, promote on its death
    (`comm/failover.Standby`).  Reports its serving port (`port`, or a
    free one), then blocks; once promoted it is the writer, merges on
    `device` and journals to `wal_path`."""
    _child_device(device)
    from bflc_demo_tpu_torch.comm.failover import Standby
    from bflc_demo_tpu_torch.comm.identity import Wallet
    standby = Standby(ProtocolConfig(**cfg_kw),
                      endpoints + [("127.0.0.1", 0)], index, port=port,
                      stall_timeout_s=stall_timeout_s,
                      wallet=Wallet.from_seed(wallet_seed),
                      standby_keys=standby_keys, quorum=quorum,
                      bft_validators=[tuple(e) for e in bft_endpoints]
                      or None,
                      bft_keys=bft_keys or None,
                      tls_client=_client_tls(tls_dir),
                      tls_server=_server_tls(tls_dir),
                      snapshot_interval=snapshot_interval,
                      snapshot_dir=snapshot_dir, wal_path=wal_path,
                      device=device, verbose=verbose)
    # the placeholder self-endpoint gets the real bound port
    standby.endpoints[index] = (standby.host, standby.port)
    port_q.put(standby.port)
    threading.Thread(target=_report_follow, args=(standby, port_q),
                     daemon=True).start()
    standby.run()


def _report_follow(standby, q) -> None:
    """Forward a standby's state-syncs and GCs to the parent as they
    happen ({"state_sync": record} / {"gc": record}), and its log base
    when it promotes ({"promoted": {"log_base", "log_size"}})."""
    sent = {"state_sync": 0, "gc": 0}
    while True:
        for kind, log in (("state_sync", standby.state_syncs),
                          ("gc", standby.gc_log)):
            for rec in log[sent[kind]:]:
                q.put({kind: rec})
                sent[kind] += 1
        if standby.promoted.is_set():
            q.put({"promoted": {"log_base": standby.ledger.log_base,
                                "log_size": standby.ledger.log_size()}})
            return
        time.sleep(0.05)


def _host_delta(delta) -> Dict[str, np.ndarray]:
    """The one copy of a trained delta to the host: float32 numpy, no
    cast (what every encode reads)."""
    return {k: v.detach().cpu().numpy() for k, v in delta.items()}


def _encode_delta(delta, cfg) -> bytes:
    """The one client-side delta encoder: the genome's sparse codec when
    it arms sparsity (the certified hash over the sparse canonical
    bytes), else the quantized or dense pipeline."""
    from bflc_demo_tpu_torch.utils.codecs import (delta_codec, pack_pytree,
                                                  pack_quantized,
                                                  pack_sparse,
                                                  sparse_enabled)
    if sparse_enabled(cfg):
        return pack_sparse(delta, cfg.delta_density, cfg.delta_dtype,
                           codec=delta_codec(cfg))
    return (pack_pytree(delta) if cfg.delta_dtype == "f32"
            else pack_quantized(delta, cfg.delta_dtype))


class _DeltaEncoder:
    """Per-client encode wrapper around `_encode_delta`: the error
    feedback of the closed compression loop.  Armed
    (`codecs.error_feedback_enabled`), it stores what the lossy encode
    dropped this upload, `compensated - decoded` in float32 through the
    one decode chain, and adds it into the next delta before encoding.
    The wire does not change, so EF and plain clients share one chain.
    The residual holds only along one model lineage: the caller passes
    each delta's base epoch, and any other than the last one + 1 (a
    rejoin, an async jump past a version) resets it."""

    def __init__(self, cfg):
        from bflc_demo_tpu_torch.utils.codecs import error_feedback_enabled
        self.cfg = cfg
        self.armed = error_feedback_enabled(cfg)
        self._residual: Optional[Dict[str, np.ndarray]] = None
        self._next_base: Optional[int] = None

    def encode(self, delta: Dict[str, np.ndarray], *,
               base_epoch: int) -> bytes:
        """`delta`: host arrays (`_host_delta`)."""
        if not self.armed:
            return _encode_delta(delta, self.cfg)
        from bflc_demo_tpu_torch.utils.codecs import (densify_entries,
                                                      dequantize_entries,
                                                      unpack_pytree)
        if self._next_base is not None and base_epoch != self._next_base:
            self._residual = None       # lineage discontinuity
        self._next_base = base_epoch + 1
        if self._residual is not None:
            delta = {k: (d + self._residual[k]).astype(d.dtype, copy=False)
                     for k, d in delta.items()}
        blob = _encode_delta(delta, self.cfg)
        decoded = densify_entries(dequantize_entries(unpack_pytree(blob)))
        self._residual = {k: np.asarray(d, np.float32)
                          - np.asarray(decoded[k], np.float32)
                          for k, d in delta.items()}
        return blob


def _train_and_encode(model, template, mr, xj, yj, cfg, enc: _DeltaEncoder,
                      base_epoch: int, counts: dict):
    """Train on the fetched model, copy the delta to the host and encode
    it: (blob, cost).  Counts the training and the blob's bytes; charges
    `client.train_s` (the training and the host copy, which waits for
    it) and `client.encode_s`."""
    from bflc_demo_tpu_torch.core.local_train import local_train
    from bflc_demo_tpu_torch.utils import tracing
    from bflc_demo_tpu_torch.utils.serialization import (restore_pytree,
                                                         unpack_pytree)
    tr = tracing.PROC
    t0 = time.perf_counter() if tr.enabled else 0.0
    delta, cost = local_train(
        model, restore_pytree(template, unpack_pytree(mr["blob"])),
        xj, yj, lr=cfg.learning_rate, batch_size=cfg.batch_size,
        local_epochs=cfg.local_epochs)
    counts["trainings"] += 1
    host = _host_delta(delta)
    t1 = time.perf_counter() if tr.enabled else 0.0
    blob = enc.encode(host, base_epoch=base_epoch)
    counts["blob_bytes"] += len(blob)
    if tr.enabled:
        tr.charge("client.train_s", t1 - t0)
        tr.charge("client.encode_s", time.perf_counter() - t1)
        tr.charge("client.encode_n")
    return blob, cost


def _round_passed(client, wallet, epoch: int) -> bool:
    """After a WRONG_EPOCH reply to a committee member's scores: True
    when the writer's round moved past `epoch`, so there is nothing left
    to score.  A writer behind it lost the commit that opened `epoch`
    (a standby promoted without the dead writer's last frames, C13) and
    reaches `epoch` again; marking it scored would leave a live
    committee that never scores, which the stall recovery cannot
    reseat."""
    return client.request("state", addr=wallet.address)["epoch"] > epoch


def _sign(wallet, kind: str, epoch: int, payload: bytes) -> str:
    from bflc_demo_tpu_torch.comm.identity import _op_bytes
    return wallet.sign(_op_bytes(kind, wallet.address, epoch,
                                 payload)).hex()


def _client_async_loop(client, router, wallet, model, template, cfg,
                       xj, yj, n: int, rounds: int,
                       crash_at_epoch: Optional[int], decode,
                       counts: dict, register) -> None:
    """The async-mode client body (FedBuff).  Trainer: fetch -> train ->
    aupload(base epoch), one delta a fetched model version; DUPLICATE
    counts as uploaded, CAP_REACHED / WRONG_EPOCH refetch and retrain.
    Committee: aupdates -> score the entries not scored yet in one
    batched call -> ascores (aseq, score) pairs.  `counts` gathers the
    trainings, the scored entries and the aupload and ascores replies by
    status."""
    from bflc_demo_tpu_torch.comm.identity import _op_bytes
    from bflc_demo_tpu_torch.ledger.base import ascores_sign_payload
    from bflc_demo_tpu_torch.meshagg.engine import score_candidates_batched
    from bflc_demo_tpu_torch.utils import tracing
    from bflc_demo_tpu_torch.utils.serialization import (restore_pytree,
                                                         unpack_pytree)
    tr = tracing.PROC
    uploaded_base = cfg.initial_trained_epoch
    scored_aseqs: set = set()
    known_log = 0
    # the error-feedback residual; a base-epoch jump past a model
    # version this trainer never uploaded against resets it
    enc = _DeltaEncoder(cfg)
    while True:
        st = client.request("state", addr=wallet.address)
        epoch = st["epoch"]
        if epoch >= rounds or epoch > cfg.max_epoch:
            break
        if crash_at_epoch is not None and 0 <= crash_at_epoch <= epoch:
            os._exit(17)        # simulated hard crash
        if epoch < 0:           # registration phase
            known_log = client.request("wait", log_size=known_log,
                                       timeout_s=2.0)["log_size"]
            continue
        acted = False
        if st["role"] == "trainer":
            mr = router.fetch_model()
            if not mr.get("ok"):
                continue
            base_epoch = int(mr["epoch"])
            if base_epoch <= uploaded_base:
                # this model version's delta is in flight or admitted:
                # wait for the chain to move
                known_log = client.request("wait", log_size=known_log,
                                           timeout_s=2.0)["log_size"]
                continue
            blob, cost = _train_and_encode(model, template, mr, xj, yj, cfg,
                                           enc, base_epoch, counts)
            digest = hashlib.sha256(blob).digest()
            router.cache.put(digest.hex(), blob)
            payload = digest + struct.pack("<qd", n, float(cost))
            r = client.request(
                "aupload", addr=wallet.address, blob=blob,
                hash=digest.hex(), n=n, cost=float(cost),
                base_epoch=base_epoch,
                tag=_sign(wallet, "aupload", base_epoch, payload))
            status = str(r.get("status", "ERROR"))
            counts["aupload"][status] = counts["aupload"].get(status, 0) + 1
            if status in ("OK", "DUPLICATE"):
                uploaded_base = base_epoch
                acted = bool(r.get("ok"))
            if status == "BAD_ARG":
                register()      # a directory hole: re-present and retry
        elif st["role"] == "comm":
            ups = [u for u in client.request("aupdates").get("updates", [])
                   if u["aseq"] not in scored_aseqs]
            if ups:
                try:
                    fetched = router.fetch_blobs([u["hash"] for u in ups])
                except (LookupError, ConnectionError):
                    continue    # an entry drained between the two reads
                deltas = [decode(fetched[u["hash"]]) for u in ups]
                mr = router.fetch_model()
                if not mr.get("ok"):
                    continue
                params = restore_pytree(template, unpack_pytree(mr["blob"]))
                t0 = time.perf_counter() if tr.enabled else 0.0
                scores = score_candidates_batched(
                    model, params, deltas, cfg.learning_rate, xj, yj)
                counts["scored"] += len(ups)
                score_list = [float(s) for s in np.nan_to_num(
                    scores.cpu().numpy(), nan=0.0, posinf=1.0, neginf=0.0)]
                if tr.enabled:
                    tr.charge("client.score_s", time.perf_counter() - t0)
                pairs = [(int(u["aseq"]), s)
                         for u, s in zip(ups, score_list)]
                r = client.request(
                    "ascores", addr=wallet.address,
                    pairs=[[a, s] for a, s in pairs],
                    tag=wallet.sign(_op_bytes(
                        "ascores", wallet.address, 0,
                        ascores_sign_payload(pairs))).hex())
                status = str(r.get("status", "ERROR"))
                counts["ascores"][status] = \
                    counts["ascores"].get(status, 0) + 1
                if r.get("status") in ("OK", "NOT_READY", "DUPLICATE"):
                    # NOT_READY: every scored entry drained first; either
                    # way these never need scoring again
                    scored_aseqs.update(u["aseq"] for u in ups)
                    acted = bool(r.get("ok"))
                if r.get("status") == "BAD_ARG":
                    register()
        if not acted:
            known_log = client.request("wait", log_size=known_log,
                                       timeout_s=2.0)["log_size"]


def _client_proc(endpoints: List[Tuple[str, int]], wallet_seed: bytes,
                 model_factory: str, factory_kw: dict,
                 x: np.ndarray, y_onehot: np.ndarray, cfg_kw: dict,
                 rounds: int, crash_at_epoch: Optional[int], device: str,
                 report_q=None, role: str = "client",
                 request_timeout_s: float = 120.0,
                 standby_keys: Optional[dict] = None,
                 bft_keys: Optional[dict] = None,
                 tls_dir: str = "") -> None:
    """One federated client: register -> role loop -> train/score ->
    report -> exit.  The state machine of `client/runtime.FLNode.step`,
    with every ledger interaction a signed socket request and every
    tensor a canonical blob; with several endpoints a dead writer is
    failed over.  `report_q` receives, at exit, the process's kernel
    launches, its tracer summary, where its reads were served and the
    foreign modules it loaded (none: the check that it never touched
    JAX)."""
    boot = {"entry": process_age_s()}
    dev = _child_device(device)
    boot["device"] = process_age_s()
    import torch

    import bflc_demo_tpu_torch.models as models
    from bflc_demo_tpu_torch.client.runtime import feature_tensor
    from bflc_demo_tpu_torch.comm.dataplane import ReadRouter
    from bflc_demo_tpu_torch.comm.failover import FailoverClient
    from bflc_demo_tpu_torch.comm.identity import Wallet
    from bflc_demo_tpu_torch.utils import tracing
    from bflc_demo_tpu_torch.utils.serialization import (densify_entries,
                                                         dequantize_entries,
                                                         restore_pytree,
                                                         unpack_pytree)

    cfg = ProtocolConfig(**cfg_kw)
    model = getattr(models, model_factory)(**factory_kw).to(dev)
    template = model.init_params(0, dev)
    wallet = Wallet.from_seed(wallet_seed)
    xj = feature_tensor(x, dev)
    yj = torch.as_tensor(np.asarray(y_onehot, np.float32), device=dev)
    boot["model"] = process_age_s()
    tr = tracing.PROC

    tls = _client_tls(tls_dir)
    client = FailoverClient(endpoints, timeout_s=request_timeout_s,
                            standby_keys=standby_keys,
                            bft_keys=bft_keys or None, tls=tls)
    router = ReadRouter(client, timeout_s=request_timeout_s, tls=tls)

    def register():
        return client.request("register", addr=wallet.address,
                              pubkey=wallet.public_bytes.hex(),
                              tag=_sign(wallet, "register", 0, b""))

    reply = register()
    if not (reply["ok"] or reply.get("status") in ("ALREADY_REGISTERED",
                                                   "DUPLICATE")):
        raise RuntimeError(f"register failed: {reply}")
    boot["register"] = process_age_s()
    _charge_boot(tr, boot)

    def decode(blob: bytes):
        return restore_pytree(template, densify_entries(
            dequantize_entries(unpack_pytree(blob))))

    counts = {"trainings": 0, "scored": 0, "blob_bytes": 0, "aupload": {},
              "ascores": {}}
    if async_enabled(cfg):
        # FedBuff: no round barrier; stragglers' deltas land late with a
        # staleness tag and a discounted weight
        _client_async_loop(client, router, wallet, model, template, cfg,
                           xj, yj, int(x.shape[0]), rounds, crash_at_epoch,
                           decode, counts, register)
    else:
        _client_sync_loop(client, router, wallet, model, template, cfg,
                          xj, yj, int(x.shape[0]), rounds, crash_at_epoch,
                          decode, counts, register)
    router.close()
    client.close()
    if report_q is not None:
        report_q.put({"role": role, "launches": launch_counts(),
                      "perf": tr.summary() if tr.enabled else None,
                      "reads": {f"{k}/{s}": n
                                for (k, s), n in router.reads.items()},
                      "foreign_modules": foreign_modules(), **counts})


def _client_sync_loop(client, router, wallet, model, template, cfg, xj, yj,
                      n: int, rounds: int, crash_at_epoch: Optional[int],
                      decode, counts: dict, register) -> None:
    """The synchronous client body: one upload a round as a trainer,
    one score row a round on the committee."""
    from bflc_demo_tpu_torch.meshagg.engine import score_candidates_batched
    from bflc_demo_tpu_torch.utils import tracing
    from bflc_demo_tpu_torch.utils.serialization import (restore_pytree,
                                                         unpack_pytree)
    tr = tracing.PROC
    trained_epoch = scored_epoch = cfg.initial_trained_epoch
    known_log = 0
    # the error-feedback residual; any lineage break (a committee round,
    # a rejoin) shows as an epoch gap and resets it
    enc = _DeltaEncoder(cfg)
    while True:
        st = client.request("state", addr=wallet.address)
        epoch = st["epoch"]
        if epoch >= rounds or epoch > cfg.max_epoch:
            break
        if crash_at_epoch is not None and 0 <= crash_at_epoch <= epoch:
            os._exit(17)        # simulated hard crash: the process dies
        if epoch < 0:           # registration phase
            known_log = client.request("wait", log_size=known_log,
                                       timeout_s=2.0)["log_size"]
            continue
        acted = False
        if st["role"] == "trainer" and epoch > trained_epoch:
            mr = router.fetch_model()
            if not mr.get("ok") or mr["epoch"] != epoch:
                continue        # round turned over mid-step; resync
            blob, cost = _train_and_encode(model, template, mr, xj, yj, cfg,
                                           enc, epoch, counts)
            digest = hashlib.sha256(blob).digest()
            router.cache.put(digest.hex(), blob)
            payload = digest + struct.pack("<qd", n, float(cost))
            r = client.request(
                "upload", addr=wallet.address, blob=blob,
                hash=digest.hex(), n=n, cost=float(cost), epoch=epoch,
                tag=_sign(wallet, "upload", epoch, payload))
            if r.get("status") in ("OK", "CAP_REACHED", "DUPLICATE",
                                   "NOT_READY"):
                # NOT_READY = the round closed under recovery; wait it out
                trained_epoch = epoch
                acted = r["ok"]
            if r.get("status") == "BAD_ARG":
                register()      # a directory hole: re-present and retry
        elif st["role"] == "comm" and epoch > scored_epoch:
            ups = client.request("updates")["updates"]
            if ups:
                try:
                    fetched = router.fetch_blobs([u["hash"] for u in ups])
                except LookupError:
                    # the list came from a writer that died before its
                    # standby mirrored those uploads: the promoted writer
                    # lists only what it holds, so wait and re-poll (C17)
                    known_log = client.request(
                        "wait", log_size=known_log,
                        timeout_s=2.0)["log_size"]
                    continue
                deltas = [decode(fetched[u["hash"]]) for u in ups]
                mr = router.fetch_model()
                if not mr.get("ok"):
                    continue
                params = restore_pytree(template, unpack_pytree(mr["blob"]))
                t0 = time.perf_counter() if tr.enabled else 0.0
                scores = score_candidates_batched(
                    model, params, deltas, cfg.learning_rate, xj, yj)
                counts["scored"] += len(ups)
                score_list = [float(s) for s in np.nan_to_num(
                    scores.cpu().numpy(), nan=0.0, posinf=1.0, neginf=0.0)]
                if tr.enabled:
                    tr.charge("client.score_s", time.perf_counter() - t0)
                payload = struct.pack(f"<{len(score_list)}d", *score_list)
                r = client.request(
                    "scores", addr=wallet.address, epoch=epoch,
                    scores=score_list,
                    tag=_sign(wallet, "scores", epoch, payload))
                if r.get("status") in ("OK", "DUPLICATE") or (
                        r.get("status") == "WRONG_EPOCH"
                        and _round_passed(client, wallet, epoch)):
                    scored_epoch = epoch
                    acted = r["ok"]
                if r.get("status") == "BAD_ARG":
                    register()
        if not acted:
            known_log = client.request("wait", log_size=known_log,
                                       timeout_s=2.0)["log_size"]


def _replica_proc(host: str, port: int, cfg_kw: dict, until_ops: int,
                  out_q, tls_dir: str = "") -> None:
    from bflc_demo_tpu_torch.comm.ledger_service import replicate
    try:
        replica = replicate(host, port, ProtocolConfig(**cfg_kw),
                            until_ops=until_ops, timeout_s=120.0,
                            tls=_client_tls(tls_dir))
        out_q.put({"ok": True, "head": replica.log_head().hex(),
                   "size": replica.log_size(), "epoch": replica.epoch,
                   "foreign_modules": foreign_modules()})
    except Exception as e:              # report, don't hang the parent
        out_q.put({"ok": False, "error": f"{type(e).__name__}: {e}"})


class ProcessFederationResult:
    def __init__(self, accuracy_history, rounds_completed, log_head,
                 log_size, recovered_clients, replica_report,
                 wall_time_s: float = 0.0, final_info=None):
        self.accuracy_history = accuracy_history
        self.rounds_completed = rounds_completed
        self.ledger_log_head = log_head
        self.ledger_log_size = log_size
        self.recovered_clients = recovered_clients
        self.replica_report = replica_report
        self.wall_time_s = wall_time_s
        # the writer's last `info` reply (with `perf` under
        # BFLC_PROC_TRACE=1: its wire / crypto / aggregate split)
        self.final_info = final_info
        # (epoch, seconds since start) at each sponsor-observed commit:
        # steady-state rounds apart from the fleet's spawn
        self.epoch_times: List[Tuple[int, float]] = []
        # seconds from the start until every client had registered
        self.spawn_s = 0.0
        # role -> that process's kernel launches ("writer", "client-i",
        # "sponsor"), and the writer's merge-engine report
        self.kernel_launches: Dict[str, Dict[str, int]] = {}
        self.writer_engine: Optional[dict] = None
        # the writer's record of every commit (epoch, seconds since it
        # started, the merge's seconds, the leg): exact round times,
        # where the sponsor's 0.2 s poll can miss a commit
        self.writer_merges: List[dict] = []
        self.ed25519_backend: Optional[str] = None
        # role -> that client's tracer summary (BFLC_PROC_TRACE=1)
        self.client_perf: Dict[str, Optional[dict]] = {}
        # role -> JAX or reference modules that child loaded (none)
        self.child_foreign_modules: Dict[str, List[str]] = {}
        self.replica_reports: List[dict] = []
        # role -> where that client's reads were served ("model/replica":
        # n, ...): the read fan-out's share
        self.client_reads: Dict[str, Dict[str, int]] = {}
        # the writer-kill drill (None without one): the kill's epoch and
        # time, the primary's last `info` and `kernels` replies, the final
        # writer's index, start and first commit (host monotonic clock)
        self.failover: Optional[dict] = None
        # BFT: the final writer's certified prefix (== log_size when every
        # op bound; None without validators), each validator's start
        # report (torch imported, CUDA initialised, foreign modules) and
        # the seconds the validators took to come up
        self.certified_size: Optional[int] = (
            (final_info or {}).get("certified_size"))
        self.validator_reports: Dict[str, dict] = {}
        self.validator_spawn_s = 0.0
        # role -> that standby's follow events in order: {"state_sync":
        # {i, epoch, seconds}}, {"gc": {i, dropped}}, {"promoted":
        # {log_base, log_size}}
        self.standby_events: Dict[str, List[dict]] = {}
        # the final writer's snapshot ops {i, epoch, state_bytes,
        # model_bytes, artifact_bytes, write_s, gc_dropped}, and under
        # TLS whether it refused a plaintext client at the handshake
        self.writer_snapshots: List[dict] = []
        self.plaintext_refused: Optional[bool] = None
        # role -> that client's trainings, scored entries and aupload and
        # ascores replies by status ({"trainings", "scored",
        # "blob_bytes", "aupload", "ascores"})
        self.client_counts: Dict[str, dict] = {}
        # the final writer's chain record (`LedgerServer._scan_chain`: the
        # opcode at every position from its start and each opcode-12
        # op's claims) and its
        # start ({"log_base", "async_buffer": the aseqs it inherited})
        self.writer_chain: Optional[dict] = None
        self.writer_start: Optional[dict] = None
        # seconds from the start to the end of each step after the
        # rounds: "rounds" (the sponsor saw the last commit),
        # "client_reports", "certified", "replicas", "teardown"
        self.phase_s: Dict[str, float] = {}
        # a hier fleet (`hier/runtime.run_federated_hier`): the cell plan,
        # each member's wallet address and exit code (spawn order), the
        # fleet's ports by role, every root op's name, sender and epoch,
        # the cells killed by the re-home drill, and by cell index each
        # live aggregator's partial records (`merge_log`), merge-engine
        # report and the root's replies to its bridge by status
        self.cell_plan = None
        self.member_addresses: List[str] = []
        self.client_exitcodes: List[Optional[int]] = []
        self.port_of: Dict[str, int] = {}
        self.root_ops: List[dict] = []
        self.killed_cells: List[int] = []
        self.cell_merges: Dict[int, List[dict]] = {}
        self.cell_engines: Dict[int, dict] = {}
        self.cell_bridge: Dict[int, dict] = {}

    @property
    def final_accuracy(self) -> float:
        return self.accuracy_history[-1][1] if self.accuracy_history else 0.0

    def best_accuracy(self) -> float:
        return max((a for _, a in self.accuracy_history), default=0.0)


def _drain_reports(q, procs, wait_s: float) -> List[dict]:
    """Every report the processes put on `q`, read while they exit (a
    process that put on a queue exits only once its data is flushed):
    until all have exited and the queue is empty, or `wait_s` passes."""
    reports: List[dict] = []
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            reports.append(q.get(timeout=0.2))
        except queue.Empty:
            if not any(p.is_alive() for p in procs):
                break
    return reports


def _drain_now(q) -> List[dict]:
    """Whatever `q` holds now."""
    out: List[dict] = []
    while True:
        try:
            out.append(q.get(timeout=0.05))
        except queue.Empty:
            return out


def client_seed(master_seed: bytes, i: int) -> bytes:
    """Client i's wallet seed: the reference's derivation from the run's
    master seed."""
    return master_seed + struct.pack("<q", i)


def start_validators(vctx, cfg_kw: dict, master_seed: bytes, n: int,
                     bft_keys: dict, verbose: bool, host: str,
                     cell_registry: Optional[dict] = None):
    """Spawn `n` BFT validators at once (identities from the master
    seed) and read each one's start report in index order.  Returns
    (processes, reports by role, endpoints); a failure terminates the
    ones started."""
    procs: List = []
    qs: List = []
    reports: Dict[str, dict] = {}
    endpoints: List[Tuple[str, int]] = []
    try:
        for v in range(n):
            q = vctx.Queue()
            vp = children.process(vctx, _validator_proc, (
                cfg_kw, master_seed + b"|bft-validator|"
                + struct.pack("<q", v), v, q, bft_keys, verbose, 0,
                cell_registry))
            vp.start()
            procs.append(vp)
            qs.append(q)
        for v, q in enumerate(qs):
            rep_v = q.get(timeout=120)
            reports[f"validator-{v}"] = rep_v
            endpoints.append((host, rep_v["port"]))
    except BaseException:
        for vp in procs:
            vp.terminate()
        raise
    return procs, reports, endpoints


def sponsor_rounds(sponsor, router, model, template, test_t, rounds: int,
                   deadline: float, t_start: float, verbose: bool,
                   incomplete: str, on_info=None):
    """The sponsor's watch over the rounds: poll the writer's `info`,
    evaluate every newly committed model on `test_t` (x, y_onehot), stop
    once `rounds` epochs committed.  `on_info(info)` runs on each reply
    (a drill's kill); when it returns True the sponsor polls again at
    once.  Every endpoint dark for a moment (mid-promotion) is retried:
    the deadline, not one poll, decides the run failed, and then raises
    naming `incomplete`.  Returns (history, epoch_times, spawn_s): the
    (epoch, accuracy) and (epoch, seconds since `t_start`) at each
    commit seen, and the seconds until the first epoch opened."""
    from bflc_demo_tpu_torch.core.local_train import evaluate
    from bflc_demo_tpu_torch.utils.serialization import (restore_pytree,
                                                         unpack_pytree)
    history: List[Tuple[int, float]] = []
    epoch_times: List[Tuple[int, float]] = []
    spawn_s = 0.0
    seen_epoch = 0              # the model at epoch 0 is the initial one
    while time.monotonic() < deadline:
        try:
            info = sponsor.request("info")
        except ConnectionError:
            time.sleep(0.5)
            continue
        if on_info is not None and on_info(info):
            continue
        if not spawn_s and info["epoch"] >= 0:
            spawn_s = time.monotonic() - t_start
        if info["epoch"] > seen_epoch:
            try:
                mr = router.fetch_model()
            except ConnectionError:
                time.sleep(0.5)
                continue
            if mr.get("ok") and mr["epoch"] > seen_epoch:
                params = restore_pytree(template, unpack_pytree(mr["blob"]))
                acc = float(evaluate(model, params, *test_t))
                history.append((mr["epoch"] - 1, acc))
                epoch_times.append((mr["epoch"] - 1,
                                    time.monotonic() - t_start))
                seen_epoch = mr["epoch"]
                if verbose:
                    print(f"Epoch: {mr['epoch'] - 1:03d}, "
                          f"test_acc: {acc:.4f}", flush=True)
        # epoch counts committed rounds across a failover; an armed
        # drill kills first
        if info["epoch"] >= rounds:
            return history, epoch_times, spawn_s
        try:
            # wake on the log's next op, or after 0.2 s
            sponsor.request("wait", log_size=info["log_size"],
                            timeout_s=0.2)
        except ConnectionError:
            pass
    raise TimeoutError(f"{incomplete} ({len(history)}/{rounds} rounds)")


def _info_with_retry(sponsor, attempts: int = 20,
                     delay_s: float = 0.5) -> dict:
    """The writer's `info`, retried through a transient outage."""
    for i in range(attempts):
        try:
            return sponsor.request("info")
        except ConnectionError:
            if i == attempts - 1:
                raise
            time.sleep(delay_s)
    raise ConnectionError("unreachable")


def final_info(sponsor, certified: bool, deadline: float) -> dict:
    """The writer's last `info`.  With `certified` (BFT) it waits until
    every op is certified: the sponsor saw the last commit before its
    certificate (a read is not certified), so the certify loop catches
    up and `certified_size` reports the finished chain."""
    final = _info_with_retry(sponsor)
    while certified and final["certified_size"] != final["log_size"]:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{final['log_size']} ops, "
                               f"{final['certified_size']} certified "
                               f"at the deadline")
        sponsor.request("wait", log_size=final["log_size"], timeout_s=0.2)
        final = _info_with_retry(sponsor)
    return final


def join_clients(clients) -> List[Optional[int]]:
    """Wait for the clients to exit, terminating any still running after
    15 s; each one's exit code, in spawn order."""
    for p in clients:
        p.join(timeout=15)
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
    return [p.exitcode for p in clients]


def stop_processes(procs) -> None:
    """Terminate and reap the fleet's server-side processes."""
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join(timeout=10)


def absorb_reports(result: "ProcessFederationResult",
                   writer_kernels: Optional[dict],
                   client_reports: List[dict],
                   launches: Dict[str, Dict[str, int]]) -> None:
    """Fill `result` from the final writer's `kernels` reply and the
    clients' reports: launch counts by role (the sponsor's own last), the
    writer's engine report, merge, snapshot and chain records, and each
    client's tracer summary, reads, foreign modules and counts."""
    kr = writer_kernels
    if kr is not None and kr.get("ok"):
        launches["writer"] = kr["launches"]
        result.writer_engine = kr["engine"]
        result.writer_merges = kr["merges"]
        result.writer_snapshots = kr.get("snapshots", [])
        result.writer_chain = kr.get("chain")
        result.writer_start = {
            "log_base": kr.get("started_log_base"),
            "async_buffer": kr.get("started_async_buffer")}
        result.ed25519_backend = kr["ed25519_backend"]
    for rep in client_reports:
        launches[rep["role"]] = rep["launches"]
        result.client_perf[rep["role"]] = rep["perf"]
        result.client_reads[rep["role"]] = rep["reads"]
        result.child_foreign_modules[rep["role"]] = rep["foreign_modules"]
        result.client_counts[rep["role"]] = {
            k: rep[k] for k in ("trainings", "scored", "blob_bytes",
                                "aupload", "ascores")}
    launches["sponsor"] = launch_counts()
    result.kernel_launches = launches


def client_args(endpoints, master_seed: bytes, i: int, model_factory: str,
                factory_kw: dict, x, y, num_classes: int, cfg_kw: dict,
                rounds: int, crash_at_epoch: Optional[int], device: str,
                report_q, standby_keys: Optional[dict] = None,
                bft_keys: Optional[dict] = None, tls_dir: str = "",
                request_timeout_s: float = 120.0) -> tuple:
    """`_client_proc`'s arguments for client i (its wallet seed is the
    reference's derivation from the run's master seed)."""
    from bflc_demo_tpu_torch.data.partition import one_hot
    return (list(endpoints), client_seed(master_seed, i),
            model_factory, factory_kw, np.asarray(x),
            one_hot(np.asarray(y), num_classes), cfg_kw, rounds,
            crash_at_epoch, device, report_q, f"client-{i}",
            request_timeout_s, standby_keys, bft_keys, tls_dir)


def run_federated_processes(
        model_factory: str,
        shards: Sequence[Tuple[np.ndarray, np.ndarray]],
        test_set: Tuple[np.ndarray, np.ndarray],
        cfg: ProtocolConfig,
        rounds: int = 5, *,
        factory_kw: Optional[dict] = None,
        master_seed: bytes = b"process-federation-master-0001",
        crash_at: Optional[Dict[int, int]] = None,
        stall_timeout_s: float = 5.0,
        wal_path: str = "",
        replicas: int = 1,
        standbys: int = 0,
        kill_writer_at_epoch: Optional[int] = None,
        quorum: int = 0,
        bft_validators: int = 0,
        tls_dir: str = "",
        snapshot_interval: int = 0,
        snapshot_dir: str = "",
        timeout_s: float = 600.0,
        init_seed: int = 0,
        device: Optional[str] = None,
        verbose: bool = False,
        **unported) -> ProcessFederationResult:
    """Run a federation as (1 writer + N clients [+ standbys] [+
    replicas]) OS processes; the parent is the sponsor.

    model_factory/factory_kw: the `bflc_demo_tpu_torch.models` entry each
    process builds its model with.  crash_at: {client index: epoch} —
    that client's process hard-exits at that epoch and the writer's
    recovery ops must carry the round.  standbys: hot standbys following
    the writer and promoting on its death.  kill_writer_at_epoch: SIGKILL
    the primary once the federation reaches this epoch (needs standbys >=
    1); the promoted standby finishes the run.  quorum: acknowledge a
    mutation only after this many standbys applied it (needs standbys >=
    quorum + 1, so a promoted writer keeps quorum followers).  wal_path:
    the primary's journal.  replicas: replica processes that replay the
    final writer's op stream after the run; each must reproduce its head.
    bft_validators: spawn this many BFT commit-quorum validator processes
    (`comm/bft.py`; 4 is the reference's f=1 geometry): every op must
    gather `bft_quorum(n)` co-signatures before it binds.
    tls_dir: provision (or reuse) the TLS certificates there and run
    every role's connections over TLS (validators excepted).
    snapshot_interval: a certified snapshot op every K rounds; the writer
    and the standbys GC their logs and WALs behind it, and a standby whose
    resume point was GC'd state-syncs.  snapshot_dir: the artifacts, in
    a directory per role (writer/, standby-s/).
    device: where every role computes, `cuda` (None) or `cpu`; the
    validators compute nothing on it.
    Async FedBuff rides the genome, not an option: `cfg.async_buffer`
    K > 0 switches every role (`ledger/base.async_enabled`;
    `BFLC_ASYNC_LEGACY=1` pins it off fleet-wide).
    """
    for name, default in _FLEET_DEFAULTS.items():
        if unported.get(name) == default:
            unported.pop(name)
    from bflc_demo_tpu_torch.comm.ledger_service import refuse_unported
    refuse_unported(unported, UNPORTED_FLEET_OPTIONS)
    cfg.validate()
    if len(shards) != cfg.client_num:
        raise ValueError(f"need {cfg.client_num} shards, got {len(shards)}")
    if kill_writer_at_epoch is not None and standbys < 1:
        raise ValueError("kill_writer_at_epoch requires standbys >= 1")
    if bft_validators < 0:
        raise ValueError(f"bft_validators must be >= 0, got "
                         f"{bft_validators}")
    if quorum and standbys < quorum + 1:
        raise ValueError(
            f"quorum={quorum} requires standbys >= {quorum + 1}: a "
            f"promoted writer must retain {quorum} followers to keep "
            f"acknowledging mutations after a failover")
    crash_at = crash_at or {}
    factory_kw = factory_kw or {}
    t_start = time.monotonic()
    if tls_dir:
        from bflc_demo_tpu_torch.comm.tls import provision_tls
        provision_tls(tls_dir)
    tls = _client_tls(tls_dir)

    def snap_dir(role: str) -> str:
        return os.path.join(snapshot_dir, role) if snapshot_dir else ""

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
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    # standby identities, the reference's derivation from the master
    # seed: only their public keys reach the writer (the demotion
    # allowlist), the clients and the sponsor
    standby_seeds = {s: master_seed + b"|standby|" + struct.pack("<q", s)
                     for s in range(1, standbys + 1)}
    standby_keys = {i: Wallet.from_seed(sd).public_bytes
                    for i, sd in standby_seeds.items()}
    # BFT validators: identities from the master seed (the reference's
    # derivation, `provision_validators`); only public keys travel
    bft_keys: Dict[int, bytes] = {}
    if bft_validators:
        from bflc_demo_tpu_torch.comm.bft import provision_validators
        _, bft_keys = provision_validators(bft_validators, master_seed)

    # validators (no torch) are spawned; every other role forks from a
    # forkserver that imported torch once (`client/children.py`)
    vctx = children.spawn_context()
    ctx = children.torch_context()
    host = "127.0.0.1"
    t_val = time.monotonic()
    validator_procs, validator_reports, bft_endpoints = start_validators(
        vctx, cfg_kw, master_seed, bft_validators, bft_keys, verbose, host)
    validator_spawn_s = time.monotonic() - t_val
    port_q = ctx.Queue()
    server = children.process(ctx, _server_proc, (
        cfg_kw, initial_blob, port_q, stall_timeout_s, device_name, verbose,
        wal_path, standby_keys, quorum, bft_endpoints, bft_keys, tls_dir,
        snapshot_interval, snap_dir("writer")))
    server.start()
    standby_procs: List = []
    standby_qs: Dict[str, object] = {}
    standby_events: Dict[str, List[dict]] = {}
    clients: List = []
    report_q = ctx.Queue()
    sponsor = router = None
    # seconds from the start to the end of each step after the rounds
    marks: Dict[str, float] = {}
    kr: Optional[dict] = None
    plaintext_refused = None
    final = None
    failover: Optional[dict] = None
    replica_reports: List[dict] = []
    client_reports: List[dict] = []
    try:
        port = port_q.get(timeout=120)
        endpoints = [(host, port)]
        # standbys spawn in priority order; each knows the endpoints
        # above it
        for s in range(1, standbys + 1):
            q = ctx.Queue()
            sp = children.process(ctx, _standby_proc, (
                cfg_kw, list(endpoints), s, q, stall_timeout_s,
                standby_seeds[s], standby_keys, quorum, device_name, verbose,
                bft_endpoints, bft_keys, tls_dir, snapshot_interval,
                snap_dir(f"standby-{s}"),
                f"{wal_path}.standby-{s}" if wal_path else ""))
            sp.start()
            standby_procs.append(sp)
            standby_qs[f"standby-{s}"] = q
            endpoints.append((host, q.get(timeout=120)))
        # each client in a process group of its own: the drill may stop
        # them (`_paused`) and kill the writer meanwhile
        for i, (sx, sy) in enumerate(shards):
            p = children.process(ctx, _client_proc, client_args(
                endpoints, master_seed, i, model_factory, factory_kw, sx,
                sy, nc, cfg_kw, rounds, crash_at.get(i), device_name,
                report_q, standby_keys, bft_keys, tls_dir), own_group=True)
            p.start()
            clients.append(p)

        xte, yte = test_set
        xte_t = feature_tensor(xte, dev)
        yte_t = torch.as_tensor(one_hot(np.asarray(yte), nc), device=dev)
        sponsor = FailoverClient(endpoints, timeout_s=120.0,
                                 standby_keys=standby_keys,
                                 bft_keys=bft_keys or None, tls=tls)
        router = ReadRouter(sponsor, timeout_s=120.0, tls=tls)
        deadline = time.monotonic() + timeout_s

        def drill(info: dict) -> bool:
            """The writer-kill drill: SIGKILL the primary as soon as it
            committed the epoch (before the sponsor's evaluation), so the
            promoted standby takes the next round.  Under BFT a standby
            follows certified ops only and cannot promote past certified
            ops it never received, so the kill waits until the primary
            certified its chain and a subscriber acked all of it (the
            reference's 0.2 s poll gives them that time).  Under a steady
            stream of appends the chain has no such moment: the clients
            are stopped meanwhile and continued once the primary is
            dead."""
            nonlocal failover
            if kill_writer_at_epoch is None or failover is not None \
                    or info["epoch"] < kill_writer_at_epoch:
                return False
            with _paused(clients if bft_validators else []) as settle:
                while bft_validators and \
                        not _primary_settled((host, port), tls):
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            "the primary's chain never settled for the "
                            "writer-kill drill")
                    time.sleep(0.005)
                failover = _kill_primary(server, (host, port), info, tls)
            failover["settle"] = settle
            if verbose:
                print(f"[drill] primary coordinator killed at epoch "
                      f"{info['epoch']}", flush=True)
            return True

        history, epoch_times, spawn_s = sponsor_rounds(
            sponsor, router, model, template, (xte_t, yte_t), rounds,
            deadline, t_start, verbose,
            f"process federation incomplete after {timeout_s}s", drill)
        marks["rounds"] = time.monotonic() - t_start
        # the clients first: an async client mid-training still uploads,
        # and its op (a drain with it) belongs to the chain the final
        # `info` reports
        client_reports = _drain_reports(report_q, clients, wait_s=60.0)
        marks["client_reports"] = time.monotonic() - t_start
        final = final_info(sponsor, bool(bft_validators), deadline)
        final_ep = sponsor.current_endpoint
        marks["certified"] = time.monotonic() - t_start
        if replicas > 0:
            rep_q = ctx.Queue()
            rps = [children.process(ctx, _replica_proc, (
                final_ep[0], final_ep[1], cfg_kw, final["log_size"], rep_q,
                tls_dir)) for _ in range(replicas)]
            for rp in rps:
                rp.start()
            replica_reports = [rep_q.get(timeout=180) for _ in rps]
            for rp in rps:
                rp.join(timeout=10)
            for rep in replica_reports:
                if not rep["ok"]:
                    raise RuntimeError(f"replica failed: {rep['error']}")
                # a replica that state-synced past the final size (the
                # writer's stall recovery drained after it) is held to
                # the writer's head at its own size
                want = (final["log_head"] if rep["size"] == final["log_size"]
                        else sponsor.request("info", at=rep["size"]).get(
                            "head_at"))
                if rep["head"] != want:
                    raise RuntimeError("replica/writer head divergence")
        marks["replicas"] = time.monotonic() - t_start
        if tls_dir:
            plaintext_refused = _plaintext_refused(final_ep)
        kr = sponsor.request("kernels")
        if kr.get("ok") and failover is not None:
            failover.update(_promotion_account(failover, kr))
    finally:
        if router is not None:
            router.close()
        if sponsor is not None:
            sponsor.close()
        join_clients(clients)
        for role, q in standby_qs.items():
            standby_events[role] = _drain_now(q)
        stop_processes([server] + standby_procs + validator_procs)
    marks["teardown"] = time.monotonic() - t_start

    result = ProcessFederationResult(
        accuracy_history=history,
        rounds_completed=final["epoch"],
        log_head=final["log_head"],
        log_size=final["log_size"],
        recovered_clients=[i for i in crash_at
                           if clients[i].exitcode not in (0, None)],
        replica_report=replica_reports[0] if replica_reports else None,
        wall_time_s=time.monotonic() - t_start,
        final_info=final)
    result.epoch_times = epoch_times
    result.spawn_s = spawn_s
    result.phase_s = marks
    absorb_reports(result, kr, client_reports, {})
    for i, rep in enumerate(replica_reports):
        result.child_foreign_modules[f"replica-{i}"] = \
            rep.get("foreign_modules", [])
    result.replica_reports = replica_reports
    result.validator_reports = validator_reports
    result.validator_spawn_s = validator_spawn_s
    result.standby_events = standby_events
    result.plaintext_refused = plaintext_refused
    if failover is not None:
        failover["kill_t"] = failover["kill_mono"] - t_start
    result.failover = failover
    return result


def _plaintext_refused(endpoint) -> bool:
    """True when a plaintext client gets no reply from a TLS writer."""
    from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
    from bflc_demo_tpu_torch.comm.wire import WireError
    try:
        probe = CoordinatorClient(*endpoint, timeout_s=15.0)
        try:
            probe.request("info")
        finally:
            probe.close()
    except (ConnectionError, WireError, OSError):
        return True
    return False


def _primary_settled(endpoint, tls=None) -> bool:
    """True when the primary's chain is fully certified and a follower
    acked its last op (or the primary no longer answers)."""
    from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
    try:
        probe = CoordinatorClient(*endpoint, timeout_s=30.0, tls=tls)
        try:
            k = probe.request("kernels")
        finally:
            probe.close()
    except (ConnectionError, OSError):
        return True
    return (k.get("certified_size") == k.get("log_size")
            and k.get("stream_acked", -1) >= k.get("log_size", 0) - 1)


@contextlib.contextmanager
def _paused(procs):
    """SIGSTOP the live processes of `procs` for the block and SIGCONT
    them after it, whatever it raised.  Yields the pause's record,
    filled in on the way out: the processes stopped and the seconds
    they were.  Each of `procs` should lead a process group of its own
    (`children.process(own_group=True)`), or a process that exits in
    the block may bring SIGHUP to this one."""
    record = {"stopped": 0, "wait_s": 0.0}
    stopped = []
    t0 = time.monotonic()
    try:
        for p in procs:
            if p.is_alive():
                try:
                    os.kill(p.pid, signal.SIGSTOP)
                    stopped.append(p)
                except ProcessLookupError:
                    pass
        yield record
    finally:
        for p in stopped:
            try:
                os.kill(p.pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
        record.update(stopped=len(stopped),
                      wait_s=time.monotonic() - t0)


def _kill_primary(server, endpoint, info: dict, tls=None) -> dict:
    """The writer-kill drill: the primary's `info` and `kernels` replies,
    then SIGKILL.  Returns the drill's record."""
    from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
    record = {"killed_at_epoch": info["epoch"], "primary_info": None,
              "primary_kernels": None}
    try:
        probe = CoordinatorClient(*endpoint, timeout_s=30.0, tls=tls)
        try:
            record["primary_info"] = probe.request("info")
            record["primary_kernels"] = probe.request("kernels")
        finally:
            probe.close()
    except (ConnectionError, OSError):
        pass
    record["kill_mono"] = time.monotonic()
    server.kill()
    server.join(timeout=10)
    return record


def _promotion_account(failover: dict, kernels: dict) -> dict:
    """The promoted writer's side of the drill from its `kernels` reply:
    its index, start and first commit after the kill on the monotonic
    clock, that commit's merge seconds."""
    kill = failover["kill_mono"]
    after = [m for m in kernels.get("merges", []) if m.get("mono", 0) > kill]
    return {"writer_index": kernels.get("writer_index"),
            "gen": kernels.get("gen"),
            "promote_s": kernels.get("started_mono", kill) - kill,
            "gap_s": after[0]["mono"] - kill if after else None,
            "first_merge_s": after[0]["merge_s"] if after else None,
            "warm_merge_s": [m["merge_s"] for m in after[1:]]}
