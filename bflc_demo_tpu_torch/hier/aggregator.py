"""The cell aggregator: a full coordinator for its members, a client of
the root.

Port of `bflc_demo_tpu/hier/aggregator.py`, `CellAggregatorServer`.
It IS a `comm.ledger_service.LedgerServer` — its members register,
upload deltas and committee-score over the unchanged wire protocol, with
the unchanged Ed25519 admission, per-sender gas budgets and stall
recovery, all at cell scope.  What changes is the round's ending: where
the single-tier coordinator merges into a NEW global model, the cell
aggregator computes one deterministic PARTIAL (`hier.partial.
cell_partial` over the cell-selected deltas, on the server's merge
engine: kernel B5 on the card) and hands it to the bridge thread, which
runs the standard client state machine against the ROOT ledger:

- root role *trainer*: sign and upload the partial as a cell-aggregate
  op (a standard `upload`: hash over the partial's canonical bytes with
  the #cellmeta evidence entry, `n` = admitted client count, `cost` =
  mean member cost) — one certified root op per cell per round; in
  sparse mode the partial is re-sparsified for this hop at the genome's
  density (`partial_blob`), the sparse bridge;
- root role *comm*: fetch the round's candidate partials through the
  read path and score them on this aggregator's validation shard with
  `core.scoring.score_candidates` on the server's device (kernel K1 on
  the card); without a shard or a model it submits a neutral row;
- on the root's commit: fetch the new global model (hash-verified via
  `comm.dataplane.ReadRouter`) and commit it into the local cell ledger
  so members see the next epoch — the aggregator is the serving replica
  for its own members (`handle_read` is inherited).

The bridge holds no lock during root I/O: members keep polling and
reading while the cell waits on the root, and a root outage degrades to
retries (FailoverClient semantics) rather than wedging the cell.  Each
cell round's partial is recorded in the inherited `merge_log` (epoch,
leg, blocks, seconds, admitted count), so the `kernels` method reports
the cell's B5 launches and merges, and the root's replies to the
bridge by status (`bridge`).

The rederive plane (reference :204-224, :254-300): with
`BFLC_REDERIVE` armed each partial's outbox carries the member-signed
evidence (`cell_ev`: every admitted member record with the member's own
upload tag and public key, the medians, the selection and this
aggregator's read endpoint), which the bridge's upload hands the root,
and the round's member blobs stay servable one round for the root
validators' fetches.  A promoted aggregator that lost a member's tag
ships none, and the validators skip, counted.  The closed compression
loop (reference :127-132, :346-383, :510-516): the bridge mirrors the
root's effective density from its `state` replies, re-encodes a partial
at the density in force when it uploads (`_outbox_blob`) and serves the
mirrored knob to its members (`_state_knobs`).

Dropped, as the port's `LedgerServer` drops them: the obs metrics,
health plane, trace spans and flight recorder (ROADMAP A14).
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from bflc_demo_tpu_torch.comm.failover import FailoverClient
from bflc_demo_tpu_torch.comm.identity import _op_bytes
from bflc_demo_tpu_torch.comm.ledger_service import LedgerServer
from bflc_demo_tpu_torch.comm.wire import WireError
from bflc_demo_tpu_torch.hier.partial import (cell_evidence_digest,
                                              cell_partial, partial_blob,
                                              split_cellmeta)
from bflc_demo_tpu_torch.ledger import LedgerStatus
from bflc_demo_tpu_torch.ledger.base import reduce_blocks
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig
from bflc_demo_tpu_torch.utils.codecs import densify_entries, unpack_pytree

Endpoint = Tuple[str, int]

# the bridge's per-request timeout against the root ledger
ROOT_TIMEOUT_S = 30.0


class CellAggregatorServer(LedgerServer):
    """One cell's coordinator + the root's client (module docstring).

    `cfg` is the CELL-tier protocol genome (`hier.cells.cell_protocol`).
    `wallet` is this aggregator's provisioned identity — the only key
    that can submit this cell's partials (the root's cell registry maps
    its address to the cell's registered membership).  `val_shard` is an
    optional (x, y_onehot) validation set for root-committee scoring;
    `model_factory`/`factory_kw` name the model (`bflc_demo_tpu_torch.
    models`) it scores with, on the server's `device`.
    """

    def __init__(self, cfg: ProtocolConfig, initial_model_blob: bytes,
                 cell_index: int, wallet,
                 root_endpoints: List[Endpoint], *,
                 model_factory: str = "", factory_kw: Optional[dict] = None,
                 val_shard: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 root_bft_keys: Optional[Dict[int, bytes]] = None,
                 **kw):
        # the cell ledger is the python backend (tiny chains)
        kw.setdefault("ledger_backend", "python")
        self._device_arg = kw.get("device")
        super().__init__(cfg, initial_model_blob, **kw)
        self.cell_index = cell_index
        self.wallet = wallet
        self._root_endpoints = list(root_endpoints)
        self._root_bft_keys = dict(root_bft_keys or {})
        self._model_factory = model_factory
        self._factory_kw = dict(factory_kw or {})
        self._val = val_shard
        self._model = None              # built at the first score
        self._template = None
        self._val_t = None
        # the bridge handoff: the computed partial awaiting root
        # submission for its epoch (one at a time — rounds are serial)
        self._outbox: Optional[dict] = None
        self._partial_epoch: Optional[int] = None
        # the ROOT's effective delta density, mirrored off its `state`
        # replies when the closed loop is armed there (None: the
        # genome's): the partial's re-encode and the members' knob
        self._root_eff_density: Optional[float] = None
        # the root's replies to this bridge's uploads and scores, by
        # status (`kernels` reports them: a refused partial shows here)
        self.bridge_replies: Dict[str, Dict[str, int]] = {"upload": {},
                                                          "scores": {}}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        super().start()
        t = threading.Thread(target=self._root_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _stage_delta(self, digest: bytes, flat) -> None:
        """Nothing to stage: the partial sums the decoded blobs."""

    def _m_kernels(self, m: dict) -> dict:
        """The server's `kernels` reply with the bridge's root replies by
        status (`bridge`)."""
        reply = super()._m_kernels(m)
        reply["bridge"] = {k: dict(v)
                           for k, v in self.bridge_replies.items()}
        return reply

    def _count_reply(self, method: str, r: dict) -> None:
        status = str(r.get("status", "ERROR"))
        counts = self.bridge_replies[method]
        counts[status] = counts.get(status, 0) + 1

    # ------------------------------------------------- cell round ending
    def _aggregate_and_commit(self) -> None:
        """Ends the CELL round: compute the deterministic partial from
        the cell-selected deltas and stage it for the bridge — the local
        ledger does NOT commit here (it commits when the root's round
        does, with the root's model hash).  Idempotent: the stall
        monitor re-enters this while the bridge waits on the root.
        Called with the lock held."""
        epoch = self.ledger.epoch
        if self._partial_epoch == epoch:
            return
        t0 = time.perf_counter()
        pending = self.ledger.pending()
        updates = self.ledger.query_all_updates()
        # members' blobs through the one decode chain (dequantize, then
        # densify in sparse mode): the stored blob is the certified one
        admitted = [(updates[s].sender,
                     self._decoded(updates[s].payload_hash),
                     updates[s].n_samples, updates[s].avg_cost)
                    for s in pending.selected]
        blocks = reduce_blocks(self.cfg)
        t1 = time.perf_counter()
        partial, n_clients, mean_cost = cell_partial(
            admitted, blocks=blocks, engine=self.engine)
        engine_s = time.perf_counter() - t1
        evidence = cell_evidence_digest(
            epoch, self.cell_index,
            [(u.sender, u.payload_hash, u.n_samples, u.avg_cost)
             for u in updates],
            [float(m) for m in pending.medians], list(pending.selected))
        # the sparse bridge: re-sparsified at the density in force (the
        # root's effective knob, re-checked when the bridge uploads)
        enc_density = self._bridge_density() if self._sparse else 1.0
        blob = partial_blob(partial, self.cell_index, n_clients, evidence,
                            density=enc_density)
        self._outbox = {"epoch": epoch, "blob": blob, "n": n_clients,
                        "cost": mean_cost,
                        "hash": hashlib.sha256(blob).digest(),
                        "partial": partial, "ev": evidence,
                        "enc_density": enc_density}
        if self._rederive:
            # the member-signed evidence a root validator re-derives
            # the partial from; the member blobs stay servable a round
            rows = self._member_evidence(epoch, updates)
            self._outbox["cell_ev"] = ({
                "epoch": epoch, "updates": rows,
                "medians": [float(m) for m in pending.medians],
                "selected": [int(s) for s in pending.selected],
                "read_ep": [self.host, self.port]}
                if rows is not None else None)
            self._rederive_blobs = {
                u.payload_hash: self._blobs[u.payload_hash]
                for u in updates if u.payload_hash in self._blobs}
        self._partial_epoch = epoch
        for u in updates:
            self._blobs.pop(u.payload_hash, None)
        self._last_progress = time.monotonic()
        self._cv.notify_all()
        dt = time.perf_counter() - t0
        self.merge_log.append({"epoch": epoch, "leg": self.engine.last_leg,
                               "blocks": blocks, "admitted": n_clients,
                               "t": self._last_progress - self._t0,
                               "mono": self._last_progress,
                               "merge_s": dt, "engine_s": engine_s,
                               "blob_bytes": len(blob)})
        if self.verbose:
            print(f"[cell {self.cell_index}] epoch {epoch}: partial over "
                  f"{n_clients} clients ready ({dt * 1e3:.1f} ms)",
                  flush=True)

    def _member_evidence(self, epoch: int, updates):
        """[[sender, hash hex, n, cost, tag hex, pubkey hex], ...] in
        ledger slot order: the member-signed admission listing a root
        validator re-verifies (`rederive.core.Rederiver.check_cell`).
        None when a member's auth evidence is gone (a promoted aggregator
        holds the chain, not the process-local tags): the bridge then
        ships none and the validators skip, counted, rather than refuse
        an honest cell."""
        from bflc_demo_tpu_torch.ledger.base import decode_op
        want = {(u.sender, u.payload_hash): i
                for i, u in enumerate(updates)}
        rows = [None] * len(updates)
        found = 0
        base = self.ledger.log_base
        for pos in sorted(self._op_auth, reverse=True):
            if found == len(updates):
                break
            if pos < base:
                continue
            try:
                d = decode_op(self.ledger.log_op(pos))
            except (ValueError, IndexError, struct.error):
                continue
            if d.get("op") != "upload" or d.get("epoch") != epoch:
                continue
            try:
                key = (d["sender"], bytes.fromhex(d["payload_hash"]))
            except (KeyError, ValueError):
                continue
            i = want.get(key)
            if i is None or rows[i] is not None:
                continue
            a = self._op_auth[pos]
            if not a.get("tag") or not a.get("pubkey"):
                continue
            u = updates[i]
            rows[i] = [u.sender, u.payload_hash.hex(), int(u.n_samples),
                       float(u.avg_cost), a["tag"], a["pubkey"]]
            found += 1
        return rows if found == len(updates) else None

    # ------------------------------------------------------ root bridge
    def _bridge_density(self) -> float:
        """The partial's re-encode density: the root's mirrored
        effective knob when its loop is armed, else the genome's."""
        ed = self._root_eff_density
        return float(ed) if ed is not None \
            else float(self.cfg.delta_density)

    def _state_knobs(self) -> dict:
        """Serve the members the root's mirrored effective density (the
        cell ledger runs no loop of its own): a member's next upload
        encodes at the knob the whole hierarchy agreed on."""
        ed = self._root_eff_density
        if ed is None:
            return super()._state_knobs()
        return {"eff_density": float(ed)}

    def _outbox_blob(self, outbox: dict) -> Tuple[bytes, bytes]:
        """(blob, hash) of the outbox at the density in force now: a
        genome op that landed between the partial and its upload would
        otherwise leave the cell at the old knob, and the root's
        validators, re-encoding at the certified one, would refuse an
        honest cell."""
        dens = self._bridge_density() if self._sparse else 1.0
        if outbox.get("enc_density") != dens:
            outbox["blob"] = partial_blob(
                outbox["partial"], self.cell_index, outbox["n"],
                outbox["ev"], density=dens)
            outbox["hash"] = hashlib.sha256(outbox["blob"]).digest()
            outbox["enc_density"] = dens
        return outbox["blob"], outbox["hash"]

    def _sign(self, kind: str, epoch: int, payload: bytes) -> str:
        return self.wallet.sign(_op_bytes(
            kind, self.wallet.address, epoch, payload)).hex()

    def _root_register(self, client) -> None:
        deadline = time.monotonic() + 120.0
        while not self._stop.is_set():
            r = client.request("register", addr=self.wallet.address,
                               pubkey=self.wallet.public_bytes.hex(),
                               tag=self._sign("register", 0, b""))
            if r.get("ok") or r.get("status") in ("ALREADY_REGISTERED",
                                                  "DUPLICATE"):
                return
            if r.get("status") in ("REPLICATION_TIMEOUT", "CERT_TIMEOUT") \
                    and time.monotonic() < deadline:
                time.sleep(0.5)
                continue
            raise ConnectionError(f"root register failed: {r}")

    def _build_model(self):
        """The scoring model, its template and the validation shard as
        tensors, on the server's device (built once)."""
        if self._model is None:
            import torch

            import bflc_demo_tpu_torch.models as models
            from bflc_demo_tpu_torch.client.runtime import feature_tensor
            from bflc_demo_tpu_torch.device import resolve_device
            dev = resolve_device(self._device_arg)
            self._model = getattr(models, self._model_factory)(
                **self._factory_kw).to(dev)
            self._template = self._model.init_params(0, dev)
            xv, yv = self._val
            self._val_t = (feature_tensor(xv, dev), torch.as_tensor(
                np.asarray(yv, np.float32), device=dev))
        return self._model

    def _score_root_candidates(self, router, ups: List[dict],
                               repoch: int) -> Optional[List[float]]:
        """This cell's root-committee score row over the round's
        candidate partials, or None when the round turned under us.
        With a validation shard: apply each partial to the global model
        and measure held-out accuracy (`core.scoring.score_candidates`,
        K1 on the card).  Without one: a neutral constant row (selection
        degrades to slot order) rather than wedging the root round."""
        if self._val is None or not self._model_factory:
            return [0.5] * len(ups)
        import torch

        from bflc_demo_tpu_torch.core.scoring import score_candidates
        from bflc_demo_tpu_torch.utils.serialization import restore_pytree
        model = self._build_model()
        mr = router.fetch_model()
        if not mr.get("ok") or mr["epoch"] != repoch:
            return None
        params = restore_pytree(self._template, unpack_pytree(mr["blob"]))
        try:
            blobs = router.fetch_blobs([u["hash"] for u in ups])
        except (LookupError, ConnectionError):
            return None
        # candidate partials are sparse on the bridge when the fleet is
        # density-armed: densify (identity on dense) before the
        # #cellmeta split, the decode chain the root writer runs
        deltas = [restore_pytree(self._template, split_cellmeta(
            densify_entries(unpack_pytree(blobs[u["hash"]])))[0])
            for u in ups]
        stacked = {k: torch.stack([d[k] for d in deltas])
                   for k in deltas[0]}
        xv, yv = self._val_t
        scores = score_candidates(model, params, stacked,
                                  self.cfg.learning_rate, xv, yv)
        return [float(s) for s in np.nan_to_num(
            scores.cpu().numpy(), nan=0.0, posinf=1.0, neginf=0.0)]

    def _commit_global(self, router) -> bool:
        """Pull the root's committed model and end the local round with
        it: commit_model with the GLOBAL hash, refresh the served blob —
        members' next fetch_model sees the new epoch.  False when the
        local round is not ready or the fetch failed."""
        mr = router.fetch_model()
        if not mr.get("ok"):
            return False
        blob = mr["blob"]
        digest = hashlib.sha256(blob).digest()
        with self._lock:
            if not self.ledger.aggregate_ready() \
                    or self.ledger.epoch >= mr["epoch"]:
                return False
            epoch = self.ledger.epoch
            st = self.ledger.commit_model(digest, epoch)
            if st != LedgerStatus.OK:
                return False
            self._model_blob = blob
            self._model_hash = digest
            self._model_schema = {k: (a.shape, a.dtype) for k, a in
                                  unpack_pytree(blob).items()}
            if self._outbox is not None \
                    and self._outbox["epoch"] <= epoch:
                self._outbox = None
            self._rounds_completed += 1
            self._last_progress = time.monotonic()
            self._cv.notify_all()
        if self.verbose:
            print(f"[cell {self.cell_index}] epoch {epoch}: global model "
                  f"committed locally", flush=True)
        return True

    def _root_loop(self) -> None:
        from bflc_demo_tpu_torch.comm.dataplane import ReadRouter
        client = FailoverClient(self._root_endpoints,
                                timeout_s=ROOT_TIMEOUT_S,
                                bft_keys=self._root_bft_keys or None)
        router = ReadRouter(client, timeout_s=ROOT_TIMEOUT_S)
        submitted_epoch = -10 ** 9
        scored_epoch = -10 ** 9
        known_log = 0
        registered = False
        try:
            while not self._stop.is_set():
                try:
                    if not registered:
                        self._root_register(client)
                        registered = True
                    st = client.request("state",
                                        addr=self.wallet.address)
                    repoch = st["epoch"]
                    ed = st.get("eff_density")
                    self._root_eff_density = (float(ed) if ed is not None
                                              else None)
                    if repoch < 0:      # root still enrolling cells
                        known_log = client.request(
                            "wait", log_size=known_log,
                            timeout_s=1.0)["log_size"]
                        continue
                    acted = False
                    with self._lock:
                        outbox = self._outbox
                    if st["role"] == "trainer" and outbox is not None \
                            and outbox["epoch"] == repoch \
                            and repoch > submitted_epoch:
                        blob, digest = self._outbox_blob(outbox)
                        payload = digest + struct.pack(
                            "<qd", outbox["n"], float(outbox["cost"]))
                        r = client.request(
                            "upload", addr=self.wallet.address,
                            blob=blob, hash=digest.hex(), n=outbox["n"],
                            cost=float(outbox["cost"]), epoch=repoch,
                            tag=self._sign("upload", repoch, payload),
                            cell_ev=outbox.get("cell_ev"))
                        self._count_reply("upload", r)
                        if r.get("status") in ("OK", "DUPLICATE",
                                               "CAP_REACHED",
                                               "WRONG_EPOCH"):
                            submitted_epoch = repoch
                            acted = bool(r.get("ok"))
                        elif r.get("status") == "BAD_ARG":
                            # a failed-over root can hold a directory
                            # hole for us — re-present the registration
                            # (idempotent) and retry next loop
                            registered = False
                    elif st["role"] == "comm" and repoch > scored_epoch:
                        ups = client.request("updates")["updates"]
                        if ups:
                            row = self._score_root_candidates(
                                router, ups, repoch)
                            if row is not None:
                                payload = struct.pack(
                                    f"<{len(row)}d", *row)
                                r = client.request(
                                    "scores",
                                    addr=self.wallet.address,
                                    epoch=repoch, scores=row,
                                    tag=self._sign("scores", repoch,
                                                   payload))
                                self._count_reply("scores", r)
                                if r.get("status") in ("OK",
                                                       "WRONG_EPOCH",
                                                       "DUPLICATE"):
                                    scored_epoch = repoch
                                    acted = bool(r.get("ok"))
                                elif r.get("status") == "BAD_ARG":
                                    registered = False
                    # end the local round when the root committed past it
                    with self._lock:
                        local_epoch = self.ledger.epoch
                        ready = self.ledger.aggregate_ready()
                    if ready and repoch > local_epoch:
                        acted = self._commit_global(router) or acted
                    if not acted:
                        known_log = client.request(
                            "wait", log_size=known_log,
                            timeout_s=1.0)["log_size"]
                except (ConnectionError, WireError, OSError, KeyError):
                    # a root outage (or a reply shape from a
                    # mid-promotion server): back off and re-drive — the
                    # bridge must outlive root churn
                    if self._stop.is_set():
                        break
                    time.sleep(0.5)
        finally:
            router.close()
            client.close()
