"""The mesh executor: the socket control plane owning the card's data plane.

Port of `bflc_demo_tpu/comm/executor_service.py` (`MeshExecutorServer`,
:64-364).  The deployment it serves (`client/process_runtime.
run_federated_mesh_processes`): thin client processes register, stage
their shard once with a signed `stage` request (the tensors cross the
socket a single time), then watch rounds over the socket; this server
owns the device and runs every round as ONE call of
`parallel.fedavg.make_sharded_protocol_round` — every staged client's
local SGD, the committee's C x K scoring, the decision, the FedAvg and
the payload ids (kernels K1-K3 and B6 on the card) — while the ledger
stays the authority: `client.staging.audit_round` replays each round
(uploads, score rows, commit) into it and any divergence raises.  The
committed model is published as the server's model blob, so every read
(`blob`, `blobs`, `model`) is the ledger service's one data plane.

Trust model (the reference's): the executor sees the staged training
data, the cross-silo "sponsor-owned accelerator" deployment; the signed
op log pins registration and staging identity and every round's
decisions.  With `attest_scores` every committee member must re-score
the round's K candidate deltas on its own shard and sign its row (the
`scores` op payload) before the round reaches the ledger: a fabricated
row gets no signature and the round aborts (`_collect_attestations`).

Extra wire methods beside the ledger service's:
    stage {addr, x, y, tag}  — one-time shard staging; x and y are blobs
        of flat entries {"x": ...} / {"y": int labels}, signed with kind
        "stage" over sha256(x) + sha256(y); BAD_ARG for a bad signature
        or an undecodable, empty or mismatched shard;
    progress                 — rounds done, rounds asked, the runner's
        error (None while it is healthy);
    round_pending {addr}     — the pending round awaiting this member's
        attestation (epoch, s_pad, the candidates' hashes, its device
        row), or epoch None;
    attest {addr, epoch, scores, tag} — WRONG_EPOCH, NOT_COMMITTEE,
        ROW_MISMATCH (beyond 1e-6 of the device row), then the signature.

The runner starts once every client has registered and staged.  Slot
order is the registered addresses ascending as integers; each round's
uploaders are `np.random.default_rng(seed)`'s permutation of the round's
trainers, first K, ascending.  `kernels` adds the executor's record:
each round's seconds on its clock (`round_s`, the device round
`device_s`, the attestation wait `attest_s`), the evidence bytes, and
when the runner started.

Port differences: the server computes on its `device` (`cuda` unless the
caller asks for the CPU); `mesh` is accepted and has no effect, since
the port folds the client axis onto one card, as its mesh runtime does;
a closed server ends a pending attestation wait at once.  Dropped: the
reference's `obs` gauges of mesh rounds (ROADMAP A14).
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bflc_demo_tpu_torch.comm.identity import _op_bytes
from bflc_demo_tpu_torch.comm.ledger_service import LedgerServer
from bflc_demo_tpu_torch.comm.wire import blob_bytes
from bflc_demo_tpu_torch.device import resolve_device
from bflc_demo_tpu_torch.ops.fingerprint import fingerprint_to_bytes
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import (pack_pytree,
                                                     unpack_pytree)

# an attested row must equal the device row within this (the wire's f64)
ROW_TOLERANCE = 1e-6


def _host(params) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


class MeshExecutorServer(LedgerServer):
    """LedgerServer + staged shards + a round-runner thread."""

    def __init__(self, cfg: ProtocolConfig, model_factory: str,
                 factory_kw: Optional[dict] = None, *,
                 rounds: int = 5, mesh=None, seed: int = 0,
                 init_seed: int = 0, client_chunk: int = 0,
                 remat: bool = False, attest_scores: bool = False,
                 attest_timeout_s: float = 60.0, **server_kw):
        import bflc_demo_tpu_torch.models as models

        self._device = resolve_device(server_kw.get("device"))
        self.model = getattr(models, model_factory)(
            **(factory_kw or {})).to(self._device)
        initial_params = self.model.init_params(init_seed, self._device)
        super().__init__(cfg, pack_pytree(_host(initial_params)),
                         **server_kw)
        self.rounds = rounds
        self.seed = seed
        self._client_chunk = client_chunk
        self._remat = remat
        self._params = initial_params
        self._staged_x: Dict[str, np.ndarray] = {}
        self._staged_y: Dict[str, np.ndarray] = {}
        self._runner: Optional[threading.Thread] = None
        self._runner_mono: Optional[float] = None
        self.rounds_done = 0
        self.runner_error: Optional[str] = None
        self.attest_scores = attest_scores
        self.attest_timeout_s = attest_timeout_s
        self._pending_attest: Optional[dict] = None
        self._attested: Dict[str, str] = {}      # addr -> sig hex (epoch's)
        self.attest_log: Dict[int, Dict[str, str]] = {}
        # one record a round: epoch, its seconds on this server's clock
        # (whole round, the device round, the attestation wait), the
        # evidence bytes published, seconds since start at its commit
        self.round_log: List[dict] = []
        self._evidence_bytes = 0

    # ------------------------------------------------------------- methods
    def _m_stage(self, m: dict) -> dict:
        addr = m["addr"]
        try:
            xb = blob_bytes(m["x"])
            yb = blob_bytes(m["y"])
        except (KeyError, ValueError) as e:
            return {"ok": False, "status": "BAD_ARG",
                    "error": f"undecodable shard: {e}"}
        payload = hashlib.sha256(xb).digest() + hashlib.sha256(yb).digest()
        if self.require_auth and not self.directory.verify(
                addr, _op_bytes("stage", addr, 0, payload),
                bytes.fromhex(m.get("tag", ""))):
            return {"ok": False, "status": "BAD_ARG",
                    "error": "bad signature"}
        try:
            x = unpack_pytree(xb)["x"]
            y = unpack_pytree(yb)["y"]
        except (KeyError, ValueError, TypeError) as e:
            return {"ok": False, "status": "BAD_ARG",
                    "error": f"undecodable shard: {e}"}
        if len(x) == 0 or len(x) != len(y):
            return {"ok": False, "status": "BAD_ARG",
                    "error": "empty or mismatched shard"}
        self._staged_x[addr] = np.array(x)
        self._staged_y[addr] = np.array(y)
        self._touch(addr)
        self._maybe_start_runner()
        return {"ok": True, "staged": len(self._staged_x)}

    def _m_progress(self, m: dict) -> dict:
        return {"ok": True, "rounds_done": self.rounds_done,
                "rounds": self.rounds, "error": self.runner_error}

    def _m_round_pending(self, m: dict) -> dict:
        p = self._pending_attest
        addr = m.get("addr", "")
        if p is None or addr not in p["rows"] or addr in self._attested:
            return {"ok": True, "epoch": None}
        return {"ok": True, "epoch": p["epoch"], "s_pad": p["s_pad"],
                "hashes": p["hashes"], "row": p["rows"][addr]}

    def _m_attest(self, m: dict) -> dict:
        p = self._pending_attest
        addr = m.get("addr", "")
        if p is None or int(m.get("epoch", -1)) != p["epoch"]:
            return {"ok": False, "status": "WRONG_EPOCH"}
        if addr not in p["rows"]:
            return {"ok": False, "status": "NOT_COMMITTEE"}
        scores = [float(s) for s in m["scores"]]
        row = p["rows"][addr]
        if len(scores) != len(row) or any(
                abs(a - b) > ROW_TOLERANCE for a, b in zip(scores, row)):
            # the member signed another row than the device computed
            return {"ok": False, "status": "ROW_MISMATCH"}
        payload = struct.pack(f"<{len(scores)}d", *scores)
        if self.require_auth and not self.directory.verify(
                addr, _op_bytes("scores", addr, p["epoch"], payload),
                bytes.fromhex(m.get("tag", ""))):
            return {"ok": False, "status": "BAD_ARG",
                    "error": "bad signature"}
        self._attested[addr] = m.get("tag", "")
        self._cv.notify_all()
        return {"ok": True, "missing": len(p["rows"]) - len(self._attested)}

    def _m_kernels(self, m: dict) -> dict:
        reply = super()._m_kernels(m)
        reply["executor"] = {"rounds": list(self.round_log),
                             "rounds_done": self.rounds_done,
                             "runner_mono": self._runner_mono,
                             "attested": {e: len(s) for e, s in
                                          self.attest_log.items()}}
        return reply

    # -------------------------------------------------------- round runner
    def _maybe_start_runner(self) -> None:
        if self._runner is not None:
            return
        # FL starts when every client registered (the epoch left the
        # genesis sentinel) and staged; a register/stage identity mismatch
        # surfaces as a runner error through `progress`
        if self.ledger.epoch < 0 or len(self._staged_x) < self.cfg.client_num:
            return
        self._runner_mono = time.monotonic()
        self._runner = threading.Thread(target=self._run_rounds,
                                        daemon=True)
        self._runner.start()

    def _run_rounds(self) -> None:
        try:
            self._run_rounds_inner()
        except Exception as e:      # noqa: BLE001 — surfaced via `progress`
            self.runner_error = f"{type(e).__name__}: {e}"
            self._say(f"runner failed: {self.runner_error}")

    def _collect_attestations(self, epoch, addrs, uploader_ids,
                              committee_ids, delta_fps, score_rows,
                              cand_deltas, s_pad) -> None:
        """Publish the round's scoring evidence and block until every
        committee member re-scored and signed its row (or raise).

        The K candidate deltas become blobs keyed by their device
        fingerprints (the ids the ledger will record), beside each
        member's device row.  Waiting releases the server lock (the
        condition's wait), so `round_pending` and `attest` are served
        meanwhile; the evidence blobs are pruned after the round."""
        cands = _host(cand_deltas)
        hashes, fp_keys = [], []
        with self._lock:
            self._evidence_bytes = 0
            for j, uid in enumerate(uploader_ids):
                fp = fingerprint_to_bytes(delta_fps[uid])
                blob = pack_pytree({k: v[j] for k, v in cands.items()})
                self._blobs[fp] = blob
                self._evidence_bytes += len(blob)
                fp_keys.append(fp)
                hashes.append(fp.hex())
            self._pending_attest = {
                "epoch": epoch, "s_pad": int(s_pad), "hashes": hashes,
                "rows": {addrs[c]: [float(score_rows[c, u])
                                    for u in uploader_ids]
                         for c in committee_ids}}
            self._attested = {}
            try:
                deadline = time.monotonic() + self.attest_timeout_s
                while len(self._attested) < len(committee_ids):
                    rem = deadline - time.monotonic()
                    if rem <= 0 or self._stop.is_set():
                        missing = [a for a in self._pending_attest["rows"]
                                   if a not in self._attested]
                        raise RuntimeError(
                            f"epoch {epoch}: committee members {missing} "
                            f"did not attest their score rows — refusing "
                            f"to commit the round")
                    self._cv.wait(rem)
                self.attest_log[epoch] = dict(self._attested)
            finally:
                self._pending_attest = None
                # every member re-scored and signed (or the round
                # aborted): without this prune a long run grows by K
                # model-sized blobs a round
                for fp in fp_keys:
                    self._blobs.pop(fp, None)

    def _run_rounds_inner(self) -> None:
        from bflc_demo_tpu_torch.client.runtime import feature_tensor
        from bflc_demo_tpu_torch.client.staging import (audit_round,
                                                        stage_padded_arrays)
        from bflc_demo_tpu_torch.parallel.fedavg import \
            make_sharded_protocol_round

        cfg = self.cfg
        n = cfg.client_num
        dev = self._device
        with self._lock:
            # the registered addresses ascending fix the slot order
            addrs = sorted(self._staged_x, key=lambda a: int(a, 16))
            xs_list = [self._staged_x[a] for a in addrs]
            ys_list = [self._staged_y[a] for a in addrs]
        # the in-process mesh runtime's staging: cyclic padding, integer
        # features kept, empty shards refused
        xs_np, ys_np, sizes = stage_padded_arrays(
            xs_list, ys_list, self.model.num_classes)
        xs = feature_tensor(xs_np, dev)
        ys = torch.as_tensor(ys_np, device=dev)
        ns = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        round_fn = make_sharded_protocol_round(
            self.model, client_num=n, lr=cfg.learning_rate,
            batch_size=cfg.batch_size, local_epochs=cfg.local_epochs,
            aggregate_count=cfg.aggregate_count,
            client_chunk=self._client_chunk, remat=self._remat,
            comm_count=cfg.comm_count,
            needed_update_count=cfg.needed_update_count,
            expose_candidates=self.attest_scores)

        params = self._params
        rng = np.random.default_rng(self.seed)
        k = cfg.needed_update_count
        for _ in range(self.rounds):
            t_round = time.monotonic()
            with self._lock:
                epoch = self.ledger.epoch
                committee_ids = sorted(
                    addrs.index(a) for a in self.ledger.committee())
            trainer_ids = [i for i in range(n) if i not in committee_ids]
            pick = rng.permutation(len(trainer_ids))[:k]
            uploader_ids = sorted(trainer_ids[int(j)] for j in pick)
            up_mask = np.zeros(n, bool)
            up_mask[uploader_ids] = True
            cm_mask = np.zeros(n, bool)
            cm_mask[committee_ids] = True
            res = round_fn(params, xs, ys, ns, up_mask, cm_mask)
            params = res.params
            delta_fps = res.delta_fps.cpu().numpy()
            score_rows = res.score_matrix.cpu().numpy()
            avg_costs = res.avg_costs.cpu().numpy()
            sel_device = np.flatnonzero(res.selected.cpu().numpy())
            params_fp = res.params_fp.cpu().numpy()
            device_s = time.monotonic() - t_round

            t_attest = time.monotonic()
            self._evidence_bytes = 0
            if self.attest_scores:
                self._collect_attestations(epoch, addrs, uploader_ids,
                                           committee_ids, delta_fps,
                                           score_rows, res.cand_deltas,
                                           xs_np.shape[1])
            attest_s = time.monotonic() - t_attest

            with self._lock:
                # full participation: client ids are the device slots
                audit_round(self.ledger, lambda cid: addrs[cid], epoch,
                            uploader_ids, committee_ids, uploader_ids,
                            committee_ids, delta_fps,
                            lambda cid: sizes[cid], avg_costs, score_rows,
                            sel_device, params_fp)
                # publish the committed model for the socket clients
                blob = pack_pytree(_host(params))
                self._model_blob = blob
                self._model_hash = hashlib.sha256(blob).digest()
                self._params = params
                self.rounds_done += 1
                self._rounds_completed += 1
                self._last_progress = time.monotonic()
                self.round_log.append({
                    "epoch": epoch, "round_s": time.monotonic() - t_round,
                    "device_s": device_s, "attest_s": attest_s,
                    "evidence_bytes": self._evidence_bytes,
                    "t": time.monotonic() - self._t0})
                self._cv.notify_all()
                self._say(f"epoch {epoch} mesh round done "
                          f"(loss={self.ledger.last_global_loss:.5f})")
