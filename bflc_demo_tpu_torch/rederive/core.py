"""The validator's re-derivation engine (see the package docstring).

Port of `bflc_demo_tpu/rederive/core.py` (:87-719): `crosscheck_rl`,
`BlobFetcher` over the port's own `comm/dataplane.py` `ReadRouter` and
`BlobCache`, `derive_leaves`, `rederive_model_flat` and `Rederiver`
with `check` and `check_cell`.  A `comm/bft.ValidatorNode` owns the
`Rederiver`.  For every commit op (sync opcode 4, async opcode 12) it:

1. pins the claimed new-model blob: the vote's `mblob` evidence, bound
   to the op's model hash, or a content-addressed fetch of that hash;
2. takes the merge's inputs from its own replica: the admitted updates,
   the committee's selection, the weights (sync: n_samples; async:
   n / sqrt(1 + s) from the certified staleness stamps through
   `async_selection`) and the previous model (the blob it verified last
   round, the provisioned initial blob at genesis, or a fetch);
3. fetches the selected deltas' blobs through the read path, each
   checked against the payload hash of an upload op it co-signed;
4. decodes them through the one chain the writer used
   (`densify_entries` after `dequantize_entries`, `split_cellmeta` at a
   hier root) and runs REDUCTION SPEC v2's merge for its leaf shard
   (`rederive/shards.py`) or the whole model on its OWN merge engine
   (`meshagg.engine.engine_for(device)`): kernel B5 on the card, one
   launch a block, at the shard's own (N, P_subset) geometry;
5. refuses (`REDERIVE`) on any byte mismatch (a shard mismatch first
   escalates to the whole model, so the refusal names every diverging
   leaf) and on a NaN or an Inf in the aggregate, naming the rows.

Unselected slots never need their blobs: the spec adds them as masked
+0.0 terms, so one shared zeros row stands in for all of them.  An
unavailable input (no evidence, no serving replica, a fetch miss) is a
counted skip and the vote signs on the guard check; a present but wrong
input refuses.

What differs from the reference: the engine is the validator's own
(`engine_for(device)`, `cuda` unless the caller asks for the CPU), never
a process-wide singleton, and torch is imported only when a `Rederiver`
is built, so a disarmed validator stays free of it.  On the card a
failed launch raises: there is no fallback to the host leg.  The obs
metrics, flight recorder, trace spans and device-cache attribution
(reference :53-56, :68-84) are ROADMAP A14 and are dropped; the counts
they fed stay in `Rederiver.stats` (with `seconds` split into
`derive_s` and `fetch_s`).  The decode, the shard map and the row
statistics are numpy on the host, as in the reference.
"""

from __future__ import annotations

import hashlib
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.rederive.shards import leaf_shard
from bflc_demo_tpu_torch.utils.codecs import (densify_entries,
                                              dequantize_entries,
                                              sparse_enabled, unpack_pytree)

Endpoint = Tuple[str, int]

_OP_COMMIT, _OP_ACOMMIT = 4, 12
_ZERO_HASH = b"\0" * 32


def crosscheck_rl(rls: Dict[int, Dict[str, str]]) -> List[str]:
    """Leaf keys whose per-leaf digests disagree across validators' vote
    metadata.  Honest votes never disagree (each digests leaves that
    matched the one claimed blob), so a non-empty result fingerprints a
    lying or faulty validator; safety rests on the shard coverage, not on
    this check."""
    seen: Dict[str, str] = {}
    bad: List[str] = []
    for _v, rl in sorted(rls.items()):
        if not isinstance(rl, dict):
            continue
        for key, dig in rl.items():
            if key in seen:
                if seen[key] != dig and key not in bad:
                    bad.append(key)
            else:
                seen[key] = str(dig)
    return bad


class BlobFetcher:
    """Content-addressed fetches for a validator: one `ReadRouter` per
    control endpoint (the writer, or a cell's read surface at a hier
    root; at most `_MAX_ROUTERS` kept), one shared `BlobCache`, every
    byte hash-checked by the router.  One lock serializes the fetches:
    the cell checks run outside the validator's lock while a commit
    check holds it, and a router's connections are not thread-safe."""

    _MAX_ROUTERS = 8

    def __init__(self, timeout_s: float = 8.0,
                 cache_bytes: int = 64 << 20):
        import collections
        import threading

        from bflc_demo_tpu_torch.comm.dataplane import BlobCache
        self.cache = BlobCache(cache_bytes)
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._routers: "collections.OrderedDict[Endpoint, object]" = \
            collections.OrderedDict()

    @staticmethod
    def _close_router(router) -> None:
        try:
            router.close()
            router.control.close()
        except Exception:       # noqa: BLE001 — teardown best-effort
            pass

    def close(self) -> None:
        with self._lock:
            for router in self._routers.values():
                self._close_router(router)
            self._routers.clear()

    def _router_for(self, read_set: Sequence[Endpoint],
                    coordinator: Optional[Endpoint]):
        """Caller holds self._lock."""
        from bflc_demo_tpu_torch.comm.dataplane import ReadRouter
        from bflc_demo_tpu_torch.comm.ledger_service import \
            CoordinatorClient
        control = coordinator or (read_set[0] if read_set else None)
        if control is None:
            return None
        control = (str(control[0]), int(control[1]))
        router = self._routers.get(control)
        if router is None:
            router = ReadRouter(
                CoordinatorClient(control[0], control[1],
                                  timeout_s=self.timeout_s),
                cache=self.cache, timeout_s=self.timeout_s)
            self._routers[control] = router
            while len(self._routers) > self._MAX_ROUTERS:
                _, old = self._routers.popitem(last=False)
                self._close_router(old)
        else:
            self._routers.move_to_end(control)
        router.note_read_set({"read_set": [list(ep) for ep in read_set]})
        return router

    def fetch(self, hashes: Sequence[str], read_set: Sequence[Endpoint],
              coordinator: Optional[Endpoint]
              ) -> Optional[Dict[str, bytes]]:
        """{hex hash: verified bytes} for every hash, or None when any
        stayed unavailable (the caller's counted skip)."""
        if not hashes:
            return {}
        with self._lock:
            router = self._router_for(read_set, coordinator)
            if router is None:
                return None
            try:
                return router.fetch_blobs(list(hashes))
            except (LookupError, ConnectionError, OSError):
                return None


def _evidence_endpoints(auth: Optional[dict]
                        ) -> Tuple[List[Endpoint], Optional[Endpoint]]:
    """(read set, writer endpoint) from a commit vote's evidence."""
    rs: List[Endpoint] = []
    co: Optional[Endpoint] = None
    if isinstance(auth, dict):
        for ep in auth.get("rs") or ():
            try:
                rs.append((str(ep[0]), int(ep[1])))
            except (TypeError, ValueError, IndexError):
                continue
        try:
            if auth.get("co"):
                co = (str(auth["co"][0]), int(auth["co"][1]))
        except (TypeError, ValueError, IndexError):
            co = None
    return rs, co


def derive_leaves(global_flat: Dict[str, np.ndarray],
                  flats_by_slot: List[Optional[Dict[str, np.ndarray]]],
                  weights: Sequence[float], selected: Sequence[int],
                  lr: float, keys: Sequence[str], blocks: int = 1,
                  engine=None) -> Dict[str, np.ndarray]:
    """The writer's merge (REDUCTION SPEC v1/v2) restricted to `keys`, on
    `engine` (None: the CPU engine) — byte for byte the writer's per
    leaf, because the reduction is leaf-independent.  Each selected
    slot's leaves are flattened once into a row; every slot whose flat
    is None (unselected: its blob was never fetched) shares one zeros
    row, which the spec adds as masked +0.0 terms.  `blocks` is the
    genome's reduce_blocks, clamped to the subset's own size (a shard
    can flatten smaller than the block count; any clamp is
    byte-invariant)."""
    from bflc_demo_tpu_torch.meshagg.engine import (engine_for,
                                                    flatten_delta)
    if engine is None:
        engine = engine_for("cpu")
    keys = sorted(keys)
    sub = {k: global_flat[k] for k in keys}
    psub = sum(int(np.asarray(global_flat[k]).size) for k in keys)
    zeros = np.zeros(psub, np.float32)
    rows = [flatten_delta(f, keys) if f is not None else zeros
            for f in flats_by_slot]
    eff_blocks = min(max(int(blocks), 1), max(psub, 1))
    return engine.aggregate_rows(sub, rows, list(weights), list(selected),
                                 lr, blocks=eff_blocks)


def rederive_model_flat(prev_blob: bytes, delta_blobs: List[bytes],
                        weights: Sequence[float],
                        selected: Sequence[int], lr: float, *,
                        sparse: bool = False,
                        keys: Optional[Sequence[str]] = None,
                        blocks: int = 1, engine=None
                        ) -> Dict[str, np.ndarray]:
    """The validator's merge over raw blobs (the differential checker
    and the drills use it): decodes each selected blob through the one
    chain, zeros the rest, and derives `keys` (default: all)."""
    global_flat = unpack_pytree(prev_blob)
    all_keys = sorted(global_flat.keys())
    sel = set(int(s) for s in selected)
    flats: List[Optional[Dict[str, np.ndarray]]] = []
    for i, blob in enumerate(delta_blobs):
        if i not in sel or blob is None:
            flats.append(None)
            continue
        flat = dequantize_entries(unpack_pytree(blob))
        if sparse:
            flat = densify_entries(flat)
        flats.append(flat)
    return derive_leaves(global_flat, flats, weights, list(selected), lr,
                         list(keys) if keys is not None else all_keys,
                         blocks=blocks, engine=engine)


class Rederiver:
    """One validator's re-derivation state and verdicts.

    `check` runs with the validator's lock held (it reads the replica's
    pending selection or async buffer, the certified prefix below the
    op); `check_cell` runs outside it.  `device` is where the merge runs
    (None: `cuda`); building a Rederiver imports torch."""

    def __init__(self, mode: str, index: int, n_validators: int, cfg, *,
                 initial_model_blob: Optional[bytes] = None,
                 cell_registry: Optional[dict] = None,
                 timeout_s: float = 8.0, device=None):
        from bflc_demo_tpu_torch.meshagg.engine import engine_for
        self.mode = mode
        self.index = int(index)
        self.n = max(int(n_validators), 1)
        self.cfg = cfg
        self.engine = engine_for(device)
        self._sparse = sparse_enabled(cfg)
        self._cell = cell_registry is not None
        self._initial_blob = initial_model_blob
        # (hash, blob) of the model this validator last verified: the
        # next round's previous model with no fetch
        self._verified: Optional[Tuple[bytes, bytes]] = None
        self.fetcher = BlobFetcher(timeout_s=timeout_s)
        self.stats = {"ok": 0, "refused": 0, "skipped": 0,
                      "escalated": 0, "cell_ok": 0, "cell_refused": 0,
                      "cell_skipped": 0, "seconds": 0.0, "fetch_s": 0.0,
                      "derive_s": 0.0, "leaves": 0, "skips": {},
                      "refusals": {}}

    def close(self) -> None:
        self.fetcher.close()

    # ------------------------------------------------------------ verdicts
    def _skip(self, reason: str) -> Tuple[str, None]:
        """The guard check alone: counted, never a wedge."""
        self.stats["skipped"] += 1
        self.stats["skips"][reason] = self.stats["skips"].get(reason, 0) + 1
        return "", None

    def _refuse(self, reason: str, detail: str) -> Tuple[str, None]:
        self.stats["refused"] += 1
        self.stats["refusals"][reason] = \
            self.stats["refusals"].get(reason, 0) + 1
        return f"rederive/{reason}: {detail}", None

    def _fetch(self, hashes, rs, co):
        t0 = time.perf_counter()
        try:
            return self.fetcher.fetch(hashes, rs, co)
        finally:
            self.stats["fetch_s"] += time.perf_counter() - t0

    def _derive(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return derive_leaves(*args, engine=self.engine, **kw)
        finally:
            self.stats["derive_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------- commits
    def check(self, ledger, op: bytes, auth: Optional[dict]
              ) -> Tuple[str, Optional[dict]]:
        """('', rl or None) to sign — rl carries the per-leaf digests of
        a re-derivation (None on a counted skip); a reason string
        refuses the vote (status REDERIVE)."""
        t0 = time.perf_counter()
        try:
            return self._check_inner(ledger, op, auth)
        finally:
            self.stats["seconds"] += time.perf_counter() - t0

    def _check_inner(self, ledger, op: bytes, auth: Optional[dict]
                     ) -> Tuple[str, Optional[dict]]:
        body = op[1:]
        try:
            claimed_hash = bytes(body[:32])
            epoch, = struct.unpack_from("<q", body, 32)
        except struct.error:
            return "", None             # malformed: validate_op refuses
        # a state the guards refuse anyway (wrong epoch, nothing
        # pending) is not re-derivable and not a skip
        if epoch != ledger.epoch:
            return "", None
        if op[0] == _OP_COMMIT:
            pending = ledger.pending()
            if pending is None:
                return "", None
            updates = ledger.query_all_updates()
            if not updates:
                return "", None
            hashes = [u.payload_hash for u in updates]
            weights = [u.n_samples for u in updates]
            selected = list(pending.selected)
            senders = [u.sender for u in updates]
        else:                           # _OP_ACOMMIT
            try:
                k, = struct.unpack_from("<q", body, 40)
            except struct.error:
                return "", None
            if not 0 < k <= ledger.async_buffer_depth:
                return "", None
            # FedBuff weights from the certified staleness stamps
            entries, selected, weights, _loss = ledger.async_selection(k)
            hashes = [e.payload_hash for e in entries]
            selected = list(selected)
            senders = [e.sender for e in entries]

        rs, co = _evidence_endpoints(auth)
        # 1. the claimed new model, bound to the op
        claimed_blob = None
        if isinstance(auth, dict) and auth.get("mblob"):
            try:
                claimed_blob = bytes.fromhex(auth["mblob"])
            except (TypeError, ValueError):
                return self._refuse("evidence",
                                    "unparseable mblob evidence")
            if hashlib.sha256(claimed_blob).digest() != claimed_hash:
                return self._refuse(
                    "evidence", "mblob evidence does not hash to the "
                                "op's model hash")
        if claimed_blob is None:
            got = self._fetch([claimed_hash.hex()], rs, co)
            if not got:
                return self._skip("claimed_model_unavailable")
            claimed_blob = got[claimed_hash.hex()]
        # 2. the previous model this commit advances
        prev_hash = bytes(ledger.query_global_model()[0])
        prev_blob = self._previous_blob(prev_hash, rs, co)
        if prev_blob is None:
            return self._skip("previous_model_unavailable")
        try:
            global_flat = unpack_pytree(prev_blob)
            claimed_flat = unpack_pytree(claimed_blob)
        except (ValueError, struct.error) as e:
            return self._refuse("decode", f"model blob refused: {e}")
        keys = sorted(global_flat.keys())
        err = _schema_mismatch(keys, global_flat, claimed_flat)
        if err:
            return self._refuse("schema", err)
        # 3. the selected deltas (hashes this validator co-signed)
        need = sorted({hashes[s].hex() for s in selected})
        blobs = self._fetch(need, rs, co)
        if blobs is None:
            return self._skip("delta_blobs_unavailable")
        flats: List[Optional[Dict[str, np.ndarray]]] = []
        sel = set(selected)
        for i, h in enumerate(hashes):
            if i not in sel:
                flats.append(None)
                continue
            try:
                flat = dequantize_entries(unpack_pytree(blobs[h.hex()]))
                if self._sparse:
                    flat = densify_entries(flat)
                if self._cell:
                    from bflc_demo_tpu_torch.hier.partial import \
                        split_cellmeta
                    flat = split_cellmeta(flat)[0]
            except (ValueError, TypeError, struct.error) as e:
                # bytes that match a certified hash but refuse the one
                # decode chain: the writer admitted garbage
                return self._refuse(
                    "decode", f"admitted delta {h.hex()[:12]} refused "
                              f"by the decode chain: {e}")
            flats.append(flat)
        # 4. derive and compare (the shard first, escalate on a mismatch)
        my_keys = (keys if self.mode == "full" or self.n <= 1
                   else leaf_shard(keys, self.index, self.n, epoch))
        lr = self.cfg.learning_rate
        from bflc_demo_tpu_torch.ledger.base import reduce_blocks
        blocks = reduce_blocks(self.cfg)
        derived = self._derive(global_flat, flats, weights, selected, lr,
                               my_keys, blocks=blocks)
        self.stats["leaves"] += len(my_keys)
        bad = _diverging_leaves(derived, claimed_flat)
        if bad and self.mode != "full" and len(my_keys) < len(keys):
            # a disagreeing leaf escalates this validator to the whole
            # model before it votes: the refusal names every bad leaf
            self.stats["escalated"] += 1
            mine = set(my_keys)
            rest = [k for k in keys if k not in mine]
            derived.update(self._derive(global_flat, flats, weights,
                                        selected, lr, rest, blocks=blocks))
            bad = _diverging_leaves(derived, claimed_flat)
        if bad:
            return self._refuse(
                "mismatch",
                f"committed model hash is not the spec merge of the "
                f"admitted set (diverging leaves: {bad[:4]}"
                f"{'...' if len(bad) > 4 else ''})")
        # 5. a byte-exact NaN/Inf aggregate still refuses, naming the
        # rows (the validator's own per-row statistics)
        nonfinite = [k for k, a in derived.items()
                     if np.issubdtype(np.asarray(a).dtype, np.floating)
                     and not np.all(np.isfinite(a))]
        if nonfinite:
            culprits, l2s = _row_stats(flats, senders, my_keys)
            return self._refuse(
                "nonfinite",
                f"aggregate contains NaN/Inf in leaves "
                f"{nonfinite[:4]} (nonfinite rows from: "
                f"{culprits[:4] or ['<aggregate-only>']}; "
                f"row L2s: {l2s[:4]})")
        # verified: next round's previous model
        self._verified = (claimed_hash, claimed_blob)
        self.fetcher.cache.put(claimed_hash.hex(), claimed_blob)
        self.stats["ok"] += 1
        rl = {k: hashlib.sha256(
                  np.ascontiguousarray(derived[k]).tobytes()
              ).hexdigest()[:16] for k in my_keys}
        return "", {"mode": self.mode, "leaves": rl}

    def _previous_blob(self, prev_hash: bytes, rs, co) -> Optional[bytes]:
        if self._verified is not None and self._verified[0] == prev_hash:
            return self._verified[1]
        if prev_hash == _ZERO_HASH:
            # genesis: the provisioned initial blob (configuration, like
            # the validator keys)
            return self._initial_blob
        cached = self.fetcher.cache.get(prev_hash.hex())
        if cached is not None:
            return cached
        got = self._fetch([prev_hash.hex()], rs, co)
        return got[prev_hash.hex()] if got else None

    # ---------------------------------------------------- hier cell tier
    def check_cell(self, op: bytes, auth: Optional[dict],
                   density: Optional[float] = None) -> str:
        """'' to proceed; a reason refuses a root-tier cell upload whose
        partial is not the deterministic FedAvg of its member-signed
        deltas.  A pure function of (op, auth) and the cell's read
        surface, run outside the validator's lock; missing evidence or
        member blobs are a counted skip.  `density` is the effective
        delta density at this chain position when the closed loop is
        armed (None: the genome's)."""
        t0 = time.perf_counter()
        try:
            err = self._check_cell_inner(op, auth, density)
            if err:
                self.stats["cell_refused"] += 1
            return err
        finally:
            self.stats["seconds"] += time.perf_counter() - t0

    def _cell_skip(self, reason: str) -> str:
        self.stats["cell_skipped"] += 1
        self.stats["skips"][reason] = self.stats["skips"].get(reason, 0) + 1
        return ""

    def _check_cell_inner(self, op: bytes, auth: Optional[dict],
                          density: Optional[float] = None) -> str:
        from bflc_demo_tpu_torch.comm.identity import (_op_bytes,
                                                       address_of,
                                                       verify_signature)
        from bflc_demo_tpu_torch.hier.partial import (cell_evidence_digest,
                                                      cell_partial,
                                                      partial_blob,
                                                      split_cellmeta)
        body = op[1:]
        try:
            slen, = struct.unpack_from("<q", body, 0)
            payload_hash = body[8 + slen:8 + slen + 32]
            op_n, = struct.unpack_from("<q", body, 8 + slen + 32)
        except struct.error:
            return ""                   # malformed: earlier checks speak
        ev = auth.get("cell") if isinstance(auth, dict) else None
        if not isinstance(ev, dict):
            return self._cell_skip("cell_evidence_missing")
        try:
            blob = bytes.fromhex(auth.get("blob", ""))
        except (TypeError, ValueError):
            blob = b""
        if not blob:
            return self._cell_skip("cell_blob_missing")
        if hashlib.sha256(blob).digest() != payload_hash:
            return ("rederive/cell: partial blob evidence does not "
                    "match the op's payload hash")
        try:
            flat = unpack_pytree(blob)
            if self._sparse:
                flat = densify_entries(flat)
            _partial_claimed, meta = split_cellmeta(flat)
        except (ValueError, struct.error) as e:
            return f"rederive/cell: partial blob refused: {e}"
        if meta is None:
            return "rederive/cell: partial without #cellmeta"
        cell_index, n_clients, digest = meta
        try:
            cepoch = int(ev["epoch"])
            listing = [(str(s), bytes.fromhex(h), int(n), float(c),
                        bytes.fromhex(t), bytes.fromhex(p))
                       for s, h, n, c, t, p in ev["updates"]]
            medians = [float(m) for m in ev["medians"]]
            selected = [int(s) for s in ev["selected"]]
            read_ep = (str(ev["read_ep"][0]), int(ev["read_ep"][1]))
        except (KeyError, TypeError, ValueError, IndexError) as e:
            return f"rederive/cell: malformed evidence ({e})"
        # the listing is bound to the certified bytes through the
        # #cellmeta digest the aggregator signed
        want = cell_evidence_digest(
            cepoch, cell_index,
            [(s, h, n, c) for s, h, n, c, _t, _p in listing],
            medians, selected)
        if want != digest:
            return ("rederive/cell: evidence listing does not match "
                    "the certified #cellmeta digest")
        if not selected or len(selected) != n_clients \
                or n_clients != op_n:
            return (f"rederive/cell: selected count {len(selected)} / "
                    f"#cellmeta {n_clients} / op weight {op_n} disagree")
        # each admitted record carries the member's own upload tag over
        # exactly (hash, n, cost) at the cell epoch
        for s, h, n, c, tag, pub in listing:
            if address_of(pub) != s:
                return (f"rederive/cell: member {s[:12]} "
                        f"address/pubkey mismatch")
            payload = h + struct.pack("<qd", n, c)
            if not verify_signature(pub, _op_bytes("upload", s, cepoch,
                                                   payload), tag):
                return f"rederive/cell: member {s[:12]} tag unverifiable"
        if any(not 0 <= s < len(listing) for s in selected):
            return "rederive/cell: selection indexes outside the listing"
        need = sorted({listing[s][1].hex() for s in selected})
        blobs = self._fetch(need, [read_ep], None)
        if blobs is None:
            return self._cell_skip("member_blobs_unavailable")
        admitted = []
        for s in selected:
            sender, h, n, c, _t, _p = listing[s]
            try:
                mflat = dequantize_entries(unpack_pytree(blobs[h.hex()]))
                if self._sparse:
                    mflat = densify_entries(mflat)
            except (ValueError, TypeError, struct.error) as e:
                return (f"rederive/cell: member delta {h.hex()[:12]} "
                        f"refused by the decode chain: {e}")
            admitted.append((sender, mflat, n, c))
        try:
            from bflc_demo_tpu_torch.ledger.base import reduce_blocks
            t0 = time.perf_counter()
            partial, n2, _cost = cell_partial(
                admitted, blocks=reduce_blocks(self.cfg),
                engine=self.engine)
            self.stats["derive_s"] += time.perf_counter() - t0
            eff = (float(density) if density is not None
                   else self.cfg.delta_density)
            rederived = partial_blob(
                partial, cell_index, n2, digest,
                density=(eff if self._sparse else 1.0))
        except ValueError as e:
            return f"rederive/cell: partial re-derivation refused: {e}"
        if hashlib.sha256(rederived).digest() != payload_hash:
            return ("rederive/cell: partial is not the deterministic "
                    "FedAvg of its member-signed deltas")
        bad = [k for k, a in partial.items()
               if np.issubdtype(np.asarray(a).dtype, np.floating)
               and not np.all(np.isfinite(a))]
        if bad:
            return (f"rederive/cell: re-derived partial is nonfinite "
                    f"in leaves {bad[:4]}")
        self.stats["cell_ok"] += 1
        return ""


def _schema_mismatch(keys: List[str], global_flat, claimed_flat) -> str:
    if sorted(claimed_flat.keys()) != keys:
        return (f"claimed model keys diverge from the previous "
                f"model's (extra="
                f"{sorted(set(claimed_flat) - set(keys))[:3]}, "
                f"missing={sorted(set(keys) - set(claimed_flat))[:3]})")
    for k in keys:
        g, c = np.asarray(global_flat[k]), np.asarray(claimed_flat[k])
        if g.shape != c.shape or g.dtype != c.dtype:
            return (f"claimed leaf {k}: {c.shape}/{c.dtype} != "
                    f"{g.shape}/{g.dtype}")
    return ""


def _diverging_leaves(derived: Dict[str, np.ndarray],
                      claimed_flat: Dict[str, np.ndarray]) -> List[str]:
    return [k for k, a in derived.items()
            if np.ascontiguousarray(a).tobytes()
            != np.ascontiguousarray(claimed_flat[k]).tobytes()]


def _row_stats(flats, senders, keys) -> Tuple[List[str], List[str]]:
    """(nonfinite senders, 'sender=l2' strings) over the fetched rows
    restricted to `keys`: the validator's own per-delta statistics."""
    culprits: List[str] = []
    l2s: List[str] = []
    for f, s in zip(flats, senders):
        if f is None:
            continue
        sq, bad = 0.0, False
        for k in keys:
            v = f.get(k)
            if v is None:
                continue
            a = np.asarray(v)
            if not np.issubdtype(a.dtype, np.floating):
                continue
            finite = np.isfinite(a)
            if not np.all(finite):
                bad = True
            sq += float(np.sum(np.square(
                np.asarray(a, np.float64)[finite])))
        if bad:
            culprits.append(s)
        l2s.append(f"{s[:10]}={sq ** 0.5:.3g}")
    return culprits, l2s
