"""Deterministic cell-partial aggregation + the #cellmeta evidence entry.

Copy of `bflc_demo_tpu/hier/partial.py`: `pack_cellmeta`,
`unpack_cellmeta`, `split_cellmeta`, `cell_evidence_digest`,
`cell_partial`, `partial_blob` and `check_cell_upload_op`, byte for byte
the reference's.  Numpy only, like `utils/codecs.py`: the root writer and
the BFT validators (which import no torch) load it.  `cell_partial` sums
through the port's certified merge engine, imported when it is called:
`engine` (default the `meshagg.engine.ENGINE` singleton, as in the
reference) — on a CUDA engine the mesh leg is kernel B5.

The cell-aggregate op the root certifies is a STANDARD `upload` op whose
payload hash is taken over the canonical bytes produced here.  Two rules
make that hash meaningful:

- **order independence**: the partial is the sample-weighted FedAvg mean
  of the cell-selected member deltas, accumulated in SORTED SENDER
  ADDRESS order with float32 arithmetic — so the same admitted set
  produces byte-identical partial-sum canonical bytes (and therefore the
  same content hash) regardless of upload arrival order, committee
  timing, or dict insertion order;
- **evidence rides inside the hash**: the reserved ``#cellmeta`` entry
  (same '#'-prefix convention as the quantization scales — an honest
  model leaf can never collide with it) carries the cell index, the
  admitted client count and the cell-local admission/score evidence
  digest.  Because it is one more canonical entry, the certified payload
  hash — the thing the aggregator SIGNS and the validator quorum co-signs
  — covers the evidence with zero changes to the certification machinery.

This module imports nothing from `comm` (the ledger server and the BFT
validators import it), only the canonical codec.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.utils.codecs import pack_entries, sparsify_entries

# reserved canonical-entry key: '#' cannot appear in a model pytree's
# keystr paths (utils.serialization.QSCALE_SUFFIX uses the same property)
CELLMETA_KEY = "#cellmeta"

_CELLMETA_MAGIC = b"BFLCCELL1"
_CELLMETA_LEN = len(_CELLMETA_MAGIC) + 16 + 32      # magic + 2*q + digest

_EVIDENCE_MAGIC = b"BFLCCELLEV1"

# ledger op codec constants (ledger/base — the upload op layout
# check_cell_upload_op decodes)
_OP_UPLOAD = 2


def pack_cellmeta(cell_index: int, n_clients: int,
                  evidence: bytes) -> np.ndarray:
    """The #cellmeta entry's value: a uint8 vector so it rides the
    canonical entry codec like any tensor leaf."""
    if len(evidence) != 32:
        raise ValueError(f"evidence digest must be 32 bytes, got "
                         f"{len(evidence)}")
    if n_clients < 1 or cell_index < 0:
        raise ValueError(f"bad cellmeta ({cell_index}, {n_clients})")
    raw = (_CELLMETA_MAGIC + struct.pack("<qq", cell_index, n_clients)
           + evidence)
    return np.frombuffer(raw, np.uint8).copy()


def unpack_cellmeta(arr: np.ndarray) -> Tuple[int, int, bytes]:
    """(cell_index, n_clients, evidence_digest); ValueError on garbage."""
    raw = np.asarray(arr, np.uint8).tobytes()
    if len(raw) != _CELLMETA_LEN or not raw.startswith(_CELLMETA_MAGIC):
        raise ValueError("not a #cellmeta entry")
    off = len(_CELLMETA_MAGIC)
    cell_index, n_clients = struct.unpack_from("<qq", raw, off)
    evidence = raw[off + 16:]
    if n_clients < 1 or cell_index < 0:
        raise ValueError(f"bad cellmeta ({cell_index}, {n_clients})")
    return int(cell_index), int(n_clients), evidence


def split_cellmeta(flat: Dict[str, np.ndarray]
                   ) -> Tuple[Dict[str, np.ndarray],
                              Optional[Tuple[int, int, bytes]]]:
    """(entries without #cellmeta, parsed meta or None).  Raises
    ValueError when a #cellmeta entry is present but malformed — a
    half-valid cell op must die at admission, not inside aggregation."""
    if CELLMETA_KEY not in flat:
        return dict(flat), None
    rest = {k: v for k, v in flat.items() if k != CELLMETA_KEY}
    return rest, unpack_cellmeta(flat[CELLMETA_KEY])


def cell_evidence_digest(epoch: int, cell_index: int,
                         admitted: Sequence[Tuple[str, bytes, int, float]],
                         medians: Sequence[float],
                         selected: Sequence[int]) -> bytes:
    """Digest of the cell-local admission + scoring outcome: the admitted
    records (sender, payload hash, n_samples, cost), the committee
    median score per slot, and which slots the cell selected — all from
    the cell ledger's REPLICATED state (updates/pending), so any party
    replaying the cell's op log re-derives the same digest.  Everything
    is struct-packed in sorted order; no JSON, no float repr."""
    d = hashlib.sha256()
    d.update(_EVIDENCE_MAGIC)
    d.update(struct.pack("<qqq", epoch, cell_index, len(admitted)))
    for sender, payload_hash, n, cost in sorted(admitted):
        sb = sender.encode()
        d.update(struct.pack("<q", len(sb)))
        d.update(sb)
        d.update(bytes(payload_hash))
        d.update(struct.pack("<qd", int(n), float(cost)))
    d.update(struct.pack("<q", len(medians)))
    for m in medians:
        d.update(struct.pack("<f", np.float32(m)))
    d.update(struct.pack("<q", len(selected)))
    for s in sorted(int(x) for x in selected):
        d.update(struct.pack("<q", s))
    return d.digest()


def cell_partial(admitted: List[Tuple[str, Dict[str, np.ndarray], int,
                                      float]], blocks: int = 1,
                 engine=None) -> Tuple[Dict[str, np.ndarray], int, float]:
    """(partial entries, admitted client count, mean cost) from the
    cell-selected member deltas.

    The partial is the sample-weighted FedAvg mean over the admitted
    deltas — the same arithmetic `_aggregate_flat` runs, one tier down —
    accumulated in SORTED SENDER ORDER with float32 ops so the result is
    a pure function of the admitted SET (float addition is not
    associative; pinning the order is what makes the canonical bytes,
    and therefore the certified hash, arrival-order independent).

    The sum runs through the meshagg engine under the SAME reduction
    spec as the root writer's merge (meshagg.spec, REDUCTION SPEC v1/v2:
    sorted-sender slot order here plays the ledger-slot-order role), so
    a large cell's partial is one compiled program and the bytes are
    identical to the pre-engine loop on every leg.  `blocks` is the
    genome's reduce_blocks (spec v2 execution shape — byte-invariant,
    so the certified partial hash never depends on it).  `engine`: the
    `meshagg.engine.MeshAggEngine` to sum on (None: `ENGINE`)."""
    if not admitted:
        raise ValueError("cell_partial over an empty admitted set")
    ordered = sorted(admitted, key=lambda t: t[0])
    if len({a for a, _, _, _ in ordered}) != len(ordered):
        raise ValueError("duplicate sender in the admitted set")
    w = np.asarray([float(n) for _, _, n, _ in ordered], np.float32)
    if np.any(w <= 0):
        raise ValueError("non-positive sample count in the admitted set")
    wsum = np.float32(w.sum())
    keys = sorted(ordered[0][1].keys())
    for _, flat, _, _ in ordered[1:]:
        if sorted(flat.keys()) != keys:
            raise ValueError("admitted deltas disagree on entry keys")
    if engine is None:
        from bflc_demo_tpu_torch.meshagg.engine import ENGINE as engine
    accs = engine.weighted_sum(keys, [flat for _, flat, _, _ in ordered],
                               w, float(wsum), blocks=blocks)
    out: Dict[str, np.ndarray] = {
        key: accs[key].astype(np.asarray(ordered[0][1][key]).dtype)
        for key in keys}
    mean_cost = float(np.float32(
        np.sum(np.asarray([c for _, _, _, c in ordered], np.float32))
        / np.float32(len(ordered))))
    return out, len(ordered), mean_cost


def partial_blob(partial: Dict[str, np.ndarray], cell_index: int,
                 n_clients: int, evidence: bytes,
                 density: float = 1.0) -> bytes:
    """Canonical bytes of (partial entries + #cellmeta) — what the cell
    aggregator hashes, SIGNS, and uploads; the certified payload hash is
    sha256 of exactly these bytes.

    With sparse upload deltas armed (density < 1) the partial is
    RE-SPARSIFIED for the bridge hop: members already uploaded sparse
    into the cell, the cell summed them dense, and the one certified op
    per cell per round gets the same egress win on the cell->root edge.
    Sparsify runs BEFORE the #cellmeta entry joins (the evidence is a
    uint8 vector sparsify passes through untouched either way), and the
    root decodes through the same `densify_entries` inverse as any
    upload — density 1.0 keeps the pre-sparse bytes byte-for-byte."""
    if CELLMETA_KEY in partial:
        raise ValueError("partial already carries a #cellmeta entry")
    entries = (sparsify_entries(dict(partial), density)
               if density < 1.0 else dict(partial))
    entries[CELLMETA_KEY] = pack_cellmeta(cell_index, n_clients, evidence)
    return pack_entries(entries)


def check_cell_upload_op(op: bytes,
                         registry: Dict[str, Tuple[int, int]]) -> str:
    """'' when a root-tier upload op respects the cell registry
    (``address -> (cell_index, max_members)``); a reason string
    otherwise.  The op-level half of the anti-inflation bound — shared
    by the root writer and every BFT validator (validators hold no
    payload blobs, but the claimed client count IS an op field):
    the sender must be a registered cell aggregator and its claimed
    client-count weight must not exceed that cell's registered
    membership.  (The #cellmeta cell-index <-> sender binding lives in
    the blob, so only the root writer's admission can enforce it —
    ``ledger_service._decode_cell_partial``.)"""
    if not op or op[0] != _OP_UPLOAD:
        return ""
    body = op[1:]
    try:
        (slen,) = struct.unpack_from("<q", body, 0)
        if slen < 0 or 8 + slen + 48 > len(body):
            return "cell op: malformed upload body"
        sender = body[8:8 + slen].decode()
        (n,) = struct.unpack_from("<q", body, 8 + slen + 32)
    except (struct.error, UnicodeDecodeError) as e:
        return f"cell op: undecodable ({e})"
    ent = registry.get(sender)
    if ent is None:
        return (f"cell op: sender {sender[:12]} is not a registered "
                f"cell aggregator")
    _cell_index, cap = ent
    if not 0 < n <= cap:
        return (f"cell op: claimed client count {n} exceeds registered "
                f"membership {cap} for {sender[:12]}")
    return ""
