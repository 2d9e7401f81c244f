"""Typed protocol messages (copy of `bflc_demo_tpu/protocol/types.py`).

The whole reference file, unchanged but for this docstring and the
`Pytree` comment: `Role`, `UpdateMeta`, `LocalUpdate`, `ScoreVector`,
`CommitCertificate` with its wire form (`to_wire`/`from_wire`, the dict
the writer, the standbys and the clients exchange, equal to the
reference's field for field) and `RoundResult`.  It imports only
`dataclasses`, `enum` and `typing`; `comm/bft.py` needs
`CommitCertificate` when it is imported.  Nothing is dropped.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional

# A model / delta is any tree of arrays.  We alias it for readability.
Pytree = Any


class Role(str, enum.Enum):
    """On-chain role of a client (reference: roles map, .cpp:168-190).

    The reference stores roles as strings "trainer"/"comm" in a JSON map;
    unknown addresses default to trainer on query (.cpp:191-205) without being
    persisted — we reproduce that read semantic in the ledger.
    """

    TRAINER = "trainer"
    COMMITTEE = "comm"


@dataclasses.dataclass(frozen=True)
class UpdateMeta:
    """Side information accompanying a delta (reference Meta struct, .h:54-77).

    n_samples weights the FedAvg mean (.cpp:374-400); avg_cost feeds the global
    loss print (.cpp:416-425).
    """

    n_samples: int
    avg_cost: float


@dataclasses.dataclass(frozen=True)
class LocalUpdate:
    """A trainer's contribution for one round (reference LocalUpdate, .h:79-107).

    ``delta`` is (params_before - params_after) / lr, so applying
    ``global -= lr * weighted_mean(delta)`` is exactly the sample-weighted mean
    of client post-training models (FedAvg; main.py:153-158 + .cpp:403-414).
    ``payload_hash`` is what the ledger records; the tensor pytree itself lives
    in the off-ledger update store (HBM / host memory).
    """

    sender: str
    epoch: int
    meta: UpdateMeta
    delta: Optional[Pytree] = None      # device pytree; None once detached
    payload_hash: bytes = b""


@dataclasses.dataclass(frozen=True)
class ScoreVector:
    """One committee member's scores for all candidate updates.

    Reference: map<address_hex, float> as JSON (main.py:211-219, .cpp:354-357).
    """

    scorer: str
    epoch: int
    scores: Dict[str, float]            # trainer address -> accuracy


@dataclasses.dataclass(frozen=True)
class CommitCertificate:
    """Quorum proof that one op bound at one chain position (comm.bft).

    The BFT equivalent of the reference's PBFT commit: `sigs` holds
    Ed25519 signatures by distinct validators, each over the canonical
    payload binding (index, chain head BEFORE the op, the op bytes'
    digest, chain head AFTER the op) — see comm.bft.cert_payload.  An op
    carries a valid certificate only if >= bft_quorum(n) validators
    independently re-executed it against their own replicas and agreed on
    the SAME prefix and result; two conflicting ops at one index can never
    both certify (quorum intersection contains an honest validator, and an
    honest validator votes at most once per index).
    """

    index: int                          # chain position of the op
    prev_head: bytes                    # head digest before the op (32B)
    op_hash: bytes                      # sha256 of the canonical op bytes
    new_head: bytes                     # head digest after the op (32B)
    sigs: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    # ^ validator index -> Ed25519 signature over cert_payload(...)
    # certification attempt the signatures were minted at (comm.bft repair
    # protocol): every signature in ONE certificate is over the SAME
    # attempt, so a stalled position re-proposed at a higher attempt can
    # never mix old-attempt and new-attempt votes into a thin quorum.
    # Certificates at different attempts for the same (index, op) are
    # equally valid — the repair rule guarantees all attempts converge on
    # one op per position.
    attempt: int = 0

    def to_wire(self) -> Dict[str, Any]:
        return {"i": self.index, "prev": self.prev_head.hex(),
                "op_hash": self.op_hash.hex(), "head": self.new_head.hex(),
                "t": self.attempt,
                "sigs": {str(v): s.hex() for v, s in self.sigs.items()}}

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "CommitCertificate":
        """Parse a peer-supplied dict; raises ValueError on malformed input
        (callers at trust boundaries catch and treat as no-certificate)."""
        try:
            sigs = {int(v): bytes.fromhex(s)
                    for v, s in dict(d["sigs"]).items()}
            return cls(index=int(d["i"]),
                       prev_head=bytes.fromhex(d["prev"]),
                       op_hash=bytes.fromhex(d["op_hash"]),
                       new_head=bytes.fromhex(d["head"]),
                       attempt=int(d.get("t", 0)),
                       sigs=sigs)
        except (KeyError, TypeError, AttributeError) as e:
            raise ValueError(f"malformed commit certificate: {e}") from e


@dataclasses.dataclass(frozen=True)
class RoundResult:
    """Outcome of one aggregation (reference Aggregate, .cpp:349-456)."""

    epoch: int                          # epoch just completed
    global_loss: float                  # sum(top-k avg_cost)/k (.cpp:416-425)
    selected: tuple                     # trainer addresses aggregated (top-k)
    new_committee: tuple                # addresses elected for next round
    model_hash: bytes = b""             # hash of the post-update global model
