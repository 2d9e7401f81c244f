"""The protocol genome — every constant client and coordinator agree on.

Copy of `bflc_demo_tpu/protocol/constants.py` (`ProtocolConfig` and its
`validate()`), cut to the fields the synchronous rounds read, with
asynchronous buffered aggregation (`async_buffer`, `max_staleness`,
`async_reseat_every`, :74-96, checked at :166-187), REDUCTION SPEC v2's
`reduce_blocks` (:128-140, checked at :210-216) and the BFT quorum
algebra (`BFT_REFERENCE_VALIDATORS`, `bft_fault_tolerance`,
`bft_quorum`, :236-261).  Dropped, with their checks: the data-plane
encodings (`delta_dtype`, `delta_density`, `delta_codec`) and the
closed compression loop (`adapt_every`, `density_floor`).  Each belongs
to a runtime this port has not reached yet (ROADMAP queue A).  The
values and the checks kept are the reference's, unchanged.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Committee-consensus FL protocol parameters (reference defaults)."""

    # population / round structure
    client_num: int = 20          # registrations that start FL
    comm_count: int = 4           # committee size; scores needed per round
    aggregate_count: int = 6      # top-k updates merged per round
    needed_update_count: int = 10  # updates accepted per round (first-come cap)

    # optimisation
    learning_rate: float = 0.001  # server-side step; clients reuse it
    batch_size: int = 100
    local_epochs: int = 1         # passes over the local shard per round

    # run control
    max_epoch: int = 1000
    genesis_epoch: int = -999     # epoch value before CLIENT_NUM registrations
    initial_trained_epoch: int = -1

    # asynchronous buffered aggregation (FedBuff): with async_buffer =
    # K > 0 the round barrier falls.  Each async upload op carries the
    # BASE epoch its client trained from, admission stamps staleness
    # s = epoch_now - base_epoch (refused past max_staleness), and the
    # writer drains every K admissions with weights n / sqrt(1 + s).
    # Every async_reseat_every-th drain reseats the committee from the
    # drained window's ranking.  0 (the default) or BFLC_ASYNC_LEGACY=1
    # keeps the synchronous chain byte for byte.
    async_buffer: int = 0
    max_staleness: int = 20
    async_reseat_every: int = 0

    # REDUCTION SPEC v2: the flattened (P,) param axis is cut into
    # reduce_blocks fixed contiguous blocks (meshagg.spec.block_bounds);
    # the committed bytes are v1's for every value.  Blocked commit ops
    # carry the claim and replicas refuse a claim that disagrees with
    # this field.  1 (the default) or BFLC_BLOCKED_LEGACY=1 keeps the v1
    # single-block wire format.
    reduce_blocks: int = 1

    def validate(self) -> "ProtocolConfig":
        if not (0 < self.comm_count < self.client_num):
            raise ValueError(
                f"comm_count must be in (0, client_num): {self.comm_count} vs "
                f"{self.client_num}")
        if not (0 < self.aggregate_count <= self.needed_update_count):
            raise ValueError(
                f"aggregate_count must be in (0, needed_update_count]: "
                f"{self.aggregate_count} vs {self.needed_update_count}")
        if self.needed_update_count > self.client_num - self.comm_count:
            raise ValueError(
                "needed_update_count exceeds trainer population "
                f"({self.needed_update_count} > "
                f"{self.client_num - self.comm_count})")
        if self.learning_rate <= 0 or self.batch_size <= 0:
            raise ValueError("learning_rate and batch_size must be positive")
        if self.async_buffer < 0 or self.max_staleness < 0:
            raise ValueError(
                f"async_buffer and max_staleness must be >= 0, got "
                f"{self.async_buffer}/{self.max_staleness}")
        if self.async_buffer > self.client_num - self.comm_count:
            raise ValueError(
                f"async_buffer ({self.async_buffer}) exceeds the "
                f"trainer population "
                f"({self.client_num - self.comm_count}): with one "
                f"in-flight delta per sender the buffer could never "
                f"fill and every aggregation would wait on stall "
                f"recovery")
        if self.async_reseat_every < 0:
            raise ValueError(
                f"async_reseat_every must be >= 0, got "
                f"{self.async_reseat_every}")
        if self.async_reseat_every > 0 and self.async_buffer <= 0:
            raise ValueError(
                "async_reseat_every requires async mode "
                f"(async_buffer > 0), got reseat_every="
                f"{self.async_reseat_every} with async_buffer="
                f"{self.async_buffer}")
        if self.reduce_blocks < 1:
            raise ValueError(
                f"reduce_blocks must be >= 1 (1 = REDUCTION SPEC v1 "
                f"single block), got {self.reduce_blocks}")
        if self.reduce_blocks > 65536:
            raise ValueError(
                f"reduce_blocks = {self.reduce_blocks} is degenerate "
                f"(> 65536): blocks beyond the param count P reduce "
                f"nothing, and P-scale geometries are rejected per "
                f"model by meshagg.spec.block_bounds")
        return self


DEFAULT_PROTOCOL = ProtocolConfig().validate()


# --- BFT commit-certificate geometry (the reference's 4-node PBFT chain):
# the one place the quorum arithmetic lives, which the writer, the
# validators, the standbys and the clients must agree on exactly.

BFT_REFERENCE_VALIDATORS = 4    # the reference chain's node count (f=1)


def bft_fault_tolerance(n_validators: int) -> int:
    """f: how many arbitrarily faulty validators n tolerate (PBFT
    n >= 3f+1, so f = floor((n-1)/3); n=4 -> f=1).  n < 4 gives f=0."""
    if n_validators < 1:
        raise ValueError(f"need at least 1 validator, got {n_validators}")
    return (n_validators - 1) // 3


def bft_quorum(n_validators: int) -> int:
    """Signatures a commit certificate needs: n - f (2f+1 at n = 3f+1).
    Any two quorums intersect in >= f+1 validators, one of them honest,
    so two conflicting ops at one position never both certify."""
    return n_validators - bft_fault_tolerance(n_validators)
