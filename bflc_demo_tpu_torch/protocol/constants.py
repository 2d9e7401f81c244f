"""The protocol genome — every constant client and coordinator agree on.

Copy of `bflc_demo_tpu/protocol/constants.py` (`ProtocolConfig` and its
`validate()`), cut to the fields the synchronous host round reads.
Dropped, with their checks: the data-plane encodings (`delta_dtype`,
`delta_density`, `delta_codec`), asynchronous aggregation
(`async_buffer`, `max_staleness`, `async_reseat_every`), the closed
compression loop (`adapt_every`, `density_floor`), the blocked reduction
(`reduce_blocks`) and the BFT quorum helpers.  Each belongs to a runtime
this port has not reached yet (ROADMAP queue A).  The values and the
checks kept are the reference's, unchanged.
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
        return self


DEFAULT_PROTOCOL = ProtocolConfig().validate()
