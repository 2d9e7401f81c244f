"""Request, retry and rotation over an ordered list of writer endpoints.

Port of `FailoverClient` (`bflc_demo_tpu/comm/failover.py:129-319`): a
`CoordinatorClient` over an endpoint list.  On a connection-level failure
the socket is dropped and the next endpoint tried, with a short backoff
after each full silent cycle; retrying is safe because every mutation is
signed and idempotent at the ledger (DUPLICATE = already in).  The
process fleet's clients and its sponsor use it as the reference does,
here with the one writer's endpoint.  Every request carries the
reference's `fence` field (the highest writer generation seen, 0 for a
writer without standbys), a `STALE_WRITER` reply rotates like a dead
endpoint, and a reply whose `gen` is behind the fence is refused.

Not ported yet: learning a higher fence from signed promotion evidence,
the standby keys that verify it, and the BFT certificate check on acks
(ROADMAP A9: standbys and failover, BFT validators); `Standby` (:320)
itself waits for the standby item.  TLS waits for its own (A9).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from bflc_demo_tpu_torch.comm.ledger_service import (CoordinatorClient,
                                                     refuse_unported)
from bflc_demo_tpu_torch.comm.wire import WireError

Endpoint = Tuple[str, int]


class FailoverClient:
    """CoordinatorClient over an ordered endpoint list."""

    def __init__(self, endpoints: List[Endpoint], timeout_s: float = 30.0,
                 max_cycles: int = 6, **unported):
        refuse_unported(unported, {
            "tls": "A9 (TLS)",
            "standby_keys": "A9 (standbys and failover)",
            "bft_keys": "A9 (BFT validators)",
            "bft_quorum": "A9 (BFT validators)"})
        if not endpoints:
            raise ValueError("need at least one endpoint")
        self._eps = list(endpoints)
        self._timeout_s = timeout_s
        self._max_cycles = max_cycles
        self._cur = 0
        self._client: Optional[CoordinatorClient] = None
        self.gen = 0

    @property
    def current_endpoint(self) -> Endpoint:
        return self._eps[self._cur]

    def _rotate(self) -> None:
        self.close()
        self._cur = (self._cur + 1) % len(self._eps)

    def request(self, method: str, **fields) -> dict:
        last: Optional[Exception] = None
        attempts = self._max_cycles * len(self._eps)
        fields.setdefault("fence", self.gen)
        for attempt in range(attempts):
            try:
                if self._client is None:
                    host, port = self._eps[self._cur]
                    self._client = CoordinatorClient(
                        host, port, timeout_s=self._timeout_s)
                reply = self._client.request(method, **fields)
                g = reply.get("gen")
                if reply.get("status") == "STALE_WRITER" or \
                        (isinstance(g, int) and g < self.gen):
                    # not the writer (it demoted itself, or it is behind
                    # our fence): never accept its reply
                    last = ConnectionError(f"stale writer (gen {g})")
                    self._rotate()
                    continue
                return reply
            except (ConnectionError, WireError, OSError) as e:
                last = e
                self._rotate()
                if self._cur == 0:          # full cycle without an answer
                    time.sleep(min(0.25 * (attempt + 1), 2.0))
        raise ConnectionError(
            f"all coordinator endpoints failed after {attempts} attempts: "
            f"{type(last).__name__}: {last}")

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
