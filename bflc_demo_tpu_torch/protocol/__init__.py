"""Protocol genome (copy of `bflc_demo_tpu/protocol`, synchronous subset)."""

from bflc_demo_tpu_torch.protocol.constants import (  # noqa: F401
    DEFAULT_PROTOCOL, ProtocolConfig)
