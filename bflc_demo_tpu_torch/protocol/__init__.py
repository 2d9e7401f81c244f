"""Protocol genome (copy of `bflc_demo_tpu/protocol`, synchronous subset)."""

from bflc_demo_tpu_torch.protocol.constants import (  # noqa: F401
    BFT_REFERENCE_VALIDATORS, DEFAULT_PROTOCOL, ProtocolConfig,
    bft_fault_tolerance, bft_quorum)
from bflc_demo_tpu_torch.protocol.types import (  # noqa: F401
    CommitCertificate, LocalUpdate, Role, RoundResult, ScoreVector,
    UpdateMeta)
