"""Sequence parallelism on the folded axis and secure aggregation (port
of `bflc_demo_tpu/parallel`: the ring-attention subset and
`parallel/secure.py`)."""

from bflc_demo_tpu_torch.parallel.mesh import FoldedAxis  # noqa: F401
from bflc_demo_tpu_torch.parallel.secure import (  # noqa: F401
    derive_pair_seeds, secure_fedavg, secure_masked_sum)
