"""The certified merge engine (port of `bflc_demo_tpu/meshagg`).

`spec` is REDUCTION SPEC v2, the fixed-order reduction every certified
aggregation computes, and its normative host leg; `engine` the reduction
surface with its host leg and its mesh leg (kernel B5 on the card);
`stats` the health plane's per-delta statistics; `check` the
differential checker (`python -m bflc_demo_tpu_torch.meshagg.check`).
`BFLC_MESH_AGG_LEGACY=1` pins the host loop byte-for-byte with the
pre-engine tree.
"""

from bflc_demo_tpu_torch.meshagg.engine import (  # noqa: F401
    ENGINE, MeshAggEngine, score_candidates_batched)
from bflc_demo_tpu_torch.meshagg.spec import (  # noqa: F401
    SPEC_VERSION, apply_step, host_weighted_sum, legacy_host_weighted_sum,
    merge_coefficients, merge_weight_vector)

__all__ = [
    "ENGINE", "MeshAggEngine", "score_candidates_batched",
    "SPEC_VERSION", "apply_step", "host_weighted_sum",
    "legacy_host_weighted_sum", "merge_coefficients",
    "merge_weight_vector",
]
