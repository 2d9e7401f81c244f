"""Sequence parallelism on the folded axis (port of `bflc_demo_tpu/parallel`,
the ring-attention subset)."""

from bflc_demo_tpu_torch.parallel.mesh import FoldedAxis  # noqa: F401
