"""Hand-written CUDA kernels and their plain PyTorch versions."""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """This process's launch count of every kernel (each wrapper counts
    where it launches its kernel, never on its plain version)."""
    from bflc_demo_tpu_torch.ops import (certified_reduce, fingerprint,
                                         flash_attention, secure_mask)
    return {**flash_attention.LAUNCHES, **fingerprint.LAUNCHES,
            **certified_reduce.LAUNCHES, **secure_mask.LAUNCHES}
