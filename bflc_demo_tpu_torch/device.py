"""Device resolution for every port entry point.

The counterpart of `JAX_PLATFORMS`: the port runs on `cuda` unless the
caller names the CPU.  A missing card is an error, never a quiet fallback,
so no run can report CPU numbers as if they were the card's.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means `cuda`.  Raises when `cuda` is asked for (explicitly or
    by default) and no card is visible.

    On `cuda` this also pins float32 matrix products and convolutions to
    full float32 (TF32 off): the port's configurations are float32 and
    the card's tolerances must not hide TF32 rounding; and it asks cuDNN
    for deterministic convolution algorithms, so two runs on the card
    take the same decisions.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return dev


def upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`.  To the card it goes from pinned memory
    without waiting on the stream: the copy runs ahead of later work in
    stream order and the host never syncs (a multi-round dispatch runs
    with no sync)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
