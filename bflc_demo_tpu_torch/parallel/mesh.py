"""The folded sequence-parallel axis: n sequence shards on one device.

The port's counterpart of an "sp" mesh axis and the `shard_map` around it
(`bflc_demo_tpu/parallel/mesh.py:make_mesh` and the `in_specs=P(None,
"sp")` of `parallel/ring_attention.py`).  The reference runs one program
per device of the axis, and its tests run n virtual devices on one CPU.
Here the n shards live on one device, folded shard-major into the leading
batch axis — row r of a folded tensor is shard r // B, batch row r % B —
so every per-shard operation of the reference runs once over all shards:

- `ppermute` (the reference's `perm = [(j, (j + 1) % n)]`) is a roll of
  the folded axis by one shard: afterwards shard i holds what shard i-1
  held;
- `psum` is a sum over the shards, in ascending shard order;
- `axis_index` becomes `offsets`, each row's first position in the
  unsharded sequence.

The same per-shard program runs in the same hop order as on n devices.
Not ported: `torch.distributed` across cards (ROADMAP A12).
"""

from __future__ import annotations

import torch

from bflc_demo_tpu_torch.device import DeviceLike, resolve_device


class FoldedAxis:
    """`size` sequence shards of a batch of `batch` rows on one device
    (`cuda` unless `device` names the CPU; raises without a card)."""

    def __init__(self, size: int, batch: int, device: DeviceLike = None):
        if size < 1 or batch < 1:
            raise ValueError(f"size and batch must be positive, got "
                             f"{size}, {batch}")
        self.size = size
        self.batch = batch
        self.device = resolve_device(device)

    def shard(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) -> (n*B, S/n) on the axis's device."""
        b, s = tokens.shape
        if b != self.batch:
            raise ValueError(f"batch {b} != the axis's batch {self.batch}")
        if s % self.size:
            raise ValueError(f"seq_len {s} not divisible by sp axis "
                             f"{self.size}")
        shards = tokens.reshape(b, self.size, s // self.size).transpose(0, 1)
        return shards.reshape(self.size * b, s // self.size).to(self.device)

    def ppermute(self, t: torch.Tensor) -> torch.Tensor:
        """Shard i receives shard i-1's rows (shard 0 gets shard n-1's)."""
        return torch.roll(t, shifts=self.batch, dims=0)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """(n*B, ...) -> (B, ...): the shards summed in ascending order."""
        b = self.batch
        total = t[:b]
        for i in range(1, self.size):
            total = total + t[i * b:(i + 1) * b]
        return total

    def offsets(self, shard_len: int) -> torch.Tensor:
        """(n*B,) int64: each folded row's first position, shard * S/n."""
        shard = torch.arange(self.size * self.batch,
                             device=self.device) // self.batch
        return shard * shard_len
