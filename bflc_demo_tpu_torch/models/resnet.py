"""ResNet-18 with GroupNorm for the cross-silo config (config 4).

Port of `bflc_demo_tpu/models/resnet.py` (:22-81): the CIFAR stem (3x3
conv, 64 filters, no bias, GroupNorm 32, relu), four stages of basic
blocks (64, 128, 256, 512 filters; the first block of stages 1-3 at
stride 2 with a 1x1 conv + GroupNorm projection on the residual), the
mean over H and W, and a Dense head.  GroupNorm groups are min(32,
filters); convs are flax's SAME, so a stride-2 3x3 conv on an even width
pads (0, 1) (`models/layers.py`).  The parameter tree is flax's:
`['_BasicBlock_3']['GroupNorm_1']['scale']` and so on, 62 leaves and
11,220,132 parameters at CIFAR-100's shapes.  `stage_sizes` stays a
constructor argument (reference :50), so tests can build a shallower
net.  `dtype` float32 or bfloat16 is the reference's compute dtype
(:25-54): the convs in `dtype`, GroupNorm in float32 cast to `dtype`,
the head float32, the parameters float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from bflc_demo_tpu_torch.models.layers import (FlaxModel, conv, conv_specs,
                                               dense, dense_specs,
                                               group_norm, group_norm_specs,
                                               nchw)


def _block_plan(stage_sizes: Sequence[int]):
    """(scope name, filters, stride) of each basic block, in order."""
    plan, i = [], 0
    for stage, blocks in enumerate(stage_sizes):
        filters = 64 * 2 ** stage
        for b in range(blocks):
            plan.append((f"_BasicBlock_{i}", filters,
                         2 if stage > 0 and b == 0 else 1))
            i += 1
    return plan


class ResNet18(FlaxModel):
    def __init__(self, input_shape: Tuple[int, ...] = (32, 32, 3),
                 num_classes: int = 100,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        specs = conv_specs(("Conv_0",), 3, input_shape[-1], 64, False) \
            + group_norm_specs(("GroupNorm_0",), 64)
        self.plan = _block_plan(stage_sizes)
        n_in = 64
        for name, filters, stride in self.plan:
            specs += conv_specs((name, "Conv_0"), 3, n_in, filters, False)
            specs += group_norm_specs((name, "GroupNorm_0"), filters)
            specs += conv_specs((name, "Conv_1"), 3, filters, filters, False)
            specs += group_norm_specs((name, "GroupNorm_1"), filters)
            if stride != 1 or n_in != filters:
                specs += conv_specs((name, "Conv_2"), 1, n_in, filters,
                                    False)
                specs += group_norm_specs((name, "GroupNorm_2"), filters)
            n_in = filters
        specs += dense_specs(("Dense_0",), n_in, num_classes)
        super().__init__(specs, num_classes, input_shape, dtype)

    def _gn(self, x: torch.Tensor, scope: str) -> torch.Tensor:
        return group_norm(x.float(), self.p(f"{scope}.scale"),
                          self.p(f"{scope}.bias"),
                          min(32, x.shape[1])).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        x = conv(nchw(x).to(self.dtype), w("Conv_0.kernel"))
        x = torch.relu(self._gn(x, "GroupNorm_0"))
        for name, _, stride in self.plan:
            y = conv(x, w(f"{name}.Conv_0.kernel"), stride=stride)
            y = torch.relu(self._gn(y, f"{name}.GroupNorm_0"))
            y = self._gn(conv(y, w(f"{name}.Conv_1.kernel")),
                         f"{name}.GroupNorm_1")
            if y.shape != x.shape:
                x = self._gn(conv(x, w(f"{name}.Conv_2.kernel"),
                                  stride=stride), f"{name}.GroupNorm_2")
            x = torch.relu(y + x)
        return dense(x.mean(dim=(2, 3)).float(), self.p("Dense_0.kernel"),
                     self.p("Dense_0.bias"))


def make_resnet18(input_shape: Tuple[int, ...] = (32, 32, 3),
                  num_classes: int = 100,
                  stage_sizes: Sequence[int] = (2, 2, 2, 2),
                  dtype: torch.dtype = torch.float32) -> ResNet18:
    return ResNet18(tuple(input_shape), num_classes, tuple(stage_sizes),
                    dtype)
