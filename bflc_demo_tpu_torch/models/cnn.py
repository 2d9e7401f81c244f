"""Convolutional models: LeNet-5 (config 2) and the LEAF FEMNIST CNN
(config 3).

Port of `bflc_demo_tpu/models/cnn.py` (:17-77): the same layers, NHWC
inputs, flax's parameter tree and initial values (`models/layers.py`,
`utils/flax_init.py`).  Stateless, no BatchNorm.  `dtype` float32 or
bfloat16 is the reference's compute dtype (:19-52): the input and every
layer but the float32 head in `dtype`, the parameters float32.

LeNet-5: Conv(6, 5x5, SAME), relu, avg_pool; Conv(16, 5x5, VALID),
relu, avg_pool; Dense 120, relu; Dense 84, relu; Dense classes.
FEMNIST CNN: Conv(32, 5x5, SAME), relu, max_pool; Conv(64, 5x5, SAME),
relu, max_pool; Dense 2048, relu; Dense classes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bflc_demo_tpu_torch.models.layers import (FlaxModel, conv, conv_specs,
                                               dense, dense_specs,
                                               flatten_nhwc, nchw, pool,
                                               pooled)


class LeNet5(FlaxModel):
    def __init__(self, input_shape: Tuple[int, ...] = (32, 32, 3),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32):
        h, w, c = input_shape
        flat = pooled(pooled(h, 1) - 4, 1) * pooled(pooled(w, 1) - 4, 1) * 16
        super().__init__(
            conv_specs(("Conv_0",), 5, c, 6) + conv_specs(("Conv_1",), 5, 6,
                                                          16)
            + dense_specs(("Dense_0",), flat, 120)
            + dense_specs(("Dense_1",), 120, 84)
            + dense_specs(("Dense_2",), 84, num_classes),
            num_classes, input_shape, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        x = pool(torch.relu(conv(nchw(x).to(self.dtype), w("Conv_0.kernel"),
                                 w("Conv_0.bias"))), "avg")
        x = pool(torch.relu(conv(x, w("Conv_1.kernel"), w("Conv_1.bias"),
                                 padding="VALID")), "avg")
        x = flatten_nhwc(x)
        x = torch.relu(dense(x, w("Dense_0.kernel"), w("Dense_0.bias")))
        x = torch.relu(dense(x, w("Dense_1.kernel"), w("Dense_1.bias")))
        return dense(x.float(), self.p("Dense_2.kernel"),
                     self.p("Dense_2.bias"))


class FemnistCNN(FlaxModel):
    def __init__(self, input_shape: Tuple[int, ...] = (28, 28, 1),
                 num_classes: int = 62, dtype: torch.dtype = torch.float32):
        h, w, c = input_shape
        flat = pooled(h, 2) * pooled(w, 2) * 64
        super().__init__(
            conv_specs(("Conv_0",), 5, c, 32) + conv_specs(("Conv_1",), 5,
                                                           32, 64)
            + dense_specs(("Dense_0",), flat, 2048)
            + dense_specs(("Dense_1",), 2048, num_classes),
            num_classes, input_shape, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        x = pool(torch.relu(conv(nchw(x).to(self.dtype), w("Conv_0.kernel"),
                                 w("Conv_0.bias"))), "max")
        x = pool(torch.relu(conv(x, w("Conv_1.kernel"), w("Conv_1.bias"))),
                 "max")
        x = torch.relu(dense(flatten_nhwc(x), w("Dense_0.kernel"),
                             w("Dense_0.bias")))
        return dense(x.float(), self.p("Dense_1.kernel"),
                     self.p("Dense_1.bias"))


def make_lenet5(input_shape: Tuple[int, ...] = (32, 32, 3),
                num_classes: int = 10,
                dtype: torch.dtype = torch.float32) -> LeNet5:
    return LeNet5(tuple(input_shape), num_classes, dtype)


def make_femnist_cnn(input_shape: Tuple[int, ...] = (28, 28, 1),
                     num_classes: int = 62,
                     dtype: torch.dtype = torch.float32) -> FemnistCNN:
    return FemnistCNN(tuple(input_shape), num_classes, dtype)
