"""flax.linen's layers as the reference's conv models use them, in PyTorch.

The reference's CNNs and ResNet (`bflc_demo_tpu/models/cnn.py`,
`models/resnet.py`) are flax modules in NHWC with flax's parameter tree.
`FlaxModel` keeps that tree: its parameters are registered under the
flax scope names (`Conv_0.kernel` <-> `['Conv_0']['kernel']`), with
flax's shapes (Conv kernels HWIO `(kh, kw, in, out)`, Dense kernels
`(in, out)`), so `params_from_jax`, the content hash and the payload
fingerprint see the reference's tree, and `init_params(seed)` draws
flax's values (`utils/flax_init.py`).  The layers compute in NCHW for
`F.conv2d` and take flax's semantics:

- `conv`: SAME padding is flax's (`lax.padtype_to_pads`): total =
  max((ceil(n / s) - 1) * s + k - n, 0), `total // 2` before and the
  rest after, so a 3x3 stride-2 conv on 32 pads (0, 1), not PyTorch's
  (1, 1); VALID pads nothing.  The HWIO kernel is permuted to OIHW here;
- `pool`: `avg_pool` / `max_pool`, 2x2 windows at stride 2, VALID;
- `flatten`: the NHWC flatten of `x.reshape((B, -1))`: NCHW permutes
  back to NHWC first, or the first Dense would see scrambled features;
- `group_norm`: flax's `GroupNorm` (`linen/normalization.py:642`):
  groups over contiguous channels, statistics per sample over (H, W,
  the group's channels), variance E[x^2] - E[x]^2 clamped at 0
  (`use_fast_variance=True`), epsilon 1e-6, then (x - mean) *
  (rsqrt(var + eps) * scale) + bias.

`dtype` is flax's compute dtype (float32 or bfloat16): the parameters
stay float32; the input is cast to `dtype`, every conv and hidden Dense
runs in `dtype` on weights cast at use (`FlaxModel.w`), GroupNorm
computes in float32 and casts its output to `dtype` (flax promotes its
statistics to float32), and the head is a float32 Dense.

`FlaxModel.apply_stacked` runs G models at once: on the card with
`torch.func.vmap` over `apply` (`apply_vmapped`; these models launch no
ctypes kernel, so vmap can batch them: a vmapped conv with per-model
weights is one grouped conv), on the CPU as G `apply` calls.  oneDNN's
grouped convolution rounds differently for different numbers of groups,
so on the CPU a vmapped round would change its last bits with
`client_chunk`; the loop keeps each slot's arithmetic its own, as the
reference's per-model `vmap` is (`core.losses.xla_cpu_order` is the
device choice).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bflc_demo_tpu_torch.core.losses import xla_cpu_order
from bflc_demo_tpu_torch.models.base import (Model, Params, compute_dtype,
                                             keystr)
from bflc_demo_tpu_torch.utils.flax_init import ParamSpec, init_tree

GN_EPSILON = 1e-6


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax's SAME padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride: int = 1,
         padding: str = "SAME") -> torch.Tensor:
    """flax `nn.Conv` on NCHW `x` with an HWIO `kernel`."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    if padding == "SAME":
        ph = same_pads(x.shape[-2], kh, stride)
        pw = same_pads(x.shape[-1], kw, stride)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding}")
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride=stride)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """flax `nn.Dense`: x @ kernel (+ bias)."""
    y = x @ kernel
    return y if bias is None else y + bias


def pool(x: torch.Tensor, kind: str) -> torch.Tensor:
    """flax `avg_pool` / `max_pool` with (2, 2) windows at stride 2,
    VALID."""
    if kind == "avg":
        return F.avg_pool2d(x, 2, 2)
    return F.max_pool2d(x, 2, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W * C) in NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = GN_EPSILON) -> torch.Tensor:
    """flax `nn.GroupNorm(num_groups=groups)` on NCHW `x`."""
    b, c = x.shape[0], x.shape[1]
    g = x.reshape(b, groups, -1)
    mean = g.mean(-1)
    var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
    shape = (b, groups, 1)
    mul = torch.rsqrt(var + eps).reshape(shape).repeat_interleave(
        c // groups, dim=1).reshape(b, c, 1, 1) * scale.reshape(1, c, 1, 1)
    mean = mean.reshape(shape).repeat_interleave(c // groups, dim=1) \
        .reshape(b, c, 1, 1)
    return (x - mean) * mul + bias.reshape(1, c, 1, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The reference's NHWC images, as float32 NCHW."""
    return x.to(torch.float32).permute(0, 3, 1, 2)


class FlaxModel(Model):
    """A model whose parameters are a flax tree listed by `ParamSpec`s in
    flax's creation order."""

    def __init__(self, specs: Sequence[ParamSpec], num_classes: int,
                 input_shape: Tuple[int, ...],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.input_shape = tuple(input_shape)
        self.dtype = compute_dtype(dtype)
        self.specs = tuple(specs)
        for spec in self.specs:
            owner = self
            for name in spec.scope:
                if not hasattr(owner, name):
                    owner.add_module(name, nn.Module())
                owner = getattr(owner, name)
            owner.register_parameter(spec.name, nn.Parameter(
                torch.zeros(spec.shape), requires_grad=False))

    def p(self, path: str) -> torch.Tensor:
        """The parameter at the dotted scope path ('Conv_0.kernel'), as
        `functional_call` has set it."""
        owner = self
        for name in path.split("."):
            owner = getattr(owner, name)
        return owner

    def w(self, path: str) -> torch.Tensor:
        """`p(path)` cast to the compute dtype (flax's `dtype=`: the
        parameters stay float32, a layer computes in `dtype`)."""
        return self.p(path).to(self.dtype)

    def init_params(self, seed: int = 0,
                    device: torch.device | str = "cpu") -> Params:
        tree = init_tree(seed, self.specs)
        return {keystr(".".join(path)): torch.as_tensor(v, device=device)
                for path, v in tree.items()}

    def apply_stacked(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if not xla_cpu_order(x):
            return self.apply_vmapped(params, x)
        return torch.stack([self.apply({k: v[g] for k, v in params.items()},
                                       x[g]) for g in range(x.shape[0])])

    def apply_vmapped(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """`apply_stacked` as one vmapped pass (the card's route)."""
        return torch.func.vmap(self.apply)(params, x)


def dense_specs(scope: Tuple[str, ...], n_in: int, n_out: int,
                use_bias: bool = True) -> list:
    specs = [ParamSpec(scope, "kernel", (n_in, n_out), "lecun_normal", 1)]
    if use_bias:
        specs.append(ParamSpec(scope, "bias", (n_out,), "zeros", 2))
    return specs


def conv_specs(scope: Tuple[str, ...], k: int, n_in: int, n_out: int,
               use_bias: bool = True) -> list:
    specs = [ParamSpec(scope, "kernel", (k, k, n_in, n_out), "lecun_normal",
                       1)]
    if use_bias:
        specs.append(ParamSpec(scope, "bias", (n_out,), "zeros", 2))
    return specs


def group_norm_specs(scope: Tuple[str, ...], channels: int) -> list:
    return [ParamSpec(scope, "scale", (channels,), "ones", 1),
            ParamSpec(scope, "bias", (channels,), "zeros", 2)]


def pooled(size: int, times: int) -> int:
    """A spatial size after `times` VALID 2x2 stride-2 pools."""
    for _ in range(times):
        size //= 2
    return size
