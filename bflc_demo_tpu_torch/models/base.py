"""The model contract the port's protocol code builds against.

Port of `bflc_demo_tpu/models/base.py`.  The reference's model is a pytree
of parameters plus a pure `apply(params, x)`; every protocol layer (local
training, candidate scoring, aggregation, hashing) moves parameter values,
never a model object.  The port keeps that shape with PyTorch idiom: a
model is an `nn.Module` whose parameter names mirror the reference's tree
(`blocks.0.wq` <-> `['blocks'][0]['wq']`), and the values the protocol
moves are flat `{keystr: tensor}` dicts — `Params` — keyed by the
reference's `jax.tree_util.keystr` paths, so the content hash of a port
model equals the reference's for the same values.  `apply` runs the
module on such a dict through `torch.func.functional_call`;
`apply_stacked` runs G models of the same architecture in one pass (the
mesh round's stacked clients and candidates).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]

# the reference's `dtype` knob takes these two (by torch dtype or name)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """`dtype` (a torch dtype, or a name such as "bfloat16" or
    "torch.bfloat16") as float32 or bfloat16; another raises
    ValueError."""
    name = str(dtype).replace("torch.", "")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    return COMPUTE_DTYPES[name]


def numpy_to_tensor(arr: np.ndarray, device: torch.device | str = "cpu"
                    ) -> torch.Tensor:
    """A tensor of `arr`'s values and dtype; a bfloat16 array (ml_dtypes'
    or `utils.codecs.BF16`) becomes a bfloat16 tensor, bit for bit."""
    from bflc_demo_tpu_torch.utils.codecs import is_bf16
    arr = np.ascontiguousarray(arr)
    if is_bf16(arr.dtype):
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(np.array(arr), device=device)


def keystr(name: str) -> str:
    """Module parameter name -> the reference's keystr path:
    'blocks.0.ln1.scale' -> "['blocks'][0]['ln1']['scale']"."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def canonical_params(module: nn.Module) -> Params:
    """The module's own parameters as a keystr-keyed `Params` dict."""
    return {keystr(n): p.detach() for n, p in module.named_parameters()}


def _flatten_tree(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) pairs of a nested dict/tuple tree of arrays."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten_tree(sub, f"{prefix}['{key}']")
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from _flatten_tree(sub, f"{prefix}[{i}]")
    else:
        yield prefix, tree


class Model(nn.Module):
    """An `nn.Module` whose parameter values travel as `Params` dicts."""

    num_classes: int

    def init_params(self, seed: int = 0,
                    device: torch.device | str = "cpu") -> Params:
        """Fresh parameter values from `seed`: the values the reference's
        `init(PRNGKey(seed))` draws."""
        raise NotImplementedError

    def apply(self, params: Params, x: torch.Tensor,
              **kwargs) -> torch.Tensor:
        """Logits of the model with parameter values `params` on `x`;
        `kwargs` go to `forward`."""
        names = {keystr(n): n for n, _ in self.named_parameters()}
        return torch.func.functional_call(
            self, {names[k]: v for k, v in params.items()}, (x,), kwargs,
            strict=True)

    def apply_stacked(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits (G, B, classes) of G models at once: every leaf of
        `params` carries a leading model axis G and `x` is (G, B, ...) —
        the reference's `vmap(apply)` written out as a batch dimension
        (`torch.func.vmap` cannot batch through the kernels' ctypes
        launches)."""
        raise NotImplementedError

    def params_from_jax(self, tree: Any,
                        device: torch.device | str = "cpu") -> Params:
        """The reference's params (nested dicts and tuples of arrays, as
        numpy) as a `Params` dict on `device`: float32, or bfloat16 where
        the reference's leaf is.  Keys and shapes must match this
        module's exactly."""
        want = {k: tuple(p.shape) for k, p in
                canonical_params(self).items()}
        got = {k: np.asarray(v) for k, v in _flatten_tree(tree)}
        got = {k: a if a.dtype.name == "bfloat16" else a.astype(np.float32)
               for k, a in got.items()}
        if set(got) != set(want):
            raise KeyError(f"parameter trees differ: missing "
                           f"{sorted(set(want) - set(got))}, extra "
                           f"{sorted(set(got) - set(want))}")
        for k, arr in got.items():
            if arr.shape != want[k]:
                raise ValueError(f"{k}: shape {arr.shape} != {want[k]}")
        return {k: numpy_to_tensor(arr, device) for k, arr in got.items()}
