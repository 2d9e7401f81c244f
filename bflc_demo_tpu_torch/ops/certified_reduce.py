"""The certified weighted sum (REDUCTION SPEC v2 steps 3-4): kernel B5.

Replaces the reference's XLA reduction programs,
`bflc_demo_tpu/meshagg/engine.py:MeshAggEngine._program` (:260-304) and
`_blocked_program` (:316-354): over an (N, P) matrix of flattened deltas,
per element,

    acc = +0.0
    for i in ascending slot order:
        t_i = gate_i ? daz(daz(d_i) * daz(c_i)) : +0.0
        acc = daz(acc + t_i)

with the bytes of `meshagg/spec.py:host_weighted_sum`, the normative host
leg.  `certified_reduce` launches the hand-written CUDA kernel
(`csrc/certified_reduce.cu`) on CUDA tensors and runs
`certified_reduce_plain` on CPU tensors; a CUDA tensor the kernel cannot
take raises.  `LAUNCHES["certified_reduce"]` counts kernel launches.

Both versions state the host's float32 rules explicitly, so they give
the host's bytes on either device:
- `daz` flushes a subnormal to the zero of its sign (`spec._daz`);
- a NaN result carries an operand's NaN, quieted — the second operand's
  when both are NaN, as numpy's vector loops and torch do on x86 — and an
  invalid operation (inf + -inf, 0 * inf) gives x86's default NaN
  0xFFC00000; the CUDA cores would give 0x7FFFFFFF for both.
numpy's own loops of 16 elements or fewer return the FIRST operand's NaN
when both are NaN, so on such short leaves two NaN deltas selected into
one element make the host leg's bytes depend on the leaf's length; with
one NaN (or inf) per element, and finite weights, every leg agrees.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MIN_NORMAL = float(np.float32(1.1754944e-38))      # spec.MIN_NORMAL
DEFAULT_NAN = -4194304                              # 0xFFC00000 as int32
QUIET_BIT = 0x00400000

# kernel launches since the last reset (plain runs excluded)
LAUNCHES = {"certified_reduce": 0}


def reset_launches() -> None:
    LAUNCHES["certified_reduce"] = 0


def _quiet(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) | QUIET_BIT).view(torch.float32)


def _host_nan(a: torch.Tensor, b: torch.Tensor,
              r: torch.Tensor) -> torch.Tensor:
    """The host's result of ``a op b`` whose IEEE value here is r."""
    default = torch.tensor(DEFAULT_NAN, dtype=torch.int32,
                           device=r.device).view(torch.float32)
    r = torch.where(torch.isnan(r), default, r)
    r = torch.where(torch.isnan(a), _quiet(a), r)
    return torch.where(torch.isnan(b), _quiet(b), r)


def daz(x: torch.Tensor) -> torch.Tensor:
    """`spec._daz`: subnormal -> signed zero; NaN quieted; else x."""
    flushed = torch.where(x.abs() >= MIN_NORMAL, x,
                          torch.copysign(torch.zeros_like(x), x))
    return torch.where(torch.isnan(x), _quiet(x), flushed)


def certified_reduce_plain(mat: torch.Tensor, coeffs: torch.Tensor,
                           gates: torch.Tensor) -> torch.Tensor:
    """(P,) accumulators of the (N, P) float32 `mat`: the spec's loop in
    float32 tensor ops, one slot after another."""
    c = daz(coeffs)
    acc = torch.zeros(mat.shape[1], dtype=torch.float32, device=mat.device)
    zero = torch.zeros((), dtype=torch.float32, device=mat.device)
    for i, selected in enumerate(gates.tolist()):
        if selected:
            d = daz(mat[i])
            t = daz(_host_nan(d, c[i], d * c[i]))
        else:
            t = zero                       # the masked +0.0 (spec step 4)
        acc = daz(_host_nan(acc, t, acc + t))
    return acc


# ------------------------------------------------------------------ kernel
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, _P, _P,
             _P, _P]


def _entry():
    from bflc_demo_tpu_torch.ops.build import load
    fn = load("certified_reduce").bflc_certified_reduce
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(mat: torch.Tensor, coeffs: torch.Tensor,
           gates: torch.Tensor) -> None:
    if mat.dtype != torch.float32 or mat.ndim != 2:
        raise ValueError(f"mat must be (N, P) float32, got {mat.dtype} "
                         f"{tuple(mat.shape)}")
    n = mat.shape[0]
    if coeffs.dtype != torch.float32 or tuple(coeffs.shape) != (n,):
        raise ValueError(f"coeffs must be ({n},) float32")
    if gates.dtype != torch.bool or tuple(gates.shape) != (n,):
        raise ValueError(f"gates must be ({n},) bool")
    if len({mat.device, coeffs.device, gates.device}) != 1:
        raise ValueError("mat, coeffs and gates lie on different devices")
    if mat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mat.device}")


def certified_reduce(mat: torch.Tensor, coeffs: torch.Tensor,
                     gates: torch.Tensor) -> torch.Tensor:
    """(P,) float32 accumulators of spec steps 3-4 over `mat` (N, P):
    `coeffs` (N,) float32 are the merge coefficients
    (`spec.merge_coefficients`), `gates` (N,) bool the selected slots.
    A CUDA `mat` may be a column block of a wider matrix (rows need not
    be adjacent, but each row's elements must be)."""
    _check(mat, coeffs, gates)
    if not mat.is_cuda:
        return certified_reduce_plain(mat, coeffs, gates)
    if mat.stride(1) != 1 and mat.shape[1] > 1:
        raise ValueError("each row of mat must be contiguous")
    n, p = mat.shape
    coeffs, gates = coeffs.contiguous(), gates.contiguous()
    out = torch.empty(p, dtype=torch.float32, device=mat.device)
    err = _entry()(mat.data_ptr(), mat.stride(0), n, p, coeffs.data_ptr(),
                   gates.data_ptr(), out.data_ptr(),
                   torch.cuda.current_stream(mat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bflc_certified_reduce: CUDA error {err} at "
                           f"launch")
    LAUNCHES["certified_reduce"] += 1
    return out
