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
`launch_shape` picks the kernel's columns a CTA and its copy width from
the geometry; `chain_latency` times one slot of the kernel's dependent
chain, the floor under every column.

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
_ARGTYPES = {
    "bflc_certified_reduce": [_P, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_longlong, _P, _P, _P, ctypes.c_int,
                              ctypes.c_int, _P],
    "bflc_certified_chain": [ctypes.c_longlong, _P, _P, _P],
}
# Routes: the column kernel (COLUMN_ROUTE, one thread a column) where the
# matrix has COLUMN_MAX_SLOTS slots or fewer and a 256-column CTA for
# every SM (the writer merges); else strips of STRIP_COLUMNS columns a
# CTA, the widest that gives every SM 2 CTAs (4 where the chain is longer
# than LONG_CHAIN slots, so that more chains walk at once), 8 at the
# narrowest (the drains: 32 and 16, and 8 for their blocks).  Times by
# route: PERF.md, from chip_smoke.py.
COLUMN_ROUTE = 0
COLUMN_THREADS = 256
COLUMN_MAX_SLOTS = 32
STRIP_COLUMNS = (32, 16, 8)
LONG_CHAIN = 64
TILE_FLOATS = 2048       # one pipeline stage: TILE_FLOATS / cols slots
_SMS = {}


def _entry(name: str = "bflc_certified_reduce"):
    from bflc_demo_tpu_torch.ops.build import load
    fn = getattr(load("certified_reduce"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def launch_shape(n: int, p: int, aligned: bool, sms: int) -> tuple:
    """(columns a CTA or COLUMN_ROUTE, floats a copy) of the kernel over an
    (n, p) matrix on a card of `sms` SMs.  The strips' copies are 16
    bytes where the base and the row stride are 16-byte aligned
    (`aligned`), else 4."""
    if n <= COLUMN_MAX_SLOTS and -(-p // COLUMN_THREADS) >= sms:
        return COLUMN_ROUTE, 1
    ctas = (4 if n > LONG_CHAIN else 2) * sms
    cols = next((c for c in STRIP_COLUMNS if -(-p // c) >= ctas),
                STRIP_COLUMNS[-1])
    return cols, 4 if aligned else 1


def aligned16(mat: torch.Tensor) -> bool:
    """Whether every row of `mat` starts on 16 bytes: the strips' 16-byte
    copies need it."""
    return mat.data_ptr() % 16 == 0 and mat.stride(0) % 4 == 0


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
    return _launch(mat, coeffs, gates,
                   *launch_shape(n, p, aligned16(mat), _sm_count(mat.device)))


def _launch(mat: torch.Tensor, coeffs: torch.Tensor, gates: torch.Tensor,
            cols: int, vec: int) -> torch.Tensor:
    """One launch of the kernel over the checked CUDA `mat`: the column
    kernel (`cols` = COLUMN_ROUTE) or strips of `cols` columns a CTA
    (STRIP_COLUMNS) with `vec`-float copies (4 needs `aligned16`)."""
    if vec == 4 and not aligned16(mat):
        raise ValueError("16-byte copies need a 16-byte aligned base and "
                         "row stride")
    n, p = mat.shape
    coeffs, gates = coeffs.contiguous(), gates.contiguous()
    out = torch.empty(p, dtype=torch.float32, device=mat.device)
    err = _entry()(mat.data_ptr(), mat.stride(0), n, p, coeffs.data_ptr(),
                   gates.data_ptr(), out.data_ptr(), cols, vec,
                   torch.cuda.current_stream(mat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bflc_certified_reduce: CUDA error {err} at "
                           f"launch")
    LAUNCHES["certified_reduce"] += 1
    return out


def chain_latency(steps: int, device) -> tuple:
    """(ms, clock cycles) per slot of one thread's walk on the card (one
    dependent __fadd_rn, its terms loaded ahead) over `steps` slots, a
    multiple of 64: times N, the least time one column of N slots can
    take."""
    out = torch.empty(1, dtype=torch.float32, device=device)
    cycles = torch.empty(1, dtype=torch.int64, device=device)
    fn = _entry("bflc_certified_chain")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    for _ in range(2):                 # the first launch loads the module
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        if fn(steps, out.data_ptr(), cycles.data_ptr(), stream) != 0:
            raise RuntimeError("bflc_certified_chain: CUDA error at launch")
        stop.record()
        stop.synchronize()
    return start.elapsed_time(stop) / steps, float(cycles.item()) / steps
