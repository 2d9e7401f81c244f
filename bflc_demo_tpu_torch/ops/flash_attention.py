"""Masked flash attention: CUDA kernels, their plain versions, autograd.

Port of `bflc_demo_tpu/ops/pallas_attention.py:flash_attention` (:409-430)
and the four Pallas kernels of that file:

- `flash_fwd`  <- `_flash_kernel` via `_flash_fwd_impl` (:42-150):
  (out, lse) with an online softmax over k-tiles;
- `flash_dkdv` <- `_dkdv_kernel` via `_flash_bwd_impl` (:153-193, :257);
- `flash_dq`   <- `_dq_kernel` via `_flash_bwd_impl` (:196-224, :286);
- `flash_carry` <- `_flash_carry_kernel` via `flash_attention_carry`
  (:300-399): one ring-attention hop, the online softmax resumed from an
  (acc, m, l) carry and returned unnormalised.  The reference has no
  backward kernel for it (ring attention's backward recomputes with the
  einsum ring), so neither has the port.

Each wrapper runs its hand-written CUDA kernel (`csrc/flash_attention.cu`)
on a CUDA tensor and its plain PyTorch version on a CPU tensor — the
choice follows the tensor's device only, and a CUDA tensor the kernel
cannot take raises instead of falling back.  `LAUNCHES` counts kernel
launches per wrapper (plain runs do not count), so a run can show that
its main path went through the kernels.  All four kernels run their
products on the tensor cores (3xTF32 for float32, at float32's
accuracy); `block_warps` picks their block size from the shape
(`launch_warps` says which rows each kernel's warps own).

Layouts follow the reference: q/k/v/out and their gradients are
(B, S, H, D); `kv_mask` is (B, S_kv) bool (False = PAD); lse and delta
are (B*H, 1, S_q) float32.  `delta = rowsum(dO * O)` stays plain torch,
as the reference computes it outside its kernels (:244-245).  The carry
is acc (B*H, S_q, D) and m, l (B*H, 1, S_q), all float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

NEG_INF = -1e30
TINY = 1e-30
HEAD_DIMS = (16, 32, 64, 128)
KERNEL_TILE = 64        # rows per streamed tile (keys; queries for dK/dV)
WARP_ROWS = 16          # output rows per warp (queries; keys for dK/dV)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per wrapper since the last reset (plain runs excluded)
LAUNCHES = {"flash_fwd": 0, "flash_dkdv": 0, "flash_dq": 0,
            "flash_carry": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scale(d: int) -> float:
    # the reference multiplies f32 logits by 1/sqrt(d), a float32 constant
    return float(np.float32(1.0 / np.sqrt(d)))


# ------------------------------------------------------------ plain versions
def _logits(q, k, kv_mask, scale):
    """f32 (B, H, S_q, S_kv) logits and the broadcast key mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return s, kv_mask[:, None, None, :]


def flash_fwd_plain(q, k, v, kv_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, S_q, H, D) in q's dtype, lse (B*H, 1, S_q) f32)."""
    b, sq, h, d = q.shape
    s, valid = _logits(q, k, kv_mask, _scale(d))
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)    # NEG_INF-NEG_INF guard
    l = p.sum(-1, keepdim=True).clamp_min(TINY)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b * h, 1, sq)
    return out, lse


def _probs_and_ds(q, k, v, kv_mask, do, lse, delta):
    b, sq, h, d = q.shape
    scale = _scale(d)
    s, valid = _logits(q, k, kv_mask, scale)
    lse = lse.reshape(b, h, sq, 1)
    # selected, never multiplied: exp(s - lse) may be inf on a fully
    # masked row, and inf * 0 would be NaN
    p = torch.where(valid, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    return p, ds


def flash_dkdv_plain(q, k, v, kv_mask, do, lse, delta):
    """(dK, dV), each (B, S_kv, H, D) in k's / v's dtype."""
    p, ds = _probs_and_ds(q, k, v, kv_mask, do, lse, delta)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_plain(q, k, v, kv_mask, do, lse, delta):
    """dQ, (B, S_q, H, D) in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, kv_mask, do, lse, delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_carry_plain(q, k, v, kv_mask, acc, m, l):
    """One hop resumed from the carry: the updated (acc, m, l), f32 and
    unnormalised.  Masked probabilities are selected to 0 (a fully masked
    hop leaves m at NEG_INF, where exp(s - m) would be 1), and p is
    rounded to v's dtype before the PV product, as the kernel does."""
    b, sq, h, d = q.shape
    s, valid = _logits(q, k, kv_mask, _scale(d))
    s = torch.where(valid, s, NEG_INF)
    m = m.reshape(b, h, sq)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l.reshape(b, h, sq) * corr + p.sum(-1)
    acc_new = acc.reshape(b, h, sq, d) * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc_new.reshape(b * h, sq, d), m_new.reshape(b * h, 1, sq),
            l_new.reshape(b * h, 1, sq))


# ------------------------------------------------------------------ kernels
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "bflc_flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, ctypes.c_float, _I, _P],
    "bflc_flash_dkdv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, ctypes.c_float, _I, _P],
    "bflc_flash_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, ctypes.c_float, _I, _P],
    "bflc_flash_carry": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, ctypes.c_float, _I, _P],
}


def _entry(name: str):
    """The C entry `name` of the built library (built on first use)."""
    from bflc_demo_tpu_torch.ops.build import load
    fn = getattr(load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, counter: str, *args) -> None:
    err = _entry(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[counter] += 1


def _check_inputs(q, k, v, kv_mask, *more) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q/k/v must be (B, S, H, D) with matching B, H, "
                         f"D: {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if tuple(kv_mask.shape) != (k.shape[0], k.shape[1]) \
            or kv_mask.dtype != torch.bool:
        raise ValueError(f"kv_mask must be bool (B, S_kv), got "
                         f"{kv_mask.dtype} {tuple(kv_mask.shape)}")
    tensors = (q, k, v, kv_mask) + more
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash attention inputs lie on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.is_cuda:
        if q.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"the kernels take head dims {HEAD_DIMS}, got "
                             f"{q.shape[-1]}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the kernels read contiguous tensors")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the kernels copy q/k/v in 16-byte pieces: "
                             "their storage must start 16-byte aligned")


def _check_bwd(q, do, lse, delta) -> None:
    """dO, lse and delta of a backward call.  The dK/dV kernel stages lse
    and delta by cp.async only where a tile's slice is 16-byte aligned
    and takes plain loads elsewhere, so only dO's storage has to be
    aligned."""
    b, sq, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q: {do.dtype} {tuple(do.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b * h, 1, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (B*H, 1, S_q), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if do.is_cuda and do.data_ptr() % 16:
        raise ValueError("the kernels copy dO in 16-byte pieces: its "
                         "storage must start 16-byte aligned")


def _check_carry(q, acc, m, l) -> None:
    b, sq, h, d = q.shape
    want = {"acc": (b * h, sq, d), "m": (b * h, 1, sq), "l": (b * h, 1, sq)}
    for name, t in (("acc", acc), ("m", m), ("l", l)):
        if tuple(t.shape) != want[name] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {want[name]}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if acc.is_cuda and acc.data_ptr() % 8:
        raise ValueError("the carry kernel reads acc in 8-byte pieces: its "
                         "storage must start 8-byte aligned")


def _check_blocks(s_q: int, s_kv: int, block_q: int, block_k: int) -> None:
    if s_q % block_q or s_kv % block_k:
        raise ValueError(f"seq lens ({s_q}, {s_kv}) must divide blocks "
                         f"({block_q}, {block_k})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def block_warps(batch_heads: int, rows: int, sms: int) -> int:
    """Warps a block of the kernels, each warp owning WARP_ROWS of the
    `rows` output rows of every (batch, head): the most of 4, 2, 1 whose
    grid, batch_heads x ceil(rows / (16 x warps)) blocks, still gives
    each of the card's `sms` multiprocessors a block; 1 where none does.
    More warps share each staged tile; fewer give a small batch more
    blocks."""
    for warps in (4, 2):
        if batch_heads * -(-rows // (WARP_ROWS * warps)) >= sms:
            return warps
    return 1


def launch_warps(kernel: str, q_shape, s_kv: int, sms: int) -> int:
    """`block_warps` of `kernel` (a LAUNCHES key) for q of `q_shape`
    (B, S_q, H, D) and S_kv keys: the dK/dV kernel's warps own keys,
    the others' own queries."""
    b, s_q, h, _ = q_shape
    return block_warps(b * h, s_kv if kernel == "flash_dkdv" else s_q, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _warps(kernel: str, q: torch.Tensor, s_kv: int) -> int:
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    return launch_warps(kernel, q.shape, s_kv, _sm_count(index))


def flash_fwd(q, k, v, kv_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (out (B, S_q, H, D), lse (B*H, 1, S_q) f32)."""
    _check_inputs(q, k, v, kv_mask)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, kv_mask)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, 1, sq), dtype=torch.float32, device=q.device)
    _launch("bflc_flash_fwd", "flash_fwd", _DTYPE_CODE[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], h,
            _scale(d), _warps("flash_fwd", q, k.shape[1]), _stream(q))
    return out, lse


def flash_dkdv(q, k, v, kv_mask, do, lse, delta):
    """dK/dV: (dK, dV), each (B, S_kv, H, D)."""
    _check_inputs(q, k, v, kv_mask, do, lse, delta)
    _check_bwd(q, do, lse, delta)
    if not q.is_cuda:
        return flash_dkdv_plain(q, k, v, kv_mask, do, lse, delta)
    b, sq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bflc_flash_dkdv", "flash_dkdv", _DTYPE_CODE[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, sq, k.shape[1], h, _scale(d),
            _warps("flash_dkdv", q, k.shape[1]), _stream(q))
    return dk, dv


def flash_dq(q, k, v, kv_mask, do, lse, delta):
    """dQ: (B, S_q, H, D)."""
    _check_inputs(q, k, v, kv_mask, do, lse, delta)
    _check_bwd(q, do, lse, delta)
    if not q.is_cuda:
        return flash_dq_plain(q, k, v, kv_mask, do, lse, delta)
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    _launch("bflc_flash_dq", "flash_dq", _DTYPE_CODE[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, sq, k.shape[1], h, _scale(d),
            _warps("flash_dq", q, k.shape[1]), _stream(q))
    return dq


def flash_carry(q, k, v, kv_mask, acc, m, l):
    """One ring hop: the carry (acc, m, l) updated over this KV block,
    unnormalised, in new tensors.  On a CUDA tensor both sequence lengths
    must be multiples of 64 (the kernel's key tile)."""
    _check_inputs(q, k, v, kv_mask, acc, m, l)
    _check_carry(q, acc, m, l)
    if not q.is_cuda:
        return flash_carry_plain(q, k, v, kv_mask, acc, m, l)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if sq % KERNEL_TILE or skv % KERNEL_TILE:
        raise ValueError(f"the carry kernel takes sequence lengths that are "
                         f"multiples of {KERNEL_TILE}, got ({sq}, {skv})")
    acc_out, m_out, l_out = (torch.empty_like(t) for t in (acc, m, l))
    _launch("bflc_flash_carry", "flash_carry", _DTYPE_CODE[q.dtype], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), acc_out.data_ptr(),
            m_out.data_ptr(), l_out.data_ptr(), b, sq, skv, h, _scale(d),
            _warps("flash_carry", q, skv), _stream(q))
    return acc_out, m_out, l_out


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, laid out (B*H, 1, S_q) like lse."""
    b, sq, h, _ = do.shape
    rows = (do.float() * out.float()).sum(-1)             # (B, S_q, H)
    return rows.permute(0, 2, 1).reshape(b * h, 1, sq).contiguous()


class FlashAttention(torch.autograd.Function):
    """The reference's `custom_vjp`: the forward keeps (q, k, v, mask,
    out, lse); the backward recomputes probabilities from lse tile by
    tile in the dK/dV and dQ kernels."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, block_q: int, block_k: int):
        _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
        out, lse = flash_fwd(q, k, v, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        do = g.contiguous()
        delta = attention_delta(do, out)
        dk, dv = flash_dkdv(q, k, v, kv_mask, do, lse, delta)
        dq = flash_dq(q, k, v, kv_mask, do, lse, delta)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_mask, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Masked flash attention.  q/k/v: (B, S, H, D); kv_mask: (B, S_kv)
    bool (False = PAD).  Returns (B, S_q, H, D).  The blocks must divide
    the sequence lengths (ValueError otherwise), as in the reference; the
    CUDA kernels keep their own tiles (64 streamed rows; 16-64 output rows
    a block) whatever they are, since the blocks do not change the
    function."""
    return FlashAttention.apply(q, k, v, kv_mask, block_q, block_k)
