#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, `bflc_demo_tpu_torch`.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports no JAX and nothing of the JAX package.  Phases, one JSON line
each; any failure raises and exits non-zero:

1. build   — compile every kernel from the sources in this checkout
             (one nvcc per source, started together);
2. device  — the card's name and power limit, as nvidia-smi reports them;
3. compare — each kernel against its plain PyTorch version on the same
             card tensors, float32 and bfloat16, at the transformer's
             training and scoring shapes, at a multi-tile shape (S = 256)
             with ragged padding and one fully masked 64-key tile, at
             a batch of 32 and at the mesh round's stacked shapes
             (320 and 6400 rows) — between them the 1-, 2- and 4-warp
             blocks of the forward, dK/dV and dQ kernels;
4. timing  — each kernel, its plain version and one PyTorch call as the
             yardstick (the forward: scaled_dot_product_attention; the
             dK/dV + dQ pair: SDPA's backward, which computes all three),
             at the training shape, and the forward also at the
             committee's score shape (B = 160), and all three at the mesh
             round's shapes (training 320, scoring 6400, sponsor 800);
             device time per call from CUDA-graph replays between CUDA
             events (warmup, then the median of several repeats), beside
             the bound, its share and TFLOP/s;
5. slice   — the config-5 federated round on the host runtime, full width,
             5 rounds (the preset's own count) on `cuda`, with the launch
             counts reset just before and read just after; then the
             final model's logits on the card against the CPU path on a
             small input; and the decisions of the model after round 2
             (from a second, 2-round run) and of the final one
             (accuracies of the sponsor's test set and of every client's
             shard) against the CPU path's on the same params;
   mesh    — the same preset on the mesh runtime (one device round per
             protocol round: 20 clients in lockstep, one stacked scoring
             pass, payload ids by the fingerprint kernel), 5 rounds, launch
             counts reset just before and read just after and held to
             K1 24, K2 20, K3 20 and fingerprint 2 a round; the decisions
             of its final model against the CPU path's; then config 1 —
             the CLI's default — for 10 rounds on the mesh runtime and 10
             on the host runtime (round times of both), its final model
             against the CPU path;
   fingerprint — the fingerprint kernel against its plain version on the
             card, bit for bit (float32, bfloat16, float16, int8, bool and
             int32 leaves, a ragged leaf, config 5's 20 stacked deltas and
             a config-1 model); its time at config 5's 20 deltas and one
             model beside the bytes bound and the chain bound (the
             measured latency of one dependent multiply-xor times the
             steps of a lane's chain);
6. compare — the ring's carry kernel (`flash_carry`) against its plain
             version over two chained hops, float32 and bfloat16, at
             S = 256 (ragged keys, one fully masked 64-key tile) and at
             the sp training shard (folded batch 32, S = 1024);
7. timing  — `flash_carry` and its plain version at that shard; beside
             it, on the same (4, 8192, 4, 32) sequence, the 8-hop ring
             forward, the flash forward unsharded (a timing row of its
             own) and PyTorch's SDPA; and on that sequence the dK/dV and
             dQ kernels, their plain versions and the pair beside SDPA's
             backward (the sp path's dense oracle runs them there);
8. sp      — the sequence-parallel transformer at config 5's width on
             the folded axis (8 shards), launch counts reset just before
             and read just after: 3 SGD steps at seq 8192 (batch 4) and a
             forward at seq 32768 (batch 2); then the 32k logits against
             the dense forward (flash forward kernel) and the first 8k
             step against one dense SGD step (flash kernels forward and
             backward);
9. merge   — the certified merge engine (`meshagg`), kernel B5: B5
             against its plain version and the numpy spec (REDUCTION
             SPEC v2's host leg), byte for byte, on every corner case of
             the CPU tests (blocks 1, 2, 5, 8, 64) and at the merge
             geometries (config 5's and config 4's writer merges, the
             reference benchmark's full drains of 64, 256 and 1024
             deltas; blocks 1 and 8); then, between a reset and a read of
             the launch counts, the engine's `aggregate_rows` once per
             geometry and block count (one launch per block per call; its
             bytes against the host leg's) and
             `python -m bflc_demo_tpu_torch.meshagg.check --device cuda`
             in-process; then B5's time per call beside its bytes bound,
             its chain bound (N times one slot's dependent step, timed
             by a one-thread chain kernel), its plain version and
             `c @ mat` (one PyTorch call for the same weighted sum, not
             bit-exact), and `aggregate_rows` end to end with its
             host-to-device staging.

Then the `kernels` line and, last, {"ok": true, "device": {...}}.
Without a card, or without the package beside it, it exits non-zero and
prints no result.

    python3 chip_smoke.py --backward-timing DIR

runs only the dK/dV and dQ timing rows (phase 4's and phase 7's) for the
package of the checkout at DIR — another version's, unpacked beside this
one, so that two versions are timed on one card in one call.

    python3 chip_smoke.py --merge-timing DIR

runs only B5's timing rows (phase 9's: every merge geometry at blocks 1
and 8, beside the bytes bound, the chain bound where DIR's package has
the chain kernel, and `c @ mat`) for the package of the checkout at DIR,
the same way.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet; dense rates).
# float32 products at float32's accuracy have two routes: the CUDA cores
# (67 TFLOP/s) or 3xTF32 on the tensor cores (three TF32 products each,
# 495 / 3 = 165 TFLOP/s; TF32 alone is not float32-accurate).  The bound
# names the faster; rows keep the CUDA-core bound beside it.
HBM_BYTES_PER_S = 3.35e12
F32_CUDA_CORE_OPS = 67e12
PEAK_OPS = {"float32": max(F32_CUDA_CORE_OPS, 495e12 / 3),
            "bfloat16": 989e12}

TRAIN_SHAPE = (16, 64, 4, 32)        # config-5 trainer batch: B, S, H, D
SCORE_SHAPE = (160, 64, 4, 32)       # config-5 committee scoring batch
MULTI_SHAPE = (4, 256, 4, 32)        # several 64-tiles each way
PAIR_SHAPE = (32, 64, 4, 32)         # the forward's two-warp blocks
MESH_TRAIN_SHAPE = (320, 64, 4, 32)  # mesh round: 20 clients x batch 16
MESH_SCORE_SHAPE = (6400, 64, 4, 32)  # 4 scorers x 10 candidates x 160 rows
SPONSOR_SHAPE = (800, 64, 4, 32)     # the sponsor's test set
# every kernel's block geometry follows the shape (launch_warps): on an
# H100 the training batch and MULTI_SHAPE take one-warp blocks, PAIR_SHAPE
# two and the score (and sponsor) batch four, for the forward, dK/dV and
# dQ alike (S_kv = S_q); the compare phase covers each
DENSE_SHAPES = (TRAIN_SHAPE, MULTI_SHAPE, PAIR_SHAPE, SCORE_SHAPE,
                MESH_TRAIN_SHAPE, MESH_SCORE_SHAPE)
BIG_FEW = dict(calls=5, replays=2, repeats=5)   # device_ms at 6400 rows
SHARD_SHAPE = (32, 1024, 4, 32)      # sp training shard: 8 shards x B 4
RING_SHAPE = (4, 8192, 4, 32)        # the same sequence, unsharded
RING_FEW = dict(calls=2, replays=2, repeats=3)   # device_ms at RING_SHAPE
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # x max(1, max|plain|)
# config 5's preset runs 5 rounds (eval/configs.py), from the reference's
# initial model (`init_params(0)` draws jax.random's values).  On the CPU
# its best over 5 rounds is 0.9862 on the mesh runtime (the reference's
# own trajectory) and 0.9987 on the host runtime; the 0.9 limit stands.
# See PERF.md section 2.
ROUNDS = 5
MIN_BEST_ACC = 0.9
SP_RUNS = {"train": dict(seq_len=8192, n_sp=8, batch=4, steps=3, lr=0.05),
           "forward": dict(seq_len=32768, n_sp=8, batch=2, steps=0)}
# the sp logits vs the dense forward: the reference's own 8k oracle bound
# moved onto the card (tests/test_long_context.py:90-101), loosened for
# the card's summation orders
SP_LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)
# one sp step vs one dense step: new params within the reference's own
# 4k-step bound (tests/test_long_context.py:186-187); the gradients they
# imply, (old - new) / lr, within 1e-3 of each leaf's largest dense
# gradient — both sides are float32 and differ only in summation order
# (ring hops vs flash tiles, 8192-long reductions; 3.5e-5 measured on an
# H100), while a wrong assembly (a gradient missing a shard, or n_sp
# times too large) is off by O(1)
SP_STEP_TOL = dict(rtol=5e-4, atol=5e-5)
SP_GRAD_TOL = 1e-3
# the mesh round's launches per round on config 5 (depth 2): 10 minibatch
# steps of all 20 clients, each a forward (K1) and backward (K2, K3) per
# layer; one scoring pass of 40 models (K1 per layer); the sponsor's eval
# (K1 per layer); the ids of the 20 deltas and of the new model
MESH_PER_ROUND = {"flash_fwd": 24, "flash_dkdv": 20, "flash_dq": 20,
                  "flash_carry": 0, "fingerprint": 2, "certified_reduce": 0}
CONFIG1_ROUNDS = 10          # the CLI's default run
CONFIG1_MIN_BEST = {"csv": 0.90, "synthetic": 0.85}  # tests/test_e2e.py
# the fingerprint's operations are a 32-bit multiply and xor per word on
# the CUDA cores; 67e12 (their float32 rate) is an upper bound on that
INT_OPS = F32_CUDA_CORE_OPS

KERNELS = {
    "flash_fwd": "bflc_demo_tpu/ops/pallas_attention.py:42",
    "flash_dkdv": "bflc_demo_tpu/ops/pallas_attention.py:153",
    "flash_dq": "bflc_demo_tpu/ops/pallas_attention.py:196",
    "flash_carry": "bflc_demo_tpu/ops/pallas_attention.py:300",
    "fingerprint": "bflc_demo_tpu/ops/fingerprint.py:62",
    "certified_reduce": "bflc_demo_tpu/meshagg/engine.py:260",
}
DENSE_KERNELS = ("flash_fwd", "flash_dkdv", "flash_dq")
SOURCES = {name: "bflc_demo_tpu_torch/ops/csrc/flash_attention.cu"
           for name in KERNELS}
SOURCES["fingerprint"] = "bflc_demo_tpu_torch/ops/csrc/fingerprint.cu"
SOURCES["certified_reduce"] = \
    "bflc_demo_tpu_torch/ops/csrc/certified_reduce.cu"
# B5 at each merge geometry (meshagg/check.py GEOMETRIES): blocks 1 (spec
# v1) and 8, one launch per block; the timing row of the kernels line is
# config 5's writer merge at one block
MERGE_BLOCKS = (1, 8)
MERGE_MAIN = "config5_merge"


def reset_counts() -> None:
    """Every kernel's launch count to 0 (just before a path runs)."""
    from bflc_demo_tpu_torch.ops import (certified_reduce, fingerprint,
                                         flash_attention)
    for module in (flash_attention, fingerprint, certified_reduce):
        module.reset_launches()


def read_counts() -> dict:
    """Every kernel's launches since the last `reset_counts`."""
    from bflc_demo_tpu_torch.ops import (certified_reduce, fingerprint,
                                         flash_attention)
    return {**flash_attention.LAUNCHES, **fingerprint.LAUNCHES,
            **certified_reduce.LAUNCHES}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def attention_inputs(torch, shape, dtype, device, seed):
    """q/k/v/dO from a numpy seed; key mask with ragged lengths like the
    data's (at least half the sequence), and for S > 64 one fully masked
    64-key tile in batch row 0."""
    b, s, _, _ = shape
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.as_tensor(rng.standard_normal(shape)
                                  .astype(np.float32)).to(device, dtype)
                  for _ in range(4))
    lengths = rng.integers(s // 2, s + 1, b)
    mask = np.arange(s)[None, :] < lengths[:, None]
    if s > 64:
        mask[0, 64:128] = False
    return q, k, v, g, torch.as_tensor(mask).to(device)


def kernel_warps(torch, fa, name, shape) -> int:
    """Warps a block that kernel `name` runs at `shape` (S_kv = S_q)."""
    return fa.launch_warps(name, shape, shape[1],
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)


def compare_phase(torch, fa, device) -> dict:
    """Max abs error of each kernel vs plain on identical inputs, at
    shapes that reach each kernel's block geometries; the float32 errors
    at the training shape go into the kernels line."""
    for name in DENSE_KERNELS:
        warps = {kernel_warps(torch, fa, name, shape)
                 for shape in DENSE_SHAPES}
        if warps != {1, 2, 4}:
            raise RuntimeError(f"the compare shapes reach {name} blocks of "
                               f"{sorted(warps)} warps, not 1, 2 and 4")
    train_err = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in DENSE_SHAPES:
            q, k, v, g, mask = attention_inputs(torch, shape, dtype,
                                                device, seed=1)
            out, lse = fa.flash_fwd(q, k, v, mask)
            delta = fa.attention_delta(g, out)
            dk, dv = fa.flash_dkdv(q, k, v, mask, g, lse, delta)
            got = {"flash_fwd": (out, lse), "flash_dkdv": (dk, dv),
                   "flash_dq": (fa.flash_dq(q, k, v, mask, g, lse, delta),)}
            # the plain backward takes the kernel forward's out/lse, so
            # each backward kernel is held against plain on equal inputs
            want = {"flash_fwd": fa.flash_fwd_plain(q, k, v, mask),
                    "flash_dkdv": fa.flash_dkdv_plain(q, k, v, mask, g, lse,
                                                      delta),
                    "flash_dq": (fa.flash_dq_plain(q, k, v, mask, g, lse,
                                                   delta),)}
            torch.cuda.synchronize()
            for name in DENSE_KERNELS:
                err = scale = 0.0
                for a, b in zip(got[name], want[name]):
                    a, b = a.float(), b.float()
                    if not torch.isfinite(a).all():
                        raise RuntimeError(f"{name}: non-finite output")
                    err = max(err, float((a - b).abs().max()))
                    scale = max(scale, float(b.abs().max()))
                tol = TOL[dtype_name] * max(1.0, scale)
                emit("compare", kernel=name, dtype=dtype_name,
                     shape=list(shape),
                     warps=kernel_warps(torch, fa, name, shape),
                     max_abs_err=err, tol=tol, ok=err <= tol)
                if err > tol:
                    raise RuntimeError(f"{name} {dtype_name} {shape}: "
                                       f"max abs err {err} > {tol}")
                if dtype_name == "float32" and shape == TRAIN_SHAPE:
                    train_err[name] = err
    return train_err


def carry_err(torch, got, want) -> tuple:
    """(max abs err, scale) over acc, m and l.  m is NEG_INF (-1e30)
    exactly where no key was valid yet, in both versions alike, so those
    entries are left out of the scale (they would make it 1e30)."""
    err = scale = 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a).all():
            raise RuntimeError("flash_carry: non-finite output")
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b[b > -1e29].abs().max()))
    return err, scale


def zero_carry(torch, fa, shape, device) -> tuple:
    """The ring's initial (acc, m, l) for q of `shape` (B, S, H, D)."""
    b, s, h, d = shape
    return (torch.zeros((b * h, s, d), device=device),
            torch.full((b * h, 1, s), fa.NEG_INF, device=device),
            torch.zeros((b * h, 1, s), device=device))


def carry_compare_phase(torch, fa, device) -> float:
    """flash_carry vs flash_carry_plain over two chained hops: hop 2
    resumes from the kernel's hop-1 carry on both sides, and its keys are
    all PAD for the last batch row.  Returns the largest float32 error at
    the sp training shard."""
    shard_err = 0.0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in (MULTI_SHAPE, SHARD_SHAPE):
            q, k1, v1, _, m1 = attention_inputs(torch, shape, dtype, device,
                                                seed=3)
            _, k2, v2, _, m2 = attention_inputs(torch, shape, dtype, device,
                                                seed=4)
            m2[-1] = False
            carry = zero_carry(torch, fa, shape, device)
            for hop, (kb, vb, mb) in enumerate(((k1, v1, m1), (k2, v2, m2))):
                got = fa.flash_carry(q, kb, vb, mb, *carry)
                want = fa.flash_carry_plain(q, kb, vb, mb, *carry)
                torch.cuda.synchronize()
                err, scale = carry_err(torch, got, want)
                tol = TOL[dtype_name] * max(1.0, scale)
                emit("compare", kernel="flash_carry", dtype=dtype_name,
                     shape=list(shape),
                     warps=kernel_warps(torch, fa, "flash_carry", shape),
                     hop=hop + 1, max_abs_err=err, tol=tol, ok=err <= tol)
                if err > tol:
                    raise RuntimeError(f"flash_carry {dtype_name} {shape} "
                                       f"hop {hop + 1}: max abs err {err} "
                                       f"> {tol}")
                if dtype_name == "float32" and shape == SHARD_SHAPE:
                    shard_err = max(shard_err, err)
                carry = got
            del q, k1, v1, k2, v2, got, want, carry
    return shard_err


def device_ms(torch, fn, calls: int = 50, replays: int = 5,
              repeats: int = 7, stream=None) -> float:
    """Median device time of one `fn()` call: `calls` calls captured in a
    CUDA graph (no host launch overhead) on `stream` (default: the
    graph's own), replayed between CUDA events."""
    for _ in range(3):
        fn()                        # warm up: build, autotune, allocate
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / (replays * calls))
    return statistics.median(times)


def work(shape, mask, dtype_name: str, name: str) -> tuple:
    """(bytes, operations) of this call: each input read once and each
    output written once; the products over the keys this mask lets
    through."""
    b, s, h, d = shape
    esize = 4 if dtype_name == "float32" else 2
    tensor = b * s * h * d * esize
    rows = b * h * s * 4                     # one f32 per (b, h, q row)
    valid_keys = int(mask.sum())             # summed over the batch
    pairs = h * s * valid_keys               # (q row, valid key) per head
    carry = b * h * s * d * 4 + 2 * rows     # acc, m, l
    moved = {"flash_fwd": 4 * tensor + rows + b * s,      # q k v | out lse
             "flash_dkdv": 6 * tensor + 2 * rows + b * s,  # q k v dO | dk dv
             "flash_dq": 5 * tensor + 2 * rows + b * s,
             "flash_carry": 3 * tensor + 2 * carry + b * s,  # q k v c | c
             }[name]
    ops = {"flash_fwd": 4, "flash_dkdv": 8, "flash_dq": 6,
           "flash_carry": 4}[name] * pairs * d
    return moved, ops


def bound(shape, mask, dtype_name: str, name: str,
          peak_ops: float = None) -> tuple:
    """Least time (ms) the card needs for this call's work: bytes over
    HBM bandwidth vs. the products over the dtype's peak."""
    moved, ops = work(shape, mask, dtype_name, name)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (peak_ops or PEAK_OPS[dtype_name]) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def timing_row(shape, mask, dtype_name: str, name: str, ms: float,
               plain_ms, library_ms) -> dict:
    """A kernel's timing beside its bound: share_of_bound = bound / time,
    and the TFLOP/s its products reach; float32 rows also carry the bound
    on the CUDA cores alone (the route of the first forward body)."""
    bound_ms, bound_by = bound(shape, mask, dtype_name, name)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms,
           "tflops": work(shape, mask, dtype_name, name)[1] / ms / 1e9}
    if dtype_name == "float32":
        row["bound_ms_cuda_cores"] = bound(shape, mask, dtype_name, name,
                                           F32_CUDA_CORE_OPS)[0]
    return row


def sdpa_inputs(q, k, v, mask):
    """SDPA's (B, H, S, D) layout and a key mask broadcast over rows."""
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v)) + (
        mask[:, None, None, :],)


def sdpa_backward_ms(torch, q, k, v, g, mask, **few) -> float:
    """Device time of SDPA's backward, which computes dQ, dK and dV in
    one call, on these inputs.  The forward's graph is kept for the
    replays; autograd runs a backward on its forward's stream, so the
    forward runs on the stream that the replays are captured on."""
    import torch.nn.functional as F
    qt, kt, vt, attn_mask = sdpa_inputs(q, k, v, mask)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    gt = g.transpose(1, 2).contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask)
    torch.cuda.current_stream().wait_stream(side)
    return device_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), gt, retain_graph=True), stream=side, **few)


def backward_timing(torch, fa, device, shape, seed, **few) -> dict:
    """The dK/dV and dQ kernels at `shape` (float32), each beside its
    plain version, and the pair beside SDPA's backward.  No one PyTorch
    call computes dK/dV or dQ alone: those rows have no library time, and
    the pair's row (a line of its own, and `pair` on both rows) holds
    SDPA's backward."""
    q, k, v, g, mask = attention_inputs(torch, shape, torch.float32, device,
                                        seed)
    out, lse = fa.flash_fwd(q, k, v, mask)
    args = (q, k, v, mask, g, lse, fa.attention_delta(g, out))
    rows = {}
    for name in ("flash_dkdv", "flash_dq"):
        kernel, plain = getattr(fa, name), getattr(fa, name + "_plain")
        row = timing_row(shape, mask, "float32", name,
                         device_ms(torch, lambda: kernel(*args), **few),
                         device_ms(torch, lambda: plain(*args), **few), None)
        row["library"] = None
        emit("timing", kernel=name, shape=list(shape), dtype="float32",
             **row)
        rows[name] = row
    pair = {"kernels": list(rows),
            "ms": sum(row["ms"] for row in rows.values()),
            "plain_ms": sum(row["plain_ms"] for row in rows.values()),
            "library_ms": sdpa_backward_ms(torch, q, k, v, g, mask, **few),
            "library": "scaled_dot_product_attention backward (dQ, dK and "
                       "dV in one call)"}
    emit("timing", kernel="flash_dkdv+flash_dq", shape=list(shape),
         dtype="float32", **pair)
    for row in rows.values():
        row["pair"] = pair
    return rows


def forward_timing(torch, fa, device, shape, seed, **few) -> dict:
    """The forward kernel at `shape` (float32) beside its plain version
    and SDPA."""
    import torch.nn.functional as F
    q, k, v, _, mask = attention_inputs(torch, shape, torch.float32, device,
                                        seed)
    qt, kt, vt, attn_mask = sdpa_inputs(q, k, v, mask)
    row = timing_row(
        shape, mask, "float32", "flash_fwd",
        device_ms(torch, lambda: fa.flash_fwd(q, k, v, mask), **few),
        device_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, mask), **few),
        device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask), **few))
    row["library"] = "scaled_dot_product_attention"
    emit("timing", kernel="flash_fwd", shape=list(shape), dtype="float32",
         **row)
    return row


def timing_phase(torch, fa, device) -> dict:
    result = {"flash_fwd": forward_timing(torch, fa, device, TRAIN_SHAPE,
                                          seed=2)}
    result.update(backward_timing(torch, fa, device, TRAIN_SHAPE, seed=2))
    for row in result.values():
        row["at"] = {}
    # the forward at the host round's score batch and the mesh round's
    # shapes (eval only, no backward, at the score and sponsor shapes)
    for name, shape, few in (("score", SCORE_SHAPE, {}),
                             ("mesh_train", MESH_TRAIN_SHAPE, {}),
                             ("mesh_score", MESH_SCORE_SHAPE, BIG_FEW),
                             ("sponsor", SPONSOR_SHAPE, {})):
        row = forward_timing(torch, fa, device, shape, seed=8, **few)
        result["flash_fwd"]["at"][name] = dict(row, shape=list(shape))
    for name, row in backward_timing(torch, fa, device, MESH_TRAIN_SHAPE,
                                     seed=8).items():
        result[name]["at"]["mesh_train"] = dict(row,
                                                shape=list(MESH_TRAIN_SHAPE))
    return result


def carry_timing_phase(torch, fa, device) -> tuple:
    """flash_carry at the sp training shard; then the ring as a whole
    beside the unsharded flash forward and SDPA on the same sequence.
    Returns the timing rows of flash_carry and of the unsharded
    forward."""
    import torch.nn.functional as F
    from bflc_demo_tpu_torch.parallel import FoldedAxis
    from bflc_demo_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v, _, mask = attention_inputs(torch, SHARD_SHAPE, torch.float32,
                                        device, seed=5)
    carry = zero_carry(torch, fa, SHARD_SHAPE, device)
    few = dict(calls=5, replays=2, repeats=5)
    row = timing_row(
        SHARD_SHAPE, mask, "float32", "flash_carry",
        device_ms(torch, lambda: fa.flash_carry(q, k, v, mask, *carry),
                  **few),
        device_ms(torch, lambda: fa.flash_carry_plain(q, k, v, mask,
                                                      *carry), **few),
        None)                      # no PyTorch call returns the raw carry
    emit("timing", kernel="flash_carry", shape=list(SHARD_SHAPE),
         dtype="float32", **row)
    del q, k, v, mask, carry

    b, s, h, d = RING_SHAPE
    n = SHARD_SHAPE[0] // b
    q, k, v, _, mask = attention_inputs(torch, RING_SHAPE, torch.float32,
                                        device, seed=6)

    def fold(t):
        return t.reshape(b, n, s // n, *t.shape[2:]).transpose(0, 1) \
            .reshape(n * b, s // n, *t.shape[2:]).contiguous()
    fq, fk, fv, fm = (fold(t) for t in (q, k, v, mask))
    axis = FoldedAxis(n, b, device)
    qt, kt, vt, attn_mask = sdpa_inputs(q, k, v, mask)
    ring = ring_attention(fq, fk, fv, fm, axis, impl="pallas")
    dense, _ = fa.flash_fwd(q, k, v, mask)
    err = float((fold(dense) - ring).abs().max())
    fwd_row = timing_row(
        RING_SHAPE, mask, "float32", "flash_fwd",
        device_ms(torch, lambda: fa.flash_fwd(q, k, v, mask), **RING_FEW),
        device_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, mask),
                  **RING_FEW),
        device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask), **RING_FEW))
    emit("timing", kernel="flash_fwd", shape=list(RING_SHAPE),
         dtype="float32", **fwd_row)
    emit("ring_timing", shape=list(RING_SHAPE), n_sp=n, dtype="float32",
         ring_ms=device_ms(torch, lambda: ring_attention(
             fq, fk, fv, fm, axis, impl="pallas"), **RING_FEW),
         flash_fwd_ms=fwd_row["ms"], sdpa_ms=fwd_row["library_ms"],
         ring_vs_flash_fwd_max_abs_err=err)
    if err > TOL["float32"]:
        raise RuntimeError(f"the ring differs from the flash forward: {err}")
    return row, dict(fwd_row, shape=list(RING_SHAPE))


def sp_slice_phase(torch, fa, device) -> int:
    """The sp path's runs between a reset and a read of the launch
    counts; then the card's oracles for them.  Returns flash_carry's
    launches."""
    from bflc_demo_tpu_torch.core.losses import softmax_cross_entropy
    from bflc_demo_tpu_torch.eval.long_context import long_context_sp

    reset_counts()
    runs = {name: long_context_sp(**kw, device=device)
            for name, kw in SP_RUNS.items()}
    torch.cuda.synchronize()
    launches = read_counts()

    for name, res in runs.items():
        kw = SP_RUNS[name]
        expected = kw["n_sp"] * res.model.cfg.depth * res.forwards
        emit("sp_slice", run=name, seq_len=kw["seq_len"], n_sp=kw["n_sp"],
             batch=kw["batch"], losses=res.losses, step_s=res.step_s,
             forward_s=res.forward_s, forwards=res.forwards,
             launches=res.launches, expected_carry_launches=expected,
             peak_mem_gib=res.peak_mem_bytes / 2**30,
             logits=res.logits.tolist())
        if not (np.isfinite(res.losses).all()
                and torch.isfinite(res.logits).all()):
            raise RuntimeError(f"sp {name}: non-finite loss or logits")
        if res.launches["flash_carry"] != expected:
            raise RuntimeError(f"sp {name}: {res.launches['flash_carry']} "
                               f"flash_carry launches, expected {expected}")
        if any(res.launches[k] for k in DENSE_KERNELS):
            raise RuntimeError(f"sp {name}: dense kernels launched inside "
                               f"the sp path: {res.launches}")
    if launches["flash_carry"] != sum(r.launches["flash_carry"]
                                      for r in runs.values()):
        raise RuntimeError(f"launch counts disagree: {launches}")

    # 32k: the sp logits vs the dense forward on the unsharded sequence
    fwd = runs["forward"]
    with torch.no_grad():
        dense = fwd.model.apply(fwd.params[-1], fwd.tokens)
    err = (fwd.logits - dense).abs()
    limit = SP_LOGITS_TOL["atol"] + SP_LOGITS_TOL["rtol"] * dense.abs()
    emit("sp_check", run="forward", check="sp logits vs dense forward",
         max_abs_err=float(err.max()), ok=bool((err <= limit).all()),
         max_err_over_limit=float((err / limit).max()), **SP_LOGITS_TOL)
    if not (err <= limit).all():
        raise RuntimeError(f"32k sp logits differ from the dense forward: "
                           f"{float(err.max())}")

    # 8k: the first sp step vs one dense SGD step from the same params
    tr = runs["train"]
    lr = SP_RUNS["train"]["lr"]
    before, after = tr.params[0], tr.params[1]
    work = {k: p.clone().requires_grad_(True) for k, p in before.items()}
    loss = softmax_cross_entropy(tr.model.apply(work, tr.tokens), tr.labels)
    grads = torch.autograd.grad(loss, list(work.values()))
    param_err = grad_err = 0.0
    bad = []
    for (key, p), g in zip(before.items(), grads):
        want = p - lr * g
        diff = (after[key] - want).abs()
        implied = (p - after[key]) / lr
        rel = float((implied - g).abs().max()) / max(float(g.abs().max()),
                                                     1e-12)
        param_err = max(param_err, float(diff.max()))
        grad_err = max(grad_err, rel)
        if (diff > SP_STEP_TOL["atol"] + SP_STEP_TOL["rtol"]
                * want.abs()).any() or rel > SP_GRAD_TOL:
            bad.append(key)
    body_moved = float((after["['blocks'][0]['w1']"]
                        - before["['blocks'][0]['w1']"]).abs().max())
    emit("sp_check", run="train", check="sp step vs dense step",
         dense_loss=float(loss.detach()), sp_loss=tr.losses[0],
         max_abs_param_err=param_err, max_rel_grad_err=grad_err,
         body_moved=body_moved, ok=not bad, **SP_STEP_TOL,
         grad_tol=SP_GRAD_TOL)
    if bad or body_moved <= 0:
        raise RuntimeError(f"8k sp step differs from the dense step at "
                           f"{bad} (body moved {body_moved})")
    return launches["flash_carry"]


def slice_phase(torch, fa, device) -> dict:
    """Config 5 on the host runtime; returns its launches and round
    times."""
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2
    from bflc_demo_tpu_torch.models.transformer import \
        make_transformer_classifier
    from bflc_demo_tpu_torch.data.synthetic import \
        synthetic_text_classification

    reset_counts()
    res = config5_transformer_sst2(rounds=ROUNDS, runtime="host",
                                   device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    best = res.best_accuracy()
    emit("slice", config="config5", runtime="host", rounds=ROUNDS,
         accuracy=[a for _, a in res.accuracy_history],
         global_loss=[l for _, l in res.loss_history],
         round_s=res.round_times_s, wall_s=res.wall_time_s,
         best_acc=best, ledger_log_head=res.ledger_log_head.hex(),
         ledger_log_size=res.ledger_log_size,
         ledger_verified=res.ledger.verify_log(), launches=launches)
    if res.rounds_completed != ROUNDS or not res.ledger.verify_log():
        raise RuntimeError("the slice did not complete a verified chain")
    missing = [n for n in DENSE_KERNELS if launches.get(n, 0) <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    if best < MIN_BEST_ACC:
        raise RuntimeError(f"best accuracy {best} < {MIN_BEST_ACC}")

    # the final model on the card (kernels) vs the CPU path (plain
    # versions) on 32 test rows: same logits within float32 tolerance
    params = res.final_params
    if not all(torch.isfinite(p).all() for p in params.values()):
        raise RuntimeError("non-finite parameters after the slice")
    x, _ = synthetic_text_classification(64, seq_len=64, vocab_size=1000,
                                         seed=7)
    tokens = torch.as_tensor(x[:32], dtype=torch.long)
    model = make_transformer_classifier()
    on_card = model.to(device).apply(params, tokens.to(device)).cpu()
    on_cpu = model.cpu().apply({k: p.cpu() for k, p in params.items()},
                               tokens)
    err = float((on_card - on_cpu).abs().max())
    emit("slice_check", logits_shape=list(on_card.shape),
         max_abs_err_vs_cpu=err, tol=1e-4)
    if on_card.shape != (32, 2) or err > 1e-4:
        raise RuntimeError(f"card logits differ from the CPU path: {err}")
    # decisions: the model after round 2 (accuracy ~0.8: rows on both
    # sides of the boundary; the initial model's zero head decides none)
    # and the final one
    early = config5_transformer_sst2(rounds=2, runtime="host",
                                     device="cuda")
    decision_check(torch, early.final_params, device, "round 2",
                   early.final_accuracy)
    decision_check(torch, params, device, "final", res.final_accuracy)
    return {"launches": launches, "round_s": res.round_times_s}


def mesh_slice_phase(torch, fa, fp, device) -> dict:
    """Config 5 on the mesh runtime between a reset and a read of the
    launch counts; then its final model's decisions on the card against
    the CPU path's.  Returns the launches and the round times."""
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2

    reset_counts()
    res = config5_transformer_sst2(rounds=ROUNDS, runtime="mesh",
                                   device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    expected = {k: n * ROUNDS for k, n in MESH_PER_ROUND.items()}
    best = res.best_accuracy()
    emit("mesh_slice", config="config5", runtime="mesh", rounds=ROUNDS,
         accuracy=[a for _, a in res.accuracy_history],
         global_loss=[l for _, l in res.loss_history],
         round_s=res.round_times_s, wall_s=res.wall_time_s, best_acc=best,
         ledger_log_head=res.ledger_log_head.hex(),
         ledger_log_size=res.ledger_log_size,
         ledger_verified=res.ledger.verify_log(), n_devices=res.n_devices,
         launches=launches, expected_launches=expected)
    if res.rounds_completed != ROUNDS or not res.ledger.verify_log():
        raise RuntimeError("the mesh slice did not complete a verified "
                           "chain")
    if launches != expected:
        raise RuntimeError(f"mesh launches {launches}, expected {expected}")
    if best < MIN_BEST_ACC:
        raise RuntimeError(f"mesh best accuracy {best} < {MIN_BEST_ACC}")
    decision_check(torch, res.final_params, device, "mesh final",
                   res.final_accuracy)
    return {"launches": launches, "round_s": res.round_times_s}


def config1_phase(torch, fa, fp, device) -> dict:
    """The CLI's default run — config 1 on the mesh runtime, 10 rounds —
    between a reset and a read of the launch counts; the same 10 rounds
    on the host runtime; the mesh run's final model on the card against
    the CPU path on the sponsor's test set."""
    from bflc_demo_tpu_torch.core.losses import accuracy
    from bflc_demo_tpu_torch.data.occupancy import (load_occupancy,
                                                    occupancy_source)
    from bflc_demo_tpu_torch.eval.configs import config1_occupancy
    from bflc_demo_tpu_torch.models import make_softmax_regression

    reset_counts()
    mesh = config1_occupancy(rounds=CONFIG1_ROUNDS, runtime="mesh",
                             device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    host = config1_occupancy(rounds=CONFIG1_ROUNDS, runtime="host",
                             device="cuda")
    source = occupancy_source()
    bar = CONFIG1_MIN_BEST[source]
    want_size = 20 + CONFIG1_ROUNDS * 15       # tests/test_e2e.py:46
    emit("mesh_slice", config="config1", data=source, rounds=CONFIG1_ROUNDS,
         accuracy=[a for _, a in mesh.accuracy_history],
         host_accuracy=[a for _, a in host.accuracy_history],
         round_s=mesh.round_times_s, host_round_s=host.round_times_s,
         best_acc=mesh.best_accuracy(), host_best_acc=host.best_accuracy(),
         min_best_acc=bar, ledger_log_head=mesh.ledger_log_head.hex(),
         ledger_log_size=mesh.ledger_log_size,
         host_ledger_log_size=host.ledger_log_size,
         ledger_verified=mesh.ledger.verify_log(), launches=launches)
    for name, res in (("mesh", mesh), ("host", host)):
        if res.ledger_log_size != want_size or not res.ledger.verify_log():
            raise RuntimeError(f"config 1 {name}: ledger of "
                               f"{res.ledger_log_size} ops, expected "
                               f"{want_size}, or unverified")
    if mesh.best_accuracy() < bar:
        raise RuntimeError(f"config 1 mesh best accuracy "
                           f"{mesh.best_accuracy()} < {bar}")
    want = {k: 0 for k in launches}
    want["fingerprint"] = MESH_PER_ROUND["fingerprint"] * CONFIG1_ROUNDS
    if launches != want:
        raise RuntimeError(f"config 1 launches {launches}, expected {want}")

    # the final model on the card vs on the CPU: logits within float32
    # rounding of the raw-scale features, the same decisions but for
    # rows whose two logits are within that tolerance of each other
    _, _, xte, yte = load_occupancy()
    model = make_softmax_regression()
    x = torch.as_tensor(xte)
    on_card = model.to(device).apply(mesh.final_params, x.to(device)).cpu()
    on_cpu = model.cpu().apply({k: p.cpu() for k, p in
                                mesh.final_params.items()}, x)
    tol = 1e-5 * max(1.0, float(on_cpu.abs().max()))
    err = float((on_card - on_cpu).abs().max())
    gap = (on_cpu[:, 0] - on_cpu[:, 1]).abs()
    flips = on_card.argmax(-1) != on_cpu.argmax(-1)
    acc_card = float(accuracy(on_card, torch.nn.functional.one_hot(
        torch.as_tensor(yte).long(), 2).float()))
    emit("mesh_check", config="config1", max_abs_err_vs_cpu=err, tol=tol,
         ties_flipped=int(flips.sum()), sponsor_acc_card=acc_card,
         sponsor_acc_recorded=mesh.final_accuracy)
    if err > tol or (flips & (gap > 2 * tol)).any():
        raise RuntimeError(f"config 1: card logits differ from the CPU "
                           f"path: {err} (tol {tol})")
    if acc_card != mesh.final_accuracy:
        raise RuntimeError(f"config 1: the sponsor's accuracy re-evaluated "
                           f"on the card ({acc_card}) is not the run's "
                           f"({mesh.final_accuracy})")
    return {"launches": launches, "round_s": mesh.round_times_s,
            "host_round_s": host.round_times_s}


def fingerprint_trees(torch, device) -> dict:
    """The compare cases, as CPU tensors: every leaf dtype of the mesh
    path and more, stacked over 3 slices, with a ragged leaf (11 words);
    config 5's 20 stacked deltas; one config-1 model."""
    from bflc_demo_tpu_torch.models import (make_softmax_regression,
                                            make_transformer_classifier)
    gen = torch.Generator().manual_seed(9)
    mixed = {
        "['f32']": torch.randn((3, 7, 5), generator=gen),
        "['bf16']": torch.randn((3, 13), generator=gen).to(torch.bfloat16),
        "['f16']": torch.randn((3, 4, 3), generator=gen).to(torch.float16),
        "['i8']": torch.randint(-128, 128, (3, 9), generator=gen,
                                dtype=torch.int8),
        "['bool']": torch.rand((3, 6), generator=gen) < 0.5,
        "['i32']": torch.randint(-2**31, 2**31 - 1, (3, 3, 3),
                                 generator=gen, dtype=torch.int32),
        "['ragged']": torch.randn((3, 11), generator=gen)}
    deltas = {k: torch.randn((20,) + tuple(v.shape), generator=gen)
              for k, v in make_transformer_classifier().init_params(0)
              .items()}
    config1 = {k: torch.randn((1,) + tuple(v.shape), generator=gen)
               for k, v in make_softmax_regression().init_params(0).items()}
    return {"mixed_dtypes": mixed, "config5_deltas": deltas,
            "config1_model": config1}


def fingerprint_compare_phase(torch, fp, device) -> tuple:
    """The kernel against the plain version on the same card tensors,
    bit for bit.  Returns the card trees for the timing phase and the
    largest difference measured."""
    trees, worst = {}, 0
    for name, tree in fingerprint_trees(torch, device).items():
        tree = {k: v.to(device) for k, v in tree.items()}
        got = fp.fingerprint_stacked(tree)
        want = fp.fingerprint_plain(tree)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        emit("compare", kernel="fingerprint", case=name,
             slices=int(got.shape[0]),
             leaves={k: [str(v.dtype).replace("torch.", "")]
                     + list(v.shape[1:]) for k, v in tree.items()},
             max_abs_err=err, ok=err == 0)
        if err:
            raise RuntimeError(f"fingerprint {name}: the kernel differs "
                               f"from the plain version")
        trees[name] = tree
        worst = max(worst, err)
    return trees, worst


def event_ms(torch, fn) -> float:
    """One call of `fn` between CUDA events (for the plain fingerprint,
    tens of thousands of launches a call, too many to capture)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def fingerprint_timing_phase(torch, fp, device, trees) -> dict:
    """The kernel at config 5's 20 deltas and at one model, beside both
    bounds: bytes (each input read once, the ids written once) and the
    chain (one lane's dependent multiply-xor steps times the latency of
    one step, measured by a one-thread chain kernel)."""
    step_ms, step_cycles = fp.fnv_chain_latency(1 << 22, device)
    deltas = trees["config5_deltas"]
    rows = {}
    for name, tree in (("config5_deltas", deltas),
                       ("config5_model", {k: v[:1].contiguous()
                                          for k, v in deltas.items()})):
        plan = fp.KernelPlan(tree)
        ms = device_ms(torch, plan.launch, calls=10, replays=3, repeats=5)
        plain_ms = event_ms(torch, lambda: fp.fingerprint_plain(tree))
        slices = plan.batch
        moved = sum(t.numel() * t.element_size() for t in tree.values()) \
            + slices * fp.LANES * 8
        words = sum(fp._leaf_words(t, slices) for t in tree.values()) \
            * slices
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * words / INT_OPS * 1e3
        steps = fp.chain_steps(tree)
        chain_ms = steps * step_ms
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "library": None, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "chain_bound_ms": chain_ms, "chain_steps": steps,
               "chain_step_ns": step_ms * 1e6,
               "chain_step_cycles": step_cycles, "slices": slices,
               "bytes": moved}
        row["share_of_bound"] = row["bound_ms"] / ms
        # the chain is the floor no schedule beats
        row["share_of_chain_bound"] = chain_ms / ms
        emit("timing", kernel="fingerprint", case=name, **row)
        rows[name] = row
    main = rows["config5_deltas"]
    main["at"] = {"config5_model": rows["config5_model"]}
    return main


def _b5_hold(torch, cr, spec, m, c, g, want, blocks: int, label: str):
    """B5 and its plain version over every spec-v2 block of the card
    matrix `m`, each against the host leg's row `want`, byte for byte."""
    bounds = spec.block_bounds(m.shape[1], blocks)
    for fn in (cr.certified_reduce, cr.certified_reduce_plain):
        got = torch.cat([fn(m[:, lo:hi], c, g) for lo, hi in bounds])
        got = got.cpu().numpy()
        if got.tobytes() != want.tobytes():
            bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
            raise RuntimeError(
                f"{fn.__name__} {label}, {blocks} blocks: {bad.size} "
                f"elements differ from the spec's bytes, first at "
                f"{int(bad[0])}: {hex(int(got.view(np.uint32)[bad[0]]))} "
                f"vs {hex(int(want.view(np.uint32)[bad[0]]))}")


def _b5_card(torch, spec, mat, w, wsum, device):
    """The card tensors of one merge: the (N, P) matrix, coefficients and
    gates."""
    return (torch.from_numpy(np.ascontiguousarray(mat)).to(device),
            torch.from_numpy(spec.merge_coefficients(w, wsum)).to(device),
            torch.from_numpy(np.asarray(w, np.float32) > 0.0).to(device))


def merge_compare_phase(torch, cr, device) -> dict:
    """B5 against its plain version and the numpy spec, byte for byte:
    every corner case of the CPU tests at blocks 1, 2, 5, 8 and 64, and
    every merge geometry at blocks 1 and 8.  Returns the geometries'
    cases for the path and timing phases."""
    from bflc_demo_tpu_torch.meshagg import check, spec
    from bflc_demo_tpu_torch.meshagg.engine import flatten_delta

    with np.errstate(all="ignore"):
        for name, (flats, w) in check.corner_cases().items():
            keys = sorted(flats[0])
            wsum = max(float(w.sum()), 1e-12)
            want = flatten_delta(spec.host_weighted_sum(keys, flats, w,
                                                        wsum), keys)
            mat = np.stack([flatten_delta(f, keys) for f in flats])
            m, c, g = _b5_card(torch, spec, mat, w, wsum, device)
            blocks = sorted({min(b, mat.shape[1])
                             for b in check.CORNER_BLOCKS})
            for b in blocks:
                _b5_hold(torch, cr, spec, m, c, g, want, b, name)
            emit("compare", kernel="certified_reduce", case=name,
                 n=int(mat.shape[0]), p=int(mat.shape[1]), blocks=blocks,
                 nonfinite=int((~np.isfinite(want)).sum()),
                 max_abs_err=0.0, ok=True)
        cases = {}
        for name in check.GEOMETRIES:
            g_, rows, weights, selected, lr = check.geometry_case(name)
            w = spec.merge_weight_vector(weights, selected, len(rows))
            wsum = max(float(w.sum()), 1e-12)
            want = spec.host_weighted_sum(
                ["x"], [{"x": r} for r in rows], w, wsum)["x"]
            m, c, g = _b5_card(torch, spec, np.stack(rows), w, wsum,
                               device)
            for b in MERGE_BLOCKS:
                _b5_hold(torch, cr, spec, m, c, g, want, b, name)
            emit("compare", kernel="certified_reduce", case=name,
                 n=len(rows), selected=len(selected), p=int(rows[0].size),
                 blocks=list(MERGE_BLOCKS), max_abs_err=0.0, ok=True)
            cases[name] = (g_, rows, weights, selected, lr)
            del m, c, g
    return cases


def merge_path_phase(torch, cr, device, cases) -> dict:
    """The engine's writer merge (`aggregate_rows`, the mesh leg) once at
    every geometry and block count, between a reset and a read of the
    launch counts — one launch per block per call — each result's bytes
    against the host leg's; then the differential checker on the card,
    counted the same way.  Returns B5's launches by path."""
    from bflc_demo_tpu_torch.meshagg import check
    from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine
    from bflc_demo_tpu_torch.utils.serialization import hash_pytree

    engine = MeshAggEngine(device=device)
    engine.run_selfcheck()              # raises on the card if it fails
    reset_counts()
    got = {(name, b): engine.aggregate_rows(*case, force_leg="mesh",
                                            blocks=b)
           for name, case in cases.items() for b in MERGE_BLOCKS}
    torch.cuda.synchronize()
    merge = read_counts()
    expected = {k: 0 for k in merge}
    expected["certified_reduce"] = len(cases) * sum(MERGE_BLOCKS)
    same = {}
    with np.errstate(all="ignore"):
        for name, case in cases.items():
            want = hash_pytree(engine.aggregate_rows(*case,
                                                     force_leg="host"))
            for b in MERGE_BLOCKS:
                same[f"{name}/{b}"] = hash_pytree(got[(name, b)]) == want
    emit("merge_path", calls=len(got), launches=merge,
         expected_launches=expected, hashes_equal_host_leg=same,
         engine=engine.report())
    if merge != expected or not all(same.values()):
        raise RuntimeError(f"merge path: {merge} launches (expected "
                           f"{expected}), hashes equal {same}")
    reset_counts()
    rc = check.main(["--device", "cuda"])
    checker = read_counts()
    emit("merge_check", rc=rc, launches=checker)
    others = {k: v for k, v in checker.items() if k != "certified_reduce"}
    if rc != 0 or checker["certified_reduce"] <= 0 or any(others.values()):
        raise RuntimeError(f"meshagg.check --device cuda: exit {rc}, "
                           f"launches {checker}")
    return {"meshagg_merge": merge, "meshagg_check": checker}


def b5_route_pair(torch, cr, device, m, c, g, bounds, few) -> dict:
    """The routes B5 takes over the blocks `bounds` of `m` ("columns a
    CTA/floats a copy"; 0 is the column kernel) and, where a strip takes
    16-byte copies, the same strips timed with 4-byte copies
    (`vec1_ms`), where the package at hand has both."""
    if not hasattr(cr, "aligned16"):
        return {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = [cr.launch_shape(m.shape[0], hi - lo,
                              cr.aligned16(m[:, lo:hi]), sms)
              for lo, hi in bounds]
    out = {"routes": sorted({f"{cols}/{vec}" for cols, vec in shapes})}
    if any(vec == 4 for _, vec in shapes):
        out["vec1_ms"] = device_ms(torch, lambda: [
            cr._launch(m[:, lo:hi], c, g, cols, 1)
            for (lo, hi), (cols, _) in zip(bounds, shapes)], **few)
    return out


def merge_timing_rows(torch, cr, device, cases, full: bool = True) -> dict:
    """B5 at every geometry and block count (one launch per block) beside
    its bytes bound (N·P·4 read, P·4 written, the coefficients and
    gates), its chain bound (N slots times one slot's dependent step,
    measured by a one-thread chain kernel, where the package has one)
    and `c @ mat`; with `full`, also its plain version and the engine's
    `aggregate_rows` end to end on the host clock (stack, host-to-device
    copy, launches, copy back, the host's model update), median of 3."""
    from bflc_demo_tpu_torch.meshagg import spec
    from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine

    step_ms = step_cycles = None
    if hasattr(cr, "chain_latency"):
        step_ms, step_cycles = cr.chain_latency(1 << 22, device)
    if full:
        engine = MeshAggEngine(device=device)
        engine.run_selfcheck()
    rows_out = {}
    few = dict(calls=20, replays=3, repeats=5)
    for name, (g_, rows, weights, selected, lr) in cases.items():
        w = spec.merge_weight_vector(weights, selected, len(rows))
        wsum = max(float(w.sum()), 1e-12)
        m, c, g = _b5_card(torch, spec, np.stack(rows), w, wsum, device)
        n, p = m.shape
        moved = n * p * 4 + p * 4 + n * 5
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * n * p / F32_CUDA_CORE_OPS * 1e3
        chain_ms = None if step_ms is None else n * step_ms
        library_ms = device_ms(torch, lambda: c @ m, **few)
        for b in MERGE_BLOCKS:
            bounds = spec.block_bounds(p, b)
            ms = device_ms(torch, lambda: [cr.certified_reduce(
                m[:, lo:hi], c, g) for lo, hi in bounds], **few)
            row = {"ms": ms, "library_ms": library_ms,
                   **b5_route_pair(torch, cr, device, m, c, g, bounds,
                                   few),
                   "library": "torch.matmul(c, mat) (c @ mat; not "
                              "bit-exact: another order, FMA)",
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else
                   "operations", "share_of_bound": max(t_bytes, t_ops) / ms,
                   "chain_bound_ms": chain_ms, "chain_step_ns":
                   None if step_ms is None else step_ms * 1e6,
                   "chain_step_cycles": step_cycles,
                   "share_of_larger_bound": None if chain_ms is None else
                   max(t_bytes, t_ops, chain_ms) / ms,
                   "bytes": moved, "n": n, "p": p, "blocks": b,
                   "launches_per_call": len(bounds)}
            if full:
                row["plain_ms"] = event_ms(torch, lambda: [
                    cr.certified_reduce_plain(m[:, lo:hi], c, g)
                    for lo, hi in bounds])
                e2e = []
                for _ in range(4):
                    t0 = time.perf_counter()
                    engine.aggregate_rows(g_, rows, weights, selected, lr,
                                          force_leg="mesh", blocks=b)
                    e2e.append(time.perf_counter() - t0)
                row["aggregate_rows_s"] = statistics.median(e2e[1:])
                row["aggregate_rows_first_s"] = e2e[0]
            emit("timing", kernel="certified_reduce", case=name, **row)
            rows_out[(name, b)] = row
        del m, c, g
    return rows_out


def merge_timing_phase(torch, cr, device, cases) -> dict:
    """The timing row of the kernels line: config 5's writer merge at one
    block, with every other geometry and block count under "at"."""
    rows_out = merge_timing_rows(torch, cr, device, cases)
    main = dict(rows_out[(MERGE_MAIN, 1)])
    main["at"] = {f"{name}/{b}": row for (name, b), row in rows_out.items()
                  if (name, b) != (MERGE_MAIN, 1)}
    return main


def decision_check(torch, params, device, model_name: str,
                   recorded: float = None) -> None:
    """A model's decisions on the card (kernels at the sponsor's and the
    committee's batch shapes) against the CPU path's on the same params:
    logits within 1e-4 on every row of config 5's data, and the
    accuracies — the sponsor's and the score op of every client's shard —
    equal, but for a row whose two CPU logits are within 2e-4 of each
    other (a tie inside the tolerance).  `recorded`: the sponsor accuracy
    the run recorded for these params, which the card's must equal."""
    from bflc_demo_tpu_torch.eval.configs import config5_data
    from bflc_demo_tpu_torch.models.transformer import \
        make_transformer_classifier

    shards, test_set = config5_data()
    sets = {"sponsor": test_set,
            **{f"client{i}": shard for i, shard in enumerate(shards)}}
    cpu_params = {k: p.cpu() for k, p in params.items()}
    card_model = make_transformer_classifier().to(device)
    cpu_model = make_transformer_classifier()
    acc, err, ties = {}, 0.0, 0
    with torch.no_grad():
        for name, (x, y) in sets.items():
            tokens = torch.as_tensor(x, dtype=torch.long)
            labels = torch.as_tensor(y)
            on_card = card_model.apply(params, tokens.to(device)).cpu()
            on_cpu = cpu_model.apply(cpu_params, tokens)
            err = max(err, float((on_card - on_cpu).abs().max()))
            flips = on_card.argmax(-1) != on_cpu.argmax(-1)
            top2 = on_cpu.topk(2, dim=-1).values
            ties += int((flips & (top2[:, 0] - top2[:, 1] <= 2e-4)).sum())
            if (flips & (top2[:, 0] - top2[:, 1] > 2e-4)).any():
                raise RuntimeError(f"{model_name} model, {name}: the card "
                                   f"decides rows that the CPU path decides "
                                   f"otherwise")
            acc[name] = [float((m.argmax(-1) == labels).float().mean())
                         for m in (on_card, on_cpu)]
    emit("decision_check", model=model_name, sets=len(sets),
         rows=sum(len(y) for _, y in sets.values()),
         max_abs_err_vs_cpu=err, tol=1e-4, ties_flipped=ties,
         sponsor_acc_card=acc["sponsor"][0], sponsor_acc_cpu=acc["sponsor"][1],
         sponsor_acc_recorded=recorded,
         score_ops_card=[acc[f"client{i}"][0] for i in range(len(shards))],
         score_ops_equal=all(a == b for a, b in acc.values()))
    if err > 1e-4:
        raise RuntimeError(f"{model_name} model: card logits differ from the "
                           f"CPU path on the config-5 data: {err}")
    if recorded is not None and abs(acc["sponsor"][0] - recorded) > 1e-6:
        raise RuntimeError(f"the sponsor's accuracy re-evaluated on the card "
                           f"({acc['sponsor'][0]}) is not the run's "
                           f"({recorded})")


def load_port(root: str = None):
    """(torch, the flash-attention module, the build module, the card) of
    the package beside this script, or of the checkout at `root`; None
    without a card or a package."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return None
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    try:
        from bflc_demo_tpu_torch.device import resolve_device
        from bflc_demo_tpu_torch.ops import build
        from bflc_demo_tpu_torch.ops import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository "
              f"({exc})", file=sys.stderr)
        return None
    return torch, fa, build, resolve_device("cuda")   # also turns TF32 off


def backward_timing_main(root: str) -> int:
    """Only the dK/dV and dQ timing rows, at the training and the ring
    shapes, for the package of the checkout at `root`."""
    port = load_port(root)
    if port is None:
        return 1
    torch, fa, _, device = port
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         package=os.path.dirname(os.path.dirname(fa.__file__)))
    backward_timing(torch, fa, device, TRAIN_SHAPE, seed=2)
    backward_timing(torch, fa, device, RING_SHAPE, seed=6, **RING_FEW)
    return 0


def merge_timing_main(root: str) -> int:
    """Only B5's timing rows, at every merge geometry and block count,
    for the package of the checkout at `root`."""
    port = load_port(root)
    if port is None:
        return 1
    torch, fa, _, device = port
    from bflc_demo_tpu_torch.meshagg import check
    from bflc_demo_tpu_torch.ops import certified_reduce as cr
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         package=os.path.dirname(os.path.dirname(fa.__file__)))
    cases = {name: check.geometry_case(name) for name in check.GEOMETRIES}
    merge_timing_rows(torch, cr, device, cases, full=False)
    return 0


def main() -> int:
    port = load_port()
    if port is None:
        return 1
    torch, fa, build, device = port
    from bflc_demo_tpu_torch.ops import certified_reduce as cr
    from bflc_demo_tpu_torch.ops import fingerprint as fp

    t0 = time.perf_counter()
    built = build.build_all()
    logs = "".join(b["log"] for b in built.values())
    emit("build", seconds=time.perf_counter() - t0,
         libraries={n: b["path"] for n, b in built.items()},
         kernels_compiled=len(re.findall(r"Compiling entry", logs)),
         max_registers=max(map(int, re.findall(r"Used (\d+) registers",
                                               logs)), default=None),
         spill_bytes=sum(map(int, re.findall(r"(\d+) bytes spill", logs))))

    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    errors = compare_phase(torch, fa, device)
    timings = timing_phase(torch, fa, device)
    # each path between a reset and a read of the launch counts
    host5 = slice_phase(torch, fa, device)
    mesh5 = mesh_slice_phase(torch, fa, fp, device)
    mesh1 = config1_phase(torch, fa, fp, device)
    emit("round_times", nvidia_smi=card,
         config5={"host": host5["round_s"], "mesh": mesh5["round_s"]},
         config1={"host": mesh1["host_round_s"], "mesh": mesh1["round_s"]})
    trees, errors["fingerprint"] = fingerprint_compare_phase(torch, fp,
                                                             device)
    timings["fingerprint"] = fingerprint_timing_phase(torch, fp, device,
                                                      trees)
    del trees
    errors["flash_carry"] = carry_compare_phase(torch, fa, device)
    timings["flash_carry"], timings["flash_fwd"]["at"]["ring"] = \
        carry_timing_phase(torch, fa, device)
    ring = backward_timing(torch, fa, device, RING_SHAPE, seed=6, **RING_FEW)
    for name, row in ring.items():
        timings[name]["at"]["ring"] = dict(row, shape=list(RING_SHAPE))
    cases = merge_compare_phase(torch, cr, device)
    errors["certified_reduce"] = 0.0
    merge_paths = merge_path_phase(torch, cr, device, cases)
    timings["certified_reduce"] = merge_timing_phase(torch, cr, device,
                                                     cases)
    del cases
    paths = {"host_config5": host5["launches"],
             "mesh_config5": mesh5["launches"],
             "mesh_config1": mesh1["launches"],
             "sp": {"flash_carry": sp_slice_phase(torch, fa, device)},
             **merge_paths}
    by_path = {name: {path: counts.get(name, 0)
                      for path, counts in paths.items()}
               for name in KERNELS}
    emit("done", seconds=time.perf_counter() - t0)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": KERNELS[name], "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name], "max_abs_err": errors[name],
         **timings[name]}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--backward-timing":
        sys.exit(backward_timing_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--merge-timing":
        sys.exit(merge_timing_main(sys.argv[2]))
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--backward-timing DIR | "
              "--merge-timing DIR]", file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
