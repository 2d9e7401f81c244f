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
             shape and at a multi-tile shape (S = 256) with ragged padding
             and one fully masked 64-key tile;
4. timing  — each kernel, its plain version and (forward) PyTorch's
             scaled_dot_product_attention, at the training shape; device
             time per call from CUDA-graph replays between CUDA events
             (warmup, then the median of several repeats);
5. slice   — the config-5 federated round on the host runtime, full width,
             4 rounds on `cuda`, with the launch counts reset just before
             and read just after; then the final model's logits on the
             card against the CPU path on a small input.

Then the `kernels` line and, last, {"ok": true, "device": {...}}.
Without a card, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet; dense rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

TRAIN_SHAPE = (16, 64, 4, 32)        # config-5 trainer batch: B, S, H, D
MULTI_SHAPE = (4, 256, 4, 32)        # several 64-tiles each way
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # x max(1, max|plain|)
ROUNDS = 4
MIN_BEST_ACC = 0.9

KERNELS = {
    "flash_fwd": "bflc_demo_tpu/ops/pallas_attention.py:42",
    "flash_dkdv": "bflc_demo_tpu/ops/pallas_attention.py:153",
    "flash_dq": "bflc_demo_tpu/ops/pallas_attention.py:196",
}
SOURCE = "bflc_demo_tpu_torch/ops/csrc/flash_attention.cu"


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


def compare_phase(torch, fa, device) -> dict:
    """Max abs error of each kernel vs plain on identical inputs; the
    float32 errors at the training shape go into the kernels line."""
    train_err = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in (TRAIN_SHAPE, MULTI_SHAPE):
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
            for name in KERNELS:
                err = scale = 0.0
                for a, b in zip(got[name], want[name]):
                    a, b = a.float(), b.float()
                    if not torch.isfinite(a).all():
                        raise RuntimeError(f"{name}: non-finite output")
                    err = max(err, float((a - b).abs().max()))
                    scale = max(scale, float(b.abs().max()))
                tol = TOL[dtype_name] * max(1.0, scale)
                emit("compare", kernel=name, dtype=dtype_name,
                     shape=list(shape), max_abs_err=err, tol=tol,
                     ok=err <= tol)
                if err > tol:
                    raise RuntimeError(f"{name} {dtype_name} {shape}: "
                                       f"max abs err {err} > {tol}")
                if dtype_name == "float32" and shape == TRAIN_SHAPE:
                    train_err[name] = err
    return train_err


def device_ms(torch, fn, calls: int = 50, replays: int = 5,
              repeats: int = 7) -> float:
    """Median device time of one `fn()` call: `calls` calls captured in a
    CUDA graph (no host launch overhead), replayed between CUDA events."""
    for _ in range(3):
        fn()                        # warm up: build, autotune, allocate
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def bound(shape, mask, dtype_name: str, name: str) -> tuple:
    """Least time (ms) the card needs for this call's work: bytes each
    read or written once over HBM bandwidth vs. the products over the
    dtype's peak (counting only the keys this mask lets through)."""
    b, s, h, d = shape
    esize = 4 if dtype_name == "float32" else 2
    tensor = b * s * h * d * esize
    rows = b * h * s * 4                     # one f32 per (b, h, q row)
    valid_keys = int(mask.sum())             # summed over the batch
    pairs = h * s * valid_keys               # (q row, valid key) per head
    moved = {"flash_fwd": 4 * tensor + rows + b * s,      # q k v | out lse
             "flash_dkdv": 6 * tensor + 2 * rows + b * s,  # q k v dO | dk dv
             "flash_dq": 5 * tensor + 2 * rows + b * s}[name]
    ops = {"flash_fwd": 4, "flash_dkdv": 8, "flash_dq": 6}[name] * pairs * d
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def timing_phase(torch, fa, device) -> dict:
    import torch.nn.functional as F
    q, k, v, g, mask = attention_inputs(torch, TRAIN_SHAPE, torch.float32,
                                        device, seed=2)
    out, lse = fa.flash_fwd(q, k, v, mask)
    delta = fa.attention_delta(g, out)
    # SDPA takes (B, H, S, D) and a key mask broadcast over query rows
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    attn_mask = mask[:, None, None, :]
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, mask),
                      lambda: fa.flash_fwd_plain(q, k, v, mask),
                      lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, attn_mask=attn_mask)),
        "flash_dkdv": (lambda: fa.flash_dkdv(q, k, v, mask, g, lse, delta),
                       lambda: fa.flash_dkdv_plain(q, k, v, mask, g, lse,
                                                   delta), None),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, mask, g, lse, delta),
                     lambda: fa.flash_dq_plain(q, k, v, mask, g, lse, delta),
                     None),
    }
    result = {}
    for name, (kernel, plain, library) in calls.items():
        bound_ms, bound_by = bound(TRAIN_SHAPE, mask, "float32", name)
        row = {"ms": device_ms(torch, kernel),
               "plain_ms": device_ms(torch, plain),
               "library_ms": None if library is None
               else device_ms(torch, library),
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit("timing", kernel=name, shape=list(TRAIN_SHAPE),
             dtype="float32", **row)
        result[name] = row
    return result


def slice_phase(torch, fa, device) -> dict:
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2
    from bflc_demo_tpu_torch.models.transformer import \
        make_transformer_classifier
    from bflc_demo_tpu_torch.data.synthetic import \
        synthetic_text_classification

    fa.reset_launches()
    res = config5_transformer_sst2(rounds=ROUNDS, runtime="host",
                                   device="cuda")
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
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
    missing = [n for n in KERNELS if launches.get(n, 0) <= 0]
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
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    try:
        from bflc_demo_tpu_torch.device import resolve_device
        from bflc_demo_tpu_torch.ops import build
        from bflc_demo_tpu_torch.ops import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository "
              f"({exc})", file=sys.stderr)
        return 1
    device = resolve_device("cuda")          # also turns TF32 off

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
    launches = slice_phase(torch, fa, device)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[name], "launches": launches[name],
         "max_abs_err": errors[name], **timings[name]}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
