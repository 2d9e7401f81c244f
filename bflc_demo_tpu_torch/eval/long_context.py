"""Long-context sequence-parallel training and inference at real lengths.

    python -m bflc_demo_tpu_torch.eval.long_context [--seq-len 8192]
        [--n-sp 8] [--batch 4] [--steps 3] [--lr 0.05] [--seed 0]
        [--device cuda|cpu]

The reference drives this path from its tests, not from a preset
(`tests/test_long_context.py`, `tests/test_ring_attention.py`); this is
the port's entry point for it.  `long_context_sp` builds config 5's
transformer at full width (vocab 1000 padded to 1024, dim 128, depth 2,
4 heads, 2 classes, float32) at `seq_len`, seeded data of that length
(`synthetic_text_classification`: lengths uniform in [S/2, S], so the
last shards carry PAD tails or are all PAD), and a `FoldedAxis` of
`n_sp` shards; then it runs `steps` SGD steps of `make_sp_train_step`
and one `make_sp_transformer_forward` of the final params.  Every ring
hop is the `flash_carry` kernel on the card.

The classifier head is drawn at random from the seed (normal * 0.5,
bias spaced over [-0.2, 0.2]), as the reference's sp tests do: the
model's zero-initialised head would make every body gradient zero on the
first step and the logits constant.

The CLI prints one JSON object: losses, step and forward seconds, the
final logits, the kernel launches and the peak device memory.
`eval/profile_sp.py` profiles the same steps on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bflc_demo_tpu_torch.data import one_hot, synthetic_text_classification
from bflc_demo_tpu_torch.device import DeviceLike, resolve_device
from bflc_demo_tpu_torch.models.base import Params
from bflc_demo_tpu_torch.models.transformer import (
    TransformerClassifier, make_transformer_classifier)
from bflc_demo_tpu_torch.ops import flash_attention as fa
from bflc_demo_tpu_torch.parallel.mesh import FoldedAxis
from bflc_demo_tpu_torch.parallel.ring_attention import (
    make_sp_train_step, make_sp_transformer_forward)


@dataclasses.dataclass
class LongContextResult:
    model: TransformerClassifier
    tokens: torch.Tensor              # (B, S) on the device
    labels: torch.Tensor              # (B, classes) one-hot
    params: List[Params]              # [initial, after step 1, ...]
    losses: List[float]               # loss of each step
    step_s: List[float]               # wall seconds of each step
    logits: torch.Tensor              # (B, classes), final params
    forward_s: float                  # wall seconds of that forward
    forwards: int                     # sp forwards run (steps + 1)
    launches: Dict[str, int]          # kernel launches during the run
    peak_mem_bytes: Optional[int]     # None off the card


def _random_head(params: Params, seed: int) -> Params:
    rng = np.random.default_rng(seed + 17)
    head_w = params["['head_w']"]
    c = params["['head_b']"].shape[0]
    return dict(params, **{
        "['head_w']": torch.as_tensor(
            rng.standard_normal(tuple(head_w.shape)).astype(np.float32)
            * 0.5, device=head_w.device),
        "['head_b']": torch.as_tensor(
            np.linspace(-0.2, 0.2, c, dtype=np.float32),
            device=head_w.device)})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def long_context_sp(seq_len: int = 8192, n_sp: int = 8, batch: int = 4,
                    steps: int = 3, lr: float = 0.05, seed: int = 0,
                    device: DeviceLike = None) -> LongContextResult:
    """`steps` sp SGD steps then one sp forward, on `cuda` unless the CPU
    is asked for (raises without a card).  See the module docstring."""
    dev = resolve_device(device)
    model = make_transformer_classifier(vocab_size=1000, seq_len=seq_len,
                                        num_classes=2, dim=128, depth=2,
                                        heads=4).to(dev)
    params = _random_head(model.init_params(seed, dev), seed)
    x, y = synthetic_text_classification(batch, seq_len=seq_len,
                                         vocab_size=1000, seed=seed)
    tokens = torch.as_tensor(x, dtype=torch.long, device=dev)
    labels = torch.as_tensor(one_hot(y, 2), device=dev)
    axis = FoldedAxis(n_sp, batch, dev)
    step = make_sp_train_step(axis, model, lr)
    forward = make_sp_transformer_forward(axis, model)

    before = dict(fa.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history, losses, step_s = [params], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, loss = step(params, tokens, labels)
        losses.append(float(loss))              # waits for the device
        step_s.append(time.perf_counter() - t0)
        history.append(params)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = forward(params, tokens)
    _sync(dev)
    forward_s = time.perf_counter() - t0
    return LongContextResult(
        model=model, tokens=tokens, labels=labels, params=history,
        losses=losses, step_s=step_s, logits=logits, forward_s=forward_s,
        forwards=steps + 1,
        launches={k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES},
        peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--n-sp", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    opts = p.parse_args(argv)
    res = long_context_sp(opts.seq_len, opts.n_sp, opts.batch, opts.steps,
                          opts.lr, opts.seed, opts.device)
    dev = res.logits.device
    print(json.dumps({
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "seq_len": opts.seq_len, "n_sp": opts.n_sp, "batch": opts.batch,
        "losses": res.losses, "step_s": res.step_s,
        "forward_s": res.forward_s, "logits": res.logits.tolist(),
        "launches": res.launches, "peak_mem_bytes": res.peak_mem_bytes}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
