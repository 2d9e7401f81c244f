"""Benchmark presets (port of `bflc_demo_tpu/eval/configs.py`).

Only config 5 — the transformer federated fine-tune on SST-2-shaped text —
is ported, on the in-process host runtime.  The other presets and the
mesh / threaded / processes / executor runtimes are still to port
(ROADMAP A4, A7-A10); asking for them raises naming the item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from bflc_demo_tpu_torch.client.simulation import (SimulationResult,
                                                   run_federated)
from bflc_demo_tpu_torch.data.partition import iid_shards
from bflc_demo_tpu_torch.data.synthetic import synthetic_text_classification
from bflc_demo_tpu_torch.device import DeviceLike
from bflc_demo_tpu_torch.models.transformer import make_transformer_classifier
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig

RUNTIMES = ("host",)
UNPORTED_RUNTIME = ("the {runtime!r} runtime is not ported yet (ROADMAP A7: "
                    "mesh; A9: processes/executor); the port runs 'host'")


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    description: str
    build: Callable[..., SimulationResult]


def _split(x, y, test_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_test = int(len(x) * test_frac)
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]


def config5_data(seed: int = 0, n_data: int = 4000, client_num: int = 20):
    """Config 5's client shards and the sponsor's test set (x, y)."""
    x, y = synthetic_text_classification(n_data, seq_len=64, vocab_size=1000,
                                         num_classes=2, seed=seed)
    xtr, ytr, xte, yte = _split(x, y)
    return iid_shards(xtr, ytr, client_num), (xte, yte)


def config5_transformer_sst2(rounds: int = 5, seed: int = 0,
                             n_data: int = 4000,
                             cfg: Optional[ProtocolConfig] = None,
                             runtime: str = "host",
                             device: DeviceLike = None,
                             verbose: bool = False) -> SimulationResult:
    """Transformer federated fine-tune on SST-2-shaped text: 20 clients,
    committee 4, 10 admitted uploads, top-6 merge, batch 16, lr 0.05, one
    local epoch; vocab 1000 (padded to 1024), seq 64, dim 128, depth 2,
    4 heads."""
    if runtime not in RUNTIMES:
        raise ValueError(UNPORTED_RUNTIME.format(runtime=runtime))
    cfg = (cfg or ProtocolConfig(
        client_num=20, comm_count=4, aggregate_count=6,
        needed_update_count=10, learning_rate=0.05,
        batch_size=16, local_epochs=1)).validate()
    shards, (xte, yte) = config5_data(seed, n_data, cfg.client_num)
    model = make_transformer_classifier(vocab_size=1000, seq_len=64,
                                        num_classes=2, dim=128, depth=2,
                                        heads=4)
    return run_federated(model, shards, (xte, yte), cfg, rounds=rounds,
                         seed=seed, device=device, verbose=verbose)


CONFIGS: Dict[str, BenchConfig] = {
    "config5": BenchConfig("config5", "Transformer/SST-2 federated (stretch)",
                           config5_transformer_sst2),
}
