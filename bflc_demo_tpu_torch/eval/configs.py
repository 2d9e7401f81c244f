"""Benchmark presets (port of `bflc_demo_tpu/eval/configs.py`).

Ported: `run_with_runtime` (:36-180) for the `mesh` (the default, as in
the reference) and `host` runtimes, refusing the mesh-only options on
`host`; config 1, softmax regression on occupancy (`config1_occupancy`
:212-221); and config 5, the transformer on SST-2-shaped text.  The other presets and the threaded /
processes / executor runtimes are still to port (ROADMAP A8-A10); asking
for them raises naming the item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from bflc_demo_tpu_torch.client.mesh_runtime import run_federated_mesh
from bflc_demo_tpu_torch.client.simulation import (SimulationResult,
                                                   run_federated)
from bflc_demo_tpu_torch.data.occupancy import load_occupancy
from bflc_demo_tpu_torch.data.partition import iid_shards
from bflc_demo_tpu_torch.data.synthetic import synthetic_text_classification
from bflc_demo_tpu_torch.device import DeviceLike
from bflc_demo_tpu_torch.models.softmax_regression import \
    make_softmax_regression
from bflc_demo_tpu_torch.models.transformer import make_transformer_classifier
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig

RUNTIMES = ("mesh", "host")
UNPORTED_RUNTIME = ("the {runtime!r} runtime is not ported yet (ROADMAP A9: "
                    "threaded/processes/executor); the port runs 'mesh' "
                    "and 'host'")


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    description: str
    build: Callable[..., SimulationResult]


def run_with_runtime(model, shards, test_set, cfg: ProtocolConfig, *,
                     runtime: str = "mesh", rounds: int = 10, seed: int = 0,
                     device: DeviceLike = None, verbose: bool = False,
                     attest_scores: Optional[bool] = None,
                     **mesh_kw) -> SimulationResult:
    """Dispatch a federated run to the chosen runtime.

    mesh: one device round per protocol round (the default);
    host: per-client calls, the reference-shaped event loop.
    attest_scores and mesh_kw (participation, client_chunk, ...) apply
    only to 'mesh'; asking 'host' for them raises, never silently drops.
    The reference's process-fleet options (standbys ... rederive, tls_dir)
    come with the runtimes that give them a meaning (ROADMAP A9/A10).
    """
    if runtime not in RUNTIMES:
        raise ValueError(UNPORTED_RUNTIME.format(runtime=runtime))
    if runtime != "mesh" and attest_scores:
        raise ValueError(f"option 'attest_scores' does not apply to the "
                         f"{runtime!r} runtime")
    if runtime == "mesh":
        return run_federated_mesh(model, shards, test_set, cfg,
                                  rounds=rounds, seed=seed,
                                  attest_scores=attest_scores,
                                  device=device, verbose=verbose, **mesh_kw)
    if mesh_kw:
        raise ValueError(f"options {list(mesh_kw)} only apply to the mesh "
                         f"runtime, not {runtime!r}")
    return run_federated(model, shards, test_set, cfg, rounds=rounds,
                         seed=seed, device=device, verbose=verbose)


def _split(x, y, test_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_test = int(len(x) * test_frac)
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]


def config1_occupancy(rounds: int = 10, seed: int = 0,
                      cfg: Optional[ProtocolConfig] = None,
                      **kw) -> SimulationResult:
    """Reference-equivalence run: softmax regression, occupancy, 20
    clients, the protocol's defaults (committee 4, 10 admitted, top-6,
    batch 100, lr 0.001)."""
    cfg = (cfg or ProtocolConfig()).validate()
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr, ytr, cfg.client_num)
    return run_with_runtime(make_softmax_regression(), shards, (xte, yte),
                            cfg, rounds=rounds, seed=seed, **kw)


def config5_data(seed: int = 0, n_data: int = 4000, client_num: int = 20):
    """Config 5's client shards and the sponsor's test set (x, y)."""
    x, y = synthetic_text_classification(n_data, seq_len=64, vocab_size=1000,
                                         num_classes=2, seed=seed)
    xtr, ytr, xte, yte = _split(x, y)
    return iid_shards(xtr, ytr, client_num), (xte, yte)


def config5_transformer_sst2(rounds: int = 5, seed: int = 0,
                             n_data: int = 4000,
                             cfg: Optional[ProtocolConfig] = None,
                             **kw) -> SimulationResult:
    """Transformer federated fine-tune on SST-2-shaped text: 20 clients,
    committee 4, 10 admitted uploads, top-6 merge, batch 16, lr 0.05, one
    local epoch; vocab 1000 (padded to 1024), seq 64, dim 128, depth 2,
    4 heads."""
    cfg = (cfg or ProtocolConfig(
        client_num=20, comm_count=4, aggregate_count=6,
        needed_update_count=10, learning_rate=0.05,
        batch_size=16, local_epochs=1)).validate()
    shards, (xte, yte) = config5_data(seed, n_data, cfg.client_num)
    model = make_transformer_classifier(vocab_size=1000, seq_len=64,
                                        num_classes=2, dim=128, depth=2,
                                        heads=4)
    return run_with_runtime(model, shards, (xte, yte), cfg, rounds=rounds,
                            seed=seed, **kw)


CONFIGS: Dict[str, BenchConfig] = {
    "config1": BenchConfig("config1", "Reference equivalence: softmax "
                           "regression on occupancy", config1_occupancy),
    "config5": BenchConfig("config5", "Transformer/SST-2 federated (stretch)",
                           config5_transformer_sst2),
}
