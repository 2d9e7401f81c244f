"""Benchmark presets (port of `bflc_demo_tpu/eval/configs.py`).

Ported: `run_with_runtime` (:36-180) for the `mesh` (the default, as in
the reference), `host`, `threaded`, `processes` and `executor` runtimes
(the mesh executor with thin client processes,
`client/process_runtime.run_federated_mesh_processes`, :169-178),
refusing the mesh-only options elsewhere and a preset without a process
factory on `processes` or `executor`; and all six presets (:191-330)
with the reference's defaults, each with its `process_factory` and
`factory_kw` (the `models` entry every fleet process builds its model
with): config 0 (MLP, MNIST shapes), config 1 (softmax regression on
occupancy), config 2 (LeNet-5, CIFAR-10 shapes, Dirichlet 0.5), config
3 (FEMNIST CNN, 100 clients, active participation on the mesh runtime),
config 4 (ResNet-18, CIFAR-100 shapes, 32 clients; on the mesh runtime
active participation, `client_chunk` 4 and `remat`) and config 5 (the
transformer on SST-2-shaped text).  The image sets are the seeded
stand-ins of `data/synthetic.py` unless `$BFLC_DATA_DIR` holds the real
arrays.  Still to port, and raising with the item: the fleet's other
options (chaos, telemetry: A14, unexpected keywords here).  Config 4's
`secure=True` runs on the mesh runtime (X25519-keyed masked merges,
`parallel/secure.py`) and raises ValueError on another, as in the
reference.  `attest_scores` applies to `mesh` and
`executor`, `tls_dir` to `processes` and `executor` (:94-99); every
other pairing raises, never silently dropped.
`standbys`, `quorum`, `bft_validators`, `tls_dir`, `snapshot_interval`,
`snapshot_dir` and `rederive` reach the fleet, `cells`, `cell_size`,
`bft_validators` and `rederive` the hier fleet (`BFLC_HIER_LEGACY=1`
pins the single tier); another runtime refuses them, and refuses an
async genome (`cfg.async_buffer` > 0 unless `BFLC_ASYNC_LEGACY=1`,
reference :70-76) or a sparse one
(`cfg.delta_density` < 1 unless `BFLC_SPARSE_LEGACY=1`, :77-84): only
the fleet runs FedBuff and moves upload blobs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np

from bflc_demo_tpu_torch.client.mesh_runtime import run_federated_mesh
from bflc_demo_tpu_torch.client.simulation import (SimulationResult,
                                                   run_federated)
from bflc_demo_tpu_torch.data.occupancy import load_occupancy
from bflc_demo_tpu_torch.data.partition import dirichlet_shards, iid_shards
from bflc_demo_tpu_torch.data.synthetic import (synthetic_cifar10,
                                                synthetic_cifar100,
                                                synthetic_femnist,
                                                synthetic_mnist,
                                                synthetic_text_classification)
from bflc_demo_tpu_torch.device import DeviceLike
from bflc_demo_tpu_torch.ledger import async_enabled, check_backend
from bflc_demo_tpu_torch.models import (make_femnist_cnn, make_lenet5,
                                        make_mlp, make_resnet18,
                                        make_softmax_regression,
                                        make_transformer_classifier)
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig
from bflc_demo_tpu_torch.utils.codecs import sparse_enabled

RUNTIMES = ("mesh", "host", "threaded", "processes", "executor")
UNKNOWN_RUNTIME = ("runtime must be mesh|host|threaded|processes|executor, "
                   "got {runtime!r}")


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    description: str
    build: Callable[..., SimulationResult]


def run_with_runtime(model, shards, test_set, cfg: ProtocolConfig, *,
                     runtime: str = "mesh", rounds: int = 10, seed: int = 0,
                     device: DeviceLike = None, verbose: bool = False,
                     attest_scores: Optional[bool] = None,
                     ledger_backend: str = "auto",
                     process_factory: str = "",
                     factory_kw: Optional[dict] = None,
                     standbys: int = 0, quorum: int = 0,
                     bft_validators: int = 0, tls_dir: str = "",
                     snapshot_interval: int = 0, snapshot_dir: str = "",
                     cells: int = 0, cell_size: int = 0,
                     rederive: str = "off",
                     **mesh_kw) -> SimulationResult:
    """Dispatch a federated run to the chosen runtime.

    mesh: one device round per protocol round (the default);
    host: per-client calls, the reference-shaped event loop;
    threaded: a thread per client against one locked ledger, with the
    failure detector's recovery ops;
    executor: thin client processes that stage their shards once while
    an executor process runs every round as one program on the device
    (score attestation on unless `attest_scores` is False, TLS with
    `tls_dir`);
    processes: the writer, the clients and a replica as OS processes
    over the socket ledger (`process_factory`/`factory_kw` name the
    model each process builds), the parent as sponsor, with `standbys`
    hot standbys, `quorum`-ack, `bft_validators` validator processes,
    TLS (`tls_dir`) and certified snapshots (`snapshot_interval`,
    `snapshot_dir`); with `cells`/`cell_size` the two-tier hier fleet
    (`hier/runtime.run_federated_hier`, reference :122-155: root, cell
    aggregators and members, `bft_validators` at the root), which
    refuses standbys, quorum, TLS, snapshots and an async genome, and
    which `BFLC_HIER_LEGACY=1` pins back to the single tier; `rederive`
    arms the validators' re-derivation of every commit on both.
    attest_scores applies to 'mesh' and 'executor', tls_dir to
    'processes' and 'executor', and mesh_kw (participation,
    client_chunk, ...) only to 'mesh'; asking another runtime for them
    raises, never silently drops.  `ledger_backend` is the reference's
    ("auto", "native" or "python"), passed to the mesh, host and
    threaded runtimes as the reference passes it (:104-120); the fleet
    runtimes' writers take "auto" whatever it says, as the reference's
    do.
    The fleet's other options (chaos, telemetry, ...) come with the
    item that gives them a meaning (ROADMAP A14).
    """
    if runtime not in RUNTIMES:
        raise ValueError(UNKNOWN_RUNTIME.format(runtime=runtime))
    # async FedBuff and sparse upload deltas are process-runtime
    # protocol modes: the other runtimes drive the synchronous round loop
    # and move no blobs, so they would ignore them
    fleet = (("async_buffer (protocol)",
              cfg.async_buffer if async_enabled(cfg) else 0),
             ("delta_density (protocol)",
              cfg.delta_density if sparse_enabled(cfg) else 0),
             ("standbys", standbys), ("quorum", quorum),
             ("bft_validators", bft_validators),
             ("snapshot_interval", snapshot_interval),
             ("snapshot_dir", snapshot_dir), ("cells", cells),
             ("cell_size", cell_size),
             ("rederive", rederive != "off" and rederive))
    inapplicable = list(fleet) if runtime != "processes" else []
    if runtime not in ("mesh", "executor"):
        # attestation exists on both mesh-family runtimes
        inapplicable.append(("attest_scores", attest_scores))
    if runtime not in ("processes", "executor"):
        inapplicable.append(("tls_dir", tls_dir))
    bad = [n for n, v in inapplicable if v]
    if bad:
        raise ValueError(f"options {bad} do not apply to the {runtime!r} "
                         f"runtime")
    check_backend(ledger_backend)
    if runtime == "mesh":
        return run_federated_mesh(model, shards, test_set, cfg,
                                  rounds=rounds, seed=seed,
                                  ledger_backend=ledger_backend,
                                  attest_scores=attest_scores,
                                  device=device, verbose=verbose, **mesh_kw)
    if mesh_kw:
        raise ValueError(f"options {list(mesh_kw)} only apply to the mesh "
                         f"runtime, not {runtime!r}")
    if runtime == "host":
        return run_federated(model, shards, test_set, cfg, rounds=rounds,
                             seed=seed, ledger_backend=ledger_backend,
                             device=device, verbose=verbose)
    if runtime == "threaded":
        from bflc_demo_tpu_torch.client.threaded import ThreadedFederation
        return ThreadedFederation(model, shards, test_set, cfg,
                                  ledger_backend=ledger_backend,
                                  device=device).run(rounds=rounds)
    if not process_factory:
        raise ValueError(f"this preset does not support the {runtime!r} "
                         f"runtime (no model factory registered)")
    if runtime == "executor":
        from bflc_demo_tpu_torch.client.process_runtime import \
            run_federated_mesh_processes
        return run_federated_mesh_processes(
            process_factory, shards, test_set, cfg, rounds=rounds,
            factory_kw=factory_kw or {}, tls_dir=tls_dir,
            attest_scores=attest_scores, device=device, verbose=verbose)
    if (cells or cell_size) and os.environ.get("BFLC_HIER_LEGACY"):
        # the reference benchmark's single-tier pin: ignore the cell tier
        # and run the unchanged flat fleet
        cells = cell_size = 0
    if cells or cell_size:
        # the two-tier fleet; the single tier's options are never
        # silently dropped
        dropped = [n for n, v in (("standbys", standbys),
                                  ("quorum", quorum), ("tls_dir", tls_dir),
                                  ("snapshot_interval", snapshot_interval),
                                  ("async_buffer (protocol)",
                                   async_enabled(cfg))) if v]
        if dropped:
            raise ValueError(f"options {dropped} are not supported with "
                             f"--cells/--cell-size")
        from bflc_demo_tpu_torch.hier.runtime import run_federated_hier
        return run_federated_hier(process_factory, shards, test_set, cfg,
                                  rounds=rounds, cells=cells,
                                  cell_size=cell_size,
                                  factory_kw=factory_kw or {},
                                  bft_validators=bft_validators,
                                  rederive=rederive,
                                  device=device, verbose=verbose)
    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    return run_federated_processes(process_factory, shards, test_set, cfg,
                                   rounds=rounds, factory_kw=factory_kw or {},
                                   standbys=standbys, quorum=quorum,
                                   bft_validators=bft_validators,
                                   tls_dir=tls_dir,
                                   snapshot_interval=snapshot_interval,
                                   snapshot_dir=snapshot_dir,
                                   rederive=rederive,
                                   device=device, verbose=verbose)


def _split(x, y, test_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_test = int(len(x) * test_frac)
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]


def config0_mlp_mnist(rounds: int = 10, seed: int = 0, n_data: int = 6000,
                      cfg: Optional[ProtocolConfig] = None,
                      **kw) -> SimulationResult:
    """2-layer MLP on MNIST-shaped data, 4-client IID FedAvg: committee
    2, the other 2 upload, top-2 merge; lr 0.05, batch 32, 2 local
    epochs."""
    cfg = (cfg or ProtocolConfig(
        client_num=4, comm_count=2, aggregate_count=2,
        needed_update_count=2, learning_rate=0.05,
        batch_size=32, local_epochs=2)).validate()
    x, y = synthetic_mnist(n_data, seed)
    xtr, ytr, xte, yte = _split(x, y)
    shards = iid_shards(xtr, ytr, cfg.client_num)
    kw.setdefault("process_factory", "make_mlp")
    return run_with_runtime(make_mlp(), shards, (xte, yte), cfg,
                            rounds=rounds, seed=seed, **kw)


def config1_occupancy(rounds: int = 10, seed: int = 0,
                      cfg: Optional[ProtocolConfig] = None,
                      **kw) -> SimulationResult:
    """Reference-equivalence run: softmax regression, occupancy, 20
    clients, the protocol's defaults (committee 4, 10 admitted, top-6,
    batch 100, lr 0.001)."""
    cfg = (cfg or ProtocolConfig()).validate()
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr, ytr, cfg.client_num)
    kw.setdefault("process_factory", "make_softmax_regression")
    return run_with_runtime(make_softmax_regression(), shards, (xte, yte),
                            cfg, rounds=rounds, seed=seed, **kw)


def config2_lenet_cifar10(rounds: int = 10, seed: int = 0,
                          n_data: int = 6000, alpha: float = 0.5,
                          cfg: Optional[ProtocolConfig] = None,
                          **kw) -> SimulationResult:
    """LeNet-5, CIFAR-10 shapes, 20-client Dirichlet(alpha) non-IID; the
    protocol defaults but lr 0.05, batch 32 and 4 local epochs (conv
    models need real local progress a round)."""
    cfg = (cfg or ProtocolConfig(learning_rate=0.05, batch_size=32,
                                 local_epochs=4)).validate()
    shards, test_set = config2_data(seed, n_data, cfg.client_num, alpha,
                                    cfg.batch_size)
    kw.setdefault("process_factory", "make_lenet5")
    return run_with_runtime(make_lenet5(), shards, test_set, cfg,
                            rounds=rounds, seed=seed, **kw)


def config2_data(seed: int = 0, n_data: int = 6000, client_num: int = 20,
                 alpha: float = 0.5, min_size: int = 32):
    """Config 2's Dirichlet client shards and the sponsor's test set."""
    x, y = synthetic_cifar10(n_data, seed)
    xtr, ytr, xte, yte = _split(x, y)
    return dirichlet_shards(xtr, ytr, client_num, alpha=alpha, seed=seed,
                            min_size=min_size), (xte, yte)


def config3_femnist_sampled(rounds: int = 10, seed: int = 0,
                            n_data: int = 20000,
                            cfg: Optional[ProtocolConfig] = None,
                            **kw) -> SimulationResult:
    """FEMNIST CNN, 100 clients, Dirichlet(1.0); committee 4, 10
    admitted, top-6, lr 0.05, batch 20, 4 local epochs.  On the mesh
    runtime only the round's 10 uploaders and 4 committee members train
    (active participation)."""
    cfg = (cfg or ProtocolConfig(
        client_num=100, comm_count=4, aggregate_count=6,
        needed_update_count=10, learning_rate=0.05,
        batch_size=20, local_epochs=4)).validate()
    x, y = synthetic_femnist(n_data, seed)
    xtr, ytr, xte, yte = _split(x, y)
    shards = dirichlet_shards(xtr, ytr, cfg.client_num, alpha=1.0,
                              seed=seed, min_size=cfg.batch_size)
    if kw.get("runtime", "mesh") == "mesh":
        kw.setdefault("participation", "active")
    kw.setdefault("process_factory", "make_femnist_cnn")
    return run_with_runtime(make_femnist_cnn(), shards, (xte, yte), cfg,
                            rounds=rounds, seed=seed, **kw)


def config4_resnet_cifar100(rounds: int = 5, seed: int = 0,
                            n_data: int = 4000,
                            cfg: Optional[ProtocolConfig] = None,
                            secure: bool = False,
                            **kw) -> SimulationResult:
    """ResNet-18 (GroupNorm), CIFAR-100 shapes, 32-client cross-silo IID;
    committee 4, 12 admitted, top-8, lr 0.1, batch 16, one local epoch.
    On the mesh runtime: active participation, `client_chunk` 4 and
    `remat` (the reference's memory controls).  `secure=True` is the
    secure-aggregation variant (:299-306), mesh runtime only: 32 wallets
    from `provision_wallets(32, b"config4-secure-seed-0001")` key each
    slot pair's masks by X25519 (`parallel/secure.py`, kernel B7), and
    sign the committee's score rows."""
    cfg = (cfg or ProtocolConfig(
        client_num=32, comm_count=4, aggregate_count=8,
        needed_update_count=12, learning_rate=0.1,
        batch_size=16, local_epochs=1)).validate()
    x, y = synthetic_cifar100(n_data, seed)
    xtr, ytr, xte, yte = _split(x, y)
    shards = iid_shards(xtr, ytr, cfg.client_num)
    if kw.get("runtime", "mesh") == "mesh":
        kw.setdefault("participation", "active")
        kw.setdefault("client_chunk", 4)
        kw.setdefault("remat", True)
        if secure:
            from bflc_demo_tpu_torch.comm.identity import provision_wallets
            wallets, _ = provision_wallets(cfg.client_num,
                                           b"config4-secure-seed-0001")
            kw.setdefault("secure_aggregation", True)
            kw.setdefault("secure_wallets", wallets)
    elif secure:
        raise ValueError("secure aggregation runs on the mesh runtime")
    kw.setdefault("process_factory", "make_resnet18")
    return run_with_runtime(make_resnet18(), shards, (xte, yte), cfg,
                            rounds=rounds, seed=seed, **kw)


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
    arch = dict(vocab_size=1000, seq_len=64, num_classes=2, dim=128,
                depth=2, heads=4)
    model = make_transformer_classifier(**arch)
    kw.setdefault("process_factory", "make_transformer_classifier")
    kw.setdefault("factory_kw", arch)
    return run_with_runtime(model, shards, (xte, yte), cfg, rounds=rounds,
                            seed=seed, **kw)


CONFIGS: Dict[str, BenchConfig] = {
    "config0": BenchConfig("config0", "MLP/MNIST, 4-client FedAvg",
                           config0_mlp_mnist),
    "config1": BenchConfig("config1", "Reference equivalence: softmax "
                           "regression on occupancy", config1_occupancy),
    "config2": BenchConfig("config2", "LeNet-5/CIFAR-10, 20-client "
                           "Dirichlet(0.5) non-IID", config2_lenet_cifar10),
    "config3": BenchConfig("config3", "FEMNIST CNN, 100 clients, sampled "
                           "(active) participation", config3_femnist_sampled),
    "config4": BenchConfig("config4", "ResNet-18/CIFAR-100, 32-client "
                           "cross-silo", config4_resnet_cifar100),
    "config5": BenchConfig("config5", "Transformer/SST-2 federated (stretch)",
                           config5_transformer_sst2),
}
