"""Configs 0 and 2 against the JAX package's presets, their data, and the CLI.

- `config0_mlp_mnist(rounds=2, n_data=1200)` (its own 4-client protocol)
  and `config2_lenet_cifar10` at the reference test's `TINY` geometry
  (`tests/test_configs.py:18-31`, n_data 1500): each round's uploaders,
  committee and selection equal the reference's mesh runtime (on a
  one-device mesh, as `tests/test_torch_mesh.py` runs it), sponsor
  accuracies within 1e-4, the ledger's size `clients + rounds * (uploads
  + scores + 1)`.  Training is float32 in other orders (XLA's convs and
  products against PyTorch's), ~1e-7 relative a step.
- `dirichlet_shards` and the image generators (`synthetic_image_
  classification`, the MNIST / CIFAR-10 / CIFAR-100 / FEMNIST stand-ins)
  give the reference's arrays byte for byte, and `$BFLC_DATA_DIR/<name>
  .npz` is read, subsampled and refused alike.
- The CLI runs configs 0-3 on `--device cpu --rounds 1` with tiny
  protocol overrides (flags, and `BFLC_*` for config 3); config 4's run
  is in `tests/test_torch_participation.py`.  The overrides start from
  `ProtocolConfig()` as the reference's `protocol_from_env` does.
  Config 4's `secure=True` provisions the preset's 32 X25519 wallets and
  runs the mesh runtime's secure aggregation (another runtime raises);
  the CLI's `--secure` exits 2 on any other config; the fleet's,
  codecs' and the device profiler's flags exit 2 naming their item.
"""

import json
import os

import numpy as np
import pytest
import torch

from bflc_demo_tpu.client import mesh_runtime as ref_mesh_runtime
from bflc_demo_tpu.data import partition as ref_partition
from bflc_demo_tpu.data import synthetic as ref_synthetic
from bflc_demo_tpu.eval import configs as ref_configs
from bflc_demo_tpu.parallel.mesh import client_axis_mesh
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils import flags as ref_flags
from bflc_demo_tpu_torch.__main__ import main as cli
from bflc_demo_tpu_torch.client import mesh_runtime
from bflc_demo_tpu_torch.data import partition, synthetic
from bflc_demo_tpu_torch.eval import configs
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import flags

TINY = dict(client_num=8, comm_count=2, aggregate_count=2,
            needed_update_count=3, learning_rate=0.05, batch_size=16,
            local_epochs=1)


@pytest.fixture(autouse=True, scope="module")
def _share_of_the_cores():
    """The CPU path on this worker's share of the cores: the suite may run
    files in parallel workers (pytest-xdist), and small convolutions
    split over every core in every worker spend their time in thread
    barriers."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)


def _record(monkeypatch, module, log):
    inner = module.audit_round

    def wrapped(ledger, addr_of, epoch, ups, comm, *rest):
        inner(ledger, addr_of, epoch, ups, comm, *rest)
        log.append((epoch, list(ups), list(comm),
                    sorted(int(s) for s in rest[6])))
    monkeypatch.setattr(module, "audit_round", wrapped)


@pytest.mark.parametrize("name,kw,clients,uploads,scores", [
    ("config0_mlp_mnist", dict(n_data=1200), 4, 2, 2),
    ("config2_lenet_cifar10", dict(n_data=1500, cfg=TINY), 8, 3, 2),
])
def test_preset_matches_reference(monkeypatch, name, kw, clients, uploads,
                                  scores):
    ref_log, port_log = [], []
    _record(monkeypatch, ref_mesh_runtime, ref_log)
    _record(monkeypatch, mesh_runtime, port_log)
    cfg = kw.pop("cfg", None)
    want = getattr(ref_configs, name)(
        rounds=2, mesh=client_axis_mesh(1), ledger_backend="python",
        cfg=cfg and RefConfig(**cfg), **kw)
    got = getattr(configs, name)(rounds=2, device="cpu",
                                 cfg=cfg and ProtocolConfig(**cfg), **kw)
    assert len(port_log) == 2 and port_log == ref_log
    for (_, a), (_, b) in zip(got.accuracy_history, want.accuracy_history):
        assert np.isfinite(a) and abs(a - b) <= 1e-4
    size = clients + 2 * (uploads + scores + 1)
    assert got.ledger_log_size == want.ledger_log_size == size


@pytest.mark.parametrize("alpha,seed,clients,min_size", [
    (0.5, 0, 20, 32), (1.0, 3, 100, 4), (0.1, 7, 8, 2)])
def test_dirichlet_shards_byte_equal(alpha, seed, clients, min_size):
    x, y = synthetic.synthetic_image_classification(3000, (2, 2, 1), 10,
                                                    seed=seed)
    got = partition.dirichlet_shards(x, y, clients, alpha, seed, min_size)
    want = ref_partition.dirichlet_shards(x, y, clients, alpha, seed,
                                          min_size)
    assert len(got) == len(want) == clients
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()
    with pytest.raises(ValueError, match="could not draw"):
        partition.dirichlet_shards(x[:50], y[:50], 20, alpha, seed, 10)


@pytest.mark.parametrize("name,args", [
    ("synthetic_mnist", (500, 1)), ("synthetic_cifar10", (300, 0)),
    ("synthetic_cifar100", (300, 2)), ("synthetic_femnist", (400, 3)),
    ("synthetic_image_classification", (200, (5, 7, 2), 6, 4))])
def test_image_generators_byte_equal(name, args):
    got = getattr(synthetic, name)(*args)
    want = getattr(ref_synthetic, name)(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_data_dir_arrays_read_alike(monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    x = rng.random((50, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 50).astype(np.int32)
    np.savez(tmp_path / "mnist.npz", x=x, y=y)
    np.savez(tmp_path / "cifar10.npz", x=x, y=y)          # wrong shape
    np.savez(tmp_path / "femnist.npz", x=x * 255, y=y)    # 0-255 pixels
    monkeypatch.setenv("BFLC_DATA_DIR", str(tmp_path))
    for n in (0, 30):
        for g, w in zip(synthetic.synthetic_mnist(n, seed=5),
                        ref_synthetic.synthetic_mnist(n, seed=5)):
            assert g.tobytes() == w.tobytes()
    for name, match in (("synthetic_cifar10", "config expects"),
                        ("synthetic_femnist", "pixel range"),
                        ("synthetic_mnist", "samples < requested")):
        n = 60 if name == "synthetic_mnist" else 10
        for module in (synthetic, ref_synthetic):
            with pytest.raises(ValueError, match=match):
                getattr(module, name)(n)
    with pytest.raises(FileNotFoundError):
        synthetic.load_image_dataset(str(tmp_path / "none.npz"))


@pytest.mark.parametrize("config,argv,env", [
    ("config0", ["--client-num", "4", "--comm-count", "2",
                 "--aggregate-count", "2", "--needed-update-count", "2",
                 "--learning-rate", "0.05", "--batch-size", "32"], {}),
    ("config1", ["--client-num", "8", "--comm-count", "2",
                 "--aggregate-count", "2", "--needed-update-count", "3"], {}),
    ("config2", ["--client-num", "8", "--comm-count", "2",
                 "--aggregate-count", "2", "--needed-update-count", "3",
                 "--learning-rate", "0.05", "--batch-size", "16"], {}),
    ("config3", ["--needed-update-count", "3"],
     dict(BFLC_CLIENT_NUM="100", BFLC_COMM_COUNT="2",
          BFLC_AGGREGATE_COUNT="2", BFLC_NEEDED_UPDATE_COUNT="5",
          BFLC_BATCH_SIZE="50")),
])
def test_cli_runs_the_presets_on_cpu(monkeypatch, capsys, config, argv, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cli(["--config", config, "--device", "cpu", "--rounds", "1",
                *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    clients = int(env.get("BFLC_CLIENT_NUM", argv[1]))
    k = int(argv[argv.index("--needed-update-count") + 1])
    c = int(env.get("BFLC_COMM_COUNT") or argv[argv.index("--comm-count")
                                                 + 1])
    assert out["config"] == config and out["rounds"] == 1
    assert out["ledger_log_size"] == clients + k + c + 1
    assert np.isfinite(out["best_acc"])


def test_protocol_overrides_match_the_reference(monkeypatch):
    env = dict(BFLC_CLIENT_NUM="30", BFLC_COMM_COUNT="3",
               BFLC_LEARNING_RATE="0.05", BFLC_LOCAL_EPOCHS="4")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = flags.protocol_from_env()
    want = ref_flags.protocol_from_env()
    for name, value in vars(got).items():
        assert getattr(want, name) == value, name
    ns = configs_cli_namespace(["--client-num", "40", "--batch-size", "20"])
    cfg = flags.parse_protocol(ns)
    _, ref_cfg = ref_flags.parse_args(["--client-num", "40", "--batch-size",
                                       "20"])
    assert cfg.client_num == ref_cfg.client_num == 40
    for name, value in vars(cfg).items():
        assert getattr(ref_cfg, name) == value, name
    # the blocked geometry, the codecs and the closed loop's fields are
    # ported (string fields as they stand)
    monkeypatch.setenv("BFLC_REDUCE_BLOCKS", "4")
    assert flags.protocol_from_env().reduce_blocks == \
        ref_flags.protocol_from_env().reduce_blocks == 4
    monkeypatch.setenv("BFLC_DELTA_DENSITY", "0.5")
    monkeypatch.setenv("BFLC_DELTA_DTYPE", "i8")
    monkeypatch.setenv("BFLC_DELTA_CODEC", "sketch")
    got, want = flags.protocol_from_env(), ref_flags.protocol_from_env()
    for name, value in vars(got).items():
        assert getattr(want, name) == value, name
    assert (got.delta_density, got.delta_dtype, got.delta_codec) == \
        (0.5, "i8", "sketch")
    monkeypatch.setenv("BFLC_ADAPT_EVERY", "2")
    monkeypatch.setenv("BFLC_DENSITY_FLOOR", "0.05")
    got, want = flags.protocol_from_env(), ref_flags.protocol_from_env()
    assert (got.adapt_every, got.density_floor) == \
        (want.adapt_every, want.density_floor) == (2, 0.05)
    monkeypatch.setenv("BFLC_DENSITY_FLOOR", "0.9")
    with pytest.raises(ValueError, match="density_floor"):
        flags.protocol_from_env()


def configs_cli_namespace(argv):
    from bflc_demo_tpu_torch.__main__ import _parser
    return _parser().parse_args(argv)


def test_no_preset_override_keeps_the_preset_protocol():
    assert flags.parse_protocol(configs_cli_namespace([])) is None


@pytest.mark.parametrize("argv,item", [
    # the checkpoint flags are ported (tests/test_torch_checkpoint.py);
    # the device profiler's is still A11
    (["--xprof-window", "2"], "A11"), (["--chaos-seed", "7"], "A14"),
    (["--chaos-profile", "light"], "A14"),
    (["--runtime", "host", "--xprof-window", "3"], "A11"),
    (["--trace-path", "t.json"], "A14")])
def test_cli_refuses_unported_flags(capsys, argv, item):
    assert cli(["--device", "cpu", *argv]) == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


@pytest.mark.parametrize("config", ["config0", "config1", "config2",
                                    "config3", "config5"])
def test_cli_secure_is_config4_only(capsys, config):
    """`--secure` is config 4's variant: on any other config the CLI
    exits 2, as the reference's (:208-213)."""
    assert cli(["--device", "cpu", "--config", config, "--secure"]) == 2
    assert "config4 secure-aggregation variant" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--attest-scores", "--no-attest-scores",
                                  None])
def test_cli_secure_takes_attest_scores_on_the_mesh(monkeypatch, capsys,
                                                    flag):
    """`--config config4 --secure` hands the preset `secure=True`, and
    `--[no-]attest-scores` with it on the mesh runtime (its wallets
    sign the rows; the reference's :174-180)."""
    import types
    seen = {}

    def build(**kw):
        seen.update(kw)
        return types.SimpleNamespace(
            rounds_completed=1, final_accuracy=0.5, wall_time_s=1.0,
            best_accuracy=lambda: 0.5, ledger_log_size=37,
            ledger_log_head=b"\0" * 32)
    monkeypatch.setitem(configs.CONFIGS, "config4", configs.BenchConfig(
        "config4", "", build))
    argv = ["--device", "cpu", "--config", "config4", "--secure",
            "--rounds", "1"] + ([flag] if flag else [])
    assert cli(argv) == 0
    assert seen["secure"] is True and seen["runtime"] == "mesh"
    assert seen.get("attest_scores") == {"--attest-scores": True,
                                         "--no-attest-scores": False,
                                         None: None}[flag]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "config"] == "config4"
    # without --secure the mesh runtime has no wallets to attest with
    assert cli(["--device", "cpu", "--config", "config4",
                "--attest-scores"]) == 2


def test_config4_secure_raises_naming_a12(monkeypatch):
    """Config 4's `secure=True` (ported): on the mesh runtime the preset
    hands the runtime secure aggregation and the 32 wallets of its seed
    (the reference's, byte for byte); on another runtime it raises."""
    from bflc_demo_tpu.comm.identity import provision_wallets as ref_wallets
    seen = {}

    def spy(model, shards, test_set, cfg, **kw):
        seen.update(kw, clients=cfg.client_num)
        return "ran"
    monkeypatch.setattr(configs, "run_with_runtime", spy)
    assert configs.config4_resnet_cifar100(rounds=1, n_data=400,
                                           secure=True) == "ran"
    assert seen["secure_aggregation"] is True
    assert (seen["participation"], seen["client_chunk"], seen["remat"]) \
        == ("active", 4, True)
    want, _ = ref_wallets(32, b"config4-secure-seed-0001")
    assert [w.address for w in seen["secure_wallets"]] == \
        [w.address for w in want]
    assert [w.dh_public_bytes for w in seen["secure_wallets"]] == \
        [w.dh_public_bytes for w in want]
    with pytest.raises(ValueError, match="mesh runtime"):
        configs.config4_resnet_cifar100(rounds=1, n_data=400, secure=True,
                                        runtime="host")
    assert set(configs.CONFIGS) == set(ref_configs.CONFIGS)
