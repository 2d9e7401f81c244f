"""The upload codecs of the port (`utils/codecs.py`) against the
reference's (`bflc_demo_tpu/utils/serialization.py`), on the CPU.

- Bytes: `pack_sparse` (and, at density 1, `pack_quantized`) give the
  reference's bytes over every delta dtype (f32, f16, i8) x density
  (1.0, 0.1, 0.01, and the densities that keep k = 0, 1, 2 and all 100
  entries of the 10 x 10 leaf) x codec (top-k, count-sketch), on a
  seeded tree with magnitude ties, -0.0, denormals, a rank-0 leaf,
  zero-size leaves, a float16 leaf and integer leaves (int32, and an
  int8 leaf that is not a quantized float), given as torch tensors to
  the port and as numpy arrays to the reference.
- Decodes: `densify_entries(dequantize_entries(unpack_pytree(blob)))`
  of each blob is the reference's bit for bit (keys, dtypes, shapes,
  bytes).
- Hostile blobs: the corpus of the reference's
  `tests/test_serialization.py:280-352` (out-of-bounds, duplicate and
  unsorted indices, an oversized count, a wrong record dtype, an orphan
  record, a count mismatch, a giant claimed shape, many records summing
  past the cap), and the count-sketch's own refusals (a leaf claimed by
  both record types, impossible geometry and ndim, a table size
  mismatch, an orphan, an empty shape, a non-float table, the decode
  cap) are refused by both packages with the same message.
- Error feedback: over 4 uploads with one lineage break (base epochs 0,
  1, 3, 4) the port's `_DeltaEncoder` emits the reference's blobs byte
  for byte (top-k/i8, sketch/f16, top-k/f32).
- Config 5 at full width (the transformer's 535,298 parameters): the
  count-sketch at densities 0.5 and 0.1 in f16, and top-k/i8 at 0.01,
  give the reference's blobs and decodes over 3 error-feedback uploads,
  its largest leaf sketched or sparsified.
- The arming decisions (`sparse_enabled`, `error_feedback_enabled`,
  `delta_codec`, `topk_count`, `sketch_geometry`) and the dense pin:
  density 1.0 and `BFLC_SPARSE_LEGACY=1` encode the dense blob.
- The merge checker's codec images (`meshagg/check.py`): its scenarios
  are the reference checker's (`tools/check_reduction_spec.py`) for
  every image, and its per-trial writer-merge hashes equal the
  reference engine's host leg on the same scenarios.
- A validator's sparse re-execution imports no torch (a subprocess).
- The CLI parses `--delta-dtype`, `--delta-density` and `--delta-codec`
  as the reference does; a density below 1 off the processes runtime,
  `--error-feedback` there or without a lossy encode exit 2, and
  `--error-feedback` exports `BFLC_ERROR_FEEDBACK=1` before the fleet
  spawns; the in-memory runtimes refuse a sparse genome.
"""

import hashlib
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bflc_demo_tpu.client import process_runtime as ref_pr
from bflc_demo_tpu.meshagg.engine import ENGINE as REF_ENGINE
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils import serialization as ref
from bflc_demo_tpu_torch.client import process_runtime as pr
from bflc_demo_tpu_torch.meshagg import check
from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import codecs
from bflc_demo_tpu_torch.utils import serialization as ser

REPO = pathlib.Path(__file__).resolve().parents[1]

DTYPES = ("f32", "f16", "i8")
# 1.0, 0.1, 0.01; then k = 0, 1, 2 and k = size (dense) for the 100-entry
# leaf ['W'] (0.01 is already k = 1 there)
DENSITIES = (1.0, 0.1, 0.01, 0.0, 0.02, 0.5, 0.999)
CODECS = ("topk", "sketch")


def _tree(seed=0):
    """{name: numpy array}: ties, -0.0 and denormals in ['W']."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((10, 10)).astype(np.float32)
    w.flat[[3, 17, 42]] = np.float32(2.5)          # magnitude ties
    w.flat[[5, 60]] = np.float32(-2.5)
    w.flat[7] = np.float32(-0.0)
    w.flat[[8, 9]] = np.float32([1e-42, -3e-40])    # denormals
    return {
        "W": w,
        "b": rng.standard_normal(7).astype(np.float32),
        "s": np.float32(rng.standard_normal()),       # rank 0
        "z": np.zeros((0,), np.float32),               # zero-size
        "e": np.zeros((3, 0), np.float32),
        "h": rng.standard_normal((4, 4)).astype(np.float16),
        "n": np.arange(-4, 5, dtype=np.int32),          # integer leaves
        "q": np.arange(-3, 3, dtype=np.int8),
    }


def _port_tree(tree):
    """The port's view: flat keystr keys, torch tensors."""
    return {f"['{k}']": torch.from_numpy(np.array(v)) for k, v in
            tree.items()}


def _same_entries(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoded_bytes_and_decodes_equal_the_references(dtype, density,
                                                        codec):
    tree = _tree()
    got = codecs.pack_sparse(_port_tree(tree), density, dtype, codec)
    want = ref.pack_sparse(tree, density, dtype, codec)
    assert got == want
    if density >= 1.0:
        assert codecs.pack_quantized(_port_tree(tree), dtype) == \
            ref.pack_quantized(tree, dtype) == want
    flat = ser.unpack_pytree(got)
    _same_entries(ser.densify_entries(ser.dequantize_entries(flat)),
                  ref.densify_entries(ref.dequantize_entries(
                      ref.unpack_pytree(want))))
    assert ser.pack_entries(flat) == got


def test_k_per_leaf_and_sketch_geometry_equal_the_references():
    for size in (0, 1, 2, 3, 7, 100, 535_298):
        for d in DENSITIES + (1e-7, 0.3333333):
            assert codecs.topk_count(size, d) == ref.topk_count(size, d)
            assert codecs.sketch_geometry(size, d) == \
                ref.sketch_geometry(size, d)
    # k = 0, 1, 2 and the whole leaf at the grid's densities
    assert [codecs.topk_count(100, d) for d in (0.0, 0.01, 0.02, 0.999)] \
        == [0, 1, 2, 100]
    for r in range(3):
        for a, b in zip(codecs._sketch_hashes("['W']", r, 100, 7),
                        ref._sketch_hashes("['W']", r, 100, 7)):
            assert a.tobytes() == b.tobytes()


def test_arming_decisions_and_dense_pin(monkeypatch):
    monkeypatch.delenv("BFLC_SPARSE_LEGACY", raising=False)
    monkeypatch.delenv("BFLC_ERROR_FEEDBACK", raising=False)
    for kw in (dict(), dict(delta_density=0.01), dict(delta_dtype="i8"),
               dict(delta_density=0.1, delta_codec="sketch",
                    delta_dtype="f16")):
        cfg, rcfg = ProtocolConfig(**kw), RefConfig(**kw)
        for env in ({}, {"BFLC_ERROR_FEEDBACK": "1"},
                    {"BFLC_SPARSE_LEGACY": "1", "BFLC_ERROR_FEEDBACK": "1"},
                    {"BFLC_ERROR_FEEDBACK": "0"}):
            for k in ("BFLC_SPARSE_LEGACY", "BFLC_ERROR_FEEDBACK"):
                monkeypatch.delenv(k, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            assert codecs.sparse_enabled(cfg) == ref.sparse_enabled(rcfg)
            assert codecs.error_feedback_enabled(cfg) == \
                ref.error_feedback_enabled(rcfg)
            assert codecs.delta_codec(cfg) == ref.delta_codec(rcfg)
    # the dense pin: density 1.0 is the dense blob, and the legacy switch
    # turns a density-armed encode into the dense one
    tree = _tree(1)
    dense = codecs.pack_pytree(_port_tree(tree))
    assert dense == ref.pack_pytree(tree)
    assert codecs.pack_sparse(_port_tree(tree), 1.0) == dense
    cfg = ProtocolConfig(delta_density=0.01)
    host = pr._host_delta(_port_tree(tree))
    assert pr._encode_delta(host, cfg) != dense
    monkeypatch.setenv("BFLC_SPARSE_LEGACY", "1")
    assert pr._encode_delta(host, cfg) == dense
    assert pr._encode_delta(host, ProtocolConfig(delta_dtype="i8")) == \
        ref.pack_quantized(tree, "i8")


# ------------------------------------------------------- hostile blobs
def _sparse_W():
    return ref.sparsify_entries(
        {"['W']": _tree(2)["W"], "['b']": _tree(2)["b"]}, 0.05)


def _mut_rec(key, fn):
    def make():
        s = dict(_sparse_W())
        s[key] = fn(s[key].copy())
        return s
    return make


def _oob(rec):
    rec[-1] = 10 ** 6
    return rec


def _dup(rec):
    rec[4] = rec[3]
    return rec


def _swap(rec):
    rec[3], rec[4] = rec[4].copy(), rec[3].copy()
    return rec


def _giant(rec):
    rec[1] = rec[2] = np.uint32(2 ** 31 - 1)
    return rec


def _oversized():
    s = dict(_sparse_W())
    key = "['W']#topk"
    ndim = int(s[key][0])
    s[key] = np.concatenate([s[key][:1 + ndim].copy(),
                             np.arange(2000, dtype=np.uint32)])
    s["['W']"] = np.zeros(2000, np.float32)
    return s


def _count_mismatch():
    s = dict(_sparse_W())
    s["['W']"] = np.append(s["['W']"], np.float32(1.0))
    return s


def _many_records():
    s = {}
    for i in range(8):
        k = f"['L{i}']"
        s[k] = np.zeros(0, np.float32)
        s[k + "#topk"] = np.asarray([2, 8192, 8192], np.uint32)
    return s


def _sketch():
    return ref.sketch_entries({"['W']": _tree(3)["W"],
                               "['b']": _tree(3)["b"]}, 0.1)


def _sk(fn):
    def make():
        s = dict(_sketch())
        fn(s)
        return s
    return make


def _sk_rec(fn):
    return _sk(lambda s: s.__setitem__("['W']#sketch",
                                       fn(s["['W']#sketch"].copy())))


HOSTILE = {
    "topk_out_of_bounds": _mut_rec("['W']#topk", _oob),
    "topk_duplicate": _mut_rec("['W']#topk", _dup),
    "topk_unsorted": _mut_rec("['W']#topk", _swap),
    "topk_oversized_count": _oversized,
    "topk_record_dtype": _mut_rec("['W']#topk",
                                  lambda r: r.astype(np.int64)),
    "topk_orphan": lambda: {"['W']#topk": _sparse_W()["['W']#topk"]},
    "topk_count_mismatch": _count_mismatch,
    "topk_giant_shape": _mut_rec("['W']#topk", _giant),
    "topk_many_records": _many_records,
    "topk_impossible_ndim": _mut_rec(
        "['W']#topk", lambda r: np.concatenate([[np.uint32(9)], r[1:]])),
    "topk_values_rank": lambda: dict(
        _sparse_W(), **{"['W']": _sparse_W()["['W']"].reshape(1, -1)}),
    "both_records": _sk(lambda s: s.__setitem__(
        "['W']#topk", _sparse_W()["['W']#topk"])),
    "sketch_depth_zero": _sk_rec(lambda r: np.concatenate(
        [r[:-2], np.uint32([0, r[-1]])])),
    "sketch_depth_five": _sk_rec(lambda r: np.concatenate(
        [r[:-2], np.uint32([5, r[-1]])])),
    "sketch_ndim": _sk_rec(lambda r: np.concatenate(
        [[np.uint32(3)], r[1:]])),
    "sketch_record_dtype": _sk_rec(lambda r: r.astype(np.int32)),
    "sketch_short_record": _sk_rec(lambda r: r[:2]),
    "sketch_table_size": _sk(lambda s: s.__setitem__(
        "['W']", s["['W']"][:-1])),
    "sketch_orphan": lambda: {"['W']#sketch": _sketch()["['W']#sketch"]},
    "sketch_int_table": _sk(lambda s: s.__setitem__(
        "['W']", s["['W']"].astype(np.int32))),
    "sketch_empty_shape": _sk_rec(lambda r: np.uint32(
        [2, 0, 10, r[-2], r[-1]])),
    "sketch_claimed_total": _sk_rec(lambda r: np.uint32(
        [2, 8192, 8192, r[-2], r[-1]])),
}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_hostile_blobs_refused_with_the_references_message(case):
    flat = HOSTILE[case]()
    with pytest.raises(ValueError) as want:
        ref.densify_entries(dict(flat))
    with pytest.raises(ValueError) as got:
        codecs.densify_entries(dict(flat))
    assert str(got.value) == str(want.value)
    # the same entries as a blob on the wire, through the one decode
    blob = ref.pack_entries(flat)
    with pytest.raises(ValueError) as got:
        ser.densify_entries(ser.dequantize_entries(ser.unpack_pytree(blob)))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ error feedback
@pytest.mark.parametrize("codec,dtype,density", [
    ("topk", "i8", 0.05), ("sketch", "f16", 0.1), ("topk", "f32", 0.02)])
def test_error_feedback_blobs_equal_the_references(monkeypatch, codec,
                                                   dtype, density):
    monkeypatch.setenv("BFLC_ERROR_FEEDBACK", "1")
    monkeypatch.delenv("BFLC_SPARSE_LEGACY", raising=False)
    kw = dict(delta_density=density, delta_dtype=dtype, delta_codec=codec)
    template = {"W": np.zeros((10, 10), np.float32),
                "b": np.zeros(7, np.float32)}
    renc = ref_pr._DeltaEncoder(RefConfig(**kw), template)
    enc = pr._DeltaEncoder(ProtocolConfig(**kw))
    assert enc.armed and renc.armed
    for r, base in enumerate((0, 1, 3, 4)):        # a break at 3
        rng = np.random.default_rng(50 + r)
        delta = {"W": rng.standard_normal((10, 10)).astype(np.float32),
                 "b": rng.standard_normal(7).astype(np.float32)}
        want = renc.encode(delta, base_epoch=base)
        got = enc.encode(pr._host_delta(_port_tree(delta)),
                         base_epoch=base)
        assert got == want, r
        for k in template:
            assert enc._residual[f"['{k}']"].tobytes() == \
                np.asarray(renc._residual[k]).tobytes()
    # a disarmed encoder is the plain encode
    monkeypatch.delenv("BFLC_ERROR_FEEDBACK")
    plain = pr._DeltaEncoder(ProtocolConfig(**kw))
    assert not plain.armed
    assert plain.encode(pr._host_delta(_port_tree(delta)), base_epoch=9) \
        == ref_pr._encode_delta(delta, RefConfig(**kw))


@pytest.mark.parametrize("codec,dtype,density", [
    ("sketch", "f16", 0.5), ("sketch", "f16", 0.1), ("topk", "i8", 0.01)])
def test_config5_width_blobs_and_decodes_equal_the_references(
        monkeypatch, codec, dtype, density):
    """The codecs over config 5's own leaves (vocab 1000 padded to 1024,
    seq 64, dim 128, depth 2): the largest leaf, the embedding table, is
    sketched (or sparsified) and the small ones pass through as the
    geometry says, and every blob and decode is the reference's."""
    import jax
    from bflc_demo_tpu.models.transformer import \
        make_transformer_classifier as ref_transformer
    monkeypatch.setenv("BFLC_ERROR_FEEDBACK", "1")
    monkeypatch.delenv("BFLC_SPARSE_LEGACY", raising=False)
    template = jax.tree_util.tree_map(np.asarray, ref_transformer(
        vocab_size=1000, seq_len=64, num_classes=2, dim=128, depth=2,
        heads=4).init_params(0))
    leaves = jax.tree_util.tree_flatten_with_path(template)[0]
    assert sum(v.size for _, v in leaves) == 535_298
    big = max(leaves, key=lambda pv: pv[1].size)
    assert jax.tree_util.keystr(big[0]) == "['embed']"
    if codec == "sketch":
        assert codecs.sketch_geometry(big[1].size, density) != (0, 0)
    kw = dict(delta_density=density, delta_dtype=dtype, delta_codec=codec)
    renc = ref_pr._DeltaEncoder(RefConfig(**kw), template)
    enc = pr._DeltaEncoder(ProtocolConfig(**kw))
    for r, base in enumerate((0, 1, 3)):           # a break at 3
        rng = np.random.default_rng(70 + r)
        delta = jax.tree_util.tree_map(
            lambda v: (0.01 * rng.standard_normal(v.shape)).astype(
                v.dtype), template)
        port_delta = {jax.tree_util.keystr(p): torch.from_numpy(
            np.array(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(delta)[0]}
        want = renc.encode(delta, base_epoch=base)
        got = enc.encode(pr._host_delta(port_delta), base_epoch=base)
        assert got == want, r
        assert len(got) < 0.6 * 4 * 535_298
        _same_entries(
            ser.densify_entries(ser.dequantize_entries(
                ser.unpack_pytree(got))),
            ref.densify_entries(ref.dequantize_entries(
                ref.unpack_pytree(want))))


# ------------------------------------------------- the merge checker
def _ref_checker():
    spec_ = importlib.util.spec_from_file_location(
        "ref_check_reduction_spec", REPO / "tools" / "check_reduction_spec.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def test_checker_hashes_equal_the_reference_checkers_first_trials():
    """The port's differential on the CPU (B5's plain version) draws the
    reference checker's scenarios, codec images included, and its
    writer-merge hash of each trial is the reference engine's."""
    rchk = _ref_checker()
    trials, seed, max_n = 10, 0, 12
    with np.errstate(over="ignore", invalid="ignore"):
        out = check.run_differential(MeshAggEngine(device="cpu"),
                                     trials=trials, seed=seed, max_n=max_n,
                                     blocks_sweep=(1, 8))
        rng = np.random.default_rng(seed)
        want, images = [], set()
        for _ in range(trials):
            g, deltas, weights, selected, lr, quant, dens, codec = \
                rchk._scenario(rng, max_n)
            images.add((quant, dens, codec if dens < 1.0 else ""))
            want.append(hashlib.sha256(ref.pack_entries(
                REF_ENGINE.aggregate_flat(g, deltas, weights, selected, lr,
                                          force_leg="host"))).hexdigest())
    assert out["mismatches"] == []
    assert out["hashes"] == want
    # the first trials cover quantized and sparse images
    assert any(q != "f32" for q, _, _ in images)
    assert any(d < 1.0 for _, d, _ in images)


# ---------------------------------------- validators import no torch
_VALIDATOR_PROBE = r"""
import hashlib, sys
import numpy as np
from bflc_demo_tpu_torch.comm.bft import ValidatorNode, check_sparse_upload_op
from bflc_demo_tpu_torch.comm.identity import Wallet
from bflc_demo_tpu_torch.ledger.base import encode_upload_op
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils.codecs import pack_sparse
cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                     needed_update_count=4, delta_density=0.05,
                     delta_dtype="i8", delta_codec=sys.argv[1])
rng = np.random.default_rng(5)
blob = pack_sparse({"['W']": rng.standard_normal((24, 16)).astype(
    np.float32)}, 0.05, "i8", sys.argv[1])
op = encode_upload_op("0xabc", hashlib.sha256(blob).digest(), 10, 1.0, 0)
assert check_sparse_upload_op(op, {"blob": blob.hex()}) == ""
node = ValidatorNode(cfg, Wallet.from_seed(b"sparse-no-torch"), 0,
                     require_auth=False)
try:
    assert node._sparse
    r = node._validate({"i": 0, "op": op.hex(), "auth": {"blob": blob.hex()}})
    assert r.get("status") != "SPARSE", r
    bad = node._validate({"i": 0, "op": op.hex(),
                          "auth": {"blob": (blob + b"x").hex()}})
    assert bad["status"] == "SPARSE", bad
finally:
    node.close()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "bflc_demo_tpu")))
"""


@pytest.mark.parametrize("codec", CODECS)
def test_validator_sparse_re_execution_imports_no_torch(codec):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _VALIDATOR_PROBE, codec],
                         capture_output=True, text=True, env=env,
                         cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# ------------------------------------------------------------- the CLI
def test_cli_parses_the_codec_flags_as_the_reference(monkeypatch):
    from bflc_demo_tpu.utils import flags as ref_flags
    from bflc_demo_tpu_torch.__main__ import _parser
    from bflc_demo_tpu_torch.utils import flags
    argv = ["--delta-dtype", "i8", "--delta-density", "0.01",
            "--delta-codec", "sketch", "--reduce-blocks", "8"]
    cfg = flags.parse_protocol(_parser().parse_args(argv))
    _, want = ref_flags.parse_args(argv)
    assert dataclasses_equal(cfg, want)
    assert (cfg.delta_dtype, cfg.delta_density, cfg.delta_codec) == \
        ("i8", 0.01, "sketch")
    with pytest.raises(SystemExit):
        _parser().parse_args(["--delta-dtype", "f8"])
    with pytest.raises(ValueError, match="delta_codec"):
        flags.parse_protocol(_parser().parse_args(["--delta-codec",
                                                   "zip"]))


def dataclasses_equal(cfg, want) -> bool:
    return all(getattr(want, k) == v for k, v in vars(cfg).items())


@pytest.mark.parametrize("argv,message", [
    (["--delta-density", "0.5"], "--delta-density < 1 applies to"),
    (["--runtime", "host", "--delta-density", "0.5"],
     "--delta-density < 1 applies to"),
    (["--error-feedback"], "--error-feedback applies to the processes"),
    (["--runtime", "processes", "--error-feedback"], "needs a lossy"),
    (["--runtime", "processes", "--error-feedback", "--delta-density",
      "1.0"], "needs a lossy")])
def test_cli_codec_gates_exit_2(capsys, monkeypatch, argv, message):
    from bflc_demo_tpu_torch.__main__ import main as cli
    monkeypatch.delenv("BFLC_SPARSE_LEGACY", raising=False)
    assert cli(["--device", "cpu", *argv]) == 2
    assert message in capsys.readouterr().err


def test_cli_error_feedback_reaches_the_children(monkeypatch):
    """`--error-feedback` with a lossy encode exports
    BFLC_ERROR_FEEDBACK=1 before the fleet spawns, as the reference's
    CLI does; an f16 encode alone is lossy enough."""
    import dataclasses

    from bflc_demo_tpu_torch.__main__ import main as cli
    from bflc_demo_tpu_torch.eval import configs

    class Spawned(Exception):
        pass

    def build(**kw):
        raise Spawned(os.environ.get("BFLC_ERROR_FEEDBACK"), kw["cfg"])

    monkeypatch.delenv("BFLC_ERROR_FEEDBACK", raising=False)
    monkeypatch.setitem(configs.CONFIGS, "config1", dataclasses.replace(
        configs.CONFIGS["config1"], build=build))
    with pytest.raises(Spawned) as got:
        cli(["--device", "cpu", "--runtime", "processes",
             "--error-feedback", "--delta-dtype", "f16"])
    assert got.value.args[0] == "1"
    assert got.value.args[1].delta_dtype == "f16"


def test_in_memory_runtimes_refuse_a_sparse_genome(monkeypatch):
    from bflc_demo_tpu_torch.eval import configs
    monkeypatch.delenv("BFLC_SPARSE_LEGACY", raising=False)
    cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                         needed_update_count=3, delta_density=0.5)
    for runtime in ("mesh", "host", "threaded"):
        with pytest.raises(ValueError, match="delta_density"):
            configs.run_with_runtime(None, [], None, cfg, runtime=runtime,
                                     device="cpu")
    # the legacy pin makes the genome dense again
    monkeypatch.setenv("BFLC_SPARSE_LEGACY", "1")
    assert not codecs.sparse_enabled(cfg)
