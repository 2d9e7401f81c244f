"""The port's certified merge engine against the reference's.

- `meshagg/spec.py` is a copy: every function gives the reference's bytes.
- The port engine's host leg and its mesh leg on the CPU (kernel B5's
  plain version) give the bytes of the reference's `spec.host_weighted_sum`
  and `blocked_host_weighted_sum`, blocks 1, 2, 5, 8 and 64, on the
  self-check scenario, FTZ products, a -0 accumulator normalised by a
  masked +0, NaN and inf in an unselected slot, +-inf in selected slots
  (whose sum is x86's default NaN 0xFFC00000) and randomized dense
  scenarios; the writer merge's hashes equal the reference ENGINE's and
  the pre-engine golden digest.
- The legacy and min-batch policy, the self-check, `compile_total`, and a
  `cuda` engine that raises where the reference falls back.
- `score_candidates_batched`, the health stats (host leg exact; the
  device leg in float32 within 1e-5 relative of the float64 host leg),
  and `python -m bflc_demo_tpu_torch.meshagg.check --device cpu`.
"""

import hashlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.meshagg import engine as ref_engine
from bflc_demo_tpu.meshagg import spec as ref_spec
from bflc_demo_tpu.meshagg import stats as ref_stats
from bflc_demo_tpu.models import make_softmax_regression as ref_softmax
from bflc_demo_tpu_torch.meshagg import check, engine, spec, stats
from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine, flatten_delta
from bflc_demo_tpu_torch.models import make_softmax_regression
from bflc_demo_tpu_torch.ops import certified_reduce as cr
from bflc_demo_tpu_torch.utils.serialization import canonical_bytes

REPO = pathlib.Path(__file__).resolve().parents[1]
BLOCKS = (1, 2, 5, 8, 64)
DEFAULT_NAN = 0xFFC00000
# the pre-engine writer merge's digest (tests/test_meshagg.py GOLDEN_AGG)
GOLDEN_AGG = ("df85ae5b7b16077404d72e33805da33a"
              "0d0f97509c3fdcdc91e55ed5e5747ee1")


def _digest(flat) -> str:
    return hashlib.sha256(canonical_bytes(flat)).hexdigest()


def _bytes(d):
    return {k: np.asarray(v, np.float32).tobytes() for k, v in d.items()}


CASES = check.corner_cases()


def _keys_wsum(flats, w):
    return sorted(flats[0]), max(float(w.sum()), 1e-12)


# ------------------------------------------------------------ spec copy
@pytest.mark.parametrize("name", list(CASES))
def test_spec_copy_bit_equal(name):
    flats, w = CASES[name]
    keys, wsum = _keys_wsum(flats, w)
    with np.errstate(all="ignore"):
        for fn in ("host_weighted_sum", "legacy_host_weighted_sum"):
            assert _bytes(getattr(spec, fn)(keys, flats, w, wsum)) == \
                _bytes(getattr(ref_spec, fn)(keys, flats, w, wsum)), fn
        p = sum(np.asarray(flats[0][k]).size for k in keys)
        for b in BLOCKS:
            b = min(b, p)
            assert spec.block_bounds(p, b) == ref_spec.block_bounds(p, b)
            assert _bytes(spec.blocked_host_weighted_sum(
                keys, flats, w, wsum, b)) == _bytes(
                ref_spec.blocked_host_weighted_sum(keys, flats, w, wsum, b))
        accs = spec.host_weighted_sum(keys, flats, w, wsum)
        g = {k: np.ones_like(np.asarray(flats[0][k])) for k in keys}
        assert _bytes(spec.apply_step(g, accs, 0.05)) == \
            _bytes(ref_spec.apply_step(g, accs, 0.05))
        x = np.concatenate([np.ravel(f[k]) for f in flats for k in keys])
        assert spec._daz(x).tobytes() == ref_spec._daz(x).tobytes()
    sel = [i for i in range(len(w)) if w[i] > 0]
    np.testing.assert_array_equal(
        spec.merge_weight_vector(w.tolist(), sel, len(w)),
        ref_spec.merge_weight_vector(w.tolist(), sel, len(w)))
    assert spec.merge_coefficients(w, wsum).tobytes() == \
        ref_spec.merge_coefficients(w, wsum).tobytes()
    assert spec.SPEC_VERSION == ref_spec.SPEC_VERSION == 2
    with pytest.raises(ValueError, match="degenerate"):
        spec.block_bounds(3, 4)


# -------------------------------------------------------------- the legs
@pytest.mark.parametrize("name", list(CASES))
def test_engine_legs_give_the_spec_bytes(name):
    flats, w = CASES[name]
    keys, wsum = _keys_wsum(flats, w)
    eng = MeshAggEngine(device="cpu")
    p = sum(np.asarray(flats[0][k]).size for k in keys)
    with np.errstate(all="ignore"):
        want = _bytes(ref_spec.host_weighted_sum(keys, flats, w, wsum))
        for b in BLOCKS:
            b = min(b, p)
            assert _bytes(ref_spec.blocked_host_weighted_sum(
                keys, flats, w, wsum, b)) == want
            for leg in ("host", "mesh"):
                got = eng.weighted_sum(keys, flats, w, wsum, force_leg=leg,
                                       blocks=b)
                assert _bytes(got) == want, (leg, b)
    if name == "selected_inf":
        acc = spec.host_weighted_sum(keys, flats, w, wsum)["x"]
        assert acc[:3].view(np.uint32).tolist() == [DEFAULT_NAN] * 3
        assert np.isposinf(acc[3]) and np.isfinite(acc[4:]).all()
    if name == "neg_zero":
        acc = spec.host_weighted_sum(keys, flats, w, wsum)["x"]
        assert acc.view(np.uint32).tolist() == [0, 0, 0, 0]   # all +0


def test_plain_kernel_version_rules():
    """B5's plain version on single ops: daz keeps the sign and NaN, an
    invalid sum gives 0xFFC00000, a NaN operand's payload is kept."""
    x = torch.tensor(np.uint32([0x00000001, 0x80000001, 0x7F800000,
                                0x7FA00001, 0x00800000]).view(np.float32))
    got = cr.daz(x).numpy().view(np.uint32).tolist()
    assert got == [0, 0x80000000, 0x7F800000, 0x7FE00001, 0x00800000]
    mat = torch.tensor([[np.inf, 1.0, np.float32(np.uint32(0x7FC00007)
                                                  .view(np.float32))],
                        [-np.inf, np.nan, 2.0]], dtype=torch.float32)
    out = cr.certified_reduce(mat, torch.tensor([0.5, 0.5]),
                              torch.tensor([True, True]))
    assert out.numpy().view(np.uint32)[0] == DEFAULT_NAN
    assert np.isnan(out.numpy()[1])
    assert out.numpy().view(np.uint32)[2] == 0x7FC00007
    with pytest.raises(ValueError):
        cr.certified_reduce(mat.double(), torch.tensor([0.5, 0.5]),
                            torch.tensor([True, True]))
    with pytest.raises(ValueError):
        cr.certified_reduce(mat, torch.tensor([0.5]), torch.tensor([True]))
    assert cr.LAUNCHES["certified_reduce"] == 0      # no kernel on the CPU


# ------------------------------------------------------- writer merge
def _golden_scenario():
    rng = np.random.default_rng(20260804)
    keys = ["/W1", "/b1", "/W2", "/b2"]
    shapes = {"/W1": (16, 8), "/b1": (8,), "/W2": (8, 3), "/b2": (3,)}
    g = {k: rng.standard_normal(shapes[k]).astype(np.float32) for k in keys}
    deltas = [{k: rng.standard_normal(shapes[k]).astype(np.float32)
               for k in keys} for _ in range(12)]
    weights = [float(10 + i) * (1.0 / np.sqrt(1.0 + (i % 4)))
               for i in range(12)]
    return keys, g, deltas, weights, [0, 2, 3, 5, 7, 8, 10]


@pytest.mark.parametrize("blocks", BLOCKS)
def test_writer_merge_hashes_equal_reference(blocks):
    keys, g, deltas, weights, selected = _golden_scenario()
    rows = [flatten_delta(d, sorted(keys)) for d in deltas]
    want = _digest(ref_engine.ENGINE.aggregate_flat(
        g, deltas, weights, selected, 0.05, force_leg="host"))
    assert want == GOLDEN_AGG
    want_rows = _digest(ref_engine.ENGINE.aggregate_rows(
        g, rows, weights, selected, 0.05, force_leg="host"))
    eng = MeshAggEngine(device="cpu")
    for leg in ("host", "mesh"):
        assert _digest(eng.aggregate_flat(g, deltas, weights, selected,
                                          0.05, force_leg=leg,
                                          blocks=blocks)) == want
        assert _digest(eng.aggregate_rows(g, rows, weights, selected, 0.05,
                                          force_leg=leg,
                                          blocks=blocks)) == want_rows
    np.testing.assert_array_equal(
        flatten_delta(deltas[0], sorted(keys)),
        ref_engine.flatten_delta(deltas[0], sorted(keys)))
    assert engine._leaf_layout(sorted(keys), g) == \
        ref_engine._leaf_layout(sorted(keys), g)


# ---------------------------------------------------------------- policy
def test_legacy_and_min_batch_policy(monkeypatch):
    keys, g, deltas, weights, selected = _golden_scenario()
    eng = MeshAggEngine(device="cpu")
    monkeypatch.setenv("BFLC_MESH_AGG_LEGACY", "1")
    assert eng.choose_leg(10_000) == "legacy"
    assert not eng.staging_worthwhile(10_000)
    assert _digest(eng.aggregate_flat(g, deltas, weights, selected,
                                      0.05)) == GOLDEN_AGG
    assert eng.last_leg == "legacy" and eng.report()["legacy_pin"]
    monkeypatch.delenv("BFLC_MESH_AGG_LEGACY")
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "8")
    assert eng.report()["selfcheck"] == "untested"
    assert eng.choose_leg(7) == "host"
    assert eng.report()["selfcheck"] == "untested"    # not armed below
    assert eng.staging_worthwhile(12) and not eng.staging_worthwhile(7)
    assert eng.choose_leg(8) == "mesh"
    assert eng.report()["selfcheck"] == "ok"
    assert _digest(eng.aggregate_flat(g, deltas, weights, selected,
                                      0.05)) == GOLDEN_AGG
    assert eng.last_leg == "mesh" and eng.calls["mesh"] == 1
    eng.aggregate_flat(g, deltas, weights, selected, 0.05, blocks=3)
    assert eng.last_leg == "blocked" and eng.last_blocks == 3
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "junk")
    assert eng.report()["min_batch"] == 16       # the default
    assert ref_engine._min_batch() == 16


def test_compile_total_counts_launch_geometries():
    eng = MeshAggEngine(device="cpu")
    rng = np.random.default_rng(3)
    deltas = [{"/x": rng.standard_normal((6, 5)).astype(np.float32)}
              for _ in range(21)]
    w = spec.merge_weight_vector([1.0] * 21, list(range(21)), 21)
    for _ in range(2):
        eng.weighted_sum(["/x"], deltas, w, float(w.sum()),
                         force_leg="mesh")
    assert eng.compile_total == 1
    # a same-size different tree shares the (N, P) geometry
    deltas2 = [{"/a": rng.standard_normal((3, 5)).astype(np.float32),
                "/b": rng.standard_normal((15,)).astype(np.float32)}
               for _ in range(21)]
    eng.weighted_sum(["/a", "/b"], deltas2, w, float(w.sum()),
                     force_leg="mesh")
    assert eng.compile_total == 1
    # 30 elements in 4 blocks: (21, 8) three times, then (21, 6)
    eng.weighted_sum(["/x"], deltas, w, float(w.sum()), force_leg="mesh",
                     blocks=4)
    assert eng.compile_total == 3 and eng.report()["cached_programs"] == 3


def _broken_mesh(eng, monkeypatch):
    """Make the mesh leg return the host bytes plus one ulp."""
    def wrong(keys, flats, w, wsum, blocks=1):
        out = spec.host_weighted_sum(keys, flats, w, wsum)
        return {k: (np.asarray(v).view(np.uint32) + 1).view(np.float32)
                for k, v in out.items()}
    monkeypatch.setattr(eng, "_mesh_weighted_sum", wrong)


def test_failing_selfcheck_raises_on_a_cuda_engine(monkeypatch):
    eng = MeshAggEngine(device="cpu")
    eng._device = torch.device("cuda")          # no card needed to fail
    _broken_mesh(eng, monkeypatch)
    with pytest.raises(RuntimeError, match="diverged"):
        eng.run_selfcheck()
    # a failing launch on the card raises too, never the host loop
    eng2 = MeshAggEngine(device="cpu")
    eng2._device = torch.device("cuda")
    eng2._selfcheck = True

    def boom(*a, **k):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(eng2, "_mesh_rows", boom)
    keys, g, deltas, weights, selected = _golden_scenario()
    with pytest.raises(RuntimeError, match="launch failed"):
        eng2.aggregate_flat(g, deltas, weights, selected, 0.05,
                            force_leg="mesh")
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    with pytest.raises(RuntimeError, match="launch failed"):
        eng2.aggregate_rows(g, [flatten_delta(d, sorted(keys))
                                for d in deltas], weights, selected, 0.05)


def test_failing_selfcheck_on_the_cpu_pins_the_host_loop(monkeypatch):
    """A `cpu` engine keeps the reference's policy: warn, host loop."""
    eng = MeshAggEngine(device="cpu")
    _broken_mesh(eng, monkeypatch)
    monkeypatch.setenv("BFLC_MESH_AGG_MIN", "1")
    with pytest.warns(RuntimeWarning, match="diverged"):
        assert eng.choose_leg(50) == "host"
    assert eng.report()["selfcheck"] == "FAILED"
    assert not eng.staging_worthwhile(50)


def test_engine_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = MeshAggEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eng.run_selfcheck()
    # the host leg and the policy below the min batch need no device
    keys, g, deltas, weights, selected = _golden_scenario()
    assert _digest(eng.aggregate_flat(g, deltas, weights, selected,
                                      0.05)) == GOLDEN_AGG


# --------------------------------------------------------------- scoring
def test_score_candidates_batched_equals_reference():
    rng = np.random.default_rng(5)
    params = {"W": rng.standard_normal((5, 2)).astype(np.float32),
              "b": rng.standard_normal(2).astype(np.float32)}
    deltas = [{k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in params.items()} for _ in range(7)]
    x = rng.standard_normal((60, 5)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 60)]
    want = np.asarray(ref_engine.score_candidates_batched(
        ref_softmax().apply, jax.tree_util.tree_map(jnp.asarray, params),
        [jax.tree_util.tree_map(jnp.asarray, d) for d in deltas], 0.3,
        jnp.asarray(x), jnp.asarray(y)))
    model = make_softmax_regression()
    port = {f"['{k}']": torch.as_tensor(v) for k, v in params.items()}
    pdeltas = [{f"['{k}']": torch.as_tensor(v) for k, v in d.items()}
               for d in deltas]
    got = engine.score_candidates_batched(model, port, pdeltas, 0.3,
                                          torch.as_tensor(x),
                                          torch.as_tensor(y))
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()
    keys = sorted(port)
    rows = [flatten_delta({k: v.numpy() for k, v in d.items()}, keys)
            for d in pdeltas]
    stacked = engine.stacked_tree_from_rows(
        rows, {k: v.numpy() for k, v in port.items()}, device="cpu")
    again = engine.score_candidates_batched(model, port, None, 0.3,
                                            torch.as_tensor(x),
                                            torch.as_tensor(y),
                                            stacked=stacked)
    assert torch.equal(got, again)


# ----------------------------------------------------------------- stats
def _stats_case():
    rng = np.random.default_rng(8)
    mat = rng.standard_normal((20, 301)).astype(np.float32)
    mat[3, :50] = 0.0
    mat[4, 7] = np.nan
    mat[5, 9] = np.inf
    mat[6] = -mat[0]
    ref = rng.standard_normal(301).astype(np.float32)
    ref[2] = np.nan
    return mat, ref


def test_stats_host_leg_equals_reference():
    mat, ref = _stats_case()
    for r in (None, ref, np.zeros(301, np.float32)):
        got = stats.batch_delta_stats(mat, r)
        want = ref_stats._host_stats(mat, r)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    layout = [("a", 0, 100, (100,)), ("b", 100, 201, (201,))]
    got = stats.per_leaf_stats(mat, layout, ref)
    want = ref_stats.per_leaf_stats(mat, layout, ref)
    for k in want:
        for s in ("l2", "cos"):
            np.testing.assert_array_equal(got[k][s], want[k][s])
    np.testing.assert_array_equal(
        stats.weighted_mean_row(mat, [1.0] * 20, [0, 3, 5]),
        ref_stats.weighted_mean_row(mat, [1.0] * 20, [0, 3, 5]))
    assert stats.batch_delta_stats(np.zeros((0, 4), np.float32))["l2"] \
        .shape == (0,)
    with pytest.raises(ValueError):
        stats.batch_delta_stats(np.zeros(4, np.float32))


def test_stats_device_leg_within_tolerance(monkeypatch):
    """The opt-in device leg, float32, against the float64 host leg:
    within 1e-5 relative (float32 sums of 301 terms); counts exact."""
    mat, ref = _stats_case()
    monkeypatch.setenv("BFLC_HEALTH_STATS_JIT", "1")
    for r in (None, ref):
        got = stats.batch_delta_stats(mat, r, device="cpu")
        want = ref_stats._host_stats(mat, r)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got["nonfinite"], want["nonfinite"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stats.batch_delta_stats(mat, ref)        # raises, never numpy
    monkeypatch.setenv("BFLC_MESH_AGG_LEGACY", "1")
    assert stats.batch_delta_stats(mat, ref)["l2"].shape == (20,)


# --------------------------------------------------------------- checker
def _ref_checker():
    spec_ = importlib.util.spec_from_file_location(
        "ref_check_reduction_spec", REPO / "tools" / "check_reduction_spec.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def test_checker_scenarios_follow_the_reference_stream():
    """Every scenario is the reference's, in every decode image (f32,
    f16 and i8 crossed with densities 1, 0.1 and 0.01 and the top-k and
    count-sketch codecs): the codecs are ported (ROADMAP A9 item 7)."""
    ref = _ref_checker()
    images = set()
    with np.errstate(over="ignore", invalid="ignore"):
        for seed in range(12):
            a = check._scenario(np.random.default_rng(seed), 16)
            b = ref._scenario(np.random.default_rng(seed), 16)
            g, deltas, weights, selected, lr, quant, density, codec = a
            assert (quant, density, codec) == tuple(b[5:])
            images.add((quant, density))
            assert _bytes(g) == _bytes(b[0])
            assert [_bytes(d) for d in deltas] == [_bytes(d) for d in b[1]]
            assert (weights, selected, lr) == (b[2], b[3], b[4])
    assert len(images) >= 4


def test_check_main_exits_zero_on_the_cpu(capsys):
    assert check.main(["--device", "cpu", "--trials", "3", "--max-n",
                       "12"]) == 0
    out = capsys.readouterr().out
    assert "byte-identical" in out and "fresh after warmup 0" in out


def test_merge_geometries():
    from bflc_demo_tpu.models.resnet import make_resnet18
    shapes = jax.eval_shape(make_resnet18().init, jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert check.resnet18_leaf_shapes() == want
    assert sum(int(np.prod(s)) for s in want.values()) == 11_220_132
    assert sum(int(np.prod(s)) for s in
               check.config5_leaf_shapes().values()) == 535_298
    g, rows, weights, selected, lr = check.geometry_case("drain_64")
    assert len(rows) == 64 and rows[0].shape == (9600,)
    assert selected == list(range(64)) and len(g) == 24


def test_b5_sixteen_byte_copies_refuse_an_unaligned_view():
    """The strips' 16-byte copies need every row on 16 bytes; a forced
    launch on another view raises before the kernel is touched."""
    m = torch.zeros(3, 44)
    assert cr.aligned16(m[:, :8]) and cr.aligned16(m[:, 4:12])
    assert not cr.aligned16(m[:, 1:9])
    assert not cr.aligned16(torch.zeros(3, 41)[:, :8])      # row stride
    c, g = torch.ones(3), torch.ones(3, dtype=torch.bool)
    for view in (m[:, 1:9], torch.zeros(3, 41)[:, :8]):
        with pytest.raises(ValueError, match="16-byte"):
            cr._launch(view, c, g, 8, 4)
