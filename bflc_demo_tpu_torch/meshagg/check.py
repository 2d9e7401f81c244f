"""Differential checker for REDUCTION SPEC v2 on the port's engine.

Port of `tools/check_reduction_spec.py` — `_sparse_image`,
`_random_flat` and `_scenario` (:53-113), `run_differential`
(:119-192), `run_steady_state_check` (:195-225) and `main` (:398-454):
randomized trees (mixed leaf ranks, 0-d leaves, denormal and
near-overflow magnitudes) in every decode image the data plane admits —
f32, f16- and i8-decoded, crossed with densities 1, 0.1 and 0.01,
crossed with the top-k and count-sketch codecs, each through the wire's
sparse-encode -> quantize -> dequantize -> densify chain
(`utils/codecs.py`) — sync and FedBuff weights, random selections
(empty and full among them), each reduced by the host leg and by the
mesh leg (kernel B5 on `--device`), plain and under ``reduce_blocks`` in
{1, 2, 8, 64}, compared byte for byte, plus the writer merge's
canonical-bytes hash (each trial's in `hashes`); then the steady-state
gate (a repeated scenario launches at no new geometry).

    python -m bflc_demo_tpu_torch.meshagg.check [--trials 20] [--seed 0]
            [--max-n 64] [--device cuda|cpu]

exit 0 = every scenario matched; exit 1 = divergence (prints it).  The
default device is the card's; `--device cpu` holds B5's plain version.

The rederive leg (`run_rederive_differential`, :228-319) and the
density-transition leg (`run_density_transition_differential`,
:322-395): the writer's merge and the validators' re-derivation
(`rederive/core.py`, full and per shard, plain and blocked) over the
raw wire blobs must give one committed hash, and a round whose blobs
straddle a density or codec change re-derives byte-identically.  Both
run on the checker's engine and report each trial's writer hash
(`hashes`).

Also here: the merge geometries `chip_smoke.py` runs B5 at — config 5's
and config 4's writer merges, the reference benchmark's full drains and
config 5's hier merges, a cell's partial of its 3 admitted members and
the root's merge of 2 cell partials (`GEOMETRIES`), with
ResNet-18/CIFAR-100's leaf shapes written out (`resnet18_leaf_shapes`,
P = 11,220,132).
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from typing import Dict, List, Tuple

import numpy as np

from bflc_demo_tpu_torch.ledger.base import staleness_weight
from bflc_demo_tpu_torch.meshagg import spec
from bflc_demo_tpu_torch.meshagg.engine import (MeshAggEngine,
                                               selfcheck_scenario)
from bflc_demo_tpu_torch.utils.codecs import (canonical_bytes,
                                              densify_entries,
                                              dequantize_entries,
                                              quantize_entries,
                                              sketch_entries,
                                              sparsify_entries)

BLOCKS_SWEEP = (1, 2, 8, 64)
CORNER_BLOCKS = (1, 2, 5, 8, 64)


def _digest(flat: Dict[str, np.ndarray]) -> bytes:
    return hashlib.sha256(canonical_bytes(flat)).digest()


def _sparse_image(flat, density, codec):
    """The sparse encoder's image: `#topk` records or `#sketch` tables,
    the two wire forms `densify_entries` inverts."""
    if codec == "sketch":
        return sketch_entries(flat, density)
    return sparsify_entries(flat, density)


def _random_flat(rng, shapes, quant, density=1.0, codec="topk"):
    """One delta in the chosen decode image: what admission, the scorers
    and the merge see of a sparse and/or quantized upload (sparsify or
    sketch before quantize, densify after dequantize: the wire order)."""
    flat = {}
    for k, shp in shapes.items():
        scale = 10.0 ** float(rng.integers(-8, 8))
        flat[k] = (rng.standard_normal(shp) * scale).astype(np.float32)
    if quant == "f32" and density >= 1.0:
        return flat
    return densify_entries(dequantize_entries(
        quantize_entries(_sparse_image(flat, density, codec), quant)))


def _scenario(rng, max_n):
    n = int(rng.integers(1, max_n + 1))
    n_leaves = int(rng.integers(1, 6))
    shapes = {}
    for j in range(n_leaves):
        rank = int(rng.integers(0, 3))
        shapes[f"/leaf{j}"] = tuple(
            int(d) for d in rng.integers(1, 9, size=rank))
    quant = ("f32", "f16", "i8")[int(rng.integers(0, 3))]
    density = (1.0, 0.1, 0.01)[int(rng.integers(0, 3))]
    codec = ("topk", "sketch")[int(rng.integers(0, 2))]
    deltas = [_random_flat(rng, shapes, quant, density, codec)
              for _ in range(n)]
    if deltas and "/leaf0" in deltas[0] and deltas[0]["/leaf0"].size:
        deltas[0]["/leaf0"].flat[0] = np.float32(1e-42)      # denormal
    if rng.integers(0, 2):
        weights = [float(rng.integers(1, 2000)) for _ in range(n)]
    else:
        weights = [float(np.float32(
            int(rng.integers(1, 2000))
            * staleness_weight(int(rng.integers(0, 20)))))
            for _ in range(n)]
    n_sel = int(rng.integers(0, n + 1))
    selected = sorted(int(i) for i in
                      rng.choice(n, size=n_sel, replace=False))
    lr = float(rng.random()) * 0.5
    g = {k: rng.standard_normal(shp).astype(np.float32)
         for k, shp in shapes.items()}
    return g, deltas, weights, selected, lr, quant, density, codec


def _p_total(deltas, keys) -> int:
    return sum(int(np.asarray(deltas[0][k]).size)
               for k in keys) if deltas else 0


def run_differential(engine: MeshAggEngine, trials: int = 20, seed: int = 0,
                     max_n: int = 64, blocks_sweep=BLOCKS_SWEEP) -> dict:
    """Host leg vs mesh leg over `trials` randomized scenarios, each also
    under every ``reduce_blocks`` of `blocks_sweep` (blocked host
    reference and blocked mesh leg, both against the v1 host bytes).
    Empty `mismatches` means the spec held."""
    rng = np.random.default_rng(seed)
    mismatches, hashes = [], []
    engine.run_selfcheck()
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(trials):
            g, deltas, weights, selected, lr, quant, density, codec = \
                _scenario(rng, max_n)
            keys = sorted(g.keys())
            w = spec.merge_weight_vector(weights, selected, len(deltas))
            wsum = max(float(w.sum()), 1e-12)
            host = engine.weighted_sum(keys, deltas, w, wsum,
                                       force_leg="host")
            mesh = engine.weighted_sum(keys, deltas, w, wsum,
                                       force_leg="mesh")
            bad = [k for k in keys if np.asarray(host[k]).tobytes()
                   != np.asarray(mesh[k]).tobytes()]
            p_total = _p_total(deltas, keys)
            for b in blocks_sweep:
                eff = min(int(b), max(p_total, 1))
                for leg in ("host", "mesh"):
                    got = engine.weighted_sum(keys, deltas, w, wsum,
                                              force_leg=leg, blocks=eff)
                    bad.extend(f"#blocked-{leg}-b{b}:{k}" for k in keys
                               if np.asarray(got[k]).tobytes()
                               != np.asarray(host[k]).tobytes())
            h_hash = _digest(engine.aggregate_flat(
                g, deltas, weights, selected, lr, force_leg="host"))
            if h_hash != _digest(engine.aggregate_flat(
                    g, deltas, weights, selected, lr, force_leg="mesh")):
                bad.append("#aggregate_flat-hash")
            blk = min(int(blocks_sweep[-1]) if blocks_sweep else 1,
                      max(p_total, 1))
            if h_hash != _digest(engine.aggregate_flat(
                    g, deltas, weights, selected, lr, force_leg="mesh",
                    blocks=blk)):
                bad.append("#aggregate_flat-blocked-hash")
            if bad:
                mismatches.append({"trial": t, "n": len(deltas),
                                   "quant": quant, "density": density,
                                   "codec": codec,
                                   "selected": len(selected),
                                   "leaves": bad})
            hashes.append(h_hash.hex())
    return {"trials": trials, "seed": seed, "max_n": max_n,
            "mismatches": mismatches, "hashes": hashes,
            "compile_total": engine.compile_total,
            "report": engine.report()}


def run_steady_state_check(engine: MeshAggEngine, repeats: int = 3,
                           seed: int = 0, max_n: int = 16) -> dict:
    """One fixed scenario reduced `repeats` times through the mesh leg,
    plain and blocked: after the first pass no new launch geometry may
    appear.  The gate holds iff ``fresh_after_warmup == 0``."""
    rng = np.random.default_rng(seed)
    g, deltas, weights, selected, lr = _scenario(rng, max_n)[:5]
    keys = sorted(g.keys())
    w = spec.merge_weight_vector(weights, selected, len(deltas))
    wsum = max(float(w.sum()), 1e-12)
    blk = min(8, max(_p_total(deltas, keys), 1))
    totals = []
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(max(int(repeats), 2)):
            engine.weighted_sum(keys, deltas, w, wsum, force_leg="mesh")
            engine.weighted_sum(keys, deltas, w, wsum, force_leg="mesh",
                                blocks=blk)
            engine.aggregate_flat(g, deltas, weights, selected, lr,
                                  force_leg="mesh")
            totals.append(int(engine.compile_total))
    return {"repeats": len(totals), "compile_totals": totals,
            "fresh_after_warmup": totals[-1] - totals[0]}


# ---------------------------------------------------------- corner cases
def _ftz_case():
    """Products that land in the subnormal range, of both signs, and a
    subnormal delta and a subnormal coefficient, all flushed."""
    rng = np.random.default_rng(11)
    flats = [{"x": (rng.standard_normal(40) * 1e-37).astype(np.float32)}
             for _ in range(6)]
    flats[1]["x"][:4] = np.float32([1e-42, -1e-42, 5e-39, -5e-39])
    w = np.float32([3.0, 1.0, 0.0, 2.0, 1e-38, 5.0])
    return flats, w


def _neg_zero_case():
    """An accumulator that flushes to -0 (a negative subnormal sum), then
    an unselected slot whose masked +0.0 normalises it to +0."""
    flats = [{"x": np.float32([-1e-38, -1e-30, 0.0, -0.0])},
             {"x": np.float32([9.9e-39, 1e-30, -0.0, -0.0])},
             {"x": np.float32([7.0, 7.0, 7.0, 7.0])}]
    w = np.float32([1.0, 1.0, 0.0])
    return flats, w


def _masked_nan_case():
    """NaN (with a payload), inf and -inf in an unselected slot never
    reach the sum."""
    rng = np.random.default_rng(12)
    flats = [{"x": rng.standard_normal(24).astype(np.float32)}
             for _ in range(5)]
    bad = flats[2]["x"]
    bad[:4] = np.float32([np.nan, np.inf, -np.inf, 1.0])
    bad[4:5] = np.uint32([0x7FC01234]).view(np.float32)
    w = np.float32([2.0, 1.0, 0.0, 4.0, 3.0])
    return flats, w


def _selected_inf_case():
    """+inf and -inf of two selected slots meet in one element: x86's
    default NaN 0xFFC00000, carried through the later slots."""
    rng = np.random.default_rng(13)
    flats = [{"x": rng.standard_normal(20).astype(np.float32)}
             for _ in range(5)]
    flats[1]["x"][:3] = np.float32([np.inf, -np.inf, np.inf])
    flats[3]["x"][:4] = np.float32([-np.inf, np.inf, -np.inf, np.inf])
    w = np.float32([1.0, 2.0, 0.0, 2.0, 1.0])
    return flats, w


def _random_case(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 40))
    shapes = {f"/l{j}": tuple(int(d) for d in rng.integers(
        1, 9, size=int(rng.integers(0, 3)))) for j in range(4)}
    flats = [{k: (rng.standard_normal(s) * 10.0 ** float(rng.integers(-8, 8))
                  ).astype(np.float32) for k, s in shapes.items()}
             for _ in range(n)]
    w = rng.integers(1, 2000, n).astype(np.float32)
    w[rng.random(n) < 0.4] = 0.0
    return flats, w


def corner_cases() -> Dict[str, Tuple[List[Dict[str, np.ndarray]],
                                      np.ndarray]]:
    """name -> (delta flats, weights w): the spec's corners (steps 3-4)
    and four random dense scenarios — what the CPU tests and
    `chip_smoke.py` hold every leg to, blocks 1, 2, 5, 8 and 64."""
    flats, w = selfcheck_scenario()
    cases = {"selfcheck": (flats, w), "ftz": _ftz_case(),
             "neg_zero": _neg_zero_case(), "masked_nan": _masked_nan_case(),
             "selected_inf": _selected_inf_case()}
    cases.update({f"random{i}": _random_case(i) for i in range(4)})
    return cases


def run_corner_cases(engine: MeshAggEngine,
                     blocks_sweep=CORNER_BLOCKS) -> List[str]:
    """Every corner case through both legs and every block count, byte
    for byte against `spec.host_weighted_sum`; returns the mismatches."""
    bad = []
    with np.errstate(all="ignore"):
        for name, (flats, w) in corner_cases().items():
            keys = sorted(flats[0])
            wsum = max(float(w.sum()), 1e-12)
            want = spec.host_weighted_sum(keys, flats, w, wsum)
            p = _p_total(flats, keys)
            for b in blocks_sweep:
                for leg in ("host", "mesh"):
                    got = engine.weighted_sum(keys, flats, w, wsum,
                                              force_leg=leg,
                                              blocks=min(b, p))
                    bad.extend(f"{name}:{leg}-b{b}:{k}" for k in keys
                               if np.asarray(got[k]).tobytes()
                               != np.asarray(want[k]).tobytes())
    return bad


# ------------------------------------------------------- merge geometries
def resnet18_leaf_shapes(num_classes: int = 100) -> Dict[str, tuple]:
    """The leaves of the reference's ResNet-18 (`models/resnet.py`, flax
    names, GroupNorm) for 32x32x3 inputs: 62 leaves, P = 11,220,132 at
    100 classes (counted with `jax.eval_shape` of its init)."""
    shapes = {"['Conv_0']['kernel']": (3, 3, 3, 64),
              "['GroupNorm_0']['scale']": (64,),
              "['GroupNorm_0']['bias']": (64,),
              "['Dense_0']['kernel']": (512, num_classes),
              "['Dense_0']['bias']": (num_classes,)}
    cin = 64
    for b, cout in enumerate((64, 64, 128, 128, 256, 256, 512, 512)):
        pre = f"['_BasicBlock_{b}']"
        shapes[f"{pre}['Conv_0']['kernel']"] = (3, 3, cin, cout)
        shapes[f"{pre}['Conv_1']['kernel']"] = (3, 3, cout, cout)
        norms = 2
        if cin != cout:                 # the projection shortcut
            shapes[f"{pre}['Conv_2']['kernel']"] = (1, 1, cin, cout)
            norms = 3
        for i in range(norms):
            shapes[f"{pre}['GroupNorm_{i}']['scale']"] = (cout,)
            shapes[f"{pre}['GroupNorm_{i}']['bias']"] = (cout,)
        cin = cout
    return shapes


def config5_leaf_shapes() -> Dict[str, tuple]:
    """The config-5 transformer's leaves (P = 535,298)."""
    from bflc_demo_tpu_torch.models import make_transformer_classifier
    from bflc_demo_tpu_torch.models.base import canonical_params
    return {k: tuple(v.shape) for k, v in
            canonical_params(make_transformer_classifier()).items()}


def bench_leaf_shapes() -> Dict[str, tuple]:
    """The reference benchmark's tree: 24 leaves of 20x20, P = 9,600
    (`eval/benchmarks.py:2604`)."""
    return {f"/L{i:02d}": (20, 20) for i in range(24)}


# name -> (N admitted, selected, leaf shapes); the writer merges of
# `eval/configs.py` (config 5 :320-321, config 4 :286-287), the
# benchmark's full drains (`eval/benchmarks.py:2604-2630`) and config 5
# in 4 cells of 5 (`hier/cells.py`: a cell merges its 3 admitted deltas,
# the root its 2 cell partials)
GEOMETRIES = {
    "config5_merge": (10, 6, config5_leaf_shapes),
    "config4_merge": (12, 8, resnet18_leaf_shapes),
    "drain_64": (64, 64, bench_leaf_shapes),
    "drain_256": (256, 256, bench_leaf_shapes),
    "drain_1024": (1024, 1024, bench_leaf_shapes),
    "config5_cell_partial": (3, 3, config5_leaf_shapes),
    "config5_root_merge": (2, 2, config5_leaf_shapes),
}


def geometry_case(name: str, seed: int = 0
                  ) -> Tuple[Dict[str, np.ndarray], List[np.ndarray],
                             List[float], List[int], float]:
    """(global model, staged rows, weights, selected, lr) of a merge at
    geometry `name`, from a seeded generator: deltas of scale 0.01,
    weights as n_samples in [8, 64), the selected slots drawn."""
    n, n_sel, shapes_fn = GEOMETRIES[name]
    shapes = shapes_fn()
    keys = sorted(shapes)
    p = sum(int(np.prod(shapes[k])) for k in keys)
    rng = np.random.default_rng(seed)
    g = {k: rng.standard_normal(shapes[k], dtype=np.float32)
         for k in keys}
    rows = [rng.standard_normal(p, dtype=np.float32) * np.float32(0.01)
            for _ in range(n)]
    weights = [float(rng.integers(8, 64)) for _ in range(n)]
    selected = sorted(int(i) for i in rng.choice(n, n_sel, replace=False))
    return g, rows, weights, selected, 0.05


def run_rederive_differential(engine: MeshAggEngine, trials: int = 12,
                              seed: int = 1, max_n: int = 24,
                              n_validators: int = 4) -> dict:
    """The validator re-derivation leg: for randomized trees, weights,
    selections, dtypes and densities, the writer's path (decode every
    admitted blob, one engine merge, pack, hash) and the validator's
    (`rederive_model_flat` over the raw wire blobs, selected only, plain
    and at a swept block count) give one committed hash, and in shard
    mode every validator's leaves equal the writer's with the shards'
    union covering every leaf.  Empty `mismatches`: the plane never
    refuses an honest writer."""
    from bflc_demo_tpu_torch.rederive.core import (derive_leaves,
                                                   rederive_model_flat)
    from bflc_demo_tpu_torch.rederive.shards import leaf_shard
    from bflc_demo_tpu_torch.utils.codecs import (pack_entries,
                                                  unpack_pytree)
    rng = np.random.default_rng(seed)
    mismatches, hashes = [], []
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(trials):
            g, _, weights, selected, lr, quant, density, codec = \
                _scenario(rng, max_n)
            n = len(weights)
            shapes = {k: np.asarray(v).shape for k, v in g.items()}
            blobs = []
            for _ in range(n):
                flat = {k: (rng.standard_normal(shp)
                            * 10.0 ** float(rng.integers(-6, 6))
                            ).astype(np.float32)
                        for k, shp in shapes.items()}
                blobs.append(pack_entries(quantize_entries(
                    _sparse_image(flat, density, codec), quant)))
            prev_blob = pack_entries(g)
            decoded = [densify_entries(dequantize_entries(
                           unpack_pytree(b))) for b in blobs]
            w_out = engine.aggregate_flat(g, decoded, weights, selected,
                                          lr)
            w_hash = hashlib.sha256(pack_entries(w_out)).digest()
            hashes.append(w_hash.hex())
            v_out = rederive_model_flat(prev_blob, blobs, weights,
                                        selected, lr,
                                        sparse=density < 1.0,
                                        engine=engine)
            bad = []
            if hashlib.sha256(pack_entries(v_out)).digest() != w_hash:
                bad.append("#full-hash")
            blk = int(BLOCKS_SWEEP[t % len(BLOCKS_SWEEP)])
            blk = min(blk, max(sum(int(np.asarray(v).size)
                                   for v in g.values()), 1))
            vb_out = rederive_model_flat(prev_blob, blobs, weights,
                                         selected, lr,
                                         sparse=density < 1.0, blocks=blk,
                                         engine=engine)
            if hashlib.sha256(pack_entries(vb_out)).digest() != w_hash:
                bad.append(f"#full-blocked-hash-b{blk}")
            keys = sorted(g.keys())
            epoch = int(rng.integers(0, 50))
            covered = set()
            sel = set(selected)
            flats = [decoded[i] if i in sel else None for i in range(n)]
            for v in range(n_validators):
                mine = leaf_shard(keys, v, n_validators, epoch)
                covered.update(mine)
                got = derive_leaves(g, flats, weights, selected, lr, mine,
                                    blocks=blk, engine=engine)
                bad += [f"#shard-v{v}:{k}" for k in mine
                        if np.asarray(got[k]).tobytes()
                        != np.asarray(w_out[k]).tobytes()]
            if covered != set(keys):
                bad.append("#shard-coverage")
            if bad:
                mismatches.append({"trial": t, "n": n, "quant": quant,
                                   "density": density, "codec": codec,
                                   "leaves": bad})
    return {"trials": trials, "seed": seed, "max_n": max_n,
            "n_validators": n_validators, "mismatches": mismatches,
            "hashes": hashes}


def run_density_transition_differential(engine: MeshAggEngine,
                                        trials: int = 8, seed: int = 2,
                                        max_n: int = 24) -> dict:
    """The closed loop's knob change: a genome op can move the density
    between a round's encodes and its admissions, so one merge may hold
    blobs of two densities and codecs.  The writer's path and the
    validator's (`rederive_model_flat`, plain and blocked) must give one
    committed hash over such a mixed round."""
    from bflc_demo_tpu_torch.rederive.core import rederive_model_flat
    from bflc_demo_tpu_torch.utils.codecs import (pack_entries,
                                                  unpack_pytree)
    rng = np.random.default_rng(seed)
    mismatches, hashes = [], []
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(trials):
            g, _, weights, selected, lr, quant, _, _ = \
                _scenario(rng, max_n)
            n = len(weights)
            shapes = {k: np.asarray(v).shape for k, v in g.items()}
            d_pre = (1.0, 0.1)[int(rng.integers(0, 2))]
            d_post = (0.1, 0.05, 0.01)[int(rng.integers(0, 3))]
            c_pre = ("topk", "sketch")[int(rng.integers(0, 2))]
            c_post = ("topk", "sketch")[int(rng.integers(0, 2))]
            cut = int(rng.integers(0, n + 1))
            blobs = []
            for i in range(n):
                flat = {k: (rng.standard_normal(shp)
                            * 10.0 ** float(rng.integers(-6, 6))
                            ).astype(np.float32)
                        for k, shp in shapes.items()}
                d, c = (d_pre, c_pre) if i < cut else (d_post, c_post)
                blobs.append(pack_entries(quantize_entries(
                    _sparse_image(flat, d, c), quant)))
            prev_blob = pack_entries(g)
            decoded = [densify_entries(dequantize_entries(
                           unpack_pytree(b))) for b in blobs]
            w_out = engine.aggregate_flat(g, decoded, weights, selected,
                                          lr)
            w_hash = hashlib.sha256(pack_entries(w_out)).digest()
            hashes.append(w_hash.hex())
            bad = []
            v_out = rederive_model_flat(prev_blob, blobs, weights,
                                        selected, lr, sparse=True,
                                        engine=engine)
            if hashlib.sha256(pack_entries(v_out)).digest() != w_hash:
                bad.append("#transition-full-hash")
            blk = min(int(BLOCKS_SWEEP[t % len(BLOCKS_SWEEP)]),
                      max(sum(int(np.asarray(v).size)
                              for v in g.values()), 1))
            vb_out = rederive_model_flat(prev_blob, blobs, weights,
                                         selected, lr, sparse=True,
                                         blocks=blk, engine=engine)
            if hashlib.sha256(pack_entries(vb_out)).digest() != w_hash:
                bad.append(f"#transition-blocked-hash-b{blk}")
            if bad:
                mismatches.append({
                    "trial": t, "n": n, "quant": quant, "cut": cut,
                    "pre": [d_pre, c_pre], "post": [d_post, c_post],
                    "leaves": bad})
    return {"trials": trials, "seed": seed, "max_n": max_n,
            "mismatches": mismatches, "hashes": hashes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-n", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="where the mesh leg runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    engine = MeshAggEngine(device=args.device)
    out = run_differential(engine, args.trials, args.seed, args.max_n)
    print(f"reduction spec differential: {out['trials']} trials on "
          f"{out['report']['device']}, blocks sweep {list(BLOCKS_SWEEP)}, "
          f"{out['compile_total']} launch geometries, "
          f"selfcheck={out['report']['selfcheck']}")
    if out["mismatches"]:
        for m in out["mismatches"]:
            print(f"  DIVERGED: {m}")
        print("FAIL: host and mesh legs are not byte-identical on this "
              "platform — certified aggregation must stay on the host "
              "loop (BFLC_MESH_AGG_LEGACY=1) until resolved")
        return 1
    corner = run_corner_cases(engine)
    if corner:
        print(f"FAIL: the spec's corner cases diverged: {corner}")
        return 1
    print("OK: host-loop, mesh, and blocked (v2) legs byte-identical "
          "on every scenario and every corner case")
    ss = run_steady_state_check(engine, seed=args.seed)
    print(f"steady-state gate: {ss['repeats']} repeats, launch geometries "
          f"{ss['compile_totals']}, fresh after warmup "
          f"{ss['fresh_after_warmup']}")
    if ss["fresh_after_warmup"]:
        print("FAIL: a repeated identical scenario launched at a new "
              "geometry after its warmup pass")
        return 1
    for name, leg in (("rederive", run_rederive_differential),
                      ("density transition",
                       run_density_transition_differential)):
        out = leg(engine, seed=args.seed + 1)
        print(f"{name} leg: {out['trials']} trials, "
              f"{len(out['mismatches'])} mismatches")
        if out["mismatches"]:
            print(f"FAIL: the {name} leg diverged: {out['mismatches']}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
