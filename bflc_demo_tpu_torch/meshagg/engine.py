"""The certified merge engine: one reduction surface, two byte-equal legs.

Port of `bflc_demo_tpu/meshagg/engine.py` — `flatten_delta` (:116),
`_leaf_layout` (:128), `MeshAggEngine` (:138-548) with its leg policy,
self-check, `weighted_sum`, `aggregate_flat` and `aggregate_rows`, the
`ENGINE` singleton, `stacked_tree_from_rows` (:554) and
`score_candidates_batched` (:572); `engine_for(device)` hands a
process's writer `ENGINE` on the card and one CPU engine otherwise.  Every certified aggregation path
(writer merge, FedBuff drain, hier cell partial) reduces through it, and
its bytes are REDUCTION SPEC v2's (`meshagg/spec.py`):

- **host leg** — `spec.host_weighted_sum` (`blocked_host_weighted_sum`
  for ``blocks > 1``), the normative numpy loop;
- **mesh leg** — kernel B5 (`ops/certified_reduce.py`) on the engine's
  device: the N admitted deltas as one stacked ``(N, P)`` float32 matrix
  (each delta's leaves raveled in sorted key order), staged to the
  device and reduced in one launch; with ``blocks = B > 1`` each of the
  spec's fixed blocks (`spec.block_bounds`) is staged and reduced as its
  own ``(N, Pb)`` launch, so peak staging is ~1/B of the matrix.

The legs are byte-identical, so choosing between them is performance
policy, under the reference's knobs: `BFLC_MESH_AGG_LEGACY=1` pins the
verbatim pre-engine loop, batches below `BFLC_MESH_AGG_MIN` (default 16)
stay on the host loop, and the mesh leg runs only after a one-time
differential SELF-CHECK (`_run_selfcheck`, the reference's canned
scenario) reproduced the host bytes.

What differs from the reference:
- the mesh leg is B5, not an XLA terms + scan program pair: the kernel
  never contracts its multiply into the add (`__fmul_rn`/`__fadd_rn`),
  so the reference's two-executable split has no counterpart;
- no fallback hides the kernel: on a `cuda` engine a failed launch or a
  failed self-check RAISES.  A `cpu` engine runs B5's plain version and
  keeps the reference's policy (warn, then the host loop);
- the report adds `selfcheck_launches`, the B5 launches the self-check
  made, so a caller can tell the merges' launches from the check's;
- `compile_total` counts the distinct ``(N, Pb)`` geometries the kernel
  was first launched at (at most `_CACHE_CAP` remembered, as the
  reference caches programs), so the steady-state gate keeps its meaning;
- the one-program cube sharded over several devices (:356-404) waits for
  ROADMAP A12: on one card the per-block loop is the path;
- the obs metric registry and the device-plane attribution are not
  ported (ROADMAP A11/A14);
- `score_candidates_batched` takes the port's `Model` (not an apply
  function), never shards the candidate axis (A12) and keeps no compile
  evidence (PyTorch compiles nothing).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bflc_demo_tpu_torch.device import DeviceLike, resolve_device
from bflc_demo_tpu_torch.meshagg import spec
from bflc_demo_tpu_torch.utils.codecs import as_float32
from bflc_demo_tpu_torch.ops.certified_reduce import (LAUNCHES,
                                                     certified_reduce)

_CACHE_CAP = 64         # distinct (N, Pb) geometries remembered per engine


def _legacy() -> bool:
    """BFLC_MESH_AGG_LEGACY=1 pins the host loop byte-for-byte."""
    return bool(os.environ.get("BFLC_MESH_AGG_LEGACY"))


def _min_batch() -> int:
    """Smallest stacked-delta count routed to the mesh leg.  Pure
    performance policy (the legs are byte-identical)."""
    try:
        return int(os.environ.get("BFLC_MESH_AGG_MIN", "16"))
    except ValueError:
        return 16


def flatten_delta(flat: Dict[str, np.ndarray],
                  keys: Sequence[str]) -> np.ndarray:
    """One delta as a contiguous ``(P,)`` float32 row: leaves raveled in
    `keys` order — pure repacking, so the reduction over rows is
    elementwise-identical to the per-leaf loops.  A bfloat16 leaf
    widens to float32 exactly (reference :118-124)."""
    if not keys:
        return np.zeros(0, np.float32)
    return np.concatenate([as_float32(flat[k]).ravel() for k in keys])


def _leaf_layout(keys: Sequence[str], flat: Dict[str, np.ndarray]):
    """[(key, offset, size, shape)] describing `flatten_delta`'s row."""
    layout, off = [], 0
    for k in keys:
        a = np.asarray(flat[k])
        layout.append((k, off, int(a.size), a.shape))
        off += int(a.size)
    return layout, off


def _host_sum(leg: str, keys: Sequence[str],
              flats: List[Dict[str, np.ndarray]], w: np.ndarray,
              wsum: float, blocks: int) -> Dict[str, np.ndarray]:
    """The host legs: the legacy loop, or the spec's (blocked) loop."""
    if leg == "legacy":
        return spec.legacy_host_weighted_sum(keys, flats, w, wsum)
    if blocks > 1:
        return spec.blocked_host_weighted_sum(keys, flats, w, wsum, blocks)
    return spec.host_weighted_sum(keys, flats, w, wsum)


def selfcheck_scenario():
    """The self-check's canned scenario, (delta flats, weights w): mixed
    shapes, a zeroed weight, a denormal and a near-overflow magnitude
    (reference :216-230)."""
    rng = np.random.default_rng(7)
    shapes = {"a": (9, 4), "b": (5,), "c": ()}
    flats = []
    for _ in range(19):
        flats.append({k: (rng.standard_normal(shapes[k])
                          * 10.0 ** float(rng.integers(-8, 8))
                          ).astype(np.float32) for k in shapes})
    flats[2]["a"][0, 0] = np.float32(1e-42)
    flats[4]["a"][1, 1] = np.float32(3.1e38)
    w = rng.random(19).astype(np.float32) * 40.0
    w[3] = 0.0
    return flats, w


class MeshAggEngine:
    """The engine; `device` is where the mesh leg runs (None: `cuda`,
    resolved at the first mesh use, so importing needs no card)."""

    def __init__(self, device: DeviceLike = None) -> None:
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self._geometries: Dict[tuple, bool] = {}
        self.compile_total = 0
        self.calls = {"mesh": 0, "host": 0}
        self.last_leg = "unused"
        self.last_blocks = 1
        self._selfcheck: Optional[bool] = None     # None = not yet run
        self.selfcheck_launches = 0

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    # ------------------------------------------------------------ policy
    def report(self) -> Dict[str, Any]:
        """Which leg ran, whether the self-check held, the launch
        geometries."""
        return {
            "spec_version": spec.SPEC_VERSION,
            "legacy_pin": _legacy(),
            "min_batch": _min_batch(),
            "last_leg": self.last_leg,
            "last_blocks": self.last_blocks,
            "calls": dict(self.calls),
            "selfcheck": ("untested" if self._selfcheck is None
                          else "ok" if self._selfcheck else "FAILED"),
            "selfcheck_launches": self.selfcheck_launches,
            "compile_total": self.compile_total,
            "cached_programs": len(self._geometries),
            "device": str(self._device) if self._device else None,
        }

    def staging_worthwhile(self, max_batch: int) -> bool:
        """True iff the mesh leg could ever consume a staged row at this
        geometry: not legacy-pinned, batch ceiling reaching the min-batch
        policy, and no already-failed self-check (which it does not
        trigger: admission stays cheap)."""
        if _legacy() or max_batch < _min_batch():
            return False
        return self._selfcheck is not False

    def choose_leg(self, n: int) -> str:
        """legacy pin > min batch > self-check > mesh."""
        if _legacy():
            return "legacy"
        return ("mesh" if n >= _min_batch() and self.run_selfcheck()
                else "host")

    def _resolve(self, n: int, force_leg: Optional[str],
                 blocks: int) -> Tuple[str, int]:
        """(leg, blocks) of one call: the forced leg or the policy's; a
        forced 'blocked' is the mesh leg at two blocks or more."""
        blocks = max(int(blocks), 1)
        leg = force_leg if force_leg is not None else self.choose_leg(n)
        if leg == "blocked":
            return "mesh", max(blocks, 2)
        return leg, blocks

    def run_selfcheck(self) -> bool:
        """Run the one-time differential self-check (idempotent) and
        return its verdict."""
        if self._selfcheck is None:
            before = LAUNCHES["certified_reduce"]
            self._selfcheck = self._run_selfcheck()
            self.selfcheck_launches = LAUNCHES["certified_reduce"] - before
        return bool(self._selfcheck)

    def _fail(self, message: str) -> None:
        """A mesh-leg fault: raises on the card, warns on the CPU."""
        if self.device.type == "cuda":
            raise RuntimeError(f"meshagg: {message}")
        warnings.warn(f"meshagg: {message} — host loop pinned",
                      RuntimeWarning)

    def _run_selfcheck(self) -> bool:
        """The reference's canned scenario (mixed shapes, a zeroed weight,
        denormal and near-overflow magnitudes; then an uneven 5-block
        geometry): the mesh leg must reproduce the host leg's bytes."""
        try:
            flats, w = selfcheck_scenario()
            keys = sorted(flats[0])
            wsum = max(float(w.sum()), 1e-12)
            host = spec.host_weighted_sum(keys, flats, w, wsum)
            mesh = self._mesh_weighted_sum(keys, flats, w, wsum)
            blocked = self._mesh_weighted_sum(keys, flats, w, wsum,
                                              blocks=5)
            hostb = spec.blocked_host_weighted_sum(keys, flats, w, wsum, 5)
        except Exception as e:                      # noqa: BLE001
            self._fail(f"self-check could not run ({e!r})")
            return False
        ok = all(np.asarray(host[k]).tobytes()
                 == np.asarray(mesh[k]).tobytes()
                 == np.asarray(blocked[k]).tobytes()
                 == np.asarray(hostb[k]).tobytes() for k in keys)
        if not ok:
            self._fail("the mesh reduction diverged from the host leg on "
                       "the self-check scenario")
        return ok

    # ------------------------------------------------------- mesh leg
    def _launch(self, mat: np.ndarray, coeffs: torch.Tensor,
                gates: torch.Tensor) -> np.ndarray:
        """Stage one (N, Pb) matrix on the device and reduce it with B5."""
        sig = mat.shape
        if sig not in self._geometries:
            if len(self._geometries) >= _CACHE_CAP:
                self._geometries.pop(next(iter(self._geometries)))
            self._geometries[sig] = True
            self.compile_total += 1
        staged = torch.from_numpy(np.ascontiguousarray(mat)).to(self.device)
        return certified_reduce(staged, coeffs, gates).cpu().numpy()

    def _mesh_rows(self, rows: List[np.ndarray], w: np.ndarray,
                   wsum: float, blocks: int = 1) -> np.ndarray:
        """(P,) float32 accumulator from staged rows: one launch, or one
        per spec-v2 block, concatenated in ascending block order."""
        coeffs = torch.from_numpy(spec.merge_coefficients(w, wsum)).to(
            self.device)
        gates = torch.from_numpy(np.asarray(w, np.float32) > 0.0).to(
            self.device)
        if blocks <= 1:
            return self._launch(np.stack(rows), coeffs, gates)
        parts = [self._launch(np.stack([r[lo:hi] for r in rows]), coeffs,
                              gates)
                 for lo, hi in spec.block_bounds(int(rows[0].size), blocks)]
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.float32))

    def _mesh_weighted_sum(self, keys: Sequence[str],
                           delta_flats: List[Dict[str, np.ndarray]],
                           w: np.ndarray, wsum: float, blocks: int = 1
                           ) -> Dict[str, np.ndarray]:
        rows = [flatten_delta(d, keys) for d in delta_flats]
        layout, _ = _leaf_layout(keys, delta_flats[0])
        acc = self._mesh_rows(rows, w, wsum, blocks)
        return {k: acc[off:off + size].reshape(shape)
                for k, off, size, shape in layout}

    def _mesh_or_fallback(self, compute, force_leg: Optional[str]):
        """Run the mesh leg; on failure raise on the card (or when the
        caller forced the leg), else warn and return None."""
        try:
            return compute()
        except Exception as e:                      # noqa: BLE001
            if force_leg in ("mesh", "blocked") or \
                    self.device.type == "cuda":
                raise
            warnings.warn(f"meshagg: mesh leg failed ({e!r}) — host "
                          f"fallback", RuntimeWarning)
            return None

    # ---------------------------------------------------- public entries
    def weighted_sum(self, keys: Sequence[str],
                     delta_flats: List[Dict[str, np.ndarray]],
                     w: np.ndarray, wsum: float, *,
                     force_leg: Optional[str] = None, blocks: int = 1
                     ) -> Dict[str, np.ndarray]:
        """Spec steps 3-4 over the admitted set: float32 accumulators per
        key.  ``force_leg`` ('host'/'mesh'/'blocked') overrides the
        policy; ``blocks`` is the genome's ``reduce_blocks`` (spec v2),
        byte-identical for every value."""
        leg, blocks = self._resolve(len(delta_flats), force_leg, blocks)
        out = None
        if leg == "mesh":
            out = self._mesh_or_fallback(
                lambda: self._mesh_weighted_sum(keys, delta_flats, w, wsum,
                                                blocks=blocks), force_leg)
            if out is None:
                leg = "host"
        if out is None:
            out = _host_sum(leg, keys, delta_flats, w, wsum, blocks)
        self._account(leg, blocks)
        return out

    def aggregate_flat(self, global_flat: Dict[str, np.ndarray],
                       delta_flats: List[Dict[str, np.ndarray]],
                       weights: Sequence[float], selected: Sequence[int],
                       lr: float, *, force_leg: Optional[str] = None,
                       blocks: int = 1) -> Dict[str, np.ndarray]:
        """The writer merge (spec steps 1-5): FedAvg / FedBuff-drain
        update of ``global_flat`` by the selected deltas."""
        w = spec.merge_weight_vector(weights, selected, len(delta_flats))
        wsum = max(float(w.sum()), 1e-12)
        accs = self.weighted_sum(list(global_flat.keys()), delta_flats,
                                 w, wsum, force_leg=force_leg,
                                 blocks=blocks)
        return spec.apply_step(global_flat, accs, lr)

    def aggregate_rows(self, global_flat: Dict[str, np.ndarray],
                       rows: List[np.ndarray],
                       weights: Sequence[float], selected: Sequence[int],
                       lr: float, *, force_leg: Optional[str] = None,
                       blocks: int = 1) -> Dict[str, np.ndarray]:
        """The writer merge over STAGED rows (`flatten_delta` images in
        sorted-key order, built at admission): one stack and one launch
        (one per block with ``blocks > 1``), no per-leaf Python.  The host
        legs unflatten the rows, which carry the exact decode bytes."""
        keys = sorted(global_flat.keys())
        w = spec.merge_weight_vector(weights, selected, len(rows))
        wsum = max(float(w.sum()), 1e-12)
        layout, _ = _leaf_layout(keys, global_flat)
        leg, blocks = self._resolve(len(rows), force_leg, blocks)
        accs = None
        if leg == "mesh":
            acc = self._mesh_or_fallback(
                lambda: self._mesh_rows(rows, w, wsum, blocks), force_leg)
            if acc is None:
                leg = "host"
            else:
                accs = {k: acc[off:off + size].reshape(shape)
                        for k, off, size, shape in layout}
        if accs is None:
            flats = [{k: r[off:off + size].reshape(shape)
                      for k, off, size, shape in layout} for r in rows]
            accs = _host_sum(leg, keys, flats, w, wsum, blocks)
        self._account(leg, blocks)
        return spec.apply_step(global_flat, accs, lr)

    def _account(self, leg: str, blocks: int = 1) -> None:
        label = "blocked" if leg == "mesh" and blocks > 1 else leg
        self.calls[label] = self.calls.get(label, 0) + 1
        self.last_leg = label
        self.last_blocks = blocks


ENGINE = MeshAggEngine()
_CPU_ENGINE: Optional[MeshAggEngine] = None


def engine_for(device: DeviceLike = None) -> MeshAggEngine:
    """The engine a process merges with on `device`: `ENGINE` on the card
    (None means `cuda`), one shared CPU engine on the CPU."""
    global _CPU_ENGINE
    if torch.device("cuda" if device is None else device).type == "cuda":
        return ENGINE
    if _CPU_ENGINE is None:
        _CPU_ENGINE = MeshAggEngine("cpu")
    return _CPU_ENGINE


def stacked_tree_from_rows(rows: List[np.ndarray],
                           template_flat: Dict[str, np.ndarray],
                           device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked candidate tree (leaves ``(N, ...)``) built from flattened
    rows (`flatten_delta` images in sorted-key order of
    `template_flat`): one stack and one transfer per leaf."""
    dev = resolve_device(device)
    keys = sorted(template_flat.keys())
    layout, _ = _leaf_layout(keys, template_flat)
    mat = np.stack(rows)
    return {k: torch.as_tensor(np.ascontiguousarray(
        mat[:, off:off + size].reshape((mat.shape[0],) + tuple(shape))),
        device=dev) for k, off, size, shape in layout}


def score_candidates_batched(model, global_params, deltas, lr: float, x, y,
                             *, stacked: Optional[Dict[str, Any]] = None):
    """All candidate scores of `core.scoring.score_candidates` over the
    stacked candidates (`deltas`, a list of `Params`, or `stacked`, e.g.
    `stacked_tree_from_rows`).  Returns a (K,) score tensor."""
    from bflc_demo_tpu_torch.core.scoring import score_candidates

    if stacked is None:
        stacked = {k: torch.stack([d[k] for d in deltas])
                   for k in deltas[0]}
    return score_candidates(model, global_params, stacked, lr, x, y)
