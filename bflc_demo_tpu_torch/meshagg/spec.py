"""REDUCTION SPEC v2 — the fixed-order deterministic aggregation rule.

Copy of `bflc_demo_tpu/meshagg/spec.py` (numpy only, nothing dropped):
the normative statement of the certified merge and its host leg, bit
for bit the reference's.  The port's device leg is kernel B5
(`ops/certified_reduce.py`), held to these functions' bytes.  The
reference's text follows; its "mesh leg"/"compiled program" is the
port's B5 kernel, and its checker is `meshagg/check.py`.

Validators re-derive the committed model hash (ROADMAP "validator-side
FedAvg re-derivation"), so the weighted-merge arithmetic is PROTOCOL,
not an implementation detail: every leg that computes it — the
coordinator's host loop, the compiled mesh program, a re-deriving
validator — must produce the same bytes from the same admitted set.
Float addition is not associative, so "the same bytes" requires pinning
the reduction ORDER — and, it turns out, the SUBNORMAL handling — not
just the formula.  This module is the normative statement (and the
host-leg implementation) of both.

Inputs: N admitted deltas d_0..d_{N-1} in ledger slot order (ascending
admission index — replicated state, identical on every replica), their
merge weights, and the selected subset.

**Arithmetic domain.**  All tensor arithmetic is IEEE float32 with
FLUSH-TO-ZERO / DENORMALS-ARE-ZERO semantics: a subnormal operand
reads as (signed) zero and a subnormal result flushes to (signed)
zero.  FTZ is what the accelerator platforms the mesh leg compiles to
actually execute (XLA:CPU pins FTZ+DAZ in its execution threads; TPU
vector units are FTZ in hardware) and cannot be disabled there, so the
spec adopts it rather than pretending gradual underflow is available.
The host leg emulates it explicitly (`_daz`).  On the subnormal-free
domain — every real model/delta exercised in this repo — FTZ float32
is bit-identical to plain float32, which is why the historical chain's
hashes are unchanged.  The pre-engine loop (gradual underflow, what
`BFLC_MESH_AGG_LEGACY=1` pins byte-for-byte) coincides with the spec
everywhere except subnormal corners.

1. **Weight vector.**  ``w`` is an (N,) float32 vector: ``w[i] =
   float32(weights[i])`` for selected slots, ``0.0`` otherwise.  On the
   sync path ``weights[i] = n_samples_i``; on the async (FedBuff) path
   ``weights[i] = float32(n_samples_i / sqrt(1 + staleness_i))``
   (`ledger.base.staleness_weight` — the one definition); on the hier
   cell tier ``weights[i] = n_samples_i`` of the cell-selected member.

2. **Normalizer.**  ``wsum = max(float64(sum(w)), 1e-12)`` for the
   writer's merge (the 1e-12 clamp keeps an empty selection inert);
   the cell partial uses ``wsum = float32(sum(w))`` over its all-
   positive weights.  Either way each per-slot coefficient is the IEEE
   float32 quotient ``c[i] = w[i] / float32(wsum)`` (a float64 ``wsum``
   that round-trips float32 exactly divides identically).

3. **Terms.**  ``t_i = daz(d_i) * daz(c[i])`` flushed — one FTZ float32
   multiply per element, NEVER fused with the accumulation (an FMA
   contraction of ``acc + d*c`` changes the low bit; the mesh kernel
   materialises the terms in a SEPARATE compiled program from the
   reduction so the compiler cannot contract across them, and the host
   leg's numpy has no FMA).  Unselected slots' terms are literal
   ``+0.0``.

4. **Fixed-order accumulation.**  ``acc`` starts at float32 zeros and
   gains the terms STRICTLY SEQUENTIALLY in ascending slot order::

       for i in 0..N-1:  acc = ftz(acc + t_i)

   EVERY slot is added, unselected slots as literal ``+0.0`` — not
   skipped: under FTZ an accumulator can reach ``-0`` (a subnormal
   negative sum flushes to it), and ``-0 + (+0) == +0`` normalizes it
   where a skip would not, so "add the masked term" is the normative
   rule and both legs follow it.  A NaN/inf in an UNSELECTED delta is
   masked out before it can poison the sum.

   **Spec v2: the protocol-agreed block structure.**  The flattened
   ``(P,)`` param axis (leaves concatenated in sorted-key order) is cut
   into ``reduce_blocks`` fixed contiguous blocks of ``Pb =
   ceil(P / reduce_blocks)`` elements each (``block_bounds`` below is
   the ONE normative partition; the last block may be short, and
   ``reduce_blocks > P`` is a degenerate geometry it rejects).  WITHIN
   each block the accumulation is exactly the v1 rule above; the
   per-block partials then combine by CONCATENATION in ascending block
   order.  Because the reduction is elementwise per parameter — no
   arithmetic ever crosses a block boundary — every element's
   ascending-slot addition chain is untouched by the partition, so the
   v2 result is byte-identical to v1 for EVERY block count and every
   device placement.  What the blocks buy is an execution degree of
   freedom: each block is an independent program the engine can stage,
   compile and shard separately (a delta matrix bigger than one chip's
   HBM runs as per-block ``(N, Pb)`` programs or one params-axis
   NamedSharding program) while the certified bytes stay a pure
   function of the admitted set.  ``reduce_blocks`` rides the protocol
   genome (`protocol.constants.ProtocolConfig`), NEVER
   ``jax.device_count()`` — a 1-chip validator re-derives a 256-chip
   writer's bytes — and blocked commit ops carry the claimed geometry
   so a writer lying about it refuses BAD_ARG at every replica.
   ``reduce_blocks = 1`` (the default, and what ``BFLC_BLOCKED_LEGACY=1``
   pins) is exactly spec v1, wire format included.

5. **Model update** (writer merge only).  Per leaf,
   ``new = float32(g) - float32(lr) * acc`` cast back to the leaf's
   stored dtype — applied host-side in BOTH legs (separate IEEE mul +
   sub, numpy, no FMA), so the tail is one shared implementation.

Everything here is seed-independent and platform-deterministic: FTZ
float32 multiply/add/divide are correctly rounded and identically
flushed on every platform this repo targets, and the engine SELF-CHECKS
the contract at first use (falling back to the host loop if a
toolchain breaks it — e.g. by contracting step 3 into step 4).
`meshagg/check.py` is the standalone differential checker.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.utils.codecs import as_float32, cast_like

SPEC_VERSION = 2

# smallest normal float32 (2**-126): the FTZ/DAZ threshold
MIN_NORMAL = np.float32(1.1754944e-38)


def _daz(x: np.ndarray) -> np.ndarray:
    """Flush subnormal float32 values to SIGNED zero (identity on the
    normal range, on ±0, ±inf and NaN) — the spec's FTZ/DAZ emulation
    for the host leg.  Multiplying by the 0/1 mask is exact and keeps
    the sign: ``-denormal * 0.0 == -0.0``."""
    a = np.asarray(x, np.float32)
    return a * (np.abs(a) >= MIN_NORMAL).astype(np.float32)


def merge_weight_vector(weights: Sequence[float], selected: Sequence[int],
                        n: int) -> np.ndarray:
    """(N,) float32 ``w`` per spec step 1 — byte-identical to the
    pre-engine ``_aggregate_flat`` preamble."""
    w = np.zeros(n, np.float32)
    for s in selected:
        w[s] = float(weights[s])
    return w


def merge_coefficients(w: np.ndarray, wsum: float) -> np.ndarray:
    """(N,) float32 ``c`` per spec step 2.  The vectorized float32
    divide produces the same IEEE quotients as the legacy loop's
    per-term ``w[i] / wsum`` (numpy NEP 50: a weak python-float divisor
    is applied at float32)."""
    return (w / np.float32(wsum)).astype(np.float32)


def host_weighted_sum(keys: Sequence[str],
                      delta_flats: List[Dict[str, np.ndarray]],
                      w: np.ndarray, wsum: float
                      ) -> Dict[str, np.ndarray]:
    """The HOST-LOOP leg of spec steps 3-4: FTZ float32, masked terms,
    strict ascending-slot accumulation.  Returns float32 accumulators
    per key.  Coincides with `legacy_host_weighted_sum` everywhere no
    subnormal enters the reduction."""
    coeffs = _daz(merge_coefficients(w, wsum))
    gates = np.asarray(w, np.float32) > 0.0
    out: Dict[str, np.ndarray] = {}
    with np.errstate(invalid="ignore", over="ignore"):
        for key in keys:
            acc = None
            for i, d in enumerate(delta_flats):
                leaf = as_float32(d[key])
                if acc is None:
                    acc = np.zeros_like(leaf)
                if gates[i]:
                    acc = _daz(acc + _daz(_daz(leaf) * coeffs[i]))
                else:
                    # the masked +0 add (spec step 4): normalizes an
                    # FTZ-produced -0 accumulator exactly like the
                    # kernel's where-masked term does
                    acc = _daz(acc + np.float32(0.0))
            out[key] = acc if acc is not None else np.float32(0.0)
    return out


def block_bounds(p: int, blocks: int) -> List[Tuple[int, int]]:
    """The ONE normative partition of the flattened ``(P,)`` param axis
    (spec v2): ``blocks`` contiguous blocks of ``Pb = ceil(p/blocks)``
    elements, block ``b`` covering ``[b*Pb, min((b+1)*Pb, p))``.  The
    last block may be short; empty trailing blocks never exist because
    ``blocks > p`` is a DEGENERATE geometry (a block would reduce
    nothing) and is rejected here with the protocol's error."""
    blocks = int(blocks)
    if blocks < 1:
        raise ValueError(f"reduce_blocks must be >= 1, got {blocks}")
    if blocks > max(int(p), 1):
        raise ValueError(
            f"degenerate block geometry: reduce_blocks = {blocks} "
            f"exceeds the flattened param count P = {p} (at least one "
            f"block would be empty); the genome must satisfy "
            f"reduce_blocks <= P for every model it certifies")
    if p <= 0:
        return [(0, 0)]
    pb = -(-int(p) // blocks)  # ceil
    return [(b * pb, min((b + 1) * pb, int(p)))
            for b in range(blocks) if b * pb < int(p)]


def blocked_host_weighted_sum(keys: Sequence[str],
                              delta_flats: List[Dict[str, np.ndarray]],
                              w: np.ndarray, wsum: float, blocks: int
                              ) -> Dict[str, np.ndarray]:
    """The NORMATIVE REFERENCE for spec v2's blocked reduction: flatten
    each delta to ``(P,)`` in sorted-key order, run the v1 FTZ masked
    sequential rule (steps 3-4) independently inside every
    ``block_bounds`` block, concatenate the partials in ascending block
    order, unflatten.  Byte-identical to ``host_weighted_sum`` for
    every ``blocks`` — asserted by the differential checker and the
    engine self-check, never assumed."""
    if blocks <= 1 or not delta_flats:
        return host_weighted_sum(keys, delta_flats, w, wsum)
    shapes = [np.asarray(delta_flats[0][k]) for k in keys]
    rows = [np.concatenate([as_float32(d[k]).ravel()
                            for k in keys]) if keys
            else np.zeros(0, np.float32) for d in delta_flats]
    p = int(rows[0].size)
    coeffs = _daz(merge_coefficients(w, wsum))
    gates = np.asarray(w, np.float32) > 0.0
    acc = np.zeros(p, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for lo, hi in block_bounds(p, blocks):
            part = np.zeros(hi - lo, np.float32)
            for i, r in enumerate(rows):
                if gates[i]:
                    part = _daz(part + _daz(_daz(r[lo:hi]) * coeffs[i]))
                else:
                    part = _daz(part + np.float32(0.0))
            # deterministic fixed-order combine: ascending-block
            # concatenation — no cross-block arithmetic ever happens
            acc[lo:hi] = part
    out: Dict[str, np.ndarray] = {}
    off = 0
    for k, ref in zip(keys, shapes):
        out[k] = acc[off:off + ref.size].reshape(ref.shape)
        off += ref.size
    return out


def legacy_host_weighted_sum(keys: Sequence[str],
                             delta_flats: List[Dict[str, np.ndarray]],
                             w: np.ndarray, wsum: float
                             ) -> Dict[str, np.ndarray]:
    """The PRE-ENGINE reduction, verbatim (gradual underflow, per-term
    ``w[i] / wsum``): what ``BFLC_MESH_AGG_LEGACY=1`` pins byte-for-
    byte, hoisted from the original ``_aggregate_flat`` /
    ``hier.partial.cell_partial`` loops."""
    out: Dict[str, np.ndarray] = {}
    for key in keys:
        acc = None
        for i, d in enumerate(delta_flats):
            leaf = as_float32(d[key])
            if acc is None:
                acc = np.zeros_like(leaf)
            if w[i] > 0.0:
                acc = acc + leaf * (w[i] / wsum)
        out[key] = acc if acc is not None else np.float32(0.0)
    return out


def apply_step(global_flat: Dict[str, np.ndarray],
               accs: Dict[str, np.ndarray], lr: float
               ) -> Dict[str, np.ndarray]:
    """Spec step 5: ``g - lr * acc`` per leaf, cast to the stored
    dtype.  Host-side numpy in BOTH legs (separate IEEE mul + sub)."""
    out: Dict[str, np.ndarray] = {}
    for key, g in global_flat.items():
        out[key] = cast_like(as_float32(g) - lr * accs[key],
                             np.asarray(g).dtype)
    return out
