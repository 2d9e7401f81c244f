"""`jax.random`'s draws without jax: Threefry-2x32 in numpy.

Port of the parts of `jax.random` (JAX 0.9, `jax._src.prng` and
`jax._src.random`) that the reference's initialisers and draws use, in
the partitionable Threefry mode it runs (`jax_threefry_partitionable`,
the default since JAX 0.5):

- `PRNGKey(seed)` is the key ``(0, seed)`` for a 32-bit seed;
- `split(key, n)` hashes the counters ``(0, i)``, i < n, under `key`:
  each output pair is a new key;
- `fold_in(key, data)` hashes the one counter ``(0, data)``;
- `bits(key, shape)` hashes the counters ``(hi, lo)`` of the flattened
  iota over `shape` (a 64-bit index split into two words) and returns
  ``x0 ^ x1``;
- `uniform` keeps the top 23 bits as the mantissa of a float in [1, 2),
  subtracts 1, then scales to [minval, maxval) and clamps at minval;
- `normal` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``;
  `normal(..., dtype="bfloat16")` is jax's bfloat16 draw: 8 random bits
  a value (bfloat16 has 7 mantissa bits, so `jax._src.random._uniform`
  draws 8) shifted right by one into the mantissa of [1, 2), and every
  step rounded to bfloat16 as XLA:CPU rounds it (`round_bf16`);
- `truncated_normal(key, lower, upper)` is ``sqrt(2) * erfinv(uniform(
  erf(lower / sqrt(2)), erf(upper / sqrt(2))))``, clamped to the open
  interval (lower, upper) (`jax._src.random._truncated_normal`).

The integer draws (`PRNGKey`, `split`, `fold_in`, `bits`) and `uniform`
equal jax's bit for bit: they are uint32 arithmetic and exact float32
steps.  `normal` computes `erfinv` with Giles' single-precision
polynomial in ``w = -log1p(-x*x)``, the one XLA's `ErfInv32` evaluates,
with its steps fused as XLA:CPU fuses them; XLA's own `log1p` is not
numpy's, so `normal` matches jax within a few float32 ulp, not bit for
bit (`tests/test_torch_prng.py` states the tolerance), and so does
`truncated_normal`.  Its `erf` is XLA:CPU's float32 rational
approximation (odd degree-9 numerator over even degree-12 denominator,
FMA Horner steps), equal to jax's for |x| < 3, which holds the bounds
flax's initialisers use (±2/sqrt(2)).  `torch.erfinv`
would differ by up to tens of ulp.

The bfloat16 draw equals jax's bit for bit (its erfinv input takes 256
values, each of which the float32 polynomial rounds as XLA does).

Dropped: jax's typed key arrays, the non-partitionable mode, 64-bit
seeds and the other distributions.  Everything returns numpy arrays;
callers convert.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

Shape = Union[int, Sequence[int]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_SQRT2 = np.float32(np.sqrt(2.0))
# Giles, "Approximating the erfinv function" (GPU Computing Gems), single
# precision, highest degree first — XLA's ErfInv32 constants
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


# XLA:CPU's float32 erf: x * P(x^2) / Q(x^2), highest degree first;
# +-1 beyond erf^-1(1 - ulp/2)
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_ONE = np.float32(3.832506856900711)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(map(int, shape))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, of the counter pairs (x0, x1) under `key`
    — jax's `threefry2x32_p`.  uint32 arithmetic wraps mod 2**32.  `key`
    is (2,), or (..., 2) keys that broadcast against the counters.  Every
    step runs in place on the two words (a draw of millions of words
    allocates nothing more)."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0, x1 = (np.array(a, np.uint32) for a in np.broadcast_arrays(
            np.asarray(x0, np.uint32) + ks[0],
            np.asarray(x1, np.uint32) + ks[1]))
        tmp = np.empty_like(x1)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                np.add(x0, x1, out=x0)
                np.left_shift(x1, np.uint32(r), out=tmp)
                np.right_shift(x1, np.uint32(32 - r), out=x1)
                np.bitwise_or(x1, tmp, out=x1)
                np.bitwise_xor(x1, x0, out=x1)
            np.add(x0, ks[(i + 1) % 3], out=x0)
            np.add(x1, ks[(i + 2) % 3] + np.uint32(i + 1), out=x1)
    return x0, x1


def _iota_2x32(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The flattened iota over `shape`, as (high word, low word)."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)),
                    dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def PRNGKey(seed: int) -> np.ndarray:          # noqa: N802 — jax's name
    """The raw (2,) uint32 key of an integer seed (jax's x32 mode)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit a 32-bit integer")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """(num, 2) new keys."""
    hi, lo = _iota_2x32((int(num),))
    return np.stack(threefry2x32(key, hi, lo), axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """The key `key` with the integer `data` folded in."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def fold_in_many(keys: np.ndarray, data) -> np.ndarray:
    """`fold_in` of each key of `keys` (..., 2) with the integer(s)
    `data` (broadcast against the keys' leading shape), in one pass."""
    keys = np.asarray(keys, np.uint32)
    data = np.broadcast_to(np.asarray(data, np.int64) & 0xFFFFFFFF,
                           keys.shape[:-1]).astype(np.uint32)
    y0, y1 = threefry2x32(keys, np.zeros_like(data), data)
    return np.stack([y0, y1], axis=-1)


def bits(key: np.ndarray, shape: Shape = ()) -> np.ndarray:
    """32-bit uniform random words of `shape`."""
    x0, x1 = threefry2x32(key, *_iota_2x32(_shape(shape)))
    return x0 ^ x1


def uniform(key: np.ndarray, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 uniform draws in [minval, maxval).  The scaling
    ``floats * (hi - lo) + lo`` is one fused multiply-add, as XLA:CPU
    computes it."""
    lo, hi = np.float32(minval), np.float32(maxval)
    mant = (bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 erfinv by XLA's ErfInv32 polynomial; ±1 give ±inf.  Each
    Horner step ``c + p*w`` is one fused multiply-add, as XLA:CPU
    contracts it: computed in float64 (where the product of two float32
    is exact), then rounded to float32."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0)).astype(np.float64)
        p = np.where(small, np.float32(_ERFINV_W_LT_5[0]),
                     np.float32(_ERFINV_W_GE_5[0]))
        for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
            c = np.where(small, np.float32(a), np.float32(b))
            p = (c.astype(np.float64) + p * w).astype(np.float32)
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf),
                        out).astype(np.float32)


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), as
    float32: the rounding of every bfloat16 step, without a bfloat16
    dtype in numpy.  Finite inputs and infinities."""
    u = np.asarray(x, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def _normal_bf16(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """jax's bfloat16 standard normal draw, as bfloat16 values in float32."""
    lo = np.float32(-0.99609375)        # nextafter(-1, 0) in bfloat16
    span = round_bf16(np.float32(1.0) - lo)
    mant = ((bits(key, shape) & np.uint32(0xFF)) >> np.uint32(1)) \
        | np.uint32(0x3F80)
    floats = (mant << np.uint32(16)).view(np.float32) - np.float32(1.0)
    u = np.maximum(lo, round_bf16(round_bf16(floats * span) + lo))
    return round_bf16(round_bf16(erfinv(u)) * round_bf16(_SQRT2))


def normal(key: np.ndarray, shape: Shape = (),
           dtype: str = "float32") -> np.ndarray:
    """Standard normal draws: float32, or with dtype "bfloat16" jax's
    bfloat16 draw (its values, held in a float32 array)."""
    if dtype == "bfloat16":
        return _normal_bf16(key, _shape(shape))
    if dtype != "float32":
        raise ValueError(f"normal draws float32 or bfloat16, got {dtype}")
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _SQRT2 * erfinv(uniform(key, shape, lo, 1.0))


def _fma_horner(w: np.ndarray, coeffs) -> np.ndarray:
    """Horner steps ``c + p*w``, each one float32 fused multiply-add
    (float64 product and sum, one rounding), highest degree first."""
    p = np.full(np.shape(w), np.float32(coeffs[0]), np.float32)
    w64 = np.asarray(w, np.float64)
    for c in coeffs[1:]:
        p = (p * w64 + np.float64(np.float32(c))).astype(np.float32)
    return p


def erf(x: np.ndarray) -> np.ndarray:
    """float32 erf by XLA:CPU's rational approximation."""
    x = np.asarray(x, np.float32)
    x2 = x * x
    p = x * _fma_horner(x2, _ERF_ALPHA)
    out = p / _fma_horner(x2, _ERF_BETA)
    return np.where(np.abs(x) <= _ERF_ONE, out,
                    np.copysign(np.float32(1.0), x)).astype(np.float32)


def truncated_normal(key: np.ndarray, lower: float, upper: float,
                     shape: Shape = ()) -> np.ndarray:
    """float32 standard normal draws truncated to (lower, upper)."""
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = erf(lo / _SQRT2), erf(hi / _SQRT2)
    out = _SQRT2 * erfinv(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf))).astype(np.float32)
