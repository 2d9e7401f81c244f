"""flax.linen's parameter draws without flax.

The reference's CNNs and ResNet (`bflc_demo_tpu/models/cnn.py`,
`models/resnet.py`) are flax modules whose `init(PRNGKey(seed), x)`
draws every parameter from its own key.  This module reproduces those
keys and draws with `utils/prng.py`, so the port's `init_params(seed)`
gives the reference's tree.  It copies, from the flax 0.12.3 the
reference runs against:

- the per-parameter key (`flax/core/scope.py`: `LazyRng` :85-131,
  `Scope.push` :600-630, `Scope.make_rng` :745-746): a child scope
  appends its name to the key's suffix, each `param` call in a scope
  increments that scope's counter and appends it, and the key is
  ``fold_in(root, first 4 bytes of SHA-1(suffix), big-endian)``.  The
  SHA-1 takes each string's UTF-8 bytes and each integer's big-endian
  bytes, with no separator: flax's `flax_fix_rng_separator`, which
  would put a ``b'\\0'`` before each part, is off in the flax the
  reference runs (its default), and is not ported;
- `lecun_normal` (`jax.nn.initializers.variance_scaling(1.0, "fan_in",
  "truncated_normal")`): truncated normal on (-2, 2) times
  ``sqrt(1 / fan_in) / 0.87962566103423978``, with fan_in the product of
  every axis but the last (a Dense kernel (in, out): in; a Conv kernel
  (kh, kw, in, out): kh * kw * in);
- `zeros` and `ones` (biases; GroupNorm's `bias` and `scale`).

A module lists its parameters as `ParamSpec`s in flax's creation order:
within a scope a parameter's counter is its rank among that scope's
`param` calls (Dense and Conv: kernel 1, bias 2; GroupNorm: scale 1,
bias 2).  Dropped: every other initialiser, rng streams other than
'params', and flax's collections.
"""

from __future__ import annotations

import hashlib
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.utils import prng

_TRUNC_STDDEV = np.float32(0.87962566103423978)


class ParamSpec(NamedTuple):
    """One flax parameter: its scope path (module names from the root),
    its name, shape, initialiser ('lecun_normal' | 'zeros' | 'ones') and
    its counter in the scope (1 for the scope's first `param`)."""
    scope: Tuple[str, ...]
    name: str
    shape: Tuple[int, ...]
    init: str
    counter: int


def fold_in_static(key: np.ndarray, data: Sequence[object]) -> np.ndarray:
    """flax's `_fold_in_static`: the key with the SHA-1 of `data` (strings
    and non-negative integers) folded in."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or string, got {x!r}")
    return prng.fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def lecun_normal(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """float32 LeCun-normal draws of `shape` (fan-in over every axis but
    the last)."""
    fan_in = int(np.prod(shape[:-1]))
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / _TRUNC_STDDEV
    return prng.truncated_normal(key, -2.0, 2.0, shape) * stddev


def init_tree(seed: int, specs: Sequence[ParamSpec]
              ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Every parameter of `specs` as `module.init(PRNGKey(seed), x)` draws
    it, keyed by its full path (scope + name)."""
    root = prng.PRNGKey(seed)
    out = {}
    for spec in specs:
        if spec.init == "lecun_normal":
            key = fold_in_static(root, spec.scope + (spec.counter,))
            value = lecun_normal(key, spec.shape)
        elif spec.init == "zeros":
            value = np.zeros(spec.shape, np.float32)
        elif spec.init == "ones":
            value = np.ones(spec.shape, np.float32)
        else:
            raise ValueError(f"unknown initialiser {spec.init!r}")
        out[spec.scope + (spec.name,)] = value
    return out
