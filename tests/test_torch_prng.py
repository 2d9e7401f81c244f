"""`utils/prng.py` against `jax.random`, and config 5 from its own init.

- `PRNGKey`, `split`, `fold_in`, `bits` and `uniform`: bit for bit, for
  the seeds {0, 1, 42, 2**31 - 1} and the transformer's shapes (JAX 0.9,
  partitionable Threefry, the reference's mode).
- `normal`: within 4 float32 ulp and 5e-7 absolute.  The port evaluates
  XLA's ErfInv32 polynomial with its fused steps; what remains is
  numpy's `log1p` against XLA:CPU's (measured: at most 3 ulp, 4.8e-7).
- The transformer's `init_params(0)` against the reference's, leaf by
  leaf, at config 5's width, to the same tolerance.
- C1 end to end: config 5's mesh runtime from each package's own
  `init_params(0)`, 3 rounds (5 take ~130 s of both packages on this
  CPU; 3 stay near 80 s): equal uploaders, committees and selections,
  and sponsor accuracies equal to 4 places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bflc_demo_tpu.client import mesh_runtime as ref_mesh_runtime
from bflc_demo_tpu.eval import configs as ref_configs
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu_torch.client import mesh_runtime
from bflc_demo_tpu_torch.eval import configs
from bflc_demo_tpu_torch.models import make_transformer_classifier
from bflc_demo_tpu_torch.utils import prng

SEEDS = [0, 1, 42, 2**31 - 1]
# config 5's leaves: embed, pos, the (d, d) projections, w1, w2, and
# shapes that are not a multiple of anything
SHAPES = [(), (7,), (1024, 128), (64, 128), (128, 128), (128, 512),
          (512, 128), (3, 5, 7)]
NORMAL_ULP = 4
NORMAL_ABS = 5e-7


def _key(seed):
    return jax.random.PRNGKey(seed)


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_bit_for_bit(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(_key(seed)))
    for num in (2, 3, 6, 7):
        np.testing.assert_array_equal(prng.split(key, num),
                                      np.asarray(jax.random.split(
                                          _key(seed), num)))
    for data in (0, 1, 5, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data),
                                      np.asarray(jax.random.fold_in(
                                          _key(seed), data)))
    # a key two splits deep, as the transformer's blocks draw theirs
    sub = prng.split(prng.split(key, 6)[2], 6)[4]
    want = jax.random.split(jax.random.split(_key(seed), 6)[2], 6)[4]
    np.testing.assert_array_equal(sub, np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_for_bit(seed, shape):
    key = prng.split(prng.PRNGKey(seed), 3)[1]
    jkey = jax.random.split(_key(seed), 3)[1]
    np.testing.assert_array_equal(
        prng.bits(key, shape), np.asarray(jax.random.bits(
            jkey, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-3.0, 2.5),
                   (float(np.nextafter(np.float32(-1), np.float32(0))),
                    1.0)):
        got = prng.uniform(key, shape, lo, hi)
        want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo,
                                             hi))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_normal_within_a_few_ulp(seed, shape):
    key = prng.split(prng.PRNGKey(seed), 3)[2]
    got = prng.normal(key, shape)
    want = np.asarray(jax.random.normal(jax.random.split(_key(seed), 3)[2],
                                        shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _ulp(got, want) <= NORMAL_ULP
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ABS)


def test_erfinv_edges_match_xla():
    x = np.array([-1.0, 1.0, 0.0, -0.0, 0.5, -0.999999, 0.9999999],
                 np.float32)
    got = prng.erfinv(x)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    finite = np.isfinite(want)
    assert _ulp(got[finite], want[finite]) <= NORMAL_ULP


def test_seed_range():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**31)
    np.testing.assert_array_equal(prng.PRNGKey(-1),
                                  np.asarray(_key(-1)))


def test_transformer_init_matches_reference_leaf_by_leaf():
    port = make_transformer_classifier()        # config 5's width
    want = port.params_from_jax(ref_transformer().init_params(0))
    got = port.init_params(0)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert _ulp(got[k].numpy(), v.numpy()) <= NORMAL_ULP, k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=NORMAL_ABS, err_msg=k)
    other = port.init_params(1)
    assert not np.array_equal(other["['embed']"].numpy(),
                              got["['embed']"].numpy())


def test_config5_mesh_rounds_from_own_init_match_reference(monkeypatch):
    """C1: both packages start from their own `init_params(0)`."""
    def recorder(module, log):
        inner = module.audit_round

        def wrapped(ledger, addr_of, epoch, ups, comm, *rest):
            inner(ledger, addr_of, epoch, ups, comm, *rest)
            log.append((epoch, list(ups), list(comm),
                        sorted(int(s) for s in rest[6])))
        monkeypatch.setattr(module, "audit_round", wrapped)

    ref_log, port_log = [], []
    recorder(ref_mesh_runtime, ref_log)
    recorder(mesh_runtime, port_log)
    want = ref_configs.config5_transformer_sst2(
        rounds=3, runtime="mesh", ledger_backend="python")
    got = configs.config5_transformer_sst2(rounds=3, runtime="mesh",
                                           device="cpu")
    assert len(port_log) == 3 and port_log == ref_log
    for (_, a), (_, b) in zip(got.accuracy_history, want.accuracy_history):
        assert round(a, 4) == round(b, 4)
    assert got.ledger_log_size == want.ledger_log_size
    assert got.ledger.verify_log()
