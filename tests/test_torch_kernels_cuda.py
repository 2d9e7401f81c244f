"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it runs where only PyTorch with CUDA is installed:
`python -m pytest tests/test_torch_kernels_cuda.py` on a machine with an
NVIDIA H100 (the kernels build for sm_90a at first use).  Without a card
every test skips: a CUDA kernel has no CPU mode.

Shapes: the config-5 transformer's (B=16, S=64, H=4, D=32), a
multi-tile one (S=256) with ragged padding and one fully masked 64-key
tile, a sequence shorter than one 64-row tile, and more keys than
queries (up to 64 x 4096); every kernel runs 1, 2 or 4 warps a block by
the shape (`launch_warps`: the rows its warps own are keys for dK/dV,
queries for the others), and the cases reach each geometry of each
kernel (one (b, h) row; (2, 1024); (16, 512); and (2, 64) queries on
4096 keys, where dK/dV runs four warps and dQ one).  The carry kernel
(one ring hop) runs two hops chained from a zero carry, at multiples of
its 64-key tile, up to the sp training shard (folded B=32, S=1024).  Between them every head dim runs in both dtypes.
The payload-fingerprint kernel (B6) is held against its plain version
bit for bit: every leaf dtype it takes, ragged word counts, empty and
non-contiguous leaves, 64-bit leaves, and config 5's 20 stacked deltas.
The certified reduction (B5) is held against its plain version and the
spec's numpy host leg byte for byte: subnormal products and deltas, a -0
accumulator, NaN/inf in unselected slots, +-inf meeting in selected
ones, random magnitudes, and column blocks of a resident matrix (blocks
1, 2, 5, 8 and 64); then the redesigned kernel's routes: N from 1 to
1025 around each route's tile height, narrow, middle and wide P (the
strips or the column kernel, as the wrapper picks), row strides and
column offsets
0-3 mod 4 (4- and 16-byte copies), NaN, inf and subnormal deltas and a
subnormal sum at tile, stage, batch and strip boundaries, NaN/inf in
unselected slots, and every route (each strip width and copy width, and
the column kernel) forced on the same inputs.
Tolerances: float32 differs only in summation order and the 3xTF32
products (~2^-21 relative each) (1e-4); bfloat16 rounds p, dS and
outputs at the same places in both versions, so they agree to a couple
of bf16 ulps (2e-2).
"""

import numpy as np
import pytest
import torch

from bflc_demo_tpu_torch.meshagg import spec
from bflc_demo_tpu_torch.models import make_transformer_classifier
from bflc_demo_tpu_torch.ops import certified_reduce as cr
from bflc_demo_tpu_torch.ops import fingerprint as fp
from bflc_demo_tpu_torch.ops import flash_attention as fa

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, device, s_kv=None, seed=11):
    """q/dO of `shape` (B, S_q, H, D); k/v with S_kv keys (default S_q)."""
    b, s, h, d = shape
    s_kv = s_kv or s
    rng = np.random.default_rng(seed)

    def rand(rows):
        return torch.as_tensor(rng.standard_normal((b, rows, h, d)),
                               device=device).to(dtype)
    q, g, k, v = rand(s), rand(s), rand(s_kv), rand(s_kv)
    mask = torch.ones((b, s_kv), dtype=torch.bool)
    if s_kv > 128:
        mask[0, 64:128] = False          # one fully masked 64-key tile
        mask[-1, 150:] = False           # ragged tail
    else:
        mask[0, s_kv // 2:] = False
    return q, k, v, g, mask.to(device)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,s_kv", [
    ((16, 64, 4, 32), None),             # the config-5 training batch
    ((2, 256, 2, 64), None),             # several tiles each way
    ((3, 40, 2, 16), None),              # a sequence shorter than a tile
    ((2, 64, 2, 128), 192),              # more keys than queries
    ((1, 64, 1, 32), None),              # forward: 4 one-warp blocks
    ((2, 1024, 4, 32), None),            # forward: two-warp blocks
    ((16, 512, 4, 32), None),            # forward: four-warp blocks
    ((2, 64, 2, 32), 1024),              # far more keys than queries
    ((2, 64, 4, 32), 4096),              # dK/dV four warps, dQ one
])
def test_kernels_match_plain(cuda_device, dtype, shape, s_kv):
    q, k, v, g, mask = _inputs(shape, dtype, cuda_device, s_kv)
    out, lse = fa.flash_fwd(q, k, v, mask)
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, mask)
    delta = fa.attention_delta(g, out)
    dk, dv = fa.flash_dkdv(q, k, v, mask, g, lse, delta)
    dq = fa.flash_dq(q, k, v, mask, g, lse, delta)
    want_dk, want_dv = fa.flash_dkdv_plain(q, k, v, mask, g, lse, delta)
    want_dq = fa.flash_dq_plain(q, k, v, mask, g, lse, delta)
    torch.cuda.synchronize()
    for got, want in ((out, want_out), (lse, want_lse), (dq, want_dq),
                      (dk, want_dk), (dv, want_dv)):
        _close(got, want, dtype)


@pytest.mark.cuda
def test_launches_counted_and_bad_head_dim_raises(cuda_device):
    q, k, v, _, mask = _inputs((2, 64, 2, 16), torch.float32, cuda_device)
    fa.reset_launches()
    fa.flash_fwd(q, k, v, mask)
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_dkdv": 0, "flash_dq": 0,
                           "flash_carry": 0}
    q24 = torch.zeros((2, 64, 2, 24), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(q24, q24, q24, mask)


def _zero_carry(shape, device):
    b, s, h, d = shape
    return (torch.zeros((b * h, s, d), device=device),
            torch.full((b * h, 1, s), fa.NEG_INF, device=device),
            torch.zeros((b * h, 1, s), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,s_kv", [
    ((4, 256, 2, 32), None),             # ragged + a fully masked tile
    ((2, 64, 2, 128), 192),              # more keys than queries
    ((2, 128, 2, 16), 64),
    ((2, 256, 2, 64), None),
    ((32, 1024, 4, 32), None),           # the sp training shard
])
def test_carry_kernel_matches_plain_over_two_hops(cuda_device, dtype, shape,
                                                  s_kv):
    q, k, v, _, mask = _inputs(shape, dtype, cuda_device, s_kv)
    _, k2, v2, _, mask2 = _inputs(shape, dtype, cuda_device, s_kv, seed=12)
    mask2[-1] = False                    # a hop with no valid key
    carry = _zero_carry(shape, cuda_device)
    for kb, vb, mb in ((k, v, mask), (k2, v2, mask2)):
        got = fa.flash_carry(q, kb, vb, mb, *carry)
        want = fa.flash_carry_plain(q, kb, vb, mb, *carry)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            scale = max(1.0, float(w[w > fa.NEG_INF / 2].abs().max()))
            _close(g / scale, w / scale, dtype)
        carry = got                      # the next hop resumes from it


def _offset_by_one(t):
    """A contiguous copy of `t` whose storage starts one element in."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("which,match", [("q", "16-byte"),
                                         ("acc", "8-byte")])
def test_carry_kernel_rejects_misaligned_storage(cuda_device, which, match):
    q, k, v, _, mask = _inputs((2, 64, 2, 32), torch.float32, cuda_device)
    acc, m, l = _zero_carry(q.shape, cuda_device)
    if which == "q":
        q = _offset_by_one(q)
    else:
        acc = _offset_by_one(acc)
    fa.reset_launches()
    with pytest.raises(ValueError, match=match):
        fa.flash_carry(q, k, v, mask, acc, m, l)
    assert fa.LAUNCHES["flash_carry"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_reject_misaligned_do(cuda_device, dtype):
    q, k, v, g, mask = _inputs((2, 64, 2, 32), dtype, cuda_device)
    out, lse = fa.flash_fwd(q, k, v, mask)
    delta = fa.attention_delta(g, out)
    g = _offset_by_one(g)
    fa.reset_launches()
    for fn in (fa.flash_dkdv, fa.flash_dq):
        with pytest.raises(ValueError, match="16-byte"):
            fn(q, k, v, mask, g, lse, delta)
    assert fa.LAUNCHES["flash_dkdv"] == 0 and fa.LAUNCHES["flash_dq"] == 0


@pytest.mark.cuda
def test_backward_kernels_take_misaligned_lse_and_delta(cuda_device):
    """lse and delta need no alignment: a tile whose slice is not 16-byte
    aligned is staged by plain loads."""
    q, k, v, g, mask = _inputs((2, 128, 2, 32), torch.float32, cuda_device)
    out, lse = fa.flash_fwd(q, k, v, mask)
    delta = fa.attention_delta(g, out)
    lse1, delta1 = _offset_by_one(lse), _offset_by_one(delta)
    dk, dv = fa.flash_dkdv(q, k, v, mask, g, lse1, delta1)
    dq = fa.flash_dq(q, k, v, mask, g, lse1, delta1)
    want_dk, want_dv = fa.flash_dkdv_plain(q, k, v, mask, g, lse, delta)
    want_dq = fa.flash_dq_plain(q, k, v, mask, g, lse, delta)
    torch.cuda.synchronize()
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
        _close(got, want, torch.float32)


@pytest.mark.cuda
def test_carry_kernel_rejects_ragged_tiles(cuda_device):
    q, k, v, _, mask = _inputs((2, 96, 2, 32), torch.float32, cuda_device)
    fa.reset_launches()
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.flash_carry(q, k, v, mask, *_zero_carry(q.shape, cuda_device))
    assert fa.LAUNCHES["flash_carry"] == 0


def _fingerprint_tree(device):
    """A tree of every dtype the kernel takes, ragged and empty leaves,
    a 64-bit leaf and a non-contiguous view, stacked over 3 slices."""
    gen = torch.Generator().manual_seed(5)
    f32 = torch.randn((3, 7, 5), generator=gen)
    return {
        "['a']": f32.to(device),
        "['b']['bf16']": torch.randn((3, 13), generator=gen)
        .to(torch.bfloat16).to(device),
        "['b']['f16']": torch.randn((3, 4, 3), generator=gen)
        .to(torch.float16).to(device),
        "['c'][0]": torch.randint(-128, 128, (3, 9), generator=gen,
                                  dtype=torch.int8).to(device),
        "['c'][1]": (torch.rand((3, 6), generator=gen) < 0.5).to(device),
        "['c'][2]": torch.randint(-2**31, 2**31 - 1, (3, 3, 3),
                                  generator=gen, dtype=torch.int32)
        .to(device),
        "['c'][10]": torch.randn((3, 5), generator=gen,
                                 dtype=torch.float64).to(device),
        "['d']": torch.zeros((3, 0), device=device),
        "['e']": f32.transpose(1, 2).to(device),      # not contiguous
    }


@pytest.mark.cuda
def test_fingerprint_kernel_matches_plain_bit_for_bit(cuda_device):
    tree = _fingerprint_tree(cuda_device)
    fp.reset_launches()
    got = fp.fingerprint_stacked(tree)
    one = fp.fingerprint_pytree({k: v[1] for k, v in tree.items()})
    assert fp.LAUNCHES["fingerprint"] == 2
    want = fp.fingerprint_plain({k: v.cpu() for k, v in tree.items()})
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(one.cpu(), want[1])


@pytest.mark.cuda
def test_fingerprint_kernel_on_config5_deltas(cuda_device):
    """The mesh round's call: 20 stacked deltas of config 5's model."""
    model = make_transformer_classifier()
    gen = torch.Generator().manual_seed(6)
    deltas = {k: torch.randn((20,) + tuple(v.shape), generator=gen)
              for k, v in model.init_params(0).items()}
    got = fp.fingerprint_stacked({k: v.to(cuda_device)
                                  for k, v in deltas.items()})
    plain = fp.fingerprint_plain({k: v[:2] for k, v in deltas.items()})
    torch.cuda.synchronize()
    assert got.shape == (20, 8)
    assert torch.equal(got[:2].cpu(), plain)
    assert len({tuple(r) for r in got.cpu().tolist()}) == 20


def _reduce_case(seed):
    """(N, P) deltas with the spec's corners, and weights with zeros."""
    rng = np.random.default_rng(seed)
    n, p = int(rng.integers(3, 40)), int(rng.integers(64, 5000))
    mat = (rng.standard_normal((n, p))
           * 10.0 ** rng.integers(-40, 38, (n, 1))).astype(np.float32)
    w = (rng.random(n) * 40).astype(np.float32)
    w[rng.random(n) < 0.3] = 0.0
    w[0], w[1] = 0.0, 3.0
    mat[0, :6] = np.float32([np.nan, np.inf, -np.inf, 1e-42, -0.0, 5.0])
    mat[1, :4] = np.float32([1e-42, -1e-42, 1e-38, -1e-38])
    mat[1, 4], mat[-1, 4] = np.inf, -np.inf       # selected +-inf
    if w[-1] == 0.0:
        w[-1] = 1.0
    return mat, w


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_certified_reduce_matches_plain_and_spec_bytes(cuda_device, seed):
    mat, w = _reduce_case(seed)
    wsum = max(float(w.sum()), 1e-12)
    with np.errstate(all="ignore"):
        want = spec.host_weighted_sum(["x"], [{"x": r} for r in mat], w,
                                      wsum)["x"]
    m = torch.from_numpy(mat).to(cuda_device)
    c = torch.from_numpy(spec.merge_coefficients(w, wsum)).to(cuda_device)
    g = torch.from_numpy(w > 0).to(cuda_device)
    cr.reset_launches()
    got = cr.certified_reduce(m, c, g)
    plain = cr.certified_reduce_plain(m, c, g)
    torch.cuda.synchronize()
    assert cr.LAUNCHES["certified_reduce"] == 1
    assert got.cpu().numpy().tobytes() == want.tobytes()
    assert plain.cpu().numpy().tobytes() == want.tobytes()
    assert got.cpu().numpy().view(np.uint32)[4] == 0xFFC00000
    p = mat.shape[1]
    for blocks in (2, 5, 8, 64):
        for lo, hi in spec.block_bounds(p, blocks):
            part = cr.certified_reduce(m[:, lo:hi], c, g)   # row stride p
            assert part.cpu().numpy().tobytes() == want[lo:hi].tobytes()


@pytest.mark.cuda
def test_certified_reduce_rejects_what_it_cannot_take(cuda_device):
    m = torch.zeros((3, 8), device=cuda_device)
    c = torch.ones(3, device=cuda_device)
    g = torch.ones(3, dtype=torch.bool, device=cuda_device)
    cr.reset_launches()
    for args in ((m[:, ::2], c, g), (m.double(), c, g), (m, c[:2], g),
                 (m, c, g.float()), (m, c.cpu(), g)):
        with pytest.raises(ValueError):
            cr.certified_reduce(*args)
    assert cr.LAUNCHES["certified_reduce"] == 0


def _strip_case(n, p, seed, cols):
    """(n, p + 3) deltas and weights whose specials sit at the tile,
    stage and strip boundaries of a `cols`-column strip route (or at the
    8-slot batches and 256-column CTAs of the column kernel)."""
    rng = np.random.default_rng(seed)
    mat = (rng.standard_normal((n, p + 3))
           * 10.0 ** rng.integers(-30, 30, (n, 1))).astype(np.float32)
    w = (rng.random(n) * 10).astype(np.float32)
    w[rng.random(n) < 0.3] = 0.0
    w[0] = 1.0
    width = cols or cr.COLUMN_THREADS
    tile = cr.TILE_FLOATS // cols if cols else 8
    rows = sorted({r % n for r in (tile - 1, tile, 4 * tile - 1, 4 * tile,
                                   n - 1)})
    edges = sorted({c % p for c in (0, width - 1, width, width + 1, p - 1)})
    for j, c in enumerate(edges):
        r = rows[j % len(rows)]
        mat[r, c + 3 - j % 4] = (np.nan, np.inf, -np.inf, 1e-42)[j % 4]
    # NaN and inf where the gate is off
    if n > 2:
        w[1] = 0.0
        mat[1, :8] = np.float32([np.nan, np.inf, -np.inf, np.nan,
                                 np.inf, 1e-42, -np.nan, 3.0])
    # a subnormal sum in the last column of every window: two selected
    # normal terms, 1.5e-38 and -1.4e-38, that nearly cancel
    if n > 1:
        w[-1] = w[0]
        coeff = spec.merge_coefficients(w, max(float(w.sum()), 1e-12))
        mat[:, p - 1] = 0.0
        mat[0, p - 1] = 1.5e-38 / coeff[0]
        mat[-1, p - 1] = -1.4e-38 / coeff[-1]
    return mat, w


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1203, 9601, 70001])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 63, 64, 65, 1024, 1025])
def test_certified_reduce_strips_give_the_spec_bytes(cuda_device, n, p):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    cols, _ = cr.launch_shape(n, p, True, sms)
    mat, w = _strip_case(n, p, n * 7 + p, cols)
    wsum = max(float(w.sum()), 1e-12)
    m = torch.from_numpy(mat).to(cuda_device)          # row stride p + 3
    c = torch.from_numpy(spec.merge_coefficients(w, wsum)).to(cuda_device)
    g = torch.from_numpy(w > 0).to(cuda_device)
    for off in range(4):                               # 0-3 mod 4
        with np.errstate(all="ignore"):
            want = spec.host_weighted_sum(
                ["x"], [{"x": r[off:off + p]} for r in mat], w, wsum)["x"]
        got = cr.certified_reduce(m[:, off:off + p], c, g)
        assert got.cpu().numpy().tobytes() == want.tobytes(), (off, cols)
    odd = torch.from_numpy(np.ascontiguousarray(mat[:, :p])).to(cuda_device)
    with np.errstate(all="ignore"):
        want = spec.host_weighted_sum(["x"], [{"x": r[:p]} for r in mat], w,
                                      wsum)["x"]
    assert cr.certified_reduce(odd, c, g).cpu().numpy().tobytes() == \
        want.tobytes()                                 # ld = p, odd


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(10, 4099), (64, 1200), (300, 9600),
                                 (1025, 257)])
def test_certified_reduce_every_route_gives_the_spec_bytes(cuda_device, n,
                                                           p):
    mat, w = _strip_case(n, p, n + p, 32)
    wsum = max(float(w.sum()), 1e-12)
    m = torch.from_numpy(mat).to(cuda_device)
    c = torch.from_numpy(spec.merge_coefficients(w, wsum)).to(cuda_device)
    g = torch.from_numpy(w > 0).to(cuda_device)
    aligned = torch.from_numpy(np.ascontiguousarray(mat[:, 4:4 + p - 3])) \
        .to(cuda_device)
    with np.errstate(all="ignore"):
        want = spec.host_weighted_sum(["x"], [{"x": r[1:1 + p]}
                                              for r in mat], w, wsum)["x"]
        want_aligned = spec.host_weighted_sum(
            ["x"], [{"x": r[4:4 + p - 3]} for r in mat], w, wsum)["x"]
    for cols in (0,) + cr.STRIP_COLUMNS:
        got = cr._launch(m[:, 1:1 + p], c, g, cols, 1)
        assert got.cpu().numpy().tobytes() == want.tobytes(), cols
        if aligned.stride(0) % 4 == 0:
            got = cr._launch(aligned, c, g, cols, 4)
            assert got.cpu().numpy().tobytes() == want_aligned.tobytes(), \
                cols


@pytest.mark.cuda
def test_certified_chain_latency_is_measured(cuda_device):
    ms, cycles = cr.chain_latency(1 << 16, cuda_device)
    assert 0 < ms < 1e-3 and 1 <= cycles < 100
