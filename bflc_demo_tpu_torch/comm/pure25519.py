"""Pure-Python Ed25519 (RFC 8032) + X25519 (RFC 7748).

Copy of `bflc_demo_tpu/comm/pure25519.py`, unchanged below this
docstring: the signing backend `comm/identity.py` falls back to where
the `cryptography` wheel is absent (the GPU machine's image has none),
with the same three caches (the fixed-base window table, the
per-public-key decompressed points, the per-seed expanded keys) and the
same `BFLC_CONTROL_PLANE_LEGACY=1` switch that disables them.  Ed25519
is deterministic, so keys and signatures are the reference's bytes
under either backend.  Nothing is dropped: X25519 stays with the
signing code it shares its field arithmetic with, although the port's
wallets do not use it yet (secure aggregation, ROADMAP A12).
"""

from __future__ import annotations

import hashlib
import os

_P = 2 ** 255 - 19                      # the curve25519 field prime
_L = 2 ** 252 + 27742317777372353535851937790883648493   # group order
_D = (-121665 * pow(121666, _P - 2, _P)) % _P            # edwards d


def _inv(x: int) -> int:
    return pow(x, _P - 2, _P)


# ---------------------------------------------------------------- ed25519
# Points are extended homogeneous coordinates (X, Y, Z, T) with x = X/Z,
# y = Y/Z, x*y = T/Z — the standard complete addition law, so no special
# cases for doubling or the identity.

def _pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    d = 2 * z1 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _pt_mul(s: int, p):
    q = (0, 1, 1, 0)                    # neutral element
    while s > 0:
        if s & 1:
            q = _pt_add(q, p)
        p = _pt_add(p, p)
        s >>= 1
    return q


def _pt_dbl(p):
    """Dedicated doubling (dbl-2008-hwcd, a=-1): 4 squarings + 4
    multiplications versus the unified law's 9 — doublings dominate every
    variable-base ladder, so this is the cheapest 20% in the file.  Same
    group element as _pt_add(p, p) (cross-checked in tests)."""
    x1, y1, z1, _ = p
    a = x1 * x1 % _P
    b = y1 * y1 % _P
    c = 2 * z1 * z1 % _P
    e = ((x1 + y1) * (x1 + y1) - a - b) % _P
    g = (b - a) % _P                    # a=-1: D + B with D = -A
    f = (g - c) % _P
    h = (-a - b) % _P
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _pt_neg(p):
    x, y, z, t = p
    return ((-x) % _P, y, z, (-t) % _P)


def _pt_mul_wnaf(s: int, p):
    """Variable-base scalar mult via width-4 NAF: ~s.bit_length()
    doublings (dedicated formula) + ~bits/5 additions from a 4-entry
    odd-multiples table — the h*A half of every signature verification.
    Same group element as _pt_mul(s, p)."""
    if s <= 0:
        return _pt_mul(s, p)            # 0: neutral (loop never runs)
    p2 = _pt_dbl(p)
    tbl = [p]                           # p, 3p, 5p, 7p
    for _ in range(3):
        tbl.append(_pt_add(tbl[-1], p2))
    digits = []
    while s > 0:
        if s & 1:
            d = s & 15
            if d >= 8:
                d -= 16
            digits.append(d)
            s -= d
        else:
            digits.append(0)
        s >>= 1
    q = (0, 1, 1, 0)
    for d in reversed(digits):
        q = _pt_dbl(q)
        if d > 0:
            q = _pt_add(q, tbl[d >> 1])
        elif d < 0:
            q = _pt_add(q, _pt_neg(tbl[(-d) >> 1]))
    return q


def _pt_equal(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return ((x1 * z2 - x2 * z1) % _P == 0
            and (y1 * z2 - y2 * z1) % _P == 0)


def _recover_x(y: int, sign: int):
    """x from the curve equation given y and the sign bit; None if y is
    not on the curve (RFC 8032 §5.1.3 decoding)."""
    if y >= _P:
        return None
    x2 = (y * y - 1) * _inv(_D * y * y + 1) % _P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (_P + 3) // 8, _P)
    if (x * x - x2) % _P != 0:
        x = x * pow(2, (_P - 1) // 4, _P) % _P
    if (x * x - x2) % _P != 0:
        return None
    if (x & 1) != sign:
        x = _P - x
    return x


_GY = 4 * _inv(5) % _P
_GX = _recover_x(_GY, 0)
_G = (_GX, _GY, 1, _GX * _GY % _P)      # the base point

# ----------------------------------------------------------- fast path
# See module docstring.  The legacy switch is read once at import: child
# processes of the federation benchmark inherit it through the spawn env;
# in-process tests drive the underlying functions directly instead.
_FAST_DISABLED = bool(os.environ.get("BFLC_CONTROL_PLANE_LEGACY"))

_BASE_TABLE = None                      # built lazily on first basepoint mul


def _build_base_table():
    """table[w][d] = d * 16**w * G for 4-bit windows w in [0, 64): one
    point addition per nonzero scalar digit replaces the ladder's ~255
    doublings + ~127 additions."""
    rows = []
    base = _G
    for _ in range(64):
        row = [(0, 1, 1, 0)]
        for _ in range(15):
            row.append(_pt_add(row[-1], base))
        rows.append(row)
        for _ in range(4):
            base = _pt_add(base, base)
    return rows


def _pt_mul_base(s: int):
    """s * G via the fixed-base window table — the same group element as
    _pt_mul(s, _G), hence byte-identical compressed output (projective
    coordinates differ; _compress normalizes)."""
    global _BASE_TABLE
    if _BASE_TABLE is None:
        _BASE_TABLE = _build_base_table()
    q = (0, 1, 1, 0)
    w = 0
    while s > 0:
        d = s & 15
        if d:
            q = _pt_add(q, _BASE_TABLE[w][d])
        s >>= 4
        w += 1
    return q


def _mul_base(s: int):
    if _FAST_DISABLED:
        return _pt_mul(s, _G)
    return _pt_mul_base(s)


def _pt_multi_mul(pairs):
    """sum(s_i * P_i) with ONE shared doubling chain (Straus): the
    backbone of batch verification — n points cost ~max_bits doublings
    total instead of ~256 each."""
    q = (0, 1, 1, 0)
    top = 0
    for s, _ in pairs:
        top = max(top, s.bit_length())
    for b in range(top - 1, -1, -1):
        q = _pt_dbl(q)
        for s, pt in pairs:
            if (s >> b) & 1:
                q = _pt_add(q, pt)
    return q


def _compress(p) -> bytes:
    x, y, z, _ = p
    zi = _inv(z)
    x, y = x * zi % _P, y * zi % _P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decompress(s: bytes):
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % _P)


def _expand_seed(seed: bytes):
    """RFC 8032 §5.1.5: seed -> (clamped scalar, nonce prefix)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


# seed -> (scalar, prefix, compressed public): a wallet signs many ops
# per round; re-deriving the key material per signature wastes a full
# basepoint mul.  Bounded — a process holds a handful of identities.
_SEED_CACHE: dict = {}
_SEED_CACHE_MAX = 64


def _expanded(seed: bytes):
    e = _SEED_CACHE.get(seed)
    if e is None:
        a, prefix = _expand_seed(seed)
        e = (a, prefix, _compress(_mul_base(a)))
        if not _FAST_DISABLED:
            if len(_SEED_CACHE) >= _SEED_CACHE_MAX:
                _SEED_CACHE.pop(next(iter(_SEED_CACHE)))
            _SEED_CACHE[bytes(seed)] = e
    return e


# pubkey -> decompressed extended point.  Verifier-side mirror of the
# seed cache: decompression costs two field exponentiations, and the
# same few validator/standby/client keys verify everything.
_PUB_CACHE: dict = {}
_PUB_CACHE_MAX = 1024


def _decompress_pub(public: bytes):
    if _FAST_DISABLED:
        return _decompress(public)
    p = _PUB_CACHE.get(public)
    if p is None:
        p = _decompress(public)
        if p is not None:
            if len(_PUB_CACHE) >= _PUB_CACHE_MAX:
                try:
                    _PUB_CACHE.pop(next(iter(_PUB_CACHE)))
                except KeyError:        # racing evictors: already gone
                    pass
            _PUB_CACHE[bytes(public)] = p
    return p


def ed25519_public(seed: bytes) -> bytes:
    """32-byte public key for a 32-byte private seed."""
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    return _expanded(seed)[2]


def ed25519_sign(seed: bytes, message: bytes) -> bytes:
    """Deterministic 64-byte signature (RFC 8032 §5.1.6)."""
    a, prefix, pub = _expanded(seed)
    r = int.from_bytes(hashlib.sha512(prefix + message).digest(),
                       "little") % _L
    r_enc = _compress(_mul_base(r))
    h = int.from_bytes(hashlib.sha512(r_enc + pub + message).digest(),
                       "little") % _L
    s = (r + h * a) % _L
    return r_enc + int.to_bytes(s, 32, "little")


def ed25519_verify(public: bytes, message: bytes, signature: bytes) -> bool:
    """True iff `signature` is a valid signature of `message` by `public`
    (RFC 8032 §5.1.7; cofactorless equation, matching modern verifiers on
    honestly-generated signatures).  Never raises on malformed inputs."""
    if len(public) != 32 or len(signature) != 64:
        return False
    a_pt = _decompress_pub(public)
    r_pt = _decompress(signature[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= _L:                         # malleability rejection
        return False
    h = int.from_bytes(hashlib.sha512(signature[:32] + public
                                      + message).digest(), "little") % _L
    if _FAST_DISABLED:
        return _pt_equal(_pt_mul(s, _G), _pt_add(r_pt, _pt_mul(h, a_pt)))
    return _pt_equal(_mul_base(s), _pt_add(r_pt, _pt_mul_wnaf(h, a_pt)))


def ed25519_verify_batch(items) -> bool:
    """Batch verification of (public, message, signature) triples via a
    random linear combination: 8·(sum z_i s_i) G == 8·(sum z_i R_i
    + sum_{pubkeys} (sum z_i h_i) A) — one shared-doubling multiscalar
    mul for the whole batch instead of two ladder muls per signature.

    The equation is COFACTORED (both sides multiplied by 8, RFC 8032
    §8.9 / the standard Ed25519 batch equation), which is what makes the
    result DETERMINISTIC: honest signatures satisfy the per-item
    equation exactly, so any combination holds (no randomness in the
    accept direction); a signature with only a small-torsion defect is
    consistently ACCEPTED (8 annihilates the torsion component on every
    call — never a coin flip that could make one verifier count a quorum
    another rejects); a genuinely forged signature survives with
    probability ~2^-128 over the blinding scalars z_i.

    True therefore means every triple verifies under cofactored
    semantics.  False means at least one failed: callers needing
    attribution fall back to per-item ed25519_verify (cofactorless —
    strictly stricter, so the fallback never accepts what the batch
    refused).  Never raises on malformed input."""
    if not items:
        return True
    rnd = os.urandom(16 * len(items))
    s_acc = 0
    pairs = []
    a_coeff: dict = {}                  # pubkey -> [coeff, point]
    for j, (pub, msg, sig) in enumerate(items):
        if not (isinstance(pub, (bytes, bytearray))
                and isinstance(sig, (bytes, bytearray))
                and len(pub) == 32 and len(sig) == 64):
            return False
        pub, sig = bytes(pub), bytes(sig)
        a_pt = _decompress_pub(pub)
        r_pt = _decompress(sig[:32])
        if a_pt is None or r_pt is None:
            return False
        s = int.from_bytes(sig[32:], "little")
        if s >= _L:                     # malleability rejection
            return False
        h = int.from_bytes(hashlib.sha512(sig[:32] + pub
                                          + bytes(msg)).digest(),
                           "little") % _L
        z = 1 + int.from_bytes(rnd[16 * j:16 * (j + 1)], "little")
        s_acc = (s_acc + z * s) % _L
        pairs.append((z, r_pt))
        entry = a_coeff.get(pub)
        if entry is None:
            a_coeff[pub] = [z * h % _L, a_pt]
        else:
            entry[0] = (entry[0] + z * h) % _L
    pairs.extend((c, pt) for c, pt in a_coeff.values())
    lhs, rhs = _mul_base(s_acc), _pt_multi_mul(pairs)
    for _ in range(3):                  # cofactor 8: three doublings
        lhs, rhs = _pt_dbl(lhs), _pt_dbl(rhs)
    return _pt_equal(lhs, rhs)


# ----------------------------------------------------------------- x25519
def _clamp(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def _x25519_ladder(k: int, u: int) -> int:
    """Montgomery ladder (RFC 7748 §5) — constant structure, variable-time
    bigints (see module docstring for why that is acceptable here)."""
    x1 = u
    x2, z2, x3, z3 = 1, 0, u, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = x1 * z3 * z3 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + 121665 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, _P - 2, _P) % _P


def x25519_exchange(private: bytes, peer_public: bytes) -> bytes:
    """Shared secret u-coordinate for (our scalar, their public)."""
    if len(private) != 32 or len(peer_public) != 32:
        raise ValueError("x25519 keys must be 32 bytes")
    u = int.from_bytes(peer_public, "little") & ((1 << 255) - 1)
    out = _x25519_ladder(_clamp(private), u)
    if out == 0:                        # small-order peer point
        raise ValueError("x25519: degenerate shared secret")
    return int.to_bytes(out, 32, "little")


def x25519_public(private: bytes) -> bytes:
    """Public u-coordinate for a 32-byte scalar (base point u=9)."""
    if len(private) != 32:
        raise ValueError("x25519 keys must be 32 bytes")
    return int.to_bytes(_x25519_ladder(_clamp(private), 9), 32, "little")
