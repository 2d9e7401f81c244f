// Secure aggregation's masked fixed-point encode for Hopper (sm_90a): kernel
// B7, every slot's blinded upload of every leaf of a round in one launch.
//
// Replaces the XLA program of bflc_demo_tpu/parallel/secure.py —
//   secure_mask_kernel <- secure_fedavg_body (:235-307): its per-leaf
//                         encode and mask, `_client_mask` (:55-81) and
//                         `_client_mask_dh` (:84-121) over every slot
// (no pallas_call there: the protocol needs its words bit for bit) and
// computes what the plain PyTorch version ../secure_mask.py:
// masked_encode_leaves_plain computes, bit for bit.  For each leaf of
// S slots x n elements, per slot i and element e of the leaf:
//
//   x   = nan_to_num(delta[i][e], nan=0, posinf=clip, neginf=-clip)
//   x   = clip(clip(x, -clip, clip) * wn[i], -clip, clip)
//   q   = int32(round_half_even(x * 2^16))
//   out = q + sum_{j>i} m_ij[e] - sum_{j<i} m_ij[e]          (mod 2^32)
//
// with m_ij[e] = x0 ^ x1 of Threefry-2x32 (20 rounds) under the pair's key
// over the counter (0, e) — jax.random.bits' partitionable draw of the
// leaf's flat iota, whose high word is 0 below 2^32 elements (the wrapper
// refuses a larger leaf).  The keys are the fold_in chains of
// parallel/secure.py (round key or X25519 pair seed, then the leaf index),
// derived on the host and packed as the upper triangle of each leaf's
// pairs, (i, j) with i < j in row order.
//
// What bounds it: integer operations.  A mask word is ~74 of them (20
// rotate-add-xor rounds, the key injections, the final xor, the add into
// a slot), and each of the S(S-1)/2 pairs' masks is drawn once, added to
// slot i and subtracted from slot j — 120 pairs at config 4's 16 slots,
// so ~10^11 operations a round of 11.2 M parameters, against the 4 bytes
// read and 4 written a slot-element.  Tensor cores, TMA and asynchronous
// copies have no work here: the bytes are 1/10^3 of the operations' time.
// The design:
//   * one launch a round: a device table of the leaves (LeafDesc) maps
//     each block to one tile of one leaf (a block never straddles two, so
//     each leaf's counter starts at 0), and the warps of the small leaves
//     run beside those of the large ones instead of one launch a leaf in
//     stream order;
//   * a block finds its leaf once (all threads test the table's rows at
//     once) and stages the leaf's pair constants in shared memory once:
//     k0, k1, k2 = k0 ^ k1 ^ parity and the injection words k + c, so the
//     element loop computes none of them;
//   * each thread carries kElems = 2 elements (a tile's columns kThreads
//     apart, coalesced), so each pair's constants are read once for two
//     independent chains the scheduler can interleave;
//   * the counter's high word is 0: x0 starts at k0, and the element
//     index is 32-bit;
//   * the SM's two integer-capable pipes share the work.  The INT pipe
//     takes what only it can do, a funnel shift (SHF) and an xor (LOP3) a
//     round; every add goes to the FMA pipe (IMAD.IADD), the x0 key
//     injections too, as an IMAD by a run-time 1 that ptxas cannot fold
//     into a three-input IADD3 (INT pipe).  That leaves 41.5 INT-pipe and
//     33 FMA-pipe instructions a mask word (eval/sass.py counts the pair
//     loop's SASS) and the INT pipe, 64 lanes an SM, the floor.  A rotate
//     as a multiply by 2^r on the FMA pipe (IMAD.WIDE.U32, or IMAD.HI.U32
//     and IMAD) measured slower for every share of the rounds tried: both
//     take far more of the pipe than an IMAD;
//   * the slots' sums live in shared memory ([slot][element][thread]: no
//     bank conflicts), so any S up to the wrapper's 40 fits one build.
//     In registers they would spare only MIO and FMA-pipe instructions
//     (the load, the store, an add), none of the INT pipe's;
//   * the encode uses __fmul_rn (no contraction into a neighbouring op)
//     and __float2int_rn (round half to even, as jnp.round; roundf rounds
//     half away from zero); NaN becomes 0 and +-inf +-clip BEFORE the
//     clip, which would carry a NaN through (the reference's order).
//
// Plain C interface, loaded with ctypes (../build.py).  The entry returns
// cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kElems = 2;                     // elements a thread
constexpr int kTile = kThreads * kElems;      // elements a block
constexpr unsigned kParity = 0x1BD11BDAu;
constexpr float kScale = 65536.0f;            // 2^16, _FRAC_BITS = 16

// rotation k of the 8: the even groups' four rounds (13, 15, 26, 6),
// then the odd groups' (17, 29, 16, 24)
__device__ constexpr int rotation(int k) {
  return k == 0 ? 13 : k == 1 ? 15 : k == 2 ? 26 : k == 3 ? 6
       : k == 4 ? 17 : k == 5 ? 29 : k == 6 ? 16 : 24;
}

// One leaf of the round; layout mirrored by ../secure_mask.py:_LEAF_DTYPE.
struct LeafDesc {
  const float* deltas;   // (S, n) float32, row-major
  long long out_off;     // the leaf's first column of the (S, total) words
  unsigned n;            // elements a slot (< 2^32)
  int first_block;       // the leaf's first block; its tiles follow
  int key_off;           // the leaf's first pair in the packed keys
  int unused;
};

// rotl(x, rotation(k)) ^ y
template <int k>
__device__ __forceinline__ unsigned rot_xor(unsigned x, unsigned y) {
  return __funnelshift_l(x, x, rotation(k)) ^ y;
}

// four rounds with rotations 4g .. 4g + 3 on every element's chain
template <int g>
__device__ __forceinline__ void rounds(unsigned (&x0)[kElems],
                                       unsigned (&x1)[kElems]) {
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    x0[u] += x1[u]; x1[u] = rot_xor<4 * g + 0>(x1[u], x0[u]);
    x0[u] += x1[u]; x1[u] = rot_xor<4 * g + 1>(x1[u], x0[u]);
    x0[u] += x1[u]; x1[u] = rot_xor<4 * g + 2>(x1[u], x0[u]);
    x0[u] += x1[u]; x1[u] = rot_xor<4 * g + 3>(x1[u], x0[u]);
  }
}

// the key injection; x0's add as an IMAD by the run-time `one` (FMA pipe),
// so ptxas cannot fold it into the next round's three-input IADD3 (INT pipe)
__device__ __forceinline__ void inject(unsigned (&x0)[kElems],
                                       unsigned (&x1)[kElems], unsigned a,
                                       unsigned b, unsigned one) {
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    x0[u] = x0[u] * one + a;
    x1[u] += b;
  }
}

// the fixed-point encode of one delta element (secure_fedavg_body's
// nan_to_num -> clip -> * wn -> clip -> round(x * 2^16) -> int32)
__device__ __forceinline__ unsigned encode(float x, float w, float clip) {
  if (isnan(x)) x = 0.0f;
  else if (isinf(x)) x = x > 0.0f ? clip : -clip;
  x = fminf(fmaxf(x, -clip), clip);
  x = fminf(fmaxf(__fmul_rn(x, w), -clip), clip);
  return static_cast<unsigned>(__float2int_rn(__fmul_rn(x, kScale)));
}

__global__ void __launch_bounds__(kThreads)
secure_mask_kernel(const LeafDesc* __restrict__ leaves, int n_leaves,
                   const uint2* __restrict__ keys,
                   const float* __restrict__ wn, int slots, long long total,
                   float clip, unsigned one, unsigned* __restrict__ out) {
  extern __shared__ uint4 smem[];
  __shared__ int leaf_index;
  const int pairs = slots * (slots - 1) / 2;
  uint4* consts = smem;                                   // [pairs][2]
  unsigned* acc = reinterpret_cast<unsigned*>(smem + 2 * pairs);
  const int tid = threadIdx.x;
  const int block = blockIdx.x;

  // the leaf whose blocks [first_block, the next leaf's) hold this one
  for (int l = tid; l < n_leaves; l += kThreads) {
    const int end = l + 1 < n_leaves ? leaves[l + 1].first_block
                                     : static_cast<int>(gridDim.x);
    if (leaves[l].first_block <= block && block < end) leaf_index = l;
  }
  __syncthreads();
  const LeafDesc leaf = leaves[leaf_index];

  // each pair's words, once a block: (k0, k1, k2, k2 + 1) and the
  // injections' (k0 + 2, k1 + 3, k2 + 4, k0 + 5)
  for (int p = tid; p < pairs; p += kThreads) {
    const uint2 k = keys[leaf.key_off + p];
    const unsigned k2 = k.x ^ k.y ^ kParity;
    consts[2 * p] = make_uint4(k.x, k.y, k2, k2 + 1u);
    consts[2 * p + 1] = make_uint4(k.x + 2u, k.y + 3u, k2 + 4u, k.x + 5u);
  }

  // element u of this thread: the tile's column tid + u * kThreads; the
  // counter is its 32-bit index in the leaf
  const long long first =
      static_cast<long long>(block - leaf.first_block) * kTile + tid;
  unsigned e[kElems];
  bool live[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    e[u] = static_cast<unsigned>(first + u * kThreads);
    live[u] = first + u * kThreads < leaf.n;
  }
  for (int i = 0; i < slots; ++i) {
    const float w = wn[i];
    const float* row = leaf.deltas + static_cast<long long>(i) * leaf.n;
#pragma unroll
    for (int u = 0; u < kElems; ++u)
      acc[(i * kElems + u) * kThreads + tid] =
          live[u] ? encode(row[e[u]], w, clip) : 0u;
  }
  __syncthreads();

  int p = 0;
  for (int i = 0; i < slots; ++i) {
    unsigned mine[kElems] = {};
    for (int j = i + 1; j < slots; ++j, ++p) {
      const uint4 a = consts[2 * p];
      const uint4 c = consts[2 * p + 1];
      unsigned x0[kElems], x1[kElems];
#pragma unroll
      for (int u = 0; u < kElems; ++u) {
        x0[u] = a.x;
        x1[u] = e[u] + a.y;
      }
      rounds<0>(x0, x1);
      inject(x0, x1, a.y, a.w, one);
      rounds<1>(x0, x1);
      inject(x0, x1, a.z, c.x, one);
      rounds<0>(x0, x1);
      inject(x0, x1, a.x, c.y, one);
      rounds<1>(x0, x1);
      inject(x0, x1, a.y, c.z, one);
      rounds<0>(x0, x1);
      inject(x0, x1, a.z, c.w, one);
#pragma unroll
      for (int u = 0; u < kElems; ++u) {
        const unsigned mask = x0[u] ^ x1[u];
        mine[u] += mask;
        acc[(j * kElems + u) * kThreads + tid] -= mask;
      }
    }
#pragma unroll
    for (int u = 0; u < kElems; ++u)
      acc[(i * kElems + u) * kThreads + tid] += mine[u];
  }

  for (int i = 0; i < slots; ++i) {
    unsigned* row = out + static_cast<long long>(i) * total + leaf.out_off;
#pragma unroll
    for (int u = 0; u < kElems; ++u)
      if (live[u]) row[e[u]] = acc[(i * kElems + u) * kThreads + tid];
  }
}

}  // namespace

extern "C" {

int bflc_secure_mask_leaf_desc_size() {
  return static_cast<int>(sizeof(LeafDesc));
}

int bflc_secure_mask_tile() { return kTile; }

// shared memory a launch needs for `slots` slots
long long bflc_secure_mask_smem(int slots) {
  const long long pairs = static_cast<long long>(slots) * (slots - 1) / 2;
  return 2 * pairs * static_cast<long long>(sizeof(uint4)) +
         static_cast<long long>(slots) * kElems * kThreads *
             static_cast<long long>(sizeof(unsigned));
}

int bflc_secure_mask(const void* leaves, int n_leaves, int blocks,
                     const void* keys, const void* wn, int slots,
                     long long total, float clip, void* out, void* stream) {
  const long long smem = bflc_secure_mask_smem(slots);
  if (smem > 47 * 1024) {             // 48 KB less the static words
    const cudaError_t err = cudaFuncSetAttribute(
        secure_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0 && slots > 0) {
    secure_mask_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const LeafDesc*>(leaves), n_leaves,
        static_cast<const uint2*>(keys), static_cast<const float*>(wn),
        slots, total, clip, 1u, static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
