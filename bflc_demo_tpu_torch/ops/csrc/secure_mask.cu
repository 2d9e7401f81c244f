// Secure aggregation's masked fixed-point encode for Hopper (sm_90a): kernel
// B7, each slot's blinded upload of one leaf.
//
// Replaces the XLA program of bflc_demo_tpu/parallel/secure.py —
//   secure_mask_kernel <- secure_fedavg_body (:217-295): its per-leaf
//                         encode and mask, `_client_mask` (:54-83) and
//                         `_client_mask_dh` (:86-117) over every slot
// (no pallas_call there: the protocol needs its words bit for bit) and
// computes what the plain PyTorch version ../secure_mask.py:
// masked_encode_plain computes, bit for bit.  For one leaf of S slots x P
// elements, per slot i and element e:
//
//   x   = nan_to_num(delta[i][e], nan=0, posinf=clip, neginf=-clip)
//   x   = clip(clip(x, -clip, clip) * wn[i], -clip, clip)
//   q   = int32(round_half_even(x * 2^16))
//   out = q + sum_{j>i} m_ij[e] - sum_{j<i} m_ij[e]          (mod 2^32)
//
// with m_ij[e] = x0 ^ x1 of Threefry-2x32 (20 rounds) under the pair's key
// over the counter (hi(e), lo(e)) — jax.random.bits' partitionable draw of
// the leaf's flat iota.  The keys (S, S, 2) are the fold_in chains of
// parallel/secure.py (round key or X25519 pair seed, then the leaf index),
// symmetric in (i, j), derived on the host.
//
// What bounds it: integer operations.  A mask word is ~78 of them (20
// rotate-add-xor rounds, the key injections, the final xor), and each of
// the S(S-1)/2 pairs' masks is drawn once, added to slot i and subtracted
// from slot j — 120 pairs at config 4's 16 slots, so ~10^11 operations a
// round of 11.2 M parameters, against the 8 + 4 bytes an element a slot
// reads and writes.  The design:
//   * one thread per element (grid-stride), all of a leaf's slots in one
//     launch; the pair keys and each thread's S accumulators live in
//     shared memory ([slot][thread]: no bank conflicts), so any S fits;
//   * the rotate is one funnel shift (__funnelshift_l), the round one add,
//     one shift and one xor;
//   * the encode uses __fmul_rn (no contraction into a neighbouring op)
//     and __float2int_rn (round half to even, as jnp.round; roundf rounds
//     half away from zero);
//   * NaN becomes 0 and +-inf +-clip BEFORE the clip, which would carry a
//     NaN through (the reference's order).
//
// Plain C interface, loaded with ctypes (../build.py).  The entry returns
// cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kParity = 0x1BD11BDAu;
constexpr float kScale = 65536.0f;     // 2^16, _FRAC_BITS = 16

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

// jax's threefry2x32 of one counter pair; returns x0 ^ x1 (random.bits)
__device__ __forceinline__ unsigned threefry_bits(unsigned k0, unsigned k1,
                                                  unsigned hi,
                                                  unsigned lo) {
  const unsigned k2 = k0 ^ k1 ^ kParity;
  unsigned x0 = hi + k0;
  unsigned x1 = lo + k1;
#define BFLC_R(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
  BFLC_R(13) BFLC_R(15) BFLC_R(26) BFLC_R(6)
  x0 += k1; x1 += k2 + 1u;
  BFLC_R(17) BFLC_R(29) BFLC_R(16) BFLC_R(24)
  x0 += k2; x1 += k0 + 2u;
  BFLC_R(13) BFLC_R(15) BFLC_R(26) BFLC_R(6)
  x0 += k0; x1 += k1 + 3u;
  BFLC_R(17) BFLC_R(29) BFLC_R(16) BFLC_R(24)
  x0 += k1; x1 += k2 + 4u;
  BFLC_R(13) BFLC_R(15) BFLC_R(26) BFLC_R(6)
  x0 += k2; x1 += k0 + 5u;
#undef BFLC_R
  return x0 ^ x1;
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
secure_mask_kernel(const float* __restrict__ deltas,
                   const float* __restrict__ wn,
                   const unsigned* __restrict__ keys, int slots,
                   long long n, float clip, unsigned* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const int pairs = slots * (slots - 1) / 2;
  unsigned* pair_keys = smem;                        // [pairs][2]
  unsigned* acc = smem + 2 * pairs;                  // [slots][kThreads]
  const int tid = threadIdx.x;
  for (int p = tid, i = 0, j = 1; p < pairs; p += kThreads) {
    // pair p in (i, j) order, i < j, rows of the upper triangle
    int q = p;
    for (i = 0; q >= slots - 1 - i; ++i) q -= slots - 1 - i;
    j = i + 1 + q;
    pair_keys[2 * p] = keys[2 * (i * slots + j)];
    pair_keys[2 * p + 1] = keys[2 * (i * slots + j) + 1];
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + tid;
       e < n; e += stride) {
    for (int i = 0; i < slots; ++i)
      acc[i * kThreads + tid] =
          encode(deltas[i * n + e], wn[i], clip);
    const unsigned hi = static_cast<unsigned>(
        static_cast<unsigned long long>(e) >> 32);
    const unsigned lo = static_cast<unsigned>(e);
    int p = 0;
    for (int i = 0; i < slots; ++i) {
      unsigned mine = 0u;
      for (int j = i + 1; j < slots; ++j, ++p) {
        const unsigned m = threefry_bits(pair_keys[2 * p],
                                         pair_keys[2 * p + 1], hi, lo);
        mine += m;
        acc[j * kThreads + tid] -= m;
      }
      acc[i * kThreads + tid] += mine;
    }
    for (int i = 0; i < slots; ++i)
      out[i * n + e] = acc[i * kThreads + tid];
  }
}

}  // namespace

extern "C" {

// shared memory a launch needs for `slots` slots
long long bflc_secure_mask_smem(int slots) {
  return static_cast<long long>(sizeof(unsigned)) *
         (static_cast<long long>(slots) * (slots - 1) +
          static_cast<long long>(slots) * kThreads);
}

int bflc_secure_mask(const void* deltas, const void* wn, const void* keys,
                     int slots, long long n, float clip, void* out,
                     int blocks, void* stream) {
  const long long smem = bflc_secure_mask_smem(slots);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        secure_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 0 && slots > 0) {
    secure_mask_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(deltas), static_cast<const float*>(wn),
        static_cast<const unsigned*>(keys), slots, n, clip,
        static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
