// The certified weighted sum for Hopper (sm_90a): REDUCTION SPEC v2 steps
// 3-4, bit for bit the host leg's bytes.
//
// Replaces the XLA programs of bflc_demo_tpu/meshagg/engine.py —
//   certified_reduce_kernel <- MeshAggEngine._program (:260-304), the
//                              (N, P) terms + scan pair, and, launched once
//                              per spec-v2 block on an (N, Pb) slice,
//                              _blocked_program (:316-354)
// and computes what the spec's host leg computes
// (bflc_demo_tpu/meshagg/spec.py:host_weighted_sum; the plain PyTorch
// version is ../certified_reduce.py:certified_reduce_plain).  Per element p:
//
//   acc = +0.0
//   for i in 0 .. N-1, strictly in ascending slot order:
//       t   = gate_i ? daz(daz(d[i, p]) * daz(c_i)) : +0.0
//       acc = daz(acc + t)
//
// daz flushes a subnormal to the zero of its sign and keeps everything else.
//
// What makes the bytes the host's, and what the code does about each:
//   * no contraction: `acc + d*c` fused into an FMA rounds once where the
//     spec rounds twice.  The product and the sum are __fmul_rn and
//     __fadd_rn, which nvcc never contracts (and no --use_fast_math);
//   * subnormals: nvcc's default -ftz=false keeps gradual underflow, so
//     each product and sum is IEEE-rounded first and then flushed
//     explicitly, as numpy's `_daz` does (|x| >= FLT_MIN ? x : signed 0);
//   * NaN bytes: the host's x86 arithmetic returns an operand's NaN,
//     quieted (the second operand's when both are NaN, as numpy's vector
//     loops and torch do), and the "default NaN" 0xFFC00000 for an invalid
//     operation (inf + -inf, 0 * inf); the CUDA cores return the canonical
//     0x7FFFFFFF for both.  `host_nan` rewrites each result to the host's.
//     Unselected slots add a literal +0.0, so a NaN or inf there never
//     reaches the sum (and -0 + +0 normalises an FTZ -0 accumulator).
//
// What bounds it: bytes.  It reads N x P floats once and writes P, a few
// operations per element (N = 10, P = 535,298: 21 MB, 6.4 us at
// 3.35 TB/s).  One thread per element walks the N slots; neighbouring
// threads read neighbouring elements of a row, so every load of the slot
// loop is coalesced, and the loop is unrolled so several rows' loads are in
// flight at once.  The slots' coefficients and gates are staged into shared
// memory, 1024 slots at a time.  A row stride `ld` lets a block of
// columns of a resident (N, P) matrix run without a copy.
//
// Plain C interface, loaded with ctypes (../build.py).  The entry returns
// cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotTile = 1024;
constexpr unsigned kDefaultNaN = 0xFFC00000u;   // x86's "real indefinite"
constexpr unsigned kQuietBit = 0x00400000u;
constexpr unsigned kMinNormal = 0x00800000u;    // FLT_MIN = 2**-126

__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_uint(x) & 0x7FFFFFFFu) > 0x7F800000u;
}

__device__ __forceinline__ float quiet(float x) {
  return __uint_as_float(__float_as_uint(x) | kQuietBit);
}

// The host's result of `a op b` whose IEEE result on the card is r.
__device__ __forceinline__ float host_nan(float a, float b, float r) {
  if (is_nan(b)) return quiet(b);
  if (is_nan(a)) return quiet(a);
  if (is_nan(r)) return __uint_as_float(kDefaultNaN);
  return r;
}

// spec._daz: x * (|x| >= FLT_MIN), i.e. subnormal -> signed zero, NaN
// quieted (x * 0.0 on the host), everything else unchanged.
__device__ __forceinline__ float daz(float x) {
  if (is_nan(x)) return quiet(x);
  return fabsf(x) >= __uint_as_float(kMinNormal) ? x : copysignf(0.0f, x);
}

__global__ void __launch_bounds__(kThreads)
certified_reduce_kernel(const float* __restrict__ mat, long long ld, int n,
                        long long p, const float* __restrict__ coeffs,
                        const unsigned char* __restrict__ gates,
                        float* __restrict__ out) {
  __shared__ float s_coeff[kSlotTile];
  __shared__ unsigned char s_gate[kSlotTile];
  const long long col = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const bool live = col < p;
  float acc = 0.0f;
  for (int base = 0; base < n; base += kSlotTile) {
    const int tile = n - base < kSlotTile ? n - base : kSlotTile;
    __syncthreads();            // the previous tile is no longer read
    for (int s = threadIdx.x; s < tile; s += kThreads) {
      s_coeff[s] = daz(coeffs[base + s]);
      s_gate[s] = gates[base + s];
    }
    __syncthreads();
    if (!live) continue;
    const float* row = mat + static_cast<long long>(base) * ld + col;
#pragma unroll 8
    for (int s = 0; s < tile; ++s) {
      const float d = __ldg(row + static_cast<long long>(s) * ld);
      float t = 0.0f;
      if (s_gate[s]) {
        const float dd = daz(d);
        const float c = s_coeff[s];
        t = daz(host_nan(dd, c, __fmul_rn(dd, c)));
      }
      acc = daz(host_nan(acc, t, __fadd_rn(acc, t)));
    }
  }
  if (live) out[col] = acc;
}

}  // namespace

extern "C" {

// mat: (n, p) float32 with row stride ld (elements); coeffs: (n,) float32;
// gates: (n,) uint8 (nonzero = selected); out: (p,) float32.
int bflc_certified_reduce(const void* mat, long long ld, int n, long long p,
                          const void* coeffs, const void* gates, void* out,
                          void* stream) {
  if (p > 0) {
    const long long blocks = (p + kThreads - 1) / kThreads;
    certified_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mat), ld, n, p,
        static_cast<const float*>(coeffs),
        static_cast<const unsigned char*>(gates), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
