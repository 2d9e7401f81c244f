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
// What bounds it.  The bytes: N x P floats read once, P written (config
// 5's merge, N = 10, P = 535,298: 21 MB, 6.4 us at 3.35 TB/s).  And the
// chain: each element's N adds are in the spec's order, so a column costs
// N dependent float adds whatever the schedule (the benchmark's drain,
// N = 1024, P = 9,600: only 9,600 chains on 132 SMs).  The design keeps
// the memory pipe full while the chains walk, and keeps the chain short:
//   * the terms t_i do not depend on the accumulator, so they are made
//     off the dependent path.  A coefficient table (flushed coefficient
//     and gate of 1024 slots) sits in shared memory.  A delta and a
//     coefficient that are both zero or within [2^-50, 2^51) ("ordinary")
//     make the spec's term by a plain __fmul_rn, and sums of such terms
//     are never subnormal, so the walk is one __fadd_rn a slot and
//     nothing else.  Any other term takes the spec's rules (`term`) and
//     marks its tile, which then walks again from its starting value
//     with `exact_add`; so does a tile whose sum ends NaN.  Either is
//     rare, and every byte is the host's;
//   * wide matrices with few slots (the writer merges): `column_kernel`,
//     one thread a column, issues 8 slots' loads together before it adds
//     them — 8 loads in flight a thread, no staging, any alignment;
//   * narrow matrices (the drains, P = 9,600, and their blocks): too few
//     columns to fill the card a thread each, so a CTA of 256 threads
//     owns a strip of W = 8-32 columns (the wrapper picks W from P) and
//     streams its (N, W) strip through shared memory in tiles of 2048 / W
//     slots, 4 stages deep by `cp.async` (4-byte copies for any
//     alignment, 16-byte where base and row stride allow); all 256
//     threads make each landed tile's terms in place, four columns at a
//     time, and W threads walk the columns.
// `certified_chain_kernel` times one slot of the walk (one thread), the
// floor under every column.
//
// Plain C interface, loaded with ctypes (../build.py).  Each entry returns
// cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 2048;               // one stage, 8 KB
constexpr int kStages = 4;
constexpr int kSlotTile = 1024;                 // slots a coefficient table
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

// The spec's term of a selected slot; c is already flushed.
__device__ __forceinline__ float term(float d, float c) {
  const float dd = daz(d);
  return daz(host_nan(dd, c, __fmul_rn(dd, c)));
}

// The spec's accumulate step with all its rules.
__device__ __forceinline__ float exact_add(float acc, float t) {
  return daz(host_nan(acc, t, __fadd_rn(acc, t)));
}

// Asynchronous copies global -> shared; `bytes` below the copy size
// zero-fills the rest (0 reads nothing; src must still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A delta or coefficient is "ordinary" when it is zero or its magnitude
// lies in [2^-50, 2^51).  The product of two ordinary numbers is then
// exact as IEEE gives it — no NaN, no subnormal, zero or |t| >= 2^-100 —
// and a sum of such terms is never subnormal (a nonzero sum below
// FLT_MIN needs an operand below 2^-102), so for them the spec's steps
// are the plain __fmul_rn and __fadd_rn.  The test reads the exponent of
// 2|x| (the sign shifted out).
constexpr unsigned kOrdinaryLow = 77u << 24;     // 2^-50's biased exponent
constexpr unsigned kOrdinarySpan = 101u << 24;   // up to 2^51

__device__ __forceinline__ bool ordinary(float x) {
  const unsigned u = __float_as_uint(x) << 1;
  return u == 0u || u - kOrdinaryLow < kOrdinarySpan;
}

// A slot's mode in the coefficient table: not selected (its term is the
// literal +0), selected with an ordinary coefficient, or selected with
// any other (every term then takes the spec's rules).
constexpr unsigned char kOff = 0, kOrdinary = 1, kSpecial = 2;

// The table of slots [base, base + kSlotTile): flushed coefficients and
// modes, every load issued before the first store.
__device__ __forceinline__ void load_table(
    float* s_coef, unsigned char* s_mode, const float* __restrict__ coeffs,
    const unsigned char* __restrict__ gates, int base, int n) {
  constexpr int kPer = kSlotTile / kThreads;
  float c[kPer];
  unsigned char g[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int slot = base + threadIdx.x + j * kThreads;
    c[j] = slot < n ? __ldg(coeffs + slot) : 0.0f;
    g[j] = slot < n ? __ldg(gates + slot) : 0;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = threadIdx.x + j * kThreads;
    s_coef[s] = daz(c[j]);
    s_mode[s] = !g[j] ? kOff : ordinary(daz(c[j])) ? kOrdinary : kSpecial;
  }
}

// The term of delta d in a slot of mode `mode` and flushed coefficient c;
// `special` is set where the spec's rules had to run.
__device__ __forceinline__ float slot_term(float d, float c,
                                           unsigned char mode,
                                           bool& special) {
  if (mode == kOff) return 0.0f;
  if (mode == kOrdinary && ordinary(d)) return __fmul_rn(d, c);
  special = true;
  return term(d, c);
}

// rows terms at col[0], col[kW], ... added to acc in order: eight loaded
// ahead, then one __fadd_rn a slot on the dependent path.
template <int kW>
__device__ __forceinline__ float walk(float acc, const float* col,
                                      int rows) {
  int s = 0;
  for (; s + 8 <= rows; s += 8) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = col[(s + j) * kW];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, t[j]);
  }
  for (; s < rows; ++s) acc = __fadd_rn(acc, col[s * kW]);
  return acc;
}

// Narrow matrices: kW (8-32) columns a CTA; kVec floats a copy (1: any
// alignment; 4: the base is 16-byte aligned and the row stride a
// multiple of 4 floats).
template <int kW, int kVec>
__global__ void __launch_bounds__(kThreads)
certified_reduce_kernel(const float* __restrict__ mat, long long ld, int n,
                        long long p, const float* __restrict__ coeffs,
                        const unsigned char* __restrict__ gates,
                        float* __restrict__ out) {
  constexpr int kRows = kTileFloats / kW;        // slots a stage
  constexpr int kPer = kTileFloats / kThreads;   // floats a thread a stage
  constexpr int kTilesPerTable = kSlotTile / kRows;
  __shared__ __align__(16) float smem[kStages * kTileFloats];
  __shared__ float s_coef[kSlotTile];
  __shared__ unsigned char s_mode[kSlotTile];
  const int tid = threadIdx.x;
  const long long col0 = static_cast<long long>(blockIdx.x) * kW;
  const int ntiles = (n + kRows - 1) / kRows;

  // tile k's copies into stage k % kStages: float idx of the stage is
  // slot base + idx / kW, column col0 + idx % kW
  auto issue = [&](int k) {
    float* buf = smem + (k % kStages) * kTileFloats;
    const int base = k * kRows;
#pragma unroll
    for (int j = 0; j < kPer / kVec; ++j) {
      const int idx = (tid + j * kThreads) * kVec;
      const int slot = base + idx / kW;
      const long long col = col0 + idx % kW;
      if (slot >= n) continue;
      const long long left = p - col;
      const int bytes = left >= kVec ? 4 * kVec
                        : left > 0   ? 4 * static_cast<int>(left) : 0;
      const float* src = bytes ? mat + static_cast<long long>(slot) * ld + col
                               : mat;
      if constexpr (kVec == 4) cp_async16(buf + idx, src, bytes);
      else cp_async4(buf + idx, src, bytes);
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < ntiles) issue(k);
    cp_async_commit();
  }
  load_table(s_coef, s_mode, coeffs, gates, 0, n);   // copies in flight
  float acc = 0.0f;
  for (int k = 0; k < ntiles; ++k) {
    const int base = k * kRows;
    if (k > 0 && k % kTilesPerTable == 0) {   // the next 1024 slots
      __syncthreads();
      load_table(s_coef, s_mode, coeffs, gates, base, n);
    }
    cp_async_wait<kStages - 2>();     // this thread's copies of tile k
    // every copy of tile k and the table landed, and the walk is done
    // with tile k - 1, whose stage the next issue refills
    __syncthreads();
    if (k + kStages - 1 < ntiles) issue(k + kStages - 1);
    cp_async_commit();
    float* buf = smem + (k % kStages) * kTileFloats;
    const int rows = min(kRows, n - base);
    // the terms in place, four columns of one slot a thread at a time,
    // off the dependent path
    bool special = false;
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      const int idx = (tid + j * kThreads) * 4;
      const int s = idx / kW;
      if (s < rows) {
        const int slot = (base + s) % kSlotTile;
        const float c = s_coef[slot];
        const unsigned char mode = s_mode[slot];
        float4 v = *reinterpret_cast<float4*>(buf + idx);
        v.x = slot_term(v.x, c, mode, special);
        v.y = slot_term(v.y, c, mode, special);
        v.z = slot_term(v.z, c, mode, special);
        v.w = slot_term(v.w, c, mode, special);
        *reinterpret_cast<float4*>(buf + idx) = v;
      }
    }
    // a tile with a special term walks with the spec's full rules
    special = __syncthreads_or(special);
    if (tid < kW) {
      const float* col = buf + tid;
      const float start = acc;
      acc = walk<kW>(acc, col, rows);
      if (special || is_nan(acc)) {
        acc = start;
        for (int s = 0; s < rows; ++s) acc = exact_add(acc, col[s * kW]);
      }
    }
  }
  cp_async_wait<0>();
  if (tid < kW && col0 + tid < p) out[col0 + tid] = acc;
}

// Wide matrices with few slots (the writer merges): one thread a column
// walks the slots in batches of 8, all of a batch's loads issued before
// its first add, so every thread keeps 8 loads in flight with no staging
// (any alignment and row stride; neighbouring threads read neighbouring
// floats of a row).  A batch's terms stay in registers for the rare walk
// with the spec's full rules.
__global__ void __launch_bounds__(kThreads)
column_kernel(const float* __restrict__ mat, long long ld, int n,
              long long p, const float* __restrict__ coeffs,
              const unsigned char* __restrict__ gates,
              float* __restrict__ out) {
  __shared__ float s_coef[kSlotTile];
  __shared__ unsigned char s_mode[kSlotTile];
  const long long col = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const bool live = col < p;
  const float* src = mat + (live ? col : 0);
  float acc = 0.0f;
  for (int base = 0; base < n; base += kSlotTile) {
    if (base > 0) __syncthreads();     // the previous table is read
    load_table(s_coef, s_mode, coeffs, gates, base, n);
    __syncthreads();
    const int tile = min(kSlotTile, n - base);
    if (!live) continue;
    for (int s = 0; s < tile; s += 8) {
      const int m = min(8, tile - s);
      float t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t[j] = j < m ? __ldg(src + static_cast<long long>(base + s + j) * ld)
                     : 0.0f;
      bool special = false;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < m) t[j] = slot_term(t[j], s_coef[s + j], s_mode[s + j],
                                    special);
      const float start = acc;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < m) acc = __fadd_rn(acc, t[j]);
      if (special || is_nan(acc)) {
        acc = start;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < m) acc = exact_add(acc, t[j]);
      }
    }
  }
  if (live) out[col] = acc;
}

// One thread walks `steps` slots (a multiple of 64) of the common-path
// chain with the kernel's own `walk` over a 64-slot column of terms in
// shared memory: the latency of one slot.
__global__ void certified_chain_kernel(long long steps, float* out,
                                       long long* cycles) {
  __shared__ float terms[64];
  for (int i = 0; i < 64; ++i) terms[i] = (i & 1) ? -0.75f : 0.75f;
  float acc = 0.0f;
  const long long t0 = clock64();
  for (long long i = 0; i < steps; i += 64) acc = walk<1>(acc, terms, 64);
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}

template <int kW>
void launch_strip(const float* mat, long long ld, int n, long long p,
                  const float* coeffs, const unsigned char* gates,
                  float* out, int vec, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((p + kW - 1) / kW);
  if (vec == 4)
    certified_reduce_kernel<kW, 4><<<blocks, kThreads, 0, stream>>>(
        mat, ld, n, p, coeffs, gates, out);
  else
    certified_reduce_kernel<kW, 1><<<blocks, kThreads, 0, stream>>>(
        mat, ld, n, p, coeffs, gates, out);
}

}  // namespace

extern "C" {

// mat: (n, p) float32 with row stride ld (elements); coeffs: (n,) float32;
// gates: (n,) uint8 (nonzero = selected); out: (p,) float32.
// cols: columns a CTA (8, 16 or 32; 0 = the column kernel);
// vec: floats a copy (1, or 4 where mat is 16-byte aligned and ld % 4 == 0).
int bflc_certified_reduce(const void* mat, long long ld, int n, long long p,
                          const void* coeffs, const void* gates, void* out,
                          int cols, int vec, void* stream) {
  const auto* m = static_cast<const float*>(mat);
  const auto* c = static_cast<const float*>(coeffs);
  const auto* g = static_cast<const unsigned char*>(gates);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (p <= 0) return static_cast<int>(cudaGetLastError());
  switch (cols) {
    case 0:
      column_kernel<<<static_cast<unsigned>((p + kThreads - 1) / kThreads),
                      kThreads, 0, s>>>(m, ld, n, p, c, g, o);
      break;
    case 8: launch_strip<8>(m, ld, n, p, c, g, o, vec, s); break;
    case 16: launch_strip<16>(m, ld, n, p, c, g, o, vec, s); break;
    case 32: launch_strip<32>(m, ld, n, p, c, g, o, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int bflc_certified_chain(long long steps, void* out, void* cycles,
                         void* stream) {
  certified_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<float*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
