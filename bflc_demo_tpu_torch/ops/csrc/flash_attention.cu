// Masked flash attention for Hopper (sm_90a): forward, dK/dV, dQ and the
// ring-attention carry step.
//
// Replaces the four Pallas TPU kernels of
// bflc_demo_tpu/ops/pallas_attention.py —
//   flash_fwd_kernel<.., false> <- _flash_kernel (:42-102), launched at :124
//   flash_dkdv_kernel           <- _dkdv_kernel  (:153-193), launched at :257
//   flash_dq_kernel             <- _dq_kernel    (:196-224), launched at :286
//   flash_fwd_kernel<.., true>  <- _flash_carry_kernel (:300-340), launched
//                                  by flash_attention_carry at :369
// and computes what they compute (see the plain PyTorch versions in
// ../flash_attention.py), not their block-by-block schedule: a Pallas grid
// carries scratch state across its sequential innermost axis, CUDA blocks
// run in no order and share nothing, so each block owns one
// (batch*head, row tile) output and loops over the streamed axis itself:
//   forward: one block per (b*h, 16-64 query rows), looping over k-tiles;
//   dK/dV:   one block per (b*h, 64-key tile), looping over q-tiles;
//   dQ:      one block per (b*h, 64-query tile), looping over k-tiles.
//
// The carry step (one ring hop of sequence-parallel attention) is the
// forward with its init and finish replaced by a load and a store of the
// f32 streaming state (acc (B*H, S_q, D), m and l (B*H, 1, S_q)), stored
// unnormalised; the caller divides acc by max(l, 1e-30) after the last hop.
//
// ---- The forward body (K1 and K4): tensor cores, S and P in registers.
// At the ring's shard (folded batch 32, S_q = S_kv = 1024, 4 heads, head
// dim 32, f32) one hop moves ~86 MB (~26 us at 3.35 TB/s) for ~12.5 GFLOP
// of products over the valid keys: operations bound it, not bytes.  The
// first body ran them on the CUDA cores with both operands of every FMA
// read from shared memory, which capped it near 1/8 of the f32 FMA rate.
// This body runs both products on the tensor cores with `mma.sync`:
//   * each warp owns 16 query rows; its Q fragments are loaded once and
//     stay in registers for the whole key loop;
//   * S = Q K^T lands in the mma accumulators; row max and row sum are
//     two xor-shuffles inside each quad of lanes; the probabilities are
//     the A operand of the P V mma as they stand in registers (for f32 the
//     key order inside each 8-key step is permuted — k-index t stands for
//     key 2t, t + 4 for key 2t + 1 — so the accumulator layout IS the A
//     fragment layout; V's B fragment reads the same keys), so P never
//     goes through shared memory;
//   * K, V and the key mask of tile j + 1 arrive by 16-byte cp.async into
//     a two-stage ring in shared memory while tile j is multiplied; rows
//     are padded (4 words for f32, 8 halves for bf16) so every fragment
//     load of a warp hits 32 distinct banks;
//   * the wrapper picks 1, 2 or 4 warps a block from the shape
//     (flash_attention.py:fwd_warps), so a small batch still gives every
//     SM a block and a long sequence lets four warps share each K/V tile.
// f32 inputs run 3xTF32: x = hi + lo with hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi), and each product is hi.lo + lo.hi + hi.hi
// accumulated in f32 (the lo.lo term is below 2^-22 relative).  Its error
// is about 2^-21 relative per product, at f32's level.  TF32 alone keeps
// 11 significant bits (~2^-11 relative, ~5e-4): that is what the port's
// f32 tolerances must not hide, which is why the device module turns
// PyTorch's TF32 off, and why this body splits every f32 operand.  The
// split costs three mma per product, so the f32 bound of this route is
// 495 / 3 = 165 TFLOP/s, above the CUDA cores' 67.  bf16 inputs run one
// m16n8k16 bf16 mma per product with f32 accumulation; p is rounded to
// bf16 on its way into the P V mma, where the reference's `.astype`
// rounds it.  p = exp(s - m) runs on the SFU's ex2 (2^(x log2 e), a few
// f32 ulps, and on an H100 an eighth faster a carry step than the
// accurate expf); the rescale exp(m - m_new) stays expf.
// What bounds the body now: not shared memory and not the tensor cores'
// rate (about a quarter of the mma.sync time is used) but the latency of
// each warp's dependent chain per tile — S mma, quad max, exponentials,
// quad sum, P V mma — with the ALU work of the splits beside it, and a
// block barrier twice a tile.  Later work: wgmma with operands in shared
// memory, TMA loads with mbarriers and a producer warp, and the same
// redesign for the dK/dV and dQ kernels below, which still run the first
// design.
//
// ---- dK/dV and dQ: the first design.  At the transformer's shapes
// (S = 64, head dim 32) one training backward moves ~2 MB in f32 for a
// few MFLOP, so launch latency and bytes bound them, not FLOPs.  q/k/v/dO
// are read once from their (B, S, H, D) layout through strides, staged
// as f32 tiles in shared memory (rows padded by one word, so the
// row-strided reads are free of bank conflicts), and every product
// accumulates in f32 on the CUDA cores.  Tile geometry: 64 x 64, 256
// threads; the four threads of one tile row are adjacent lanes of one
// warp, so row reductions are two xor-shuffles and a row's values are
// shared through shared memory with __syncwarp only.
//
// Numerics follow the reference exactly where it is explicit:
//   * logits = (q . k) * scale in f32; masked logits are -1e30;
//   * probabilities of masked keys are SELECTED to 0, never multiplied by
//     the mask — on a fully masked row lse sits near -1e30 and
//     exp(s - lse) overflows to inf, and inf * 0 is NaN (the guards at
//     pallas_attention.py:86, :182, :216); a fully masked tile or hop
//     leaves m at -1e30, and a later real one rescales through corr = 0;
//   * p (and dS) are rounded to the storage dtype before the products
//     that consume them, as the reference's `.astype(v.dtype)` does;
//   * out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
// Ragged sequence ends are masked in-kernel.  The block sizes of the
// reference API only have to divide the sequence (the wrapper checks
// that); they do not change the function, so the kernels keep their own
// tiles.
//
// Plain C ABI (loaded with ctypes).  Every entry returns cudaGetLastError()
// after its launch, so a refused launch surfaces in the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;                  // q rows and k rows per tile
constexpr int kThreads = 256;
constexpr int kLanes = 4;                  // threads sharing one tile row
constexpr int kPer = kTile / kLanes;       // columns per thread
constexpr int kPT = kTile + 1;             // padded row of a (tile x tile)
constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round through the storage dtype (the reference's `.astype(dtype)`)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// element (b, s, h, d) of a contiguous (B, S, H, D) tensor
template <int D>
__device__ __forceinline__ size_t at(int b, int s, int h, int S, int H) {
  return ((static_cast<size_t>(b) * S + s) * H + h) * D;
}

// rows [row0, row0 + kTile) of head h of batch b -> f32 tile, stride D+1;
// rows past the sequence end read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int h, int row0, int S, int H) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D, s = row0 + r;
    dst[r * (D + 1) + d] = s < S ? to_f32(src[at<D>(b, s, h, S, H) + d]) : 0.f;
  }
}

// key validity for keys [k0, k0 + kTile): the (B, S_kv) bool mask is set and
// the key lies inside the sequence
__device__ __forceinline__ void load_mask(int* dst, const bool* mask, int b,
                                          int k0, int Skv) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int s = k0 + i;
    dst[i] = s < Skv && mask[static_cast<size_t>(b) * Skv + s];
  }
}

// per-row f32 statistics (lse or delta) of rows [q0, q0 + kTile)
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int bh, int q0, int Sq) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int s = q0 + i;
    dst[i] = s < Sq ? src[static_cast<size_t>(bh) * Sq + s] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) acc += a[d] * b[d];
  return acc;
}

// max / sum over the four adjacent lanes of a quad (one row)
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------- tensor-core primitives
// 16-byte asynchronous copy global -> shared; zero-fills when !in (src must
// still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both exact in tf32, to ~2^-22 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c (16x8 f32) += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, the lower k index in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// exp(x) as 2^(x log2 e) on the SFU's ex2 (a few float32 ulps; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------- forward
constexpr int kRows = 16;                  // query rows per warp (mma M)
constexpr int kKeys = 64;                  // keys per staged K/V tile
constexpr int kKeyTiles = kKeys / 8;       // 8-key column tiles of S
constexpr int kMaxWarps = 4;

// Shared memory of the forward: two stages of (K tile, V tile, key mask).
// Rows are padded so that a warp's fragment loads hit 32 distinct banks:
// f32 rows D + 4 words (stride = 4 mod 32 words), bf16 rows D + 8 halves.
template <typename T, int D>
struct FwdSmem {
  static constexpr int kStride = D + (std::is_same<T, float>::value ? 4 : 8);
  static constexpr size_t kTileBytes = sizeof(T) * kKeys * kStride;
  static constexpr size_t kStageBytes = 2 * kTileBytes + kKeys;
  static constexpr size_t kBytes = 2 * kStageBytes;
};

// Start the copies of keys [k0, k0 + kKeys) of head h of batch b into one
// stage: rows past the sequence end are zero-filled and their keys marked
// invalid.  The mask row comes by cp.async where it is whole and aligned
// (every tile of the main paths), else by plain loads (ragged lengths; made
// visible by the same barrier).  Plain loads throughout took K1 at config
// 5's training shape, one-warp blocks, from 6.62-6.63 to 6.85-6.95 us, and
// left K4 at the sp shard unchanged (chip_smoke.py's timing phases, H100
// 80GB HBM3 at 700 W).
template <typename T, int D>
__device__ __forceinline__ void stage_kv(unsigned char* stage, const T* k,
                                         const T* v, const bool* mask, int b,
                                         int h, int k0, int Skv, int H) {
  using L = FwdSmem<T, D>;
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte copy
  constexpr int kChunks = D / kVec;        // copies per row
  T* ks = reinterpret_cast<T*>(stage);
  T* vs = reinterpret_cast<T*>(stage + L::kTileBytes);
  unsigned char* valid = stage + 2 * L::kTileBytes;
  for (int i = threadIdx.x; i < kKeys * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * kVec, s = k0 + r;
    const bool in = s < Skv;
    const size_t src = in ? at<D>(b, s, h, Skv, H) + c : 0;
    cp_async16(ks + r * L::kStride + c, k + src, in);
    cp_async16(vs + r * L::kStride + c, v + src, in);
  }
  const bool* row = mask + static_cast<size_t>(b) * Skv + k0;
  if (k0 + kKeys <= Skv && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    for (int i = threadIdx.x; i < kKeys / 16; i += blockDim.x)
      cp_async16(valid + 16 * i, row + 16 * i, true);
  } else {
    for (int i = threadIdx.x; i < kKeys; i += blockDim.x)
      valid[i] = k0 + i < Skv && row[i];
  }
}

// One warp's products on the tensor cores.  Fragment coordinates: lane =
// 4 g + t; the accumulator of an 8-column tile holds rows g (elements 0,
// 1) and g + 8 (elements 2, 3) at columns 2t and 2t + 1.
template <typename T, int D>
struct WarpMma;

// f32: 3xTF32 m16n8k8.  Q is split once; K, V and P at their use.
template <int D>
struct WarpMma<float, D> {
  static constexpr int kSteps = D / 8;     // mma depth 8 over the head dim
  static constexpr int P = FwdSmem<float, D>::kStride;
  uint32_t qh[kSteps][4], ql[kSteps][4];

  // A fragment of step kk: (g, 8kk + t), (g + 8, ..), (g, 8kk + t + 4),
  // (g + 8, ..); q0 / q8 point at rows g / g + 8, null past the end
  __device__ __forceinline__ void load_q(const float* q0, const float* q8,
                                         int t) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int d = 8 * kk + t;
      split_tf32(q0 ? q0[d] : 0.f, qh[kk][0], ql[kk][0]);
      split_tf32(q8 ? q8[d] : 0.f, qh[kk][1], ql[kk][1]);
      split_tf32(q0 ? q0[d + 4] : 0.f, qh[kk][2], ql[kk][2]);
      split_tf32(q8 ? q8[d + 4] : 0.f, qh[kk][3], ql[kk][3]);
    }
  }

  // s[n] = Q K^T over keys 8n .. 8n + 7 of the staged tile; B fragment
  // (k = d, n = key): (8kk + t, g) and (8kk + t + 4, g)
  __device__ __forceinline__ void logits(float (&s)[kKeyTiles][4],
                                         const float* ks, int g,
                                         int t) const {
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t bh[kKeyTiles][2], bl[kKeyTiles][2];
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        const float* kr = ks + (8 * n + g) * P + 8 * kk + t;
        split_tf32(kr[0], bh[n][0], bl[n][0]);
        split_tf32(kr[4], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
        mma_tf32(s[n], qh[kk], bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
        mma_tf32(s[n], ql[kk], bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
        mma_tf32(s[n], qh[kk], bh[n][0], bh[n][1]);
    }
  }

  // acc[n] += P V over the tile's keys, output columns 8n .. 8n + 7.  In
  // step j (keys 8j .. 8j + 7) k-index t stands for key 2t and t + 4 for
  // key 2t + 1, so p[j] is the A fragment as it stands: (g, 2t) = p[j][0],
  // (g + 8, 2t) = p[j][2], (g, 2t + 1) = p[j][1], (g + 8, 2t + 1) = p[j][3];
  // V's B fragment reads keys 8j + 2t and 8j + 2t + 1 at column 8n + g
  __device__ __forceinline__ void pv(float (&acc)[D / 8][4],
                                     const float (&p)[kKeyTiles][4],
                                     const float* vs, int g, int t) const {
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(p[j][0], ah[0], al[0]);
      split_tf32(p[j][2], ah[1], al[1]);
      split_tf32(p[j][1], ah[2], al[2]);
      split_tf32(p[j][3], ah[3], al[3]);
      const float* vr = vs + (8 * j + 2 * t) * P + g;
      uint32_t bh[D / 8][2], bl[D / 8][2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        split_tf32(vr[8 * n], bh[n][0], bl[n][0]);
        split_tf32(vr[P + 8 * n], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
    }
  }
};

// bf16: one m16n8k16 per product; p is rounded to bf16 on the way in
template <int D>
struct WarpMma<__nv_bfloat16, D> {
  static constexpr int kSteps = D / 16;    // mma depth 16 over the head dim
  static constexpr int P = FwdSmem<__nv_bfloat16, D>::kStride;
  uint32_t qa[kSteps][4];

  // A fragment of step kk: pairs (g, 16kk + 2t), (g + 8, ..),
  // (g, 16kk + 2t + 8), (g + 8, ..)
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q0,
                                         const __nv_bfloat16* q8, int t) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int d = 16 * kk + 2 * t;
      qa[kk][0] = q0 ? ld32(q0 + d) : 0u;
      qa[kk][1] = q8 ? ld32(q8 + d) : 0u;
      qa[kk][2] = q0 ? ld32(q0 + d + 8) : 0u;
      qa[kk][3] = q8 ? ld32(q8 + d + 8) : 0u;
    }
  }

  // B fragment (k = d, n = key): pairs (16kk + 2t, g), (16kk + 2t + 8, g)
  __device__ __forceinline__ void logits(float (&s)[kKeyTiles][4],
                                         const __nv_bfloat16* ks, int g,
                                         int t) const {
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        const __nv_bfloat16* kr = ks + (8 * n + g) * P + 16 * kk + 2 * t;
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
  }

  // step j covers keys 16j .. 16j + 15: the accumulators of key tiles 2j
  // and 2j + 1 are its A fragment; V's B fragment holds the pairs
  // (16j + 2t, 8n + g) and (16j + 2t + 8, 8n + g)
  __device__ __forceinline__ void pv(float (&acc)[D / 8][4],
                                     const float (&p)[kKeyTiles][4],
                                     const __nv_bfloat16* vs, int g,
                                     int t) const {
#pragma unroll
    for (int j = 0; j < kKeyTiles / 2; ++j) {
      const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                             pack_bf16(p[2 * j][2], p[2 * j][3]),
                             pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                             pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
      const __nv_bfloat16* vr = vs + (16 * j + 2 * t) * P + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* c = vr + 8 * n;
        mma_bf16(acc[n], a, pack_bf16(c[0], c[P]),
                 pack_bf16(c[8 * P], c[9 * P]));
      }
    }
  }
};

// The ring-attention carry, (acc, m, l) per (b*h, q row), in and out; the
// plain forward leaves it null.
struct Carry {
  const float* acc_in;
  const float* m_in;
  const float* l_in;
  float* acc_out;
  float* m_out;
  float* l_out;
};

// kCarry = false: the forward, from m = -1e30, l = 0, acc = 0 to
// out = acc / max(l, 1e-30) and lse.  kCarry = true: the carry step, from
// the carry in to the carry out, unnormalised; out and lse are unused.
// Block: blockDim.x / 32 warps of 16 query rows each; grid (B*H, row tiles).
template <typename T, int D, bool kCarry>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const bool* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, Carry carry,
                 int Sq, int Skv, int H, float scale) {
  using L = FwdSmem<T, D>;
  constexpr int kCols = D / 8;             // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char fwd_smem[];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (blockIdx.y * (blockDim.x / 32) + warp) * kRows;
  const int rows[2] = {r0 + g, r0 + g + 8};   // this thread's query rows
  const int n_tiles = (Skv + kKeys - 1) / kKeys;

  // tile 0 is in flight while Q and the carry are read
  stage_kv<T, D>(fwd_smem, k, v, mask, b, h, 0, Skv, H);
  cp_async_commit();

  WarpMma<T, D> mma;
  mma.load_q(rows[0] < Sq ? q + at<D>(b, rows[0], h, Sq, H) : nullptr,
             rows[1] < Sq ? q + at<D>(b, rows[1], h, Sq, H) : nullptr, t);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kCols][4];
#pragma unroll
  for (int n = 0; n < kCols; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if constexpr (kCarry) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= Sq) continue;
      const size_t row = static_cast<size_t>(bh) * Sq + rows[i];
      m[i] = carry.m_in[row];
      l[i] = carry.l_in[row];
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        const float2 a = *reinterpret_cast<const float2*>(
            carry.acc_in + row * D + 8 * n + 2 * t);
        acc[n][2 * i] = a.x;
        acc[n][2 * i + 1] = a.y;
      }
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles)
      stage_kv<T, D>(fwd_smem + ((j + 1) & 1) * L::kStageBytes, k, v, mask,
                     b, h, (j + 1) * kKeys, Skv, H);
    cp_async_commit();                     // empty on the last tile
    cp_async_wait<1>();                    // this thread's copies of tile j
    __syncthreads();                       // ... and every thread's
    const unsigned char* stage = fwd_smem + (j & 1) * L::kStageBytes;
    const T* ks = reinterpret_cast<const T*>(stage);
    const T* vs = reinterpret_cast<const T*>(stage + L::kTileBytes);
    const unsigned char* valid = stage + 2 * L::kTileBytes;

    float s[kKeyTiles][4];
    mma.logits(s, ks, g, t);
    bool ok[kKeyTiles][2];
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      ok[n][0] = valid[8 * n + 2 * t];
      ok[n][1] = valid[8 * n + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ok[n][e & 1] ? s[n][e] * scale : kNegInf;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[n][e]);
      }
    }
    float corr[2], p_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], row_max(tile_max[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ok[n][e & 1] ? fast_exp(s[n][e] - m[e >> 1]) : 0.f;
        p_sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + row_sum(p_sum[i]);
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }
    mma.pv(acc, s, vs, g, t);
    __syncthreads();                       // tile j read: its stage refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Sq) continue;
    const size_t row = static_cast<size_t>(bh) * Sq + rows[i];
    if constexpr (kCarry) {
#pragma unroll
      for (int n = 0; n < kCols; ++n)
        store2(carry.acc_out + row * D + 8 * n + 2 * t, acc[n][2 * i],
               acc[n][2 * i + 1]);
      if (t == 0) {
        carry.m_out[row] = m[i];
        carry.l_out[row] = l[i];
      }
    } else {
      const float denom = fmaxf(l[i], kTiny);
      T* o = out + at<D>(b, rows[i], h, Sq, H) + 2 * t;
#pragma unroll
      for (int n = 0; n < kCols; ++n)
        store2(o + 8 * n, acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
      if (t == 0) lse[row] = m[i] + logf(denom);
    }
  }
}

// ------------------------------------------------------------------ dK/dV
// One block per (b*h, k-tile); thread (c, lane) owns key row c of the tile
// and output columns lane, lane+4, ...; q-tiles stream through.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const bool* __restrict__ mask,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Sq, int Skv, int H, float scale) {
  constexpr int P = D + 1;
  constexpr int kCols = D / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * P;
  float* qs = vs + kTile * P;
  float* dos = qs + kTile * P;
  float* pt = dos + kTile * P;             // (k col, q row), stride kPT
  float* dst = pt + kTile * kPT;           // (k col, q row), stride kPT
  float* lse_s = dst + kTile * kPT;
  float* delta_s = lse_s + kTile;
  int* valid = reinterpret_cast<int*>(delta_s + kTile);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;

  load_tile<T, D>(ks, k, b, h, k0, Skv, H);
  load_tile<T, D>(vs, v, b, h, k0, Skv, H);
  load_mask(valid, mask, b, k0, Skv);
  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kTile) {
    __syncthreads();
    load_tile<T, D>(qs, q, b, h, q0, Sq, H);
    load_tile<T, D>(dos, dout, b, h, q0, Sq, H);
    load_rows(lse_s, lse, bh, q0, Sq);
    load_rows(delta_s, delta, bh, q0, Sq);
    __syncthreads();

    const bool key_ok = valid[c];
#pragma unroll 4
    for (int j = 0; j < kPer; ++j) {
      const int rq = lane + kLanes * j;
      const bool ok = key_ok && q0 + rq < Sq;
      const float s = dot_rows<D>(qs + rq * P, ks + c * P) * scale;
      const float p = ok ? expf(s - lse_s[rq]) : 0.f;
      const float dp = dot_rows<D>(dos + rq * P, vs + c * P);
      const float ds = p * (dp - delta_s[rq]) * scale;
      pt[c * kPT + rq] = round_to<T>(p);
      dst[c * kPT + rq] = round_to<T>(ds);
    }
    __syncwarp();                          // key row c, written by 4 lanes
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = lane + kLanes * j;
      float accv = 0.f, acck = 0.f;
#pragma unroll 8
      for (int rq = 0; rq < kTile; ++rq) {
        accv += pt[c * kPT + rq] * dos[rq * P + d];
        acck += dst[c * kPT + rq] * qs[rq * P + d];
      }
      dv_acc[j] += accv;
      dk_acc[j] += acck;
    }
  }

  const int sk = k0 + c;
  if (sk < Skv) {
    const size_t base = at<D>(b, sk, h, Skv, H);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[base + lane + kLanes * j] = from_f32<T>(dk_acc[j]);
      dv[base + lane + kLanes * j] = from_f32<T>(dv_acc[j]);
    }
  }
}

// --------------------------------------------------------------------- dQ
// One block per (b*h, q-tile); thread (r, lane) owns query row r; k-tiles
// stream through.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const bool* __restrict__ mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Skv, int H, float scale) {
  constexpr int P = D + 1;
  constexpr int kCols = D / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * P;
  float* ks = dos + kTile * P;
  float* vs = ks + kTile * P;
  float* dss = vs + kTile * P;             // (q row, k col), stride kPT
  int* valid = reinterpret_cast<int*>(dss + kTile * kPT);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int r = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int sq = q0 + r;

  load_tile<T, D>(qs, q, b, h, q0, Sq, H);
  load_tile<T, D>(dos, dout, b, h, q0, Sq, H);
  const float row_lse = sq < Sq ? lse[static_cast<size_t>(bh) * Sq + sq] : 0.f;
  const float row_delta =
      sq < Sq ? delta[static_cast<size_t>(bh) * Sq + sq] : 0.f;
  float dq_acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dq_acc[j] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(ks, k, b, h, k0, Skv, H);
    load_tile<T, D>(vs, v, b, h, k0, Skv, H);
    load_mask(valid, mask, b, k0, Skv);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + kLanes * j;
      const float s = dot_rows<D>(qs + r * P, ks + c * P) * scale;
      const float p = valid[c] ? expf(s - row_lse) : 0.f;
      const float dp = dot_rows<D>(dos + r * P, vs + c * P);
      dss[r * kPT + c] = round_to<T>(p * (dp - row_delta) * scale);
    }
    __syncwarp();                          // query row r, written by 4 lanes
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = lane + kLanes * j;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < kTile; ++c) acc += dss[r * kPT + c] * ks[c * P + d];
      dq_acc[j] += acc;
    }
  }

  if (sq < Sq) {
    const size_t base = at<D>(b, sq, h, Sq, H);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      dq[base + lane + kLanes * j] = from_f32<T>(dq_acc[j]);
  }
}

constexpr size_t dkdv_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPT + 2 * kTile) +
         sizeof(int) * kTile;
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPT) +
         sizeof(int) * kTile;
}

// Launch one instantiation; the dynamic shared-memory opt-in is set once
// per instantiation (several of them need more than the default 48 KB).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool* configured, size_t smem, dim3 grid,
           int threads, cudaStream_t stream, Args... args) {
  if (!*configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    *configured = true;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

// forward and carry: `warps` (1, 2 or 4) warps of 16 query rows a block
template <typename T, int D, bool kCarry>
int run_fwd_body(const void* q, const void* k, const void* v,
                 const void* mask, void* out, void* lse, const Carry& carry,
                 int B, int Sq, int Skv, int H, float scale, int warps,
                 cudaStream_t stream) {
  static bool configured = false;
  if (warps != 1 && warps != 2 && warps != kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kRows * warps;
  return launch(flash_fwd_kernel<T, D, kCarry>, &configured,
                FwdSmem<T, D>::kBytes, dim3(B * H, (Sq + rows - 1) / rows),
                32 * warps, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const bool*>(mask), static_cast<T*>(out),
                static_cast<float*>(lse), carry, Sq, Skv, H, scale);
}

template <typename T, int D>
int run_fwd(const void* q, const void* k, const void* v, const void* mask,
            void* out, void* lse, int B, int Sq, int Skv, int H, float scale,
            int warps, cudaStream_t stream) {
  return run_fwd_body<T, D, false>(q, k, v, mask, out, lse, Carry{}, B, Sq,
                                   Skv, H, scale, warps, stream);
}

template <typename T, int D>
int run_carry(const void* q, const void* k, const void* v, const void* mask,
              const void* acc_in, const void* m_in, const void* l_in,
              void* acc_out, void* m_out, void* l_out, int B, int Sq,
              int Skv, int H, float scale, int warps, cudaStream_t stream) {
  const Carry carry{static_cast<const float*>(acc_in),
                    static_cast<const float*>(m_in),
                    static_cast<const float*>(l_in),
                    static_cast<float*>(acc_out), static_cast<float*>(m_out),
                    static_cast<float*>(l_out)};
  return run_fwd_body<T, D, true>(q, k, v, mask, nullptr, nullptr, carry, B,
                                  Sq, Skv, H, scale, warps, stream);
}

template <typename T, int D>
int run_dkdv(const void* q, const void* k, const void* v, const void* mask,
             const void* dout, const void* lse, const void* delta, void* dk,
             void* dv, int B, int Sq, int Skv, int H, float scale,
             cudaStream_t stream) {
  static bool configured = false;
  return launch(flash_dkdv_kernel<T, D>, &configured, dkdv_smem(D),
                dim3(B * H, tiles(Skv)), kThreads, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const bool*>(mask),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), Sq, Skv, H, scale);
}

template <typename T, int D>
int run_dq(const void* q, const void* k, const void* v, const void* mask,
           const void* dout, const void* lse, const void* delta, void* dq,
           int B, int Sq, int Skv, int H, float scale, cudaStream_t stream) {
  static bool configured = false;
  return launch(flash_dq_kernel<T, D>, &configured, dq_smem(D),
                dim3(B * H, tiles(Sq)), kThreads, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const bool*>(mask),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), Sq,
                Skv, H, scale);
}

// dtype code 0 = float32, 1 = bfloat16; head dims 16/32/64/128
#define BFLC_DISPATCH(RUN, ...)                                    \
  switch (dtype * 1000 + head_dim) {                               \
    case 16: return RUN<float, 16>(__VA_ARGS__);                   \
    case 32: return RUN<float, 32>(__VA_ARGS__);                   \
    case 64: return RUN<float, 64>(__VA_ARGS__);                   \
    case 128: return RUN<float, 128>(__VA_ARGS__);                 \
    case 1016: return RUN<__nv_bfloat16, 16>(__VA_ARGS__);         \
    case 1032: return RUN<__nv_bfloat16, 32>(__VA_ARGS__);         \
    case 1064: return RUN<__nv_bfloat16, 64>(__VA_ARGS__);         \
    case 1128: return RUN<__nv_bfloat16, 128>(__VA_ARGS__);        \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }

}  // namespace

extern "C" {

int bflc_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, const void* mask, void* out, void* lse,
                   int B, int Sq, int Skv, int H, float scale, int warps,
                   void* stream) {
  BFLC_DISPATCH(run_fwd, q, k, v, mask, out, lse, B, Sq, Skv, H, scale,
                warps, static_cast<cudaStream_t>(stream))
}

int bflc_flash_dkdv(int dtype, int head_dim, const void* q, const void* k,
                    const void* v, const void* mask, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv,
                    int B, int Sq, int Skv, int H, float scale,
                    void* stream) {
  BFLC_DISPATCH(run_dkdv, q, k, v, mask, dout, lse, delta, dk, dv, B, Sq,
                Skv, H, scale, static_cast<cudaStream_t>(stream))
}

int bflc_flash_dq(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, const void* mask, const void* dout,
                  const void* lse, const void* delta, void* dq, int B,
                  int Sq, int Skv, int H, float scale, void* stream) {
  BFLC_DISPATCH(run_dq, q, k, v, mask, dout, lse, delta, dq, B, Sq, Skv, H,
                scale, static_cast<cudaStream_t>(stream))
}

int bflc_flash_carry(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* mask, const void* acc_in,
                     const void* m_in, const void* l_in, void* acc_out,
                     void* m_out, void* l_out, int B, int Sq, int Skv, int H,
                     float scale, int warps, void* stream) {
  BFLC_DISPATCH(run_carry, q, k, v, mask, acc_in, m_in, l_in, acc_out, m_out,
                l_out, B, Sq, Skv, H, scale, warps,
                static_cast<cudaStream_t>(stream))
}

}  // extern "C"
