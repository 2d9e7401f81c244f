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
// run in no order and share nothing, so each warp owns 16 output rows of
// one batch*head and its block loops over the streamed axis in 64-row
// tiles:
//   forward, carry, dQ: 16 query rows a warp, key tiles stream;
//   dK/dV:              16 key rows a warp, query tiles stream.
// Every output row has one owner: no atomics, and the results do not
// depend on the schedule.
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
// body runs both products on the tensor cores with `mma.sync`:
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
//     (flash_attention.py:block_warps), so a small batch still gives every
//     SM a block and a long sequence lets four warps share each tile.
// f32 inputs run 3xTF32: x = hi + lo with hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi), and each product is hi.lo + lo.hi + hi.hi
// accumulated in f32 (the lo.lo term is below 2^-22 relative).  Its error
// is about 2^-21 relative per product, at f32's level.  TF32 alone keeps
// 11 significant bits (~2^-11 relative, ~5e-4): that is what the port's
// f32 tolerances must not hide, which is why the device module turns
// PyTorch's TF32 off, and why every kernel here splits every f32 operand.
// The split costs three mma per product, so the f32 bound of this route
// is 495 / 3 = 165 TFLOP/s, above the CUDA cores' 67.  bf16 inputs run one
// m16n8k16 bf16 mma per product with f32 accumulation; p (and dS) are
// rounded to bf16 on their way into the next mma, where the reference's
// `.astype` rounds them.  p = exp(s - m) runs on the SFU's ex2
// (2^(x log2 e), a few f32 ulps, and on an H100 an eighth faster a carry
// step than the accurate expf); the rescale exp(m - m_new) stays expf.
// What bounds the body: not shared memory and not the tensor cores' rate
// (about a quarter of the mma.sync time is used) but the latency of each
// warp's dependent chain per tile — S mma, quad max, exponentials, quad
// sum, P V mma — with the ALU work of the splits beside it, and a block
// barrier twice a tile.  Later work: wgmma with operands in shared memory,
// TMA loads with mbarriers and a producer warp.
//
// ---- The backward pair (K2 dK/dV, K3 dQ): the same primitives.  At
// config 5's training shape (B 16, S 64, 4 heads, head dim 32, f32) the
// pair moves ~5.8 MB (~1.7 us) for ~90 MFLOP over the valid keys: bytes
// and launch latency bound it; at the sp oracle's (4, 8192) sequence the
// products do (~0.36 TFLOP for the pair, ~2.2 ms at 165 TFLOP/s).  Both
// recompute p from the forward's lse (no softmax statistics to carry):
//   * dQ (K3) is the forward with a third product.  A warp holds Q and dO
//     as A fragments and its rows' lse and delta in registers; K, V and
//     the key mask stream through the forward's ring (stage_kv).  Per key
//     tile S = Q K^T and dP = dO V^T (V is staged as K is, so the same
//     `logits` computes it), p and dS in the accumulators, then
//     dQ += dS K with K read as the forward reads V — the same key
//     permutation, so dS is the A fragment as it stands;
//   * dK/dV (K2) swaps the roles.  A warp holds the K and V rows of its
//     16 keys as A fragments and their mask bits in registers; 64-query
//     tiles of Q, dO, lse and delta stream through the same ring
//     (stage_qdo).  S^T = K Q^T and dP^T = V dO^T land with queries as the
//     accumulator's columns, so lse and delta are read at columns 8n + 2t
//     and 8n + 2t + 1, and p^T and dS^T are the A fragments of
//     dV += p^T dO and dK += dS^T Q as they stand (dO and Q read as the
//     forward reads V);
//   * blocks of 1, 2 or 4 warps over the rows each kernel owns (keys for
//     K2, queries for K3), by the forward's chooser: 256 one-warp blocks
//     each at config 5's training shape, so every SM of an H100 gets one,
//     and 2048 four-warp blocks at (4, 8192).
// A K2 warp keeps 4 product chains a tile and K3 3, against the forward's
// 2, so the same per-tile latency bounds them.  f32 registers: the split
// fragments of two A operands (2 x D/2 x 4 words) and two D-wide
// accumulators fit at D = 32; at D = 64 and 128 (on no main path) they
// spill, which the build's -Xptxas -v report shows.
//
// Numerics follow the reference exactly where it is explicit:
//   * logits = (q . k) * scale in f32; masked logits are -1e30;
//   * probabilities of masked keys are SELECTED to 0, never multiplied by
//     the mask — on a fully masked row lse sits near -1e30 and
//     exp(s - lse) overflows to inf, and inf * 0 is NaN (the guards at
//     pallas_attention.py:86, :182, :216); a fully masked tile or hop
//     leaves m at -1e30, and a later real one rescales through corr = 0;
//   * dS = p (dP - delta) scale in f32;
//   * p (and dS) are rounded to the storage dtype before the products
//     that consume them, as the reference's `.astype(v.dtype)` does;
//   * every product accumulates in f32 and is rounded once, at the store;
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

constexpr int kRows = 16;                  // output rows per warp (mma M)
constexpr int kTile = 64;                  // rows per streamed tile
constexpr int kTileCols = kTile / 8;       // 8-column tiles of an S tile
constexpr int kMaxWarps = 4;
constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;

// element (b, s, h, d) of a contiguous (B, S, H, D) tensor
template <int D>
__device__ __forceinline__ size_t at(int b, int s, int h, int S, int H) {
  return ((static_cast<size_t>(b) * S + s) * H + h) * D;
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

// ---------------------------------------------------------------- staging
// Shared memory of the streamed tiles: two stages, each two (kTile x D)
// row tiles and kExtra bytes beside them.  Rows are padded so that a
// warp's fragment loads hit 32 distinct banks: f32 rows D + 4 words
// (stride = 4 mod 32 words), bf16 rows D + 8 halves.
template <typename T, int D, size_t kExtra = 0>
struct StageSmem {
  static constexpr int kStride = D + (std::is_same<T, float>::value ? 4 : 8);
  static constexpr size_t kTileBytes = sizeof(T) * kTile * kStride;
  static constexpr size_t kStageBytes = 2 * kTileBytes + kExtra;
  static constexpr size_t kBytes = 2 * kStageBytes;
};

// K, V and the key mask (forward, carry, dQ)
template <typename T, int D>
using KvSmem = StageSmem<T, D, kTile>;
// Q, dO and the query rows' lse and delta (dK/dV)
template <typename T, int D>
using QdoSmem = StageSmem<T, D, 2 * kTile * sizeof(float)>;

// Start the copies of rows [r0, r0 + kTile) of head h of batch b of two
// (B, S, H, D) tensors into two padded tiles; rows past S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* xs, T* ys, const T* x,
                                           const T* y, int b, int h, int r0,
                                           int S, int H) {
  constexpr int kStride = StageSmem<T, D>::kStride;
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte copy
  constexpr int kChunks = D / kVec;        // copies per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * kVec, s = r0 + r;
    const bool in = s < S;
    const size_t src = in ? at<D>(b, s, h, S, H) + c : 0;
    cp_async16(xs + r * kStride + c, x + src, in);
    cp_async16(ys + r * kStride + c, y + src, in);
  }
}

// Entries [0, kTile) of a per-row vector (key mask, lse or delta) whose
// first n entries exist, zero past them: by cp.async where the tile is
// whole and the source 16-byte aligned (every tile of the main paths),
// else by plain loads (ragged lengths, or a misaligned tensor; made
// visible by the same barrier).  Plain loads of the key mask throughout
// took K1 at config 5's training shape, one-warp blocks, from 6.62-6.63 to
// 6.85-6.95 us, and left K4 at the sp shard unchanged (chip_smoke.py's
// timing phases, H100 80GB HBM3 at 700 W).
template <typename E>
__device__ __forceinline__ void stage_vec(E* dst, const E* src, int n) {
  if (n >= kTile && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int kCopies = kTile * sizeof(E) / 16;
    for (int i = threadIdx.x; i < kCopies; i += blockDim.x)
      cp_async16(reinterpret_cast<unsigned char*>(dst) + 16 * i,
                 reinterpret_cast<const unsigned char*>(src) + 16 * i, true);
  } else {
    for (int i = threadIdx.x; i < kTile; i += blockDim.x)
      dst[i] = i < n ? src[i] : E(0);
  }
}

// keys [k0, k0 + kTile) into one stage of KvSmem: K, V, and the key mask
// (false past S_kv)
template <typename T, int D>
__device__ __forceinline__ void stage_kv(unsigned char* stage, const T* k,
                                         const T* v, const bool* mask, int b,
                                         int h, int k0, int Skv, int H) {
  using L = KvSmem<T, D>;
  stage_rows<T, D>(reinterpret_cast<T*>(stage),
                   reinterpret_cast<T*>(stage + L::kTileBytes), k, v, b, h,
                   k0, Skv, H);
  stage_vec(reinterpret_cast<bool*>(stage + 2 * L::kTileBytes),
            mask + static_cast<size_t>(b) * Skv + k0, Skv - k0);
}

// queries [q0, q0 + kTile) into one stage of QdoSmem: Q, dO, then lse and
// delta of those rows (kTile f32 each; 0 past S_q)
template <typename T, int D>
__device__ __forceinline__ void stage_qdo(unsigned char* stage, const T* q,
                                          const T* dout, const float* lse,
                                          const float* delta, int b, int h,
                                          int q0, int Sq, int H) {
  using L = QdoSmem<T, D>;
  stage_rows<T, D>(reinterpret_cast<T*>(stage),
                   reinterpret_cast<T*>(stage + L::kTileBytes), q, dout, b,
                   h, q0, Sq, H);
  float* stats = reinterpret_cast<float*>(stage + 2 * L::kTileBytes);
  const size_t row = (static_cast<size_t>(b) * H + h) * Sq + q0;
  stage_vec(stats, lse + row, Sq - q0);
  stage_vec(stats + kTile, delta + row, Sq - q0);
}

// ---------------------------------------------------------- warp products
// One warp's products on the tensor cores: A is 16 rows held in registers
// (Q, dO, K or V), the streamed tile is the B operand.  Fragment
// coordinates: lane = 4 g + t; the accumulator of an 8-column tile holds
// rows g (elements 0, 1) and g + 8 (elements 2, 3) at columns 2t and
// 2t + 1.
template <typename T, int D>
struct WarpMma;

// f32: 3xTF32 m16n8k8.  A is split once; the tile and P at their use.
template <int D>
struct WarpMma<float, D> {
  static constexpr int kSteps = D / 8;     // mma depth 8 over the head dim
  static constexpr int P = StageSmem<float, D>::kStride;
  uint32_t ah[kSteps][4], al[kSteps][4];

  // A fragment of step kk: (g, 8kk + t), (g + 8, ..), (g, 8kk + t + 4),
  // (g + 8, ..); r0 / r8 point at rows g / g + 8, null past the end
  __device__ __forceinline__ void load_a(const float* r0, const float* r8,
                                         int t) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int d = 8 * kk + t;
      split_tf32(r0 ? r0[d] : 0.f, ah[kk][0], al[kk][0]);
      split_tf32(r8 ? r8[d] : 0.f, ah[kk][1], al[kk][1]);
      split_tf32(r0 ? r0[d + 4] : 0.f, ah[kk][2], al[kk][2]);
      split_tf32(r8 ? r8[d + 4] : 0.f, ah[kk][3], al[kk][3]);
    }
  }

  // s[n] = A X^T over rows 8n .. 8n + 7 of the staged tile X; B fragment
  // (k = d, n = tile row): (8kk + t, g) and (8kk + t + 4, g)
  __device__ __forceinline__ void logits(float (&s)[kTileCols][4],
                                         const float* xs, int g,
                                         int t) const {
#pragma unroll
    for (int n = 0; n < kTileCols; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t bh[kTileCols][2], bl[kTileCols][2];
#pragma unroll
      for (int n = 0; n < kTileCols; ++n) {
        const float* xr = xs + (8 * n + g) * P + 8 * kk + t;
        split_tf32(xr[0], bh[n][0], bl[n][0]);
        split_tf32(xr[4], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < kTileCols; ++n)
        mma_tf32(s[n], ah[kk], bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < kTileCols; ++n)
        mma_tf32(s[n], al[kk], bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < kTileCols; ++n)
        mma_tf32(s[n], ah[kk], bh[n][0], bh[n][1]);
    }
  }

  // acc[n] += P X over the tile's rows, output columns 8n .. 8n + 7.  In
  // step j (tile rows 8j .. 8j + 7) k-index t stands for row 2t and t + 4
  // for row 2t + 1, so p[j] is the A fragment as it stands: (g, 2t) =
  // p[j][0], (g + 8, 2t) = p[j][2], (g, 2t + 1) = p[j][1], (g + 8, 2t + 1)
  // = p[j][3]; X's B fragment reads rows 8j + 2t and 8j + 2t + 1 at
  // column 8n + g
  __device__ __forceinline__ void pv(float (&acc)[D / 8][4],
                                     const float (&p)[kTileCols][4],
                                     const float* xs, int g, int t) const {
#pragma unroll
    for (int j = 0; j < kTileCols; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(p[j][0], ph[0], pl[0]);
      split_tf32(p[j][2], ph[1], pl[1]);
      split_tf32(p[j][1], ph[2], pl[2]);
      split_tf32(p[j][3], ph[3], pl[3]);
      const float* xr = xs + (8 * j + 2 * t) * P + g;
      uint32_t bh[D / 8][2], bl[D / 8][2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        split_tf32(xr[8 * n], bh[n][0], bl[n][0]);
        split_tf32(xr[P + 8 * n], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(acc[n], ph, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(acc[n], pl, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(acc[n], ph, bh[n][0], bh[n][1]);
    }
  }
};

// bf16: one m16n8k16 per product; p is rounded to bf16 on the way in
template <int D>
struct WarpMma<__nv_bfloat16, D> {
  static constexpr int kSteps = D / 16;    // mma depth 16 over the head dim
  static constexpr int P = StageSmem<__nv_bfloat16, D>::kStride;
  uint32_t a[kSteps][4];

  // A fragment of step kk: pairs (g, 16kk + 2t), (g + 8, ..),
  // (g, 16kk + 2t + 8), (g + 8, ..)
  __device__ __forceinline__ void load_a(const __nv_bfloat16* r0,
                                         const __nv_bfloat16* r8, int t) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int d = 16 * kk + 2 * t;
      a[kk][0] = r0 ? ld32(r0 + d) : 0u;
      a[kk][1] = r8 ? ld32(r8 + d) : 0u;
      a[kk][2] = r0 ? ld32(r0 + d + 8) : 0u;
      a[kk][3] = r8 ? ld32(r8 + d + 8) : 0u;
    }
  }

  // B fragment (k = d, n = tile row): pairs (16kk + 2t, g), (16kk + 2t +
  // 8, g)
  __device__ __forceinline__ void logits(float (&s)[kTileCols][4],
                                         const __nv_bfloat16* xs, int g,
                                         int t) const {
#pragma unroll
    for (int n = 0; n < kTileCols; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int n = 0; n < kTileCols; ++n) {
        const __nv_bfloat16* xr = xs + (8 * n + g) * P + 16 * kk + 2 * t;
        mma_bf16(s[n], a[kk], ld32(xr), ld32(xr + 8));
      }
    }
  }

  // step j covers tile rows 16j .. 16j + 15: the accumulators of column
  // tiles 2j and 2j + 1 are its A fragment; X's B fragment holds the pairs
  // (16j + 2t, 8n + g) and (16j + 2t + 8, 8n + g)
  __device__ __forceinline__ void pv(float (&acc)[D / 8][4],
                                     const float (&p)[kTileCols][4],
                                     const __nv_bfloat16* xs, int g,
                                     int t) const {
#pragma unroll
    for (int j = 0; j < kTileCols / 2; ++j) {
      const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                              pack_bf16(p[2 * j][2], p[2 * j][3]),
                              pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                              pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
      const __nv_bfloat16* xr = xs + (16 * j + 2 * t) * P + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* c = xr + 8 * n;
        mma_bf16(acc[n], pa, pack_bf16(c[0], c[P]),
                 pack_bf16(c[8 * P], c[9 * P]));
      }
    }
  }
};

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// row r's 8-column accumulators to row r of a (.., D) output at column 2t
template <typename T, int D>
__device__ __forceinline__ void store_row(T* out, const float (&acc)[D / 8][4],
                                          int i, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    store2(out + 8 * n + 2 * t, acc[n][2 * i], acc[n][2 * i + 1]);
}

// ---------------------------------------------------------------- forward
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
  using L = KvSmem<T, D>;
  constexpr int kCols = D / 8;             // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char fwd_smem[];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (blockIdx.y * (blockDim.x / 32) + warp) * kRows;
  const int rows[2] = {r0 + g, r0 + g + 8};   // this thread's query rows
  const int n_tiles = (Skv + kTile - 1) / kTile;

  // tile 0 is in flight while Q and the carry are read
  stage_kv<T, D>(fwd_smem, k, v, mask, b, h, 0, Skv, H);
  cp_async_commit();

  WarpMma<T, D> mma;
  mma.load_a(rows[0] < Sq ? q + at<D>(b, rows[0], h, Sq, H) : nullptr,
             rows[1] < Sq ? q + at<D>(b, rows[1], h, Sq, H) : nullptr, t);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kCols][4];
  zero<D>(acc);
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
                     b, h, (j + 1) * kTile, Skv, H);
    cp_async_commit();                     // empty on the last tile
    cp_async_wait<1>();                    // this thread's copies of tile j
    __syncthreads();                       // ... and every thread's
    const unsigned char* stage = fwd_smem + (j & 1) * L::kStageBytes;
    const T* ks = reinterpret_cast<const T*>(stage);
    const T* vs = reinterpret_cast<const T*>(stage + L::kTileBytes);
    const unsigned char* valid = stage + 2 * L::kTileBytes;

    float s[kTileCols][4];
    mma.logits(s, ks, g, t);
    bool ok[kTileCols][2];
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kTileCols; ++n) {
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
    for (int n = 0; n < kTileCols; ++n) {
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
      store_row<float, D>(carry.acc_out + row * D, acc, i, t);
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

// ------------------------------------------------------------- backward
// p = exp(s scale - lse), SELECTED to 0 where the (query, key) pair is
// masked (exp may be inf on a fully masked row), and dS = p (dP - delta)
// scale: s becomes p and dp becomes dS.
__device__ __forceinline__ void probs_and_ds(float& s, float& dp, bool ok,
                                             float lse, float delta,
                                             float scale) {
  const float p = ok ? fast_exp(s * scale - lse) : 0.f;
  s = p;
  dp = p * (dp - delta) * scale;
}

// dQ (K3): blockDim.x / 32 warps of 16 query rows each; grid (B*H, row
// tiles); key tiles stream through KvSmem.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const bool* __restrict__ mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Skv, int H, float scale) {
  using L = KvSmem<T, D>;
  extern __shared__ __align__(16) unsigned char dq_smem[];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (blockIdx.y * (blockDim.x / 32) + warp) * kRows;
  const int rows[2] = {r0 + g, r0 + g + 8};   // this thread's query rows
  const int n_tiles = (Skv + kTile - 1) / kTile;

  stage_kv<T, D>(dq_smem, k, v, mask, b, h, 0, Skv, H);
  cp_async_commit();

  WarpMma<T, D> mq, mdo;
  const T* qr[2];
  const T* dr[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < Sq;
    qr[i] = in ? q + at<D>(b, rows[i], h, Sq, H) : nullptr;
    dr[i] = in ? dout + at<D>(b, rows[i], h, Sq, H) : nullptr;
    const size_t row = static_cast<size_t>(bh) * Sq + rows[i];
    row_lse[i] = in ? lse[row] : 0.f;
    row_delta[i] = in ? delta[row] : 0.f;
  }
  mq.load_a(qr[0], qr[1], t);
  mdo.load_a(dr[0], dr[1], t);
  float acc[D / 8][4];
  zero<D>(acc);

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles)
      stage_kv<T, D>(dq_smem + ((j + 1) & 1) * L::kStageBytes, k, v, mask,
                     b, h, (j + 1) * kTile, Skv, H);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* stage = dq_smem + (j & 1) * L::kStageBytes;
    const T* ks = reinterpret_cast<const T*>(stage);
    const T* vs = reinterpret_cast<const T*>(stage + L::kTileBytes);
    const unsigned char* valid = stage + 2 * L::kTileBytes;

    float s[kTileCols][4], dp[kTileCols][4];
    mq.logits(s, ks, g, t);                // S = Q K^T
    mdo.logits(dp, vs, g, t);              // dP = dO V^T
#pragma unroll
    for (int n = 0; n < kTileCols; ++n) {
      const bool ok[2] = {valid[8 * n + 2 * t] != 0,
                          valid[8 * n + 2 * t + 1] != 0};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        probs_and_ds(s[n][e], dp[n][e], ok[e & 1], row_lse[e >> 1],
                     row_delta[e >> 1], scale);
    }
    mq.pv(acc, dp, ks, g, t);              // dQ += dS K
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (rows[i] < Sq) store_row<T, D>(dq + at<D>(b, rows[i], h, Sq, H), acc,
                                      i, t);
}

// dK/dV (K2): blockDim.x / 32 warps of 16 key rows each; grid (B*H, row
// tiles of the keys); query tiles stream through QdoSmem.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const bool* __restrict__ mask,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Sq, int Skv, int H, float scale) {
  using L = QdoSmem<T, D>;
  extern __shared__ __align__(16) unsigned char dkdv_smem[];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (blockIdx.y * (blockDim.x / 32) + warp) * kRows;
  const int keys[2] = {r0 + g, r0 + g + 8};   // this thread's key rows
  const int n_tiles = (Sq + kTile - 1) / kTile;

  stage_qdo<T, D>(dkdv_smem, q, dout, lse, delta, b, h, 0, Sq, H);
  cp_async_commit();

  WarpMma<T, D> mk, mv;
  const T* kr[2];
  const T* vr[2];
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = keys[i] < Skv;
    kr[i] = in ? k + at<D>(b, keys[i], h, Skv, H) : nullptr;
    vr[i] = in ? v + at<D>(b, keys[i], h, Skv, H) : nullptr;
    key_ok[i] = in && mask[static_cast<size_t>(b) * Skv + keys[i]];
  }
  mk.load_a(kr[0], kr[1], t);
  mv.load_a(vr[0], vr[1], t);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles)
      stage_qdo<T, D>(dkdv_smem + ((j + 1) & 1) * L::kStageBytes, q, dout,
                      lse, delta, b, h, (j + 1) * kTile, Sq, H);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* stage = dkdv_smem + (j & 1) * L::kStageBytes;
    const T* qs = reinterpret_cast<const T*>(stage);
    const T* dos = reinterpret_cast<const T*>(stage + L::kTileBytes);
    const float* stats = reinterpret_cast<const float*>(stage +
                                                        2 * L::kTileBytes);
    const int q_left = Sq - j * kTile;     // queries of the tile inside S_q

    float s[kTileCols][4], dp[kTileCols][4];
    mk.logits(s, qs, g, t);                // S^T = K Q^T
    mv.logits(dp, dos, g, t);              // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < kTileCols; ++n) {
      const int c = 8 * n + 2 * t;         // this thread's query columns
      const float2 ls = *reinterpret_cast<const float2*>(stats + c);
      const float2 dl = *reinterpret_cast<const float2*>(stats + kTile + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int odd = e & 1;
        probs_and_ds(s[n][e], dp[n][e],
                     key_ok[e >> 1] && c + odd < q_left, odd ? ls.y : ls.x,
                     odd ? dl.y : dl.x, scale);
      }
    }
    mk.pv(dv_acc, s, dos, g, t);           // dV += p^T dO
    mk.pv(dk_acc, dp, qs, g, t);           // dK += dS^T Q
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= Skv) continue;
    const size_t row = at<D>(b, keys[i], h, Skv, H);
    store_row<T, D>(dk + row, dk_acc, i, t);
    store_row<T, D>(dv + row, dv_acc, i, t);
  }
}

// ---------------------------------------------------------------- launch
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

// `warps` (1, 2 or 4) warps of kRows output rows a block, over `rows` rows
// of each batch*head; false for another warp count
bool row_grid(int B, int H, int rows, int warps, dim3* grid) {
  if (warps != 1 && warps != 2 && warps != kMaxWarps) return false;
  const int per = kRows * warps;
  *grid = dim3(B * H, (rows + per - 1) / per);
  return true;
}

constexpr int kBadWarps = static_cast<int>(cudaErrorInvalidValue);

template <typename T, int D, bool kCarry>
int run_fwd_body(const void* q, const void* k, const void* v,
                 const void* mask, void* out, void* lse, const Carry& carry,
                 int B, int Sq, int Skv, int H, float scale, int warps,
                 cudaStream_t stream) {
  static bool configured = false;
  dim3 grid;
  if (!row_grid(B, H, Sq, warps, &grid)) return kBadWarps;
  return launch(flash_fwd_kernel<T, D, kCarry>, &configured,
                KvSmem<T, D>::kBytes, grid, 32 * warps, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const bool*>(mask),
                static_cast<T*>(out), static_cast<float*>(lse), carry, Sq,
                Skv, H, scale);
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

// dK/dV: its warps own key rows
template <typename T, int D>
int run_dkdv(const void* q, const void* k, const void* v, const void* mask,
             const void* dout, const void* lse, const void* delta, void* dk,
             void* dv, int B, int Sq, int Skv, int H, float scale, int warps,
             cudaStream_t stream) {
  static bool configured = false;
  dim3 grid;
  if (!row_grid(B, H, Skv, warps, &grid)) return kBadWarps;
  return launch(flash_dkdv_kernel<T, D>, &configured, QdoSmem<T, D>::kBytes,
                grid, 32 * warps, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const bool*>(mask), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), Sq, Skv, H, scale);
}

// dQ: its warps own query rows
template <typename T, int D>
int run_dq(const void* q, const void* k, const void* v, const void* mask,
           const void* dout, const void* lse, const void* delta, void* dq,
           int B, int Sq, int Skv, int H, float scale, int warps,
           cudaStream_t stream) {
  static bool configured = false;
  dim3 grid;
  if (!row_grid(B, H, Sq, warps, &grid)) return kBadWarps;
  return launch(flash_dq_kernel<T, D>, &configured, KvSmem<T, D>::kBytes,
                grid, 32 * warps, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const bool*>(mask), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), Sq,
                Skv, H, scale);
}

// head dims 16/32/64/128 of one dtype
#define BFLC_HEAD_DIMS(RUN, T, ...)                                \
  switch (head_dim) {                                              \
    case 16: return RUN<T, 16>(__VA_ARGS__);                       \
    case 32: return RUN<T, 32>(__VA_ARGS__);                       \
    case 64: return RUN<T, 64>(__VA_ARGS__);                       \
    case 128: return RUN<T, 128>(__VA_ARGS__);                     \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }

}  // namespace

// BFLC_FA_PART (0-7) compiles entry point BFLC_FA_PART / 2 at dtype
// BFLC_FA_PART % 2 (0 float32, 1 bfloat16), and so only the kernels that
// pair instantiates: the build compiles the eight parts in parallel and
// links them into one library (ops/build.py).  Unset, this file compiles
// all of them.  An entry point's float32 part holds its C entry, which
// hands bfloat16 (dtype code 1) to its twin `_bf16` in the other part.
#if defined(BFLC_FA_PART)
#define BFLC_FA_PART_IS(entry, dtype) (BFLC_FA_PART == 2 * (entry) + (dtype))
#else
#define BFLC_FA_PART_IS(entry, dtype) 1
#endif

extern "C" {

// the bfloat16 twins, which a float32 part calls across parts
int bflc_flash_fwd_bf16(int head_dim, const void* q, const void* k,
                        const void* v, const void* mask, void* out, void* lse,
                        int B, int Sq, int Skv, int H, float scale, int warps,
                        void* stream);
int bflc_flash_dkdv_bf16(int head_dim, const void* q, const void* k,
                         const void* v, const void* mask, const void* dout,
                         const void* lse, const void* delta, void* dk,
                         void* dv, int B, int Sq, int Skv, int H, float scale,
                         int warps, void* stream);
int bflc_flash_dq_bf16(int head_dim, const void* q, const void* k,
                       const void* v, const void* mask, const void* dout,
                       const void* lse, const void* delta, void* dq, int B,
                       int Sq, int Skv, int H, float scale, int warps,
                       void* stream);
int bflc_flash_carry_bf16(int head_dim, const void* q, const void* k,
                          const void* v, const void* mask, const void* acc_in,
                          const void* m_in, const void* l_in, void* acc_out,
                          void* m_out, void* l_out, int B, int Sq, int Skv,
                          int H, float scale, int warps, void* stream);

#if BFLC_FA_PART_IS(0, 1)
int bflc_flash_fwd_bf16(int head_dim, const void* q, const void* k,
                        const void* v, const void* mask, void* out, void* lse,
                        int B, int Sq, int Skv, int H, float scale, int warps,
                        void* stream) {
  BFLC_HEAD_DIMS(run_fwd, __nv_bfloat16, q, k, v, mask, out, lse, B, Sq, Skv,
                 H, scale, warps, static_cast<cudaStream_t>(stream))
}
#endif

#if BFLC_FA_PART_IS(0, 0)
int bflc_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, const void* mask, void* out, void* lse,
                   int B, int Sq, int Skv, int H, float scale, int warps,
                   void* stream) {
  if (dtype == 1) return bflc_flash_fwd_bf16(head_dim, q, k, v, mask, out, lse,
      B, Sq, Skv, H, scale, warps, stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  BFLC_HEAD_DIMS(run_fwd, float, q, k, v, mask, out, lse, B, Sq, Skv, H, scale,
                 warps, static_cast<cudaStream_t>(stream))
}
#endif

#if BFLC_FA_PART_IS(1, 1)
int bflc_flash_dkdv_bf16(int head_dim, const void* q, const void* k,
                         const void* v, const void* mask, const void* dout,
                         const void* lse, const void* delta, void* dk,
                         void* dv, int B, int Sq, int Skv, int H, float scale,
                         int warps, void* stream) {
  BFLC_HEAD_DIMS(run_dkdv, __nv_bfloat16, q, k, v, mask, dout, lse, delta, dk,
                 dv, B, Sq, Skv, H, scale, warps,
                 static_cast<cudaStream_t>(stream))
}
#endif

#if BFLC_FA_PART_IS(1, 0)
int bflc_flash_dkdv(int dtype, int head_dim, const void* q, const void* k,
                    const void* v, const void* mask, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv,
                    int B, int Sq, int Skv, int H, float scale, int warps,
                    void* stream) {
  if (dtype == 1) return bflc_flash_dkdv_bf16(head_dim, q, k, v, mask, dout,
      lse, delta, dk, dv, B, Sq, Skv, H, scale, warps, stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  BFLC_HEAD_DIMS(run_dkdv, float, q, k, v, mask, dout, lse, delta, dk, dv, B,
                 Sq, Skv, H, scale, warps, static_cast<cudaStream_t>(stream))
}
#endif

#if BFLC_FA_PART_IS(2, 1)
int bflc_flash_dq_bf16(int head_dim, const void* q, const void* k,
                       const void* v, const void* mask, const void* dout,
                       const void* lse, const void* delta, void* dq, int B,
                       int Sq, int Skv, int H, float scale, int warps,
                       void* stream) {
  BFLC_HEAD_DIMS(run_dq, __nv_bfloat16, q, k, v, mask, dout, lse, delta, dq, B,
                 Sq, Skv, H, scale, warps, static_cast<cudaStream_t>(stream))
}
#endif

#if BFLC_FA_PART_IS(2, 0)
int bflc_flash_dq(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, const void* mask, const void* dout,
                  const void* lse, const void* delta, void* dq, int B, int Sq,
                  int Skv, int H, float scale, int warps, void* stream) {
  if (dtype == 1) return bflc_flash_dq_bf16(head_dim, q, k, v, mask, dout, lse,
      delta, dq, B, Sq, Skv, H, scale, warps, stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  BFLC_HEAD_DIMS(run_dq, float, q, k, v, mask, dout, lse, delta, dq, B, Sq,
                 Skv, H, scale, warps, static_cast<cudaStream_t>(stream))
}
#endif

#if BFLC_FA_PART_IS(3, 1)
int bflc_flash_carry_bf16(int head_dim, const void* q, const void* k,
                          const void* v, const void* mask, const void* acc_in,
                          const void* m_in, const void* l_in, void* acc_out,
                          void* m_out, void* l_out, int B, int Sq, int Skv,
                          int H, float scale, int warps, void* stream) {
  BFLC_HEAD_DIMS(run_carry, __nv_bfloat16, q, k, v, mask, acc_in, m_in, l_in,
                 acc_out, m_out, l_out, B, Sq, Skv, H, scale, warps,
                 static_cast<cudaStream_t>(stream))
}
#endif

#if BFLC_FA_PART_IS(3, 0)
int bflc_flash_carry(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* mask, const void* acc_in,
                     const void* m_in, const void* l_in, void* acc_out,
                     void* m_out, void* l_out, int B, int Sq, int Skv, int H,
                     float scale, int warps, void* stream) {
  if (dtype == 1) return bflc_flash_carry_bf16(head_dim, q, k, v, mask, acc_in,
      m_in, l_in, acc_out, m_out, l_out, B, Sq, Skv, H, scale, warps, stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  BFLC_HEAD_DIMS(run_carry, float, q, k, v, mask, acc_in, m_in, l_in, acc_out,
                 m_out, l_out, B, Sq, Skv, H, scale, warps,
                 static_cast<cudaStream_t>(stream))
}
#endif

}  // extern "C"
