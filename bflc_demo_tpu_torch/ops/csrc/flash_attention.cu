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
// run in no order and share nothing, so each block here owns one
// (batch*head, tile) output and loops over the streamed axis itself:
//   forward: one block per (b*h, q-tile), looping over k-tiles;
//   dK/dV:   one block per (b*h, k-tile), looping over q-tiles;
//   dQ:      one block per (b*h, q-tile), looping over k-tiles.
//
// What bounds them on the card: at the transformer's shapes (S = 64,
// head dim 32) one training forward moves ~2 MB of q/k/v/out in f32 for
// ~34 MFLOP, so launch latency and bytes bound the work, not FLOPs.
//
// The carry step (one ring hop of sequence-parallel attention) is K1 with
// its init and finish replaced by a load and a store of the f32 streaming
// state (acc (B*H, S_q, D), m and l (B*H, 1, S_q)), stored unnormalised;
// the caller divides acc by max(l, 1e-30) after the last hop.  At the
// ring's training shape (folded batch 32, S_q = S_kv = 1024, 4 heads, head
// dim 32) one hop reads q/k/v (3 x 16.8 MB) and the carry and writes the
// carry (2 x 16.8 MB), ~84 MB or ~25 us at 3.35 TB/s, for two products of
// 2*1024*1024*32 flops per (batch, head) row, ~17 GFLOP or ~0.26 ms at
// 67 TFLOP/s in f32: the port's first kernel bound by operations, not
// bytes.  It stays on the CUDA cores in f32 all the same (tensor cores are
// later work), so its time is the products' time.
//
// The design therefore stays simple: q/k/v/dO are read once from their
// (B, S, H, D) layout through strides (no transposed copies), staged as
// f32 tiles in shared memory (rows padded by one word, so the row-strided
// reads below are free of bank conflicts), and every product accumulates
// in f32 on the CUDA cores.  Tensor cores (wgmma) and TMA are later work.
//
// Numerics follow the reference exactly where it is explicit:
//   * logits = (q . k) * scale in f32; masked logits are -1e30;
//   * probabilities of masked keys are SELECTED to 0, never multiplied by
//     the mask — on a fully masked row lse sits near -1e30 and
//     exp(s - lse) overflows to inf, and inf * 0 is NaN (the guards at
//     pallas_attention.py:86, :182, :216);
//   * p (and dS) are rounded to the storage dtype before the products
//     that consume them, as the reference's `.astype(v.dtype)` does;
//   * out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// Tile geometry: 64 query rows x 64 key rows, 256 threads; the four
// threads of one tile row are adjacent lanes of one warp, so row
// reductions are two xor-shuffles and a row's probabilities are shared
// through shared memory with __syncwarp only.  Ragged sequence ends are
// masked in-kernel.  The block sizes of the reference API only have to
// divide the sequence (the wrapper checks that); they do not change the
// function, so the kernel keeps its own tile.
//
// Plain C ABI (loaded with ctypes).  Every entry returns cudaGetLastError()
// after its launch, so a refused launch surfaces in the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
template <typename T, int D, bool kCarry>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const bool* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, Carry carry,
                 int Sq, int Skv, int H, float scale) {
  constexpr int P = D + 1;
  constexpr int kCols = D / kLanes;        // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * P;
  float* vs = ks + kTile * P;
  float* ps = vs + kTile * P;              // (q row, k col), stride kPT
  int* valid = reinterpret_cast<int*>(ps + kTile * kPT);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int r = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;

  const int sq = q0 + r;
  const size_t row = static_cast<size_t>(bh) * Sq + sq;   // carry/lse row

  load_tile<T, D>(qs, q, b, h, q0, Sq, H);
  float m = kNegInf, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  if constexpr (kCarry) {
    if (sq < Sq) {
      m = carry.m_in[row];
      l = carry.l_in[row];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = carry.acc_in[row * D + lane + kLanes * j];
    }
  }

  for (int k0 = 0; k0 < Skv; k0 += kTile) {
    __syncthreads();                       // previous tile consumed
    load_tile<T, D>(ks, k, b, h, k0, Skv, H);
    load_tile<T, D>(vs, v, b, h, k0, Skv, H);
    load_mask(valid, mask, b, k0, Skv);
    __syncthreads();

    float s[kPer];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + kLanes * j;
      const float logit = dot_rows<D>(qs + r * P, ks + c * P) * scale;
      s[j] = valid[c] ? logit : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, row_max(tile_max));
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + kLanes * j;
      const float p = valid[c] ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
      ps[r * kPT + c] = round_to<T>(p);
    }
    const float corr = expf(m - m_new);
    l = l * corr + row_sum(p_sum);
    m = m_new;
    __syncwarp();                          // the row's p, written by 4 lanes
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = lane + kLanes * j;
      float pv = 0.f;
#pragma unroll 8
      for (int c = 0; c < kTile; ++c) pv += ps[r * kPT + c] * vs[c * P + d];
      acc[j] = acc[j] * corr + pv;
    }
  }

  if (sq >= Sq) return;
  if constexpr (kCarry) {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      carry.acc_out[row * D + lane + kLanes * j] = acc[j];
    if (lane == 0) {
      carry.m_out[row] = m;
      carry.l_out[row] = l;
    }
  } else {
    const float denom = fmaxf(l, kTiny);
    const size_t base = at<D>(b, sq, h, Sq, H);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      out[base + lane + kLanes * j] = from_f32<T>(acc[j] / denom);
    if (lane == 0) lse[row] = m + logf(denom);
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

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPT) +
         sizeof(int) * kTile;
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
           cudaStream_t stream, Args... args) {
  if (!*configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    *configured = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

template <typename T, int D>
int run_fwd(const void* q, const void* k, const void* v, const void* mask,
            void* out, void* lse, int B, int Sq, int Skv, int H, float scale,
            cudaStream_t stream) {
  static bool configured = false;
  return launch(flash_fwd_kernel<T, D, false>, &configured, fwd_smem(D),
                dim3(B * H, tiles(Sq)), stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const bool*>(mask), static_cast<T*>(out),
                static_cast<float*>(lse), Carry{}, Sq, Skv, H, scale);
}

template <typename T, int D>
int run_carry(const void* q, const void* k, const void* v, const void* mask,
              const void* acc_in, const void* m_in, const void* l_in,
              void* acc_out, void* m_out, void* l_out, int B, int Sq,
              int Skv, int H, float scale, cudaStream_t stream) {
  static bool configured = false;
  const Carry carry{static_cast<const float*>(acc_in),
                    static_cast<const float*>(m_in),
                    static_cast<const float*>(l_in),
                    static_cast<float*>(acc_out), static_cast<float*>(m_out),
                    static_cast<float*>(l_out)};
  return launch(flash_fwd_kernel<T, D, true>, &configured, fwd_smem(D),
                dim3(B * H, tiles(Sq)), stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const bool*>(mask), static_cast<T*>(nullptr),
                static_cast<float*>(nullptr), carry, Sq, Skv, H, scale);
}

template <typename T, int D>
int run_dkdv(const void* q, const void* k, const void* v, const void* mask,
             const void* dout, const void* lse, const void* delta, void* dk,
             void* dv, int B, int Sq, int Skv, int H, float scale,
             cudaStream_t stream) {
  static bool configured = false;
  return launch(flash_dkdv_kernel<T, D>, &configured, dkdv_smem(D),
                dim3(B * H, tiles(Skv)), stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const bool*>(mask), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), Sq, Skv, H, scale);
}

template <typename T, int D>
int run_dq(const void* q, const void* k, const void* v, const void* mask,
           const void* dout, const void* lse, const void* delta, void* dq,
           int B, int Sq, int Skv, int H, float scale, cudaStream_t stream) {
  static bool configured = false;
  return launch(flash_dq_kernel<T, D>, &configured, dq_smem(D),
                dim3(B * H, tiles(Sq)), stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const bool*>(mask), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
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
                   int B, int Sq, int Skv, int H, float scale,
                   void* stream) {
  BFLC_DISPATCH(run_fwd, q, k, v, mask, out, lse, B, Sq, Skv, H, scale,
                static_cast<cudaStream_t>(stream))
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
                     float scale, void* stream) {
  BFLC_DISPATCH(run_carry, q, k, v, mask, acc_in, m_in, l_in, acc_out, m_out,
                l_out, B, Sq, Skv, H, scale, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
