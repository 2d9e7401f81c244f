// Payload fingerprints for Hopper (sm_90a): the 32-byte ids the mesh round
// records on the ledger.
//
// Replaces the XLA program of bflc_demo_tpu/ops/fingerprint.py —
//   fingerprint_kernel <- fingerprint_pytree (:62-93) and, one block per
//                         stacked slice, fingerprint_stacked (:96-99)
// and computes what it computes (the plain PyTorch version is
// ../fingerprint.py:fingerprint_plain), bit for bit.  Per lane j of 8:
//
//   h = 2166136261
//   for each leaf i, in the reference's tree order:
//       h ^= salt_i                       (leaf index and row count)
//       h = h * P ^ s   for each static salt s (dtype, then each dim)
//       h = h * P ^ w[r * 8 + j]   for every row r of the leaf's words,
//                                  zero-padded to a multiple of 8
//   twice: h_j = h_j * P ^ h_{j-1 mod 8}      (the final mix)
//
// with P = 16777619 and uint32 arithmetic.  The salts depend only on the
// tree's structure; the wrapper computes them on the host and passes them
// in the leaf table.
//
// What bounds it: each lane is ONE dependent chain, a multiply and an xor
// per row (config 5's model: 67,073 rows), so the floor is the chain's
// latency, not bytes — 20 deltas x 2.1 MB would take ~13 us at 3.35 TB/s.
// The design keeps the chain fed and does nothing else on it:
//   * one block per candidate; threads 0-7 own the 8 lanes' chains;
//   * all 256 threads of the block stage the next tile of 512 rows (16 KB
//     of words, widened from 1-, 2- or 4-byte elements) into the other
//     half of a two-tile ring in shared memory while the 8 chain threads
//     walk the current tile — the loads are issued before the chain and
//     land during it;
//   * the chain reads shared memory, which does not depend on h, so the
//     unrolled loop issues those reads ahead of the multiply-xor chain;
//   * every leaf of the tree is walked inside the one launch, from a
//     device table of (pointer, candidate stride, word count, element
//     size, salts), so a round's ids cost two launches, not one per leaf;
//   * the final mix shuffles within the 8 chain lanes (`__shfl_sync` with
//     width 8 is jnp.roll(h, 1)).
// The chain's own latency is measured by `bflc_fnv_chain` below: one
// thread running the same multiply-xor step.
//
// Plain C interface, loaded with ctypes (../build.py).  Each entry returns
// cudaGetLastError() after its launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kPrime = 16777619u;
constexpr unsigned kOffset = 2166136261u;
constexpr int kLanes = 8;
constexpr int kThreads = 256;
constexpr int kTileRows = 512;
constexpr int kTileWords = kTileRows * kLanes;
constexpr int kPerThread = kTileWords / kThreads;

// One leaf of the tree; layout mirrored by ../fingerprint.py:_LEAF_DTYPE.
struct LeafDesc {
  const unsigned char* base;   // candidate 0's first byte
  long long stride;            // bytes from one candidate's leaf to the next
  long long n_words;           // uint32 words per candidate, before padding
  int esize;                   // bytes of the element one word widens (1/2/4)
  int salt_off;                // salts[salt_off]: the leaf's xor salt
  int n_mx;                    // then this many multiply-xor salts
  int unused;
};

__device__ __forceinline__ unsigned load_word(const unsigned char* p,
                                              int esize, long long w) {
  // sub-32-bit elements widen after a bitcast (int8 -1 -> 255); 64-bit
  // leaves arrive as twice the words at esize 4, low word first
  if (esize == 4) return reinterpret_cast<const unsigned*>(p)[w];
  if (esize == 2) return reinterpret_cast<const unsigned short*>(p)[w];
  return p[w];
}

__global__ void __launch_bounds__(kThreads)
fingerprint_kernel(const LeafDesc* __restrict__ leaves, int n_leaves,
                   const unsigned* __restrict__ salts,
                   long long* __restrict__ out) {
  __shared__ unsigned tile[2][kTileWords];
  const int tid = threadIdx.x;
  const bool chain = tid < kLanes;
  const long long cand = blockIdx.x;
  unsigned h = kOffset;

  for (int li = 0; li < n_leaves; ++li) {
    const LeafDesc leaf = leaves[li];
    const unsigned char* p = leaf.base + cand * leaf.stride;
    const long long rows = (leaf.n_words + kLanes - 1) / kLanes;
    if (chain) {
      h ^= salts[leaf.salt_off];
      for (int s = 0; s < leaf.n_mx; ++s)
        h = h * kPrime ^ salts[leaf.salt_off + 1 + s];
    }
    const long long n_tiles = (rows + kTileRows - 1) / kTileRows;
    if (n_tiles == 0) continue;

    unsigned staged[kPerThread];
    auto fetch = [&](long long t) {
      const long long w0 = t * kTileWords + tid;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const long long w = w0 + k * kThreads;
        staged[k] = w < leaf.n_words ? load_word(p, leaf.esize, w) : 0u;
      }
    };
    auto store = [&](int half) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        tile[half][tid + k * kThreads] = staged[k];
    };

    fetch(0);                   // the previous leaf ended on a barrier
    store(0);
    __syncthreads();
    for (long long t = 0; t < n_tiles; ++t) {
      const bool more = t + 1 < n_tiles;
      if (more) fetch(t + 1);   // in flight while the chain runs
      if (chain) {
        const unsigned* cur = tile[t & 1];
        const int n = static_cast<int>(
            rows - t * kTileRows < kTileRows ? rows - t * kTileRows
                                             : kTileRows);
        int r = 0;
        for (; r + 16 <= n; r += 16) {
#pragma unroll
          for (int u = 0; u < 16; ++u)
            h = h * kPrime ^ cur[(r + u) * kLanes + tid];
        }
        for (; r < n; ++r) h = h * kPrime ^ cur[r * kLanes + tid];
      }
      if (more) store((t + 1) & 1);
      __syncthreads();
    }
  }

  if (chain) {
    for (int round = 0; round < 2; ++round) {
      const unsigned prev =
          __shfl_sync(0xFFu, h, (tid + kLanes - 1) % kLanes, kLanes);
      h = h * kPrime ^ prev;
    }
    out[cand * kLanes + tid] = static_cast<long long>(h);
  }
}

// The latency of one step of the chain: a single thread runs `steps`
// dependent multiply-xor steps (the xor operand varies, so nothing folds)
// and reports its clock cycles.
__global__ void fnv_chain_kernel(unsigned seed, long long steps,
                                 unsigned* out, long long* cycles) {
  unsigned h = seed;
  const unsigned x = seed * 2654435761u;
  const long long t0 = clock64();
#pragma unroll 16
  for (long long i = 0; i < steps; ++i)
    h = h * kPrime ^ (x + static_cast<unsigned>(i));
  const long long t1 = clock64();
  out[0] = h;
  cycles[0] = t1 - t0;
}

}  // namespace

extern "C" {

int bflc_fingerprint(const void* leaves, int n_leaves, const void* salts,
                     int n_cand, void* out, void* stream) {
  if (n_cand > 0) {
    fingerprint_kernel<<<n_cand, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const LeafDesc*>(leaves), n_leaves,
        static_cast<const unsigned*>(salts), static_cast<long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int bflc_fnv_chain(unsigned seed, long long steps, void* out, void* cycles,
                   void* stream) {
  fnv_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, steps, static_cast<unsigned*>(out),
      static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

int bflc_fingerprint_leaf_desc_size() {
  return static_cast<int>(sizeof(LeafDesc));
}

}  // extern "C"
