// One stable 8-bit LSD radix pass that carries a permutation (kernel K1).
//
// Replaces cylon_tpu/ops/pallas_radix.py::radix_pass_pallas: its _hist_kernel
// (K1a, per-tile digit histogram) and its _pos_kernel plus the XLA scatter
// after it (K1b, stable destination of every row). Given a digit lane `enc`
// (uint32 or uint64 bit patterns), the carried permutation `perm_in`, and the
// digit [shift, shift + bits), bits <= 8, the pass writes `perm_out` so that
// enc[perm_out] is stably sorted by the digit.
//
//   K1a ct_radix_hist:    one block per TILE rows reads enc[perm_in[i]] and
//                         counts its digits with shared-memory atomics; the
//                         256 counts go out BUCKET-MAJOR, hist[b * n_tiles + t],
//                         so one exclusive scan over the flat array (done by
//                         the caller) is every (bucket, tile) start offset.
//   K1b ct_radix_scatter: the same tile, 256 rows per round in row order.
//                         Each warp groups its lanes by digit with
//                         __match_any_sync; a row's rank is the count of
//                         lower lanes with its digit, the per-warp digit counts
//                         are scanned across the block's warps in shared
//                         memory, and a running per-digit base carries from
//                         round to round. Ranks never come from atomics, so
//                         the order is stable by construction, and the row
//                         is written straight to perm_out[offset + rank]
//                         (Mosaic could not scatter from VMEM; CUDA can).
//
// Bound on the H100: memory. A pass moves perm_in and enc (read through the
// permutation, a random gather) in both kernels and writes perm_out once;
// the histogram and offsets are 1 KB per tile. Arithmetic is a few integer
// ops per row. The ragged last tile is masked; no size is required to be a
// multiple of TILE.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 16;                 // rounds of THREADS rows per tile
constexpr int TILE = THREADS * ROUNDS;     // 4096 rows, must match ops/cuda_radix.py
constexpr int RADIX = 256;
constexpr unsigned NO_DIGIT = 0xFFFFFFFFu; // rows past the end
static_assert(THREADS == RADIX, "the cross-warp scan gives each thread one digit");

template <typename K>
__device__ __forceinline__ unsigned digit_at(const K* enc, int32_t p, int shift,
                                             unsigned mask) {
  return static_cast<unsigned>((enc[p] >> shift) & static_cast<K>(mask));
}

template <typename K>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const K* __restrict__ enc, const int32_t* __restrict__ perm,
            int32_t* __restrict__ hist, int64_t n, int64_t n_tiles, int shift,
            unsigned mask) {
  __shared__ int32_t h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
#pragma unroll 4
  for (int r = 0; r < ROUNDS; ++r) {
    const int64_t i = base + static_cast<int64_t>(r) * THREADS + threadIdx.x;
    if (i < n) atomicAdd(&h[digit_at(enc, perm[i], shift, mask)], 1);
  }
  __syncthreads();
  hist[static_cast<int64_t>(threadIdx.x) * n_tiles + blockIdx.x] = h[threadIdx.x];
}

template <typename K>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const K* __restrict__ enc, const int32_t* __restrict__ perm_in,
               const int32_t* __restrict__ offs, int32_t* __restrict__ perm_out,
               int64_t n, int64_t n_tiles, int shift, unsigned mask) {
  __shared__ int32_t base[RADIX];           // next destination of each digit
  __shared__ int32_t wdst[WARPS][RADIX];    // per-warp count, then per-warp start
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  base[threadIdx.x] =
      offs[static_cast<int64_t>(threadIdx.x) * n_tiles + blockIdx.x];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * TILE;
  for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) wdst[w][threadIdx.x] = 0;
    __syncthreads();
    // rows of this round in (warp, lane) order == row order
    const int64_t i = tile0 + static_cast<int64_t>(r) * THREADS + threadIdx.x;
    unsigned d = NO_DIGIT;
    int32_t p = 0;
    if (i < n) {
      p = perm_in[i];
      d = digit_at(enc, p, shift, mask);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int rank = __popc(peers & lower);
    if (d != NO_DIGIT && rank == 0) wdst[warp][d] = __popc(peers);
    __syncthreads();
    {  // thread t scans digit t across the warps, in warp order
      int32_t run = base[threadIdx.x];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int32_t c = wdst[w][threadIdx.x];
        wdst[w][threadIdx.x] = run;
        run += c;
      }
      base[threadIdx.x] = run;
    }
    __syncthreads();
    if (d != NO_DIGIT) perm_out[wdst[warp][d] + rank] = p;
    __syncthreads();
  }
}

inline unsigned digit_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

}  // namespace

extern "C" int ct_radix_tile() { return TILE; }

// hist: int32 [RADIX * n_tiles], bucket-major. enc_bytes: 4 or 8.
extern "C" int ct_radix_hist(const void* enc, int64_t enc_bytes,
                             const void* perm, void* hist, int64_t n,
                             int64_t n_tiles, int64_t shift, int64_t bits,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned mask = digit_mask(static_cast<int>(bits));
  const dim3 grid(static_cast<unsigned>(n_tiles));
  if (enc_bytes == 8) {
    hist_kernel<unsigned long long><<<grid, THREADS, 0, s>>>(
        static_cast<const unsigned long long*>(enc),
        static_cast<const int32_t*>(perm), static_cast<int32_t*>(hist), n,
        n_tiles, static_cast<int>(shift), mask);
  } else {
    hist_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint32_t*>(enc), static_cast<const int32_t*>(perm),
        static_cast<int32_t*>(hist), n, n_tiles, static_cast<int>(shift), mask);
  }
  return static_cast<int>(cudaGetLastError());
}

// offs: int32 [RADIX * n_tiles], the exclusive scan of hist.
extern "C" int ct_radix_scatter(const void* enc, int64_t enc_bytes,
                                const void* perm_in, const void* offs,
                                void* perm_out, int64_t n, int64_t n_tiles,
                                int64_t shift, int64_t bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned mask = digit_mask(static_cast<int>(bits));
  const dim3 grid(static_cast<unsigned>(n_tiles));
  if (enc_bytes == 8) {
    scatter_kernel<unsigned long long><<<grid, THREADS, 0, s>>>(
        static_cast<const unsigned long long*>(enc),
        static_cast<const int32_t*>(perm_in), static_cast<const int32_t*>(offs),
        static_cast<int32_t*>(perm_out), n, n_tiles, static_cast<int>(shift),
        mask);
  } else {
    scatter_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint32_t*>(enc), static_cast<const int32_t*>(perm_in),
        static_cast<const int32_t*>(offs), static_cast<int32_t*>(perm_out), n,
        n_tiles, static_cast<int>(shift), mask);
  }
  return static_cast<int>(cudaGetLastError());
}
