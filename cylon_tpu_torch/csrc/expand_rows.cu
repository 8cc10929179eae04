// Windowed expand (kernel K2): out[l, k] = srcT[l, clamp(li[k], 0, cap - 1)].
//
// Replaces cylon_tpu/ops/pallas_gather.py::expand_rows_raw (its
// _expand_kernel / _expand_kernel_db and the four CYLON_TPU_EXPAND_GATHER
// variants, which were TPU workarounds for Mosaic's gather limits). The join's
// left emit indices are repeat(arange(m), counts) with every count >= 1:
// non-decreasing with step <= 1, so the OUT_TILE outputs of one block read at
// most OUT_TILE consecutive source columns. Each block stages that window of
// srcT in shared memory, LANE_CHUNK lanes at a time (any number of lanes L
// fits), with coalesced reads, then writes its outputs lane by lane with
// coalesced stores. An index outside the window (a caller that breaks the
// step contract) is read from global memory instead, so the kernel equals the
// plain srcT[:, clamp(li)] for every input, not only for contract inputs.
//
// Bound on the H100: memory. It reads L x (window columns) int32 of the
// source and li once, and writes L x n_out int32; there is no arithmetic to
// speak of.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int OUT_TILE = 1024;            // outputs per block == window width
constexpr int PER_THREAD = OUT_TILE / THREADS;
constexpr int LANE_CHUNK = 8;             // lanes staged at once: 32 KB smem

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t clamp_col(int64_t v, int64_t cap) {
  return v < 0 ? 0 : (v > cap - 1 ? cap - 1 : v);
}

__global__ void __launch_bounds__(THREADS)
expand_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ li,
              int32_t* __restrict__ out, int64_t L, int64_t cap, int64_t n_out) {
  __shared__ int32_t win[LANE_CHUNK][OUT_TILE];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * OUT_TILE;
  const int64_t cnt = lmin(OUT_TILE, n_out - t0);
  const int64_t w0 = clamp_col(li[t0], cap);
  const int64_t wlen = lmin(OUT_TILE, cap - w0);

  int64_t col[PER_THREAD];   // clamped source column of each of my outputs
  bool staged[PER_THREAD];   // inside the shared window?
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int64_t k = threadIdx.x + static_cast<int64_t>(j) * THREADS;
    int64_t c = 0;
    if (k < cnt) c = clamp_col(li[t0 + k], cap);
    col[j] = c;
    staged[j] = c >= w0 && c < w0 + wlen;
  }

  for (int64_t l0 = 0; l0 < L; l0 += LANE_CHUNK) {
    const int lc = static_cast<int>(lmin(LANE_CHUNK, L - l0));
    for (int l = 0; l < lc; ++l) {
      const int32_t* row = src + (l0 + l) * cap + w0;
      for (int64_t c = threadIdx.x; c < wlen; c += THREADS) win[l][c] = row[c];
    }
    __syncthreads();
    for (int l = 0; l < lc; ++l) {
      int32_t* orow = out + (l0 + l) * n_out + t0;
      const int32_t* srow = src + (l0 + l) * cap;
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int64_t k = threadIdx.x + static_cast<int64_t>(j) * THREADS;
        if (k < cnt) orow[k] = staged[j] ? win[l][col[j] - w0] : srow[col[j]];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ct_expand_out_tile() { return OUT_TILE; }

// src: int32 [L, cap] row-major; li: int32 [n_out]; out: int32 [L, n_out].
// Requires cap >= 1 and n_out >= 1 (the wrapper skips empty launches).
extern "C" int ct_expand_rows(const void* src, const void* li, void* out,
                              int64_t L, int64_t cap, int64_t n_out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n_out + OUT_TILE - 1) / OUT_TILE;
  expand_kernel<<<dim3(static_cast<unsigned>(blocks)), THREADS, 0, s>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(li),
      static_cast<int32_t*>(out), L, cap, n_out);
  return static_cast<int>(cudaGetLastError());
}
