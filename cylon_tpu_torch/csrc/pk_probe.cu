// PK-FK bucket probe (kernel B5): for every left slot of every hash bucket,
// the largest live right row id whose key equals the slot's key, else -1.
//
// Replaces cylon_tpu/ops/pallas_join.py::_pallas_probe (its _probe_block
// kernel). Both sides arrive bucketed by ops/pk_join.bucket_layout: nb
// buckets of B slots, keys as int32 bit patterns (narrow and unsigned keys
// mapped injectively, so equality is kept), right row ids int32 with -1 on an
// empty slot. An empty right slot never matches, whatever its key; with
// duplicate right keys the largest id wins, as the Pallas kernel's row max.
//
// Design: one block per bucket. Each thread owns one left slot (a
// block-stride loop covers B > blockDim) and keeps its running max in a
// register. The bucket's right (key, id) pairs are staged in shared memory
// interleaved, CHUNK pairs at a time, so any B works (8192 included); every
// thread of a warp then reads the same pair in step (a broadcast, no bank
// conflict) with one 8-byte load per compare.
//
// Bound on the H100, at the main path's shape (8M = 8,000,000 rows a side,
// B = 256, nb = 65536): the function moves 16 * nb * B = 268 MB (left key,
// right key, right id in; result out), 0.080 ms at 3.35 TB/s. A per-bucket
// hash table in shared memory, max on insert, answers each left slot in
// about one probe, so the function is bound by bytes. This kernel instead
// compares all nb * B * B = 4.29e9 slot pairs; the live ones alone,
// 256 * 8M = 2.048e9, take 0.122 ms at the card's 32-bit integer rate
// (132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7e12 per s). The hash table is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int CHUNK = 2048;  // right (key, id) pairs staged at once: 16 KB

__global__ void __launch_bounds__(MAX_THREADS)
probe_kernel(const int32_t* __restrict__ lk, const int32_t* __restrict__ rk,
             const int32_t* __restrict__ rid, int32_t* __restrict__ out,
             int64_t B) {
  __shared__ int2 pairs[CHUNK];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * B;
  for (int64_t l0 = 0; l0 < B; l0 += blockDim.x) {
    const int64_t i = l0 + threadIdx.x;
    const bool mine = i < B;
    const int32_t key = mine ? lk[base + i] : 0;
    int32_t best = -1;  // ids > best are live (>= 0); -1 and below never win
    for (int64_t r0 = 0; r0 < B; r0 += CHUNK) {
      const int n = static_cast<int>(B - r0 < CHUNK ? B - r0 : CHUNK);
      __syncthreads();  // the previous chunk is read by every thread
      for (int j = threadIdx.x; j < n; j += blockDim.x)
        pairs[j] = make_int2(rk[base + r0 + j], rid[base + r0 + j]);
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const int2 p = pairs[j];
        if (p.x == key && p.y > best) best = p.y;
      }
    }
    if (mine) out[base + i] = best;
  }
}

}  // namespace

// lk, rk, rid, out: int32 [nb * B]. Requires nb >= 1 and B >= 1 (the wrapper
// checks).
extern "C" int ct_pk_probe(const void* lk, const void* rk, const void* rid,
                           void* out, int64_t nb, int64_t B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t warps = (B + 31) / 32;
  const int threads = static_cast<int>(warps * 32 < MAX_THREADS ? warps * 32 : MAX_THREADS);
  probe_kernel<<<dim3(static_cast<unsigned>(nb)), threads, 0, s>>>(
      static_cast<const int32_t*>(lk), static_cast<const int32_t*>(rk),
      static_cast<const int32_t*>(rid), static_cast<int32_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}
