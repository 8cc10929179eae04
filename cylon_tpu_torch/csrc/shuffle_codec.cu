// The chunked hash shuffle's codec kernels: the fused pack (kernel B2) and
// the fused compact (kernel B3).
//
// B2 replaces cylon_tpu/ops/pallas_codec.py::fused_pack_dest (_pack_kernel):
// per row, the murmur3 chain of ops/hash.py over the key columns' two words
// (or a given partition-id lane), the partition id (h & (P-1) for a
// power-of-two P, h % P otherwise), the row's stable rank within its bucket,
// and round r's send slot dest = pid * bc + (pos - r * bc), or the sentinel
// P * bc for rows of other rounds, dead rows and rows at or past n.
// The Pallas kernel carries a running histogram across a sequential grid; a
// CUDA grid runs its blocks in no order, so B2 takes two kernels and a scan
// between them, the design the radix pass K1 had before its one-sweep
// rewrite, with the bucket in place of the digit:
//
//   B2a ct_pack_hist: one block per TILE rows hashes them, writes the int32
//                     partition-id lane (dead rows: P) and the tile's
//                     per-bucket counts BUCKET-MAJOR, hist[b * n_tiles + t].
//                     It depends neither on bc nor on r: one launch per
//                     table and shuffle, whose bucket totals are the count
//                     phase's send counts.
//   (the caller)      an exclusive scan of hist along the tiles of each
//                     bucket (torch.cumsum): every tile's first position
//                     within each bucket.
//   B2b ct_pack_dest: the same tile, 256 rows per round in row order; each
//                     warp groups its lanes by bucket with __match_any_sync,
//                     the per-warp bucket counts are scanned across the
//                     block's warps in shared memory, a running per-bucket
//                     base carries from round to round. The rank is stable
//                     by construction (no atomics). One launch per round.
//
// B3 replaces pallas_codec.py::fused_compact_move (_compact_kernel): the
// received [P * (bc + n_header), LM] int32 rows, chunk p holding c_p =
// clip(recv_p, 0, bc) live rows, become move[argsort(~mask, stable)] with
// live rows front-packed in (chunk, slot) order and dead rows behind them.
// The TPU kernel keeps the whole output in VMEM and writes overlapping
// windows masked; here the destinations are disjoint and computed directly:
// with ls_p = sum of c_q (q < p) and ds_p = sum(c) + p * bc - ls_p, live row
// j < c_p of chunk p goes to ls_p + j and dead row j >= c_p to ds_p + j - c_p.
// So B3 is a row copy with no size limit. It reads the chunk counts where
// they arrived (lane 0 of each chunk's header row, given a stride) and
// skips the header rows, so the received buffer is never re-laid out.
//
// Bound on the H100: memory for all three. B2a reads the key words (8 bytes
// per key column per row, 4 more per nullable key) and writes the 4-byte pid
// lane; the murmur chain is some 30 integer operations per key and row,
// far below the integer rate. B2b reads the pid lane and writes dest. B3
// reads and writes every received int32 once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 16;                 // rounds of THREADS rows per tile
constexpr int TILE = THREADS * ROUNDS;     // 4096 rows, must match ops/cuda_codec.py
constexpr int MAX_P = 1024;                // buckets a block's shared histogram holds
constexpr unsigned NO_PID = 0xFFFFFFFFu;   // dead rows in the warp match

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// one murmur3_x86_32 body round (ops/hash.py mix_word)
__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// words: [2 * n_key, cap] (lo, hi) per key column; valids: [nv, cap], one
// row per key column whose bit is set in valid_mask, in column order
__global__ void __launch_bounds__(THREADS)
pack_hist_kernel(const uint32_t* __restrict__ words, int n_key,
                 const int32_t* __restrict__ valids, int64_t valid_mask,
                 const int32_t* __restrict__ pid_in, int32_t* __restrict__ pid_out,
                 int32_t* __restrict__ hist, int64_t cap, int64_t n,
                 int64_t n_tiles, int P) {
  __shared__ int32_t h[MAX_P];
  for (int b = threadIdx.x; b < P; b += THREADS) h[b] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
  const bool pow2 = (P & (P - 1)) == 0;
  for (int r = 0; r < ROUNDS; ++r) {
    const int64_t i = base + static_cast<int64_t>(r) * THREADS + threadIdx.x;
    if (i >= cap) continue;
    int32_t p = P;
    if (i < n) {
      if (pid_in != nullptr) {
        p = pid_in[i];
        if (p < 0 || p > P) p = P;
      } else {
        uint32_t hh = 0u;
        int vi = 0;
        for (int c = 0; c < n_key; ++c) {
          uint32_t hc = mix_word(0u, words[(2 * c) * cap + i]);
          hc = mix_word(hc, words[(2 * c + 1) * cap + i]);
          hc = fmix32(hc ^ 8u);  // length footer: 4 bytes x 2 words
          if ((valid_mask >> c) & 1) {
            if (valids[vi * cap + i] == 0) hc = 0u;  // nulls hash to 0
            ++vi;
          }
          hh = c == 0 ? hc : hh * 31u + hc;
        }
        p = pow2 ? static_cast<int32_t>(hh & static_cast<uint32_t>(P - 1))
                 : static_cast<int32_t>(hh % static_cast<uint32_t>(P));
      }
    }
    pid_out[i] = p;
    if (p < P) atomicAdd(&h[p], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < P; b += THREADS)
    hist[static_cast<int64_t>(b) * n_tiles + blockIdx.x] = h[b];
}

// base: [P * n_tiles] exclusive scan of hist along each bucket's tiles.
// Dynamic shared memory: P + WARPS * P int32.
__global__ void __launch_bounds__(THREADS)
pack_dest_kernel(const int32_t* __restrict__ pid, const int32_t* __restrict__ tile_base,
                 int32_t* __restrict__ dest, int64_t cap, int64_t n_tiles, int P,
                 int64_t round_lo, int64_t bc) {
  extern __shared__ int32_t smem[];
  int32_t* base = smem;        // [P] next position within each bucket
  int32_t* wdst = smem + P;    // [WARPS][P] per-warp count, then per-warp start
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int32_t sentinel = static_cast<int32_t>(static_cast<int64_t>(P) * bc);
  for (int b = threadIdx.x; b < P; b += THREADS)
    base[b] = tile_base[static_cast<int64_t>(b) * n_tiles + blockIdx.x];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * TILE;
  for (int r = 0; r < ROUNDS; ++r) {
    for (int k = threadIdx.x; k < WARPS * P; k += THREADS) wdst[k] = 0;
    __syncthreads();
    // rows of this round in (warp, lane) order == row order
    const int64_t i = tile0 + static_cast<int64_t>(r) * THREADS + threadIdx.x;
    unsigned d = NO_PID;
    if (i < cap) {
      const int32_t p = pid[i];
      if (p >= 0 && p < P) d = static_cast<unsigned>(p);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int rank = __popc(peers & lower);
    if (d != NO_PID && rank == 0) wdst[warp * P + d] = __popc(peers);
    __syncthreads();
    for (int b = threadIdx.x; b < P; b += THREADS) {  // scan bucket b over warps
      int32_t run = base[b];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int32_t c = wdst[w * P + b];
        wdst[w * P + b] = run;
        run += c;
      }
      base[b] = run;
    }
    __syncthreads();
    if (i < cap) {
      int32_t out = sentinel;
      if (d != NO_PID) {
        const int64_t slot = static_cast<int64_t>(wdst[warp * P + d] + rank) - round_lo;
        if (slot >= 0 && slot < bc)
          out = static_cast<int32_t>(static_cast<int64_t>(d) * bc + slot);
      }
      dest[i] = out;
    }
    __syncthreads();
  }
}

// grid (row blocks of a chunk, P): block (x, p) copies rows
// [x * rows_per_block, ...) of chunk p to their front-packed places
__global__ void __launch_bounds__(THREADS)
compact_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ counts,
               int64_t count_stride, int32_t* __restrict__ out, int P, int64_t bc,
               int64_t n_header, int lm, int rows_per_block) {
  __shared__ int64_t s_ls, s_ds, s_c;
  const int p = blockIdx.y;
  if (threadIdx.x == 0) {
    int64_t ls = 0, total = 0, c = 0;
    for (int q = 0; q < P; ++q) {
      int64_t cq = counts[static_cast<int64_t>(q) * count_stride];
      cq = cq < 0 ? 0 : (cq > bc ? bc : cq);
      if (q < p) ls += cq;
      if (q == p) c = cq;
      total += cq;
    }
    s_ls = ls;
    s_c = c;
    s_ds = total + static_cast<int64_t>(p) * bc - ls;
  }
  __syncthreads();
  const int64_t ls = s_ls, ds = s_ds, c = s_c;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  if (j0 >= bc) return;
  const int64_t rows = (bc - j0) < rows_per_block ? (bc - j0) : rows_per_block;
  const int elems = static_cast<int>(rows) * lm;
  const int32_t* chunk =
      src + (static_cast<int64_t>(p) * (bc + n_header) + n_header + j0) * lm;
  for (int k = threadIdx.x; k < elems; k += THREADS) {
    const int jj = k / lm;
    const int l = k - jj * lm;
    const int64_t j = j0 + jj;
    const int64_t to = j < c ? ls + j : ds + j - c;
    out[to * lm + l] = chunk[k];
  }
}

}  // namespace

extern "C" int ct_codec_tile() { return TILE; }
extern "C" int ct_codec_max_partitions() { return MAX_P; }

// B2a. pid_in == nullptr selects hash mode (words/valids), else pid-input
// mode. pid_out: int32 [cap]; hist: int32 [P * n_tiles], bucket-major.
extern "C" int ct_pack_hist(const void* words, int64_t n_key, const void* valids,
                            int64_t valid_mask, const void* pid_in, void* pid_out,
                            void* hist, int64_t cap, int64_t n, int64_t n_tiles,
                            int64_t P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_hist_kernel<<<static_cast<unsigned>(n_tiles), THREADS, 0, s>>>(
      static_cast<const uint32_t*>(words), static_cast<int>(n_key),
      static_cast<const int32_t*>(valids), valid_mask,
      static_cast<const int32_t*>(pid_in), static_cast<int32_t*>(pid_out),
      static_cast<int32_t*>(hist), cap, n, n_tiles, static_cast<int>(P));
  return static_cast<int>(cudaGetLastError());
}

// B2b. tile_base: int32 [P * n_tiles]; dest: int32 [cap].
extern "C" int ct_pack_dest(const void* pid, const void* tile_base, void* dest,
                            int64_t cap, int64_t n_tiles, int64_t P,
                            int64_t round_idx, int64_t bc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(P) * (1 + WARPS) * sizeof(int32_t);
  pack_dest_kernel<<<static_cast<unsigned>(n_tiles), THREADS, smem, s>>>(
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(tile_base),
      static_cast<int32_t*>(dest), cap, n_tiles, static_cast<int>(P),
      round_idx * bc, bc);
  return static_cast<int>(cudaGetLastError());
}

// B3. src: int32 [P * (bc + n_header), lm]; counts[q * count_stride] is
// chunk q's received count; out: int32 [P * bc, lm].
extern "C" int ct_compact_move(const void* src, const void* counts,
                               int64_t count_stride, void* out, int64_t P,
                               int64_t bc, int64_t n_header, int64_t lm,
                               int64_t rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((bc + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>(P));
  compact_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(counts),
      count_stride, static_cast<int32_t*>(out), static_cast<int>(P), bc, n_header,
      static_cast<int>(lm), static_cast<int>(rows_per_block));
  return static_cast<int>(cudaGetLastError());
}
