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
// between them, with the bucket in place of a radix digit:
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
//   B2b ct_pack_dest: one block per tile of the same TILE rows, one launch
//                     per round, the design of K1b's one-sweep pass
//                     (radix_pass.cu) without its look-back, since B2a's
//                     scanned histogram already gives each tile its start
//                     in every bucket. The tile is warp-striped: warp w
//                     owns rows [w * 512, w * 512 + 512), item k of lane l
//                     is row w * 512 + 32 k + l, so each item is one
//                     coalesced 128-byte load and a warp's items are in row
//                     order. A thread issues all ITEMS loads before it
//                     ranks any. Each warp then ranks its items in order
//                     with no block barrier: __match_any_sync gives the
//                     item's rows of each bucket; a row's rank is its
//                     bucket's running count in the warp's own [P] slice
//                     of shared memory plus its peers in lower lanes, and
//                     the group's last lane writes the count back, under
//                     __syncwarp only. That is one population count a
//                     row, the instruction the ranks are short of on this
//                     card (the warp-level multisplit of Ashkiani et al.
//                     2016, with its running counts in registers, needs
//                     two). After one __syncthreads each bucket's warp
//                     counts are scanned in warp order, seeded with the
//                     tile's start; after a second, every thread adds its
//                     warp's start to its ranks and writes its ITEMS
//                     slots, coalesced. Two block barriers per tile,
//                     stable by construction (no atomics).
//
// B3 replaces pallas_codec.py::fused_compact_move (_compact_kernel): the
// received [P * (bc + n_header), LM] int32 rows, chunk p holding c_p =
// clip(recv_p, 0, bc) live rows, become move[argsort(~mask, stable)] with
// live rows front-packed in (chunk, slot) order and dead rows behind them.
// The TPU kernel keeps the whole output in VMEM and writes overlapping
// windows masked; here the destinations are disjoint and computed directly:
// with ls_p = sum of c_q (q < p) and ds_p = sum(c) + p * bc - ls_p, live row
// j < c_p of chunk p goes to ls_p + j and dead row j >= c_p to ds_p + j - c_p.
// In elements a chunk is two contiguous runs, [0, c_p * LM) and the rest,
// each copied at a constant offset. A block owns a fixed window of one
// chunk, 16-byte aligned in the source, whose addresses depend on p, bc,
// n_header and LM alone: it issues its 16-byte loads first and reads the
// chunk counts while they are in flight (where they arrived: lane 0 of each
// chunk's header row, given a stride; one thread per chunk and a block
// reduction). A vector whose run keeps its alignment in the output (always
// when LM % 4 == 0) is stored in one 16-byte store, any other element alone;
// the window's ragged ends load and store element by element. So B3 is a
// copy with no size limit and no per-row index arithmetic, and the received
// buffer is never re-laid out.
//
// Bound on the H100: memory for all three. B2a reads the key words (8 bytes
// per key column per row, 4 more per nullable key) and writes the 4-byte pid
// lane; the murmur chain is some 30 integer operations per key and row,
// far below the integer rate. B2b reads the pid lane and writes dest. B3
// reads and writes every received int32 once. On the card B2b and B3 run
// at about 60% of that bound. B2b's grid is a single wave whose blocks
// load, rank and store in turn, so the memory idles while they rank.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                  // rows per thread and tile
constexpr int WARP_ROWS = 32 * ITEMS;      // 512: a warp's rows in a B2b tile
constexpr int TILE = THREADS * ITEMS;      // 4096 rows, must match ops/cuda_codec.py
constexpr int MAX_P = 1024;                // buckets a block's shared histogram holds
constexpr int P_PER_THREAD = MAX_P / THREADS;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned NO_PID = 0xFFFFFFFFu;   // dead rows in the warp match
constexpr unsigned DEAD = 0xFFFFu;         // dead rows' bucket in a packed rank
constexpr int COMPACT_THREADS = 128;
constexpr int VECS = 4;                    // int4 vectors a B3 thread moves
constexpr int WINDOW_VECS = COMPACT_THREADS * VECS;  // a B3 block's window: 8 KB

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
  for (int r = 0; r < ITEMS; ++r) {
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

// tile_base: [P * n_tiles] exclusive scan of hist along each bucket's tiles.
// Dynamic shared memory: WARPS * P int32.
__global__ void __launch_bounds__(THREADS)
pack_dest_kernel(const int32_t* __restrict__ pid, const int32_t* __restrict__ tile_base,
                 int32_t* __restrict__ dest, int64_t cap, int64_t n_tiles, int P,
                 int64_t round_lo, int64_t bc) {
  extern __shared__ int32_t wcnt[];  // [WARPS][P]: warp counts, then warp starts
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TILE + warp * WARP_ROWS + lane;
  int32_t* wc = wcnt + warp * P;
  for (int b = lane; b < P; b += 32) wc[b] = 0;

  // 1. every load of the thread in flight before any rank
  unsigned dr[ITEMS];  // the pid, then bucket << 16 | rank within the warp
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = row0 + 32 * k;
    dr[k] = i < cap ? static_cast<unsigned>(pid[i]) : NO_PID;
  }
  int32_t tb[P_PER_THREAD];  // the tile's first position in buckets t, t + THREADS, ...
#pragma unroll
  for (int u = 0; u < P_PER_THREAD; ++u) {
    const int b = t + u * THREADS;
    tb[u] = b < P ? tile_base[static_cast<int64_t>(b) * n_tiles + blockIdx.x] : 0;
  }
  __syncwarp();

  // 2. stable ranks within the warp, items in row order: every lane reads
  // its bucket's running count, the group's last lane writes it back
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const unsigned p = dr[k];
    const bool live = p < static_cast<unsigned>(P);
    const unsigned peers = __match_any_sync(FULL, live ? p : NO_PID);
    const int rank = __popc(peers & lower);
    const int before = live ? wc[p] : 0;
    __syncwarp();
    if (live && (peers >> lane) == 1u) wc[p] = before + rank + 1;
    __syncwarp();
    dr[k] = live ? (p << 16) | static_cast<unsigned>(before + rank) : (DEAD << 16);
  }
  __syncthreads();

  // 3. each bucket's warp counts -> warp starts, in warp order
#pragma unroll
  for (int u = 0; u < P_PER_THREAD; ++u) {
    const int b = t + u * THREADS;
    if (b < P) {
      int32_t run = tb[u];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int32_t c = wcnt[w * P + b];
        wcnt[w * P + b] = run;
        run += c;
      }
    }
  }
  __syncthreads();

  // 4. the slots, coalesced
  const int32_t sentinel = static_cast<int32_t>(static_cast<int64_t>(P) * bc);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = row0 + 32 * k;
    if (i < cap) {
      const unsigned p = dr[k] >> 16;
      int32_t out = sentinel;
      if (p != DEAD) {
        const int64_t slot = static_cast<int64_t>(wc[p] + static_cast<int>(dr[k] & 0xFFFFu)) - round_lo;
        if (slot >= 0 && slot < bc)
          out = static_cast<int32_t>(static_cast<int64_t>(p) * bc + slot);
      }
      dest[i] = out;
    }
  }
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// Element e of a vector (e a compile-time constant once unrolled).
__device__ __forceinline__ int32_t& elem(int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// grid (windows of a chunk, P): block (x, p) moves window x of chunk p. All
// element indices below are in the 16-byte grid of the aligned-down source
// (g = element index in src + sa) or output (o = element index in out + oa).
__global__ void __launch_bounds__(COMPACT_THREADS)
compact_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ counts,
               int64_t count_stride, int32_t* __restrict__ out, int P, int64_t bc,
               int64_t n_header, int64_t lm) {
  constexpr int NW = COMPACT_THREADS / 32;
  __shared__ int64_t red[2][NW];
  __shared__ int64_t s_c;
  const int p = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sa = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
  const int oa = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3u);
  const int32_t* src_al = src - sa;
  int32_t* out_al = out - oa;
  const int4* src4 = reinterpret_cast<const int4*>(src_al);
  int4* out4 = reinterpret_cast<int4*>(out_al);
  // chunk p's data rows, and this block's window of them
  const int64_t c0 = (static_cast<int64_t>(p) * (bc + n_header) + n_header) * lm + sa;
  const int64_t c1 = c0 + bc * lm;
  const int64_t v0 = c0 / 4 + static_cast<int64_t>(blockIdx.x) * WINDOW_VECS;
  const int64_t lo = c0 > 4 * v0 ? c0 : 4 * v0;
  const int64_t hi = c1 < 4 * (v0 + WINDOW_VECS) ? c1 : 4 * (v0 + WINDOW_VECS);
  if (lo >= hi) return;  // uniform over the block

  // 1. the loads: they do not depend on the counts
  int4 val[VECS];
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const int64_t g = 4 * (v0 + u * COMPACT_THREADS + t);
    if (g >= lo && g + 4 <= hi) {
      val[u] = src4[g >> 2];
    } else {
      val[u] = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + e >= lo && g + e < hi) elem(val[u], e) = src_al[g + e];
    }
  }

  // 2. the counts while the loads are in flight: ls_p, c_p and the total
  int64_t before = 0, total = 0;
  for (int q = t; q < P; q += COMPACT_THREADS) {
    int64_t cq = counts[static_cast<int64_t>(q) * count_stride];
    cq = cq < 0 ? 0 : (cq > bc ? bc : cq);
    total += cq;
    if (q < p) before += cq;
    if (q == p) s_c = cq;
  }
  before = warp_sum(before);
  total = warp_sum(total);
  if (lane == 0) {
    red[0][warp] = before;
    red[1][warp] = total;
  }
  __syncthreads();
  int64_t ls = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    ls += red[0][w];
    all += red[1][w];
  }
  const int64_t c = s_c;
  const int64_t ds = all + static_cast<int64_t>(p) * bc - ls;
  // run 1 (live rows) is [c0, split), run 2 (dead rows) [split, c1); each
  // moves by a constant: o = g + shift
  const int64_t split = c0 + c * lm;
  const int64_t shift1 = ls * lm - c0 + oa;
  const int64_t shift2 = (ds - c) * lm - c0 + oa;

  // 3. the stores: 16 bytes where the run keeps its alignment
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const int64_t g = 4 * (v0 + u * COMPACT_THREADS + t);
    if (g >= lo && g + 4 <= hi && (g + 4 <= split || g >= split)) {
      const int64_t shift = g < split ? shift1 : shift2;
      if ((shift & 3) == 0) {
        out4[(g + shift) >> 2] = val[u];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) out_al[g + e + shift] = elem(val[u], e);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + e >= lo && g + e < hi)
          out_al[g + e + (g + e < split ? shift1 : shift2)] = elem(val[u], e);
    }
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
  const size_t smem = static_cast<size_t>(WARPS) * P * sizeof(int32_t);
  pack_dest_kernel<<<static_cast<unsigned>(n_tiles), THREADS, smem, s>>>(
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(tile_base),
      static_cast<int32_t*>(dest), cap, n_tiles, static_cast<int>(P), round_idx * bc, bc);
  return static_cast<int>(cudaGetLastError());
}

// B3. src: int32 [P * (bc + n_header), lm]; counts[q * count_stride] is
// chunk q's received count; out: int32 [P * bc, lm].
extern "C" int ct_compact_move(const void* src, const void* counts,
                               int64_t count_stride, void* out, int64_t P,
                               int64_t bc, int64_t n_header, int64_t lm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a chunk's window grid starts at its first element's 16-byte line: up to
  // 3 elements before the chunk share its first window
  const int64_t per_window = 4 * static_cast<int64_t>(WINDOW_VECS);
  const dim3 grid(static_cast<unsigned>((bc * lm + 3 + per_window - 1) / per_window),
                  static_cast<unsigned>(P));
  compact_kernel<<<grid, COMPACT_THREADS, 0, s>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(counts),
      count_stride, static_cast<int32_t*>(out), static_cast<int>(P), bc, n_header, lm);
  return static_cast<int>(cudaGetLastError());
}
