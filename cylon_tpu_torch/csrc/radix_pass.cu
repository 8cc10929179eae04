// Stable LSD radix sort of one digit lane, carrying its keys and a
// permutation (kernel K1): one histogram launch per lane (K1a) and one
// one-sweep launch per 8-bit digit (K1b).
//
// Replaces cylon_tpu/ops/pallas_radix.py::radix_pass_pallas: its
// _hist_kernel (K1a, per-tile digit histogram) and its _pos_kernel plus the
// XLA scatter after it (K1b, each row's stable destination). The lane holds
// uint32 or uint64 bit patterns; the sort covers the bits [lo, hi) in 8-bit
// digits, the last one possibly narrower. After pass p the keys are stably
// sorted by digits 0..p, and the permutation moves with them, so the caller
// gets both the sorted lane and the stable argsort.
//
//   K1a ct_radix_lane_hist: a grid-stride read of the lane counts EVERY
//        digit of every pass in one go (shared-memory histograms of
//        passes x 256 bins, then one global atomicAdd per bin and block).
//        Digit counts do not depend on the row order, so one read serves
//        all passes.
//   K1b ct_radix_onesweep: one launch per digit. A block takes the next tile
//        of TILE rows from an atomic counter (so every tile it waits on
//        has started: the look-back cannot deadlock), loads keys and perm
//        coalesced in warp-striped order (warp w holds rows
//        [w * 512, (w + 1) * 512) of the tile, item i of lane l is row
//        w * 512 + i * 32 + l), and ranks them within the warp in row order:
//        8 ballots give each lane its peers with an equal digit, the lowest
//        peer bumps the warp's count of that digit. A scan of the warp
//        counts in warp order and a block scan over the digits place every
//        row in the tile's digit-sorted order, stable by construction.
//        The tile publishes its per-digit count in one 32-bit status word
//        per (tile, digit), flag and count together ("aggregate only" or
//        "inclusive prefix"), and looks back over its predecessors for its
//        exclusive prefix (decoupled look-back, Merrill & Garland 2016, as
//        in Onesweep, Adinets & Merrill 2022). The rows are reordered in
//        shared memory and written out in that order, so neighbouring
//        threads store to neighbouring addresses inside each digit's run.
//        The next pass reads the keys and perm sequentially: no pass
//        gathers through the permutation.
//
// Bound on the H100: memory. A 32-bit pass moves 16 B per row (key and perm
// in, key and perm out; 12 B when the perm in is the identity and is not
// read), 0.080 ms at 16M rows and 3.35 TB/s; a 64-bit pass 24 B. The
// histogram reads each key once. A whole argsort of 8M 32-bit keys is one
// histogram read plus 4 passes, 64 B per row (0.153 ms); the function itself
// needs only the keys read and the perm written, 8 B per row (0.019 ms).
// Status words (1 KB per tile and pass) and the digit counts are small
// beside the rows. A pass whose digit is the same on every row (the lane's
// counts say so) keeps the order: its blocks copy their tiles straight
// through, as CUB's Onesweep short-circuits such a pass. Skew short of that
// ranks as any other tile.
//
// On the card a pass runs at about 40% of that bound. A block keeps its
// tile in registers (128 a thread: MIN_BLOCKS = 2 blocks of 8 warps an SM;
// with more registers only one fits, and that is much slower), and a
// tile's phases run one after the other (tile claim, loads, warp ranks,
// scans, look-back, writes). Reading LOOKBACK predecessors' words at once
// shortens the look-back's chain of L2 round trips.
//
// Scratch comes from the caller: the histogram (zeroed) and, per pass, a
// zeroed block of STATUS_HEAD ints (the tile counter) followed by
// n_tiles * 256 status words. Counts travel in 30 bits: n < 2^30.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                  // rows per thread and tile
constexpr int WARP_ROWS = 32 * ITEMS;      // 512: a warp's rows in the tile
constexpr int TILE = THREADS * ITEMS;      // 4096, must match ops/cuda_radix.py
constexpr int RADIX = 256;
constexpr int MAX_PASSES = 8;
constexpr int STATUS_HEAD = 32;            // ints before the status words
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned FLAG_AGG = 1u << 30;    // the word holds this tile's count
constexpr unsigned FLAG_PREFIX = 1u << 31; // ... the count of tiles 0..t
constexpr unsigned COUNT_MASK = FLAG_AGG - 1u;
constexpr unsigned SPIN_LIMIT = 1u << 24;  // polls of one status word (seconds)
constexpr int LOOKBACK = 8;                // status words read at once in the look-back
constexpr int MIN_BLOCKS = 2;              // blocks per SM the registers must allow
constexpr int MAX_DEVICES = 64;            // devices whose launch attributes are kept
static_assert(THREADS == RADIX, "one thread per digit in the scans and the look-back");

template <typename K>
__device__ __forceinline__ unsigned digit_of(K key, int shift, unsigned mask) {
  return static_cast<unsigned>(key >> shift) & mask;
}

template <typename K>
__global__ void __launch_bounds__(THREADS)
lane_hist_kernel(const K* __restrict__ keys, int32_t* __restrict__ hist,
                 int64_t n, int lo, int passes, int last_bits) {
  __shared__ int32_t h[MAX_PASSES * RADIX];
  for (int i = threadIdx.x; i < passes * RADIX; i += THREADS) h[i] = 0;
  __syncthreads();
  const unsigned last_mask = (1u << last_bits) - 1u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
#pragma unroll 4
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += stride) {
    const K k = keys[i];
    for (int p = 0; p < passes; ++p) {
      const unsigned mask = p == passes - 1 ? last_mask : 0xFFu;
      atomicAdd(&h[p * RADIX + digit_of(k, lo + 8 * p, mask)], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * RADIX; i += THREADS)
    if (h[i] != 0) atomicAdd(&hist[i], h[i]);
}

// Exclusive scan of a and b over the block's threads, in thread order.
__device__ __forceinline__ void block_excl_scan2(int& a, int& b, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(FULL, ia, o), yb = __shfl_up_sync(FULL, ib, o);
    if (lane >= o) {
      ia += ya;
      ib += yb;
    }
  }
  if (lane == 31) {
    tmp[warp] = ia;
    tmp[WARPS + warp] = ib;
  }
  __syncthreads();
  int oa = 0, ob = 0;
  for (int w = 0; w < warp; ++w) {
    oa += tmp[w];
    ob += tmp[WARPS + w];
  }
  a = oa + ia - a;
  b = ob + ib - b;
}

template <typename K>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
onesweep_kernel(const K* __restrict__ keys_in, const int32_t* __restrict__ perm_in,
                K* __restrict__ keys_out, int32_t* __restrict__ perm_out,
                const int32_t* __restrict__ counts, unsigned* __restrict__ status,
                int64_t n, int shift, int bits) {
  extern __shared__ __align__(16) unsigned char staging[];
  K* skeys = reinterpret_cast<K*>(staging);                           // [TILE]
  int32_t* sperm = reinterpret_cast<int32_t*>(staging + TILE * sizeof(K));  // [TILE]
  __shared__ int32_t wh[WARPS][RADIX];  // per-warp digit counts, then each warp's start
  __shared__ int32_t blk_start[RADIX];  // first tile position of each digit's run
  __shared__ int32_t gbase[RADIX];      // global position of tile position 0, per digit
  __shared__ int32_t scan_tmp[2 * WARPS];
  __shared__ int tile_sh;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // every row on one digit: the pass keeps the order, and each block copies
  // its tile straight through (no ranking, no look-back)
  if (__syncthreads_or(static_cast<int64_t>(counts[t]) == n)) {
    const int64_t end = n < (static_cast<int64_t>(blockIdx.x) + 1) * TILE
                            ? n : (static_cast<int64_t>(blockIdx.x) + 1) * TILE;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + t; i < end; i += THREADS) {
      keys_out[i] = keys_in[i];
      perm_out[i] = perm_in != nullptr ? perm_in[i] : static_cast<int32_t>(i);
    }
    return;
  }
  if (t == 0) tile_sh = atomicAdd(reinterpret_cast<int*>(status), 1);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) wh[w][t] = 0;
  __syncthreads();
  const int tile = tile_sh;
  unsigned* words = status + STATUS_HEAD;
  const int64_t tile0 = static_cast<int64_t>(tile) * TILE;
  const int64_t row0 = tile0 + warp * WARP_ROWS + lane;
  const unsigned mask = (1u << bits) - 1u;
  const unsigned lower = (1u << lane) - 1u;

  K key[ITEMS];
  int32_t pv[ITEMS];
  unsigned dr[ITEMS];  // digit << 16 | rank within the warp
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int64_t i = row0 + it * 32;
    const bool valid = i < n;
    key[it] = valid ? keys_in[i] : K(0);
    pv[it] = valid ? (perm_in != nullptr ? perm_in[i] : static_cast<int32_t>(i)) : 0;
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const bool valid = row0 + it * 32 < n;
    const unsigned d = digit_of(key[it], shift, mask);
    unsigned peers = __ballot_sync(FULL, valid);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b < bits) {  // uniform over the warp
        const bool bit = (d >> b) & 1u;
        const unsigned bal = __ballot_sync(FULL, bit);
        peers &= bit ? bal : ~bal;
      }
    }
    const int leader = valid ? __ffs(peers) - 1 : lane;
    int before = 0;
    if (valid && lane == leader) before = atomicAdd(&wh[warp][d], __popc(peers));
    before = __shfl_sync(FULL, before, leader);
    dr[it] = (d << 16) | static_cast<unsigned>(before + __popc(peers & lower));
  }
  __syncthreads();

  // thread t owns digit t: the warps' starts within the tile's run, in warp order
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = wh[w][t];
    wh[w][t] = total;
    total += c;
  }
  volatile unsigned* mine = words + static_cast<int64_t>(tile) * RADIX + t;
  *mine = (tile == 0 ? FLAG_PREFIX : FLAG_AGG) | static_cast<unsigned>(total);

  int local = total, gofs = counts[t];
  block_excl_scan2(local, gofs, scan_tmp);  // tile run start, global run start
  blk_start[t] = local;
  __syncthreads();

#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (row0 + it * 32 < n) {
      const unsigned d = dr[it] >> 16;
      const int pos = blk_start[d] + wh[warp][d] + static_cast<int>(dr[it] & 0xFFFFu);
      skeys[pos] = key[it];
      sperm[pos] = pv[it];
    }
  }

  // decoupled look-back: rows of digit t in tiles before this one. The
  // words of LOOKBACK predecessors are read at once, then taken in tile
  // order up to the first inclusive prefix; a word not yet published ends
  // the window and is read again.
  int excl = 0;
  if (tile > 0) {
    int j = tile - 1;
    unsigned spins = 0;
    while (true) {
      unsigned v[LOOKBACK];
#pragma unroll
      for (int u = 0; u < LOOKBACK; ++u)
        v[u] = j - u >= 0 ? *reinterpret_cast<volatile const unsigned*>(
                                words + static_cast<int64_t>(j - u) * RADIX + t)
                          : 0u;
      int used = 0;
      bool done = false, stalled = false;
#pragma unroll
      for (int u = 0; u < LOOKBACK; ++u) {
        if (!done && !stalled) {
          if (v[u] == 0u) {
            stalled = true;
          } else {
            excl += static_cast<int>(v[u] & COUNT_MASK);
            done = (v[u] & FLAG_PREFIX) != 0u;
            ++used;
          }
        }
      }
      if (done) break;
      j -= used;
      // a word that never comes is a fault, not a wait
      if (used == 0 && ++spins == SPIN_LIMIT) __trap();
    }
    *mine = FLAG_PREFIX | static_cast<unsigned>(excl + total);
  }
  gbase[t] = gofs + excl - local;
  __syncthreads();

  const int64_t left = n - tile0;
  const int tile_n = left < TILE ? static_cast<int>(left) : TILE;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + t;
    if (j < tile_n) {
      const K kk = skeys[j];
      const int dest = gbase[digit_of(kk, shift, mask)] + j;
      keys_out[dest] = kk;
      perm_out[dest] = sperm[j];
    }
  }
}

// Allows onesweep_kernel<K> its dynamic shared memory on the current device,
// once per device: the attribute is kept, and setting it is a CUDA API call
// on the host at every launch otherwise.
template <typename K>
cudaError_t allow_onesweep_smem(int bytes) {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(onesweep_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return e;
}

template <typename K>
int launch_onesweep(const void* keys_in, const void* perm_in, void* keys_out,
                    void* perm_out, const void* counts, void* status, int64_t n,
                    int shift, int bits, cudaStream_t s) {
  const size_t dyn = static_cast<size_t>(TILE) * (sizeof(K) + sizeof(int32_t));
  const cudaError_t e = allow_onesweep_smem<K>(static_cast<int>(dyn));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_tiles = (n + TILE - 1) / TILE;
  onesweep_kernel<K><<<dim3(static_cast<unsigned>(n_tiles)), THREADS, dyn, s>>>(
      static_cast<const K*>(keys_in), static_cast<const int32_t*>(perm_in),
      static_cast<K*>(keys_out), static_cast<int32_t*>(perm_out),
      static_cast<const int32_t*>(counts), static_cast<unsigned*>(status), n, shift, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ct_radix_tile() { return TILE; }
extern "C" int ct_radix_status_head() { return STATUS_HEAD; }

// hist: int32 [passes * 256], zeroed; passes = ceil((hi - lo) / 8) <= 8.
extern "C" int ct_radix_lane_hist(const void* keys, int64_t key_bytes, void* hist,
                                  int64_t n, int64_t lo, int64_t hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int span = static_cast<int>(hi - lo);
  const int passes = (span + 7) / 8;
  const int last_bits = span - 8 * (passes - 1);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (n + THREADS * 16 - 1) / (THREADS * 16);
  if (blocks > 4 * static_cast<int64_t>(sms)) blocks = 4 * static_cast<int64_t>(sms);
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (key_bytes == 8) {
    lane_hist_kernel<unsigned long long><<<grid, THREADS, 0, s>>>(
        static_cast<const unsigned long long*>(keys), static_cast<int32_t*>(hist), n,
        static_cast<int>(lo), passes, last_bits);
  } else {
    lane_hist_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(hist), n,
        static_cast<int>(lo), passes, last_bits);
  }
  return static_cast<int>(cudaGetLastError());
}

// One pass over the digit [shift, shift + bits), bits <= 8. perm_in may be
// null: the identity (row i carries i). counts: int32 [256], this digit's
// counts over the whole lane. status: int32 [STATUS_HEAD + n_tiles * 256],
// zeroed. n >= 1.
extern "C" int ct_radix_onesweep(const void* keys_in, const void* perm_in, void* keys_out,
                                 void* perm_out, const void* counts, void* status,
                                 int64_t key_bytes, int64_t n, int64_t shift, int64_t bits,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 8)
    return launch_onesweep<unsigned long long>(keys_in, perm_in, keys_out, perm_out, counts,
                                               status, n, static_cast<int>(shift),
                                               static_cast<int>(bits), s);
  return launch_onesweep<uint32_t>(keys_in, perm_in, keys_out, perm_out, counts, status, n,
                                   static_cast<int>(shift), static_cast<int>(bits), s);
}
