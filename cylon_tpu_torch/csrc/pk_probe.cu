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
// Design: one shared-memory hash table per bucket. A block takes G buckets
// (G * B >= 1024 slots when B is small, else one bucket), loads their right
// (key, id) pairs coalesced and inserts each live pair into its bucket's
// open-addressing table of T slots, T the least power of two >= 2B. A slot
// is one 64-bit word, key << 32 | (id + 1): 0 marks an empty slot and a live
// entry is never 0. An insert claims an empty slot with atomicCAS; where the
// slot already holds the key, atomicMax on the word keeps the larger id (the
// key half is equal, and a slot's key never changes once set). After a block
// barrier each left slot probes linearly from its key's slot until it finds
// the key or an empty slot; the table is at most half full, so that takes
// about one probe. The table slot comes from the key's own bits,
// (key * 0x9E3779B1) >> (32 - log2 T), not from the bucket hash: every key
// of a bucket shares the bucket id's bits.
//
// Shared memory: G * T * 8 bytes (16 KB at B = 256, G = 4; 128 KB at
// B = 8192). B above 8192 needs more than the 227 KB a block can have and is
// refused (the wrapper raises first).
//
// Bound on the H100, at the main path's shape (8M = 8,000,000 rows a side,
// B = 256, nb = 65536): memory. The function moves 16 * nb * B = 268 MB (left
// key, right key, right id in; result out), 0.080 ms at 3.35 TB/s; the table
// work is a few shared-memory operations per slot. (The all-pairs kernel this
// design replaced compared all nb * B * B = 4.29e9 slot pairs.)
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;                     // slots a thread loads before it works on them
constexpr int BLOCK_SLOTS = THREADS * PER; // buckets per block: max(1, BLOCK_SLOTS / B)
constexpr uint32_t HASH_MUL = 0x9E3779B1u;
constexpr int MAX_SHARED = 232448;         // 227 KB, a block's most on the H100
constexpr int MAX_DEVICES = 64;            // devices whose launch attribute is kept

__device__ __forceinline__ uint32_t home(int32_t key, int log_t) {
  return (static_cast<uint32_t>(key) * HASH_MUL) >> (32 - log_t);
}

__global__ void __launch_bounds__(THREADS)
probe_kernel(const int32_t* __restrict__ lk, const int32_t* __restrict__ rk,
             const int32_t* __restrict__ rid, int32_t* __restrict__ out, int64_t nb,
             int B, int G, int log_t) {
  extern __shared__ unsigned long long table[];  // G tables of T words
  const int T = 1 << log_t;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G;
  const int g_here = nb - b0 < G ? static_cast<int>(nb - b0) : G;
  const int slots = g_here * B;
  const int64_t base = b0 * B;
  for (int i = threadIdx.x; i < G * T; i += THREADS) table[i] = 0ull;
  __syncthreads();

  for (int s0 = 0; s0 < slots; s0 += BLOCK_SLOTS) {
    int32_t key[PER], id[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int s = s0 + u * THREADS + threadIdx.x;
      id[u] = s < slots ? rid[base + s] : -1;
      key[u] = s < slots ? rk[base + s] : 0;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      if (id[u] < 0) continue;
      const int s = s0 + u * THREADS + threadIdx.x;
      unsigned long long* tab = table + (s / B) * T;
      const unsigned long long w = (static_cast<unsigned long long>(static_cast<uint32_t>(key[u])) << 32) |
                                   static_cast<uint32_t>(id[u] + 1);
      uint32_t h = home(key[u], log_t);
      while (true) {
        const unsigned long long old = atomicCAS(&tab[h], 0ull, w);
        if (old == 0ull) break;
        if (static_cast<uint32_t>(old >> 32) == static_cast<uint32_t>(key[u])) {
          atomicMax(&tab[h], w);
          break;
        }
        h = (h + 1) & (T - 1);
      }
    }
  }
  __syncthreads();

  for (int s0 = 0; s0 < slots; s0 += BLOCK_SLOTS) {
    int32_t key[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int s = s0 + u * THREADS + threadIdx.x;
      key[u] = s < slots ? lk[base + s] : 0;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int s = s0 + u * THREADS + threadIdx.x;
      if (s >= slots) continue;
      const unsigned long long* tab = table + (s / B) * T;
      uint32_t h = home(key[u], log_t);
      int32_t best = -1;
      while (true) {
        const unsigned long long w = tab[h];
        if (w == 0ull) break;
        if (static_cast<uint32_t>(w >> 32) == static_cast<uint32_t>(key[u])) {
          best = static_cast<int32_t>(static_cast<uint32_t>(w)) - 1;
          break;
        }
        h = (h + 1) & (T - 1);
      }
      out[base + s] = best;
    }
  }
}

// log2 of the table size for bucket width B: the least T = 2^k >= 2B.
int log_t_of(int64_t B) {
  int k = 1;
  while ((int64_t{1} << k) < 2 * B) ++k;
  return k;
}

int buckets_per_block(int64_t B) {
  return B >= BLOCK_SLOTS ? 1 : static_cast<int>(BLOCK_SLOTS / B);
}

}  // namespace

// Shared memory of one block for bucket width B: its buckets' tables.
extern "C" int64_t ct_pk_probe_shared_bytes(int64_t B) {
  return static_cast<int64_t>(buckets_per_block(B)) * (int64_t{1} << log_t_of(B)) * 8;
}

// The most shared memory a block may have: a table past it is refused.
extern "C" int64_t ct_pk_probe_shared_limit() { return MAX_SHARED; }

// lk, rk, rid, out: int32 [nb * B]. Requires nb >= 1, B >= 1 and the table
// within ct_pk_probe_shared_limit() (the wrapper checks and raises first);
// returns cudaErrorInvalidValue when it is not.
extern "C" int ct_pk_probe(const void* lk, const void* rk, const void* rid, void* out,
                           int64_t nb, int64_t B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t smem = ct_pk_probe_shared_bytes(B);
  if (smem > MAX_SHARED) return static_cast<int>(cudaErrorInvalidValue);
  // the kernel may use up to MAX_SHARED on each device: set once per device
  // (the attribute is kept; setting it is a CUDA API call on the host)
  static std::atomic<bool> allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !allowed[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SHARED);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) allowed[dev].store(true, std::memory_order_release);
  }
  const int G = buckets_per_block(B);
  const int64_t blocks = (nb + G - 1) / G;
  probe_kernel<<<dim3(static_cast<unsigned>(blocks)), THREADS, static_cast<size_t>(smem), s>>>(
      static_cast<const int32_t*>(lk), static_cast<const int32_t*>(rk),
      static_cast<const int32_t*>(rid), static_cast<int32_t*>(out), nb, static_cast<int>(B), G,
      log_t_of(B));
  return static_cast<int>(cudaGetLastError());
}
