// Native host runtime: arena memory pool + murmur3 string hashing.
//
// Reference analogs:
//  - memory pool: cylon's Arrow-pool adapter (cpp/src/cylon/ctx/
//    memory_pool.hpp:69, arrow_memory_pool_utils.{hpp,cpp}) — here an arena
//    allocator for HOST staging buffers (CSV write staging, transfer prep);
//    device memory is owned by PyTorch's caching allocator, so the pool's
//    job is the host edge only.
//  - murmur3: util/murmur3.{hpp,cpp} (MurmurHash3_x86_32), used by the
//    reference's hash partition kernels; here it hashes DICTIONARY string
//    values once per dictionary on the host (ops/hash.py
//    hash_dictionary_host) — the device then mixes the resulting lane.
//
// Plain C ABI (no pybind11 in the image); loaded via ctypes.
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ------------------------------------------------------------------ pool

struct CtPool {
  std::mutex mu;
  size_t block_bytes;
  std::vector<char*> blocks;      // block_bytes each, kept across resets
  std::vector<char*> dedicated;   // one oversized request each, freed at reset
  size_t dedicated_bytes = 0;     // their total size
  size_t cur_block = 0;   // index of the block being carved
  size_t cur_off = 0;     // offset inside it
  size_t in_use = 0;      // bytes handed out since last reset
  size_t peak = 0;        // high-water mark of in_use
  uint64_t allocs = 0;    // total ct_pool_alloc calls
};

void* ct_pool_create(int64_t block_bytes) {
  auto* p = new CtPool();
  p->block_bytes = block_bytes > 0 ? (size_t)block_bytes : (size_t)1 << 20;
  return p;
}

// Arena alloc: bump-pointer within blocks; oversized requests get a
// dedicated block of their own. Returned memory lives until
// ct_pool_reset/destroy.
void* ct_pool_alloc(void* pool, int64_t nbytes) {
  auto* p = static_cast<CtPool*>(pool);
  if (nbytes <= 0) return nullptr;
  std::lock_guard<std::mutex> g(p->mu);
  size_t n = ((size_t)nbytes + 63) & ~size_t(63);  // 64-byte align
  p->allocs++;
  p->in_use += n;
  if (p->in_use > p->peak) p->peak = p->in_use;
  if (n > p->block_bytes) {
    char* b = new char[n];
    p->dedicated.push_back(b);
    p->dedicated_bytes += n;
    return b;
  }
  while (true) {
    if (p->cur_block < p->blocks.size()) {
      if (p->cur_off + n <= p->block_bytes) {
        char* out = p->blocks[p->cur_block] + p->cur_off;
        p->cur_off += n;
        return out;
      }
      p->cur_block++;
      p->cur_off = 0;
      continue;
    }
    p->blocks.push_back(new char[p->block_bytes]);
  }
}

static void free_dedicated(CtPool* p) {
  for (char* b : p->dedicated) delete[] b;
  p->dedicated.clear();
  p->dedicated_bytes = 0;
}

// Reuse the carving blocks without freeing (the arena pattern: reset
// between ops) and free the dedicated ones: a staging buffer larger than
// a block is one write's column, and keeping it would grow the pool by
// every large write for the pool's lifetime.
void ct_pool_reset(void* pool) {
  auto* p = static_cast<CtPool*>(pool);
  std::lock_guard<std::mutex> g(p->mu);
  free_dedicated(p);
  p->cur_block = 0;
  p->cur_off = 0;
  p->in_use = 0;
}

int64_t ct_pool_in_use(void* pool) {
  auto* p = static_cast<CtPool*>(pool);
  std::lock_guard<std::mutex> g(p->mu);
  return (int64_t)p->in_use;
}

int64_t ct_pool_peak(void* pool) {
  auto* p = static_cast<CtPool*>(pool);
  std::lock_guard<std::mutex> g(p->mu);
  return (int64_t)p->peak;
}

int64_t ct_pool_reserved(void* pool) {
  auto* p = static_cast<CtPool*>(pool);
  std::lock_guard<std::mutex> g(p->mu);
  return (int64_t)(p->blocks.size() * p->block_bytes + p->dedicated_bytes);
}

int64_t ct_pool_allocs(void* pool) {
  auto* p = static_cast<CtPool*>(pool);
  std::lock_guard<std::mutex> g(p->mu);
  return (int64_t)p->allocs;
}

void ct_pool_destroy(void* pool) {
  auto* p = static_cast<CtPool*>(pool);
  for (char* b : p->blocks) delete[] b;
  free_dedicated(p);
  delete p;
}

// --------------------------------------------------------------- murmur3

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6b;
  h ^= h >> 13;
  h *= 0xc2b2ae35;
  h ^= h >> 16;
  return h;
}

// MurmurHash3_x86_32 over an arbitrary byte string.
uint32_t ct_murmur3_32(const void* key, int64_t len, uint32_t seed) {
  const uint8_t* data = (const uint8_t*)key;
  const int64_t nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51;
  const uint32_t c2 = 0x1b873593;
  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, data + i * 4, 4);
    k1 *= c1;
    k1 = rotl32(k1, 15);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl32(h1, 13);
    h1 = h1 * 5 + 0xe6546b64;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= tail[1] << 8; [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = rotl32(k1, 15);
      k1 *= c2;
      h1 ^= k1;
  }
  h1 ^= (uint32_t)len;
  return fmix32(h1);
}

// Batch form over a concatenated UTF-8 buffer with n+1 offsets.
void ct_murmur3_batch(const char* bytes, const int64_t* offsets, int64_t n,
                      uint32_t seed, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = ct_murmur3_32(bytes + offsets[i], offsets[i + 1] - offsets[i], seed);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sorted-dictionary union (cylon_tpu_torch.native.dict_union).
//
// Numpy 'U' (UCS4 fixed-width) arrays compare like python strings: code
// points in order, shorter string first on a shared prefix; trailing NUL
// chars are padding. The two inputs are each sorted and duplicate-free (the
// Column dictionary invariant), so the union is ONE two-pointer merge —
// O(Da + Db) character compares vs np.union1d's concat + full sort. At the
// 10B-row north star a high-cardinality string join's dictionary union is
// the host-side bottleneck this replaces (reference analog: the string-key
// hash partition path, arrow/arrow_partition_kernels.cpp:243-305, which
// never needs a union because Arrow carries raw strings — our codes are
// order-preserving, which IS the point of the sorted dictionary).
// ---------------------------------------------------------------------------
extern "C" {

static inline int ct_ucs4_cmp(const uint32_t* x, int32_t wx,
                              const uint32_t* y, int32_t wy) {
  int32_t w = wx < wy ? wx : wy;
  for (int32_t i = 0; i < w; ++i) {
    if (x[i] != y[i]) return x[i] < y[i] ? -1 : 1;
  }
  for (int32_t i = w; i < wx; ++i)
    if (x[i]) return 1;  // x longer: y is a strict prefix -> y < x
  for (int32_t i = w; i < wy; ++i)
    if (y[i]) return -1;
  return 0;
}

// Merge-union two sorted unique UCS4 arrays. out_union must hold
// (da + db) * wu uint32 (zero-filled by the callee per element); wu >=
// max(wa, wb). map_a[i] / map_b[j] receive each input entry's index in the
// union. Returns the union size.
int64_t ct_dict_union_u32(const uint32_t* a, int64_t da, int32_t wa,
                          const uint32_t* b, int64_t db, int32_t wb,
                          uint32_t* out_union, int32_t wu,
                          int32_t* map_a, int32_t* map_b) {
  int64_t ia = 0, ib = 0, u = 0;
  while (ia < da || ib < db) {
    int c;
    if (ia >= da) c = 1;
    else if (ib >= db) c = -1;
    else c = ct_ucs4_cmp(a + ia * wa, wa, b + ib * wb, wb);
    uint32_t* dst = out_union + u * wu;
    if (c <= 0) {
      const uint32_t* src = a + ia * wa;
      int32_t i = 0;
      for (; i < wa; ++i) dst[i] = src[i];
      for (; i < wu; ++i) dst[i] = 0;
      map_a[ia++] = (int32_t)u;
      if (c == 0) map_b[ib++] = (int32_t)u;
    } else {
      const uint32_t* src = b + ib * wb;
      int32_t i = 0;
      for (; i < wb; ++i) dst[i] = src[i];
      for (; i < wu; ++i) dst[i] = 0;
      map_b[ib++] = (int32_t)u;
    }
    ++u;
  }
  return u;
}

}  // extern "C"
