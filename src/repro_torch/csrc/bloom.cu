// Batched Bloom-filter membership for Hopper (sm_90a): the shard-skip test
// of selective scheduling (paper §II-D-1) over a device-resident active set.
//
// bloom_contains  replaces the TPU kernel
//     src/repro/kernels/bloom/kernel.py::bloom_contains (body _kernel)
//   For each id x (an int32 read as its uint32 bit pattern):
//     h1 = x * MUL1,  h1 ^= h1 >> 15
//     h2 = (x + ADD) * MUL2,  h2 ^= h2 >> 13,  h2 |= 1
//   and for each filter f, hit = AND over i < num_hashes[f] of bit
//   (h1 + i * h2) & (num_bits[f] - 1) of the filter's uint32 word table,
//   all in uint32 arithmetic that wraps, bit-exact with the host
//   BloomFilter32.  One launch takes up to kMaxFilters filters, each with
//   its own size and probe count, as a table of pointers passed by value.
//   Two outputs: the bits themselves, [n_filters, n] bytes, or (any != 0)
//   one byte per filter, set where some id hits it: the shard-activity
//   decision of any_active_shards, reduced on the card so no [n] array per
//   filter comes back to the host.
//   Bound: the bits read each id once (4 B), each touched 32 B sector of
//   the word tables once (the smoke's 16 shard filters at 2^21 vertices:
//   512 KB each) and write their bytes once, with about 8 integer
//   operations to hash an id and 6 a probe.  What the bound leaves out
//   sets the time: every random 4 B probe moves its own 32 B sector from
//   L2 (about 1.9 probes an id at the smoke's 30% of bits set; 16 probes
//   an id where a scan must test every id against 16 filters), and the
//   bits and the scan both run at L2's rate of random sectors.  The "any"
//   output needs far less where filters are hit: an in-order scan may stop
//   once every filter has a hit, and until then probes only the filters
//   still without one.
//   Design.  The bits: a thread an id, which probes every filter of the
//   launch in turn, stopping at a filter's first clear bit (the host
//   filter's AND, short-circuited: the same result).  The TPU kernel kept
//   a whole table in VMEM; an SM's 227 KB of shared memory holds less than
//   one of the smoke's tables.  Three other forms measured no faster on
//   the smoke's tables at 2^10 to 2^21 ids: several ids a thread probed
//   level by level (their probes issued together), all of shared memory
//   given to L1, and a table held in a cluster of 4 blocks' shared memory
//   and probed through distributed shared memory (slower than L2).
//   The "any" output: a warp walks the ids grid-stride, 32 at a time, and
//   takes the filters in a turn that starts at its own index (the warps of
//   the first wave start on different filters), skipping a filter whose
//   bit it knows.  A per-stream state (a 64-bit word of hit bits and a
//   block counter) is zero between launches.  A warp's first hit of a
//   filter goes to its block's word in shared memory and, once a filter
//   and block, to the state's word; warps read the block's word before
//   each filter, the state's once an iteration (and before each filter in
//   their first), and leave once every filter is hit.  Each block at its
//   end counts itself in the state (after a fence); the last one writes
//   every flag from the word and sets the state back to zero.  So a call
//   is one launch (no clearing launch before it, no flag launch after),
//   the OR (and so every flag) does not depend on the order the blocks
//   run in, and two streams never share a state (the wrapper keeps one
//   per stream).  Why not simpler: a flag byte stored by every warp that hits
//   serialises some 10^6 stores on 16 bytes in L2; reading the state's
//   word before every filter for the whole scan makes that one line's
//   rate set the time where a filter is never hit.  Ids need no padding.
//
// The C function launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMul1 = 0x9E3779B1u;
constexpr uint32_t kMul2 = 0x85EBCA77u;
constexpr uint32_t kAdd = 0x27D4EB2Fu;
constexpr int kMaxFilters = 64;  // one bit each in the "any" masks
constexpr int kMaxHashes = 16;
constexpr int kThreads = 256;
constexpr int kAnyBlocksPerSm = 2;  // the "any" grid: 512 threads an SM

struct FilterArgs {
  const uint32_t* words[kMaxFilters];
  uint32_t mask[kMaxFilters];  // num_bits - 1
  int num_hashes[kMaxFilters];
  int n;
};

// The "any" output's state, one per stream; zero between launches.
struct AnyState {
  unsigned long long seen;  // bit p: some id hits filter p
  unsigned int done;        // blocks of the launch that have finished
  unsigned int pad;
};

struct Hash {
  uint32_t h1, h2;
};

__device__ __forceinline__ Hash hash2(int32_t id) {
  const uint32_t x = static_cast<uint32_t>(id);
  uint32_t h1 = x * kMul1;
  h1 ^= h1 >> 15;
  uint32_t h2 = (x + kAdd) * kMul2;
  h2 ^= h2 >> 13;
  return {h1, h2 | 1u};
}

// Is the id behind h (possibly) in filter p?
__device__ __forceinline__ bool member(const FilterArgs& f, int p, Hash h) {
  const uint32_t* w = f.words[p];
  const uint32_t mask = f.mask[p];
  const uint32_t nh = static_cast<uint32_t>(f.num_hashes[p]);
  for (uint32_t k = 0; k < nh; ++k) {
    const uint32_t pos = (h.h1 + k * h.h2) & mask;
    if (!((__ldg(w + (pos >> 5)) >> (pos & 31u)) & 1u)) return false;
  }
  return true;
}

// out[p, i]: id i (possibly) in filter p.  A thread an id.
__global__ void __launch_bounds__(kThreads)
bloom_bits_kernel(const __grid_constant__ FilterArgs f,
                  const int32_t* __restrict__ items, long long n,
                  uint8_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const Hash h = hash2(__ldg(items + i));
  for (int p = 0; p < f.n; ++p) out[p * n + i] = member(f, p, h);
}

// *word as lane 0 reads it, in every lane: the warp's branches on it agree.
__device__ __forceinline__ unsigned long long warp_read(const volatile unsigned long long* word) {
  unsigned long long v = 0;
  if ((threadIdx.x & 31) == 0) v = *word;
  return __shfl_sync(0xffffffffu, v, 0);
}

// The scan for the "any" output: st->seen |= bit p for each filter p that
// some id hits (see the source note).  A warp walks the ids grid-stride,
// 32 at a time, and takes the filters in a turn that starts at its own
// index, so the warps of the first wave start on different filters.  It
// reads the state's word once an iteration into the block's word, the
// block's word before each filter (in its first iteration the state's
// too), and stops once every bit is set.  Every lane of a warp runs the
// same iterations (the bound is the warp's first id), so the ballots and
// shuffles see all 32 lanes.
__device__ __forceinline__ void any_scan(const FilterArgs& f, const int32_t* __restrict__ items,
                                         long long n, AnyState* st,
                                         unsigned long long* block_seen) {
  const unsigned long long all = f.n == kMaxFilters ? ~0ull : (1ull << f.n) - 1;
  volatile unsigned long long* seen = &st->seen;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int first = static_cast<int>(warp % f.n);
  for (long long base = warp * 32; base < n; base += stride) {
    unsigned long long known = warp_read(seen);
    if (lane == 0 && (known & ~*static_cast<volatile unsigned long long*>(block_seen))) {
      atomicOr(block_seen, known);
    }
    if (known == all) return;
    const bool first_pass = base == warp * 32;
    const long long i = base + lane;
    const Hash h = i < n ? hash2(__ldg(items + i)) : Hash{0u, 1u};
    for (int k = 0; k < f.n; ++k) {
      const int p = first + k < f.n ? first + k : first + k - f.n;
      const unsigned long long bit = 1ull << p;
      if (known & bit) continue;
      known |= warp_read(block_seen);  // another warp of the block may have hit it
      if (!(known & bit) && first_pass) known |= warp_read(seen);  // or of the grid
      if (known == all) return;
      if (known & bit) continue;
      if (__ballot_sync(0xffffffffu, i < n && member(f, p, h))) {
        if (lane == 0 && !(atomicOr(block_seen, bit) & bit)) atomicOr(&st->seen, bit);
        known |= bit;
      }
    }
    if (known == all) return;
  }
}

// The end of an "any" launch, run by every thread of every block: the
// block counts itself in the state once all its warps are done; the last
// block writes each flag from the word of hit bits and zeroes the state.
__device__ __forceinline__ void finish_any(int n_filters, uint8_t* __restrict__ out,
                                           AnyState* st) {
  __shared__ bool last;
  __shared__ unsigned long long word;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's hit bits before its count
    last = atomicAdd(&st->done, 1u) == gridDim.x - 1;
    if (last) {
      __threadfence();
      word = atomicExch(&st->seen, 0ull);
      st->done = 0;
    }
  }
  __syncthreads();
  if (last && static_cast<int>(threadIdx.x) < n_filters) out[threadIdx.x] = (word >> threadIdx.x) & 1ull;
}

__global__ void __launch_bounds__(kThreads)
bloom_any_kernel(const __grid_constant__ FilterArgs f,
                 const int32_t* __restrict__ items, long long n,
                 uint8_t* __restrict__ out, AnyState* st) {
  __shared__ unsigned long long block_seen;
  if (threadIdx.x == 0) block_seen = 0;
  __syncthreads();
  any_scan(f, items, n, st, &block_seen);
  finish_any(f.n, out, st);
}

}  // namespace

// words: n_filters device pointers to uint32 tables of num_bits[f] / 32
// words; num_bits: powers of two >= 32; num_hashes: 1..kMaxHashes.
// items: n int32 ids on the device.  out: [n_filters, n] bytes, or with
// any != 0 n_filters bytes and state: the stream's 16-byte "any" state,
// zero (as every launch leaves it).
extern "C" int bloom_contains(const void* const* words,
                              const unsigned long long* num_bits,
                              const int* num_hashes, int n_filters,
                              const void* items, long long n, int any,
                              void* out, void* state, void* stream) {
  FilterArgs f;
  if (n_filters <= 0 || n_filters > kMaxFilters || n <= 0 || (any && state == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  f.n = n_filters;
  for (int p = 0; p < n_filters; ++p) {
    const unsigned long long nb = num_bits[p];
    if (nb < 32 || nb > (1ull << 32) || (nb & (nb - 1)) || num_hashes[p] < 1 ||
        num_hashes[p] > kMaxHashes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    f.words[p] = static_cast<const uint32_t*>(words[p]);
    f.mask[p] = static_cast<uint32_t>(nb - 1);
    f.num_hashes[p] = num_hashes[p];
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int32_t*>(items);
  auto* o = static_cast<uint8_t*>(out);
  if (!any) {
    bloom_bits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(f, x, n, o);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long most = static_cast<long long>(sms) * kAnyBlocksPerSm;
  bloom_any_kernel<<<static_cast<unsigned>(blocks < most ? blocks : most), kThreads, 0, s>>>(
      f, x, n, o, static_cast<AnyState*>(state));
  return static_cast<int>(cudaGetLastError());
}
