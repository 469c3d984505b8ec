// Windowed row-split ELL pull-update for Hopper (sm_90a): the VSW hot loop.
//
// Two kernels, each behind a plain C entry point that launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().  Both
// take a batch of up to kMaxBatch shards as tables of per-shard pointers,
// passed by value as a __grid_constant__ parameter, so a batch is one
// launch and no shard's arrays are ever copied into a concatenation.
//
// ell_partials_masked  replaces the TPU kernel
//     src/repro/kernels/spmv_ell/kernel.py::ell_partials_masked
//   partial[r] = COMBINE over valid slots s of msgs[tile_window[r / tr] *
//   window + idx[r, s]], the combine identity where row r has no valid slot.
//   Bound: memory.  csr_to_ell packs each row's valid slots at its front,
//   and on R-MAT about 95% of slots are padding, so what the function must
//   move is the whole mask plane (1 B a slot: it is the only way to find
//   the valid slots), the 32 B sectors of idx that hold valid slots (about
//   one a row), the message sectors those slots gather, tile_window, and
//   one float out per row.  Most of the idx plane is never read.
//   Design (K % 16 == 0, 16 B aligned planes): a row is spread over
//   L = K/16 lanes (rounded up to a power of two, at most 32), so a warp
//   works on 32/L rows at once; a lane loads 16 mask bytes in one 16 B
//   load, and only if any is set the 16 indices, then gathers the set
//   slots with predicated loads that can all be in flight together.  One
//   row at a time per warp left the kernel waiting on the mask -> idx ->
//   message chain of loads.  Otherwise (any K) a warp takes one row, a
//   lane one slot in 32.  No shared-memory staging of the W-wide message
//   window (the TPU kernel's VMEM table): the gathers are few, and the
//   whole message array (8 MB at 2^21 vertices) sits in L2.  A lane folds
//   its slots in ascending order and a fixed xor-shuffle tree folds the
//   lanes, so a result never changes from run to run or with the batch.
//   The kernel reads its own tile_window entries (no scalar prefetch).
//
// segment_combine  replaces the XLA segment_sum/min/max that follows the
//     TPU kernel (src/repro/kernels/spmv_ell/ops.py::_segment_combine)
//   out[r] = COMBINE over partial[perm[j]], j in [row_ptr[r], row_ptr[r+1]),
//   starting from the identity; an empty row gets the identity.  One warp
//   per destination row: lane l folds j = row_ptr[r] + l, + 32, ... in
//   ascending order, then a fixed xor-shuffle tree folds the lanes.  A
//   thread per row would serialise a hub row's thousands of partials.  No
//   atomics and a fixed order, so batched and per-shard launches give the
//   same bits.
//   Bound: memory — the partials of the non-padding rows, perm and row_ptr
//   read once, out written once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Combine : int { kSum = 0, kMin = 1, kMax = 2 };

template <int OP>
struct Op;

template <>
struct Op<kSum> {
  __device__ __forceinline__ static float identity() { return 0.0f; }
  __device__ __forceinline__ static float apply(float a, float b) { return a + b; }
};

template <>
struct Op<kMin> {
  __device__ __forceinline__ static float identity() { return INFINITY; }
  __device__ __forceinline__ static float apply(float a, float b) { return fminf(a, b); }
};

template <>
struct Op<kMax> {
  __device__ __forceinline__ static float identity() { return -INFINITY; }
  __device__ __forceinline__ static float apply(float a, float b) { return fmaxf(a, b); }
};

constexpr int kMaxBatch = 64;
constexpr int kWarpsPerBlock = 8;
constexpr int kCombineThreads = 256;
constexpr int kSlotsPerLane = 16;  // one 16 B load of mask bytes

struct PartialsArgs {
  const void* idx[kMaxBatch];
  const uint8_t* mask[kMaxBatch];
  const int32_t* tile_window[kMaxBatch];
  long long row0[kMaxBatch + 1];  // first ELL row of each shard; row0[n] = total
  int n;
};

struct CombineArgs {
  const int32_t* perm[kMaxBatch];
  const int32_t* row_ptr[kMaxBatch];
  long long ell0[kMaxBatch];  // first partial of each shard
  int dst0[kMaxBatch + 1];    // first destination row of each shard; dst0[n] = total
  int n;
};

// The shard holding global row r of a table of n first-rows (n is small).
template <typename T>
__device__ __forceinline__ int shard_of(const T* first, int n, long long r) {
  int s = 0;
  while (s + 1 < n && r >= first[s + 1]) ++s;
  return s;
}

template <typename IdxT, int OP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_partials_vec_kernel(const __grid_constant__ PartialsArgs a,
                        const float* __restrict__ msgs,
                        float* __restrict__ out, int k, int tr, int window,
                        int lanes_per_row) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes_per_row - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
          (32 / lanes_per_row) +
      lane / lanes_per_row;
  const bool live = row < a.row0[a.n];  // dead lanes still join the shuffles
  float acc = Op<OP>::identity();
  if (live) {
    const int s = shard_of(a.row0, a.n, row);
    const long long r = row - a.row0[s];
    const float* table =
        msgs + static_cast<long long>(__ldg(a.tile_window[s] + r / tr)) * window;
    const IdxT* ri = static_cast<const IdxT*>(a.idx[s]) + r * k;
    const uint8_t* rm = a.mask[s] + r * k;
    for (int c = sub * kSlotsPerLane; c < k; c += lanes_per_row * kSlotsPerLane) {
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(rm + c));
      if ((m.x | m.y | m.z | m.w) == 0u) continue;
      constexpr int kVecs = kSlotsPerLane * sizeof(IdxT) / sizeof(int4);
      int4 q[kVecs];
#pragma unroll
      for (int v = 0; v < kVecs; ++v) q[v] = __ldg(reinterpret_cast<const int4*>(ri + c) + v);
      IdxT j[kSlotsPerLane];
      memcpy(j, q, sizeof(q));
      const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int t = 0; t < kSlotsPerLane; ++t) {
        if ((mw[t / 4] >> (8 * (t % 4))) & 0xffu) {
          const int col = min(max(static_cast<int>(j[t]), 0), window - 1);
          acc = Op<OP>::apply(acc, __ldg(table + col));
        }
      }
    }
  }
  for (int off = lanes_per_row / 2; off > 0; off >>= 1) {
    acc = Op<OP>::apply(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (live && sub == 0) out[row] = acc;
}

template <typename IdxT, int OP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_partials_scalar_kernel(const __grid_constant__ PartialsArgs a,
                           const float* __restrict__ msgs,
                           float* __restrict__ out, int k, int tr, int window) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.row0[a.n]) return;  // whole warp leaves together
  const int s = shard_of(a.row0, a.n, row);
  const long long r = row - a.row0[s];
  const float* table =
      msgs + static_cast<long long>(__ldg(a.tile_window[s] + r / tr)) * window;
  const IdxT* ri = static_cast<const IdxT*>(a.idx[s]) + r * k;
  const uint8_t* rm = a.mask[s] + r * k;
  float acc = Op<OP>::identity();
  for (int t = lane; t < k; t += 32) {
    if (__ldg(rm + t)) {
      const int col = min(max(static_cast<int>(__ldg(ri + t)), 0), window - 1);
      acc = Op<OP>::apply(acc, __ldg(table + col));  // clipped, as the TPU kernel
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = Op<OP>::apply(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) out[row] = acc;
}

template <int OP>
__global__ void __launch_bounds__(kCombineThreads)
segment_combine_kernel(const __grid_constant__ CombineArgs a,
                       const float* __restrict__ part,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kCombineThreads / 32) + (threadIdx.x >> 5);
  if (r >= a.dst0[a.n]) return;  // whole warp leaves together
  const int s = shard_of(a.dst0, a.n, r);
  const int32_t* rp = a.row_ptr[s] + (r - a.dst0[s]);
  const int32_t* pm = a.perm[s];
  const float* p = part + a.ell0[s];
  const int end = __ldg(rp + 1);
  float acc = Op<OP>::identity();
  for (int j = __ldg(rp) + lane; j < end; j += 32) {
    acc = Op<OP>::apply(acc, __ldg(p + __ldg(pm + j)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = Op<OP>::apply(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) out[r] = acc;
}

template <typename IdxT, int OP>
void launch_partials(const PartialsArgs& a, const float* x, float* o, int k,
                     int tr, int window, int lanes_per_row, cudaStream_t stream) {
  const long long rows = a.row0[a.n];
  const dim3 block(kWarpsPerBlock * 32);
  if (lanes_per_row > 0) {
    const long long per_block = static_cast<long long>(kWarpsPerBlock) * (32 / lanes_per_row);
    const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block));
    ell_partials_vec_kernel<IdxT, OP><<<grid, block, 0, stream>>>(
        a, x, o, k, tr, window, lanes_per_row);
  } else {
    const dim3 grid(static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
    ell_partials_scalar_kernel<IdxT, OP><<<grid, block, 0, stream>>>(a, x, o, k, tr, window);
  }
}

template <typename IdxT>
void launch_partials(const PartialsArgs& a, const float* x, float* o, int k,
                     int tr, int window, int lanes_per_row, int combine,
                     cudaStream_t stream) {
  switch (combine) {
    case kSum:
      launch_partials<IdxT, kSum>(a, x, o, k, tr, window, lanes_per_row, stream);
      break;
    case kMin:
      launch_partials<IdxT, kMin>(a, x, o, k, tr, window, lanes_per_row, stream);
      break;
    default:
      launch_partials<IdxT, kMax>(a, x, o, k, tr, window, lanes_per_row, stream);
      break;
  }
}

}  // namespace

// idx/mask/tile_window: n_shards device pointers each; n_ell: rows of each.
// vec != 0 takes the 16-slots-a-lane path; the caller checks K % 16 == 0
// and 16 B alignment of every idx and mask plane.
extern "C" int ell_partials_masked(const void* const* idx,
                                   const void* const* mask,
                                   const void* const* tile_window,
                                   const long long* n_ell, int n_shards,
                                   int idx_bytes, int vec, const void* msgs,
                                   void* out, int k, int tr, int window,
                                   int combine, void* stream) {
  if (n_shards <= 0 || n_shards > kMaxBatch || k <= 0 || tr <= 0 ||
      window <= 0 || combine < 0 || combine > 2 ||
      (idx_bytes != 2 && idx_bytes != 4) || (vec && k % kSlotsPerLane)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartialsArgs a;
  a.n = n_shards;
  a.row0[0] = 0;
  for (int s = 0; s < n_shards; ++s) {
    if (n_ell[s] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    a.idx[s] = idx[s];
    a.mask[s] = static_cast<const uint8_t*>(mask[s]);
    a.tile_window[s] = static_cast<const int32_t*>(tile_window[s]);
    a.row0[s + 1] = a.row0[s] + n_ell[s];
  }
  int lanes = 0;
  if (vec) {
    const int groups = k / kSlotsPerLane;
    lanes = 1;
    while (lanes < groups && lanes < 32) lanes <<= 1;
  }
  const auto* x = static_cast<const float*>(msgs);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 2) {
    launch_partials<int16_t>(a, x, o, k, tr, window, lanes, combine, s);
  } else {
    launch_partials<int32_t>(a, x, o, k, tr, window, lanes, combine, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// perm/row_ptr: n_shards device pointers each; n_ell and rows: each shard's
// ELL rows (its partials, in order in part) and destination rows.
extern "C" int segment_combine(const void* part, const void* const* perm,
                               const void* const* row_ptr,
                               const long long* n_ell, const int* rows,
                               int n_shards, void* out, int combine,
                               void* stream) {
  if (n_shards <= 0 || n_shards > kMaxBatch || combine < 0 || combine > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CombineArgs a;
  a.n = n_shards;
  a.dst0[0] = 0;
  long long ell = 0;
  for (int s = 0; s < n_shards; ++s) {
    if (rows[s] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    a.perm[s] = static_cast<const int32_t*>(perm[s]);
    a.row_ptr[s] = static_cast<const int32_t*>(row_ptr[s]);
    a.ell0[s] = ell;
    a.dst0[s + 1] = a.dst0[s] + rows[s];
    ell += n_ell[s];
  }
  constexpr int kRowsPerBlock = kCombineThreads / 32;
  const dim3 grid((a.dst0[n_shards] + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kCombineThreads);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(part);
  auto* o = static_cast<float*>(out);
  switch (combine) {
    case kSum:
      segment_combine_kernel<kSum><<<grid, block, 0, s>>>(a, p, o);
      break;
    case kMin:
      segment_combine_kernel<kMin><<<grid, block, 0, s>>>(a, p, o);
      break;
    default:
      segment_combine_kernel<kMax><<<grid, block, 0, s>>>(a, p, o);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
