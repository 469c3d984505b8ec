// Windowed row-split ELL pull-update for Hopper (sm_90a): the VSW hot loop.
//
// Five entry points, each a plain C function that launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().  All take a
// batch of up to kMaxBatch shards as tables of per-shard pointers, passed
// by value as a __grid_constant__ parameter, so a batch is one launch and
// no shard's arrays are ever copied into a concatenation.  The single-lane
// and the lane entry points share one templated device body each (a lane
// count of 1 and one compile-time combine for the former), so lane l of a
// lane launch folds exactly the values, in exactly the order, that a
// single-lane launch on message row l folds: the two agree bitwise.
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
//   P = K/16 threads (rounded up to a power of two, at most 32), so a warp
//   works on 32/P rows at once; a thread loads 16 mask bytes in one 16 B
//   load, and only if any is set the 16 indices, then gathers the set
//   slots with predicated loads that can all be in flight together.
//   Otherwise (any K) a warp takes one row, a thread one slot in 32.  No
//   shared-memory staging of the W-wide message window (the TPU kernel's
//   VMEM table): the gathers are few, and the whole message array (8 MB at
//   2^21 vertices) sits in L2.  A thread folds its slots in ascending
//   order and a fixed xor-shuffle tree folds the threads of a row, so a
//   result never changes from run to run or with the batch.
//
// ell_partials_sentinel  replaces the TPU kernel
//     src/repro/kernels/spmv_ell/kernel.py::ell_partials_sentinel
//   The masked update with no mask plane: idx points every padding slot at
//   an identity slot appended to its window (the caller stages messages as
//   [num_windows, window] with window = W + pad and the identity from
//   column W on), so partial[r] = COMBINE over ALL slots s of
//   msgs[tile_window[r / tr] * window + idx[r, s]].
//   Bound: memory.  Without a mask the function must read the whole idx
//   plane (2 B a slot at W <= 32767, else 4 B), the message sectors its
//   slots gather (the valid slots' and each window's identity sector),
//   tile_window and one float out per row.  Where most slots are padding
//   that is more than the masked kernel moves: its 1 B mask plane plus
//   only the idx sectors of set slots.
//   Design: the masked kernel's body with the mask test compiled out (a
//   template flag): the same row over K/16 threads, 16 indices a 32 B
//   load, the same ascending fold and xor-shuffle tree.  A padding slot
//   folds the identity, which leaves every partial's bits unchanged
//   (x + 0 == x for the sum, which never holds -0; fminf/fmaxf with
//   +inf/-inf), so sentinel partials are bitwise the masked partials on
//   the same slots, for all three combines.  The identity slots of a
//   window share one sector, which stays in L1.
//
// ell_partials_lanes  replaces both the vmapped TPU kernel of the lane
//     update (src/repro/kernels/spmv_ell/ops.py::_update_lanes_jit) and the
//     ragged TPU kernel (src/repro/kernels/spmv_ell/kernel.py::
//     ell_partials_ragged)
//   partial[r, l] for L message rows, lane l folding with its own combine
//   arm (cid[l] indexes arm_op; an id outside the arms marks a padding lane,
//   written as 0, as the ragged TPU kernel leaves it).  Both the messages
//   and the partials are lane-minor: messages [n_pad, S] and partials
//   [n_ell, S], with the lane stride S >= L a multiple of the chunk NL.  A
//   valid slot gathers its source's lanes from one contiguous run (one
//   32 B sector for 8 lanes) instead of L separate sectors, and a row's
//   partials leave in 16 B stores.
//   Bound: memory.  The mask plane and the idx sectors of set slots once
//   (not once per lane), the L * 4 B of messages each distinct gathered
//   source holds (whole sectors), tile_window and cid, and L floats out per
//   ELL row.
//   Design: the single-lane body, with the lanes processed in chunks of
//   NL (8, or 4/1 for few lanes) kept in registers; each chunk reloads the
//   row's mask and indices, which hit L1 after the first chunk.  The fold
//   order per lane is the single-lane kernel's.  Lanes are independent
//   float reductions, not a matrix product: no tensor cores.
//
// segment_combine  replaces the XLA segment_sum/min/max that follows the
//     TPU kernel (src/repro/kernels/spmv_ell/ops.py::_segment_combine)
//   out[r] = COMBINE over partial[perm[j]], j in [row_ptr[r], row_ptr[r+1]),
//   starting from the identity; an empty row gets the identity.  One warp
//   per destination row: thread t folds j = row_ptr[r] + t, + 32, ... in
//   ascending order, then a fixed xor-shuffle tree folds the threads.  No
//   atomics and a fixed order, so batched and per-shard launches give the
//   same bits.  Bound: memory — the partials of the non-padding rows, perm
//   and row_ptr read once, out written once.  The lane combine below is
//   the same templated body with a lane count of 1.
//
// segment_combine_lanes  replaces the vmapped segment combine of the lane
//     update and the per-arm combine plus select of the ragged update
//     (src/repro/kernels/spmv_ell/ops.py::_update_lanes_ragged_jit)
//   out[l, r] as segment_combine on lane l of the lane-minor partials with
//   lane l's own arm; padding lanes are written as 0.  The segment_combine
//   body with a lane chunk: a warp per destination row, thread t folding
//   j = row_ptr[r] + t, + 32, ... for NL lanes at once (one perm load, one
//   contiguous run of partials), then the same xor tree per lane, so lane
//   l is bitwise segment_combine on lane l.  Bound: memory — L floats of
//   each non-padding partial, perm and row_ptr once, L outputs a row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Combine : int { kSum = 0, kMin = 1, kMax = 2 };
constexpr int kPerLane = -1;  // combine read per lane at run time
constexpr int kPadLane = -1;  // a lane's op when it matches no arm

constexpr int kMaxBatch = 64;
constexpr int kMaxArms = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kCombineThreads = 256;
constexpr int kSlotsPerLane = 16;  // one 16 B load of mask bytes

// The identity and the fold of a combine: OP when it is known at compile
// time, else the run-time op of the lane (any op < 0 marks a padding lane,
// whose result is discarded).  The run-time fold selects the same
// arithmetic, so it gives the compile-time fold's bits.
template <int OP>
__device__ __forceinline__ float identity_of(int op) {
  if constexpr (OP == kSum) return 0.0f;
  else if constexpr (OP == kMin) return INFINITY;
  else if constexpr (OP == kMax) return -INFINITY;
  else return op == kSum ? 0.0f : (op == kMin ? INFINITY : -INFINITY);
}

template <int OP>
__device__ __forceinline__ float fold(int op, float a, float b) {
  if constexpr (OP == kSum) return a + b;
  else if constexpr (OP == kMin) return fminf(a, b);
  else if constexpr (OP == kMax) return fmaxf(a, b);
  else return op == kSum ? a + b : (op == kMin ? fminf(a, b) : fmaxf(a, b));
}

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

// The lane axis of a launch.  Single-lane launches: n_lanes = 1 and every
// stride 1.  Lane-minor tables hold a row's lanes side by side.
struct LaneArgs {
  const int32_t* cid;     // [n_lanes] arm of each lane (kPerLane only)
  long long out_stride;   // partials: elements between ELL rows of the
                          // output; combine: between lanes of the output
  int n_lanes;
  int stride;             // lane stride of the messages (partials) or of
                          // the partials (combine)
  int n_arms;
  int arm_op[kMaxArms];
};

template <int OP>
__device__ __forceinline__ int lane_op(const LaneArgs& la, int l) {
  if constexpr (OP != kPerLane) {
    return OP;
  } else {
    if (l >= la.n_lanes) return kPadLane;
    const int c = __ldg(la.cid + l);
    return (c >= 0 && c < la.n_arms) ? la.arm_op[c] : kPadLane;
  }
}

// NL consecutive lanes of one source from the vertex-major table.
template <int NL>
__device__ __forceinline__ void gather(const float* p, float (&v)[NL]) {
  if constexpr (NL == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int q = 0; q < NL / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  }
}

// NL consecutive lanes of one row of a lane-minor output.
template <int NL>
__device__ __forceinline__ void store(float* p, const float (&v)[NL]) {
  if constexpr (NL == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int q = 0; q < NL / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
}

// The shard holding global row r of a table of n first-rows (n is small).
template <typename T>
__device__ __forceinline__ int shard_of(const T* first, int n, long long r) {
  int s = 0;
  while (s + 1 < n && r >= first[s + 1]) ++s;
  return s;
}

template <typename IdxT, int OP, int NL, bool MASKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_partials_vec_kernel(const __grid_constant__ PartialsArgs a, LaneArgs la,
                        const float* __restrict__ msgs,
                        float* __restrict__ out, int k, int tr, int window,
                        int lanes_per_row) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes_per_row - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
          (32 / lanes_per_row) +
      lane / lanes_per_row;
  const bool live = row < a.row0[a.n];  // dead threads still join the shuffles
  const float* table = msgs;
  const IdxT* ri = nullptr;
  const uint8_t* rm = nullptr;
  if (live) {
    const int s = shard_of(a.row0, a.n, row);
    const long long r = row - a.row0[s];
    table = msgs + static_cast<long long>(__ldg(a.tile_window[s] + r / tr)) *
                       window * la.stride;
    ri = static_cast<const IdxT*>(a.idx[s]) + r * k;
    if constexpr (MASKED) rm = a.mask[s] + r * k;
  }
  const int n_lanes = OP == kPerLane ? la.n_lanes : 1;
  for (int l0 = 0; l0 < n_lanes; l0 += NL) {
    int op[NL];
    float acc[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      op[i] = lane_op<OP>(la, l0 + i);
      acc[i] = identity_of<OP>(op[i]);
    }
    if (live) {
      for (int c = sub * kSlotsPerLane; c < k; c += lanes_per_row * kSlotsPerLane) {
        uint32_t mw[4] = {~0u, ~0u, ~0u, ~0u};  // no mask: every slot folds
        if constexpr (MASKED) {
          const uint4 m = __ldg(reinterpret_cast<const uint4*>(rm + c));
          if ((m.x | m.y | m.z | m.w) == 0u) continue;
          mw[0] = m.x;
          mw[1] = m.y;
          mw[2] = m.z;
          mw[3] = m.w;
        }
        constexpr int kVecs = kSlotsPerLane * sizeof(IdxT) / sizeof(int4);
        int4 q[kVecs];
#pragma unroll
        for (int v = 0; v < kVecs; ++v) q[v] = __ldg(reinterpret_cast<const int4*>(ri + c) + v);
        IdxT j[kSlotsPerLane];
        memcpy(j, q, sizeof(q));
#pragma unroll
        for (int t = 0; t < kSlotsPerLane; ++t) {
          if ((mw[t / 4] >> (8 * (t % 4))) & 0xffu) {
            const int col = min(max(static_cast<int>(j[t]), 0), window - 1);
            float v[NL];
            gather<NL>(table + static_cast<long long>(col) * la.stride + l0, v);
#pragma unroll
            for (int i = 0; i < NL; ++i) acc[i] = fold<OP>(op[i], acc[i], v[i]);
          }
        }
      }
    }
    for (int off = lanes_per_row / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        acc[i] = fold<OP>(op[i], acc[i], __shfl_xor_sync(0xffffffffu, acc[i], off));
      }
    }
    if (live && sub == 0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) acc[i] = op[i] < 0 ? 0.0f : acc[i];
      store<NL>(out + row * la.out_stride + l0, acc);
    }
  }
}

template <typename IdxT, int OP, int NL, bool MASKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_partials_scalar_kernel(const __grid_constant__ PartialsArgs a, LaneArgs la,
                           const float* __restrict__ msgs,
                           float* __restrict__ out, int k, int tr, int window) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.row0[a.n]) return;  // whole warp leaves together
  const int s = shard_of(a.row0, a.n, row);
  const long long r = row - a.row0[s];
  const float* table = msgs + static_cast<long long>(__ldg(a.tile_window[s] + r / tr)) *
                                  window * la.stride;
  const IdxT* ri = static_cast<const IdxT*>(a.idx[s]) + r * k;
  const uint8_t* rm = MASKED ? a.mask[s] + r * k : nullptr;
  const int n_lanes = OP == kPerLane ? la.n_lanes : 1;
  for (int l0 = 0; l0 < n_lanes; l0 += NL) {
    int op[NL];
    float acc[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      op[i] = lane_op<OP>(la, l0 + i);
      acc[i] = identity_of<OP>(op[i]);
    }
    for (int t = lane; t < k; t += 32) {
      if (!MASKED || __ldg(rm + t)) {
        // clipped, as the TPU kernel's gather
        const int col = min(max(static_cast<int>(__ldg(ri + t)), 0), window - 1);
        float v[NL];
        gather<NL>(table + static_cast<long long>(col) * la.stride + l0, v);
#pragma unroll
        for (int i = 0; i < NL; ++i) acc[i] = fold<OP>(op[i], acc[i], v[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        acc[i] = fold<OP>(op[i], acc[i], __shfl_xor_sync(0xffffffffu, acc[i], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) acc[i] = op[i] < 0 ? 0.0f : acc[i];
      store<NL>(out + row * la.out_stride + l0, acc);
    }
  }
}

template <int OP, int NL>
__global__ void __launch_bounds__(kCombineThreads)
segment_combine_kernel(const __grid_constant__ CombineArgs a, LaneArgs la,
                       const float* __restrict__ part,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kCombineThreads / 32) + (threadIdx.x >> 5);
  if (r >= a.dst0[a.n]) return;  // whole warp leaves together
  const int s = shard_of(a.dst0, a.n, r);
  const int32_t* rp = a.row_ptr[s] + (r - a.dst0[s]);
  const int32_t* pm = a.perm[s];
  const float* p = part + a.ell0[s] * la.stride;
  const int begin = __ldg(rp);
  const int end = __ldg(rp + 1);
  const int n_lanes = OP == kPerLane ? la.n_lanes : 1;
  for (int l0 = 0; l0 < n_lanes; l0 += NL) {
    int op[NL];
    float acc[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      op[i] = lane_op<OP>(la, l0 + i);
      acc[i] = identity_of<OP>(op[i]);
    }
    for (int j = begin + lane; j < end; j += 32) {
      float v[NL];
      gather<NL>(p + static_cast<long long>(__ldg(pm + j)) * la.stride + l0, v);
#pragma unroll
      for (int i = 0; i < NL; ++i) acc[i] = fold<OP>(op[i], acc[i], v[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        acc[i] = fold<OP>(op[i], acc[i], __shfl_xor_sync(0xffffffffu, acc[i], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        if (l0 + i < n_lanes) out[(l0 + i) * la.out_stride + r] = op[i] < 0 ? 0.0f : acc[i];
      }
    }
  }
}

template <typename IdxT, int OP, int NL, bool MASKED>
void launch_partials(const PartialsArgs& a, const LaneArgs& la, const float* x,
                     float* o, int k, int tr, int window, int lanes_per_row,
                     cudaStream_t stream) {
  const long long rows = a.row0[a.n];
  const dim3 block(kWarpsPerBlock * 32);
  if (lanes_per_row > 0) {
    const long long per_block = static_cast<long long>(kWarpsPerBlock) * (32 / lanes_per_row);
    const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block));
    ell_partials_vec_kernel<IdxT, OP, NL, MASKED><<<grid, block, 0, stream>>>(
        a, la, x, o, k, tr, window, lanes_per_row);
  } else {
    const dim3 grid(static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
    ell_partials_scalar_kernel<IdxT, OP, NL, MASKED><<<grid, block, 0, stream>>>(
        a, la, x, o, k, tr, window);
  }
}

template <typename IdxT, bool MASKED>
void launch_single(const PartialsArgs& a, const LaneArgs& la, const float* x,
                   float* o, int k, int tr, int window, int lanes_per_row,
                   int combine, cudaStream_t stream) {
  switch (combine) {
    case kSum:
      launch_partials<IdxT, kSum, 1, MASKED>(a, la, x, o, k, tr, window, lanes_per_row, stream);
      break;
    case kMin:
      launch_partials<IdxT, kMin, 1, MASKED>(a, la, x, o, k, tr, window, lanes_per_row, stream);
      break;
    default:
      launch_partials<IdxT, kMax, 1, MASKED>(a, la, x, o, k, tr, window, lanes_per_row, stream);
      break;
  }
}

template <typename IdxT>
void launch_lanes(const PartialsArgs& a, const LaneArgs& la, const float* x,
                  float* o, int k, int tr, int window, int lanes_per_row,
                  int nl, cudaStream_t stream) {
  switch (nl) {
    case 1:
      launch_partials<IdxT, kPerLane, 1, true>(a, la, x, o, k, tr, window, lanes_per_row, stream);
      break;
    case 4:
      launch_partials<IdxT, kPerLane, 4, true>(a, la, x, o, k, tr, window, lanes_per_row, stream);
      break;
    default:
      launch_partials<IdxT, kPerLane, 8, true>(a, la, x, o, k, tr, window, lanes_per_row, stream);
      break;
  }
}

// Fills the shard table; returns false on a bad shape.
bool fill_partials(PartialsArgs* a, const void* const* idx,
                   const void* const* mask, const void* const* tile_window,
                   const long long* n_ell, int n_shards) {
  a->n = n_shards;
  a->row0[0] = 0;
  for (int s = 0; s < n_shards; ++s) {
    if (n_ell[s] <= 0) return false;
    a->idx[s] = idx[s];
    a->mask[s] = mask ? static_cast<const uint8_t*>(mask[s]) : nullptr;
    a->tile_window[s] = static_cast<const int32_t*>(tile_window[s]);
    a->row0[s + 1] = a->row0[s] + n_ell[s];
  }
  return true;
}

bool fill_combine(CombineArgs* a, const void* const* perm,
                  const void* const* row_ptr, const long long* n_ell,
                  const int* rows, int n_shards) {
  a->n = n_shards;
  a->dst0[0] = 0;
  long long ell = 0;
  for (int s = 0; s < n_shards; ++s) {
    if (rows[s] <= 0) return false;
    a->perm[s] = static_cast<const int32_t*>(perm[s]);
    a->row_ptr[s] = static_cast<const int32_t*>(row_ptr[s]);
    a->ell0[s] = ell;
    a->dst0[s + 1] = a->dst0[s] + rows[s];
    ell += n_ell[s];
  }
  return true;
}

// Threads a row is spread over on the vector path (0: the warp-per-row path).
int lanes_per_row(int k, int vec) {
  if (!vec) return 0;
  const int groups = k / kSlotsPerLane;
  int p = 1;
  while (p < groups && p < 32) p <<= 1;
  return p;
}

bool bad_shape(int n_shards, int k, int tr, int window, int idx_bytes, int vec) {
  return n_shards <= 0 || n_shards > kMaxBatch || k <= 0 || tr <= 0 ||
         window <= 0 || (idx_bytes != 2 && idx_bytes != 4) ||
         (vec && k % kSlotsPerLane);
}

LaneArgs single_lane() {
  LaneArgs la;
  memset(&la, 0, sizeof(la));
  la.n_lanes = 1;
  la.stride = 1;
  la.out_stride = 1;
  return la;
}

bool fill_lanes(LaneArgs* la, const void* cid, const int* arm_ops, int n_arms,
                int n_lanes) {
  memset(la, 0, sizeof(*la));
  if (n_lanes <= 0 || n_arms <= 0 || n_arms > kMaxArms) return false;
  for (int i = 0; i < n_arms; ++i) {
    if (arm_ops[i] < kSum || arm_ops[i] > kMax) return false;
    la->arm_op[i] = arm_ops[i];
  }
  la->cid = static_cast<const int32_t*>(cid);
  la->n_arms = n_arms;
  la->n_lanes = n_lanes;
  return true;
}

}  // namespace

// idx/mask/tile_window: n_shards device pointers each; n_ell: rows of each.
// vec != 0 takes the 16-slots-a-thread path; the caller checks K % 16 == 0
// and 16 B alignment of every idx and mask plane.
extern "C" int ell_partials_masked(const void* const* idx,
                                   const void* const* mask,
                                   const void* const* tile_window,
                                   const long long* n_ell, int n_shards,
                                   int idx_bytes, int vec, const void* msgs,
                                   void* out, int k, int tr, int window,
                                   int combine, void* stream) {
  PartialsArgs a;
  if (bad_shape(n_shards, k, tr, window, idx_bytes, vec) || combine < kSum ||
      combine > kMax || !fill_partials(&a, idx, mask, tile_window, n_ell, n_shards)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LaneArgs la = single_lane();
  const auto* x = static_cast<const float*>(msgs);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int p = lanes_per_row(k, vec);
  if (idx_bytes == 2) {
    launch_single<int16_t, true>(a, la, x, o, k, tr, window, p, combine, s);
  } else {
    launch_single<int32_t, true>(a, la, x, o, k, tr, window, p, combine, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As ell_partials_masked with no mask plane: window is the extended window
// (W + pad) and idx already points padding slots at its identity slots.
// vec != 0: the caller checks K % 16 == 0 and 16 B alignment of every idx
// plane.
extern "C" int ell_partials_sentinel(const void* const* idx,
                                     const void* const* tile_window,
                                     const long long* n_ell, int n_shards,
                                     int idx_bytes, int vec, const void* msgs,
                                     void* out, int k, int tr, int window,
                                     int combine, void* stream) {
  PartialsArgs a;
  if (bad_shape(n_shards, k, tr, window, idx_bytes, vec) || combine < kSum ||
      combine > kMax || !fill_partials(&a, idx, nullptr, tile_window, n_ell, n_shards)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LaneArgs la = single_lane();
  const auto* x = static_cast<const float*>(msgs);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int p = lanes_per_row(k, vec);
  if (idx_bytes == 2) {
    launch_single<int16_t, false>(a, la, x, o, k, tr, window, p, combine, s);
  } else {
    launch_single<int32_t, false>(a, la, x, o, k, tr, window, p, combine, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// msgs: the lane-minor message table [n_pad, lane_stride]; lanes
// 0..n_lanes-1 are read, lane_stride a multiple of nl (1, 4 or 8) and the
// table 16 B aligned for nl > 1.  cid: n_lanes int32 on the device;
// arm_ops: n_arms combines on the host.  out: the lane-minor partials
// [sum n_ell, lane_stride], 16 B aligned (padding columns written as 0).
extern "C" int ell_partials_lanes(const void* const* idx,
                                  const void* const* mask,
                                  const void* const* tile_window,
                                  const long long* n_ell, int n_shards,
                                  int idx_bytes, int vec, const void* msgs,
                                  int lane_stride, int n_lanes, int nl,
                                  const void* cid, const int* arm_ops,
                                  int n_arms, void* out, int k, int tr,
                                  int window, void* stream) {
  PartialsArgs a;
  LaneArgs la;
  if (bad_shape(n_shards, k, tr, window, idx_bytes, vec) ||
      (nl != 1 && nl != 4 && nl != 8) || lane_stride < n_lanes ||
      lane_stride % nl ||
      (nl > 1 && (reinterpret_cast<uintptr_t>(msgs) % 16 ||
                  reinterpret_cast<uintptr_t>(out) % 16)) ||
      !fill_partials(&a, idx, mask, tile_window, n_ell, n_shards) ||
      !fill_lanes(&la, cid, arm_ops, n_arms, n_lanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  la.stride = lane_stride;
  la.out_stride = lane_stride;
  const auto* x = static_cast<const float*>(msgs);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int p = lanes_per_row(k, vec);
  if (idx_bytes == 2) {
    launch_lanes<int16_t>(a, la, x, o, k, tr, window, p, nl, s);
  } else {
    launch_lanes<int32_t>(a, la, x, o, k, tr, window, p, nl, s);
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
  CombineArgs a;
  if (n_shards <= 0 || n_shards > kMaxBatch || combine < kSum || combine > kMax ||
      !fill_combine(&a, perm, row_ptr, n_ell, rows, n_shards)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LaneArgs la = single_lane();
  constexpr int kRowsPerBlock = kCombineThreads / 32;
  const dim3 grid((a.dst0[n_shards] + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kCombineThreads);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(part);
  auto* o = static_cast<float*>(out);
  switch (combine) {
    case kSum:
      segment_combine_kernel<kSum, 1><<<grid, block, 0, s>>>(a, la, p, o);
      break;
    case kMin:
      segment_combine_kernel<kMin, 1><<<grid, block, 0, s>>>(a, la, p, o);
      break;
    default:
      segment_combine_kernel<kMax, 1><<<grid, block, 0, s>>>(a, la, p, o);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// part: lane-minor partials [sum n_ell, part_stride] (lanes 0..n_lanes-1
// read; part_stride a multiple of nl, the table 16 B aligned for nl > 1);
// out: [n_lanes, sum rows]; cid/arm_ops as for ell_partials_lanes.
extern "C" int segment_combine_lanes(const void* part, int part_stride,
                                     const void* const* perm,
                                     const void* const* row_ptr,
                                     const long long* n_ell, const int* rows,
                                     int n_shards, int n_lanes, int nl,
                                     const void* cid, const int* arm_ops,
                                     int n_arms, void* out, void* stream) {
  CombineArgs a;
  LaneArgs la;
  if (n_shards <= 0 || n_shards > kMaxBatch || (nl != 1 && nl != 4 && nl != 8) ||
      part_stride < n_lanes || part_stride % nl ||
      (nl > 1 && reinterpret_cast<uintptr_t>(part) % 16) ||
      !fill_combine(&a, perm, row_ptr, n_ell, rows, n_shards) ||
      !fill_lanes(&la, cid, arm_ops, n_arms, n_lanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  la.stride = part_stride;
  la.out_stride = a.dst0[n_shards];
  constexpr int kRowsPerBlock = kCombineThreads / 32;
  const dim3 grid((a.dst0[n_shards] + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kCombineThreads);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(part);
  auto* o = static_cast<float*>(out);
  switch (nl) {
    case 1:
      segment_combine_kernel<kPerLane, 1><<<grid, block, 0, s>>>(a, la, p, o);
      break;
    case 4:
      segment_combine_kernel<kPerLane, 4><<<grid, block, 0, s>>>(a, la, p, o);
      break;
    default:
      segment_combine_kernel<kPerLane, 8><<<grid, block, 0, s>>>(a, la, p, o);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
