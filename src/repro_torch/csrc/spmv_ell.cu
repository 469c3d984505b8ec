// Windowed row-split ELL pull-update for Hopper (sm_90a): the VSW hot loop.
//
// Five entry points, each a plain C function that launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().  All take a
// batch of up to kMaxBatch shards as tables of per-shard pointers, passed
// by value as a __grid_constant__ parameter, so a batch is one launch and
// no shard's arrays are ever copied into a concatenation.  Lane l of a lane
// launch folds exactly the values, in exactly the order, that a
// single-lane launch on message row l folds, so the two agree bitwise: on
// the warp-per-row path they share one templated body (a lane count of 1
// and a compile-time combine for the single-lane one); on the vector path
// every kernel keeps the single-lane order's accumulators and tree (see
// ell_partials_masked, ell_partials_lanes and segment_combine_lanes).
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
//   one float out per row.  Most of the idx plane is never read.  On the
//   smoke's batch the mask plane is 73% of those bytes, so the kernel is a
//   stream of the mask plane with a little gather work on the side.
//   The single-lane order, which every partials kernel keeps: a row's
//   16-slot units are dealt to P = K/16 accumulators (rounded up to a
//   power of two, at most 32), accumulator p folding the set slots of
//   units p, p + P, ... in ascending slot order from the identity; then
//   the P accumulators are folded in a fixed tree, acc[q] = fold(acc[q],
//   acc[q + off]) for q < off, off = P/2 ... 1 (an xor-shuffle tree over P
//   threads, as seen from its thread 0).  So a result never changes from
//   run to run or with the batch.
//   Design (K % 16 == 0, 16 B aligned planes, K <= 128): a warp takes one
//   set of 32 rows, a thread a row.  A thread loads its row's P mask units
//   (all in flight at once: 32 rows' masks are 4 KB a warp at K = 128),
//   and ballots list the set's items: (row, accumulator p) with a set
//   slot.  The items go to the warp's threads in turn; an item's thread
//   reads its unit's 16 indices once and issues its 16 gathers before its
//   first fold, and leaves the accumulator in shared memory; then thread
//   t folds row t's accumulators in the tree and the warp stores the 32
//   partials in one coalesced run.  So one dependent chain (mask, indices,
//   gathers) serves 32 rows, where a row over P threads served 32 / P.
//   The sets of the batch's shards are interleaved (warp g: set g / n of
//   shard g % n), so the warps in flight gather from the same windows.
//   Two things keep the gathers in flight together.  No load is
//   predicated (a predicated load's register is moved out at once, which
//   waits for it), and an unset slot of an item's unit loads the
//   combine's identity from a fixed device slot (it stays in L1) and
//   folds it, so the folds need no predicate a slot (a warp has 7; short
//   of them the compiler interleaves loads and folds, one round trip
//   each).  Folding the identity changes no bit, for the reason given
//   below (ell_partials_lanes): an accumulator is never -0.0, nor NaN for
//   min/max.  The tree leaves out the folds whose second operand is an
//   accumulator with no item, for that reason too.  So the partials are
//   bitwise the single-lane order.  K > 128 (P = 16, 32, rows too wide
//   for a thread's registers) takes the vector body that the sentinel
//   kernel shares: a row over P threads, each folding its units in the
//   single-lane order, then an xor-shuffle tree.  Otherwise (any K) a warp
//   takes one row, a thread one slot in 32.  No shared-memory staging of
//   the W-wide message window (the TPU kernel's VMEM table): the gathers
//   are few, and the whole message array (8 MB at 2^21 vertices) sits in
//   L2.  Designs that measured slower on the smoke's batch: a persistent
//   warp streaming its run of the mask plane through a shared-memory ring
//   by bulk copies (cp.async.bulk on mbarriers), per warp or per block,
//   and a register pipeline of the vector body three sets deep.  The
//   ring's shared memory held occupancy to 16 warps an SM, and every
//   longer run of sets a warp lost to the tail of its heaviest rows.
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
//   Design: the masked partials' vector body with the mask test compiled
//   out (a template flag): a row over P threads, thread p folding all 16
//   slots of units p, p + P, ... (16 indices a 32 B load) in ascending
//   order, then an xor-shuffle tree over the row's threads: the
//   single-lane order over every slot.  A padding slot folds the
//   identity, which leaves every
//   partial's bits unchanged (x + 0 == x for the sum, which never holds
//   -0; fminf/fmaxf with +inf/-inf), so sentinel partials are bitwise the
//   masked partials on the same slots, for all three combines.  The
//   identity slots of a window share one sector, which stays in L1.
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
//   128 B line for 32 lanes) instead of L separate sectors.
//   Bound: memory.  The mask plane and the idx sectors of set slots once
//   (not once per lane), the L * 4 B of messages each distinct gathered
//   source holds (whole sectors), tile_window and cid, and L floats out per
//   ELL row.  The gathers themselves move one run per valid slot (8.4 M
//   slots x 128 B = 1.07 GB at L=32 on the smoke's batch) through L2,
//   which the bound does not count: the window a tile gathers from
//   (W x S x 4 B = 2 MB at W=16384, L=32) is larger than a block's 227 KB
//   of shared memory, so it is left to L2, not staged.
//   Design (the vector path: K % 16 == 0, 16 B aligned planes): the lane
//   axis is on threads, and each row is read once for all its lanes.  T
//   threads own a row, V lanes each (V = 1, 2 or 4, as the lane stride and
//   the registers allow; T at least P = lanes_per_row(k, 1)), so a warp
//   works on a set of 32 / T rows at once.  A warp walks a run of 16 sets;
//   two set records in shared memory, filled by cp.async, keep the next
//   set's mask bytes (units 0..P-1 of a row, one 16 B load a unit), unit-0
//   indices and tile_window entries on their way while it works.
//   Per set, one thread a (row, unit) turns the unit's 16 mask bytes into
//   16 bits, and a ballot lists the set's items: (row, accumulator p) with
//   a set slot.  The set's 32 / T thread groups take the items in turn (a
//   full row is 8 items at K=128, not one thread walking 128 slots): a
//   group reads the unit's 16 indices once, gathers each set slot's V lanes
//   a thread (one source's lanes are one contiguous run of the group),
//   16 / V gathers in flight before it folds them in slot order, and leaves
//   the accumulator in shared memory.  Then each row's group folds the
//   row's accumulators in the tree below and writes the row's S lanes in
//   one coalesced store; padding lanes and the columns from L to S are
//   written as 0.  A lane's combine arm is read once.  A launch with one
//   arm folds with a compile-time combine; in a ragged launch a thread
//   whose lanes share an arm folds with that arm's (one branch an arm
//   present in the warp), else with the run-time select of each lane's.
//   Each shard is cut into runs of
//   equal share, and warp g takes run g / n of shard g % n, so the warps in
//   flight hold the same stretch of every shard of the batch, whose rows
//   gather from the same few windows (one shard's run after another would
//   fetch each window from memory once a shard).  A warp's accumulators
//   (P x S floats a row of its set) must fit a block's shared memory: a
//   lane stride past that (about 1,800 lanes at K >= 512) is refused
//   before any launch, as no other kernel keeps the fold order.
//   Why lane l is bitwise the single-lane kernel on row l: accumulator p
//   of a lane folds exactly the slots of the single-lane order's
//   accumulator p, in that order (one item), and the accumulators are
//   folded in that order's tree.  Only the folds whose second operand is
//   an accumulator with no item are left out, and they change no bit:
//   that operand is the identity, and an accumulator is never -0.0 (it
//   starts at +0.0, and x + y is -0.0 only if both are; nothing is flushed
//   to zero: no fast-math flags) nor, for min/max, NaN (fminf/fmaxf return
//   the non-NaN operand, and it starts at +-inf), so x + 0 == x,
//   fminf(x, +inf) == x and fmaxf(x, -inf) == x, NaN sums being the
//   card's one canonical NaN either way.  No fold is reordered.
//   tests/test_torch_lanes.py models both orders in numpy, bitwise.  No
//   tensor cores: the lanes are independent float reductions.
//   Otherwise (any K) the warp-per-row body of the single-lane kernel, NL
//   lanes a chunk (8, or 4/1 for few lanes) kept in registers.
//
// segment_combine  replaces the XLA segment_sum/min/max that follows the
//     TPU kernel (src/repro/kernels/spmv_ell/ops.py::_segment_combine)
//   out[r] = COMBINE over partial[perm[j]], j in [row_ptr[r], row_ptr[r+1]),
//   starting from the identity; an empty row gets the identity.  The
//   order, which every combine keeps (the warp-per-row order): 32
//   accumulators, accumulator t folding j = row_ptr[r] + t, + 32, ... in
//   ascending order from the identity, then a fixed xor-shuffle tree as
//   seen from thread 0.  No atomics and a fixed order, so batched and
//   per-shard launches give the same bits.  Bound: memory — the partials
//   of the non-padding rows, perm and row_ptr read once, out written once;
//   counted in whole 32 B sectors, the sectors the gathers touch.  What the
//   bound leaves out: the gathers are random 4 B reads of the partials
//   (a row's partials come from different windows' ELL blocks), each
//   moving its own 32 B sector from L2.
//   Design: kRowThreads (G = 4) threads a row, 32 / G rows a warp, all of
//   one shard, dealt n_warps apart (the shard's warp count, odd).  R-MAT's
//   heavy rows are those with many low zero bits (on the smoke's batch
//   row 0 folds 904 partials and rows 1-31 79-344), so rows dealt in runs
//   would give a few warps most of the work; with n_warps odd a warp's
//   rows take every residue mod 32 / G once.  The order's accumulator a
//   lives in thread a % G of the row's group as its slot a / G, so the
//   tree's levels 16 ... G stay in each thread and two shuffles in the
//   group finish it: no shuffle a batch, and a batch of a row's 32 entries
//   is 8 loads a thread, the group's 4 threads reading 4 consecutive perm
//   entries in each.  A group walks its
//   row two batches at a time (16 perm loads, then 16 gathers, in flight a
//   thread).  Rows past kGroupRows partials (0.8% of the smoke's rows) are
//   walked afterwards by the whole warp, kWarpBatches batches in flight.
//   Designs that measured slower on the smoke's batch: a thread a row
//   (consecutive rows, or strided with the warp taking the long rows from
//   a cursor that deals batches across rows), and all 32 rows of a warp
//   in lockstep rounds with a transpose tree: their per-row shuffles
//   outnumbered the loads, and their predicated folds sat each right after
//   its gather.
//
// segment_combine_lanes  replaces the vmapped segment combine of the lane
//     update and the per-arm combine plus select of the ragged update
//     (src/repro/kernels/spmv_ell/ops.py::_update_lanes_ragged_jit)
//   out[l, r] as segment_combine on lane l of the lane-minor partials with
//   lane l's own arm; padding lanes are written as 0.
//   Bound: memory — L floats of each non-padding partial, perm and row_ptr
//   once, L outputs a row.  On the smoke's batch that is about 23 partial
//   rows of L * 4 B each (128 B at L=32) for each destination row.
//   Design: the lane axis on threads.  T threads own a destination row, a
//   lane each (T = L rounded up to a power of two, at most 32; a wider
//   launch takes the lanes in passes of 32), so a warp works on 32 / T
//   rows at once and reads each partial row as one contiguous run of its
//   lanes.  A row's thread group loads perm 32 entries at a time, T to a
//   coalesced load, and hands them out by shuffle; each thread keeps the
//   32 accumulators of its lane in registers, entry j folding into
//   accumulator (j - row_ptr[r]) % 32, and issues a batch's 32 loads
//   before its first fold.  That is segment_combine's thread t (which
//   folds j = row_ptr[r] + t, + 32, ... in ascending order from the
//   identity), and the accumulators are then folded in segment_combine's
//   xor tree as seen from its thread 0, acc[q] = fold(acc[q], acc[q +
//   off]) for q < off, all 31 folds, so lane l is bitwise segment_combine
//   on lane l with nothing left out.  A launch with one arm folds with a
//   compile-time combine; in a ragged one each thread folds its lane's
//   arm (a branch a thread: the shuffles come before it).  A block stages
//   its 32 or more destination rows in shared memory and writes each
//   lane's run of them contiguously: the output is [L, rows].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"  // cp.async helpers

namespace {

enum Combine : int { kSum = 0, kMin = 1, kMax = 2 };
constexpr int kPerLane = -1;  // combine read per lane at run time
constexpr int kPadLane = -1;  // a lane's op when it matches no arm

constexpr int kMaxBatch = 64;
constexpr int kMaxArms = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kCombineThreads = 256;
constexpr int kRowThreads = 4;    // threads a row of the single-lane combine
constexpr int kGroupRows = 128;   // the longest row those threads walk; longer: the warp
constexpr int kWarpBatches = 16;  // batches of 32 the warp has in flight on a long row
constexpr int kSlotsPerLane = 16;  // one 16 B load of mask bytes
constexpr int kLaneRowSets = 16;   // row sets a warp of the lane kernel walks
constexpr int kLaneStages = 2;     // sets staged at once, in shared memory
constexpr int kLaneBlocksPerSM = 3;  // 85 registers a thread at most
constexpr int kGatherFloats = 16;    // floats a lane thread gathers at once
constexpr int kBlockSmem = 227 * 1024;  // an H100 block's shared memory, opted in
constexpr int kCombineWarps = 8;     // warps a block of the lane combine

// Each combine's identity in device memory, for a load that stands in for
// a slot with no message (it stays in L1).
__device__ const float kIdentities[3] = {0.0f, INFINITY, -INFINITY};
// The index an entry past its row loads in place of perm (it stays in L1).
__device__ const int32_t kZeroIndex = 0;

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
  int warp0[kMaxBatch + 1];   // segment_combine: first warp of each shard; warp0[n] = total
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

// NL consecutive lanes of one source from the vertex-major table (NL = 1,
// 2 or a multiple of 4, 4 B aligned times NL up to 16 B).
template <int NL>
__device__ __forceinline__ void gather(const float* p, float (&v)[NL]) {
  if constexpr (NL == 1) {
    v[0] = __ldg(p);
  } else if constexpr (NL == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
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

// NL consecutive lanes of one row of a lane-minor output (NL as gather's).
template <int NL>
__device__ __forceinline__ void store(float* p, const float (&v)[NL]) {
  if constexpr (NL == 1) {
    *p = v[0];
  } else if constexpr (NL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
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

// The single-lane partials on the vector path (the sentinel's, and the
// masked partials' where K > 128): a row over lanes_per_row threads,
// thread sub folding its 16-slot units sub, sub + lanes_per_row, ... in
// ascending slot order (every slot without a mask plane), then an
// xor-shuffle tree over the row's threads: the single-lane order.
template <typename IdxT, int OP, bool MASKED>
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
  const bool live = row < a.row0[a.n];  // dead threads still join the shuffles
  float acc = identity_of<OP>(OP);
  if (live) {
    const int s = shard_of(a.row0, a.n, row);
    const long long r = row - a.row0[s];
    const float* table =
        msgs + static_cast<long long>(__ldg(a.tile_window[s] + r / tr)) * window;
    const IdxT* ri = static_cast<const IdxT*>(a.idx[s]) + r * k;
    const uint8_t* rm = MASKED ? a.mask[s] + r * k : nullptr;
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
          acc = fold<OP>(OP, acc, __ldg(table + col));
        }
      }
    }
  }
  for (int off = lanes_per_row / 2; off > 0; off >>= 1) {
    acc = fold<OP>(OP, acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (live && sub == 0) out[row] = acc;
}

// Bit t set where byte t of the 16 mask bytes is non-zero.
__device__ __forceinline__ uint32_t slot_bits(uint4 m) {
  const uint32_t x[4] = {m.x, m.y, m.z, m.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // one bit a byte at bits 0, 8, 16, 24; the product gathers them,
    // byte 0 lowest, into its top byte
    const uint32_t b = __vcmpne4(x[q], 0u) & 0x01010101u;
    bits |= ((b * 0x01020408u) >> 24) << (4 * q);
  }
  return bits;
}

// A warp's shared memory in a lane launch, for `sets` rows at once: a ring
// of kLaneStages records of a set (the mask bytes of units 0..P-1 of each
// row, zeros past K; the 16 indices of unit 0 of each row; each row's
// tile_window entry), the set's slot bits (16 a unit), and its
// accumulators: P of each of the row's S lanes.
template <typename IdxT, int P>
struct LaneSmem {
  static constexpr int kVecs = kSlotsPerLane * sizeof(IdxT) / sizeof(int4);
  int idx_at, tw_at, set_bytes, bits_at, acc_at, bytes;
  __device__ __host__ LaneSmem(int sets, int lane_stride)
      : idx_at(16 * P * sets),
        tw_at(16 * (P + kVecs) * sets),
        set_bytes(16 * (P + kVecs) * sets + (4 * sets + 15) / 16 * 16),
        bits_at(kLaneStages * set_bytes),
        acc_at(bits_at + (2 * P * sets + 15) / 16 * 16),
        bytes(acc_at + 4 * P * sets * lane_stride) {}
};

// A warp's run of rows of one shard, and what each of its threads copies
// of every set of it into shared memory: thread `lane` < sets * P the mask
// bytes of unit lane % P of row lane / P, threads c < sets * kVecs 16 B of
// the unit-0 indices, thread `lane` < sets the tile_window entry of row
// `lane` (tracked from set to set without a division).
template <typename IdxT, int P>
struct LaneRun {
  static constexpr int kVecs = LaneSmem<IdxT, P>::kVecs;
  const uint8_t* mask;  // the run's first row
  const IdxT* idx;
  const int32_t* tw;
  int rows, k, units, sets;
  int tile, rem, tr;  // this thread's next tile_window row: tile, row % tr

  __device__ void stage(uint8_t* rec, const LaneSmem<IdxT, P>& sm, int set, int lane,
                        const void* none) {
    const int r0 = set * sets;
    if (lane < sets * P) {  // sets * P <= 32: one mask unit a thread
      const int r = r0 + lane / P;
      const int u = lane % P;
      const bool ok = r < rows && u < units;
      mma::cp_async_16(rec + 16 * lane, ok ? mask + r * k + 16 * u : none, ok);
    }
    for (int c = lane; c < sets * kVecs; c += 32) {
      const int r = r0 + c / kVecs;
      const bool ok = r < rows;
      mma::cp_async_16(rec + sm.idx_at + 16 * c,
                   ok ? reinterpret_cast<const int4*>(idx + r * k) + c % kVecs : none, ok);
    }
    if (lane < sets) {
      const bool ok = r0 + lane < rows;
      mma::cp_async_4(rec + sm.tw_at + 4 * lane, ok ? tw + tile : none, ok);
      for (rem += sets; rem >= tr; rem -= tr) ++tile;
    }
  }
};

// Folds gathered slots t (bit t of w) into a thread's V lanes, in order.
template <int V, int OP, int N>
__device__ __forceinline__ void fold_batch(float (&acc)[V], const int (&op)[V], uint32_t w,
                                           const float (&x)[N][V]) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if ((w >> t) & 1u) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fold<OP>(op[v], acc[v], x[t][v]);
    }
  }
}

// Folds the set slots of one 16-slot unit (bits w, its 16 indices at ix)
// into a thread's V lanes of one accumulator, in slot order: 16 / V slots
// at a time, their gathers all issued before the first fold.
// `lanes` is the thread's first lane of the row's window; a source's lanes
// start col * stride after it.
template <typename IdxT, int V, int OP>
__device__ __forceinline__ void fold_unit(float (&acc)[V], const int (&op)[V], int arm,
                                          uint32_t w, const IdxT* ix, const float* lanes,
                                          int stride, int window) {
  constexpr int kVecs = kSlotsPerLane * sizeof(IdxT) / sizeof(int4);
  int4 q[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) q[v] = reinterpret_cast<const int4*>(ix)[v];
  IdxT j[kSlotsPerLane];
  memcpy(j, q, sizeof(q));
  constexpr int kBatch = kGatherFloats / V;
#pragma unroll
  for (int h = 0; h < kSlotsPerLane; h += kBatch) {
    if (((w >> h) & ((1u << kBatch) - 1u)) == 0u) continue;
    float x[kBatch][V];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      if ((w >> (h + t)) & 1u) {
        const int col = min(max(static_cast<int>(j[h + t]), 0), window - 1);
        gather<V>(lanes + static_cast<unsigned>(col * stride), x[t]);
      }
    }
    if constexpr (OP != kPerLane) {
      fold_batch<V, OP>(acc, op, w >> h, x);
    } else if (arm == kSum) {  // all the thread's lanes on one arm: its
      fold_batch<V, kSum>(acc, op, w >> h, x);  // compile-time fold, a
    } else if (arm == kMin) {                   // branch for each arm
      fold_batch<V, kMin>(acc, op, w >> h, x);  // present in the warp
    } else if (arm == kMax) {
      fold_batch<V, kMax>(acc, op, w >> h, x);
    } else {
      fold_batch<V, kPerLane>(acc, op, w >> h, x);
    }
  }
}

// A row's result from its P accumulators (acc[q * stride], those in
// `held`): the single-lane order's tree, acc[q] = fold(acc[q], acc[q +
// off]) for q < off, off = P/2 ... 1, less its folds whose second operand
// is an accumulator that holds no item.  Those hold the identity, and
// fold(x, identity) is x bitwise for every x an accumulator can hold (see
// the source note); a row with none is the identity.
template <int P, int OP>
__device__ __forceinline__ float held_tree(uint32_t held, int op, const float* acc_at,
                                           int stride) {
  if (held == 1u) return acc_at[0];  // accumulator 0 alone: no fold is left
  float acc[P];
  uint32_t left = held;
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = (held >> q) & 1u ? acc_at[q * stride] : identity_of<OP>(op);
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < off; ++q) {
      if ((left >> (q + off)) & 1u) acc[q] = fold<OP>(op, acc[q], acc[q + off]);
    }
    left |= left >> off;
  }
  return acc[0];
}

// The lane partials on the vector path (see the source note).  A warp
// walks its run of rows in sets of 32 / T rows.  Each set's work is a list
// of items, one for each (row, accumulator p) that has a set slot: the
// slots of units p, p + P, ... of that row, in order.  The 32 / T groups of
// T threads take the items in turn, a thread V lanes of the row (lanes
// V sub .. V sub + V - 1, then V (sub + T) ...), and leave each
// accumulator in shared memory; a row's thread group then folds its
// accumulators in the single-lane kernel's xor tree, as seen from that
// kernel's thread 0, and stores the row.  OP is the combine of every lane
// where the launch has one arm, else kPerLane.  Each shard is cut into
// `chunks` runs of whole sets; warp g takes run g / n of shard g % n, so
// the warps in flight hold the same stretch of every shard, whose rows
// gather from the same few windows.  The ring of kLaneStages set records,
// filled by cp.async, keeps the next sets' masks, unit-0 indices and
// tile_window entries on their way while the warp gathers.
template <typename IdxT, int P, int V, int OP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kLaneBlocksPerSM)
ell_partials_lanes_kernel(const __grid_constant__ PartialsArgs a,
                          const __grid_constant__ LaneArgs la,
                          const float* __restrict__ msgs,
                          float* __restrict__ out, int k, int tr, int window,
                          int row_threads, int chunks) {
  extern __shared__ __align__(16) uint8_t lane_smem[];
  const int lane = threadIdx.x & 31;
  const int sub = lane & (row_threads - 1);
  const int g = lane / row_threads;   // the thread's group, and its row of a set
  const int sets = 32 / row_threads;  // rows a warp works on at once
  const int stride = la.stride;
  const LaneSmem<IdxT, P> sm(sets, stride);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int s = warp % a.n;
  const int n_rows = static_cast<int>(a.row0[s + 1] - a.row0[s]);
  const int run = ((n_rows + chunks - 1) / chunks + sets - 1) / sets * sets;
  const int begin = min(warp / a.n * run, n_rows);
  const int end = min(begin + run, n_rows);
  const int n_sets = (end - begin + sets - 1) / sets;
  LaneRun<IdxT, P> rr;
  rr.mask = a.mask[s] + static_cast<long long>(begin) * k;
  rr.idx = static_cast<const IdxT*>(a.idx[s]) + static_cast<long long>(begin) * k;
  rr.tw = a.tile_window[s];
  rr.rows = end - begin;
  rr.k = k;
  rr.units = k / kSlotsPerLane;
  rr.sets = sets;
  rr.tr = tr;
  rr.tile = (begin + lane) / tr;
  rr.rem = (begin + lane) % tr;
  const void* none = a.mask[0];  // an aligned address that is not read
  uint8_t* base = lane_smem + (threadIdx.x >> 5) * sm.bytes;
  uint16_t* bits = reinterpret_cast<uint16_t*>(base + sm.bits_at);
  float* accs = reinterpret_cast<float*>(base + sm.acc_at);
  const int rounds = (rr.units + P - 1) / P;
  const int blocks = (stride + row_threads * V - 1) / (row_threads * V);
  const uint32_t row_units = P == 32 ? ~0u : (1u << P) - 1u;
  float* out_rows = out + (a.row0[s] + begin) * la.out_stride;
  int op0[V];  // the arms of a thread's lanes of block 0, read once
#pragma unroll
  for (int v = 0; v < V; ++v) op0[v] = lane_op<kPerLane>(la, sub * V + v);

  for (int i = 0; i < kLaneStages - 1; ++i) {
    if (i < n_sets) rr.stage(base + i * sm.set_bytes, sm, i, lane, none);
    mma::cp_async_commit();
  }
  for (int i = 0; i < n_sets; ++i) {
    const int ahead = i + kLaneStages - 1;
    if (ahead < n_sets) {
      rr.stage(base + (ahead % kLaneStages) * sm.set_bytes, sm, ahead, lane, none);
    }
    mma::cp_async_commit();  // empty groups keep the count
    mma::cp_async_wait<kLaneStages - 1>();
    __syncwarp();
    const uint8_t* rec = base + (i % kLaneStages) * sm.set_bytes;
    const int r0 = i * sets;  // the set's first row, from the run's first
    // Thread c < sets * P turns unit c % P of row c / P into slot bits.
    uint32_t mine = 0u;
    if (lane < sets * P) {
      mine = slot_bits(reinterpret_cast<const uint4*>(rec)[lane]);
      bits[lane] = static_cast<uint16_t>(mine);
    }
    // The items: bit c for (row c / P, accumulator c % P).  Past round 0
    // every accumulator of a live row is one (its units are read then).
    const uint32_t items = __ballot_sync(
        0xffffffffu, lane < sets * P &&
                         (rounds == 1 ? mine != 0u : r0 + lane / P < rr.rows));
    __syncwarp();
    for (int wave = 0; wave < __popc(items); wave += sets) {
      const int it = wave + g;
      if (it >= __popc(items)) break;  // no warp-wide step below
      const int c = __fns(items, 0, it + 1);
      const int gi = c / P;  // the item's row of the set, and accumulator
      const int p = c % P;
      const int r = r0 + gi;
      const float* table =
          msgs + static_cast<long long>(reinterpret_cast<const int32_t*>(rec + sm.tw_at)[gi]) *
                     window * stride;
      for (int b = 0; b < blocks; ++b) {
        const int l0 = (b * row_threads + sub) * V;
        if (l0 >= stride) break;
        int op[V];
        float acc[V];
        int arm = 0;  // the combine of all the thread's lanes, else kPerLane
#pragma unroll
        for (int v = 0; v < V; ++v) {
          op[v] = b == 0 ? op0[v] : lane_op<kPerLane>(la, l0 + v);
          acc[v] = identity_of<OP>(op[v]);
          arm = v == 0 ? op[0] : (op[v] == arm ? arm : kPerLane);
        }
        for (int rd = 0; rd < rounds; ++rd) {
          const int u = rd * P + p;
          if (u >= rr.units) break;
          const uint32_t w_u =
              rd == 0 ? bits[c]
                      : slot_bits(__ldg(reinterpret_cast<const uint4*>(rr.mask + r * k) + u));
          const IdxT* ix = u == 0 ? reinterpret_cast<const IdxT*>(rec + sm.idx_at) +
                                        gi * kSlotsPerLane  // staged
                                  : rr.idx + r * k + u * kSlotsPerLane;
          fold_unit<IdxT, V, OP>(acc, op, arm, w_u, ix, table + l0, stride, window);
        }
        store<V>(accs + (c * stride + l0), acc);
      }
    }
    __syncwarp();
    // Each row's tree, a lane at a time (held_tree).
    const int r = r0 + g;
    if (r < rr.rows) {
      for (int b = 0; b < blocks; ++b) {
        const int l0 = (b * row_threads + sub) * V;
        if (l0 >= stride) break;
        int op[V];
#pragma unroll
        for (int v = 0; v < V; ++v) op[v] = b == 0 ? op0[v] : lane_op<kPerLane>(la, l0 + v);
        const uint32_t held = (items >> (g * P)) & row_units;
        const float* row_accs = accs + (g * P * stride + l0);
        float res[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          res[v] = op[v] < 0 ? 0.0f : held_tree<P, OP>(held, op[v], row_accs + v, stride);
        }
        store<V>(out_rows + static_cast<long long>(r) * la.out_stride + l0, res);
      }
    }
    __syncwarp();  // every thread is done with this set before it is refilled
  }
}

// Index t of a 16-slot unit held as int4s (t a constant once unrolled).
template <typename IdxT>
__device__ __forceinline__ int unit_index(const int4 (&q)[kSlotsPerLane * sizeof(IdxT) / 16],
                                          int t) {
  constexpr int kPerVec = 16 / sizeof(IdxT);
  const int4& v = q[t / kPerVec];
  const int c = t % kPerVec * sizeof(IdxT) / 4;  // the 32-bit word holding it
  const int w = c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  if constexpr (sizeof(IdxT) == 2) {
    return static_cast<int16_t>(w >> (16 * (t % 2)));  // little-endian halves
  } else {
    return w;
  }
}

// The 16 gathers of one unit (bits w, indices q) from `table`, into x: no
// load is predicated, and an unset slot loads the identity, so the fold
// needs no predicate register a slot (a warp has 7) and all 16 loads are
// in flight at once.  Folding an identity changes no bit (see the source
// note).
template <typename IdxT, int OP>
__device__ __forceinline__ void gather_unit(float (&x)[kSlotsPerLane], uint32_t w,
                                            const int4 (&q)[kSlotsPerLane * sizeof(IdxT) / 16],
                                            const float* table, int window) {
#pragma unroll
  for (int t = 0; t < kSlotsPerLane; ++t) {
    const int col = min(max(unit_index<IdxT>(q, t), 0), window - 1);
    x[t] = __ldg((w >> t) & 1u ? table + col : kIdentities + OP);
  }
}

template <int OP>
__device__ __forceinline__ float fold_slots(float acc, const float (&x)[kSlotsPerLane]) {
#pragma unroll
  for (int t = 0; t < kSlotsPerLane; ++t) acc = fold<OP>(OP, acc, x[t]);
  return acc;
}

// The masked partials on the vector path where K <= 128 (see the source
// note).  A warp takes one set of 32 rows of one shard (warp g: set g / n
// of shard g % n, so the warps in flight hold the same stretch of every
// shard), thread t owning row t of the set: it loads the
// row's P mask units, and ballots list the set's items, (row, accumulator
// p) with a set slot, p-major.  The items are dealt to the warp's threads
// in turn; an item's thread reads its unit's 16 indices, gathers and folds
// them (an unset slot as the identity) and leaves the accumulator in
// shared memory; then thread t folds row t's accumulators in the
// single-lane tree, less its folds with an accumulator that holds no item,
// and the warp stores the set's 32 partials in one coalesced run.
template <typename IdxT, int P, int OP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_partials_masked_kernel(const __grid_constant__ PartialsArgs a,
                           const float* __restrict__ msgs, float* __restrict__ out,
                           int k, int tr, int window) {
  static_assert(P <= 8, "a thread holds its row's P mask units");
  __shared__ float warp_accs[kWarpsPerBlock][32 * P];
  constexpr int kVecs = kSlotsPerLane * sizeof(IdxT) / sizeof(int4);
  const int lane = threadIdx.x & 31;
  float* accs = warp_accs[threadIdx.x >> 5];
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int s = warp % a.n;  // set warp / n of shard warp % n
  const int n_rows = static_cast<int>(a.row0[s + 1] - a.row0[s]);
  const int r0 = warp / a.n * 32;
  if (r0 >= n_rows) return;  // whole warp leaves together
  const uint8_t* mask = a.mask[s];
  const IdxT* idx = static_cast<const IdxT*>(a.idx[s]);
  const int32_t* tw = a.tile_window[s];
  const int units = k / kSlotsPerLane;  // <= P
  const int r = r0 + lane;
  const bool live = r < n_rows;
  const uint4* rm = reinterpret_cast<const uint4*>(mask + static_cast<long long>(live ? r : 0) * k);
  uint4 mu[P];  // all the row's units in flight at once
#pragma unroll
  for (int u = 0; u < P; ++u) mu[u] = __ldg(rm + (u < units ? u : 0));
  uint32_t held = 0u;  // the row's accumulators (one unit each) with a set slot
#pragma unroll
  for (int u = 0; u < P; ++u) {
    held |= live && u < units && (mu[u].x | mu[u].y | mu[u].z | mu[u].w) != 0u ? 1u << u : 0u;
  }
  uint32_t words[P];  // rows holding accumulator p
  int n_items = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    words[p] = __ballot_sync(0xffffffffu, (held >> p) & 1u);
    n_items += __popc(words[p]);
  }
  for (int it = lane; it < n_items; it += 32) {
    int p = 0, row = 0, before = 0;
#pragma unroll
    for (int pp = 0; pp < P; ++pp) {
      const int pc = __popc(words[pp]);
      if (it >= before && it < before + pc) {
        p = pp;
        row = __fns(words[pp], 0, it - before + 1);
      }
      before += pc;
    }
    const long long at = static_cast<long long>(r0 + row) * k + p * kSlotsPerLane;
    const uint32_t w = slot_bits(__ldg(reinterpret_cast<const uint4*>(mask + at)));
    int4 q[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) q[v] = __ldg(reinterpret_cast<const int4*>(idx + at) + v);
    const float* table = msgs + static_cast<long long>(__ldg(tw + (r0 + row) / tr)) * window;
    float x[kSlotsPerLane];
    gather_unit<IdxT, OP>(x, w, q, table, window);
    accs[row * P + p] = fold_slots<OP>(identity_of<OP>(OP), x);
  }
  __syncwarp();
  if (live) out[a.row0[s] + r] = held_tree<P, OP>(held, OP, accs + lane * P, 1);
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

// Folds a batch's first n loaded partials into accumulators 0 .. n-1.
// (Every loop here has a fixed trip count, so the arrays stay in
// registers.)
template <int OP>
__device__ __forceinline__ void fold_entries(float (&acc)[32], const float (&x)[32], int n) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = i < n ? fold<OP>(OP, acc[i], x[i]) : acc[i];
}

// segment_combine's xor tree as seen from its thread 0, every fold kept:
// acc[q] = fold(acc[q], acc[q + off]) for q < off, off = 16 ... 1.
template <int OP>
__device__ __forceinline__ float fold_tree(float (&acc)[32]) {
#pragma unroll
  for (int lv = 4; lv >= 0; --lv) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (q < (1 << lv)) acc[q] = fold<OP>(OP, acc[q], acc[q + (1 << lv)]);
    }
  }
  return acc[0];
}

// The single-lane combine (see the source note).  A warp owns 32 / G
// destination rows of one shard, n_warps apart (the shard's warp count,
// odd), G threads a row.  The warp-per-row order's accumulator a (entries
// row_ptr[r] + a, + 32, ...) lives in thread a % G of the row's group, as
// its slot a / G.  A row of at most kGroupRows partials is walked by its
// group, two batches of 32 entries at a time (16 perm loads, then 16
// gathers, in flight a thread); then the tree as seen from thread 0: the
// levels 16 ... G inside each thread, the levels below by shuffles within
// the group.  Each longer row is then walked by the whole warp,
// kWarpBatches batches of 32 at a time, and folded by the xor tree.  An
// entry past its row reads a fixed zero in place of perm and then the
// combine's identity, which it folds (one L1 line each): no load is
// predicated, no address selects on a value loaded in the same batch, and
// no fold is predicated (ptxas would put each fold right after its
// gather, one round trip an entry).  Folding the identity changes no bit:
// an accumulator is never -0.0, nor NaN for min/max (see
// ell_partials_lanes).
template <int OP>
__global__ void __launch_bounds__(kCombineThreads)
segment_combine_kernel(const __grid_constant__ CombineArgs a,
                       const float* __restrict__ part, float* __restrict__ out) {
  constexpr int G = kRowThreads;
  constexpr int S = 32 / G;  // accumulators a thread
  const int lane = threadIdx.x & 31;
  const int g = lane % G;
  const int gw = blockIdx.x * (kCombineThreads / 32) + (threadIdx.x >> 5);
  if (gw >= a.warp0[a.n]) return;  // whole warp leaves together
  const int s = shard_of(a.warp0, a.n, gw);
  const int n_warps = a.warp0[s + 1] - a.warp0[s];
  const int rows = a.dst0[s + 1] - a.dst0[s];
  const int r = gw - a.warp0[s] + (lane / G) * n_warps;  // the group's row of the shard
  const bool live = r < rows;
  const int32_t* rp = a.row_ptr[s] + (live ? r : 0);
  const int32_t* pm = a.perm[s];
  const float* p = part + a.ell0[s];
  const float* ident = kIdentities + OP;
  const int begin = __ldg(rp);
  const int stop = __ldg(rp + 1);
  const int len = live ? stop - begin : 0;
  const int n = len <= kGroupRows ? len : 0;  // entries the group walks
  float acc[S];
#pragma unroll
  for (int m = 0; m < S; ++m) acc[m] = identity_of<OP>(OP);
  for (int i0 = 0; i0 < n; i0 += 64) {
    int pv[2 * S];
#pragma unroll
    for (int m = 0; m < 2 * S; ++m) {
      const int i = i0 + g + G * m;
      pv[m] = __ldg(i < n ? pm + begin + i : &kZeroIndex);
    }
    float x[2 * S];
#pragma unroll
    for (int m = 0; m < 2 * S; ++m) x[m] = __ldg((i0 + g + G * m < n ? p : ident) + pv[m]);
#pragma unroll
    for (int m = 0; m < 2 * S; ++m) acc[m % S] = fold<OP>(OP, acc[m % S], x[m]);
  }
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {  // levels 16 ... G, in the thread
#pragma unroll
    for (int m = 0; m < off; ++m) acc[m] = fold<OP>(OP, acc[m], acc[m + off]);
  }
  float res = acc[0];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {  // levels below G, in the group
    res = fold<OP>(OP, res, __shfl_xor_sync(0xffffffffu, res, off));
  }
  unsigned todo = __ballot_sync(0xffffffffu, g == 0 && len > kGroupRows);
  while (todo != 0) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1;
    const int b = __shfl_sync(0xffffffffu, begin, k);
    const int e = b + __shfl_sync(0xffffffffu, len, k);
    float v = identity_of<OP>(OP);
    for (int j0 = b; j0 < e; j0 += 32 * kWarpBatches) {
      int pv[kWarpBatches];
#pragma unroll
      for (int u = 0; u < kWarpBatches; ++u) {
        const int j = j0 + 32 * u + lane;
        pv[u] = __ldg(j < e ? pm + j : &kZeroIndex);
      }
      float x[kWarpBatches];
#pragma unroll
      for (int u = 0; u < kWarpBatches; ++u) x[u] = __ldg((j0 + 32 * u + lane < e ? p : ident) + pv[u]);
#pragma unroll
      for (int u = 0; u < kWarpBatches; ++u) v = fold<OP>(OP, v, x[u]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = fold<OP>(OP, v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    v = __shfl_sync(0xffffffffu, v, 0);
    if (lane == k) res = v;
  }
  if (live && g == 0) out[a.dst0[s] + r] = res;
}

// A block of the lane combine stages kRows destination rows of a pass's T
// lanes: 8 warps of kSets rows at once, each walking kWarpSets sets.
template <int T>
struct CombineTile {
  static constexpr int kSets = 32 / T;
  static constexpr int kRows = kSets * kCombineWarps > 32 ? kSets * kCombineWarps : 32;
  static constexpr int kWarpSets = kRows / (kSets * kCombineWarps);
};

// The lane combine (see the source note).  T threads own a row, a lane
// each; OP is every lane's combine where the launch has one arm, else
// kPerLane.  Lanes go in passes of T; per pass a block folds its kRows
// rows into shared memory, then writes each lane's run of them.
template <int OP, int T>
__global__ void __launch_bounds__(kCombineWarps * 32)
segment_combine_lanes_kernel(const __grid_constant__ CombineArgs a,
                             const __grid_constant__ LaneArgs la,
                             const float* __restrict__ part, float* __restrict__ out) {
  using Tile = CombineTile<T>;
  __shared__ float staged[T][Tile::kRows + 1];  // +1: no bank conflicts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % T;  // the thread's lane of a pass
  const int g = lane / T;    // its row of a set
  const unsigned group = T == 32 ? 0xffffffffu : ((1u << T) - 1u) << (g * T);
  const int tile0 = blockIdx.x * Tile::kRows;
  const int n_rows = min(Tile::kRows, a.dst0[a.n] - tile0);
  for (int l0 = 0; l0 < la.n_lanes; l0 += T) {
    const int l = l0 + sub;
    const bool live = l < la.n_lanes;
    // a padding lane (an id outside the arms) is written as 0
    const int op = live ? lane_op<kPerLane>(la, l) : kPadLane;
#pragma unroll 1
    for (int q = 0; q < Tile::kWarpSets; ++q) {
      const int rr = (q * kCombineWarps + warp) * Tile::kSets + g;
      float res = 0.0f;
      if (rr < n_rows) {  // the same for the whole thread group
        const int r = tile0 + rr;
        const int s = shard_of(a.dst0, a.n, r);
        const int32_t* rp = a.row_ptr[s] + (r - a.dst0[s]);
        const int32_t* pm = a.perm[s];
        // lane l of the shard's partial e: part[p0 + e * stride] (the table
        // is under 2^31 floats: the wrapper checks)
        const unsigned p0 = static_cast<unsigned>(a.ell0[s] * la.stride + l);
        const unsigned stride = static_cast<unsigned>(la.stride);
        const int begin = __ldg(rp);
        const int end = __ldg(rp + 1);
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = identity_of<OP>(op);
        for (int j0 = begin; j0 < end; j0 += 32) {
          const int n = min(32, end - j0);
          // Every load of the batch is issued before its first fold, and
          // none is predicated (a predicated load's register is moved out
          // at once, which waits for it): an entry past the row reads perm
          // and the table at their start, which stay in L1.
          int pv[32 / T];  // perm[j0 .. j0 + 31], T to a load
#pragma unroll
          for (int v = 0; v < 32 / T; ++v) {
            const int j = j0 + v * T + sub;
            pv[v] = __ldg(pm + (j < end ? j : 0));
          }
          float x[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int e = T == 1 ? pv[i] : __shfl_sync(group, pv[i / T], i % T, T);
            x[i] = __ldg(part + (live && i < n ? p0 + static_cast<unsigned>(e) * stride : 0u));
          }
          if constexpr (OP != kPerLane) {
            fold_entries<OP>(acc, x, n);
          } else if (op == kSum) {  // the thread's arm: a branch a thread,
            fold_entries<kSum>(acc, x, n);  // after the group's shuffles
          } else if (op == kMin) {
            fold_entries<kMin>(acc, x, n);
          } else if (op == kMax) {
            fold_entries<kMax>(acc, x, n);
          }
        }
        if constexpr (OP != kPerLane) {
          res = fold_tree<OP>(acc);
        } else if (op == kSum) {
          res = fold_tree<kSum>(acc);
        } else if (op == kMin) {
          res = fold_tree<kMin>(acc);
        } else if (op == kMax) {
          res = fold_tree<kMax>(acc);
        }
        res = op < 0 ? 0.0f : res;
      }
      staged[sub][rr] = res;
    }
    __syncthreads();
    const int n_lanes = min(T, la.n_lanes - l0);
    for (int i = threadIdx.x; i < n_lanes * Tile::kRows; i += kCombineWarps * 32) {
      const int rr = i % Tile::kRows;
      if (rr < n_rows) {
        out[static_cast<long long>(l0 + i / Tile::kRows) * la.out_stride + tile0 + rr] =
            staged[i / Tile::kRows][rr];
      }
    }
    __syncthreads();  // the block is done with the rows before the next pass
  }
}

template <typename IdxT, int OP, int NL, bool MASKED>
void launch_scalar(const PartialsArgs& a, const LaneArgs& la, const float* x,
                   float* o, int k, int tr, int window, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.row0[a.n] + kWarpsPerBlock - 1) / kWarpsPerBlock));
  ell_partials_scalar_kernel<IdxT, OP, NL, MASKED><<<grid, dim3(kWarpsPerBlock * 32), 0, stream>>>(
      a, la, x, o, k, tr, window);
}

// The masked kernel's grid: a warp for each set of 32 rows of each shard,
// the shards' sets interleaved.
template <typename IdxT, int P, int OP>
void launch_masked_rows(const PartialsArgs& a, const float* x, float* o, int k, int tr,
                        int window, cudaStream_t stream) {
  long long longest = 0;
  for (int s = 0; s < a.n; ++s) {
    longest = a.row0[s + 1] - a.row0[s] > longest ? a.row0[s + 1] - a.row0[s] : longest;
  }
  const long long warps = (longest + 31) / 32 * a.n;
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  ell_partials_masked_kernel<IdxT, P, OP><<<grid, dim3(kWarpsPerBlock * 32), 0, stream>>>(
      a, x, o, k, tr, window);
}

template <typename IdxT, int OP>
cudaError_t launch_masked(const PartialsArgs& a, const LaneArgs& la, const float* x,
                          float* o, int k, int tr, int window, int lanes_per_row,
                          cudaStream_t stream) {
  switch (lanes_per_row) {
    case 0:
      launch_scalar<IdxT, OP, 1, true>(a, la, x, o, k, tr, window, stream);
      return cudaSuccess;
    case 1:
      launch_masked_rows<IdxT, 1, OP>(a, x, o, k, tr, window, stream);
      return cudaSuccess;
    case 2:
      launch_masked_rows<IdxT, 2, OP>(a, x, o, k, tr, window, stream);
      return cudaSuccess;
    case 4:
      launch_masked_rows<IdxT, 4, OP>(a, x, o, k, tr, window, stream);
      return cudaSuccess;
    case 8:
      launch_masked_rows<IdxT, 8, OP>(a, x, o, k, tr, window, stream);
      return cudaSuccess;
    default: {  // K > 128: a row over P threads
      const long long per_block = static_cast<long long>(kWarpsPerBlock) * (32 / lanes_per_row);
      const dim3 grid(static_cast<unsigned>((a.row0[a.n] + per_block - 1) / per_block));
      ell_partials_vec_kernel<IdxT, OP, true><<<grid, dim3(kWarpsPerBlock * 32), 0, stream>>>(
          a, x, o, k, tr, window, lanes_per_row);
      return cudaSuccess;
    }
  }
}

template <typename IdxT, int OP>
cudaError_t launch_sentinel(const PartialsArgs& a, const LaneArgs& la, const float* x,
                            float* o, int k, int tr, int window, int lanes_per_row,
                            cudaStream_t stream) {
  if (lanes_per_row > 0) {
    const long long per_block = static_cast<long long>(kWarpsPerBlock) * (32 / lanes_per_row);
    const dim3 grid(static_cast<unsigned>((a.row0[a.n] + per_block - 1) / per_block));
    ell_partials_vec_kernel<IdxT, OP, false><<<grid, dim3(kWarpsPerBlock * 32), 0, stream>>>(
        a, x, o, k, tr, window, lanes_per_row);
  } else {
    launch_scalar<IdxT, OP, 1, false>(a, la, x, o, k, tr, window, stream);
  }
  return cudaSuccess;
}

template <typename IdxT, bool MASKED, int OP>
cudaError_t launch_single(const PartialsArgs& a, const LaneArgs& la, const float* x,
                          float* o, int k, int tr, int window, int lanes_per_row,
                          cudaStream_t stream) {
  if constexpr (MASKED) {
    return launch_masked<IdxT, OP>(a, la, x, o, k, tr, window, lanes_per_row, stream);
  } else {
    return launch_sentinel<IdxT, OP>(a, la, x, o, k, tr, window, lanes_per_row, stream);
  }
}

// The single-lane partials, masked or sentinel, with the combine at
// compile time.
template <typename IdxT, bool MASKED>
cudaError_t launch_single(const PartialsArgs& a, const LaneArgs& la, const float* x,
                          float* o, int k, int tr, int window, int lanes_per_row,
                          int combine, cudaStream_t stream) {
  switch (combine) {
    case kSum:
      return launch_single<IdxT, MASKED, kSum>(a, la, x, o, k, tr, window, lanes_per_row, stream);
    case kMin:
      return launch_single<IdxT, MASKED, kMin>(a, la, x, o, k, tr, window, lanes_per_row, stream);
    default:
      return launch_single<IdxT, MASKED, kMax>(a, la, x, o, k, tr, window, lanes_per_row, stream);
  }
}

// Lanes a thread of a lane launch holds on the vector path (V): the
// fewest that let P threads cover the lane stride, up to four, in 8 B or
// 16 B loads the stride allows, and at most 32 / P (which bounds the
// kernels built).
int lane_vector(int p, int lane_stride) {
  int v = 1;
  while (v < 4 && lane_stride % (2 * v) == 0 && p * 2 * v <= 32 && lane_stride >= 2 * v * p) {
    v <<= 1;
  }
  return v;
}

// Threads that own a row of a lane launch on the vector path: V lanes
// each up to a warp, and at least P (one a unit of a round).
int lane_row_threads(int p, int v, int lane_stride) {
  int t = p;
  while (t * v < lane_stride && t < 32) t <<= 1;
  return t;
}

// cudaErrorInvalidConfiguration, before any launch, where a warp's shared
// memory (its P accumulators of each of a set's rows' S lanes) is more
// than a block may have: about 1,800 lanes at K >= 512, 7,000 at K = 128.
template <typename IdxT, int P, int V, int OP>
cudaError_t launch_lane_rows(const PartialsArgs& a, const LaneArgs& la, const float* x,
                             float* o, int k, int tr, int window, cudaStream_t stream) {
  const int t = lane_row_threads(P, V, la.stride);
  const int per_warp_smem = LaneSmem<IdxT, P>(32 / t, la.stride).bytes;
  if (per_warp_smem > kBlockSmem) return cudaErrorInvalidConfiguration;
  long long longest = 0;
  for (int s = 0; s < a.n; ++s) {
    longest = a.row0[s + 1] - a.row0[s] > longest ? a.row0[s + 1] - a.row0[s] : longest;
  }
  const long long per_warp = static_cast<long long>(kLaneRowSets) * (32 / t);
  const int chunks = static_cast<int>((longest + per_warp - 1) / per_warp);
  const long long warps = static_cast<long long>(chunks) * a.n;
  // as many warps a block as fit kLaneBlocksPerSM blocks in an SM
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && kLaneBlocksPerSM * wpb * per_warp_smem > kBlockSmem) wpb >>= 1;
  const int smem = wpb * per_warp_smem;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ell_partials_lanes_kernel<IdxT, P, V, OP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>((warps + wpb - 1) / wpb));
  ell_partials_lanes_kernel<IdxT, P, V, OP><<<grid, dim3(wpb * 32), smem, stream>>>(
      a, la, x, o, k, tr, window, t, chunks);
  return cudaSuccess;
}

// One arm: its combine at compile time; several: each lane's at run time.
template <typename IdxT, int P, int V>
cudaError_t launch_lane_rows(const PartialsArgs& a, const LaneArgs& la, const float* x,
                             float* o, int k, int tr, int window, cudaStream_t stream) {
  switch (la.n_arms > 1 ? kPerLane : la.arm_op[0]) {
    case kSum:
      return launch_lane_rows<IdxT, P, V, kSum>(a, la, x, o, k, tr, window, stream);
    case kMin:
      return launch_lane_rows<IdxT, P, V, kMin>(a, la, x, o, k, tr, window, stream);
    case kMax:
      return launch_lane_rows<IdxT, P, V, kMax>(a, la, x, o, k, tr, window, stream);
    default:
      return launch_lane_rows<IdxT, P, V, kPerLane>(a, la, x, o, k, tr, window, stream);
  }
}

template <typename IdxT, int P>
cudaError_t launch_lane_rows(const PartialsArgs& a, const LaneArgs& la, const float* x,
                             float* o, int k, int tr, int window, cudaStream_t stream) {
  const int v = lane_vector(P, la.stride);
  if constexpr (P <= 8) {
    if (v == 4) return launch_lane_rows<IdxT, P, 4>(a, la, x, o, k, tr, window, stream);
  }
  if constexpr (P <= 16) {
    if (v == 2) return launch_lane_rows<IdxT, P, 2>(a, la, x, o, k, tr, window, stream);
  }
  return launch_lane_rows<IdxT, P, 1>(a, la, x, o, k, tr, window, stream);
}

// The vector path (lanes_per_row > 0) takes the lane-row kernel, whose P
// is lanes_per_row; the warp-per-row path the scalar kernel in chunks of nl.
template <typename IdxT>
cudaError_t launch_lanes(const PartialsArgs& a, const LaneArgs& la, const float* x,
                         float* o, int k, int tr, int window, int lanes_per_row,
                         int nl, cudaStream_t stream) {
  switch (lanes_per_row) {
    case 0:
      break;
    case 1:
      return launch_lane_rows<IdxT, 1>(a, la, x, o, k, tr, window, stream);
    case 2:
      return launch_lane_rows<IdxT, 2>(a, la, x, o, k, tr, window, stream);
    case 4:
      return launch_lane_rows<IdxT, 4>(a, la, x, o, k, tr, window, stream);
    case 8:
      return launch_lane_rows<IdxT, 8>(a, la, x, o, k, tr, window, stream);
    case 16:
      return launch_lane_rows<IdxT, 16>(a, la, x, o, k, tr, window, stream);
    default:
      return launch_lane_rows<IdxT, 32>(a, la, x, o, k, tr, window, stream);
  }
  switch (nl) {
    case 1:
      launch_scalar<IdxT, kPerLane, 1, true>(a, la, x, o, k, tr, window, stream);
      break;
    case 4:
      launch_scalar<IdxT, kPerLane, 4, true>(a, la, x, o, k, tr, window, stream);
      break;
    default:
      launch_scalar<IdxT, kPerLane, 8, true>(a, la, x, o, k, tr, window, stream);
      break;
  }
  return cudaSuccess;
}

template <int OP, int T>
void launch_combine_tile(const CombineArgs& a, const LaneArgs& la, const float* p, float* o,
                         cudaStream_t stream) {
  constexpr int kRows = CombineTile<T>::kRows;
  const dim3 grid((a.dst0[a.n] + kRows - 1) / kRows);
  segment_combine_lanes_kernel<OP, T><<<grid, dim3(kCombineWarps * 32), 0, stream>>>(a, la, p,
                                                                                    o);
}

// Threads a destination row of the lane combine: the lanes, rounded up to
// a power of two, at most 32 (wider launches go in passes of 32).
template <int OP>
void launch_combine_lanes(const CombineArgs& a, const LaneArgs& la, const float* p, float* o,
                          cudaStream_t stream) {
  if (la.n_lanes == 1) {
    launch_combine_tile<OP, 1>(a, la, p, o, stream);
  } else if (la.n_lanes == 2) {
    launch_combine_tile<OP, 2>(a, la, p, o, stream);
  } else if (la.n_lanes <= 4) {
    launch_combine_tile<OP, 4>(a, la, p, o, stream);
  } else if (la.n_lanes <= 8) {
    launch_combine_tile<OP, 8>(a, la, p, o, stream);
  } else if (la.n_lanes <= 16) {
    launch_combine_tile<OP, 16>(a, la, p, o, stream);
  } else {
    launch_combine_tile<OP, 32>(a, la, p, o, stream);
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
// vec != 0 takes the vector path; the caller checks K % 16 == 0
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
  const cudaError_t e =
      idx_bytes == 2 ? launch_single<int16_t, true>(a, la, x, o, k, tr, window, p, combine, s)
                     : launch_single<int32_t, true>(a, la, x, o, k, tr, window, p, combine, s);
  const cudaError_t last = cudaGetLastError();  // read, so none is left behind
  return static_cast<int>(e != cudaSuccess ? e : last);
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
  const cudaError_t e =
      idx_bytes == 2 ? launch_single<int16_t, false>(a, la, x, o, k, tr, window, p, combine, s)
                     : launch_single<int32_t, false>(a, la, x, o, k, tr, window, p, combine, s);
  const cudaError_t last = cudaGetLastError();  // read, so none is left behind
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// msgs: the lane-minor message table [n_pad, lane_stride]; lanes
// 0..n_lanes-1 are read, lane_stride a multiple of nl (1, 4 or 8) and the
// table 16 B aligned for nl > 1.  cid: n_lanes int32 on the device;
// arm_ops: n_arms combines on the host.  out: the lane-minor partials
// [sum n_ell, lane_stride], 16 B aligned (padding columns written as 0).
// Returns cudaErrorInvalidConfiguration, launching nothing, where the
// vector path's shared memory does not fit the lane stride.
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
      static_cast<long long>(window) * lane_stride >= (1LL << 31) ||  // 32-bit offsets
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
  const cudaError_t e = idx_bytes == 2
                            ? launch_lanes<int16_t>(a, la, x, o, k, tr, window, p, nl, s)
                            : launch_lanes<int32_t>(a, la, x, o, k, tr, window, p, nl, s);
  const cudaError_t last = cudaGetLastError();  // read, so none is left behind
  return static_cast<int>(e != cudaSuccess ? e : last);
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
  // a warp for each kRowsPerWarp rows of a shard, an odd count (see
  // segment_combine_kernel)
  constexpr int kRowsPerWarp = 32 / kRowThreads;
  a.warp0[0] = 0;
  for (int i = 0; i < n_shards; ++i) {
    a.warp0[i + 1] = a.warp0[i] + ((rows[i] + kRowsPerWarp - 1) / kRowsPerWarp | 1);
  }
  constexpr int kWarps = kCombineThreads / 32;
  const dim3 grid((a.warp0[n_shards] + kWarps - 1) / kWarps);
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

// part: lane-minor partials [sum n_ell, part_stride] (lanes 0..n_lanes-1
// read, part_stride >= n_lanes, under 2^31 floats in all); out: [n_lanes,
// sum rows]; cid/arm_ops as for ell_partials_lanes.
extern "C" int segment_combine_lanes(const void* part, int part_stride,
                                     const void* const* perm,
                                     const void* const* row_ptr,
                                     const long long* n_ell, const int* rows,
                                     int n_shards, int n_lanes,
                                     const void* cid, const int* arm_ops,
                                     int n_arms, void* out, void* stream) {
  CombineArgs a;
  LaneArgs la;
  long long n_part = 0;
  for (int s = 0; s < n_shards && s < kMaxBatch; ++s) n_part += n_ell[s];
  if (n_shards <= 0 || n_shards > kMaxBatch || part_stride < n_lanes ||
      n_part * part_stride >= (1LL << 31) ||  // 32-bit offsets
      !fill_combine(&a, perm, row_ptr, n_ell, rows, n_shards) ||
      !fill_lanes(&la, cid, arm_ops, n_arms, n_lanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  la.stride = part_stride;
  la.out_stride = a.dst0[n_shards];
  const auto* p = static_cast<const float*>(part);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (la.n_arms > 1 ? kPerLane : la.arm_op[0]) {
    case kSum:
      launch_combine_lanes<kSum>(a, la, p, o, s);
      break;
    case kMin:
      launch_combine_lanes<kMin>(a, la, p, o, s);
      break;
    case kMax:
      launch_combine_lanes<kMax>(a, la, p, o, s);
      break;
    default:
      launch_combine_lanes<kPerLane>(a, la, p, o, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
