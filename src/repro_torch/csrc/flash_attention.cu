// Flash attention forward for Hopper (sm_90a): the attention of every
// prefill layer.
//
// flash_attention_fwd, flash_attention_fwd_tc  replace the TPU kernel
//     src/repro/kernels/flash_attention/kernel.py::flash_attention
//     (body _flash_kernel)
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//   for q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D], G = Hq / Hkv, scale =
//   D^-0.5.  Causal queries are the suffix of the keys: query i sits at
//   key position i + Skv - Sq and sees keys up to it.  Online softmax with
//   f32 statistics (m, l) and an f32 accumulator; the output is acc /
//   max(l, 1e-30), written in q's dtype (f32 or bf16).  Any Sq, Skv (the
//   ragged tail tile is masked).
//   Bound: operations.  4 B Hq Sq Skv D flops (halved when causal) against
//   bytes of q, k, v and o read or written once: at the prefill's shapes
//   (D = 128, Sq = Skv >= 512) over 200 flops a byte, past the card's
//   balance point, so only the tensor cores can approach the bound.
//
// Dispatch (the wrapper's uses_tensor_cores, checked again here): a call
// runs the tensor-core kernel when q is bf16, D is 64 or 128 (at 256 the
// 64 x 256 f32 accumulator takes 128 registers a thread on top of the
// scores: ptxas spilled 116 B, so 256 stays on the scalar kernel), every
// tensor's last stride is 1 and its base pointer and other strides are
// 16 B aligned.  Every other call (f32, other D, other strides) runs the
// scalar kernel, so f32 keeps full f32 products (the tensor cores would
// take f32 as TF32).  The rule depends on dtype, shape and layout only;
// nothing is caught or retried.
//
// flash_attention_fwd_tc (bf16 on the tensor cores, warpgroup MMA).  A
// CTA is one warpgroup (4 warps) owning 64 query rows of one (batch, query
// head), 16 rows a warp; the q tiles are launched in reverse, the heavy
// causal ones first.  Q and K/V tiles of 64 keys x D stay bf16 in shared
// memory in wgmma's canonical 128 B-swizzled layout ([64][64] blocks of
// 128 B rows, 16 B chunk c of row r at c ^ (r % 8)), filled by cp.async.cg
// 16 B a thread into a ring of 2 stages, so tile j + 1's copy overlaps
// tile j's products; rows past Skv are zero-filled.  Shared memory: 80 KB
// at D = 128 (2 CTAs an SM), 40 KB at 64 (3).  S = Q K^T is
// wgmma.m64n64k16 with both operands read from shared memory through
// descriptors (bf16 in, f32 accumulate: products of bf16 values are exact
// in f32, so this is the reference's f32 dot up to summation order).  The
// causal and ragged masks and the online softmax run on the accumulator
// registers (row max and sum folded over the quad of a row with xor
// shuffles; exp2 of log2e-scaled scores).  P.V keeps the reference's f32
// P: P is split into a bf16 high part and a bf16 low part (p - hi), about
// 16 significant bits, and both multiply the same V tile (route (a)): a
// warp's score accumulators are, packed, its A fragment, so P.V is
// wgmma.m64nDk16 with A from registers and V read from shared memory
// transposed (MN-major).  Each product is waited for before the next
// step; overlapping P(j) V(j) with S(j + 1) (a third stage, or
// FlashAttention-3's two score buffers) measured slower.  The epilogue
// divides by l (clamped at 1e-30, so a row with no valid key stays 0),
// rounds to bf16 and stores 16 B a lane through the output's strides,
// staged in Q's tile.
//
// flash_attention_fwd (the scalar kernel: f32, and bf16 calls off the
// rule).  The TPU grid carries (m, l, acc) in VMEM scratch across its
// sequential kv axis; here one CTA of 128 threads owns one (batch * head,
// 64-query tile) and loops over 64-key tiles itself, with scalar f32
// FMAs, P.V in f32.  The query tile, each K and V tile and the tile's
// probabilities are staged in shared memory as f32 (115 KB at D = 128,
// 214 KB at D = 256: one CTA an SM).  Thread (ty, tx) = (tid / 8, tid %
// 8) owns query rows 4 ty .. 4 ty + 3: it computes their scores against
// keys tx, tx + 8, ..., tx + 56, folds the row max and sum over the 8
// threads of the row with xor shuffles, and keeps the rows' output columns
// tx, tx + 8, ... in registers.  Shared tiles are padded by one float a
// row so that neither the coalesced fills nor the strided reads conflict
// on banks.  Any D <= 256.
//
// Both: GQA by index (query head h reads K/V head h / G, nothing is
// expanded); every tensor is read through its own strides (the model
// hands over transposed views; the output is written into the caller's
// layout); key tiles wholly above the diagonal are never loaded (the TPU
// baseline still copies them in).
//
// The C functions launch on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBQ = 64;        // queries a CTA
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 threads
constexpr int kRows = 4;       // query rows a thread
constexpr int kCols = kBK / 8; // scores a thread a row

enum DType : int { kF32 = 0, kBF16 = 1 };

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[4], sk[4], sv[4], so[4];  // element strides (b, h, s, d)
  int Hq, group, Sq, Skv, D, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// rows [r0, r0 + n) of a [*, D] tile through strides into dst[n][ld],
// zero beyond `rows_valid` and beyond D (so loops may run to DMAX)
template <typename T, int DMAX>
__device__ __forceinline__ void fill_tile(float* dst, int ld, const T* base,
                                          long long s_row, long long s_d,
                                          int r0, int rows_valid, int D) {
  for (int i = threadIdx.x; i < kBK * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.0f;
    if (r0 + r < rows_valid && d < D) x = to_f32(base[(r0 + r) * s_row + d * s_d]);
    dst[r * ld + d] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __grid_constant__ FlashArgs a) {
  static_assert(kBQ == kBK, "one fill routine serves the Q, K and V tiles");
  constexpr int LDK = DMAX + 1;  // Q and K rows: read across rows
  constexpr int LDV = DMAX;      // V rows: read along the row
  constexpr int LDP = kBK + 1;
  constexpr int OC = DMAX / 8;   // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][LDK]
  float* Ks = Qs + kBQ * LDK;    // [kBK][LDK]
  float* Vs = Ks + kBK * LDK;    // [kBK][LDV]
  float* Ps = Vs + kBK * LDV;    // [kBQ][LDP]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int q0 = blockIdx.x * kBQ;
  const int D = a.D;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];

  fill_tile<T, DMAX>(Qs, LDK, qb, a.sq[2], a.sq[3], q0, a.Sq, D);

  float m[kRows], l[kRows], acc[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }
  const int off = a.Skv - a.Sq;  // query i sits at key position i + off
  // keys past the tile's last query position are masked for every row:
  // their tiles are skipped, never loaded
  const int kend = a.causal ? min(a.Skv, q0 + kBQ + off) : a.Skv;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
    fill_tile<T, DMAX>(Ks, LDK, kb, a.sk[2], a.sk[3], k0, a.Skv, D);
    fill_tile<T, DMAX>(Vs, LDV, vb, a.sv[2], a.sv[3], k0, a.Skv, D);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * LDK + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 8 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool ok = kpos < a.Skv && (!a.causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row are lanes 8 (ty % 4) .. 8 (ty % 4) + 7
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no valid key yet keeps m = -inf: exp(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[(ty * kRows + i) * LDP + tx + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // Ps complete

    const int kn = min(kBK, a.Skv - k0);  // keys past Skv have p = 0
#pragma unroll 2
    for (int c = 0; c < kn; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float vv = Vs[c * LDV + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= a.Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      const int col = tx + 8 * j;
      if (col < D) ob[r * a.so[2] + col * a.so[3]] = from_f32<T>(acc[i][j] / li);
    }
  }
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (DMAX + 1) + kBK * DMAX + kBQ * (kBK + 1));
}

template <typename T, int DMAX>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DMAX>();
  // above 48 KB only as opted-in dynamic shared memory (set on every call:
  // the setting belongs to the current device)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.Hq);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const FlashArgs& a, int B, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(a, B, stream);
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  if (a.D <= 128) return launch<T, 128>(a, B, stream);
  return launch<T, 256>(a, B, stream);
}

// ------------------------------------ tensor-core kernel (bf16, wgmma)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;        // queries a CTA: one warpgroup, 16 rows a warp
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 128;  // the warpgroup
constexpr int kStages = 2;     // K/V ring: tile j + 1 copies in during tile j

template <int D> __host__ __device__ constexpr int min_ctas() { return D <= 64 ? 3 : 2; }
template <int D>
constexpr size_t smem_bytes() {  // Q and the K/V ring
  return sizeof(bf16) * static_cast<size_t>(kBQ + 2 * kStages * kBK) * D;
}
// V is read MN-major (d contiguous): the descriptor's leading offset steps
// along d (from one 64-wide block to the next, 8 KB), its stride offset
// along the keys (8-row atoms, 1 KB)
constexpr uint32_t kAtom = 1024, kBlock = kBK * 64 * sizeof(bf16);

// element (r, c) of a [64][D] tile kept as D / 64 blocks of [64][64] with
// 128 B rows, 128 B-swizzled: the canonical wgmma layout
__device__ __forceinline__ int off(int r, int c) {
  return (c >> 6) * (kBK * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// rows [r0, r0 + 64) of a [*, D] bf16 matrix (row stride s_row elements)
// into a tile by cp.async, 16 B a thread; rows past n zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long s_row,
                                          int r0, int n) {
  constexpr int CH = D / 8;  // 16 B chunks a row
  static_assert(kBK * CH % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kBK * CH / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / CH, c = i % CH;
    const bool ok = r0 + r < n;
    const bf16* src = ok ? base + static_cast<long long>(r0 + r) * s_row + c * 8 : base;
    mma::cp_async_16(dst + off(r, c * 8), src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, min_ctas<D>())
flash_fwd_tc_kernel(const __grid_constant__ FlashArgs a) {
  constexpr int kTile = kBK * D;  // elements of a Q, K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile;             // [kStages] tiles
  bf16* Vs = Ks + kStages * kTile;   // [kStages] tiles

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heavy causal tiles first
  const int r0 = warp * 16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const int off_q = a.Skv - a.Sq;  // query i sits at key position i + off_q
  // keys past the tile's last query position are masked for every row:
  // their tiles are never loaded
  const int kend = a.causal ? min(a.Skv, q0 + kBQ + off_q) : a.Skv;
  const int n_tiles = (kend + kBK - 1) / kBK;

  load_tile<D>(Qs, qb, a.sq[2], q0, a.Sq);
  load_tile<D>(Ks, kb, a.sk[2], 0, a.Skv);
  load_tile<D>(Vs, vb, a.sv[2], 0, a.Skv);
  mma::cp_async_commit();

  float o[D / 2];  // the 64 x D output, mma.sync m16n8 layout a warp
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // rows g, g + 8
  const float sl2 = a.scale * 1.4426950408889634f;  // scores in log2 units
  const int qpos0 = q0 + r0 + g + off_q;            // key position of row g

  for (int j = 0; j < n_tiles; ++j) {
    mma::cp_async_wait<0>();
    mma::fence_proxy_async();  // the copies are visible to wgmma's reads
    __syncthreads();           // tile j in place; tile j - 1's stage is free
    if (j + 1 < n_tiles) {
      const int st = (j + 1) % kStages;
      load_tile<D>(Ks + st * kTile, kb, a.sk[2], (j + 1) * kBK, a.Skv);
      load_tile<D>(Vs + st * kTile, vb, a.sv[2], (j + 1) * kBK, a.Skv);
    }
    mma::cp_async_commit();
    const bf16* Kt = Ks + (j % kStages) * kTile;
    const bf16* Vt = Vs + (j % kStages) * kTile;

    // S = Q K^T: D / 16 k-steps of 16 (32 B inside a 128 B swizzle row)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    mma::fence_regs(s);
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int e = (kk >> 2) * (kBK * 64) + (kk & 3) * 16;
      mma::wgmma_m64n64k16_ss(s, mma::wgmma_desc(Qs + e, 16, kAtom),
                              mma::wgmma_desc(Kt + e, 16, kAtom), kk > 0);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(s);

    // scale, mask (only tiles that cross Skv or this warp's diagonal);
    // s[4 n + e]: key 8 n + 2 t + (e & 1), row g + 8 (e >> 1)
    const int k0 = j * kBK;
    const bool masked = k0 + kBK > a.Skv || (a.causal && k0 + kBK - 1 > q0 + r0 + off_q);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * sl2;
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int qpos = qpos0 + ((i >> 1) & 1) * 8;
        if (key >= a.Skv || (a.causal && key > qpos)) x = -INFINITY;
      }
      s[i] = x;
    }
    // online softmax, row max and sum folded over the quad of the row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      // a row that has seen no valid key yet keeps m = -inf: exp2(-inf) = 0
      mu[r] = mn == -INFINITY ? 0.0f : mn;
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
    }
    float rs[2] = {0.0f, 0.0f};  // this thread's share of the row sums
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - mu[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V, P as hi + lo bf16 parts straight from the accumulators
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const float c0[4] = {s[8 * kk], s[8 * kk + 1], s[8 * kk + 2], s[8 * kk + 3]};
      const float c1[4] = {s[8 * kk + 4], s[8 * kk + 5], s[8 * kk + 6], s[8 * kk + 7]};
      mma::p_fragments(c0, c1, ph[kk], pl[kk]);
    }
    mma::fence_regs(o);
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = mma::wgmma_desc(Vt + kk * 16 * 64, kBlock, kAtom);
      mma::wgmma_rs_mn(o, ph[kk], dv);
      mma::wgmma_rs_mn(o, pl[kk], dv);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(o);
  }
  mma::cp_async_wait<0>();  // only empty groups remain

  // epilogue: O / l in bf16, staged in Q's tile, then 16 B stores along
  // each output row through the output's strides
  float li[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    li[r] = fmaxf(l[r], 1e-30f);
  }
  __syncthreads();  // every wgmma read of Qs is done
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + off(r0 + g, 8 * n + 2 * t)) =
        mma::pack_bf16(o[4 * n] / li[0], o[4 * n + 1] / li[0]);
    *reinterpret_cast<uint32_t*>(Qs + off(r0 + g + 8, 8 * n + 2 * t)) =
        mma::pack_bf16(o[4 * n + 2] / li[1], o[4 * n + 3] / li[1]);
  }
  __syncwarp();  // a warp stores its own 16 rows
  bf16* ob = static_cast<bf16*>(a.o) + b * a.so[0] + h * a.so[1];
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, row = q0 + r0 + r;
    if (row < a.Sq) {
      *reinterpret_cast<uint4*>(ob + row * a.so[2] + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + off(r0 + r, c * 8));
    }
  }
}

// opt in to the dynamic shared memory and ask for the largest shared
// carveout, so min_ctas<D>() CTAs fit an SM (set on every call: the
// settings belong to the current device)
template <int D>
cudaError_t configure() {
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem_bytes<D>()));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const cudaError_t attr = configure<D>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.Hq);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(a);
  return cudaGetLastError();
}

// the dispatch rule's layout half: last strides 1, pointers and the
// other strides 16 B aligned
bool aligned(const FlashArgs& a) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  const long long* st[4] = {a.sq, a.sk, a.sv, a.so};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0 || st[i][3] != 1) return false;
    for (int j = 0; j < 3; ++j) {
      if (st[i][j] % 8 != 0) return false;
    }
  }
  return true;
}

}  // namespace tc

FlashArgs make_args(const void* q, const void* k, const void* v, void* o, int Hq,
                    int Hkv, int Sq, int Skv, int D, const long long* strides,
                    int causal, float scale) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[4 + i];
    a.sv[i] = strides[8 + i];
    a.so[i] = strides[12 + i];
  }
  a.Hq = Hq;
  a.group = Hq / Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// strides: 16 element strides, (b, h, s, d) of q, k, v and o in turn.
// The wrapper has checked shapes, dtypes, devices, Hq % Hkv == 0,
// 1 <= D <= 256, Sq, Skv >= 1, B * Hq <= 65535, and Sq <= Skv if causal.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Hq, int Hkv, int Sq, int Skv,
                        int D, const long long* strides, int causal,
                        float scale, void* stream) {
  const FlashArgs a = make_args(q, k, v, o, Hq, Hkv, Sq, Skv, D, strides, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(a, B, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(a, B, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel: bf16, the same arguments and checks, and the
// dispatch rule's layout (D 64 or 128; see the note at the top);
// cudaErrorInvalidValue for a call off the rule.
int flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o,
                           int B, int Hq, int Hkv, int Sq, int Skv, int D,
                           const long long* strides, int causal, float scale,
                           void* stream) {
  const FlashArgs a = make_args(q, k, v, o, Hq, Hkv, Sq, Skv, D, strides, causal, scale);
  if (!tc::aligned(a)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return tc::launch<64>(a, B, s);
  if (D == 128) return tc::launch<128>(a, B, s);
  return cudaErrorInvalidValue;
}

// CTAs of the tensor-core kernel that fit one SM at head dim D (64 or
// 128), or -1: a diagnostic the smoke run prints.
int flash_attention_tc_ctas_per_sm(int D) {
  int n = -1;
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 64 && tc::configure<64>() == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tc::flash_fwd_tc_kernel<64>,
                                                      tc::kThreads, tc::smem_bytes<64>());
  } else if (D == 128 && tc::configure<128>() == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tc::flash_fwd_tc_kernel<128>,
                                                      tc::kThreads, tc::smem_bytes<128>());
  }
  return e == cudaSuccess ? n : -1;
}

}  // extern "C"
