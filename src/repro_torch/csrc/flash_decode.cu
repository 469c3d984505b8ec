// Single-token GQA decode attention for Hopper (sm_90a).
//
// flash_decode  replaces the TPU kernel
//     src/repro/kernels/flash_attention/kernel.py::flash_decode
//     (body _decode_kernel)
//   For each (batch x kv head) row b: o[b, g] = sum_j p[g, j] v[b, j] /
//   sum_j p[g, j], p[g, j] = exp(s[g, j] - max_j s[g, j]) on valid slots
//   and 0 elsewhere, s[g, j] = scale * q[b, g] . k[b, j], for q [BH, G, D]
//   (the G query heads of one kv head), k, v [BH, S, D] and valid [BH, S].
//   As the TPU kernel: f32 statistics and accumulator, the finite NEG_INF
//   -1e30 for masked scores, p zeroed explicitly on masked slots (not left
//   to exp underflow), l clamped at 1e-30 so a row with no valid slot
//   gives 0, the output in q's dtype (f32 or bf16).  Any S >= 1, D <= 256,
//   G <= 32; no padding of S.
//   Bound: memory.  At decode shapes a key and a value row are read once
//   for G query rows: 4 G D flops against 2 D bytes (bf16) a key, 16 flops
//   a byte at G = 8, far below the card's balance point.  The function
//   must read q, valid, the K and V rows of valid slots (a tile with no
//   valid slot is never read), and write o.
//   Split: the TPU grid walks the kv blocks of one row in order on one
//   core, carrying (m, l, acc) in VMEM.  Here that would be BH CTAs (8 for
//   a batch of 4 on Qwen2.5-3B's 2 kv heads) for 132 SMs, so the kv axis
//   is split: each (split, row) CTA takes a run of whole 64-key tiles and
//   computes its un-normalised (o, m, l), as decode_partials_ref does for
//   a shard of the cache.  The split count depends only on the shapes
//   (about 264 CTAs in all, two an SM, at most 256 tiles a split: the
//   wrapper's decode_splits; twice the CTAs measured slower, the merge
//   being longer).  One launch a call: the last CTA of each row to finish
//   merges that row's splits in ascending order, the algebra of
//   flash_decode_combine, so the result is deterministic (bitwise the same
//   run to run, whichever CTA comes last).  "Last" is an atomic ticket per
//   row, taken after __threadfence(); the last CTA resets its ticket to 0.
//   Hazard: the tickets are scratch that outlives the launch.  Two
//   launches that shared them concurrently would miscount, so the wrapper
//   keeps one ticket array per device and stream (launches on one stream
//   are ordered); a launch that faults mid-way leaves tickets set, but a
//   fault poisons the context anyway.  With one split the CTA writes the
//   output itself (the merge of one split changes no bits).
//
// Dispatch (the wrapper's decode_uses_tensor_cores, checked again here):
// bf16 with D = 64, 128 or 256, G <= 16 and q, k, v 16 B aligned runs the
// ring kernel; every other call (f32, other D or G, misaligned views)
// runs the scalar kernel.  Both take the same splits.
//
// decode_ring_kernel (bf16).  The function is memory-bound, so the design
// streams the cache: K and V tiles of 64 keys x D stay bf16 in shared
// memory, in a ring of 3 stages filled by cp.async.cg 16 B a thread (96 KB
// of ring at D = 128, two CTAs an SM: up to 128 KB in flight an SM); a
// CTA first lists the tiles of its split that hold a valid slot (a
// coalesced byte scan of the mask), and only those are ever copied.  Four
// warps take 16 keys of each tile each, with mma.sync.m16n8k16 on the
// tensor cores (not needed for speed at 16 flops a byte, but it leaves
// the SM's issue slots to the copies): S = Q K^T with the G query rows
// padded to 16 (Q read once into registers, or from shared memory at
// D = 256), masked scores at -1e30 and p = 0 on masked slots, the online
// softmax in f32 on the accumulator fragments, and O += P V with P split
// into bf16 high and low parts (about 16 bits: the reference multiplies
// f32 P by V).  Each warp keeps its own (m, l, O); at the end the four
// are merged in warp order through shared memory (the ring's space), and
// the row's last CTA merges the splits from partials it copies into the
// ring by cp.async (merge_row_staged).
//
// decode_split_kernel (the scalar kernel: f32 and calls off the rule).
// A CTA has DMAX threads (the head dim rounded up to 64, 128 or 256); a
// key tile is TK = min(DMAX, 128) keys, staged in shared memory as f32
// rows padded by 4 floats (16 B reads without bank conflicts).  Thread t
// < TK scores key t against the G query rows (q in shared memory, read as
// broadcasts); a warp per query row folds the tile's max and sum with xor
// shuffles; then thread t owns output column d = t for all G rows and
// reads V straight from device memory, coalesced along d, the tile's
// probabilities broadcast from shared memory.
//
// The C function launches one kernel on the caller's stream, allocates
// nothing (the caller passes the partials' and tickets' scratch) and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF: finite
constexpr int kMaxG = 32;
constexpr int kTileKeys = 64;    // the unit of a split (the wrapper's _DECODE_TILE)
constexpr int kMaxTiles = 256;   // tiles a split (_DECODE_MAX_TILES)
constexpr int kMergeChunk = 64;  // splits the merge stages at a time
constexpr int kMergeFloats = kMaxG + 2 * kMergeChunk * kMaxG;  // its shared memory

enum DType : int { kF32 = 0, kBF16 = 1 };

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  float* po;  // [splits, BH, G, D] un-normalised partial outputs
  float* pm;  // [splits, BH, G] partial row maxima
  float* pl;  // [splits, BH, G] partial row sums
  int* tickets;  // [BH] zero between launches
  void* o;    // [BH, G, D]
  int BH, G, S, D, splits, tiles_per_split, vec;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// 16 B of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// o[bh, g, d] = sum_s w_s o_s / max(sum_s w_s l_s, 1e-30), w_s = exp(m_s -
// max_s m_s), the splits taken in ascending order.  A split with no valid
// slot has m_s = -1e30 and l_s = o_s = 0: weight 0 beside any valid split.
// The partials are read through L2 (__ldcg): other CTAs wrote them.  A
// warp a row takes the maximum (exact in any order); then, kMergeChunk
// splits at a time, the CTA stages (w_s, l_s) in shared memory, and each
// thread folds its items (output elements) over the chunk's splits in
// order.  The loads of NS splits x NI items are issued before any of them
// is used: the merge is a chain of L2 round trips, so their number, not
// the bytes, sets its time.  `scratch` is kMergeFloats floats of the CTA's
// shared memory that nothing else uses any more.
template <typename T, int NI, int NS>
__device__ void merge_row(const DecodeArgs& a, int bh, float* scratch) {
  float* m_star = scratch;                                          // [kMaxG]
  auto w_c = reinterpret_cast<float(*)[kMaxG]>(scratch + kMaxG);   // [kMergeChunk][kMaxG]
  auto l_c = w_c + kMergeChunk;                                     // [kMergeChunk][kMaxG]
  const int G = a.G, D = a.D, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long stride = static_cast<long long>(a.BH) * G;  // between splits
  const float* pm = a.pm + static_cast<long long>(bh) * G;
  const float* pl = a.pl + static_cast<long long>(bh) * G;
  const float* po = a.po + static_cast<long long>(bh) * G * D;
  for (int g = warp; g < G; g += nt / 32) {
    float m = kNegInf;
    for (int s = lane; s < a.splits; s += 32) m = fmaxf(m, __ldcg(pm + s * stride + g));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) m_star[g] = m;
  }
  const int n_items = G * D;
  for (int base = 0; base < n_items; base += nt * NI) {
    float acc[NI], lsum[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[i] = lsum[i] = 0.0f;
    for (int c0 = 0; c0 < a.splits; c0 += kMergeChunk) {
      const int nc = min(kMergeChunk, a.splits - c0);
      __syncthreads();  // m_star written; the last chunk's reads done
      for (int i = tid; i < nc * G; i += nt) {
        const int s = i / G, g = i % G;
        const long long r = (c0 + s) * stride + g;
        w_c[s][g] = expf(__ldcg(pm + r) - m_star[g]);
        l_c[s][g] = __ldcg(pl + r);
      }
      __syncthreads();
      for (int sb = 0; sb < nc; sb += NS) {
        float x[NS][NI];
#pragma unroll
        for (int u = 0; u < NS; ++u) {
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int item = base + i * nt + tid;
            if (sb + u < nc && item < n_items) {
              x[u][i] = __ldcg(po + (c0 + sb + u) * stride * D + item);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < NS; ++u) {
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int item = base + i * nt + tid;
            if (sb + u < nc && item < n_items) {
              const int g = item / D;
              const float w = w_c[sb + u][g];
              lsum[i] = fmaf(l_c[sb + u][g], w, lsum[i]);
              acc[i] = fmaf(x[u][i], w, acc[i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int item = base + i * nt + tid;
      if (item < n_items) {
        static_cast<T*>(a.o)[static_cast<long long>(bh) * G * D + item] =
            from_f32<T>(acc[i] / fmaxf(lsum[i], 1e-30f));
      }
    }
  }
}

// Called by every thread of a CTA once its split's partials are written:
// true in the last CTA of row bh to get here, which then merges the row.
// That CTA resets the ticket at once: no CTA of this launch reads it again.
__device__ bool last_split(const DecodeArgs& a, int bh) {
  __shared__ int last;
  __threadfence();  // this thread's partials are visible device-wide
  __syncthreads();  // ... and every thread's
  if (threadIdx.x == 0) {
    last = atomicAdd(a.tickets + bh, 1) == a.splits - 1;
    if (last) a.tickets[bh] = 0;
  }
  __syncthreads();
  if (last) __threadfence();  // order the reads of the other CTAs' partials after the ticket
  return last;
}

// keys a tile: one a thread, at most 128 (shared memory at DMAX = 256)
#define TILE_KEYS(DMAX) ((DMAX) < 128 ? (DMAX) : 128)

template <int DMAX>
size_t split_smem_bytes(int G) {
  constexpr int TK = TILE_KEYS(DMAX);
  // Q [G][DMAX], K [TK][DMAX + 4], P [G][TK], row m/l/alpha [kMaxG] each,
  // valid flags [TK]; at the end the merge's staging
  const size_t n = static_cast<size_t>(G) * DMAX + TK * (DMAX + 4) +
                   static_cast<size_t>(G) * TK + 3 * kMaxG + TK;
  return sizeof(float) * (n > kMergeFloats ? n : kMergeFloats);
}

template <typename T, int DMAX, int GMAX>
__global__ void __launch_bounds__(DMAX)
decode_split_kernel(const __grid_constant__ DecodeArgs a) {
  constexpr int TK = TILE_KEYS(DMAX);
  constexpr int LDK = DMAX + 4;
  constexpr int NW = DMAX / 32;
  constexpr int E = 16 / sizeof(T);  // elements a 16 B load
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = a.G, D = a.D;
  float* Qs = smem;           // [G][DMAX]
  float* Ks = Qs + G * DMAX;  // [TK][LDK]
  float* Ps = Ks + TK * LDK;  // [G][TK]
  float* row_m = Ps + G * TK;
  float* row_l = row_m + kMaxG;
  float* row_a = row_l + kMaxG;
  int* ok_s = reinterpret_cast<int*>(row_a + kMaxG);  // [TK]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int split = blockIdx.x, bh = blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + static_cast<long long>(bh) * G * D;
  const T* k = static_cast<const T*>(a.k) + static_cast<long long>(bh) * a.S * D;
  const T* v = static_cast<const T*>(a.v) + static_cast<long long>(bh) * a.S * D;
  const uint8_t* valid = a.valid + static_cast<long long>(bh) * a.S;

  for (int i = t; i < G * DMAX; i += DMAX) {
    const int g = i / DMAX, d = i % DMAX;
    Qs[i] = d < D ? to_f32(q[g * D + d]) : 0.0f;
  }
  if (t < G) {
    row_m[t] = kNegInf;
    row_l[t] = 0.0f;
  }
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.0f;

  const int j_begin = split * a.tiles_per_split * kTileKeys;
  const int j_end = min(a.S, j_begin + a.tiles_per_split * kTileKeys);
  for (int j0 = j_begin; j0 < j_end; j0 += TK) {
    const int ok = t < TK && j0 + t < j_end && valid[j0 + t];
    // A tile with no valid slot leaves (m, l, acc) as they are (p = 0,
    // alpha = 1): skip it.  The vote is also the barrier after the last
    // tile's reads of Ks and Ps.
    if (!__syncthreads_or(ok)) continue;
    if (t < TK) ok_s[t] = ok;
    if (a.vec) {  // D == DMAX, 16 B aligned rows
      for (int i = t; i < TK * (DMAX / E); i += DMAX) {
        const int r = i / (DMAX / E), c = (i % (DMAX / E)) * E;
        float f[E];
        if (j0 + r < j_end) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(
              k + static_cast<long long>(j0 + r) * D + c));
          unpack(u, f, T());
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) f[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          *reinterpret_cast<float4*>(Ks + r * LDK + c + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        }
      }
    } else {
      for (int i = t; i < TK * DMAX; i += DMAX) {
        const int r = i / DMAX, c = i % DMAX;
        Ks[r * LDK + c] = (c < D && j0 + r < j_end)
                              ? to_f32(k[static_cast<long long>(j0 + r) * D + c])
                              : 0.0f;
      }
    }
    __syncthreads();

    if (t < TK) {  // thread t scores key j0 + t against every query row
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] = 0.0f;
      const float4* kr = reinterpret_cast<const float4*>(Ks + t * LDK);
      const float4* q4 = reinterpret_cast<const float4*>(Qs);
#pragma unroll 4
      for (int c = 0; c < DMAX / 4; ++c) {
        const float4 kk = kr[c];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float4 qq = q4[g * (DMAX / 4) + c];
            s[g] = fmaf(qq.x, kk.x, s[g]);
            s[g] = fmaf(qq.y, kk.y, s[g]);
            s[g] = fmaf(qq.z, kk.z, s[g]);
            s[g] = fmaf(qq.w, kk.w, s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) Ps[g * TK + t] = ok ? s[g] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {  // a warp per query row
      float mx = kNegInf;
      for (int jj = lane; jj < TK; jj += 32) mx = fmaxf(mx, Ps[g * TK + jj]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = row_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int jj = lane; jj < TK; jj += 32) {
        const float p = ok_s[jj] ? expf(Ps[g * TK + jj] - m_new) : 0.0f;
        Ps[g * TK + jj] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[g] = alpha;
        row_l[g] = row_l[g] * alpha + sum;
        row_m[g] = m_new;
      }
    }
    __syncthreads();

    // thread t owns output column d = t of every query row
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) acc[g] *= row_a[g];
    }
    const bool col = t < D;
#pragma unroll 2
    for (int jj = 0; jj < TK; jj += 4) {
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jr = j0 + jj + u;
        vv[u] = (col && jr < j_end) ? to_f32(v[static_cast<long long>(jr) * D + t]) : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float4 pp = *reinterpret_cast<const float4*>(Ps + g * TK + jj);
          acc[g] = fmaf(pp.x, vv[0], acc[g]);
          acc[g] = fmaf(pp.y, vv[1], acc[g]);
          acc[g] = fmaf(pp.z, vv[2], acc[g]);
          acc[g] = fmaf(pp.w, vv[3], acc[g]);
        }
      }
    }
  }
  __syncthreads();

  if (a.splits == 1) {  // the merge of one split: o / max(l, 1e-30)
    if (t < D) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          static_cast<T*>(a.o)[(static_cast<long long>(bh) * G + g) * D + t] =
              from_f32<T>(acc[g] / fmaxf(row_l[g], 1e-30f));
        }
      }
    }
    return;
  }
  const long long row0 = (static_cast<long long>(split) * a.BH + bh) * G;
  if (t < D) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) a.po[(row0 + g) * D + t] = acc[g];
    }
  }
  if (t < G) {
    a.pm[row0 + t] = row_m[t];
    a.pl[row0 + t] = row_l[t];
  }
  if (last_split(a, bh)) merge_row<T, 8, 8>(a, bh, smem);
}

template <typename T, int DMAX, int GMAX>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<DMAX>(a.G);
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<T, DMAX, GMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  decode_split_kernel<T, DMAX, GMAX>
      <<<dim3(a.splits, a.BH), dim3(DMAX), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_g(const DecodeArgs& a, cudaStream_t stream) {
  if (a.G <= 1) return launch<T, DMAX, 1>(a, stream);
  if (a.G <= 2) return launch<T, DMAX, 2>(a, stream);
  if (a.G <= 4) return launch<T, DMAX, 4>(a, stream);
  if (a.G <= 8) return launch<T, DMAX, 8>(a, stream);
  if (a.G <= 16) return launch<T, DMAX, 16>(a, stream);
  return launch<T, DMAX, 32>(a, stream);
}

template <typename T>
cudaError_t launch_t(const DecodeArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_g<T, 64>(a, stream);
  if (a.D <= 128) return launch_g<T, 128>(a, stream);
  return launch_g<T, 256>(a, stream);
}

// ------------------------------------------------------- ring kernel (bf16)
namespace ring {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps, 16 keys of each tile a warp
constexpr int kWarps = 4;
constexpr int kStages = 3;
constexpr int kRows = 16;      // query rows of the mma tile (G <= 16)

template <int D> __host__ __device__ constexpr int min_ctas() { return D <= 64 ? 4 : (D <= 128 ? 2 : 1); }
template <int D>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(bf16) * static_cast<size_t>(2 * kStages * kTileKeys) * D;
}
template <int D>
constexpr size_t smem_bytes() {  // ring, Q, the tile list and its flags
  return ring_bytes<D>() + sizeof(bf16) * kRows * D + sizeof(int) * kMaxTiles + kMaxTiles;
}

// key rows [j0, j0 + 64) of a [S, D] bf16 matrix into a swizzled tile,
// rows past S zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int j0, int S) {
  constexpr int CH = D / 8;
  static_assert(kTileKeys * CH % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kTileKeys * CH / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / CH, c = i % CH;
    const bool ok = j0 + r < S;
    const bf16* src = ok ? base + static_cast<long long>(j0 + r) * D + c * 8 : base;
    mma::cp_async_16(dst + mma::swz<D>(r, c * 8), src, ok);
  }
}

// The merge of merge_row for the ring kernel, with the partials brought
// in by cp.async: a chunk of splits at a time, as many as fit the free
// ring, is copied into shared memory in one go (their rows of the
// partials are contiguous; the first chunk while the maxima are read),
// while (w_s, l_s) are staged beside them; then each thread folds its
// float4 items over the chunk in ascending order.  About one L2 round
// trip a chunk instead of one every few splits.
template <int D>
__device__ void merge_row_staged(const DecodeArgs& a, int bh, float* scratch) {
  constexpr int kRingFloats = static_cast<int>(ring_bytes<D>() / sizeof(float));
  constexpr int kHdr = kMaxG + 2 * kMergeChunk * kRows;  // a multiple of 4 floats
  constexpr int NI = kRows * D / 4 / kThreads;            // float4 items a thread, at most
  const int G = a.G, per = G * D, per4 = per / 4, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int C = min(kMergeChunk, (kRingFloats - kHdr) / per);  // splits a chunk
  float* m_star = scratch;                  // [kMaxG]
  float* w_c = scratch + kMaxG;             // [kMergeChunk][kRows]
  float* l_c = w_c + kMergeChunk * kRows;   // [kMergeChunk][kRows]
  float* buf = scratch + kHdr;              // [C][G][D]
  const long long stride = static_cast<long long>(a.BH) * G;  // between splits
  const float* pm = a.pm + static_cast<long long>(bh) * G;
  const float* pl = a.pl + static_cast<long long>(bh) * G;
  const float* po = a.po + static_cast<long long>(bh) * per;
  const auto copy_chunk = [&](int c0, int nc) {  // nc splits' partials into buf
    for (int i = tid; i < nc * per4; i += kThreads) {
      const int s = i / per4, c = i % per4;
      mma::cp_async_16(buf + s * per + 4 * c, po + (c0 + s) * stride * D + 4 * c, true);
    }
    mma::cp_async_commit();
  };
  copy_chunk(0, min(C, a.splits));  // in flight while the maxima are read
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int s = lane; s < a.splits; s += 32) m = fmaxf(m, __ldcg(pm + s * stride + g));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) m_star[g] = m;
  }
  float acc[NI][4], lsum[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) lsum[i] = acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  for (int c0 = 0; c0 < a.splits; c0 += C) {
    const int nc = min(C, a.splits - c0);
    __syncthreads();  // m_star written; the last chunk's reads done
    if (c0 > 0) copy_chunk(c0, nc);
    for (int i = tid; i < nc * G; i += kThreads) {
      const int s = i / G, g = i % G;
      const long long r = (c0 + s) * stride + g;
      w_c[s * kRows + g] = expf(__ldcg(pm + r) - m_star[g]);
      l_c[s * kRows + g] = __ldcg(pl + r);
    }
    mma::cp_async_wait<0>();
    __syncthreads();
    for (int s = 0; s < nc; ++s) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int item = tid + i * kThreads;
        if (item < per4) {
          const int g = item * 4 / D;
          const float w = w_c[s * kRows + g];
          lsum[i] = fmaf(l_c[s * kRows + g], w, lsum[i]);
          const float4 x = reinterpret_cast<const float4*>(buf + s * per)[item];
          acc[i][0] = fmaf(x.x, w, acc[i][0]);
          acc[i][1] = fmaf(x.y, w, acc[i][1]);
          acc[i][2] = fmaf(x.z, w, acc[i][2]);
          acc[i][3] = fmaf(x.w, w, acc[i][3]);
        }
      }
    }
  }
  bf16* out = static_cast<bf16*>(a.o) + static_cast<long long>(bh) * per;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int item = tid + i * kThreads;
    if (item < per4) {
      const float l = fmaxf(lsum[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * item + e] = __float2bfloat16(acc[i][e] / l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, min_ctas<D>())
decode_ring_kernel(const __grid_constant__ DecodeArgs a) {
  constexpr int KS = D / 16, NB = D / 8;
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);         // [kStages][64][D]
  bf16* Vs = Ks + kStages * kTileKeys * D;              // [kStages][64][D]
  bf16* Qs = Vs + kStages * kTileKeys * D;              // [16][D]
  int* list = reinterpret_cast<int*>(Qs + kRows * D);   // [kMaxTiles]
  uint8_t* flags = reinterpret_cast<uint8_t*>(list + kMaxTiles);
  float* Os = reinterpret_cast<float*>(smem_raw);       // [kWarps][16][D], after the ring
  __shared__ int n_list;
  __shared__ float wm[kWarps][kRows], wl[kWarps][kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, bh = blockIdx.y;
  const int G = a.G, S = a.S;
  const bf16* q = static_cast<const bf16*>(a.q) + static_cast<long long>(bh) * G * D;
  const bf16* k = static_cast<const bf16*>(a.k) + static_cast<long long>(bh) * S * D;
  const bf16* v = static_cast<const bf16*>(a.v) + static_cast<long long>(bh) * S * D;
  const uint8_t* valid = a.valid + static_cast<long long>(bh) * S;

  // Q rows 0 .. G - 1, rows G .. 15 zero (their scores are never used)
  constexpr int QCH = D / 8;
#pragma unroll
  for (int it = 0; it < kRows * QCH / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / QCH, c = i % QCH;
    mma::cp_async_16(Qs + mma::swz<D>(r, c * 8), r < G ? q + r * D + c * 8 : q, r < G);
  }
  mma::cp_async_commit();

  // the split's tiles that hold a valid slot, in order
  const int t_begin = split * a.tiles_per_split;
  const int n_span = min(a.tiles_per_split, (S + kTileKeys - 1) / kTileKeys - t_begin);
  for (int i = tid; i < n_span; i += kThreads) flags[i] = 0;
  __syncthreads();
  {
    const int j_end = min(S, (t_begin + n_span) * kTileKeys);
    for (int j = t_begin * kTileKeys + tid; j < j_end; j += kThreads) {
      if (valid[j]) flags[j / kTileKeys - t_begin] = 1;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_span; base += 32) {
      const bool f = base + lane < n_span && flags[base + lane];
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(bal & ((1u << lane) - 1u))] = t_begin + base + lane;
      n += __popc(bal);
    }
    if (lane == 0) n_list = n;
  }
  __syncthreads();
  const int n = n_list;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n) {
      load_tile<D>(Ks + st * kTileKeys * D, k, list[st] * kTileKeys, S);
      load_tile<D>(Vs + st * kTileKeys * D, v, list[st] * kTileKeys, S);
    }
    mma::cp_async_commit();
  }

  float o[NB][4];
#pragma unroll
  for (int c = 0; c < NB; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // rows g, g + 8
  uint32_t qf[kQRegs ? KS : 1][4];

  for (int i = 0; i < n; ++i) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed for all; stage (i - 1) % kStages is free
    {
      const int nx = i + kStages - 1;
      if (nx < n) {
        const int st = nx % kStages;
        load_tile<D>(Ks + st * kTileKeys * D, k, list[nx] * kTileKeys, S);
        load_tile<D>(Vs + st * kTileKeys * D, v, list[nx] * kTileKeys, S);
      }
      mma::cp_async_commit();
    }
    if (kQRegs && i == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) mma::ldmatrix_x4(qf[kk], mma::a_addr<D>(Qs, 0, kk, lane));
    }
    const bf16* Kt = Ks + (i % kStages) * kTileKeys * D;
    const bf16* Vt = Vs + (i % kStages) * kTileKeys * D;
    const int kw = 16 * warp;                       // this warp's keys in the tile
    const int key0 = list[i] * kTileKeys + kw;

    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4], bf[4];
      if constexpr (kQRegs) {
        af[0] = qf[kk][0]; af[1] = qf[kk][1]; af[2] = qf[kk][2]; af[3] = qf[kk][3];
      } else {
        mma::ldmatrix_x4(af, mma::a_addr<D>(Qs, 0, kk, lane));
      }
      mma::ldmatrix_x4(bf, mma::bn_addr<D>(Kt, kw, kk, lane));
      mma::mma_16816(s[0], af, bf[0], bf[1]);
      mma::mma_16816(s[1], af, bf[2], bf[3]);
    }

    bool ok[2][2];  // [n-block][column 2t + c]
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = key0 + 8 * nb + 2 * t + c;
        ok[nb][c] = key < S && valid[key];
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = ok[nb][e & 1] ? s[nb][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = ok[nb][e & 1] ? expf(s[nb][e] - m[e >> 1]) : 0.0f;
        rs[e >> 1] += s[nb][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    uint32_t ph[4], pl[4];
    mma::p_fragments(s[0], s[1], ph, pl);
#pragma unroll
    for (int jd = 0; jd < NB / 2; ++jd) {
      o[2 * jd][0] *= alpha[0]; o[2 * jd][1] *= alpha[0];
      o[2 * jd][2] *= alpha[1]; o[2 * jd][3] *= alpha[1];
      o[2 * jd + 1][0] *= alpha[0]; o[2 * jd + 1][1] *= alpha[0];
      o[2 * jd + 1][2] *= alpha[1]; o[2 * jd + 1][3] *= alpha[1];
      uint32_t bf[4];
      mma::ldmatrix_x4_trans(bf, mma::bk_addr<D>(Vt, kw, 16 * jd, lane));
      mma::mma_16816(o[2 * jd], ph, bf[0], bf[1]);
      mma::mma_16816(o[2 * jd], pl, bf[0], bf[1]);
      mma::mma_16816(o[2 * jd + 1], ph, bf[2], bf[3]);
      mma::mma_16816(o[2 * jd + 1], pl, bf[2], bf[3]);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' partials now

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t == 0) {
    wm[warp][g] = m[0];
    wl[warp][g] = l[0];
    wm[warp][g + 8] = m[1];
    wl[warp][g + 8] = l[1];
  }
  float* Ow = Os + warp * kRows * D;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    *reinterpret_cast<float2*>(Ow + g * D + 8 * c + 2 * t) = make_float2(o[c][0], o[c][1]);
    *reinterpret_cast<float2*>(Ow + (g + 8) * D + 8 * c + 2 * t) = make_float2(o[c][2], o[c][3]);
  }
  __syncthreads();

  // the four warps' partials merged in warp order: the split's (o, m, l)
  const long long row0 = (static_cast<long long>(split) * a.BH + bh) * G;
  for (int i = tid; i < G * D; i += kThreads) {
    const int gg = i / D, d = i % D;
    float ms = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, wm[w][gg]);
    float lt = 0.0f, ot = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(wm[w][gg] - ms);
      lt = fmaf(wl[w][gg], wt, lt);
      ot = fmaf(Os[(w * kRows + gg) * D + d], wt, ot);
    }
    if (a.splits == 1) {
      static_cast<bf16*>(a.o)[(static_cast<long long>(bh) * G + gg) * D + d] =
          __float2bfloat16(ot / fmaxf(lt, 1e-30f));
    } else {
      a.po[(row0 + gg) * D + d] = ot;
      if (d == 0) {
        a.pm[row0 + gg] = ms;
        a.pl[row0 + gg] = lt;
      }
    }
  }
  if (a.splits > 1 && last_split(a, bh)) merge_row_staged<D>(a, bh, Os);
}

// opt in to the dynamic shared memory and ask for the largest shared
// carveout, so min_ctas<D>() CTAs fit an SM
template <int D>
cudaError_t configure() {
  const cudaError_t e = cudaFuncSetAttribute(decode_ring_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem_bytes<D>()));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(decode_ring_kernel<D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static_assert(sizeof(float) * kWarps * kRows * D <= ring_bytes<D>(), "partials fit the ring");
  static_assert(kMaxG + 2 * kMergeChunk * kRows + kRows * D <= ring_bytes<D>() / sizeof(float),
                "the merge's staging and one split's partials fit the ring");
  const cudaError_t attr = configure<D>();
  if (attr != cudaSuccess) return attr;
  decode_ring_kernel<D><<<dim3(a.splits, a.BH), dim3(kThreads), bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ring

}  // namespace

extern "C" {

// q [BH, G, D], k/v [BH, S, D] contiguous (dtype 0 f32, 1 bf16), valid
// [BH, S] bytes, o [BH, G, D] in q's dtype.  splits * tiles_per_split
// tiles of 64 keys cover S, no split is empty and a split has at most 256
// tiles.  With splits > 1: po/pm/pl f32 scratch of splits * BH * G * D,
// splits * BH * G and splits * BH * G, and tickets, BH ints that are 0
// and that no concurrent launch uses.  path 0: the scalar kernel; 1: the
// scalar kernel with 16 B loads of k (D is 64, 128 or 256, k 16 B
// aligned); 2: the ring kernel (bf16, D 64, 128 or 256, G <= 16, q, k
// and v 16 B aligned).
int flash_decode(const void* q, const void* k, const void* v,
                 const void* valid, void* o, void* po, void* pm, void* pl,
                 void* tickets, int dtype, int BH, int G, int S, int D, int splits,
                 int tiles_per_split, int path, float scale, void* stream) {
  const long long span = static_cast<long long>(tiles_per_split) * kTileKeys;
  const bool tc_dim = D == 64 || D == 128 || D == 256;
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (BH <= 0 || BH > 65535 || G <= 0 || G > kMaxG || S <= 0 || D <= 0 ||
      D > 256 || tiles_per_split <= 0 || tiles_per_split > kMaxTiles || splits <= 0 ||
      splits * span < S || (splits - 1) * span >= S ||
      (dtype != kF32 && dtype != kBF16) || path < 0 || path > 2 ||
      (path == 1 && !(tc_dim && al(k))) ||
      (path == 2 && !(dtype == kBF16 && tc_dim && G <= ring::kRows && al(q) && al(k) &&
                      al(v))) ||
      (splits > 1 && (po == nullptr || pm == nullptr || pl == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid = static_cast<const uint8_t*>(valid);
  a.po = static_cast<float*>(po);
  a.pm = static_cast<float*>(pm);
  a.pl = static_cast<float*>(pl);
  a.tickets = static_cast<int*>(tickets);
  a.o = o;
  a.BH = BH;
  a.G = G;
  a.S = S;
  a.D = D;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.vec = path == 1;
  a.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (path == 2) {
    e = D == 64 ? ring::launch<64>(a, s) : D == 128 ? ring::launch<128>(a, s)
                                                    : ring::launch<256>(a, s);
  } else {
    e = dtype == kF32 ? launch_t<float>(a, s) : launch_t<__nv_bfloat16>(a, s);
  }
  return static_cast<int>(e);
}

// CTAs of the ring kernel that fit one SM at head dim D (64, 128 or 256),
// or -1: a diagnostic the smoke run prints.
int flash_decode_ring_ctas_per_sm(int D) {
  int n = -1;
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 64 && ring::configure<64>() == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ring::decode_ring_kernel<64>,
                                                      ring::kThreads, ring::smem_bytes<64>());
  } else if (D == 128 && ring::configure<128>() == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ring::decode_ring_kernel<128>,
                                                      ring::kThreads, ring::smem_bytes<128>());
  } else if (D == 256 && ring::configure<256>() == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ring::decode_ring_kernel<256>,
                                                      ring::kThreads, ring::smem_bytes<256>());
  }
  return e == cudaSuccess ? n : -1;
}

}  // extern "C"
