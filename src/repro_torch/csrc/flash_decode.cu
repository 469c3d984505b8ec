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
//   Design (simple first: scalar f32 FMAs, no tensor cores, no TMA).
//   The TPU grid walks the kv blocks of one row in order on one core,
//   carrying (m, l, acc) in VMEM.  Here that would be BH CTAs (8 for a
//   batch of 4 on Qwen2.5-3B's 2 kv heads) for 132 SMs, so the kv axis is
//   split: pass 1 gives each (split, row) CTA a run of whole key tiles
//   and writes its un-normalised (o, m, l), as decode_partials_ref does
//   for a shard of the cache; pass 2 merges the splits of each row in
//   ascending order, the algebra of flash_decode_combine, so the result is
//   deterministic.  The split count depends only on the shapes (about
//   512 CTAs in all: the wrapper's decode_splits).  A pass-1 CTA has DMAX threads (the head dim
//   rounded up to 64, 128 or 256); a key tile is TK = min(DMAX, 128)
//   keys, staged in shared memory as f32 rows padded by 4 floats (16 B
//   reads without bank conflicts).  Thread t < TK scores key t against the
//   G query rows (q in shared memory, read as broadcasts); a warp per
//   query row folds the tile's max and sum with xor shuffles; then thread
//   t owns output column d = t for all G rows and reads V straight from
//   device memory, coalesced along d, the tile's probabilities broadcast
//   from shared memory.
//
// The C function launches both passes on the caller's stream, allocates
// nothing (the caller passes the partials' scratch) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF: finite
constexpr int kMaxG = 32;
constexpr int kMergeThreads = 128;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  float* po;  // [splits, BH, G, D] un-normalised partial outputs
  float* pm;  // [splits, BH, G] partial row maxima
  float* pl;  // [splits, BH, G] partial row sums
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

// keys a tile: one a thread, at most 128 (shared memory at DMAX = 256)
#define TILE_KEYS(DMAX) ((DMAX) < 128 ? (DMAX) : 128)

template <int DMAX>
size_t split_smem_bytes(int G) {
  constexpr int TK = TILE_KEYS(DMAX);
  // Q [G][DMAX], K [TK][DMAX + 4], P [G][TK], row m/l/alpha [kMaxG] each,
  // valid flags [TK]
  return sizeof(float) * (static_cast<size_t>(G) * DMAX + TK * (DMAX + 4) +
                          static_cast<size_t>(G) * TK + 3 * kMaxG + TK);
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

  const int j_begin = split * a.tiles_per_split * TK;
  const int j_end = min(a.S, j_begin + a.tiles_per_split * TK);
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
}

// o[bh, g, d] = sum_s w_s o_s / max(sum_s w_s l_s, 1e-30), w_s = exp(m_s -
// max_s m_s), the splits taken in ascending order.  A split with no valid
// slot has m_s = -1e30 and l_s = o_s = 0: weight 0 beside any valid split.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const __grid_constant__ DecodeArgs a) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  const int bh = blockIdx.y;
  if (i >= a.G * a.D) return;
  const int g = i / a.D, d = i % a.D;
  const long long stride = static_cast<long long>(a.BH) * a.G;  // between splits
  const long long r0 = static_cast<long long>(bh) * a.G + g;
  float m_star = kNegInf;
  for (int s = 0; s < a.splits; ++s) m_star = fmaxf(m_star, a.pm[s * stride + r0]);
  float l = 0.0f, o = 0.0f;
  for (int s = 0; s < a.splits; ++s) {
    const long long r = s * stride + r0;
    const float w = expf(a.pm[r] - m_star);
    l = fmaf(a.pl[r], w, l);
    o = fmaf(a.po[r * a.D + d], w, o);
  }
  static_cast<T*>(a.o)[r0 * a.D + d] = from_f32<T>(o / fmaxf(l, 1e-30f));
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
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((a.G * a.D + kMergeThreads - 1) / kMergeThreads, a.BH);
  decode_merge_kernel<T><<<grid, dim3(kMergeThreads), 0, stream>>>(a);
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

int dmax_of(int D) { return D <= 64 ? 64 : (D <= 128 ? 128 : 256); }

}  // namespace

extern "C" {

// q [BH, G, D], k/v [BH, S, D] contiguous (dtype 0 f32, 1 bf16), valid
// [BH, S] bytes, o [BH, G, D] in q's dtype; po/pm/pl f32 scratch of
// splits * BH * G * D, splits * BH * G and splits * BH * G; splits *
// tiles_per_split tiles of 64 keys (D <= 64) or 128 keys (D > 64) cover S
// and no split is empty.  vec != 0: D is 64, 128 or 256 and k is 16 B aligned.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* valid, void* o, void* po, void* pm, void* pl,
                 int dtype, int BH, int G, int S, int D, int splits,
                 int tiles_per_split, int vec, float scale, void* stream) {
  const long long tile = TILE_KEYS(dmax_of(D));
  const long long span = static_cast<long long>(tiles_per_split) * tile;
  if (BH <= 0 || BH > 65535 || G <= 0 || G > kMaxG || S <= 0 || D <= 0 ||
      D > 256 || tiles_per_split <= 0 || splits <= 0 ||
      splits * span < S || (splits - 1) * span >= S ||
      (dtype != kF32 && dtype != kBF16) || (vec && D != dmax_of(D))) {
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
  a.o = o;
  a.BH = BH;
  a.G = G;
  a.S = S;
  a.D = D;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.vec = vec;
  a.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == kF32 ? launch_t<float>(a, s)
                                      : launch_t<__nv_bfloat16>(a, s);
  return static_cast<int>(e);
}

}  // extern "C"
