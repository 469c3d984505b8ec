// Flash attention forward for Hopper (sm_90a): the attention of every
// prefill layer.
//
// flash_attention_fwd  replaces the TPU kernel
//     src/repro/kernels/flash_attention/kernel.py::flash_attention
//     (body _flash_kernel)
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//   for q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D], G = Hq / Hkv, scale =
//   D^-0.5.  Causal queries are the suffix of the keys: query i sits at
//   key position i + Skv - Sq and sees keys up to it.  Online softmax with
//   f32 statistics (m, l) and an f32 accumulator, P.V in f32 as the TPU
//   kernel does; the output is acc / l, written in q's dtype (f32 or bf16).
//   Any Sq, Skv (the ragged tail tile is masked), D <= 256.
//   Bound: operations.  4 B Hq Sq Skv D flops (halved when causal) against
//   bytes of q, k, v and o read or written once: at the prefill's shapes
//   (D = 128, Sq = Skv >= 512) over 200 flops a byte, past the card's
//   balance point.
//   Design (simple first: scalar f32 FMAs, no tensor cores, no TMA).
//   The TPU grid carries (m, l, acc) in VMEM scratch across its sequential
//   kv axis; here one CTA of 128 threads owns one (batch * head, 64-query
//   tile) and loops over 64-key tiles itself.  The query tile, each K and
//   V tile and the tile's probabilities are staged in shared memory as
//   f32 (115 KB at D = 128, 214 KB at D = 256: one CTA an SM).  Thread
//   (ty, tx) = (tid / 8, tid % 8) owns query rows 4 ty .. 4 ty + 3: it
//   computes their scores against keys tx, tx + 8, ..., tx + 56, folds
//   the row max and sum over the 8 threads of the row with xor shuffles,
//   and keeps the rows' output columns tx, tx + 8, ... in registers.
//   Shared tiles are padded by one float a row so that neither the
//   coalesced fills nor the strided reads conflict on banks.  GQA by
//   index: query head h reads K/V head h / G, nothing is expanded.  Every
//   tensor is read through its own strides (the model hands over
//   transposed views; the output is written into the caller's layout).
//   Key tiles wholly above the diagonal are never loaded (the TPU
//   baseline still copies them in).
//
// The C function launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// strides: 16 element strides, (b, h, s, d) of q, k, v and o in turn.
// The wrapper has checked shapes, dtypes, devices, Hq % Hkv == 0,
// 1 <= D <= 256, Sq, Skv >= 1, B * Hq <= 65535, and Sq <= Skv if causal.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Hq, int Hkv, int Sq, int Skv,
                        int D, const long long* strides, int causal,
                        float scale, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(a, B, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
