// Two other designs of the flash kernel's head-dim 256 arm, measured
// beside the committed one (``src/repro_torch/csrc/flash_attention.cu``,
// two warpgroups each owning 64 query rows and every column) by
// ``tools/flash256_designs.py``, which appends this file to a copy of that
// source.  Both give a CTA 64 query rows and two warpgroups, each owning
// half the output columns; they differ in how the scores are made.
namespace {
namespace tcx {
using namespace tc;
using tc::kBK;
constexpr int kBQ = 64;

// "cols": 64 query rows a CTA of two warpgroups, warpgroup w owning output
// columns [128 w, 128 w + 128); both compute the whole 64 x 64 score tile
// over all of D (16 k-steps) from the same shared tiles, so their m, l and
// P are bitwise equal with nothing exchanged.
template <int D>
__global__ void __launch_bounds__(256, 1)
cols_kernel(const __grid_constant__ FlashArgs a) {
  static_assert(D == 256, "");
  constexpr int kTile = kBK * D, DW = 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile;
  bf16* Vs = Ks + kStages * kTile;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int r0 = warp * 16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const int off_q = a.Skv - a.Sq;
  const int kend = a.causal ? min(a.Skv, q0 + kBQ + off_q) : a.Skv;
  const int n_tiles = (kend + kBK - 1) / kBK;
  load_tile<D>(Qs, qb, a.sq[2], q0, a.Sq);
  load_tile<D>(Ks, kb, a.sk[2], 0, a.Skv);
  load_tile<D>(Vs, vb, a.sv[2], 0, a.Skv);
  mma::cp_async_commit();
  float o[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float sl2 = a.scale * 1.4426950408889634f;
  const int qpos0 = q0 + r0 + g + off_q;
  for (int j = 0; j < n_tiles; ++j) {
    mma::cp_async_wait<0>();
    mma::fence_proxy_async();
    __syncthreads();
    if (j + 1 < n_tiles) {
      const int st = (j + 1) % kStages;
      load_tile<D>(Ks + st * kTile, kb, a.sk[2], (j + 1) * kBK, a.Skv);
      load_tile<D>(Vs + st * kTile, vb, a.sv[2], (j + 1) * kBK, a.Skv);
    }
    mma::cp_async_commit();
    const bf16* Kt = Ks + (j % kStages) * kTile;
    const bf16* Vt = Vs + (j % kStages) * kTile + wg * 2 * (kBK * 64);
    uint64_t dq = mma::wgmma_desc(Qs, 16, kAtom);
    uint64_t dk = mma::wgmma_desc(Kt, 16, kAtom);
    uint64_t dv = mma::wgmma_desc(Vt, kBlock, kAtom);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    mma::fence_regs(s);
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t e = ((kk >> 2) * (kBK * 64) + (kk & 3) * 16) * 2 / 16;
      mma::wgmma_m64n64k16_ss(s, dq + e, dk + e, kk > 0);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(s);
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
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mu[r] = mn == -INFINITY ? 0.0f : mn;
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - mu[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
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
      const uint64_t e = (kk * 16 * 64) * 2 / 16;
      mma::wgmma_rs_mn(o, ph[kk], dv + e);
      mma::wgmma_rs_mn(o, pl[kk], dv + e);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(o);
  }
  mma::cp_async_wait<0>();
  float li[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    li[r] = fmaxf(l[r], 1e-30f);
  }
  __syncthreads();
  const int c0 = wg * DW;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + off(r0 + g, c0 + 8 * n + 2 * t)) =
        mma::pack_bf16(o[4 * n] / li[0], o[4 * n + 1] / li[0]);
    *reinterpret_cast<uint32_t*>(Qs + off(r0 + g + 8, c0 + 8 * n + 2 * t)) =
        mma::pack_bf16(o[4 * n + 2] / li[1], o[4 * n + 3] / li[1]);
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(a.o) + b * a.so[0] + h * a.so[1];
  constexpr int CH = DW / 8;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = c0 / 8 + i % CH, row = q0 + r0 + r;
    if (row < a.Sq) {
      *reinterpret_cast<uint4*>(ob + row * a.so[2] + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + off(r0 + r, c * 8));
    }
  }
}

// "split": 64 query rows a CTA of two warpgroups, warpgroup w owning
// output columns [128 w, 128 w + 128); each sums the scores over its half
// of D (8 k-steps) and the two exchange the f32 partial scores through
// shared memory (16 KB each) under one barrier, added in the same order in
// both (so their m, l and P are bitwise equal).
template <int D>
__global__ void __launch_bounds__(256, 1)
split_kernel(const __grid_constant__ FlashArgs a) {
  static_assert(D == 256, "");
  constexpr int kTile = kBK * D, DW = 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile;
  bf16* Vs = Ks + kStages * kTile;
  float* X = reinterpret_cast<float*>(Vs + kStages * kTile);  // [2][32][128]
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int tw = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int r0 = warp * 16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const int off_q = a.Skv - a.Sq;
  const int kend = a.causal ? min(a.Skv, q0 + kBQ + off_q) : a.Skv;
  const int n_tiles = (kend + kBK - 1) / kBK;
  load_tile<D>(Qs, qb, a.sq[2], q0, a.Sq);
  load_tile<D>(Ks, kb, a.sk[2], 0, a.Skv);
  load_tile<D>(Vs, vb, a.sv[2], 0, a.Skv);
  mma::cp_async_commit();
  float o[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float sl2 = a.scale * 1.4426950408889634f;
  const int qpos0 = q0 + r0 + g + off_q;
  for (int j = 0; j < n_tiles; ++j) {
    mma::cp_async_wait<0>();
    mma::fence_proxy_async();
    __syncthreads();
    if (j + 1 < n_tiles) {
      const int st = (j + 1) % kStages;
      load_tile<D>(Ks + st * kTile, kb, a.sk[2], (j + 1) * kBK, a.Skv);
      load_tile<D>(Vs + st * kTile, vb, a.sv[2], (j + 1) * kBK, a.Skv);
    }
    mma::cp_async_commit();
    const bf16* Kt = Ks + (j % kStages) * kTile;
    const bf16* Vt = Vs + (j % kStages) * kTile + wg * 2 * (kBK * 64);
    uint64_t dq = mma::wgmma_desc(Qs + wg * 2 * (kBK * 64), 16, kAtom);
    uint64_t dk = mma::wgmma_desc(Kt + wg * 2 * (kBK * 64), 16, kAtom);
    uint64_t dv = mma::wgmma_desc(Vt, kBlock, kAtom);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    mma::fence_regs(s);
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t e = ((kk >> 2) * (kBK * 64) + (kk & 3) * 16) * 2 / 16;
      mma::wgmma_m64n64k16_ss(s, dq + e, dk + e, kk > 0);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) X[(wg * 32 + i) * 128 + tw] = s[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += X[((1 - wg) * 32 + i) * 128 + tw];
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
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mu[r] = mn == -INFINITY ? 0.0f : mn;
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - mu[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
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
      const uint64_t e = (kk * 16 * 64) * 2 / 16;
      mma::wgmma_rs_mn(o, ph[kk], dv + e);
      mma::wgmma_rs_mn(o, pl[kk], dv + e);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(o);
  }
  mma::cp_async_wait<0>();
  float li[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    li[r] = fmaxf(l[r], 1e-30f);
  }
  __syncthreads();
  const int c0 = wg * DW;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + off(r0 + g, c0 + 8 * n + 2 * t)) =
        mma::pack_bf16(o[4 * n] / li[0], o[4 * n + 1] / li[0]);
    *reinterpret_cast<uint32_t*>(Qs + off(r0 + g + 8, c0 + 8 * n + 2 * t)) =
        mma::pack_bf16(o[4 * n + 2] / li[1], o[4 * n + 3] / li[1]);
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(a.o) + b * a.so[0] + h * a.so[1];
  constexpr int CH = DW / 8;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = c0 / 8 + i % CH, row = q0 + r0 + r;
    if (row < a.Sq) {
      *reinterpret_cast<uint4*>(ob + row * a.so[2] + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + off(r0 + r, c * 8));
    }
  }
}

template <typename K>
cudaError_t go(K kernel, const FlashArgs& a, int B, int rows, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + rows - 1) / rows, B * a.Hq);
  kernel<<<grid, 256, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace tcx
}  // namespace

// variant 0: the committed arm; 1: "cols"; 2: "split"
extern "C" int flash256_design(int variant, const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                               const long long* strides, int causal, float scale,
                               void* stream) {
  const FlashArgs a = make_args(q, k, v, o, Hq, Hkv, Sq, Skv, D, strides, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr size_t T = 64 * 256 * 2;  // bytes of a [64][256] bf16 tile
  if (D != 256 || !tc::aligned(a)) return cudaErrorInvalidValue;
  switch (variant) {
    case 0: return tc::launch<256>(a, B, s);
    case 1: return tcx::go(tcx::cols_kernel<256>, a, B, 64, 5 * T, s);
    case 2: return tcx::go(tcx::split_kernel<256>, a, B, 64, 5 * T + 32768, s);
  }
  return cudaErrorInvalidValue;
}
