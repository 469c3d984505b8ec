// Fragment helpers for the bf16 tensor-core kernels (sm_90a): asynchronous
// 16 B and 4 B copies into shared memory (the ELL lane kernel's too), an
// XOR-swizzled [rows][D] bf16 tile layout, ldmatrix and mma.sync.m16n8k16
// (bf16 in, f32 accumulate).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), for
// lane = 4 g + t:
//   A (16 x 16, row-major) 4 regs: rows g, g + 8 x columns 2t, 2t + 1 and
//     2t + 8, 2t + 9;
//   B (16 x 8, k x n) 2 regs: k rows 2t, 2t + 1 and 2t + 8, 2t + 9 at column g;
//   C (16 x 8, f32) 4 floats: c0, c1 at row g, columns 2t, 2t + 1; c2, c3
//     at row g + 8.
// So the C fragments of two neighbouring n-blocks are, packed to bf16
// pairs, the A fragment of one 16-deep k-step: the scores of one product
// feed the next without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// A tile of R rows x D bf16 in shared memory: the 16 B chunk c of row r
// sits at chunk c ^ (r % 8), so the 8 rows an ldmatrix matrix reads (or a
// warp's copies write) fall on 8 different bank groups.  D >= 64.
template <int D>
__device__ __forceinline__ int swz(int r, int col) {
  return r * D + ((((col >> 3) ^ (r & 7))) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared, bypassing L1; zero-filled when !pred (src must
// still be a valid address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4 B global -> shared, likewise
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair (x in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p = hi + lo to about 16 significant bits: hi = bf16(p), lo = bf16(p - hi).
// Two bf16 products against the same operand then carry P at nearly f32
// precision (the reference multiplies P by V in f32).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x, y);
  const float hx = __uint_as_float(hi << 16), hy = __uint_as_float(hi & 0xffff0000u);
  lo = pack_bf16(x - hx, y - hy);
}

// A fragments (hi and lo) of the 16-key k-step made of the C fragments of
// n-blocks c0 (keys 0-7) and c1 (keys 8-15)
__device__ __forceinline__ void p_fragments(const float (&c0)[4], const float (&c1)[4],
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// ldmatrix lane addresses into a swizzled [rows][D] tile.
// A operand, rows r0 .. r0 + 15, k-step kk (columns 16 kk .. 16 kk + 15)
template <int D>
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* t, int r0,
                                                       int kk, int lane) {
  return t + swz<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 16 * kk + (lane >> 4) * 8);
}
// B operand from row-major [n][k] (K rows): n-blocks n0 / 8 and n0 / 8 + 1
// (rows n0 .. n0 + 15), k-step kk; regs {0, 1} -> n-block 0, {2, 3} -> 1
template <int D>
__device__ __forceinline__ const __nv_bfloat16* bn_addr(const __nv_bfloat16* t, int n0,
                                                        int kk, int lane) {
  return t + swz<D>(n0 + (lane & 7) + (lane >> 4) * 8, 16 * kk + ((lane >> 3) & 1) * 8);
}
// B operand from row-major [k][n] (V rows), with .trans: k rows k0 .. k0 +
// 15, n-blocks at columns c0 and c0 + 8; regs {0, 1} -> c0, {2, 3} -> c0 + 8
template <int D>
__device__ __forceinline__ const __nv_bfloat16* bk_addr(const __nv_bfloat16* t, int k0,
                                                        int c0, int lane) {
  return t + swz<D>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, c0 + (lane >> 4) * 8);
}

// ------------------------------------------------- warpgroup MMA (wgmma)
// Shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor Format"):
// start address, leading and stride byte offsets (all >> 4), 128 B swizzle.
// A tile stored as [rows][64] bf16 blocks of 128 B rows with 16 B chunk c
// of row r at c ^ (r % 8) is the canonical 128 B-swizzled layout; its
// atoms (8 rows) must start 1024 B aligned, and a k-step of 16 elements
// inside a 64-wide block advances the start address by 32 B.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy (cp.async, stores) made
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across a wgmma's issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 f32) (+)= A B, A = 64 x 16 and B = 16 x 64 from shared memory
// (K-major descriptors); scale_d 0 overwrites d.  The accumulator layout
// of warp w is that of mma.sync m16n8 for rows 16 w .. 16 w + 15, n-block
// j in d[4 j .. 4 j + 3].
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N f32) += A B, A = 64 x 16 bf16 from registers (the mma.sync A
// fragment of each warp's 16 rows), B = 16 x N from shared memory,
// MN-major (transposed) descriptor; N = 64 and N = 128
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace mma
