// Tile helpers shared by the tensor-core attention kernels (sm_90a): the
// paged kernel (csrc/paged_attention.cu, mma.sync) and K2f, K2q and K2kv
// (csrc/flash_attention.cu, wgmma).  16-byte cp.async copies into shared
// memory, ldmatrix fragment loads, the bf16 mma.sync.m16n8k16 and
// wgmma.m64nNk16 products with f32 accumulators, and the online-softmax
// step both run on their score fragments.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for
// lane = threadIdx.x % 32, g = lane / 4, t = lane % 4:
//   - A (16 x 16, row-major), 4 registers of bf16x2: a0 = (g, 2t..2t+1),
//     a1 = (g + 8, 2t..), a2 = (g, 8 + 2t..), a3 = (g + 8, 8 + 2t..);
//   - B (16 x 8, k x n), 2 registers: b0 = (k 2t..2t+1, n g),
//     b1 = (k 8 + 2t.., n g);
//   - C/D (16 x 8, f32), 4 registers: c0, c1 = (g, 2t), (g, 2t + 1);
//     c2, c3 = (g + 8, 2t), (g + 8, 2t + 1).
// The C layout of two neighbouring n-tiles is the A layout of one k16
// slice, so a score tile turns into the A operand of the next product in
// registers (pack_bf16x2), with no trip through shared memory.
//
// Tiles in shared memory are rows of bf16 with a row stride of a multiple
// of 8 elements plus 8 (16 bytes of padding): the 8 rows that one
// ldmatrix phase reads then start in 8 distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes < 16 fills the rest with zeros
// (0: a row past the end, nothing is read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (a scale); src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// reductions over the 4 lanes (t = 0..3) that share a fragment row; each
// lane ends with the same bits, in a fixed order
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S[16 x 8 kN] += Q[16 x kD] K^T for one warp.  q points at the warp's
// first query row of a [rows][ldq] bf16 tile, k at key row 0 of a
// [>= 8 kN][ld] bf16 tile.
template <int kD, int kN>
__device__ __forceinline__ void qk_tile(float (&s)[kN][4],
                                        const __nv_bfloat16* q, int ldq,
                                        const __nv_bfloat16* k, int ld,
                                        int lane) {
  static_assert(kN % 2 == 0, "two key n-tiles per ldmatrix");
  // A: rows 0-15 at k 0-7 (lanes 0-15), then k 8-15 (lanes 16-31)
  const int a_row = lane & 15, a_col = (lane >> 4) << 3;
  // B: (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7),
  // (keys 8-15, d 8-15) of each 16-key pair of n-tiles
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, q + a_row * ldq + kk * 16 + a_col);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, k + (n * 8 + b_row) * ld + kk * 16 + b_col);
      mma_bf16(s[n], a, b[0], b[1]);
      mma_bf16(s[n + 1], a, b[2], b[3]);
    }
  }
}

// O[16 x kD] += P[16 x 16 kK] V for one warp: p holds the A fragments of
// kK 16-key slices, v points at key row 0 of a [16 kK][ld] bf16 tile.
template <int kD, int kK>
__device__ __forceinline__ void pv_tile(float (&o)[kD / 8][4],
                                        const uint32_t (&p)[kK][4],
                                        const __nv_bfloat16* v, int ld,
                                        int lane) {
  // matrices (transposed): (keys 0-7, d 0-7), (keys 8-15, d 0-7),
  // (keys 0-7, d 8-15), (keys 8-15, d 8-15)
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int n = 0; n < kD / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v + (kk * 16 + row) * ld + n * 8 + col);
      mma_bf16(o[n], p[kk], b[0], b[1]);
      mma_bf16(o[n + 1], p[kk], b[2], b[3]);
    }
  }
}

// One online-softmax step of one m-tile (16 rows) over a tile of 8 kN
// keys.  s holds the tile's scaled scores, -inf where masked (p is then
// exactly 0, even while m is the -1e30 seed), and is overwritten with the
// unrounded p; m and l are the running max and sum of rows g and g + 8, o
// the unnormalized output, rescaled here.  l sums the unrounded f32 p; p
// comes out rounded to bf16 as the A fragments of the PV product (two
// neighbouring C tiles are one A slice).  exp is __expf (ex2.approx of
// x log2 e): a few ulp, far below the bf16 rounding of p and the output.
template <int kD, int kN>
__device__ __forceinline__ void softmax_step(float (&s)[kN][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&o)[kD / 8][4],
                                             uint32_t (&p)[kN / 2][4]) {
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    }
    mx = quad_max(mx);  // >= the -1e30 seed: finite
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      s[n][2 * i] = __expf(s[n][2 * i] - mx);
      s[n][2 * i + 1] = __expf(s[n][2 * i + 1] - mx);
      psum += s[n][2 * i] + s[n][2 * i + 1];
    }
    corr[i] = __expf(m[i] - mx);
    l[i] = l[i] * corr[i] + quad_sum(psum);
    m[i] = mx;
  }
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    o[n][0] *= corr[0];
    o[n][1] *= corr[0];
    o[n][2] *= corr[1];
    o[n][3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    p[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    p[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    p[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    p[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// ------------------------------------------------------------ wgmma
// Warpgroup products (4 warps, 64 rows): B, and A where it is not in
// registers, read from shared memory through a matrix descriptor.  The
// tiles use the no-swizzle layout of 8 x 16-byte core matrices, each 128
// contiguous bytes:
//   - K-major (k contiguous): core matrix (row group r / 8, k chunk c) at
//     (r / 8) * SBO + c * LBO, row r % 8 at + 16 (r % 8);
//   - MN-major (n contiguous, read with kTransB = 1): core matrix (n chunk
//     c, k group r / 8) at c * SBO + (r / 8) * LBO.
// The accumulator of m64nNk16 holds, in each warp w, rows 16 w + g and
// 16 w + g + 8 as N / 8 m16n8 C fragments in a row: the softmax above
// runs on it unchanged, and its p feeds the next product from registers.

// descriptor of a no-swizzle tile at p (16-byte aligned), byte strides
// lbo and sbo
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// shared-memory writes of the generic proxy (cp.async, st.shared) seen by
// the async proxy that wgmma reads through; each writer fences before
// the barrier that publishes its writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// keeps the compiler from moving reads or writes of accumulators across
// a wgmma wait or fence
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= a[64 x 16] b[16 x 64], both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t a_desc,
                                                   uint64_t b_desc,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// d[64 x 32] (+)= a[64 x 16] b[16 x 32], both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16],
                                                   uint64_t a_desc,
                                                   uint64_t b_desc,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// barrier `id` (1..15; 0 is __syncthreads) over the `threads` threads
// (a multiple of 32) that name it: one warpgroup's own barrier
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d[64 x 16] (+)= a[64 x 16] b[16 x 16]: a in registers (the warp's 16
// rows as an m16n8k16 A fragment), b from shared memory; kTransB = 1
// reads b MN-major (n contiguous)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b_desc,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(scale_d), "n"(kTransB));
}

// d[64 x 32] (+)= a[64 x 16] b[16 x 32]: a in registers (the warp's 16
// rows as an m16n8k16 A fragment), b from shared memory; kTransB = 1
// reads b MN-major (n contiguous)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b_desc,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(scale_d), "n"(kTransB));
}

// d[64 x 64] (+)= a[64 x 16] b[16 x 64]: a in registers (the warp's 16
// rows as an m16n8k16 A fragment), b from shared memory; kTransB = 1
// reads b MN-major (n contiguous)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b_desc,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(scale_d), "n"(kTransB));
}

// d[64 x 128] (+)= a[64 x 16] b[16 x 128]: a in registers (the warp's 16
// rows as an m16n8k16 A fragment), b from shared memory; kTransB = 1
// reads b MN-major (n contiguous)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b_desc,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(scale_d), "n"(kTransB));
}

// ------------------------------------------------- staged tiles, products
// What the wgmma attention kernels (K2f, K2q, K2kv in flash_attention.cu;
// K3q, K3kv in ring_flash.cu) share: bf16 rows of one head staged into
// core-matrix tiles, the descriptors of a staged tile as an operand over
// D or over its rows, and the products of the backward kernels.  Each
// bf16 score tile is recomputed from two products over D (S = A1 B1^T,
// dP = A2 B2^T, both operands K-major in shared memory); the gradient
// product's A is a packed score tile in registers (the C fragments of a
// product are the A fragments of the next) and its B a tile already
// staged for the score products, read MN-major: a K-major core-matrix
// tile over D is the MN-major B of a product over its rows, N = D; only
// the descriptor's strides change roles.

// byte offset of 16-byte piece c of row r in a K-major tile of kD columns
template <int kD>
__device__ __forceinline__ int kmajor_at(int r, int c) {
  return (r >> 3) * (kD / 8) * 128 + c * 128 + (r & 7) * 16;
}

// byte offset of 16-byte piece c (n chunk) of row r (k) in an MN-major
// tile of kRowsT rows
template <int kRowsT>
__device__ __forceinline__ int mnmajor_at(int r, int c) {
  return c * (kRowsT / 8) * 128 + (r >> 3) * 128 + (r & 7) * 16;
}

// kRowsT rows from row0 of one head into a core-matrix tile at dst, by
// kThr threads from thread tid: zero past S and past D.  The i-th thread
// writes the i-th 16 bytes of the tile, so a warp's copies land in
// contiguous shared memory.
template <int kD, int kRowsT, bool kMN, int kThr>
__device__ __forceinline__ void stage_cm(unsigned char* dst,
                                        const __nv_bfloat16* base,
                                        long long ss, int row0, int S, int D,
                                        bool vec, int tid) {
  constexpr int kPieces = kD / 8;
  for (int i = tid; i < kRowsT * kPieces; i += kThr) {
    int r, c;
    if (kMN) {
      r = i % kRowsT;
      c = i / kRowsT;
    } else {
      r = (i / (8 * kPieces)) * 8 + i % 8;
      c = (i / 8) % kPieces;
    }
    const int row = row0 + r;
    unsigned char* at = dst + (kMN ? mnmajor_at<kRowsT>(r, c)
                                 : kmajor_at<kD>(r, c));
    if (vec) {
      const bool live = row < S && c * 8 < D;
      mma_tiles::cp_async_16(at, live ? base + row * ss + c * 8 : base,
                             live ? 16 : 0);
    } else {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(at);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = c * 8 + k;
        e[k] = (row < S && d < D) ? base[row * ss + d] : __float2bfloat16(0.f);
      }
    }
  }
}

// o[64 x kD] += a[64 x 16] b[16 x kD], a in registers, b MN-major
template <int kD>
__device__ __forceinline__ void pv_wgmma(float (&o)[kD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (kD == 16) mma_tiles::wgmma_m64n16k16_rs<1>(o, a, desc, 1);
  if constexpr (kD == 32) mma_tiles::wgmma_m64n32k16_rs<1>(o, a, desc, 1);
  if constexpr (kD == 64) mma_tiles::wgmma_m64n64k16_rs<1>(o, a, desc, 1);
  if constexpr (kD == 128) mma_tiles::wgmma_m64n128k16_rs<1>(o, a, desc, 1);
}
// descriptor of k16 slice kk of rows row0 .. of a K-major tile of kD
// columns (row0 a multiple of 8): an operand of a product over D
template <int kD>
__device__ __forceinline__ uint64_t desc_over_d(const unsigned char* tile,
                                                int row0, int kk) {
  return mma_tiles::smem_desc(tile + (row0 / 8) * (kD / 8) * 128 + kk * 256,
                              128, (kD / 8) * 128);
}

// the same tile from row row0 as the MN-major B [16 rows x kD] of a
// product over its rows: LBO steps 8 rows, SBO 8 columns
template <int kD>
__device__ __forceinline__ uint64_t desc_over_rows(const unsigned char* tile,
                                                   int row0) {
  return mma_tiles::smem_desc(tile + (row0 / 8) * (kD / 8) * 128,
                              (kD / 8) * 128, 128);
}

// d (+)= a[64 x 16] b[16 x kC], both K-major in shared memory
template <int kC>
__device__ __forceinline__ void wgmma_ss(float (&d)[kC / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (kC == 32) mma_tiles::wgmma_m64n32k16_ss(d, a, b, scale_d);
  if constexpr (kC == 64) mma_tiles::wgmma_m64n64k16_ss(d, a, b, scale_d);
}

// s = A1 B1^T and dp = A2 B2^T for 64 rows of A and the kC rows of B from
// b_row, over kD; the warpgroup waits for both
template <int kD, int kC>
__device__ __forceinline__ void score_products(
    float (&s)[kC / 2], float (&dp)[kC / 2],
    const unsigned char* a1, const unsigned char* b1,
    const unsigned char* a2, const unsigned char* b2, int b_row) {
  mma_tiles::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wgmma_ss<kC>(s, desc_over_d<kD>(a1, 0, kk),
                 desc_over_d<kD>(b1, b_row, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wgmma_ss<kC>(dp, desc_over_d<kD>(a2, 0, kk),
                 desc_over_d<kD>(b2, b_row, kk), kk > 0);
  }
  mma_tiles::wgmma_commit();
  mma_tiles::wgmma_wait<0>();
  mma_tiles::fence_regs(s);
  mma_tiles::fence_regs(dp);
}

// a score tile's C fragments, rounded to bf16, as the A fragments of its
// k16 slices
template <int kC>
__device__ __forceinline__ void pack_a(uint32_t (&x)[kC / 16][4],
                                       const float (&c)[kC / 2]) {
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
    const float* lo = c + 8 * kk;
    x[kk][0] = mma_tiles::pack_bf16x2(lo[0], lo[1]);
    x[kk][1] = mma_tiles::pack_bf16x2(lo[2], lo[3]);
    x[kk][2] = mma_tiles::pack_bf16x2(lo[4], lo[5]);
    x[kk][3] = mma_tiles::pack_bf16x2(lo[6], lo[7]);
  }
}

// acc[64 x kD] += x[64 x kC] T[rows row0 .., kD]; the caller fences,
// commits and waits
template <int kD, int kC>
__device__ __forceinline__ void grad_product(float (&acc)[kD / 2],
                                             const uint32_t (&x)[kC / 16][4],
                                             const unsigned char* t,
                                             int row0) {
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
    pv_wgmma<kD>(acc, x[kk], desc_over_rows<kD>(t, row0 + 16 * kk));
  }
}

// whether 16-byte cp.async copies can stage the n_in bf16 inputs: D and
// every (batch, position, head) stride (3 a tensor, in `strides`) in
// whole 8-element pieces, and 16-byte aligned bases
inline bool vec_copies(int D, const void* const* in, int n_in,
                       const long long* strides) {
  bool vec = D % 8 == 0;
  for (int i = 0; i < 3 * n_in; ++i) vec = vec && strides[i] % 8 == 0;
  for (int i = 0; i < n_in; ++i) {
    vec = vec && reinterpret_cast<uintptr_t>(in[i]) % 16 == 0;
  }
  return vec;
}

// the D a tensor-core kernel is instantiated at: D zero-padded to 16, 32,
// 64 or 128
inline int padded_d(int D) {
  return D <= 16 ? 16 : (D <= 32 ? 32 : (D <= 64 ? 64 : 128));
}

}  // namespace mma_tiles
