// Flash attention forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of tf_operator_tpu/ops/flash_attention.py
// (`flash_attention` through the `_flash` custom VJP):
//   - K2f  `_fwd_kernel`: out = softmax(Q K^T * scale) V with online softmax,
//          plus the row logsumexp (lse) the backward pass recomputes from;
//   - K2q  `_dq_kernel`:  dQ = scale * sum_t dS K, P recomputed from lse,
//          dS = P * (dO V^T - delta);
//   - K2kv `_dkv_kernel`: dV = sum P^T dO, dK = scale * sum dS^T Q, each kv
//          tile of each kv head owned by one block that streams every
//          (query head of its GQA group x q tile).
//
// Numerics kept from the TPU kernels:
//   - scores s = (q . k) in f32, then * scale (scale = 1/sqrt(D) after the dot);
//   - masked scores are NEG_INF = -1e30 (causal q >= k, window band
//     k > q - W); their probabilities are exactly 0 (the TPU kernel reaches
//     the same 0 through exp(-1e30 - m) or a correction factor of 0);
//   - forward: l sums the unrounded f32 p; p is rounded to V's type only
//     for the PV product; out = acc / l with l == 0 -> 1; lse = m + log(l);
//   - backward: p = exp(s - lse); dS = p * (dp - delta) rounded to the
//     input type before dQ += scale * (dS K) and dK += scale * (dS^T Q);
//     dV += round(p)^T dO; per-tile products are added to f32 accumulators
//     and the gradients are returned in the input type;
//   - tiles that cannot hold a live pair are skipped (`_tile_live`).
//
// Layout: q [B, S, H, D] and k/v [B, S, KV, D] are read straight from their
// strides (unit stride on D), head h reading kv head h / (H / KV): neither
// the [B*H, S, D] transpose nor the repeated kv is materialized.  Outputs
// are contiguous: out/dq [B, S, H, D], dk/dv [B, S, KV, D], lse [B, H, S].
// Any S works: rows and columns past S are masked (the TPU wrapper needs a
// 128-aligned tiling of S and otherwise falls back to an einsum path).
//
// The scalar design (f32 inputs): one block of 256 threads per
// (64-row tile, head, batch); each tile of Q, K, V, dO is staged in shared
// memory as f32 (row stride D + 1, so the column reads of the score
// products hit distinct banks).  Thread (ty, tx) of the 16 x 16 grid owns
// score rows ty + 16 i and columns tx + 16 j (i, j < 4) of each 64 x 64
// score tile, and output rows ty + 16 i, columns tx + 16 j (j < D / 16) of
// the 64 x D accumulators.  Row statistics (max, sum) are reduced across
// the 16 threads of a row with warp shuffles; every lane of a row gets the
// same bits, so the kernel is deterministic: no atomics, no cross-block
// sums.  The TPU grid's sequential (streamed) axis becomes a loop inside
// the block.
//
// What bounds it on this card: at the training shapes (S = 2048, D = 128,
// causal) the work is S^2 D products per head, far above the bytes, so it
// is bound by operations: 989 TFLOP/s in the tensor cores.  The scalar
// kernels do their products as f32 FMAs (67 TFLOP/s peak) out of shared
// memory, with no overlap of the tile loads and compute; bf16 inputs take
// the tensor-core kernels below.  The numbers are in PERF.md.
//
// K2f on bf16 inputs takes the tensor-core design
// (flash_fwd_wgmma_kernel, helpers in mma_tiles.cuh):
//   - a block of 4 warpgroups (512 threads) per (64-row q tile, kv head,
//     batch) when G = 4: each warpgroup owns 64 rows of one query head of
//     the kv head's group, so every K and V tile is staged once for 256
//     rows (other G take consecutive (q tile, head) units).  Blocks start
//     heaviest first across all kv heads, so the causal tail is short;
//   - Q, and K and V tiles of 64 rows, are staged as bf16 by 16-byte
//     cp.async copies in the no-swizzle core-matrix layouts wgmma reads
//     (Q, K K-major; V MN-major, read transposed); K/V sit in a 3-stage
//     ring, tile t + 1 in flight while tile t is used, one barrier a tile;
//   - S = Q K^T by wgmma.m64n64k16 (both operands in shared memory),
//     O += P V by wgmma.m64n{D}k16 with p in registers (bf16 in, f32
//     accumulators).  wgmma rather than mma.sync: an mma.sync version of
//     this kernel ran at about the same time whatever its tile shape,
//     bound by its tile loads and barriers; wgmma needs no ldmatrix and
//     128 registers a thread, so 16 warps share an SM and a tile serves
//     four heads;
//   - the online softmax runs on the S accumulators (each warp's 16 rows
//     are m16n8 C fragments): row max and sum over the 4 lanes of a row by
//     shuffles in a fixed order, no atomics, so repeats are bit-identical;
//     p is rounded to bf16 in registers as the PV operand;
//   - visibility is tested per element only on tiles that straddle the
//     diagonal, the window's edge or S; interior tiles skip it.  A masked
//     score is -inf, so its p is exactly 0 while m is still the -1e30
//     seed.  Any D up to 128 is zero-padded to 16, 32, 64 or 128.
// K2q and K2kv on bf16 inputs take wgmma designs of their own
// (flash_dq_wgmma_kernel, flash_dkv_wgmma_kernel):
//   - both recompute p = exp(S scale - lse) and dS = p (dP - delta) in
//     registers from two products over D, S and dP, 32 columns at a time
//     in K2q and 64 in K2kv (wgmma.m64n{32,64}k16, both operands in
//     shared memory), and add the gradient product with the rounded p or
//     dS as the A operand in registers;
//   - the gradient products read a tile already staged for the score
//     products: a K-major core-matrix tile over D is, with its
//     descriptor's strides swapped, the MN-major B of a product over its
//     rows.  So K serves S = Q K^T and dQ += dS K, and Q and dO serve
//     S^T = K Q^T, dP^T = V dO^T, dV += p^T dO and dK += dS^T Q, each
//     from one copy, and nothing is transposed through shared memory;
//   - K2q is K2f's block: 4 warpgroups of 64 q rows of the heads of one
//     GQA group, K and V tiles staged once for all in a 3-stage ring,
//     heaviest blocks first; dQ, S and dP fit 128 registers a thread;
//   - K2kv makes the kv rows the M dimension: a block of 2 warpgroups per
//     (64-row kv tile, kv head) keeps K and V in shared memory, deals the
//     units (query head of the group, live q tile) to its warpgroups in
//     turn, each streaming its Q, dO, lse and delta through its own
//     2-stage ring under its own named barrier, and sums the two
//     warpgroups' dK and dV partials through shared memory in a fixed
//     order at the end.  dK and dV take 128 registers a thread (245 in
//     all), so one block of 8 warps an SM; the first kv tiles, the
//     heaviest under a causal mask, start first;
//   - no atomics in either: repeats are bit-identical.
// f32 inputs keep the scalar kernels: the tensor cores would round them
// to TF32, and the f32 parity checks hold the training step to full f32.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC
// and called through ctypes (tf_operator_tpu_torch/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tiles.cuh"

namespace {

using mma_tiles::desc_over_rows;
using mma_tiles::grad_product;
using mma_tiles::pack_a;
using mma_tiles::pv_wgmma;
using mma_tiles::score_products;
using mma_tiles::stage_cm;

constexpr int kTile = 64;               // q rows and kv rows per tile
constexpr int kTx = 16;                 // threads per score row
constexpr int kThreads = kTx * kTx;     // 256
constexpr int kRows = kTile / kTx;      // score rows (and cols) per thread
constexpr int kMaxD = 128;
constexpr int kDCols = kMaxD / kTx;     // accumulator columns per thread
constexpr int kLdP = kTile + 1;         // row stride of the p / dS tiles
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T and back: p and dS enter their products in the input type
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, S]
  const float* delta;  // [B, H, S]
  void* out;           // [B, S, H, D]
  float* lse_out;      // [B, H, S]
  void* dq;            // [B, S, H, D]
  void* dk;            // [B, S, KV, D]
  void* dv;            // [B, S, KV, D]
  // element strides (batch, position, head) of q, k, v and dout
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int S, H, KV, D, G;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ float warp_max16(float x) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum16(float x) {
#pragma unroll
  for (int off = kTx / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Whether query qi may attend key ki (both global positions).
__device__ __forceinline__ bool visible(int qi, int ki, const Args& a) {
  if (qi >= a.S || ki >= a.S) return false;
  if (a.causal) {
    if (ki > qi) return false;
    if (a.window > 0 && ki <= qi - a.window) return false;
  }
  return true;
}

// `_tile_live`: can the q tile at q0 and the kv tile at k0 hold any live
// pair?  Uniform across the block, so a skipped tile skips its barriers.
__device__ __forceinline__ bool tile_live(int q0, int k0, const Args& a) {
  bool live = a.causal ? (k0 <= q0 + kTile - 1) : true;
  if (a.window > 0) live = live && (k0 + kTile - 1 > q0 - a.window);
  return live;
}

// Stage rows row0 .. row0 + kTile - 1 of head h of a [B, S, Hx, D] tensor
// into dst [kTile][D + 1] as f32; rows past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          long long sb, long long ss,
                                          long long sh, int b, int h,
                                          int row0, const Args& a) {
  const T* p = static_cast<const T*>(src) + b * sb + h * sh;
  const int D = a.D, ld = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = row0 + r;
    dst[r * ld + d] = row < a.S ? to_f32(p[row * ss + d]) : 0.f;
  }
}

// Rows row0 .. of a [B, H, S] f32 statistic into dst [kTile]; 0 past S.
__device__ __forceinline__ void load_stat(float* dst, const float* src,
                                          int b, int h, int row0,
                                          const Args& a) {
  if (threadIdx.x < kTile) {
    const int row = row0 + threadIdx.x;
    dst[threadIdx.x] =
        row < a.S ? src[(static_cast<long long>(b) * a.H + h) * a.S + row]
                  : 0.f;
  }
}

// ---------------------------------------------------------------- K2f
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* qs = smem;              // [kTile][ld]
  float* ks = qs + kTile * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;   // [kTile][ld]
  float* ps = vs + kTile * ld;   // [kTile][kLdP] p rounded to V's type

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  load_tile<T>(qs, a.q, a.q_b, a.q_s, a.q_h, b, h, q0, a);

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = (a.S + kTile - 1) / kTile;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kTile;
    if (!tile_live(q0, k0, a)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T>(ks, a.k, a.k_b, a.k_s, a.k_h, b, hk, k0, a);
    load_tile<T>(vs, a.v, a.v_b, a.v_s, a.v_h, b, hk, k0, a);
    __syncthreads();

    float s[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float qa[kRows], kb[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = qs[(ty + kTx * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kRows; ++j) kb[j] = ks[(tx + kTx * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }

    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTx * i, qi = q0 + r;
      bool vis[kRows];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        vis[j] = visible(qi, k0 + tx + kTx * j, a);
        s[i][j] = vis[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max16(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        ps[r * kLdP + tx + kTx * j] = round_to<T>(p);
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum16(psum);
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* pr = ps + (ty + kTx * i) * kLdP;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) {
        const int d = tx + kTx * j;
        if (d < D) {
          float pv = 0.f;
          for (int c = 0; c < kTile; ++c) pv = fmaf(pr[c], vs[c * ld + d], pv);
          acc[i][j] = acc[i][j] * corr[i] + pv;
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTx * i;
    if (row >= a.S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const long long base = ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int d = tx + kTx * j;
      if (d < D) out[base + d] = from_f32<T>(acc[i][j] / l_safe);
    }
    if (tx == 0) {
      a.lse_out[(static_cast<long long>(b) * a.H + h) * a.S + row] =
          m[i] + logf(l_safe);
    }
  }
}

// ------------------------------------------------ K2f, warpgroup products
// A block holds kWgGroups warpgroups; each owns one unit of 64 q rows of
// one query head.  The units of a kv head's group are numbered
// u = (q tile) * G + (head in group), and a block takes kWgGroups
// consecutive units: with G = 4 that is the four query heads of one q
// tile, which read the same K and V tiles, so each tile is staged once
// for 256 rows.  Q and K sit K-major, V MN-major, in the no-swizzle
// core-matrix layout (mma_tiles.cuh); S = Q K^T is wgmma m64n64k16 with
// both operands in shared memory, O += P V is wgmma m64n{D}k16 with p in
// registers.  512 threads at up to 128 registers keep 16 warps on an SM.
constexpr int kWgGroups = 4;
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgKeys = 64;  // kv rows per tile
// K/V tiles in the ring: tile t + 1 loads while tile t is used, and the
// buffer a load refills was read two tiles before, behind a barrier that
// every thread has passed since: one barrier a tile
constexpr int kWgStages = 3;

// Whether any (query, key) pair of q rows q0 .. q_hi and the kv tile at k0
// is visible (tile_live for a q span other than kTile rows and kv tiles of
// kWgKeys).
__device__ __forceinline__ bool span_live(int q0, int q_hi, int k0,
                                          const Args& a) {
  if (a.causal && k0 > q_hi) return false;
  return a.window <= 0 || k0 + kWgKeys - 1 > q0 - a.window;
}

// Whether every pair of q rows q0 .. q_hi and the kv tile at k0 is
// visible, so the per-element test can be skipped.
__device__ __forceinline__ bool span_full(int q0, int q_hi, int k0,
                                          const Args& a) {
  if (k0 + kWgKeys > a.S) return false;
  if (!a.causal) return true;
  if (k0 + kWgKeys - 1 > q0) return false;
  return a.window <= 0 || k0 > q_hi - a.window;
}

template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(Args a, int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int kTileBytes = kWgKeys * kD * 2;
  constexpr int kQBytes = 64 * kD * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qs = smem_raw;                  // [kWgGroups][64 x kD]
  unsigned char* ks = qs + kWgGroups * kQBytes;  // [kWgStages][kWgKeys x kD]
  unsigned char* vs = ks + kWgStages * kTileBytes;  // the same, MN-major

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int n_qt = (a.S + 63) / 64;
  const int n_units = n_qt * a.G;
  // blockIdx.x runs over (unit block, kv head), kv head fastest, unit
  // blocks from the last (the heaviest under a causal mask): the first
  // blocks to start are the longest, across every kv head
  const int hk = blockIdx.x % a.KV, b = blockIdx.z;
  const int u0 = (gridDim.x / a.KV - 1 - blockIdx.x / a.KV) * kWgGroups;
  const int u = u0 + wg;
  const bool unit_live = u < n_units;
  const int w0 = (u / a.G) * 64;  // the warpgroup's rows w0 .. w0 + 63
  const int h = hk * a.G + u % a.G;
  // the block's rows span the q tiles of its first and last live unit
  const int q0 = (u0 / a.G) * 64;
  const int q_hi = (min(u0 + kWgGroups, n_units) - 1) / a.G * 64 + 63;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;

  // the kv tiles any unit of the block sees form one run t_lo .. t_hi
  const int n_kv = (a.S + kWgKeys - 1) / kWgKeys;
  const int t_hi = a.causal ? min(n_kv - 1, q_hi / kWgKeys) : n_kv - 1;
  int t_lo = 0;
  while (t_lo <= t_hi && !span_live(q0, q_hi, t_lo * kWgKeys, a)) ++t_lo;

  if (unit_live) {
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
    stage_cm<kD, 64, false, 128>(qs + wg * kQBytes, qb, a.q_s, w0, a.S, a.D,
                                 vec, threadIdx.x % 128);
  }
  if (t_lo <= t_hi) {
    stage_cm<kD, kWgKeys, false, kWgThreads>(ks, kb, a.k_s, t_lo * kWgKeys,
                                             a.S, a.D, vec, threadIdx.x);
    stage_cm<kD, kWgKeys, true, kWgThreads>(vs, vb, a.v_s, t_lo * kWgKeys,
                                            a.S, a.D, vec, threadIdx.x);
  }
  mma_tiles::cp_async_commit();

  // descriptor strides: K-major rows of kD / 8 core matrices, MN-major
  // columns of kWgKeys / 8
  constexpr uint32_t kSboK = (kD / 8) * 128, kSboV = (kWgKeys / 8) * 128;
  const int r_a = w0 + warp * 16 + g, r_b = r_a + 8;
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float(&o_flat)[kD / 2] = reinterpret_cast<float(&)[kD / 2]>(o);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) % kWgStages;
    if (t < t_hi) {
      const int nx = (t + 1 - t_lo) % kWgStages;
      stage_cm<kD, kWgKeys, false, kWgThreads>(
          ks + nx * kTileBytes, kb, a.k_s, (t + 1) * kWgKeys, a.S, a.D, vec,
          threadIdx.x);
      stage_cm<kD, kWgKeys, true, kWgThreads>(
          vs + nx * kTileBytes, vb, a.v_s, (t + 1) * kWgKeys, a.S, a.D, vec,
          threadIdx.x);
    }
    mma_tiles::cp_async_commit();
    mma_tiles::cp_async_wait<1>();  // all but tile t + 1 have landed
    mma_tiles::fence_proxy_async();
    __syncthreads();

    // a warpgroup none of whose rows sees the tile leaves m, l and o as
    // they are; it only keeps the block's barriers
    const int k0 = t * kWgKeys;
    if (unit_live && span_live(w0, w0 + 63, k0, a)) {
      float s[kWgKeys / 8][4];
      float(&s_flat)[kWgKeys / 2] = reinterpret_cast<float(&)[kWgKeys / 2]>(s);
      mma_tiles::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        mma_tiles::wgmma_m64n64k16_ss(
            s_flat,
            mma_tiles::smem_desc(qs + wg * kQBytes + kk * 256, 128, kSboK),
            mma_tiles::smem_desc(ks + st * kTileBytes + kk * 256, 128, kSboK),
            kk > 0);
      }
      mma_tiles::wgmma_commit();
      mma_tiles::wgmma_wait<0>();
      mma_tiles::fence_regs(s_flat);

      const bool full = span_full(w0 + warp * 16, w0 + warp * 16 + 15, k0, a);
#pragma unroll
      for (int n = 0; n < kWgKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = e < 2 ? r_a : r_b;
          const int ki = k0 + n * 8 + 2 * tq + (e & 1);
          s[n][e] = (full || visible(qi, ki, a)) ? s[n][e] * a.scale
                                                  : -INFINITY;
        }
      }
      uint32_t p[kWgKeys / 16][4];
      mma_tiles::softmax_step<kD, kWgKeys / 8>(s, m, l, o, p);
      mma_tiles::fence_regs(o_flat);
      mma_tiles::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        pv_wgmma<kD>(o_flat, p[kk],
                     mma_tiles::smem_desc(vs + st * kTileBytes + kk * 256,
                                          128, kSboV));
      }
      mma_tiles::wgmma_commit();
      mma_tiles::wgmma_wait<0>();
      mma_tiles::fence_regs(o_flat);
    }
  }

  if (!unit_live) return;
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? r_a : r_b;
    if (row >= a.S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * tq + e;
        if (d < a.D) out[base + d] = __float2bfloat16(o[n][2 * i + e] / l_safe);
      }
    }
    if (tq == 0) {
      a.lse_out[(static_cast<long long>(b) * a.H + h) * a.S + row] =
          m[i] + logf(l_safe);
    }
  }
}

size_t wgmma_smem_bytes(int Dp) {
  return 2 * static_cast<size_t>(Dp) *
         (64 * kWgGroups + 2 * kWgStages * kWgKeys);
}

// Scores and dO . V^T of one (q tile, kv tile) pair, for the thread's
// kRows x kRows entries: s unscaled, dp as is.
__device__ __forceinline__ void score_and_dp(const float* qs, const float* dos,
                                             const float* ks, const float* vs,
                                             int ld, int D, int ty, int tx,
                                             float (&s)[kRows][kRows],
                                             float (&dp)[kRows][kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  }
  for (int d = 0; d < D; ++d) {
    float qa[kRows], oa[kRows], kb[kRows], vb[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      qa[i] = qs[(ty + kTx * i) * ld + d];
      oa[i] = dos[(ty + kTx * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      kb[j] = ks[(tx + kTx * j) * ld + d];
      vb[j] = vs[(tx + kTx * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------- K2q
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* qs = smem;                 // [kTile][ld]
  float* dos = qs + kTile * ld;     // [kTile][ld]
  float* ks = dos + kTile * ld;     // [kTile][ld]
  float* vs = ks + kTile * ld;      // [kTile][ld]
  float* dss = vs + kTile * ld;     // [kTile][kLdP] dS rounded to K's type
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  load_tile<T>(qs, a.q, a.q_b, a.q_s, a.q_h, b, h, q0, a);
  load_tile<T>(dos, a.dout, a.o_b, a.o_s, a.o_h, b, h, q0, a);
  load_stat(lse_s, a.lse, b, h, q0, a);
  load_stat(delta_s, a.delta, b, h, q0, a);

  float acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = (a.S + kTile - 1) / kTile;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kTile;
    if (!tile_live(q0, k0, a)) continue;
    __syncthreads();
    load_tile<T>(ks, a.k, a.k_b, a.k_s, a.k_h, b, hk, k0, a);
    load_tile<T>(vs, a.v, a.v_b, a.v_s, a.v_h, b, hk, k0, a);
    __syncthreads();

    float s[kRows][kRows], dp[kRows][kRows];
    score_and_dp(qs, dos, ks, vs, ld, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTx * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kTx * j;
        const float p = visible(q0 + r, k0 + c, a)
                            ? expf(s[i][j] * a.scale - lse_s[r])
                            : 0.f;
        dss[r * kLdP + c] = round_to<T>(p * (dp[i][j] - delta_s[r]));
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* dr = dss + (ty + kTx * i) * kLdP;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) {
        const int d = tx + kTx * j;
        if (d < D) {
          float x = 0.f;
          for (int c = 0; c < kTile; ++c) x = fmaf(dr[c], ks[c * ld + d], x);
          acc[i][j] += a.scale * x;
        }
      }
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTx * i;
    if (row >= a.S) continue;
    const long long base = ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int d = tx + kTx * j;
      if (d < D) dq[base + d] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- K2kv
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* ks = smem;                 // [kTile][ld]
  float* vs = ks + kTile * ld;      // [kTile][ld]
  float* qs = vs + kTile * ld;      // [kTile][ld]
  float* dos = qs + kTile * ld;     // [kTile][ld]
  float* ps = dos + kTile * ld;     // [kTile q][kLdP] p rounded to dO's type
  float* dss = ps + kTile * kLdP;   // [kTile q][kLdP] dS rounded to Q's type
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  load_tile<T>(ks, a.k, a.k_b, a.k_s, a.k_h, b, hk, k0, a);
  load_tile<T>(vs, a.v, a.v_b, a.v_s, a.v_h, b, hk, k0, a);

  // the thread's kv rows are ty + 16 i, its columns tx + 16 j
  float dk[kRows][kDCols], dv[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }
  }

  const int n_q = (a.S + kTile - 1) / kTile;
  for (int g = 0; g < a.G; ++g) {
    const int h = hk * a.G + g;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_live(q0, k0, a)) continue;
      __syncthreads();
      load_tile<T>(qs, a.q, a.q_b, a.q_s, a.q_h, b, h, q0, a);
      load_tile<T>(dos, a.dout, a.o_b, a.o_s, a.o_h, b, h, q0, a);
      load_stat(lse_s, a.lse, b, h, q0, a);
      load_stat(delta_s, a.delta, b, h, q0, a);
      __syncthreads();

      // entries (q row ty + 16 i, kv row tx + 16 j)
      float s[kRows][kRows], dp[kRows][kRows];
      score_and_dp(qs, dos, ks, vs, ld, D, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty + kTx * i;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int c = tx + kTx * j;
          const float p = visible(q0 + r, k0 + c, a)
                              ? expf(s[i][j] * a.scale - lse_s[r])
                              : 0.f;
          ps[r * kLdP + c] = round_to<T>(p);
          dss[r * kLdP + c] = round_to<T>(p * (dp[i][j] - delta_s[r]));
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int c = ty + kTx * i;
#pragma unroll
        for (int j = 0; j < kDCols; ++j) {
          const int d = tx + kTx * j;
          if (d < D) {
            float xv = 0.f, xk = 0.f;
            for (int r = 0; r < kTile; ++r) {
              xv = fmaf(ps[r * kLdP + c], dos[r * ld + d], xv);
              xk = fmaf(dss[r * kLdP + c], qs[r * ld + d], xk);
            }
            dv[i][j] += xv;
            dk[i][j] += a.scale * xk;
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty + kTx * i;
    if (row >= a.S) continue;
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * a.KV + hk) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int d = tx + kTx * j;
      if (d < D) {
        dk_out[base + d] = from_f32<T>(dk[i][j]);
        dv_out[base + d] = from_f32<T>(dv[i][j]);
      }
    }
  }
}

// ------------------------------------------ K2q and K2kv, warpgroup products
// bf16 inputs.  Both kernels recompute p from lse and form dS in registers
// from two score products over D (S = A1 B1^T and dP = A2 B2^T, wgmma
// m64nCk16 with both operands K-major in shared memory), then add a
// gradient product whose A operand is the packed p or dS (the C fragments
// of a score product are the A fragments of the next one) and whose B
// operand is a tile already staged for the score products, read MN-major:
// a K-major core-matrix tile over D is the MN-major B of a product over
// its rows, N = D; only the descriptor's strides change roles.  Score
// products take kC columns at a time (kDqCols, kDkvCols), so a thread's
// accumulators fit its registers beside the gradient's.

// Whether any pair of q rows q_lo .. q_hi and keys k_lo .. k_hi is
// visible (rows and keys past S are dead), and whether every pair is, so
// the per-element test can be skipped.  Unlike the forward, a q row past
// S would feed dK and dV, so `full` needs it inside S.
__device__ __forceinline__ bool pairs_live(int q_lo, int q_hi, int k_lo,
                                           int k_hi, const Args& a) {
  if (q_lo >= a.S || k_lo >= a.S) return false;
  if (!a.causal) return true;
  if (k_lo > q_hi) return false;
  return a.window <= 0 || k_hi > q_lo - a.window;
}

__device__ __forceinline__ bool pairs_full(int q_lo, int q_hi, int k_lo,
                                           int k_hi, const Args& a) {
  if (q_hi >= a.S || k_hi >= a.S) return false;
  if (!a.causal) return true;
  if (k_hi > q_lo) return false;
  return a.window <= 0 || k_lo > q_hi - a.window;
}

// rows r_a and r_b = r_a + 8 of a warpgroup's [64 x kD] accumulator,
// times mul, into head h of a contiguous [B, S, heads, D] bf16 tensor
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[kD / 2],
                                           float mul, int r_a, int b, int h,
                                           int heads, int tq, const Args& a) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_a + 8 * i;
    if (row >= a.S) continue;
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * heads + h) * a.D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * tq + e;
        if (d < a.D) out[base + d] = __float2bfloat16(mul * acc[4 * n + 2 * i + e]);
      }
    }
  }
}

// K2q: as K2f's block, kDqGroups warpgroups of 64 q rows of one query
// head each (consecutive units of the kv head's group), K and V tiles of
// 64 keys staged once for the block in a kWgStages ring, one barrier a
// tile.  Per warpgroup, kDqCols keys at a time: S = Q K^T and
// dP = dO V^T, p = exp(S scale - lse), dS = p (dP - delta) rounded to
// bf16, and dQ += dS K with K read MN-major.  Registers: dQ (kD / 2), S
// and dP (16 each) a thread, so 4 warpgroups fit 128 registers (64 keys
// at 2 or 3 warpgroups a block ran no faster on the H100).
constexpr int kDqGroups = 4;
constexpr int kDqThreads = 128 * kDqGroups;
constexpr int kDqCols = 32;

template <int kD>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_dq_wgmma_kernel(Args a, int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int kTileBytes = 64 * kD * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qs = smem_raw;                      // [kDqGroups][64 x kD]
  unsigned char* dos = qs + kDqGroups * kTileBytes;  // the same, dO
  unsigned char* ks = dos + kDqGroups * kTileBytes;  // [kWgStages][64 x kD]
  unsigned char* vs = ks + kWgStages * kTileBytes;   // the same, V

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int n_units = ((a.S + 63) / 64) * a.G;
  // blockIdx.x runs over (unit block, kv head), kv head fastest, unit
  // blocks from the last: the heaviest start first, as in K2f
  const int hk = blockIdx.x % a.KV, b = blockIdx.z;
  const int u0 = (gridDim.x / a.KV - 1 - blockIdx.x / a.KV) * kDqGroups;
  const int u = u0 + wg;
  const bool unit_live = u < n_units;
  const int w0 = (u / a.G) * 64;
  const int h = hk * a.G + u % a.G;
  const int q0 = (u0 / a.G) * 64;
  const int q_hi = (min(u0 + kDqGroups, n_units) - 1) / a.G * 64 + 63;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;

  const int n_kv = (a.S + 63) / 64;
  const int t_hi = a.causal ? min(n_kv - 1, q_hi / 64) : n_kv - 1;
  int t_lo = 0;
  while (t_lo <= t_hi && !pairs_live(q0, q_hi, 64 * t_lo, 64 * t_lo + 63, a))
    ++t_lo;

  const int r_a = w0 + warp * 16 + g;
  float lse[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  if (unit_live) {
    const int tid = threadIdx.x % 128;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
    const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.o_b + h * a.o_h;
    stage_cm<kD, 64, false, 128>(qs + wg * kTileBytes, qb, a.q_s, w0, a.S,
                                 a.D, vec, tid);
    stage_cm<kD, 64, false, 128>(dos + wg * kTileBytes, ob, a.o_s, w0, a.S,
                                 a.D, vec, tid);
    const long long st = (static_cast<long long>(b) * a.H + h) * a.S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (r_a + 8 * i < a.S) {
        lse[i] = a.lse[st + r_a + 8 * i];
        dlt[i] = a.delta[st + r_a + 8 * i];
      }
    }
  }
  if (t_lo <= t_hi) {
    stage_cm<kD, 64, false, kDqThreads>(ks, kb, a.k_s, 64 * t_lo, a.S, a.D,
                                        vec, threadIdx.x);
    stage_cm<kD, 64, false, kDqThreads>(vs, vb, a.v_s, 64 * t_lo, a.S, a.D,
                                        vec, threadIdx.x);
  }
  mma_tiles::cp_async_commit();

  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) % kWgStages;
    if (t < t_hi) {
      const int nx = (t + 1 - t_lo) % kWgStages;
      stage_cm<kD, 64, false, kDqThreads>(ks + nx * kTileBytes, kb, a.k_s,
                                          64 * (t + 1), a.S, a.D, vec,
                                          threadIdx.x);
      stage_cm<kD, 64, false, kDqThreads>(vs + nx * kTileBytes, vb, a.v_s,
                                          64 * (t + 1), a.S, a.D, vec,
                                          threadIdx.x);
    }
    mma_tiles::cp_async_commit();
    mma_tiles::cp_async_wait<1>();  // all but tile t + 1 have landed
    mma_tiles::fence_proxy_async();
    __syncthreads();
    if (!unit_live) continue;  // keeps the block's barriers only

    const unsigned char* kt = ks + st * kTileBytes;
    const unsigned char* vt = vs + st * kTileBytes;
#pragma unroll 1
    for (int half = 0; half < 64 / kDqCols; ++half) {
      const int kh = 64 * t + kDqCols * half;
      if (!pairs_live(w0, w0 + 63, kh, kh + kDqCols - 1, a)) continue;
      float s[kDqCols / 2], dp[kDqCols / 2];
      score_products<kD, kDqCols>(s, dp, qs + wg * kTileBytes, kt,
                                  dos + wg * kTileBytes, vt, kDqCols * half);
      const bool full = pairs_full(w0 + warp * 16, w0 + warp * 16 + 15, kh,
                                   kh + kDqCols - 1, a);
#pragma unroll
      for (int j = 0; j < kDqCols / 2; ++j) {
        const int i = (j >> 1) & 1;
        const int ki = kh + (j >> 2) * 8 + 2 * tq + (j & 1);
        const float p = (full || visible(r_a + 8 * i, ki, a))
                            ? __expf(s[j] * a.scale - lse[i])
                            : 0.f;
        s[j] = p * (dp[j] - dlt[i]);
      }
      uint32_t x[kDqCols / 16][4];
      pack_a<kDqCols>(x, s);
      mma_tiles::fence_regs(dq);
      mma_tiles::wgmma_fence();
      grad_product<kD, kDqCols>(dq, x, kt, kDqCols * half);
      mma_tiles::wgmma_commit();
      mma_tiles::wgmma_wait<0>();
      mma_tiles::fence_regs(dq);
    }
  }
  mma_tiles::cp_async_wait<0>();
  if (unit_live) {
    store_rows<kD>(static_cast<bf16*>(a.dq), dq, a.scale, r_a, b, h, a.H, tq,
                   a);
  }
}

// K2kv: a block of kDkvGroups warpgroups per (64-row kv tile, kv head),
// kv rows the M dimension, so nothing is transposed through shared
// memory.  K and V stay in shared memory; the units (query head of the
// group, live q tile) are dealt to the warpgroups in turn, each streaming
// its own Q, dO, lse and delta through a kDkvStages ring under its own
// barrier.  Per unit, kDkvCols q rows at a time: S^T = K Q^T and
// dP^T = V dO^T, p^T = exp(S^T scale - lse[col]), dS^T = p^T (dP^T -
// delta[col]), then dV += round(p^T) dO and dK += dS^T Q with dO and Q
// read MN-major.  At the end each warpgroup hands the other its partial
// of the gradient the other writes, summed in a fixed order: no atomics.
// Registers: dK and dV (kD / 2 each), S and dP (kDkvCols / 2 each; 64
// columns ran about 4 % faster on the H100 than 32), so 2 warpgroups a
// block, one block an SM; blocks start from the first kv tile, the
// heaviest under a causal mask.
constexpr int kDkvGroups = 2;
constexpr int kDkvThreads = 128 * kDkvGroups;
constexpr int kDkvStages = 2;
constexpr int kDkvCols = 64;

// bytes of one stage of a warpgroup's ring: Q, dO, lse, delta
__host__ __device__ constexpr int dkv_stage_bytes(int d) {
  return 2 * 64 * d * 2 + 2 * 64 * 4;
}

template <int kD>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_dkv_wgmma_kernel(Args a, int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int kTileBytes = 64 * kD * 2;
  constexpr int kStageBytes = dkv_stage_bytes(kD);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ks = smem_raw;          // [64 x kD]
  unsigned char* vs = ks + kTileBytes;   // [64 x kD]
  unsigned char* rings = vs + kTileBytes;  // [kDkvGroups][kDkvStages]

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int tid = threadIdx.x % 128;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int hk = blockIdx.x % a.KV, b = blockIdx.z;
  const int k0 = (blockIdx.x / a.KV) * 64;
  unsigned char* ring = rings + wg * kDkvStages * kStageBytes;

  // the live q tiles of this kv tile form one run qt_lo .. qt_hi
  const int n_q = (a.S + 63) / 64;
  int qt_lo = a.causal ? k0 / 64 : 0, qt_hi = n_q - 1;
  while (qt_hi >= qt_lo && !pairs_live(64 * qt_hi, 64 * qt_hi + 63, k0,
                                       k0 + 63, a))
    --qt_hi;
  while (qt_lo <= qt_hi && !pairs_live(64 * qt_lo, 64 * qt_lo + 63, k0,
                                       k0 + 63, a))
    ++qt_lo;
  const int n_live = qt_hi - qt_lo + 1;  // >= 1: key k0 sees query k0
  // unit u = (head in group) * n_live + (q tile - qt_lo); this warpgroup
  // takes u = wg, wg + kDkvGroups, ...
  const int n_my = (a.G * n_live - wg + kDkvGroups - 1) / kDkvGroups;

  auto stage_unit = [&](int i, int buf) {
    const int u = wg + kDkvGroups * i;
    const int h = hk * a.G + u / n_live;
    const int q0 = 64 * (qt_lo + u % n_live);
    unsigned char* dst = ring + buf * kStageBytes;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
    const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.o_b + h * a.o_h;
    stage_cm<kD, 64, false, 128>(dst, qb, a.q_s, q0, a.S, a.D, vec, tid);
    stage_cm<kD, 64, false, 128>(dst + kTileBytes, ob, a.o_s, q0, a.S, a.D,
                                 vec, tid);
    // lse by threads 0-63, delta by 64-127; 0 past S
    const int row = q0 + tid % 64;
    const float* src = (tid < 64 ? a.lse : a.delta) +
                       (static_cast<long long>(b) * a.H + h) * a.S;
    float* stat = reinterpret_cast<float*>(dst + 2 * kTileBytes) + tid;
    mma_tiles::cp_async_4(stat, row < a.S ? src + row : src,
                          row < a.S ? 4 : 0);
  };

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;
  stage_cm<kD, 64, false, kDkvThreads>(ks, kb, a.k_s, k0, a.S, a.D, vec,
                                       threadIdx.x);
  stage_cm<kD, 64, false, kDkvThreads>(vs, vb, a.v_s, k0, a.S, a.D, vec,
                                       threadIdx.x);
  if (n_my > 0) stage_unit(0, 0);
  mma_tiles::cp_async_commit();
  mma_tiles::cp_async_wait<0>();
  mma_tiles::fence_proxy_async();
  __syncthreads();

  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;
  const int kr_a = k0 + warp * 16 + g;

  for (int i = 0; i < n_my; ++i) {
    const int buf = i & 1;
    // the other buffer was last read in unit i - 1, behind the barrier
    // that closed it
    if (i + 1 < n_my) stage_unit(i + 1, buf ^ 1);
    mma_tiles::cp_async_commit();
    if (i > 0) {
      mma_tiles::cp_async_wait<1>();  // all but unit i + 1 have landed
      mma_tiles::fence_proxy_async();
      mma_tiles::named_barrier(1 + wg, 128);
    }
    const int q0 = 64 * (qt_lo + (wg + kDkvGroups * i) % n_live);
    const unsigned char* qt = ring + buf * kStageBytes;
    const unsigned char* dot = qt + kTileBytes;
    const float* ls = reinterpret_cast<const float*>(dot + kTileBytes);
    const float* dl = ls + 64;
#pragma unroll 1
    for (int half = 0; half < 64 / kDkvCols; ++half) {
      const int qh = q0 + kDkvCols * half;
      if (!pairs_live(qh, qh + kDkvCols - 1, k0, k0 + 63, a)) continue;
      float s[kDkvCols / 2], dp[kDkvCols / 2];
      score_products<kD, kDkvCols>(s, dp, ks, qt, vs, dot, kDkvCols * half);
      const bool full = pairs_full(qh, qh + kDkvCols - 1, k0 + warp * 16,
                                   k0 + warp * 16 + 15, a);
#pragma unroll
      for (int j = 0; j < kDkvCols / 2; ++j) {
        const int kr = kr_a + 8 * ((j >> 1) & 1);
        const int c = kDkvCols * half + (j >> 2) * 8 + 2 * tq + (j & 1);
        const float p = (full || visible(q0 + c, kr, a))
                            ? __expf(s[j] * a.scale - ls[c])
                            : 0.f;
        s[j] = p;
        dp[j] = p * (dp[j] - dl[c]);
      }
      uint32_t pb[kDkvCols / 16][4], xb[kDkvCols / 16][4];
      pack_a<kDkvCols>(pb, s);
      pack_a<kDkvCols>(xb, dp);
      mma_tiles::fence_regs(dv);
      mma_tiles::fence_regs(dk);
      mma_tiles::wgmma_fence();
      grad_product<kD, kDkvCols>(dv, pb, dot, kDkvCols * half);
      grad_product<kD, kDkvCols>(dk, xb, qt, kDkvCols * half);
      mma_tiles::wgmma_commit();
      mma_tiles::wgmma_wait<0>();
      mma_tiles::fence_regs(dv);
      mma_tiles::fence_regs(dk);
    }
    mma_tiles::named_barrier(1 + wg, 128);  // buffer buf is free
  }
  mma_tiles::cp_async_wait<0>();

  // warpgroup 0 writes dK, warpgroup 1 dV; each first hands the other its
  // partial through its own ring (free since its last barrier).  The
  // threads of the same index in the two warpgroups hold the same
  // elements, so the exchange is in fragment order.
  float* mine = reinterpret_cast<float*>(ring);
  const float* other = reinterpret_cast<const float*>(
      rings + (1 - wg) * kDkvStages * kStageBytes);
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) mine[128 * j + tid] = dv[j];
  } else {
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) mine[128 * j + tid] = dk[j];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) dk[j] += other[128 * j + tid];
    store_rows<kD>(static_cast<bf16*>(a.dk), dk, a.scale, kr_a, b, hk, a.KV,
                   tq, a);
  } else {
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) dv[j] = other[128 * j + tid] + dv[j];
    store_rows<kD>(static_cast<bf16*>(a.dv), dv, 1.f, kr_a, b, hk, a.KV, tq,
                   a);
  }
}

size_t dq_wgmma_smem_bytes(int Dp) {
  return static_cast<size_t>(64) * Dp * 2 * (2 * kDqGroups + 2 * kWgStages);
}

size_t dkv_wgmma_smem_bytes(int Dp) {
  return static_cast<size_t>(64) * Dp * 2 * 2 +
         static_cast<size_t>(kDkvGroups) * kDkvStages * dkv_stage_bytes(Dp);
}

// shared memory of each scalar kernel, in bytes (0 = fwd, 1 = dq,
// 2 = dkv); the tensor-core kernels' ((dq_, dkv_)wgmma_smem_bytes)
// stay under one block's 232448 at every D up to kMaxD
size_t smem_bytes(int which, int D) {
  const size_t tile = static_cast<size_t>(kTile) * (D + 1);
  const size_t ptile = static_cast<size_t>(kTile) * kLdP;
  switch (which) {
    case 0: return sizeof(float) * (3 * tile + ptile);
    case 1: return sizeof(float) * (4 * tile + ptile + 2 * kTile);
    default: return sizeof(float) * (4 * tile + 2 * ptile + 2 * kTile);
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, dim3 grid, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = K2f, 1 = K2q, 2 = K2kv, each on the tensor cores
template <int kD>
int launch_wgmma(int which, const Args& a, bool vec, int B,
                 cudaStream_t stream) {
  void (*kernel)(Args, int) =
      which == 0 ? flash_fwd_wgmma_kernel<kD>
                 : (which == 1 ? flash_dq_wgmma_kernel<kD>
                               : flash_dkv_wgmma_kernel<kD>);
  const size_t smem = which == 0 ? wgmma_smem_bytes(kD)
                                 : (which == 1 ? dq_wgmma_smem_bytes(kD)
                                               : dkv_wgmma_smem_bytes(kD));
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (a.S + 63) / 64;
  const int groups = which == 0 ? kWgGroups : kDqGroups;
  // K2f, K2q: blocks of `groups` (q tile, head) units per kv head; K2kv:
  // one block per (kv tile, kv head)
  const int blocks = which == 2 ? n_qt : (n_qt * a.G + groups - 1) / groups;
  const int threads = which == 0 ? kWgThreads
                                 : (which == 1 ? kDqThreads : kDkvThreads);
  kernel<<<dim3(blocks * a.KV, 1, B), threads, smem, stream>>>(a,
                                                               vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// a tensor-core kernel at D zero-padded to 16, 32, 64 or 128, with
// 16-byte copies where the n_in bf16 inputs allow them
int launch_wgmma_padded(int which, const Args& a, const void* const* in,
                        int n_in, const long long* strides, int B,
                        cudaStream_t st) {
  const bool vec = mma_tiles::vec_copies(a.D, in, n_in, strides);
  switch (mma_tiles::padded_d(a.D)) {
    case 16: return launch_wgmma<16>(which, a, vec, B, st);
    case 32: return launch_wgmma<32>(which, a, vec, B, st);
    case 64: return launch_wgmma<64>(which, a, vec, B, st);
    default: return launch_wgmma<128>(which, a, vec, B, st);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const long long* st, int S, int H, int KV, int D, int causal,
               int window, float scale) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.q_b = st[0]; a.q_s = st[1]; a.q_h = st[2];
  a.k_b = st[3]; a.k_s = st[4]; a.k_h = st[5];
  a.v_b = st[6]; a.v_s = st[7]; a.v_h = st[8];
  if (dout != nullptr) {
    a.o_b = st[9]; a.o_s = st[10]; a.o_h = st[11];
  }
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.G = H / KV;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return a;
}

bool bad_shape(int B, int S, int H, int KV, int D) {
  return D < 1 || D > kMaxD || KV < 1 || H % KV != 0 || S < 1 || B < 1 ||
         B > 65535 || H > 65535;
}

}  // namespace

extern "C" {

// Largest head_dim the kernels take, and each scalar kernel's shared
// memory.
int flash_max_head_dim() { return kMaxD; }

long long flash_smem_bytes(int which, int D) {
  return static_cast<long long>(smem_bytes(which, D));
}

// dtype: 0 = float32, 1 = bfloat16.  strides: q, k, v (and for the
// backward dout) as (batch, position, head) element strides; unit stride
// on D.  window <= 0: none.  Each returns the launch's cudaError_t.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     float* lse, const long long* strides, int B, int S,
                     int H, int KV, int D, int causal, int window,
                     float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, nullptr, strides, S, H, KV, D, causal, window,
                     scale);
  a.out = out;
  a.lse_out = lse;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(flash_fwd_kernel<float>, a, grid, smem_bytes(0, D), st);
  if (dtype == 1) {
    const void* in[] = {q, k, v};
    return launch_wgmma_padded(0, a, in, 3, strides, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, const long long* strides, int B, int S, int H,
                    int KV, int D, int causal, int window, float scale,
                    int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, dout, strides, S, H, KV, D, causal, window,
                     scale);
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(flash_dq_kernel<float>, a, grid, smem_bytes(1, D), st);
  if (dtype == 1) {
    const void* in[] = {q, k, v, dout};
    return launch_wgmma_padded(1, a, in, 4, strides, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, const long long* strides, int B,
                     int S, int H, int KV, int D, int causal, int window,
                     float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, dout, strides, S, H, KV, D, causal, window,
                     scale);
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  const dim3 grid((S + kTile - 1) / kTile, KV, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(flash_dkv_kernel<float>, a, grid, smem_bytes(2, D), st);
  if (dtype == 1) {
    const void* in[] = {q, k, v, dout};
    return launch_wgmma_padded(2, a, in, 4, strides, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
