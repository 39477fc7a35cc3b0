// Ring flash attention steps for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of tf_operator_tpu/ops/ring_flash.py
// (`ring_flash_attention`: `_carry_fwd_call` and `_bwd_step_call`):
//   - K3f  `_carry_fwd_kernel`: one ring step of the online-softmax forward
//          of a member's q shard against the resident kv shard.  The running
//          (m, l, acc) state is read from device memory and written back
//          (in place: each block owns its rows);
//   - K3q  `_dq_ring_kernel`: one step's dQ contribution,
//          scale * sum dS K with P = exp(s - lse), dS = P * (dO V^T - delta),
//          added in place to the member's f32 dq;
//   - K3kv `_dkv_ring_kernel`: one step's dK/dV contribution to the resident
//          shard, added in place to its f32 dk/dv.  The kernel reads kv head
//          h / G and sums each kv head's GQA group itself, so the TPU's
//          repeat of kv to H heads before the step (`_expand_kv`) and its
//          fold of dk/dv after it (`_fold_dkv`) do not exist.
//
// Numerics kept from the TPU kernels:
//   - scores s = (q . k) in f32, then * scale (scale = 1/sqrt(D));
//   - the causal/window mask compares GLOBAL ids.  A shard is two half-chunks
//     with global starts (off0, off1): row r has id off0 + r for r < S/2 and
//     off1 + r - S/2 above (contiguous shards pass off1 = off0 + S/2).  The
//     TPU maps only each tile's first row (`_tile_global_start`) and needs
//     tiles that divide the half; here every row and key maps itself, so any
//     S works, and tiles may straddle the halves;
//   - masked scores are NEG_INF = -1e30 and their p is exactly 0, also in a
//     row with nothing visible yet (m == NEG_INF), the TPU's
//     `where(s <= NEG_INF / 2, 0, ...)` guard; corr = exp(min(m_prev - m_new,
//     0)); a dead tile or step leaves (m, l, acc) as they were;
//   - forward: l sums the unrounded f32 p; p is rounded to V's type only for
//     the PV product;
//   - backward: p = exp(s - lse) (0 for lse = POS_INF, the finish of a row
//     that saw no key); dS rounded to K's type for dQ and to Q's type for dK;
//     dV += round(p)^T dO; all contributions are f32 and added to f32
//     accumulators.
//
// Which tiles run: one rule for every kernel, `span_live` and `span_full`
// below (mirrored in ops/ring_flash.py and checked there against the mask
// for rings of 2 and 4, both layouts and windows).  A span of rows maps to
// the hull [lo, hi] of its rows' global ids; a (q span, key span) pair is
// skipped only when no key id of the hull can be visible from any q id of
// it, and is taken as full (no per-element test) only when both spans lie
// inside S and inside one half-chunk and every pair of the hulls is
// visible.  No kernel assumes that the live tiles form one run: under
// zigzag shards and windows they need not, so each tile is tested.
//
// Layout: q, dO [B, S, H, D] and compact k/v [B, S, KV, D] are read from
// their strides (unit stride on D), head h reading kv head h / (H / KV).  The
// state is contiguous f32: m, l, lse, delta [B, H, S]; acc, dq [B, S, H, D];
// dk, dv [B, S, KV, D].  Rows and keys past S are masked.
//
// The scalar design (f32 inputs): one block of 256 threads per
// (64-row tile, head, batch); each tile of Q, K, V, dO is staged in shared
// memory as f32 (row stride D + 1 against bank conflicts).  Thread (ty, tx)
// of the 16 x 16 grid owns score rows ty + 16 i and columns tx + 16 j
// (i, j < 4) and accumulator rows ty + 16 i, columns tx + 16 j.  Row
// statistics are reduced across a row's 16 lanes with warp shuffles.  f32
// inputs keep it: the tensor cores would round them to TF32, and the f32
// parity checks hold the ring to full f32.
//
// bf16 inputs take the tensor-core designs of K2f, K2q and K2kv
// (csrc/flash_attention.cu; tiles, descriptors and products shared through
// mma_tiles.cuh):
//   - K3f (ring_fwd_wgmma_kernel) is K2f's block with kRfGroups = 2
//     warpgroups, each 64 q rows of one query head of one GQA group: Q
//     K-major, K and V tiles of 64 keys staged once for both as bf16 by
//     16-byte cp.async copies in a 3-stage ring two tiles ahead (V
//     MN-major), S = Q K^T by wgmma.m64n64k16 from shared memory and O +=
//     P V by wgmma.m64n{D}k16 with p in registers, in the TPU's order acc
//     corr + PV per tile; row max and sum as trees over a thread's 16
//     entries, since at 8 warps an SM the scalar step is latency-bound.  The
//     carry stays in device memory: m and l of the warpgroup's rows are
//     read into registers and its 64 x D block of acc straight into the O
//     accumulator fragments, issued before the first tile is waited for,
//     so that the f32 read overlaps the first copies and the first S
//     product; all are written back at the end, acc 8 bytes at a time.  A
//     warpgroup whose unit sees no tile of the step reads and writes
//     nothing, and a row a live tile adds nothing to (corr = 1, p = 0)
//     keeps its bits.  Each tile is tested (span_live), not a run t_lo ..
//     t_hi as in K2f, and blocks start heaviest first;
//   - p = exp(S scale - lse) and dS = p (dP - delta) are formed in registers
//     from two wgmma score products over D and become, rounded to bf16, the
//     A operand of the gradient product, whose B is a tile already staged for
//     the score products read MN-major (the descriptor's LBO and SBO
//     swapped): Q, K, V and dO are each staged once, as bf16, by 16-byte
//     cp.async copies (element copies where a stride or D forbids them;
//     D zero-padded to 16, 32, 64 or 128);
//   - K3q (ring_dq_wgmma_kernel) is K2q's block with kRqGroups = 2
//     warpgroups on K3f's unit map, 64 keys at a time: K and V tiles are
//     staged once for both in a 3-stage ring, the tiles no unit of the
//     block sees are skipped, and blocks start heaviest first;
//   - K3kv (ring_dkv_wgmma_kernel) makes the kv rows M, as K2kv: K and V
//     stay in shared memory, dK and dV are f32 registers (kD / 2 each), and
//     the units (query head of the group, live q tile) stream through a
//     2-stage ring.  K2kv's one block per (kv tile, kv head) would be 64
//     blocks for 132 SMs at S_l = 512, so each (kv tile, kv head) is a
//     cluster of kRkvCluster = 2 blocks of one warpgroup (128 blocks at
//     S_l = 512; up to two an SM): block rank c takes units c, c + 2, ...
//     The partials meet through distributed shared memory and are summed
//     in rank order, each rank summing half of the elements and adding it
//     to dk or dv.  On the H100 clusters of 2 ran faster than of 4, and
//     far faster than single blocks (PERF.md);
//   - p is taken by ex2.approx as 2^(S scale log2 e - c log2 e), c the row
//     max m (K3f) or lse (K3q, K3kv): a few ulp, as K2's __expf, well below
//     the bf16 rounding of p and dS;
//   - in place: each element of m, l, acc, dq, dk and dv is read and
//     written back once per launch, by one thread.  No atomics, so repeats
//     are bit-identical.
// Two warpgroups a block in K3f and K3q, not K2's four: at the ring's S_l
// = 512 (8 q tiles x 4 heads x 8 kv heads) that is 128 blocks that hold
// work, not 64, for 132 SMs.
//
// What bounds it on this card: at the ring-train shapes (S_l = 512, H = 32,
// KV = 8, D = 128, bf16) one full K3f step moves about 23 MB (the f32 acc
// read and written is 16.8 MB of it: 7.0 us at 3.35 TB/s) against 4.3
// GFLOP of products (4.3 us at 989 TFLOP/s): bound by bytes, and by the
// carry above all, which is why K3f issues the carry's reads first.  K3q
// and K3kv read no f32 carry but add 8.4 MB and 4.2 MB of f32 accumulators
// in place against 3 and 4 products.  The scalar kernels do their
// products as f32 FMAs (67 TFLOP/s peak) out of shared memory, far from
// either bound.  The numbers are in PERF.md.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC
// and called through ctypes (tf_operator_tpu_torch/kernels.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kTile = 64;               // q rows and kv rows per tile
constexpr int kTx = 16;                 // threads per score row
constexpr int kThreads = kTx * kTx;     // 256
constexpr int kRows = kTile / kTx;      // score rows (and cols) per thread
constexpr int kMaxD = 128;
constexpr int kDCols = kMaxD / kTx;     // accumulator columns per thread
constexpr int kLdP = kTile + 1;         // row stride of the p / dS tiles
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, S]
  const float* delta;  // [B, H, S]
  float* m;            // [B, H, S]      K3f carry
  float* l;            // [B, H, S]      K3f carry
  float* acc;          // [B, S, H, D]   K3f carry
  float* dq;           // [B, S, H, D]   K3q accumulator
  float* dk;           // [B, S, KV, D]  K3kv accumulators
  float* dv;           // [B, S, KV, D]
  // element strides (batch, position, head) of q, k, v and dout
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int S, H, KV, D, G;
  int half;                    // S / 2: the first half-chunk's rows
  int q_off0, q_off1;          // global starts of the q shard's halves
  int k_off0, k_off1;          // and of the resident kv shard's
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

// Global id of shard row r (half-chunk starts off0, off1).
__device__ __forceinline__ int global_id(int r, int off0, int off1,
                                         const Args& a) {
  return r < a.half ? off0 + r : off1 + r - a.half;
}

// Whether local query row r may attend local key row c of this step.
__device__ __forceinline__ bool visible(int r, int c, const Args& a) {
  if (r >= a.S || c >= a.S) return false;
  if (a.causal) {
    const int qi = global_id(r, a.q_off0, a.q_off1, a);
    const int ki = global_id(c, a.k_off0, a.k_off1, a);
    if (ki > qi) return false;
    if (a.window > 0 && ki <= qi - a.window) return false;
  }
  return true;
}

// [lo, hi]: the hull of the global ids of local rows r_lo .. r_hi (r_hi
// within S) of a shard with half-chunk starts off0, off1.
__device__ __forceinline__ void id_hull(int r_lo, int r_hi, int off0,
                                        int off1, const Args& a, int& lo,
                                        int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  if (r_lo < a.half) {
    lo = off0 + r_lo;
    hi = off0 + min(r_hi, a.half - 1);
  }
  if (r_hi >= a.half) {
    lo = min(lo, off1 + max(r_lo, a.half) - a.half);
    hi = max(hi, off1 + r_hi - a.half);
  }
}

// `_tile_live`: can q rows q_lo .. q_hi and keys k_lo .. k_hi (local)
// hold a visible pair?  Conservative over the id hulls (exact unless a
// span straddles the halves).  Uniform across whoever tests it, so a
// skipped tile skips its barriers.  ops/ring_flash.span_live mirrors it.
__device__ __forceinline__ bool span_live(int q_lo, int q_hi, int k_lo,
                                          int k_hi, const Args& a) {
  if (q_lo >= a.S || k_lo >= a.S) return false;
  if (!a.causal) return true;
  int qa, qb, ka, kb;
  id_hull(q_lo, min(q_hi, a.S - 1), a.q_off0, a.q_off1, a, qa, qb);
  id_hull(k_lo, min(k_hi, a.S - 1), a.k_off0, a.k_off1, a, ka, kb);
  return ka <= qb && (a.window <= 0 || kb > qa - a.window);
}

// Whether every pair of the spans is visible, so the per-element test can
// be skipped: both inside S (a q row past S would feed dK and dV) and
// inside one half-chunk (a span that straddles the halves always takes the
// per-element path).  ops/ring_flash.span_full mirrors it.
__device__ __forceinline__ bool span_full(int q_lo, int q_hi, int k_lo,
                                          int k_hi, const Args& a) {
  if (q_hi >= a.S || k_hi >= a.S) return false;
  if (!a.causal) return true;
  if ((q_lo < a.half && q_hi >= a.half) || (k_lo < a.half && k_hi >= a.half))
    return false;
  int qa, qb, ka, kb;
  id_hull(q_lo, q_hi, a.q_off0, a.q_off1, a, qa, qb);
  id_hull(k_lo, k_hi, a.k_off0, a.k_off1, a, ka, kb);
  return kb <= qa && (a.window <= 0 || ka > qb - a.window);
}

// the (kTile x kTile) tiles of the scalar kernels
__device__ __forceinline__ bool tile_live(int q0, int k0, const Args& a) {
  return span_live(q0, q0 + kTile - 1, k0, k0 + kTile - 1, a);
}

// Stage rows row0 .. row0 + kTile - 1 of head h of a [B, S, Hx, D] f32
// tensor into dst [kTile][D + 1]; rows past S are zero.
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          long long sb, long long ss,
                                          long long sh, int b, int h,
                                          int row0, const Args& a) {
  const float* p = static_cast<const float*>(src) + b * sb + h * sh;
  const int D = a.D, ld = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = row0 + r;
    dst[r * ld + d] = row < a.S ? p[row * ss + d] : 0.f;
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

// ---------------------------------------------------------------- K3f
// The scalar kernels take f32 inputs only (bf16 runs on the tensor
// cores), so p and dS need no rounding here.
__global__ void __launch_bounds__(kThreads) ring_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* qs = smem;              // [kTile][ld]
  float* ks = qs + kTile * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;   // [kTile][ld]
  float* ps = vs + kTile * ld;   // [kTile][kLdP] p

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  load_tile(qs, a.q, a.q_b, a.q_s, a.q_h, b, h, q0, a);

  // the carry in: every lane of a row reads the same m and l
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.S;
  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTx * i;
    const bool in = row < a.S;
    m[i] = in ? a.m[stat + row] : kNegInf;
    l[i] = in ? a.l[stat + row] : 0.f;
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int d = tx + kTx * j;
      acc[i][j] = (in && d < D) ? a.acc[base + d] : 0.f;
    }
  }

  const int n_kv = (a.S + kTile - 1) / kTile;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kTile;
    if (!tile_live(q0, k0, a)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile(ks, a.k, a.k_b, a.k_s, a.k_h, b, hk, k0, a);
    load_tile(vs, a.v, a.v_b, a.v_s, a.v_h, b, hk, k0, a);
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
      const int r = ty + kTx * i;
      bool vis[kRows];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        vis[j] = visible(q0 + r, k0 + tx + kTx * j, a);
        s[i][j] = vis[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max16(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        ps[r * kLdP + tx + kTx * j] = p;
      }
      corr[i] = expf(fminf(m[i] - m_new, 0.f));
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

  // the carry out
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTx * i;
    if (row >= a.S) continue;
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int d = tx + kTx * j;
      if (d < D) a.acc[base + d] = acc[i][j];
    }
    if (tx == 0) {
      a.m[stat + row] = m[i];
      a.l[stat + row] = l[i];
    }
  }
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

// ---------------------------------------------------------------- K3q
__global__ void __launch_bounds__(kThreads) ring_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* qs = smem;                 // [kTile][ld]
  float* dos = qs + kTile * ld;     // [kTile][ld]
  float* ks = dos + kTile * ld;     // [kTile][ld]
  float* vs = ks + kTile * ld;      // [kTile][ld]
  float* dss = vs + kTile * ld;     // [kTile][kLdP] dS
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  load_tile(qs, a.q, a.q_b, a.q_s, a.q_h, b, h, q0, a);
  load_tile(dos, a.dout, a.o_b, a.o_s, a.o_h, b, h, q0, a);
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
    load_tile(ks, a.k, a.k_b, a.k_s, a.k_h, b, hk, k0, a);
    load_tile(vs, a.v, a.v_b, a.v_s, a.v_h, b, hk, k0, a);
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
        dss[r * kLdP + c] = p * (dp[i][j] - delta_s[r]);
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

  // dq += this step's contribution (each element owned by one thread)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTx * i;
    if (row >= a.S) continue;
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int d = tx + kTx * j;
      if (d < D) a.dq[base + d] += acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- K3kv
__global__ void __launch_bounds__(kThreads) ring_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* ks = smem;                 // [kTile][ld]
  float* vs = ks + kTile * ld;      // [kTile][ld]
  float* qs = vs + kTile * ld;      // [kTile][ld]
  float* dos = qs + kTile * ld;     // [kTile][ld]
  float* ps = dos + kTile * ld;     // [kTile q][kLdP] p
  float* dss = ps + kTile * kLdP;   // [kTile q][kLdP] dS
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  load_tile(ks, a.k, a.k_b, a.k_s, a.k_h, b, hk, k0, a);
  load_tile(vs, a.v, a.v_b, a.v_s, a.v_h, b, hk, k0, a);

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
      load_tile(qs, a.q, a.q_b, a.q_s, a.q_h, b, h, q0, a);
      load_tile(dos, a.dout, a.o_b, a.o_s, a.o_h, b, h, q0, a);
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
          ps[r * kLdP + c] = p;
          dss[r * kLdP + c] = p * (dp[i][j] - delta_s[r]);
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

  // dk, dv += this step's group-summed contributions
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
        a.dk[base + d] += dk[i][j];
        a.dv[base + d] += dv[i][j];
      }
    }
  }
}

// ------------------------------------- K3f, K3q and K3kv, warpgroup products
using mma_tiles::desc_over_d;
using mma_tiles::grad_product;
using mma_tiles::pack_a;
using mma_tiles::pv_wgmma;
using mma_tiles::score_products;
using mma_tiles::stage_cm;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (ex2.approx: a few ulp, far below the
// bf16 rounding of p and dS).  exp(x) is taken as 2^(x log2 e) with log2 e
// folded into the scale: p = exp(s scale - c) is 2^(s (scale log2 e) -
// c log2 e), one FMA and one ex2 an element, which ran faster on the H100
// than __expf of s scale - c.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The unit map of K3f and K3q: the units of a kv head's group are
// u = (q tile) G + (head in group), 64 q rows of one query head each, and
// a block of `groups` warpgroups takes `groups` consecutive units.
// blockIdx.x runs over (unit block, kv head), kv head fastest, unit
// blocks from the last: under a causal mask the heaviest start first.
// Returns the block's first unit.  ops/ring_flash.fwd_units mirrors it.
__device__ __forceinline__ int first_unit(int groups, const Args& a) {
  return (gridDim.x / a.KV - 1 - blockIdx.x / a.KV) * groups;
}

// The first kv tile from t that any of units u0 .. u0 + groups - 1 (those
// that exist) sees; n_t: none.  Each tile is tested: under zigzag shards
// and windows the live tiles need not form one run.
__device__ __forceinline__ int next_live_tile(int t, int u0, int groups,
                                              int n_t, const Args& a) {
  for (; t < n_t; ++t) {
    for (int i = 0; i < groups && u0 + i < n_t * a.G; ++i) {
      const int r0 = ((u0 + i) / a.G) * 64;
      if (span_live(r0, r0 + 63, 64 * t, 64 * t + 63, a)) return t;
    }
  }
  return n_t;
}

// K3f: kRfGroups warpgroups of 64 q rows of one query head each (the
// units of first_unit), K and V tiles of 64 keys staged once for the
// block in a kRfStages ring (K K-major, V MN-major), loaded two tiles
// ahead, one barrier a tile.  Per warpgroup and live tile: S = Q K^T by
// wgmma.m64n64k16 from shared memory, the online-softmax step on its
// accumulators (row max and sum as trees), and O += P V by
// wgmma.m64n{kD}k16 with p in registers, in the TPU's order acc corr +
// PV.  The carry is read into registers (acc straight into the O
// accumulator fragments) while the first tiles load, and written back
// at the end, 8 bytes at a time where D and acc's alignment allow.
// Registers: O (kD / 2) and S (32) a thread, 256 threads at up to 255.
constexpr int kRfGroups = 2;
constexpr int kRfThreads = 128 * kRfGroups;
constexpr int kRfStages = 3;

__device__ __forceinline__ float fmax2(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ float fsum(float x, float y) { return x + y; }

// op over the thread's 16 entries of fragment row r (0: g, 1: g + 8) of
// a 64-column score tile, as a tree: with 8 warps an SM the serial chain
// of 16 was latency-bound (PERF.md)
template <float (*op)(float, float)>
__device__ __forceinline__ float row_tree(const float (&s)[32], int r) {
  float x[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) x[n] = op(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int n = 0; n < w; ++n) x[n] = op(x[n], x[n + w]);
  }
  return x[0];
}

template <int kD>
__global__ void __launch_bounds__(kRfThreads, 1)
    ring_fwd_wgmma_kernel(Args a, int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int kTileBytes = 64 * kD * 2;
  // MN-major V: 8 columns of D span 64 / 8 core matrices
  constexpr uint32_t kSboV = (64 / 8) * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qs = smem_raw;                     // [kRfGroups][64 x kD]
  unsigned char* ks = qs + kRfGroups * kTileBytes;  // [kRfStages][64 x kD]
  unsigned char* vs = ks + kRfStages * kTileBytes;  // the same, MN-major

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int n_t = (a.S + 63) / 64;
  const int hk = blockIdx.x % a.KV, b = blockIdx.z;
  const int u0 = first_unit(kRfGroups, a);
  const int u = u0 + wg;
  const int w0 = (u / a.G) * 64;  // the warpgroup's rows w0 .. w0 + 63
  const int h = hk * a.G + u % a.G;
  // a warpgroup whose unit sees no tile of this step reads and writes
  // none of the carry
  const bool active = u < n_t * a.G && next_live_tile(0, u, 1, n_t, a) < n_t;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;

  if (active) {
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
    stage_cm<kD, 64, false, 128>(qs + wg * kTileBytes, qb, a.q_s, w0, a.S,
                                 a.D, vec, threadIdx.x % 128);
  }
  // K and V tile t into ring buffer buf; a commit group per tile, even
  // when there is no tile, so that wait<1> always means "all but the
  // newest"
  auto stage_kv = [&](int t, int buf) {
    if (t < n_t) {
      stage_cm<kD, 64, false, kRfThreads>(ks + buf * kTileBytes, kb, a.k_s,
                                          64 * t, a.S, a.D, vec, threadIdx.x);
      stage_cm<kD, 64, true, kRfThreads>(vs + buf * kTileBytes, vb, a.v_s,
                                         64 * t, a.S, a.D, vec, threadIdx.x);
    }
    mma_tiles::cp_async_commit();
  };
  // the block's first two tiles in flight at once (Q rides with the first)
  int t = next_live_tile(0, u0, kRfGroups, n_t, a);
  int t_nx = next_live_tile(t + 1, u0, kRfGroups, n_t, a);
  stage_kv(t, 0);
  stage_kv(t_nx, 1);

  // the carry in, issued before the first tile is waited for: m and l of
  // rows r_a and r_a + 8 (every lane of a quad reads the same), and acc
  // as the O fragments, o[4 n + 2 i + e] = (row r_a + 8 i, column
  // 8 n + 2 tq + e): each element read by its one owner
  const int r_a = w0 + warp * 16 + g;
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.S;
  const bool pairs =
      a.D % 2 == 0 && reinterpret_cast<uintptr_t>(a.acc) % 8 == 0;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_a + 8 * i;
      if (row >= a.S) continue;
      m[i] = a.m[stat + row];
      l[i] = a.l[stat + row];
      const float* src =
          a.acc + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int d = n * 8 + 2 * tq;
        if (d >= a.D) continue;
        if (pairs) {
          const float2 x = *reinterpret_cast<const float2*>(src + d);
          o[4 * n + 2 * i] = x.x;
          o[4 * n + 2 * i + 1] = x.y;
        } else {
          o[4 * n + 2 * i] = src[d];
          if (d + 1 < a.D) o[4 * n + 2 * i + 1] = src[d + 1];
        }
      }
    }
  }

  const float scale2 = a.scale * kLog2e;
  // the i-th tile seen sits in buffer i % kRfStages, loaded two tiles
  // ahead: the buffer refilled at tile i was read at tile i - 1, behind
  // this tile's barrier
  for (int i = 0; t < n_t; ++i) {
    mma_tiles::cp_async_wait<1>();  // all but tile t_nx have landed
    mma_tiles::fence_proxy_async();
    __syncthreads();
    const int t2 = next_live_tile(t_nx + 1, u0, kRfGroups, n_t, a);
    stage_kv(t2, (i + 2) % kRfStages);

    // a warpgroup none of whose rows sees the tile leaves its carry as it
    // is; it only keeps the block's barriers
    const int k0 = 64 * t;
    if (active && span_live(w0, w0 + 63, k0, k0 + 63, a)) {
      const unsigned char* kt = ks + (i % kRfStages) * kTileBytes;
      const unsigned char* vt = vs + (i % kRfStages) * kTileBytes;
      float s[32];
      mma_tiles::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        mma_tiles::wgmma_m64n64k16_ss(
            s, desc_over_d<kD>(qs + wg * kTileBytes, 0, kk),
            desc_over_d<kD>(kt, 0, kk), kk > 0);
      }
      mma_tiles::wgmma_commit();
      mma_tiles::wgmma_wait<0>();
      mma_tiles::fence_regs(s);

      // masked scores become -inf: p is exactly 0, also while m is the
      // -1e30 seed.  The row max is taken over the raw scores and scaled
      // after (scaling by a positive factor keeps the order)
      const bool full = span_full(w0 + warp * 16, w0 + warp * 16 + 15, k0,
                                  k0 + 63, a);
      if (!full) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int ki = k0 + (j >> 2) * 8 + 2 * tq + (j & 1);
          if (!visible(r_a + 8 * ((j >> 1) & 1), ki, a)) s[j] = -INFINITY;
        }
      }
      float corr[2], m2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new =
            fmaxf(m[r], mma_tiles::quad_max(row_tree<fmax2>(s, r)) * a.scale);
        // a row the tile adds nothing to keeps its carry's bits
        corr[r] = m_new == m[r] ? 1.f : ex2((m[r] - m_new) * kLog2e);
        m2[r] = m_new * kLog2e;
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s[j] = ex2(fmaf(s[j], scale2, -m2[(j >> 1) & 1]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * corr[r] + mma_tiles::quad_sum(row_tree<fsum>(s, r));
      }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
      uint32_t p[4][4];
      pack_a<64>(p, s);
      mma_tiles::fence_regs(o);
      mma_tiles::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pv_wgmma<kD>(o, p[kk],
                     mma_tiles::smem_desc(vt + kk * 256, 128, kSboV));
      }
      mma_tiles::wgmma_commit();
      mma_tiles::wgmma_wait<0>();
      mma_tiles::fence_regs(o);
    }
    t = t_nx;
    t_nx = t2;
  }
  mma_tiles::cp_async_wait<0>();
  if (!active) return;

  // the carry out, each element by its one owner
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_a + 8 * i;
    if (row >= a.S) continue;
    float* dst =
        a.acc + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = n * 8 + 2 * tq;
      if (d >= a.D) continue;
      if (pairs) {
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(o[4 * n + 2 * i], o[4 * n + 2 * i + 1]);
      } else {
        dst[d] = o[4 * n + 2 * i];
        if (d + 1 < a.D) dst[d + 1] = o[4 * n + 2 * i + 1];
      }
    }
    if (tq == 0) {
      a.m[stat + row] = m[i];
      a.l[stat + row] = l[i];
    }
  }
}

// K3q: kRqGroups warpgroups of 64 q rows of one query head each (the
// units of first_unit), K and V tiles of 64 keys staged once for the
// block in a kRqStages ring, one barrier a tile.  Per warpgroup, kRqCols
// keys at a time: S = Q K^T and dP = dO V^T, p = exp(S scale - lse),
// dS = p (dP - delta) rounded to bf16, and dQ += dS K with K read
// MN-major.  Registers: dQ (kD / 2), S and dP (kRqCols / 2 each) a
// thread.  In probe builds on the H100 at the ring-train shapes, 64 keys
// at a time ran faster than 32, and 1 or 4 warpgroups a block slower
// than 2 (PERF.md).
constexpr int kRqGroups = 2;
constexpr int kRqThreads = 128 * kRqGroups;
constexpr int kRqCols = 64;
constexpr int kRqStages = 3;

template <int kD>
__global__ void __launch_bounds__(kRqThreads, 1)
    ring_dq_wgmma_kernel(Args a, int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int kTileBytes = 64 * kD * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qs = smem_raw;                      // [kRqGroups][64 x kD]
  unsigned char* dos = qs + kRqGroups * kTileBytes;  // the same, dO
  unsigned char* ks = dos + kRqGroups * kTileBytes;  // [kRqStages][64 x kD]
  unsigned char* vs = ks + kRqStages * kTileBytes;   // the same, V

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int n_t = (a.S + 63) / 64;
  const int hk = blockIdx.x % a.KV, b = blockIdx.z;
  const int u0 = first_unit(kRqGroups, a);
  const int u = u0 + wg;
  const bool unit_live = u < n_t * a.G;
  const int w0 = (u / a.G) * 64;  // the warpgroup's rows w0 .. w0 + 63
  const int h = hk * a.G + u % a.G;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;
  auto next_tile = [&](int t) {
    return next_live_tile(t, u0, kRqGroups, n_t, a);
  };

  const int r_a = w0 + warp * 16 + g;
  const float scale2 = a.scale * kLog2e;
  float lse[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};  // lse in log2 units
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
        lse[i] = a.lse[st + r_a + 8 * i] * kLog2e;
        dlt[i] = a.delta[st + r_a + 8 * i];
      }
    }
  }
  int t = next_tile(0);
  if (t < n_t) {
    stage_cm<kD, 64, false, kRqThreads>(ks, kb, a.k_s, 64 * t, a.S, a.D, vec,
                                        threadIdx.x);
    stage_cm<kD, 64, false, kRqThreads>(vs, vb, a.v_s, 64 * t, a.S, a.D, vec,
                                        threadIdx.x);
  }
  mma_tiles::cp_async_commit();

  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;

  // the i-th tile seen sits in buffer i % kRqStages; the buffer a load
  // refills was read two tiles before, behind a barrier every thread has
  // passed since
  for (int i = 0; t < n_t; ++i) {
    const int nx = next_tile(t + 1);
    if (nx < n_t) {
      const int buf = (i + 1) % kRqStages;
      stage_cm<kD, 64, false, kRqThreads>(ks + buf * kTileBytes, kb, a.k_s,
                                          64 * nx, a.S, a.D, vec,
                                          threadIdx.x);
      stage_cm<kD, 64, false, kRqThreads>(vs + buf * kTileBytes, vb, a.v_s,
                                          64 * nx, a.S, a.D, vec,
                                          threadIdx.x);
    }
    mma_tiles::cp_async_commit();
    mma_tiles::cp_async_wait<1>();  // all but tile nx have landed
    mma_tiles::fence_proxy_async();
    __syncthreads();

    const unsigned char* kt = ks + (i % kRqStages) * kTileBytes;
    const unsigned char* vt = vs + (i % kRqStages) * kTileBytes;
    // a warpgroup whose rows see none of the tile keeps the barriers only
#pragma unroll 1
    for (int part = 0; unit_live && part < 64 / kRqCols; ++part) {
      const int kh = 64 * t + kRqCols * part;
      if (!span_live(w0, w0 + 63, kh, kh + kRqCols - 1, a)) continue;
      float s[kRqCols / 2], dp[kRqCols / 2];
      score_products<kD, kRqCols>(s, dp, qs + wg * kTileBytes, kt,
                                  dos + wg * kTileBytes, vt, kRqCols * part);
      const bool full = span_full(w0 + warp * 16, w0 + warp * 16 + 15, kh,
                                  kh + kRqCols - 1, a);
#pragma unroll
      for (int j = 0; j < kRqCols / 2; ++j) {
        const int r = (j >> 1) & 1;
        const int ki = kh + (j >> 2) * 8 + 2 * tq + (j & 1);
        const float p = (full || visible(r_a + 8 * r, ki, a))
                            ? ex2(fmaf(s[j], scale2, -lse[r]))
                            : 0.f;
        s[j] = p * (dp[j] - dlt[r]);
      }
      uint32_t x[kRqCols / 16][4];
      pack_a<kRqCols>(x, s);
      mma_tiles::fence_regs(dq);
      mma_tiles::wgmma_fence();
      grad_product<kD, kRqCols>(dq, x, kt, kRqCols * part);
      mma_tiles::wgmma_commit();
      mma_tiles::wgmma_wait<0>();
      mma_tiles::fence_regs(dq);
    }
    t = nx;
  }
  mma_tiles::cp_async_wait<0>();
  if (!unit_live) return;

  // dq += scale * this step's sum: each element by its one owner
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_a + 8 * i;
    if (row >= a.S) continue;
    float* out =
        a.dq + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * tq + e;
        if (d < a.D) out[d] += a.scale * dq[4 * n + 2 * i + e];
      }
    }
  }
}

// K3kv: a cluster of kRkvCluster blocks, one warpgroup each, per (64-row kv
// tile, kv head), kv rows the M dimension.  Each block keeps K and V in
// shared memory and streams its share of the units (query head of the
// group, live q tile): rank c takes units c, c + kRkvCluster, ..., each
// unit's Q, dO, lse and delta through a kRkvStages ring.  Per unit, all 64
// q rows at once: S^T = K Q^T and dP^T = V dO^T, p^T = exp(S^T scale -
// lse[col]), dS^T = p^T (dP^T - delta[col]), then dV += round(p^T) dO and
// dK += dS^T Q with dO and Q read MN-major.  Registers: dK and dV (kD / 2
// each), S and dP (32 each) a thread: 128 threads at up to 255 registers,
// two blocks an SM.
constexpr int kRkvCluster = 2;
constexpr int kRkvThreads = 128;
constexpr int kRkvStages = 2;

// bytes of one stage of the ring: Q, dO, lse, delta
__host__ __device__ constexpr int rkv_stage_bytes(int d) {
  return 2 * 64 * d * 2 + 2 * 64 * 4;
}

template <int kD>
__global__ void __cluster_dims__(kRkvCluster, 1, 1)
    __launch_bounds__(kRkvThreads, 2) ring_dkv_wgmma_kernel(Args a, int vec) {
  using bf16 = __nv_bfloat16;
  namespace cg = cooperative_groups;
  constexpr int kTileBytes = 64 * kD * 2;
  constexpr int kStageBytes = rkv_stage_bytes(kD);
  // the partials of the end (kD / 2 float2 a thread) reuse the ring
  static_assert(kD * 512 <= kRkvStages * kStageBytes, "partials fit");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ks = smem_raw;            // [64 x kD]
  unsigned char* vs = ks + kTileBytes;     // [64 x kD]
  unsigned char* ring = vs + kTileBytes;   // [kRkvStages][kStageBytes]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, g = lane / 4, tq = lane % 4;
  // clusters run over (kv tile, kv head), kv head fastest, from the first
  // kv tile: under a causal mask the heaviest start first
  const int pair = blockIdx.x / kRkvCluster;
  const int hk = pair % a.KV, b = blockIdx.z;
  const int k0 = (pair / a.KV) * 64;

  // the q tiles that see this kv tile, tested one by one; where they
  // form one run lo .. hi (they need not), the j-th is lo + j
  const int n_q = (a.S + 63) / 64;
  auto q_live = [&](int qt) {
    return span_live(64 * qt, 64 * qt + 63, k0, k0 + 63, a);
  };
  int n_live = 0, lo = 0, hi = -1;
  for (int qt = 0; qt < n_q; ++qt) {
    if (q_live(qt)) {
      lo = n_live++ == 0 ? qt : lo;
      hi = qt;
    }
  }
  const bool run = hi - lo + 1 == n_live;
  auto live_tile = [&](int j) {  // the j-th of them
    if (run) return lo + j;
    int qt = 0;
    for (;; ++qt) {
      if (q_live(qt) && j-- == 0) break;
    }
    return qt;
  };
  // unit v = (head in group) n_live + (index of its live q tile); this
  // block takes v = rank + kRkvCluster i
  const int n_my =
      (a.G * n_live - rank + kRkvCluster - 1) / kRkvCluster;

  auto stage_unit = [&](int i, int buf) {
    const int v = rank + kRkvCluster * i;
    const int h = hk * a.G + v / n_live;
    const int q0 = 64 * live_tile(v % n_live);
    unsigned char* dst = ring + buf * kStageBytes;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
    const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.o_b + h * a.o_h;
    stage_cm<kD, 64, false, kRkvThreads>(dst, qb, a.q_s, q0, a.S, a.D, vec,
                                         tid);
    stage_cm<kD, 64, false, kRkvThreads>(dst + kTileBytes, ob, a.o_s, q0,
                                         a.S, a.D, vec, tid);
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
  stage_cm<kD, 64, false, kRkvThreads>(ks, kb, a.k_s, k0, a.S, a.D, vec,
                                       tid);
  stage_cm<kD, 64, false, kRkvThreads>(vs, vb, a.v_s, k0, a.S, a.D, vec,
                                       tid);
  if (n_my > 0) stage_unit(0, 0);
  mma_tiles::cp_async_commit();
  mma_tiles::cp_async_wait<0>();
  mma_tiles::fence_proxy_async();
  __syncthreads();

  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;
  const int kr_a = k0 + warp * 16 + g;
  const float scale2 = a.scale * kLog2e;

  for (int i = 0; i < n_my; ++i) {
    const int buf = i & 1;
    // the other buffer was last read in unit i - 1, behind the barrier
    // that closed it
    if (i + 1 < n_my) stage_unit(i + 1, buf ^ 1);
    mma_tiles::cp_async_commit();
    if (i > 0) {
      mma_tiles::cp_async_wait<1>();  // all but unit i + 1 have landed
      mma_tiles::fence_proxy_async();
      __syncthreads();
    }
    const int q0 = 64 * live_tile((rank + kRkvCluster * i) % n_live);
    const unsigned char* qt = ring + buf * kStageBytes;
    const unsigned char* dot = qt + kTileBytes;
    // lse (in log2 units) and delta of the thread's 16 columns 8 n + 2 tq
    // (+ 1), read into registers while the score products run
    const float2* ls = reinterpret_cast<const float2*>(dot + kTileBytes);
    float2 lsv[8], dlv[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      lsv[n] = ls[4 * n + tq];
      lsv[n].x *= kLog2e;
      lsv[n].y *= kLog2e;
      dlv[n] = ls[32 + 4 * n + tq];
    }
    float s[32], dp[32];
    score_products<kD, 64>(s, dp, ks, qt, vs, dot, 0);
    const bool full = span_full(q0, q0 + 63, k0 + warp * 16,
                                k0 + warp * 16 + 15, a);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kr = kr_a + 8 * ((j >> 1) & 1);
      const int c = (j >> 2) * 8 + 2 * tq + (j & 1);
      const float l_c = (j & 1) ? lsv[j >> 2].y : lsv[j >> 2].x;
      const float d_c = (j & 1) ? dlv[j >> 2].y : dlv[j >> 2].x;
      const float p = (full || visible(q0 + c, kr, a))
                          ? ex2(fmaf(s[j], scale2, -l_c))
                          : 0.f;
      s[j] = p;
      dp[j] = p * (dp[j] - d_c);
    }
    uint32_t pb[4][4], xb[4][4];
    pack_a<64>(pb, s);
    pack_a<64>(xb, dp);
    mma_tiles::fence_regs(dv);
    mma_tiles::fence_regs(dk);
    mma_tiles::wgmma_fence();
    grad_product<kD, 64>(dv, pb, dot, 0);
    grad_product<kD, 64>(dk, xb, qt, 0);
    mma_tiles::wgmma_commit();
    mma_tiles::wgmma_wait<0>();
    mma_tiles::fence_regs(dv);
    mma_tiles::fence_regs(dk);
    __syncthreads();  // buffer buf is free
  }
  mma_tiles::cp_async_wait<0>();

  // the partials of the cluster's blocks: each block's threads hold the
  // same elements in the same fragment order, so partial j of thread tid
  // sits at [j][tid] in every block (dK's kD / 4 float2 pairs, then dV's)
  constexpr int kPairs = kD / 2;
  float2* mine = reinterpret_cast<float2*>(ring);
#pragma unroll
  for (int j = 0; j < kPairs / 2; ++j) {
    mine[j * kRkvThreads + tid] = make_float2(dk[2 * j], dk[2 * j + 1]);
    mine[(kPairs / 2 + j) * kRkvThreads + tid] =
        make_float2(dv[2 * j], dv[2 * j + 1]);
  }
  cluster.sync();
  // rank c sums pairs c kSlice .. of the cluster's partials in rank order
  // and adds the sum to dk or dv
  constexpr int kSlice = kPairs / kRkvCluster;
  static_assert(kSlice * kRkvCluster == kPairs, "whole slices");
  const float2* part[kRkvCluster];
#pragma unroll
  for (int r = 0; r < kRkvCluster; ++r) part[r] = cluster.map_shared_rank(mine, r);
#pragma unroll
  for (int jj = 0; jj < kSlice; ++jj) {
    const int j = rank * kSlice + jj;
    float2 sum = part[0][j * kRkvThreads + tid];
#pragma unroll
    for (int r = 1; r < kRkvCluster; ++r) {
      const float2 x = part[r][j * kRkvThreads + tid];
      sum.x += x.x;
      sum.y += x.y;
    }
    // pair jl holds fragment entries 2 jl, 2 jl + 1: n-tile jl / 2, row
    // half jl % 2
    const bool is_v = j >= kPairs / 2;
    const int jl = is_v ? j - kPairs / 2 : j;
    const int row = kr_a + 8 * (jl & 1);
    const int d = (jl >> 1) * 8 + 2 * tq;
    if (row >= a.S) continue;
    float* out = (is_v ? a.dv : a.dk) +
                 ((static_cast<long long>(b) * a.S + row) * a.KV + hk) * a.D;
    const float mul = is_v ? 1.f : a.scale;
    if (d < a.D) out[d] += mul * sum.x;
    if (d + 1 < a.D) out[d + 1] += mul * sum.y;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// shared memory of each tensor-core kernel at D padded to Dp, in bytes
// (0 = fwd, 1 = dq, 2 = dkv)
size_t wgmma_smem_bytes(int which, int Dp) {
  const size_t tile = static_cast<size_t>(64) * Dp * 2;
  if (which == 0) return tile * (kRfGroups + 2 * kRfStages);
  if (which == 1) return tile * (2 * kRqGroups + 2 * kRqStages);
  return tile * 2 + static_cast<size_t>(kRkvStages) * rkv_stage_bytes(Dp);
}

// shared memory of each scalar kernel, in bytes (0 = fwd, 1 = dq, 2 = dkv)
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

// which: 0 = K3f, 1 = K3q, 2 = K3kv, on the tensor cores
template <int kD>
int launch_wgmma(int which, const Args& a, bool vec, int B,
                 cudaStream_t stream) {
  void (*kernel)(Args, int) =
      which == 0 ? ring_fwd_wgmma_kernel<kD>
                 : (which == 1 ? ring_dq_wgmma_kernel<kD>
                               : ring_dkv_wgmma_kernel<kD>);
  const size_t smem = wgmma_smem_bytes(which, kD);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_t = (a.S + 63) / 64;
  // K3f, K3q: blocks of `groups` (q tile, head) units per kv head
  // (first_unit); K3kv: a cluster of kRkvCluster blocks per (kv tile, kv
  // head)
  const int groups = which == 0 ? kRfGroups : kRqGroups;
  const int blocks = which == 2 ? n_t * a.KV * kRkvCluster
                                : (n_t * a.G + groups - 1) / groups * a.KV;
  const int threads = which == 0 ? kRfThreads
                                 : (which == 1 ? kRqThreads : kRkvThreads);
  kernel<<<dim3(blocks, 1, B), threads, smem, stream>>>(a, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// K3f on bf16 inputs q, k, v, or K3q and K3kv on q, k, v, dout: D
// zero-padded to 16, 32, 64 or 128, 16-byte copies where the inputs allow
// them (strides holds 3 entries for each input)
int launch_wgmma_padded(int which, const Args& a, const long long* strides,
                        int B, cudaStream_t st) {
  const void* in[] = {a.q, a.k, a.v, a.dout};
  const bool vec =
      mma_tiles::vec_copies(a.D, in, which == 0 ? 3 : 4, strides);
  switch (mma_tiles::padded_d(a.D)) {
    case 16: return launch_wgmma<16>(which, a, vec, B, st);
    case 32: return launch_wgmma<32>(which, a, vec, B, st);
    case 64: return launch_wgmma<64>(which, a, vec, B, st);
    default: return launch_wgmma<128>(which, a, vec, B, st);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const long long* st, int S, int H, int KV, int D, int q_off0,
               int q_off1, int k_off0, int k_off1, int causal, int window,
               float scale) {
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
  a.half = S / 2;
  a.q_off0 = q_off0;
  a.q_off1 = q_off1;
  a.k_off0 = k_off0;
  a.k_off1 = k_off1;
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

// Largest head_dim the kernels take, and the shared memory of the kernel
// that `which` (0 = K3f, 1 = K3q, 2 = K3kv) launches on inputs of `dtype`
// (bf16: the tensor-core kernels at D padded).
int ring_max_head_dim() { return kMaxD; }

long long ring_smem_bytes(int which, int D, int dtype) {
  if (dtype == 1) {
    return static_cast<long long>(
        wgmma_smem_bytes(which, mma_tiles::padded_d(D)));
  }
  return static_cast<long long>(smem_bytes(which, D));
}

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, dout).  strides: q, k, v
// (and for the backward dout) as (batch, position, head) element strides;
// unit stride on D.  q_off*/k_off*: global starts of the two half-chunks of
// the q shard and of the resident kv shard.  window <= 0: none.  Each
// returns the launch's cudaError_t.  bf16 inputs launch the tensor-core
// kernels, and a launch they refuse returns its error: no scalar
// fallback.
int ring_fwd_launch(const void* q, const void* k, const void* v, float* m,
                    float* l, float* acc, const long long* strides, int B,
                    int S, int H, int KV, int D, int q_off0, int q_off1,
                    int k_off0, int k_off1, int causal, int window,
                    float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, nullptr, strides, S, H, KV, D, q_off0, q_off1,
                     k_off0, k_off1, causal, window, scale);
  a.m = m;
  a.l = l;
  a.acc = acc;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(ring_fwd_kernel, a, grid, smem_bytes(0, D), st);
  if (dtype == 1) return launch_wgmma_padded(0, a, strides, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int ring_dq_launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   float* dq, const long long* strides, int B, int S, int H,
                   int KV, int D, int q_off0, int q_off1, int k_off0,
                   int k_off1, int causal, int window, float scale, int dtype,
                   void* stream) {
  if (bad_shape(B, S, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, dout, strides, S, H, KV, D, q_off0, q_off1,
                     k_off0, k_off1, causal, window, scale);
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(ring_dq_kernel, a, grid, smem_bytes(1, D), st);
  if (dtype == 1) return launch_wgmma_padded(1, a, strides, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int ring_dkv_launch(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    float* dk, float* dv, const long long* strides, int B,
                    int S, int H, int KV, int D, int q_off0, int q_off1,
                    int k_off0, int k_off1, int causal, int window,
                    float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, dout, strides, S, H, KV, D, q_off0, q_off1,
                     k_off0, k_off1, causal, window, scale);
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  const dim3 grid((S + kTile - 1) / kTile, KV, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(ring_dkv_kernel, a, grid, smem_bytes(2, D), st);
  if (dtype == 1) return launch_wgmma_padded(2, a, strides, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
