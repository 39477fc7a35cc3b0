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
//          shard, added in place to its f32 dk/dv.  Each kv tile of each kv
//          head is owned by one block that streams every (query head of its
//          GQA group x q tile), so the group's sum is taken here: the TPU's
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
//     accumulators;
//   - tiles that cannot hold a live pair are skipped (`_tile_live`), with a
//     conservative test for tiles that straddle the halves.
//
// Layout: q, dO [B, S, H, D] and compact k/v [B, S, KV, D] are read from
// their strides (unit stride on D), head h reading kv head h / (H / KV).  The
// state is contiguous f32: m, l, lse, delta [B, H, S]; acc, dq [B, S, H, D];
// dk, dv [B, S, KV, D].  Rows and keys past S are masked.
//
// Design (simple and right first; K2's, csrc/flash_attention.cu): one block
// of 256 threads per (64-row tile, head, batch); each tile of Q, K, V, dO is
// staged in shared memory as f32 (row stride D + 1 against bank conflicts).
// Thread (ty, tx) of the 16 x 16 grid owns score rows ty + 16 i and columns
// tx + 16 j (i, j < 4) and accumulator rows ty + 16 i, columns tx + 16 j.
// Row statistics are reduced across a row's 16 lanes with warp shuffles;
// every lane gets the same bits, no atomics, no cross-block sums, so a launch
// repeats bit for bit.
//
// What bounds it on this card: at the ring-train shapes (S_l = 512, H = 32,
// KV = 8, D = 128, bf16) one full K3f step moves about 23 MB (the f32 acc read
// and written is 16.8 MB of it: 7.0 us at 3.35 TB/s) against 4.3 GFLOP of
// products (4.3 us at 989 TFLOP/s): bound by bytes.  K3q and K3kv read no
// f32 carry but add 8.4 MB and 4.2 MB of f32 accumulators in place against 3
// and 4 products: bound by operations.  This kernel does its products as
// scalar f32 FMAs (67 TFLOP/s peak) out of shared memory, so it is far from
// either bound; tensor-core products and double-buffered loads are later
// work.  The numbers are in PERF.md.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC
// and called through ctypes (tf_operator_tpu_torch/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

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

// [lo, hi] of the global ids of rows r0 .. r0 + kTile - 1 (within S).
__device__ __forceinline__ void id_range(int r0, int off0, int off1,
                                         const Args& a, int& lo, int& hi) {
  const int r1 = min(r0 + kTile, a.S) - 1;
  lo = INT_MAX;
  hi = INT_MIN;
  if (r0 < a.half) {
    lo = off0 + r0;
    hi = off0 + min(r1, a.half - 1);
  }
  if (r1 >= a.half) {
    lo = min(lo, off1 + max(r0, a.half) - a.half);
    hi = max(hi, off1 + r1 - a.half);
  }
}

// `_tile_live`: can the q tile at q0 and the kv tile at k0 hold any live
// pair?  Conservative over the tiles' id ranges (exact unless a tile
// straddles the halves); uniform across the block, so a skipped tile skips
// its barriers.
__device__ __forceinline__ bool tile_live(int q0, int k0, const Args& a) {
  if (!a.causal) return true;
  int qlo, qhi, klo, khi;
  id_range(q0, a.q_off0, a.q_off1, a, qlo, qhi);
  id_range(k0, a.k_off0, a.k_off1, a, klo, khi);
  bool live = klo <= qhi;
  if (a.window > 0) live = live && (khi > qlo - a.window);
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

// ---------------------------------------------------------------- K3f
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_fwd_kernel(Args a) {
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
        ps[r * kLdP + tx + kTx * j] = round_to<T>(p);
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
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_dq_kernel(Args a) {
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
template <typename T>
__global__ void __launch_bounds__(kThreads) ring_dkv_kernel(Args a) {
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

// shared memory of each kernel, in bytes (0 = fwd, 1 = dq, 2 = dkv)
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

// Largest head_dim the kernels take, and each kernel's shared memory.
int ring_max_head_dim() { return kMaxD; }

long long ring_smem_bytes(int which, int D) {
  return static_cast<long long>(smem_bytes(which, D));
}

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, dout).  strides: q, k, v
// (and for the backward dout) as (batch, position, head) element strides;
// unit stride on D.  q_off*/k_off*: global starts of the two half-chunks of
// the q shard and of the resident kv shard.  window <= 0: none.  Each
// returns the launch's cudaError_t.
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
  if (dtype == 0) return launch(ring_fwd_kernel<float>, a, grid, smem_bytes(0, D), st);
  if (dtype == 1) {
    return launch(ring_fwd_kernel<__nv_bfloat16>, a, grid, smem_bytes(0, D), st);
  }
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
  if (dtype == 0) return launch(ring_dq_kernel<float>, a, grid, smem_bytes(1, D), st);
  if (dtype == 1) {
    return launch(ring_dq_kernel<__nv_bfloat16>, a, grid, smem_bytes(1, D), st);
  }
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
  if (dtype == 0) return launch(ring_dkv_kernel<float>, a, grid, smem_bytes(2, D), st);
  if (dtype == 1) {
    return launch(ring_dkv_kernel<__nv_bfloat16>, a, grid, smem_bytes(2, D), st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
