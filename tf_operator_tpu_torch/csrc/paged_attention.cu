// Paged GQA attention over a KV block pool, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tf_operator_tpu/models/paged_attention.py
// (`paged_attention`, kernel body `_kernel`).  Same function: each query
// row of q [B, L, H, D] attends the positions its lane's block table
// [B, T] routes into the pools [N+1, bs, KV, D], with
//   - visibility by the ring formula k = q - mod(q - slot, T*bs) (floor
//     modulo), optional sliding-window band k > q - window;
//   - block id 0 (scratch) masked, all-masked rows finalizing to 0;
//   - online softmax in f32 (running max m, running sum l, accumulator);
//   - p rounded to V's type before the PV product, as the TPU kernel does.
//
// K1q, the int8 variant (`_int8_kernel_adapter` -> `_kernel` with
// k_scale_ref/v_scale_ref): the pools hold an int8 payload and an f32
// scale per (position, kv head), scale[(block*bs + o)*KV + j].  Each
// element is dequantized while the block is staged, exactly as the TPU
// kernel does: (float)q * scale, ROUNDED TO T (bf16 or f32), and only
// then widened for the QK and PV products.  Everything else is K1's; the
// payload type is a template parameter of the one kernel.
//
// Two designs, chosen by q's dtype in dispatch():
//
// f32 queries: the scalar kernel (paged_attention_kernel), exact in f32
// (the tensor cores would round to TF32, and the f32 parity checks hold
// serving to full f32):
//   - one thread block per (tile of kRows query rows, kv head, lane).  The
//     rows of a kv head's group are r = l*G + g, so q and out are indexed
//     [B, L, H, D] straight from their strides, head = j*G + r%G — no
//     [B, KV, L*G, D] transpose is materialized.
//   - the TPU grid's sequential table axis (VMEM scratch carried across
//     grid steps) becomes a loop over table slots inside the block; each
//     block reads table[b, t] itself instead of a scalar prefetch.
//   - each [bs, D] K and V block is staged in shared memory as f32; m, l
//     and the per-row correction live in shared memory, the accumulator
//     in registers (each thread owns columns tid and tid + kThreads).
//   - query rows are tiled over the grid, so no bound on L*G exists here
//     (the TPU kernel's _MAX_Q_ROWS bound was its VMEM budget).
//   - a table slot is skipped outright when it is scratch, or when every
//     row of the tile is within one turn of the ring and the slot's
//     positions lie after the tile's last query or before its window.
//
// bf16 queries: the tensor-core kernel (paged_mma_kernel, fragment helpers
// in mma_tiles.cuh):
//   - a block holds 16 query rows per warp (r = l*G + g, as above); a key
//     tile gathers the 64 keys of as many pool blocks as hold them (4 at
//     bs = 16, 1 at bs = 64, 16 at bs = 4).  Each lane resolves the table
//     entries of two keys and shuffles the pool rows around, so no copy
//     waits on a table load of its own;
//   - K and V tiles are staged as bf16 in a 2-stage shared-memory ring by
//     16-byte cp.async copies, tile t + 1 in flight while tile t is used.
//     int8 pools copy payload and scales raw by cp.async a tile ahead (it
//     cannot transform), and the block dequantizes each tile in shared
//     memory with K1q's bits, (float)q * scale rounded to bf16;
//   - S = Q K^T and O += P V by mma.sync.m16n8k16 (bf16 in, f32
//     accumulators); the online softmax runs on the S fragments and p
//     enters PV from registers, rounded to bf16 (mma.sync rather than
//     wgmma: a decode block has 16 rows, and wgmma takes 64);
//   - decode (at most 16 rows per (kv head, lane)) splits the table into
//     chunks of split_slots (models/paged_attention.py) slots, one block
//     each, writing a partial (m, l, unnormalized acc) to f32 scratch; a
//     second kernel merges each row's chunks in chunk order.  An empty
//     chunk (scratch, past the query, before the window) holds m = -1e30,
//     l = 0; a row whose chunks are all empty finalizes to 0;
//   - prefill blocks of 8 warps hold 128 rows, and start heaviest first
//     (the last rows see the most keys) across every kv head.
//
// What bounds it on this card: decode (L = 1) is memory-bound — the bytes
// of the visible K/V blocks, read once, dominate; q and out are small.
// K1q reads half (bf16) of those bytes, plus 4 bytes of scale per
// (position, head).  Prefill at L = 512 is bound by operations.  The
// numbers are in PERF.md.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC
// and called through ctypes (tf_operator_tpu_torch/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int kRows = 16;          // query rows per thread block
constexpr int kThreads = 128;      // threads per block
constexpr int kColsPerThread = 2;  // head_dim <= kThreads * kColsPerThread
constexpr float kNegInf = -1e30f;  // the TPU kernel's running-max seed

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

// One K or V element as the products see it: float pools widen the
// element; int8 pools dequantize it, rounded to T (QTensor.dequantize into
// q's dtype) before widening.  `s` indexes the (position, head) scale.
template <typename T>
__device__ __forceinline__ float kv_value(const T* pool, const float*,
                                          long long g, long long) {
  return to_f32(pool[g]);
}
template <typename T>
__device__ __forceinline__ float kv_value(const signed char* pool,
                                          const float* scale, long long g,
                                          long long s) {
  return to_f32(from_f32<T>(static_cast<float>(pool[g]) * scale[s]));
}

// jnp.mod is floor modulo: the result takes the divisor's sign.  C's %
// truncates, and q - slot is negative for slots past the query.
__device__ __forceinline__ int floor_mod(int a, int r) {
  const int m = a % r;
  return m < 0 ? m + r : m;
}

// KT is the pools' element type: T (K1) or signed char (K1q, with the
// k_scale/v_scale pools; nullptr for K1).
template <typename T, typename KT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ pos, T* __restrict__ out, int L, int G, int KV,
    int D, int bs, int n_slots, long long sq_b, long long sq_l,
    long long sq_h, long long so_b, long long so_l, long long so_h,
    int window, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;  // padded row stride: score reads hit distinct banks
  float* qs = smem;                  // [kRows][D]
  float* ks = qs + kRows * D;        // [bs][dp]
  float* vs = ks + bs * dp;          // [bs][dp]
  float* ss = vs + bs * dp;          // [kRows][bs] scores, then rounded p
  float* m_s = ss + kRows * bs;      // [kRows] running max
  float* l_s = m_s + kRows;          // [kRows] running sum
  float* c_s = l_s + kRows;          // [kRows] this slot's correction

  const int tid = threadIdx.x;
  const int j = blockIdx.y;  // kv head
  const int b = blockIdx.z;  // lane
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, L * G - r0);
  const int base = pos[b];
  const int ring = n_slots * bs;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float v = 0.f;
    if (r < rows) {
      const int row = r0 + r;
      v = to_f32(q[b * sq_b + (row / G) * sq_l + (j * G + row % G) * sq_h +
                   d]);
    }
    qs[i] = v;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    c_s[tid] = 1.f;
  }
  float acc[kRows][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;
  }
  // query positions of the tile's first and last rows (row r is l = r/G)
  const int q_lo = base + r0 / G;
  const int q_hi = base + (r0 + rows - 1) / G;
  __syncthreads();

  for (int t = 0; t < n_slots; ++t) {
    const int block_id = table[static_cast<long long>(b) * n_slots + t];
    if (block_id == 0) continue;  // scratch: every score masked
    if (q_hi < ring) {
      // every query is within one turn of the ring: slot s is visible to
      // q exactly when q - window < s <= q
      const int s_lo = t * bs, s_hi = t * bs + bs - 1;
      if (s_lo > q_hi) continue;
      if (window > 0 && s_hi <= q_lo - window) continue;
    }
    const long long blk = static_cast<long long>(block_id) * bs;
    for (int i = tid; i < bs * D; i += kThreads) {
      const int o = i / D, d = i % D;
      const long long sidx = (blk + o) * KV + j;  // (position, head)
      const long long g = sidx * D + d;
      ks[o * dp + d] = kv_value<T>(k_pool, k_scale, g, sidx);
      vs[o * dp + d] = kv_value<T>(v_pool, v_scale, g, sidx);
    }
    __syncthreads();

    for (int i = tid; i < kRows * bs; i += kThreads) {
      const int r = i / bs, o = i % bs;
      float s = -INFINITY;  // marks a masked score
      if (r < rows) {
        const int qp = base + (r0 + r) / G;
        const int kg = qp - floor_mod(qp - (t * bs + o), ring);
        if (kg >= 0 && (window <= 0 || kg > qp - window)) {
          const float* qr = qs + r * D;
          const float* kr = ks + o * dp;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot * scale;
        }
      }
      ss[i] = s;
    }
    __syncthreads();

    if (tid < rows) {
      float* sr = ss + tid * bs;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int o = 0; o < bs; ++o) m_new = fmaxf(m_new, sr[o]);
      float psum = 0.f;
      for (int o = 0; o < bs; ++o) {
        // masked probabilities are zeroed explicitly: while m is still
        // the -1e30 seed, exp(s - m) of a masked score would not vanish
        const float p = sr[o] == -INFINITY ? 0.f : expf(sr[o] - m_new);
        psum += p;
        sr[o] = to_f32(from_f32<T>(p));  // p in V's type for the PV product
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + psum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int d = tid + c * kThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const float* pr = ss + r * bs;
            float pv = 0.f;
            for (int o = 0; o < bs; ++o) pv = fmaf(pr[o], vs[o * dp + d], pv);
            acc[r][c] = acc[r][c] * c_s[r] + pv;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int d = tid + c * kThreads;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float l = l_s[r];
          const int row = r0 + r;
          // an all-masked row (frozen lane) has l == 0 and finalizes to 0
          out[b * so_b + (row / G) * so_l + (j * G + row % G) * so_h + d] =
              from_f32<T>(acc[r][c] / (l == 0.f ? 1.f : l));
        }
      }
    }
  }
}

size_t smem_bytes(int D, int bs) {
  return sizeof(float) *
         (static_cast<size_t>(kRows) * D + 2ull * bs * (D + 1) +
          static_cast<size_t>(kRows) * bs + 3ull * kRows);
}

// ----------------------------------------------- K1/K1q, tensor cores
constexpr int kKeys = 64;       // keys per tile
constexpr int kSplitRows = 16;  // at most this many rows per (kv head,
                                // lane) may split the table into chunks
// above kSplitRows rows: blocks of kPrefillWarps warps of 16 rows, 128
// rows a block, so each key tile is staged, and dequantized, once for 128
// rows.  (Four warps of 32 rows hold as many but spill: measured slower,
// K1q most.)
constexpr int kPrefillWarps = 8;

struct MmaArgs {
  const __nv_bfloat16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;  // int8 pools only
  const float* v_scale;
  const int* table;
  const int* pos;
  __nv_bfloat16* out;
  // split: per (lane, kv head, chunk) p and row r < R = L*G, the partial
  // m at part[p*R + r], l at part[P*R + p*R + r] and the unnormalized
  // acc at part[2*P*R + (p*R + r)*D + d], P = B*KV*n_chunks
  float* part;
  int B, L, G, KV, D, bs, n_slots;
  long long sq_b, sq_l, sq_h, so_b, so_l, so_h;
  int window;
  float scale;
  int chunk_slots;  // table slots per chunk; n_slots when not split
  int n_chunks;     // 1 when not split
  int split;
  int vec;  // 16-byte copies: D, the q strides and the bases line up
  int raw;  // int8 payload staged raw by cp.async, then dequantized
};

// Blocks of kWarps warps of 16 rows.
template <int kD, int kWarps>
struct PagedSmem {
  static constexpr int kLd = kD + 8;
  static constexpr int kRowsB = 16 * kWarps;
  // q [kRowsB][kLd], K and V [2][kKeys][kLd] bf16; key positions
  // [2][kKeys]; int8: raw K and V [2][kKeys][kD] and scales [2][kKeys]
  static constexpr size_t kTiles =
      sizeof(__nv_bfloat16) * (kRowsB + 4 * kKeys) * kLd +
      sizeof(int) * 2 * kKeys;
  static constexpr size_t kRaw = 4 * kKeys * kD + sizeof(float) * 4 * kKeys;
  static size_t bytes(bool raw) { return kTiles + (raw ? kRaw : 0); }
};

// Stage the key tile at k0 of the block's (lane b, kv head j) into
// buffer st: each key's pool row (masked: block id 0, or past key_hi) and
// its position (-1 when masked).  Each lane of a warp resolves the table
// entries of keys lane and lane + 32 (two loads in flight together) and
// hands the pool rows around by shuffles, so no copy waits on a table
// load of its own.  bf16 pools copy by cp.async; int8 pools copy payload
// and scale raw (dequantized by dequant_tile) or, without raw, are
// dequantized element by element here; vec off: element loads.
template <typename KT, int kD, int kThr>
__device__ __forceinline__ void stage_keys(const MmaArgs& a, int b, int j,
                                           int k0, int key_hi, int st,
                                           __nv_bfloat16* ks,
                                           __nv_bfloat16* vs, int* kpos,
                                           signed char* kraw,
                                           signed char* vraw, float* ksc,
                                           float* vsc) {
  using bf16 = __nv_bfloat16;
  constexpr int ld = kD + 8;
  constexpr bool kInt8 = std::is_same<KT, signed char>::value;
  static_assert(kKeys == 64, "two keys per lane");
  const KT* kp = static_cast<const KT*>(a.k_pool);
  const KT* vp = static_cast<const KT*>(a.v_pool);
  const int* tbl = a.table + static_cast<long long>(b) * a.n_slots;
  const int lane = threadIdx.x % 32;
  // the key's pool row (position, head), or -1
  auto row_of = [&](int r) -> long long {
    const int kidx = k0 + r;
    if (kidx >= key_hi) return -1;
    const int blk = tbl[kidx / a.bs];
    if (blk == 0) return -1;
    return (static_cast<long long>(blk) * a.bs + kidx % a.bs) * a.KV + j;
  };
  const long long row_lo = row_of(lane), row_hi = row_of(lane + 32);
  // every lane of a warp runs the same iterations (the trip counts are
  // multiples of 32), so the shuffles see the whole warp
  auto row_at = [&](int r) -> long long {
    const long long lo = __shfl_sync(0xffffffffu, row_lo, r & 31);
    const long long hi = __shfl_sync(0xffffffffu, row_hi, r & 31);
    return r < 32 ? lo : hi;
  };
  bf16* kt = ks + st * kKeys * ld;
  bf16* vt = vs + st * kKeys * ld;
  if (a.vec && (!kInt8 || a.raw)) {
    constexpr int kPiece = 16 / sizeof(KT);  // elements per 16 bytes
    constexpr int kPieces = kD / kPiece;
    for (int i = threadIdx.x; i < kKeys * kPieces; i += kThr) {
      const int r = i / kPieces, c = i % kPieces;
      const long long row = row_at(r);
      const bool live = row >= 0 && c * kPiece < a.D;
      const long long off = live ? row * a.D + c * kPiece : 0;
      const int n = live ? 16 : 0;
      if constexpr (kInt8) {
        const int at = (st * kKeys + r) * kD + c * kPiece;
        mma_tiles::cp_async_16(kraw + at, kp + off, n);
        mma_tiles::cp_async_16(vraw + at, vp + off, n);
        if (c == 0) {
          const long long sr = row < 0 ? 0 : row;
          mma_tiles::cp_async_4(ksc + st * kKeys + r, a.k_scale + sr, n / 4);
          mma_tiles::cp_async_4(vsc + st * kKeys + r, a.v_scale + sr, n / 4);
        }
      } else {
        mma_tiles::cp_async_16(kt + r * ld + c * kPiece, kp + off, n);
        mma_tiles::cp_async_16(vt + r * ld + c * kPiece, vp + off, n);
      }
      if (c == 0) kpos[st * kKeys + r] = row < 0 ? -1 : k0 + r;
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * kD; i += kThr) {
      const int r = i / kD, d = i % kD;
      const long long row = row_at(r);
      float kx = 0.f, vx = 0.f;
      if (row >= 0 && d < a.D) {
        kx = kv_value<bf16>(kp, a.k_scale, row * a.D + d, row);
        vx = kv_value<bf16>(vp, a.v_scale, row * a.D + d, row);
      }
      kt[r * ld + d] = __float2bfloat16(kx);  // exact: already bf16 values
      vt[r * ld + d] = __float2bfloat16(vx);
      if (d == 0) kpos[st * kKeys + r] = row < 0 ? -1 : k0 + r;
    }
  }
}

// int8 raw stage st -> bf16 K and V tiles st: (float)q * scale rounded to
// bf16, K1q's dequantization bits.  Masked keys were zero-filled (payload
// and scale), so they become 0.
template <int kD, int kThr>
__device__ __forceinline__ void dequant_tile(int st, __nv_bfloat16* ks,
                                             __nv_bfloat16* vs,
                                             const signed char* kraw,
                                             const signed char* vraw,
                                             const float* ksc,
                                             const float* vsc) {
  constexpr int ld = kD + 8;
  for (int i = threadIdx.x; i < kKeys * kD / 4; i += kThr) {
    const int r = i / (kD / 4), d = (i % (kD / 4)) * 4;
    const int at = (st * kKeys + r) * kD + d;
    const char4 kq = *reinterpret_cast<const char4*>(kraw + at);
    const char4 vq = *reinterpret_cast<const char4*>(vraw + at);
    const float kscale = ksc[st * kKeys + r], vscale = vsc[st * kKeys + r];
    __nv_bfloat162* kd = reinterpret_cast<__nv_bfloat162*>(
        ks + (st * kKeys + r) * ld + d);
    __nv_bfloat162* vd = reinterpret_cast<__nv_bfloat162*>(
        vs + (st * kKeys + r) * ld + d);
    kd[0] = __floats2bfloat162_rn(static_cast<float>(kq.x) * kscale,
                                  static_cast<float>(kq.y) * kscale);
    kd[1] = __floats2bfloat162_rn(static_cast<float>(kq.z) * kscale,
                                  static_cast<float>(kq.w) * kscale);
    vd[0] = __floats2bfloat162_rn(static_cast<float>(vq.x) * vscale,
                                  static_cast<float>(vq.y) * vscale);
    vd[1] = __floats2bfloat162_rn(static_cast<float>(vq.z) * vscale,
                                  static_cast<float>(vq.w) * vscale);
  }
}

// One block per (row tile, chunk, kv head) and lane; kWarps warps of 16
// rows r = l*G + g each.  The block walks the key tiles of its chunk that
// can hold a visible key, tile t + 1 in flight while tile t is used.
template <typename KT, int kD, int kWarps>
__global__ void __launch_bounds__(32 * kWarps) paged_mma_kernel(MmaArgs a) {
  using bf16 = __nv_bfloat16;
  using Smem = PagedSmem<kD, kWarps>;
  constexpr int kThr = 32 * kWarps, kRowsB = Smem::kRowsB, ld = Smem::kLd;
  constexpr bool kInt8 = std::is_same<KT, signed char>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRowsB][ld]
  bf16* ks = qs + kRowsB * ld;                    // [2][kKeys][ld]
  bf16* vs = ks + 2 * kKeys * ld;                 // [2][kKeys][ld]
  int* kpos = reinterpret_cast<int*>(vs + 2 * kKeys * ld);  // [2][kKeys]
  signed char* kraw = reinterpret_cast<signed char*>(kpos + 2 * kKeys);
  signed char* vraw = kraw + 2 * kKeys * kD;                // [2][kKeys][kD]
  float* ksc = reinterpret_cast<float*>(vraw + 2 * kKeys * kD);  // [2][kKeys]
  float* vsc = ksc + 2 * kKeys;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // blockIdx.x runs over (row tile, chunk, kv head), kv head fastest, row
  // tiles from the last: the last rows see the most keys, so the longest
  // blocks start first, across every kv head
  const int R = a.L * a.G, n_tiles = (R + kRowsB - 1) / kRowsB;
  const int j = blockIdx.x % a.KV, b = blockIdx.z;
  const int chunk = (blockIdx.x / a.KV) % a.n_chunks;
  const int r0 = (n_tiles - 1 - blockIdx.x / (a.KV * a.n_chunks)) * kRowsB;
  const int rows = min(kRowsB, R - r0);
  const int base = a.pos[b], ring = a.n_slots * a.bs;
  const int key_lo = chunk * a.chunk_slots * a.bs;
  const int key_hi = min(key_lo + a.chunk_slots * a.bs, ring);
  const int q_lo = base + r0 / a.G, q_hi = base + (r0 + rows - 1) / a.G;
  // every query within one turn of the ring: key position p (its linear
  // slot) is visible to q exactly when q - window < p <= q
  const bool within = q_hi < ring;
  int lo = key_lo, hi = key_hi;
  if (within) {
    hi = min(hi, q_hi + 1);
    if (a.window > 0) lo = max(lo, q_lo - a.window + 1);
  }
  const int t_first = lo < hi ? (lo - key_lo) / kKeys : 0;
  const int n_t = lo < hi ? (hi - 1 - key_lo) / kKeys - t_first + 1 : 0;
  const int k_first = key_lo + t_first * kKeys;

  // the block's query rows as bf16, zero past R and past D
  for (int i = threadIdx.x; i < kRowsB * (kD / 8); i += kThr) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8, row = r0 + r;
    const bool live = r < rows && c < a.D;
    const bf16* src = a.q + b * a.sq_b + (row / a.G) * a.sq_l +
                      (j * a.G + row % a.G) * a.sq_h + c;
    if (a.vec) {
      mma_tiles::cp_async_16(qs + r * ld + c, live ? src : a.q, live ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qs[r * ld + c + e] = (live && c + e < a.D) ? src[e]
                                                   : __float2bfloat16(0.f);
      }
    }
  }
  if (n_t > 0) {
    stage_keys<KT, kD, kThr>(a, b, j, k_first, key_hi, 0, ks, vs, kpos, kraw,
                             vraw, ksc, vsc);
  }
  mma_tiles::cp_async_commit();

  const int g = lane / 4, tq = lane % 4;
  const int wr = r0 + warp * 16;  // the warp's first row
  const bool warp_rows = wr < R;
  const int wq_lo = base + wr / a.G;
  const int wq_hi = base + min(wr + 15, R - 1) / a.G;
  // query positions of the thread's rows g and g + 8
  const int qp[2] = {base + (wr + g) / a.G, base + (wr + g + 8) / a.G};
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_t; ++i) {
    const int st = i & 1, k0 = k_first + i * kKeys;
    if (i + 1 < n_t) {
      stage_keys<KT, kD, kThr>(a, b, j, k0 + kKeys, key_hi, st ^ 1, ks, vs,
                               kpos, kraw, vraw, ksc, vsc);
    }
    mma_tiles::cp_async_commit();
    mma_tiles::cp_async_wait<1>();  // all but tile i + 1 have landed
    __syncthreads();
    if (kInt8 && a.raw) {
      dequant_tile<kD, kThr>(st, ks, vs, kraw, vraw, ksc, vsc);
      __syncthreads();
    }

    // a warp whose rows see none of the tile keeps m, l and o as they are
    bool live = warp_rows;
    if (within) {
      live = live && k0 <= wq_hi &&
             (a.window <= 0 || k0 + kKeys - 1 > wq_lo - a.window);
    }
    if (live) {
      float s[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      mma_tiles::qk_tile<kD, kKeys / 8>(s, qs + warp * 16 * ld, ld,
                                        ks + st * kKeys * ld, ld, lane);
      const int* kp = kpos + st * kKeys;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pk = kp[n * 8 + 2 * tq + (e & 1)];
          const int q = qp[e >> 1];
          bool vis;
          if (within) {
            vis = pk >= 0 && pk <= q && (a.window <= 0 || pk > q - a.window);
          } else {
            const int kg = q - floor_mod(q - pk, ring);
            vis = pk >= 0 && kg >= 0 && (a.window <= 0 || kg > q - a.window);
          }
          s[n][e] = vis ? s[n][e] * a.scale : -INFINITY;
        }
      }
      uint32_t p[kKeys / 16][4];
      mma_tiles::softmax_step<kD, kKeys / 8>(s, m, l, o, p);
      mma_tiles::pv_tile<kD, kKeys / 16>(o, p, vs + st * kKeys * ld, ld, lane);
    }
    __syncthreads();  // buffer st is refilled in the next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + g + 8 * i;
    if (row >= R) continue;
    if (a.split) {
      const long long P = static_cast<long long>(a.B) * a.KV * a.n_chunks;
      const long long pr =
          ((static_cast<long long>(b) * a.KV + j) * a.n_chunks + chunk) * R +
          row;
      if (tq == 0) {
        a.part[pr] = m[i];
        a.part[P * R + pr] = l[i];
      }
      float* acc = a.part + 2 * P * R + pr * a.D;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + 2 * tq + e;
          if (d < a.D) acc[d] = o[n][2 * i + e];
        }
      }
    } else {
      // an all-masked row (frozen lane) has l == 0 and finalizes to 0
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
      bf16* dst = a.out + b * a.so_b + (row / a.G) * a.so_l +
                  (j * a.G + row % a.G) * a.so_h;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + 2 * tq + e;
          if (d < a.D) dst[d] = __float2bfloat16(o[n][2 * i + e] / l_safe);
        }
      }
    }
  }
}

// The decode split's second pass: each row's chunk partials merged in
// chunk order (fixed, so repeats are bit-identical).  A chunk with no
// visible key holds m = -1e30, l = 0, acc = 0 and adds nothing; a row
// whose chunks are all empty finalizes to 0.  KT (the pools' payload)
// only names the kernel after its first pass, K1's or K1q's.
template <typename KT>
__global__ void __launch_bounds__(128) paged_merge_kernel(MmaArgs a) {
  const int j = blockIdx.x, b = blockIdx.y, R = a.L * a.G, C = a.n_chunks;
  const long long P = static_cast<long long>(a.B) * a.KV * C;
  const long long p0 = (static_cast<long long>(b) * a.KV + j) * C;
  const float* pm = a.part;
  const float* pl = a.part + P * R;
  const float* pa = a.part + 2 * P * R;
  for (int i = threadIdx.x; i < R * a.D; i += blockDim.x) {
    const int r = i / a.D, d = i % a.D;
    float mx = kNegInf;
    for (int c = 0; c < C; ++c) mx = fmaxf(mx, pm[(p0 + c) * R + r]);
    float lsum = 0.f, acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const long long pr = (p0 + c) * R + r;
      const float w = expf(pm[pr] - mx);
      lsum += pl[pr] * w;
      acc += pa[pr * a.D + d] * w;
    }
    a.out[b * a.so_b + (r / a.G) * a.so_l + (j * a.G + r % a.G) * a.so_h +
          d] = __float2bfloat16(acc / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename KT, int kD, int kWarps>
int launch_mma_k(MmaArgs a, cudaStream_t stream) {
  using Smem = PagedSmem<kD, kWarps>;
  constexpr bool kInt8 = std::is_same<KT, signed char>::value;
  // raw staging: whole 16-byte pieces of payload, and room for them
  a.raw = kInt8 && a.vec && a.D % 16 == 0 && kD <= 128 ? 1 : 0;
  const size_t smem = Smem::bytes(a.raw);
  auto kernel = paged_mma_kernel<KT, kD, kWarps>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int R = a.L * a.G;
  const dim3 grid(((R + Smem::kRowsB - 1) / Smem::kRowsB) * a.n_chunks * a.KV,
                  1, a.B);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !a.split) return static_cast<int>(e);
  paged_merge_kernel<KT><<<dim3(a.KV, a.B), 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT, int kWarps>
int launch_mma_w(const MmaArgs& a, cudaStream_t stream) {
  if (a.D <= 16) return launch_mma_k<KT, 16, kWarps>(a, stream);
  if (a.D <= 32) return launch_mma_k<KT, 32, kWarps>(a, stream);
  if (a.D <= 64) return launch_mma_k<KT, 64, kWarps>(a, stream);
  if (a.D <= 128) return launch_mma_k<KT, 128, kWarps>(a, stream);
  return launch_mma_k<KT, 256, kWarps>(a, stream);
}

// bf16 queries: one warp of 16 rows per block when a (kv head, lane) has
// at most kSplitRows rows (decode, split over the table when chunk_slots
// > 0); above that, kPrefillWarps warps.
template <typename KT>
int launch_mma(MmaArgs a, cudaStream_t stream) {
  const int R = a.L * a.G;
  if (a.chunk_slots > 0) {
    if (R > kSplitRows || a.part == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.split = 1;
    a.n_chunks = (a.n_slots + a.chunk_slots - 1) / a.chunk_slots;
  } else {
    a.split = 0;
    a.n_chunks = 1;
    a.chunk_slots = a.n_slots;
  }
  if (R <= kSplitRows) return launch_mma_w<KT, 1>(a, stream);
  return launch_mma_w<KT, kPrefillWarps>(a, stream);
}

template <typename T, typename KT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* table,
           const int* pos, void* out, int B, int L, int H, int KV, int D,
           int bs, int n_slots, long long sq_b, long long sq_l,
           long long sq_h, long long so_b, long long so_l, long long so_h,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, bs);
  auto kernel = paged_attention_kernel<T, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int G = H / KV;
  const dim3 grid((L * G + kRows - 1) / kRows, KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), k_scale, v_scale, table, pos,
      static_cast<T*>(out), L, G, KV, D, bs, n_slots, sq_b, sq_l, sq_h, so_b,
      so_l, so_h, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Both entry points: payload type KT (T for K1, signed char for K1q),
// q/out type chosen by dtype (0 = float32: the scalar kernel above; 1 =
// bfloat16: the tensor-core kernel, split over the table in chunks of
// chunk_slots slots when chunk_slots > 0, with part its f32 scratch).
template <bool kInt8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* table,
             const void* pos, void* out, void* part, int B, int L, int H,
             int KV, int D, int bs, int n_slots, int chunk_slots,
             long long sq_b, long long sq_l, long long sq_h, long long so_b,
             long long so_l, long long so_h, int window, float scale,
             int dtype, void* stream) {
  if (D > kThreads * kColsPerThread || H % KV != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* tbl = static_cast<const int*>(table);
  const auto* ps = static_cast<const int*>(pos);
  const auto* ksc = static_cast<const float*>(k_scale);
  const auto* vsc = static_cast<const float*>(v_scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using KT = typename std::conditional<kInt8, signed char, float>::type;
    return launch<float, KT>(q, k_pool, v_pool, ksc, vsc, tbl, ps, out, B,
                             L, H, KV, D, bs, n_slots, sq_b, sq_l, sq_h,
                             so_b, so_l, so_h, window, scale, st);
  }
  if (dtype == 1) {
    MmaArgs a = {};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k_pool = k_pool;
    a.v_pool = v_pool;
    a.k_scale = ksc;
    a.v_scale = vsc;
    a.table = tbl;
    a.pos = ps;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.part = static_cast<float*>(part);
    a.B = B;
    a.L = L;
    a.G = H / KV;
    a.KV = KV;
    a.D = D;
    a.bs = bs;
    a.n_slots = n_slots;
    a.sq_b = sq_b; a.sq_l = sq_l; a.sq_h = sq_h;
    a.so_b = so_b; a.so_l = so_l; a.so_h = so_h;
    a.window = window;
    a.scale = scale;
    a.chunk_slots = chunk_slots;
    // 16-byte copies: D and q's strides in whole 8-element pieces, bases
    // 16-byte aligned (pool rows are then aligned too)
    a.vec = D % 8 == 0 && sq_b % 8 == 0 && sq_l % 8 == 0 && sq_h % 8 == 0 &&
            (reinterpret_cast<uintptr_t>(q) |
             reinterpret_cast<uintptr_t>(k_pool) |
             reinterpret_cast<uintptr_t>(v_pool)) % 16 == 0;
    if (kInt8) return launch_mma<signed char>(a, st);
    return launch_mma<__nv_bfloat16>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Largest head_dim the kernel takes, and its shared-memory need; the
// wrapper checks both before launching.
int paged_attention_max_head_dim() { return kThreads * kColsPerThread; }

long long paged_attention_smem_bytes(int D, int bs) {
  return static_cast<long long>(smem_bytes(D, bs));
}

// K1.  dtype: 0 = float32, 1 = bfloat16.  window <= 0 means full causal.
// Strides are in elements; q and out have unit stride on the last dim,
// the pools are contiguous [N+1, bs, KV, D], table [B, n_slots] and
// pos [B] are contiguous int32.  Returns the launch's cudaError_t.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* pos, void* out, void* part, int B,
                           int L, int H, int KV, int D, int bs, int n_slots,
                           int chunk_slots, long long sq_b, long long sq_l,
                           long long sq_h, long long so_b, long long so_l,
                           long long so_h, int window, float scale,
                           int dtype, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, table, pos, out,
                         part, B, L, H, KV, D, bs, n_slots, chunk_slots, sq_b,
                         sq_l, sq_h, so_b, so_l, so_h, window, scale, dtype,
                         stream);
}

// K1q: as K1, with int8 payload pools [N+1, bs, KV, D] and contiguous f32
// scale pools [N+1, bs, KV, 1]; dtype is q's and out's.
int paged_attention_int8_launch(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* table,
                                const void* pos, void* out, void* part,
                                int B, int L, int H, int KV, int D, int bs,
                                int n_slots, int chunk_slots, long long sq_b,
                                long long sq_l, long long sq_h,
                                long long so_b, long long so_l,
                                long long so_h, int window, float scale,
                                int dtype, void* stream) {
  return dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, table, pos, out,
                        part, B, L, H, KV, D, bs, n_slots, chunk_slots, sq_b,
                        sq_l, sq_h, so_b, so_l, so_h, window, scale, dtype,
                        stream);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
