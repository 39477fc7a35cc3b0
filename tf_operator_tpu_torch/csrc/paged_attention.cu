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
// Design (simple and right first):
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
//   - query rows are tiled over the grid, so no bound on L*G exists here.
//     The TPU kernel's _MAX_Q_ROWS bound was its VMEM budget (q, the
//     accumulator and a score tile for the whole group in one program),
//     not a property of the function; here a block holds only kRows rows
//     and every read of a CUDA pool, prefill included, goes through this
//     kernel.
//   - a table slot is skipped outright when it is scratch, or when every
//     row of the tile is within one turn of the ring and the slot's
//     positions lie after the tile's last query or before its window:
//     such a slot would contribute only masked scores, which leave m, l
//     and the accumulator unchanged.
//
// What bounds it on this card: decode (L = 1) is memory-bound — the bytes
// of the visible K/V blocks, read once, dominate; q and out are small.
// This design leaves on the table: cp.async/TMA double-buffering of the
// next block while the current one is used, 16-byte vector loads,
// tensor-core (mma/wgmma) score and PV products, split-K across the table
// for long contexts at small batch, and keeping K/V in bf16 in shared
// memory.  Those are later work; the numbers are in PERF.md.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC
// and called through ctypes (tf_operator_tpu_torch/kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// jnp.mod is floor modulo: the result takes the divisor's sign.  C's %
// truncates, and q - slot is negative for slots past the query.
__device__ __forceinline__ int floor_mod(int a, int r) {
  const int m = a % r;
  return m < 0 ? m + r : m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
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
      const long long g = ((blk + o) * KV + j) * D + d;
      ks[o * dp + d] = to_f32(k_pool[g]);
      vs[o * dp + d] = to_f32(v_pool[g]);
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

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* pos, void* out, int B, int L, int H,
           int KV, int D, int bs, int n_slots, long long sq_b, long long sq_l,
           long long sq_h, long long so_b, long long so_l, long long so_h,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, bs);
  auto kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int G = H / KV;
  const dim3 grid((L * G + kRows - 1) / kRows, KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, pos, static_cast<T*>(out), L, G,
      KV, D, bs, n_slots, sq_b, sq_l, sq_h, so_b, so_l, so_h, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest head_dim the kernel takes, and its shared-memory need; the
// wrapper checks both before launching.
int paged_attention_max_head_dim() { return kThreads * kColsPerThread; }

long long paged_attention_smem_bytes(int D, int bs) {
  return static_cast<long long>(smem_bytes(D, bs));
}

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means full causal.
// Strides are in elements; q and out have unit stride on the last dim,
// the pools are contiguous [N+1, bs, KV, D], table [B, n_slots] and
// pos [B] are contiguous int32.  Returns the launch's cudaError_t.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* pos, void* out, int B, int L, int H,
                           int KV, int D, int bs, int n_slots,
                           long long sq_b, long long sq_l, long long sq_h,
                           long long so_b, long long so_l, long long so_h,
                           int window, float scale, int dtype, void* stream) {
  if (D > kThreads * kColsPerThread || H % KV != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* tbl = static_cast<const int*>(table);
  const auto* ps = static_cast<const int*>(pos);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k_pool, v_pool, tbl, ps, out, B, L, H, KV, D, bs,
                         n_slots, sq_b, sq_l, sq_h, so_b, so_l, so_h, window,
                         scale, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tbl, ps, out, B, L, H,
                                 KV, D, bs, n_slots, sq_b, sq_l, sq_h, so_b,
                                 so_l, so_h, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
