// Blocked causal / sliding-window GQA attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py, `_kernel`): for
// each query row, softmax(q . k^T * scale) . v over the keys it may see,
// with an online softmax that keeps the running max m, the running sum l
// and the output accumulator in float32, so the (Sq, Skv) score matrix
// never reaches device memory. Query head h reads KV head h * Hkv / H: the
// grouped heads share one copy of K and V, with no repeated-KV tensor.
//
//   key j is visible to query i (global position i + q_offset) iff
//     j < Skv  and  (!causal or j <= i + q_offset)
//              and  (!window or j >  i + q_offset - window)
//
// Bound: at the serving shapes (S up to 1,024, head_dim 128) the work is
// 4 * S^2/2 * D operations per (b, h) against 4 * S * D bytes of bf16
// input, far above the H100's 295 operations per byte: bound by
// operations. This first version computes in float32 on the CUDA cores
// (no tensor cores), so it sits far from the bf16 tensor-core bound; the
// numbers are in PERF.md. wgmma, TMA and warp specialisation are later
// work.
//
// Design: one CTA of 128 threads per (64-query tile, head, batch row),
// heaviest causal tiles launched first. The query tile and each 32-key
// tile of K and V are staged in shared memory as float32 (rows padded by
// one float, so the column walks are free of bank conflicts). Each thread
// owns a 4 x 4 block of the score tile and 4 rows x D/8 columns of the
// accumulator; a row's max and sum are reduced over its 8 threads with
// warp shuffles. Differences from the Pallas kernel, none of which
// changes the result on rows that see at least one key:
//   * keys are masked by length (j < Skv), so S need not be a multiple of
//     the tile and the wrapper neither pads nor slices;
//   * key tiles that lie wholly outside the causal / window band of the
//     query tile are skipped;
//   * tensors are read through their strides, in the model's (B, S, H, D)
//   layout, with no transposes.
// The final division is by max(l, 1e-30), as in the Pallas kernel.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../tiles.cuh"

namespace {

using tiles::from_f32;
using tiles::load_rows;
using tiles::to_f32;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kThreads = 128;      // 16 row groups x 8 column lanes
constexpr int kBQ = 64;            // query rows per CTA (16 x 4)
constexpr int kBK = 32;            // keys per tile (8 x 4)

// Element strides of the batch, sequence and head axes of a (B, S, H, D)
// tensor; the head_dim axis has stride 1.
struct Strides {
  int64_t b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (D + 1) + 2 * kBK * (D + 1) +
          kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           int n_heads, int n_kv_heads, int q_len,
                           int kv_len, int q_offset, int causal, int window,
                           float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x (D + 1)
  float* ks = qs + kBQ * (D + 1);    // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);    // kBK x (D + 1)
  float* ps = vs + kBK * (D + 1);    // kBQ x (kBK + 1): probabilities

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h * n_kv_heads / n_heads;
  const int ty = threadIdx.x / 8;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = threadIdx.x % 8;  // score columns tx + 8j, acc columns
                                   // tx + 8c

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  const int q_rows = min(kBQ, q_len - q0);
  load_rows<T, D>(qs, qb + q0 * sq.s, sq.s, kBQ, q_rows);

  // the keys some row of this tile may see: [k_begin, k_end)
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + q_rows - 1 + q_offset + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  constexpr int kCols = D / 8;
  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int valid = min(kBK, kv_len - k0);
    load_rows<T, D>(ks, kb + k0 * sk.s, sk.s, kBK, valid);
    load_rows<T, D>(vs, vb + k0 * sv.s, sv.s, kBK, valid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool ok = kp < kv_len;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 8 threads are lanes that differ in their low 3 bits
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * (kBK + 1) + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[j * (D + 1) + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row < q_rows) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = ob + (q0 + row) * so.s;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        orow[tx + 8 * c] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* o, const int64_t* st, int batch, int n_heads,
                         int n_kv_heads, int q_len, int kv_len, int q_offset,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid((q_len + kBQ - 1) / kBQ, n_heads, batch);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, n_heads,
      n_kv_heads, q_len, kv_len, q_offset, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, void* o, const int64_t* st, int batch,
                       int n_heads, int n_kv_heads, int q_len, int kv_len,
                       int q_offset, int causal, int window, float scale,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_typed<T, 32>(q, k, v, o, st, batch, n_heads, n_kv_heads,
                                 q_len, kv_len, q_offset, causal, window,
                                 scale, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, st, batch, n_heads, n_kv_heads,
                                 q_len, kv_len, q_offset, causal, window,
                                 scale, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, o, st, batch, n_heads,
                                  n_kv_heads, q_len, kv_len, q_offset,
                                  causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, Hkv, D), o (B, Sq, H, D), all of one
// dtype (0: float32, 1: bfloat16), read and written through the 12 element
// strides in `strides` (batch, sequence, head of q, k, v, o in turn).
// Launches on `stream` and returns a CUDA error code: 0 when the launch was
// accepted. The caller checks shapes, types, devices and alignment.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides, int batch,
                                      int n_heads, int n_kv_heads, int q_len,
                                      int kv_len, int head_dim, int dtype,
                                      int q_offset, int causal, int window,
                                      float scale, void* stream) {
  if (batch <= 0 || q_len <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(head_dim, q, k, v, o, strides, batch, n_heads,
                            n_kv_heads, q_len, kv_len, q_offset, causal,
                            window, scale, s);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(head_dim, q, k, v, o, strides, batch,
                                    n_heads, n_kv_heads, q_len, kv_len,
                                    q_offset, causal, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
