// Single-token decode attention against a KV cache for Hopper (sm_90a),
// split-KV (flash-decoding).
//
// Replaces the Pallas TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention/decode_attention.py, `_kernel`): one
// query token per sequence attends to its cache rows k with
//
//   k < pos[b]  and  (!window or k >= pos[b] - window),
//
// where pos[b] is the sequence's valid length, read on the device. The G =
// H / Hkv query heads of a group share one cache head. The online softmax
// keeps m, l and the accumulator in float32.
//
// Bound: bytes. Each visible cache row is read once for K and once for V
// (2 * Hkv * D elements per position) against 4 * H * D operations per
// position: a few operations per byte, far below the H100's 295.
//
// Design: the Pallas kernel walks the cache of one sequence in one grid
// row; at batch 4 that would be 4 CTAs on 132 SMs. Here the grid is
// (n_split, Hkv, B): the visible range [lo, hi) of a sequence is cut into
// n_split equal slices, computed on the device from pos, so only rows that
// hold visible positions are read and no CTA waits on a host copy of pos.
// A CTA of 128 threads holds its group's G query rows in shared memory and
// walks its slice in tiles of 64 keys: K and V rows are loaded with 16-byte
// reads and kept as float32 (rows padded by one float against bank
// conflicts), one thread per (head, key) computes a score, one warp per
// head updates (m, l), and one thread per (head, column) the accumulator.
// Each CTA writes its float32 partials (acc, m, l) to a workspace; a second
// launch merges the n_split partials of every (b, h):
//
//   M = max m_i,  l = sum l_i e^(m_i - M),  o = sum acc_i e^(m_i - M) / l,
//
// dividing by max(l, 1e-30) as the Pallas kernel does. A slice with no
// visible key leaves (m, l, acc) = (-1e30, 0, 0), which the merge weighs
// by zero. A sequence with no visible key at all (pos = 0) gives 0 here,
// where the Pallas kernel gives the mean of the whole cache; the model
// never asks for that row (it attends with pos + 1 >= 1).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../tiles.cuh"

namespace {

using tiles::from_f32;
using tiles::load_rows;
using tiles::to_f32;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;        // keys per tile: two per lane of a warp
constexpr int kMaxGroups = 16;  // query heads per cache head

// Element strides: q and o (B, H, D) by batch and head; the caches
// (B, S, Hkv, D) by batch, position and head. The head_dim axis has
// stride 1.
struct Strides {
  int64_t q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h;
};

template <int D>
constexpr size_t split_smem_bytes(int groups) {
  return sizeof(float) * (2 * static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(groups) * (D + kBK + 3));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l, Strides st, int n_heads,
                        int n_kv_heads, int max_len, int window,
                        int n_split, float scale) {
  extern __shared__ float smem[];
  const int groups = n_heads / n_kv_heads;
  float* ks = smem;                 // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);   // kBK x (D + 1)
  float* qs = vs + kBK * (D + 1);   // groups x D
  float* ps = qs + groups * D;      // groups x kBK: scores, then probs
  float* ms = ps + groups * kBK;    // groups: running max
  float* ls = ms + groups;          // groups: running sum
  float* as = ls + groups;          // groups: this tile's rescale

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // this CTA's slice [s_lo, s_hi) of the visible range [lo, hi)
  const int p = pos[b];
  const int hi = min(p, max_len);
  const int lo = window > 0 ? max(0, p - window) : 0;
  const int len = max(hi - lo, 0);
  const int s_lo = lo + static_cast<int>(static_cast<int64_t>(len) * split /
                                         n_split);
  const int s_hi = lo + static_cast<int>(static_cast<int64_t>(len) *
                                         (split + 1) / n_split);

  for (int idx = tid; idx < groups * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    qs[idx] = to_f32(q[b * st.q_b + (hk * groups + g) * st.q_h + d]);
  }
  for (int g = tid; g < groups; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
  }

  // accumulator elements e = tid + kThreads * i of the (groups, D) block
  constexpr int kMaxAcc = (kMaxGroups * D + kThreads - 1) / kThreads;
  const int n_elems = groups * D;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.0f;

  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int k0 = s_lo; k0 < s_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int valid = min(kBK, s_hi - k0);
    load_rows<T, D>(ks, kb + k0 * st.k_s, st.k_s, kBK, valid);
    load_rows<T, D>(vs, vb + k0 * st.v_s, st.v_s, kBK, valid);
    __syncthreads();

    for (int idx = tid; idx < groups * kBK; idx += kThreads) {
      const int g = idx / kBK;
      const int j = idx % kBK;
      const float* qrow = qs + g * D;
      const float* krow = ks + j * (D + 1);
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
      ps[idx] = j < valid ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < groups; g += kWarps) {
      float* prow = ps + g * kBK;
      const float s0 = prow[lane];
      const float s1 = prow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + kThreads * i;
      if (e < n_elems) {
        const int g = e / D;
        const int d = e % D;
        const float* prow = ps + g * kBK;
        float a = acc[i] * as[g];
        for (int j = 0; j < kBK; ++j) a += prow[j] * vs[j * (D + 1) + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // ms and ls are final

  const int64_t slot =
      (static_cast<int64_t>(b) * n_kv_heads + hk) * n_split + split;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + kThreads * i;
    if (e < n_elems) part_acc[slot * n_elems + e] = acc[i];
  }
  for (int g = tid; g < groups; g += kThreads) {
    part_m[slot * groups + g] = ms[g];
    part_l[slot * groups + g] = ls[g];
  }
}

// One CTA per (h, b), one thread per column: merges the n_split partials.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      T* __restrict__ o, Strides st,
                                      int n_heads, int n_kv_heads,
                                      int n_split, int head_dim) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = n_heads / n_kv_heads;
  const int hk = h / groups;
  const int g = h % groups;
  const int64_t base =
      (static_cast<int64_t>(b) * n_kv_heads + hk) * n_split;
  float m_max = kNegInf;
  for (int sp = 0; sp < n_split; ++sp)
    m_max = fmaxf(m_max, part_m[(base + sp) * groups + g]);
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float l = 0.0f, a = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) {
      const int64_t slot = base + sp;
      const float w = expf(part_m[slot * groups + g] - m_max);
      l += part_l[slot * groups + g] * w;
      a += part_acc[(slot * groups + g) * head_dim + d] * w;
    }
    o[b * st.o_b + h * st.o_h + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* pos, float* part_acc, float* part_m,
                         float* part_l, void* o, const Strides& st,
                         int batch, int n_heads, int n_kv_heads,
                         int max_len, int window, int n_split, float scale,
                         cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(split_smem_bytes<D>(kMaxGroups)));
  if (attr != cudaSuccess) return attr;
  const int groups = n_heads / n_kv_heads;
  const dim3 grid(n_split, n_kv_heads, batch);
  decode_split_kernel<T, D>
      <<<grid, kThreads, split_smem_bytes<D>(groups), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), pos, part_acc, part_m, part_l, st,
          n_heads, n_kv_heads, max_len, window, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(n_heads, batch), D, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(o), st, n_heads, n_kv_heads,
      n_split, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, const int* pos, float* part_acc,
                       float* part_m, float* part_l, void* o,
                       const Strides& st, int batch, int n_heads,
                       int n_kv_heads, int max_len, int window, int n_split,
                       float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_typed<T, 32>(q, k, v, pos, part_acc, part_m, part_l, o,
                                 st, batch, n_heads, n_kv_heads, max_len,
                                 window, n_split, scale, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, pos, part_acc, part_m, part_l, o,
                                 st, batch, n_heads, n_kv_heads, max_len,
                                 window, n_split, scale, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, pos, part_acc, part_m, part_l, o,
                                  st, batch, n_heads, n_kv_heads, max_len,
                                  window, n_split, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D), caches (B, S, Hkv, D) and o (B, H, D) of one dtype (0:
// float32, 1: bfloat16), read and written through the 10 element strides in
// `strides` (q: batch, head; k and v: batch, position, head; o: batch,
// head); pos (B,) int32 on the device. The workspace holds
// B * Hkv * n_split * (H / Hkv) * (D + 2) floats: part_acc, part_m and
// part_l. Launches the split pass and the merge on `stream` and returns a
// CUDA error code: 0 when both launches were accepted. The caller checks
// shapes, types, devices, alignment and H / Hkv <= 16.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* pos,
                                       float* part_acc, float* part_m,
                                       float* part_l, void* o,
                                       const int64_t* strides, int batch,
                                       int n_heads, int n_kv_heads,
                                       int max_len, int head_dim, int dtype,
                                       int window, int n_split, float scale,
                                       void* stream) {
  if (batch <= 0 || n_heads <= 0) return static_cast<int>(cudaSuccess);
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kMaxGroups || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(head_dim, q, k, v, pos, part_acc, part_m, part_l,
                            o, st, batch, n_heads, n_kv_heads, max_len,
                            window, n_split, scale, s);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(head_dim, q, k, v, pos, part_acc,
                                    part_m, part_l, o, st, batch, n_heads,
                                    n_kv_heads, max_len, window, n_split,
                                    scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
