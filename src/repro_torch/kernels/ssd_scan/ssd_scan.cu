// Mamba2 chunked SSD scan (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan`
// (src/repro/kernels/ssd_scan/ssd_scan.py, `_kernel`). Per batch row b and
// head h, with A = -exp(a_log[h]) and a (P, N) float32 state S:
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,     y_t = S_t C_t
//
// computed chunk by chunk, as the Pallas kernel does: within a chunk of Q
// steps, with s the cumulative sum of dt A over the chunk,
//
//   y     = ((C B^T) o L) (x dt) + exp(s) o (C S^T),  L[i][j] = exp(s_i - s_j), j <= i
//   S    <- exp(s_Q) S + sum_j exp(s_Q - s_j) dt_j x_j B_j^T
//
// Bound: at the serving shape (one sequence of 1,024 tokens, 80 heads,
// P = 64, N = 128, bf16 x/B/C) the bytes to move (x and y, dt, B and C,
// the final state) take about 7 us at 3.35 TB/s and the operations of the
// chunked algebra about 5 us on the bf16 tensor cores: bound by bytes.
// This first version computes in float32 on the CUDA cores from shared
// memory, so it sits far from that bound (PERF.md); tensor-core products
// and C B^T shared over the heads are later work.
//
// Design: the Pallas grid (B, H, chunks) runs its chunk axis in order and
// keeps the state in VMEM scratch. Here blocks run in no order, so one CTA
// of 256 threads per (h, b) walks the chunks itself in a loop, with the
// state in shared memory for the whole sequence; it never reaches device
// memory except once at the end, when the caller asks for it. The chunk
// tile is kQ = 64 steps, whatever chunk the caller names: shared memory,
// not the TPU's 256, sets it (B and C tiles of 64 x 128 floats each, x, the
// masked score tile and the state: 130 KB at P = 64, N = 128, above the
// 48 KB default, opted in with cudaFuncSetAttribute). The chunked algebra
// is exact for any chunk length, so only rounding differs from chunk 256.
// Steps at or past `len` act as dt = 0 (decay 1, no update) and their rows
// of y are not written: the zero-dt padding of the Pallas wrapper without
// its copies. x, B and C are read through their strides, so the slices of
// the model's packed xBC tensor are read in place. Each thread owns a 4 x
// 4 block of the score tile, a 4 x P/16 block of y and a P/16 x N/16 block
// of the state (rows of shared memory padded by one float, so the column
// walks hit distinct banks).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../tiles.cuh"

namespace {

using tiles::from_f32;
using tiles::to_f32;

constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kQ = 64;         // steps per chunk tile (16 x 4)

// Element strides of the batch, sequence and head axes; the last axis (P
// or N) has stride 1. B and C have no head axis (h unused).
struct Strides {
  int64_t b, l, h;
};

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * static_cast<size_t>(kQ) * (N + 1) + kQ * (P + 1) +
          kQ * (kQ + 1) + P * (N + 1) + 4 * kQ);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log, const T* __restrict__ bm,
                    const T* __restrict__ cm, T* __restrict__ y,
                    float* __restrict__ state_out, Strides sx, Strides sdt,
                    Strides sb, Strides sc, Strides sy, int len,
                    int n_heads) {
  extern __shared__ float smem[];
  float* bs = smem;               // kQ x (N + 1): B of the chunk
  float* cs = bs + kQ * (N + 1);  // kQ x (N + 1): C of the chunk
  float* xs = cs + kQ * (N + 1);  // kQ x (P + 1): x of the chunk
  float* ms = xs + kQ * (P + 1);  // kQ x (kQ + 1): (C B^T) o L o dt
  float* ss = ms + kQ * (kQ + 1); // P x (N + 1): the carried state
  float* dts = ss + P * (N + 1);  // kQ: dt, 0 past len
  float* cum = dts + kQ;          // kQ: s_t
  float* ws = cum + kQ;           // kQ: exp(s_Q - s_t) dt_t
  float* ecum = ws + kQ;          // kQ: exp(s_t)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the score tile and y;
                            // state rows ty + 16i
  const int tx = tid % 16;  // columns tx + 16j
  constexpr int kPc = P / 16;
  constexpr int kNc = N / 16;

  const float A = -expf(a_log[h]);
  const T* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const T* bb = bm + b * sb.b;
  const T* cb = cm + b * sc.b;
  T* yb = y + b * sy.b + h * sy.h;

  for (int i = tid; i < P * (N + 1); i += kThreads) ss[i] = 0.0f;

  for (int t0 = 0; t0 < len; t0 += kQ) {
    const int valid = min(kQ, len - t0);
    __syncthreads();  // the previous chunk's readers of the tiles are done
    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int r = idx / N, col = idx % N;
      float bv = 0.0f, cv = 0.0f;
      if (r < valid) {
        bv = to_f32(bb[(t0 + r) * sb.l + col]);
        cv = to_f32(cb[(t0 + r) * sc.l + col]);
      }
      bs[r * (N + 1) + col] = bv;
      cs[r * (N + 1) + col] = cv;
    }
    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int r = idx / P, col = idx % P;
      xs[r * (P + 1) + col] =
          r < valid ? to_f32(xb[(t0 + r) * sx.l + col]) : 0.0f;
    }
    if (tid < kQ) dts[tid] = tid < valid ? dtb[(t0 + tid) * sdt.l] : 0.0f;
    __syncthreads();
    if (tid == 0) {  // s_t, summed in order as a cumulative sum does
      float s = 0.0f;
      for (int t = 0; t < kQ; ++t) {
        s += dts[t] * A;
        cum[t] = s;
      }
    }
    __syncthreads();
    const float s_last = cum[kQ - 1];
    if (tid < kQ) {
      ecum[tid] = expf(cum[tid]);
      ws[tid] = expf(s_last - cum[tid]) * dts[tid];
    }

    // the intra-chunk score tile: (C B^T)[i][j] L[i][j] dt_j, zero above
    // the diagonal (where exp would see a positive argument)
    {
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * (N + 1) + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * (N + 1) + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          ms[r * (kQ + 1) + col] =
              col <= r ? g[i][j] * expf(cum[r] - cum[col]) * dts[col] : 0.0f;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(s) o (C S^T), with S as it was before this chunk
    {
      float acc[4][kPc], off[4][kPc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kPc; ++c) acc[i][c] = off[i][c] = 0.0f;
      for (int j = 0; j < kQ; ++j) {
        float mv[4], xv[kPc];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = ms[(ty * 4 + i) * (kQ + 1) + j];
#pragma unroll
        for (int c = 0; c < kPc; ++c) xv[c] = xs[j * (P + 1) + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kPc; ++c) acc[i][c] += mv[i] * xv[c];
      }
      for (int k = 0; k < N; ++k) {
        float cv[4], sv[kPc];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * (N + 1) + k];
#pragma unroll
        for (int c = 0; c < kPc; ++c) sv[c] = ss[(tx + 16 * c) * (N + 1) + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kPc; ++c) off[i][c] += cv[i] * sv[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r < valid) {
          T* yrow = yb + (t0 + r) * sy.l;
#pragma unroll
          for (int c = 0; c < kPc; ++c)
            yrow[tx + 16 * c] = from_f32<T>(acc[i][c] + ecum[r] * off[i][c]);
        }
      }
    }
    __syncthreads();  // the readers of S are done

    // S <- exp(s_Q) S + sum_j exp(s_Q - s_j) dt_j x_j B_j^T
    {
      const float decay = expf(s_last);
      float upd[kPc][kNc];
#pragma unroll
      for (int i = 0; i < kPc; ++i)
#pragma unroll
        for (int m = 0; m < kNc; ++m) upd[i][m] = 0.0f;
      for (int j = 0; j < kQ; ++j) {
        const float wj = ws[j];
        float xv[kPc], bv[kNc];
#pragma unroll
        for (int i = 0; i < kPc; ++i) xv[i] = xs[j * (P + 1) + ty + 16 * i] * wj;
#pragma unroll
        for (int m = 0; m < kNc; ++m) bv[m] = bs[j * (N + 1) + tx + 16 * m];
#pragma unroll
        for (int i = 0; i < kPc; ++i)
#pragma unroll
          for (int m = 0; m < kNc; ++m) upd[i][m] += xv[i] * bv[m];
      }
#pragma unroll
      for (int i = 0; i < kPc; ++i)
#pragma unroll
        for (int m = 0; m < kNc; ++m) {
          float* s = ss + (ty + 16 * i) * (N + 1) + tx + 16 * m;
          *s = decay * *s + upd[i][m];
        }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + (static_cast<int64_t>(b) * n_heads + h) * P * N;
    for (int idx = tid; idx < P * N; idx += kThreads)
      so[idx] = ss[(idx / N) * (N + 1) + idx % N];
  }
}

template <typename T, int P, int N>
cudaError_t launch_typed(const void* x, const void* dt, const void* a_log,
                         const void* b, const void* c, void* y, void* state,
                         const int64_t* st, int batch, int len, int n_heads,
                         cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, N>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const Strides sx{st[0], st[1], st[2]}, sdt{st[3], st[4], st[5]},
      sb{st[6], st[7], 0}, sc{st[8], st[9], 0}, sy{st[10], st[11], st[12]};
  const dim3 grid(n_heads, batch);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), sx, sdt, sb, sc, sy, len, n_heads);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_state_dim(int state_dim, const void* x, const void* dt,
                             const void* a_log, const void* b, const void* c,
                             void* y, void* state, const int64_t* st,
                             int batch, int len, int n_heads,
                             cudaStream_t stream) {
  switch (state_dim) {
    case 32:
      return launch_typed<T, P, 32>(x, dt, a_log, b, c, y, state, st, batch,
                                    len, n_heads, stream);
    case 64:
      return launch_typed<T, P, 64>(x, dt, a_log, b, c, y, state, st, batch,
                                    len, n_heads, stream);
    case 128:
      return launch_typed<T, P, 128>(x, dt, a_log, b, c, y, state, st, batch,
                                     len, n_heads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dims(int head_dim, int state_dim, const void* x,
                        const void* dt, const void* a_log, const void* b,
                        const void* c, void* y, void* state,
                        const int64_t* st, int batch, int len, int n_heads,
                        cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_state_dim<T, 32>(state_dim, x, dt, a_log, b, c, y, state,
                                     st, batch, len, n_heads, stream);
    case 64:
      return launch_state_dim<T, 64>(state_dim, x, dt, a_log, b, c, y, state,
                                     st, batch, len, n_heads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, L, H, P), dt (B, L, H) float32, a_log (H,) float32 contiguous, b
// and c (B, L, N), y (B, L, H, P); x, b, c and y of one dtype (0: float32,
// 1: bfloat16), read and written through the 13 element strides in
// `strides` (batch, sequence and head of x and dt, batch and sequence of b
// and c, batch, sequence and head of y; the last axis of x, b, c and y has
// stride 1). `state`, when not null, receives the final state (B, H, P, N)
// float32, contiguous. Launches on `stream` and returns a CUDA error code:
// 0 when the launch was accepted. The caller checks shapes, types, devices
// and strides.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_log, const void* b,
                               const void* c, void* y, void* state,
                               const int64_t* strides, int batch, int len,
                               int n_heads, int head_dim, int state_dim,
                               int dtype, void* stream) {
  if (batch <= 0 || n_heads <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dims<float>(head_dim, state_dim, x, dt, a_log, b, c, y,
                             state, strides, batch, len, n_heads, s);
  else if (dtype == 1)
    err = launch_dims<__nv_bfloat16>(head_dim, state_dim, x, dt, a_log, b, c,
                                     y, state, strides, batch, len, n_heads,
                                     s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
