// Mamba2 chunked SSD scan (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan`
// (src/repro/kernels/ssd_scan/ssd_scan.py, `_kernel`). Per batch row b and
// head h, with A = -exp(a_log[h]) and a (P, N) float32 state S:
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,     y_t = S_t C_t
//
// computed chunk by chunk: within a chunk of Q steps, with s the cumulative
// sum of dt A over the chunk and S_in the state entering it,
//
//   y     = ((C B^T) o L o dt_j) x + exp(s) o (C S_in^T),
//           L[i][j] = exp(s_i - s_j) for j <= i, else 0
//   S_in' = exp(s_Q) S_in + S_c,   S_c = sum_j exp(s_Q - s_j) dt_j x_j B_j^T
//
// Bound: at the serving shape (one sequence of 1,024 tokens, 80 heads,
// P = 64, N = 128, bf16 x/B/C) the bytes to move (x and y, dt, B and C,
// the final state) take about 7 us at 3.35 TB/s and the operations of the
// chunked algebra about 4 us on the bf16 tensor cores: bound by bytes.
// The Pallas kernel walks the chunks in order with the state in VMEM; one
// CTA per (head, row) doing the same here leaves most SMs idle and keeps
// every product on the CUDA cores. So the scan runs as three launches,
// each parallel over chunks:
//
//   A  chunk_state: grid (chunk, head group, row). Each chunk's own
//      contribution S_c = (x o w)^T B, w_j = exp(s_Q - s_j) dt_j, and s_Q,
//      into float32 scratch that the wrapper allocates.
//   B  state_pass: grid (P N / 1,024, head, row). S_in of every chunk by
//      the recurrence S_in[c] = exp(s_Q[c-1]) S_in[c-1] + S_c[c-1], four
//      elements a thread, eight chunks' loads in flight at a time; writes
//      S_in in x's dtype and the final state. It moves 34 MB at the
//      serving shape: bound by bytes.
//   C  chunk_scan: grid (chunk, head group, row). C B^T once per CTA for
//      all heads of its group (B and C are shared by the heads), then per
//      head y = M x + exp(s) o (C S_in^T). Launched with programmatic
//      stream serialization, it stages C and B and forms C B^T while the
//      state passing still runs, and waits for it only to read S_in.
//
// Phases A and C run one CTA per SM (the chunk scan's shared memory allows
// no second); the wrapper sizes the head group from the length so that
// one wave covers the grid and short prompts still spread over the SMs. A
// CTA loads dt and forms s for all heads of its group up front (one warp
// a head), then walks the heads with the next head's x (and S_in) in
// flight by cp.async into a second buffer. S_c and y leave through shared
// memory in 16-byte rows. The bfloat16 instance runs its three products on
// the tensor cores (mma.sync m16n8k16, float32 accumulators, fragments by
// ldmatrix from padded shared-memory rows, a step's fragments loaded
// before its products): C, B and x enter as they are; M is rounded to
// bf16 once, as the attention kernel rounds P (so its exp is ex2.approx
// of log2-scaled sums, far finer than that rounding); S_in is stored in
// bf16 for C S_in^T; x o w, which is no bf16 value, enters the state
// product as bf16 hi + lo (two products), so S_c keeps float32 precision.
// Its tile is Q = 128 steps (8 warps of 16 rows), so the float32 scratch
// of chunk states is 21 MB at the serving shape, inside the 50 MB L2. The
// float32 instance keeps its products on the CUDA cores (TF32 misses its
// tolerance) with Q = 64, each thread a 4 x 4 block of the score tile, a
// 4 x P/16 block of y and a P/16 x N/16 block of S_c.
//
// Steps at or past `len` act as dt = 0 (decay 1, no update) and their rows
// of y are not written: the zero-dt padding of the Pallas wrapper without
// its copies. x, B and C are read through their strides, so the slices of
// the model's packed xBC tensor are read in place (16-byte copies when the
// wrapper finds them aligned, else element by element).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../hopper.cuh"
#include "../tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps in every phase
constexpr int kQtc = 128;      // steps per chunk tile, bfloat16 instance
constexpr int kQf = 64;        // steps per chunk tile, float32 instance

// Element strides of the batch, sequence and head axes; the last axis (P
// or N) has stride 1. B and C have no head axis (h unused).
struct Strides {
  int64_t b, l, h;
};

// What every phase reads and writes. T is x's dtype.
struct Problem {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  void* y;
  float* state;   // (B, H, P, N) float32, or null
  float* states;  // (B, H, chunks, P, N) float32: each chunk's own S_c
  float* s_last;  // (B, H, chunks): s at the chunk's last step
  void* s_in;     // (B, H, chunks, P, N) in T: the state entering a chunk
  Strides sx, sdt, sb, sc, sy;
  int len, n_heads, chunks, group, vec;
};

// s_t = sum_{u <= t} dt_u A over a tile of Q steps, by one warp: each lane
// sums Q / 32 consecutive steps, then the lanes' totals are scanned with
// shuffles. `dts` and `cum` in shared memory.
template <int Q>
__device__ __forceinline__ void warp_cumsum(const float* dts, float A,
                                            float* cum) {
  constexpr int kPer = Q / 32;
  const int lane = threadIdx.x % 32;
  float v[kPer];
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    run += dts[lane * kPer + i] * A;
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float base = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) base = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) cum[lane * kPer + i] = base + v[i];
}

constexpr int kMaxGroup = kThreads / 32;  // heads a CTA takes, at most

// dt (0 at or past `valid`) and s of the tile's Q steps for every head of
// the group [h_begin, h_end) into shared memory, head-major: loaded once,
// then one warp a head scans. The caller syncs before reading them.
template <int Q>
__device__ __forceinline__ void group_cumsums(float* dts, float* cum,
                                              const Problem& pr, int bi,
                                              int t0, int valid, int h_begin,
                                              int h_end) {
  const int nh = h_end - h_begin;
  for (int idx = threadIdx.x; idx < nh * Q; idx += kThreads) {
    const int hh = idx % nh, r = idx / nh;  // neighbouring heads together
    dts[hh * Q + r] =
        r < valid ? pr.dt[bi * pr.sdt.b + (t0 + r) * pr.sdt.l +
                          (h_begin + hh) * pr.sdt.h]
                  : 0.0f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp < nh)
    warp_cumsum<Q>(dts + warp * Q, -expf(pr.a_log[h_begin + warp]),
                   cum + warp * Q);
}

// w_t = exp(s_Q - s_t) dt_t of every head of the group (head-major, as
// group_cumsums leaves dt and s, which the caller has synced), and s_Q of
// each into `s_last`. The caller syncs before reading w.
template <int Q>
__device__ __forceinline__ void group_weights(float* ws, const float* dts,
                                              const float* cum,
                                              const Problem& pr, int bi,
                                              int chunk, int h_begin,
                                              int h_end) {
  for (int idx = threadIdx.x; idx < (h_end - h_begin) * Q;
       idx += kThreads) {
    const int hh = idx / Q, r = idx % Q;
    const float s_q = cum[hh * Q + Q - 1];
    ws[idx] = expf(s_q - cum[idx]) * dts[idx];
    if (r == 0)
      pr.s_last[(static_cast<int64_t>(bi) * pr.n_heads + h_begin + hh) *
                    pr.chunks + chunk] = s_q;
  }
}

// Rows [0, rows) of a (rows x D) bf16 tile, row r at src + r * row_stride,
// into shared memory at dst with a row stride of `ld` elements; rows at or
// past `valid` are zero. With `vec`, 16-byte cp.async copies (the caller
// commits and waits); else element by element.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld, const bf16* src,
                                           int64_t row_stride, int rows,
                                           int valid, bool vec) {
  if (vec) {
    constexpr int kChunks = D / 8;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      const bool in = r < valid;
      hopper::cp_async16(dst + r * ld + c, in ? src + r * row_stride + c : src,
                         in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      dst[r * ld + c] =
          r < valid ? src[r * row_stride + c] : __float2bfloat16(0.0f);
    }
  }
}

// The same for a float32 tile, stored with a row stride of D + 1.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int64_t row_stride, int rows,
                                          int valid, bool vec) {
  if (vec) {
    tiles::load_rows<float, D>(dst, src, row_stride, rows, valid);
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      dst[r * (D + 1) + c] = r < valid ? src[r * row_stride + c] : 0.0f;
    }
  }
}

// ---- phase A: chunk states ---------------------------------------------

template <int P, int N>
constexpr size_t state_tc_smem() {
  return sizeof(bf16) * (static_cast<size_t>(kQtc) * (N + 8) +
                         2 * kQtc * (P + 8)) +
         sizeof(float) * (3 * kMaxGroup * kQtc + P * (N + 8));
}

// S_c (P x N) = (x o w)^T B on the tensor cores. Warp w computes the m16
// tile w % (P / 16) of rows (p) and kNT n8 tiles of columns (n); K runs
// over the Q steps. x o w is split into bf16 hi + lo. dt, s and w of every
// head of the group are made once, up front; the next head's x (cp.async
// into the other buffer) is in flight during the current head's products;
// each warp's part of S_c leaves through shared memory in 16-byte rows.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) chunk_state_tc(Problem pr) {
  constexpr int Q = kQtc, kLdN = N + 8, kLdP = P + 8;
  constexpr int kMT = P / 16;                              // m16 tiles
  constexpr int kWN = 8 / kMT < N / 16 ? 8 / kMT : N / 16;  // warps per one
  constexpr int kNT = N / 8 / kWN;                          // n8 tiles each
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bs = reinterpret_cast<bf16*>(smem);  // Q x kLdN: B
  bf16* xb = bs + Q * kLdN;                  // 2 x Q x kLdP: x, two heads
  float* dts = reinterpret_cast<float*>(xb + 2 * Q * kLdP);  // G x Q: dt
  float* cum = dts + kMaxGroup * Q;                          // G x Q: s_t
  float* ws = cum + kMaxGroup * Q;                           // G x Q: w_t
  float* st = ws + kMaxGroup * Q;  // P x (N + 8): S_c on its way out

  const int chunk = blockIdx.x, bi = blockIdx.z;
  const int t0 = chunk * Q, valid = min(Q, pr.len - t0);
  const int h_begin = blockIdx.y * pr.group;
  const int h_end = min(pr.n_heads, h_begin + pr.group);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;     // fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;   // ldmatrix: matrix and row
  const bool active = warp < kMT * kWN;
  const int mt = warp % kMT, nt0 = (warp / kMT) * kNT;

  const bf16* xg =
      static_cast<const bf16*>(pr.x) + bi * pr.sx.b + t0 * pr.sx.l;
  stage_bf16<N>(bs, kLdN,
                static_cast<const bf16*>(pr.b) + bi * pr.sb.b + t0 * pr.sb.l,
                pr.sb.l, Q, valid, pr.vec);
  stage_bf16<P>(xb, kLdP, xg + h_begin * pr.sx.h, pr.sx.l, Q, valid, pr.vec);
  hopper::cp_async_commit();
  group_cumsums<Q>(dts, cum, pr, bi, t0, valid, h_begin, h_end);
  __syncthreads();
  group_weights<Q>(ws, dts, cum, pr, bi, chunk, h_begin, h_end);
  for (int h = h_begin; h < h_end; ++h) {
    const int cur = (h - h_begin) & 1;
    __syncthreads();  // the previous head's readers of the tiles are done
    if (h + 1 < h_end)
      stage_bf16<P>(xb + (cur ^ 1) * Q * kLdP, kLdP, xg + (h + 1) * pr.sx.h,
                    pr.sx.l, Q, valid, pr.vec);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // this head's x (the next one's may fly)
    __syncthreads();
    if (!active) continue;

    const int64_t head = static_cast<int64_t>(bi) * pr.n_heads + h;
    const bf16* xs = xb + cur * Q * kLdP;
    const float* w = ws + (h - h_begin) * Q;
    float acc[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
#pragma unroll 2
    for (int ks = 0; ks < Q / 16; ++ks) {
      // A = (x o w)^T: rows p, K = steps j; x is stored (j, p), so the
      // transposing load gives the fragment
      uint32_t a[4], hi[4], lo[4], bf[kNT / 2][4];
      hopper::ldmatrix_x4_trans(
          a, xs + (16 * ks + (mi >> 1) * 8 + mr) * kLdP + 16 * mt +
                 (mi & 1) * 8);
      // B: K = steps j, columns n; stored (j, n): transposing loads, all
      // in flight while x o w is split
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        hopper::ldmatrix_x4_trans(
            bf[np], bs + (16 * ks + (mi & 1) * 8 + mr) * kLdN +
                        8 * (nt0 + 2 * np) + (mi >> 1) * 8);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 16 * ks + (r >> 1) * 8 + 2 * t;
        const float2 v = hopper::unpack_bf16(a[r]);
        const float v0 = v.x * w[j], v1 = v.y * w[j + 1];
        hi[r] = hopper::pack_bf16(v0, v1);
        const float2 vh = hopper::unpack_bf16(hi[r]);
        lo[r] = hopper::pack_bf16(v0 - vh.x, v1 - vh.y);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        hopper::mma_bf16_m16n8k16(acc[2 * np], hi, bf[np][0], bf[np][1]);
        hopper::mma_bf16_m16n8k16(acc[2 * np + 1], hi, bf[np][2],
                                  bf[np][3]);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        hopper::mma_bf16_m16n8k16(acc[2 * np], lo, bf[np][0], bf[np][1]);
        hopper::mma_bf16_m16n8k16(acc[2 * np + 1], lo, bf[np][2],
                                  bf[np][3]);
      }
    }
    // the warp's 16 x 8 kNT block of S_c: into shared memory, then out
    constexpr int kLdS = N + 8;
    const int p = 16 * mt + g;
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int n = 8 * (nt0 + i) + 2 * t;
      *reinterpret_cast<float2*>(st + p * kLdS + n) =
          make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(st + (p + 8) * kLdS + n) =
          make_float2(acc[i][2], acc[i][3]);
    }
    __syncwarp();
    float* out = pr.states + (head * pr.chunks + chunk) * (P * N);
    constexpr int kRow = 2 * kNT;  // 16-byte pieces of the warp's row part
#pragma unroll
    for (int k = lane; k < 16 * kRow; k += 32) {
      const int r = 16 * mt + k / kRow, c = 8 * nt0 + (k % kRow) * 4;
      *reinterpret_cast<float4*>(out + r * N + c) =
          *reinterpret_cast<const float4*>(st + r * kLdS + c);
    }
    __syncwarp();  // the warp's part of st is read before it writes again
  }
}

template <int P, int N>
constexpr size_t state_f32_smem() {
  return sizeof(float) * (static_cast<size_t>(kQf) * (N + 1) +
                          kQf * (P + 1) + 3 * kMaxGroup * kQf);
}

// S_c on the CUDA cores: each thread a P/16 x N/16 block (rows ty + 16 i,
// columns tx + 16 m), padded rows so the column walks hit distinct banks.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) chunk_state_f32(Problem pr) {
  constexpr int Q = kQf, kPc = P / 16, kNc = N / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem);  // Q x (N + 1): B
  float* xs = bs + Q * (N + 1);                // Q x (P + 1): x
  float* dts = xs + Q * (P + 1);               // G x Q: dt
  float* cum = dts + kMaxGroup * Q;            // G x Q: s_t
  float* ws = cum + kMaxGroup * Q;             // G x Q: w_t

  const int chunk = blockIdx.x, bi = blockIdx.z;
  const int t0 = chunk * Q, valid = min(Q, pr.len - t0);
  const int h_begin = blockIdx.y * pr.group;
  const int h_end = min(pr.n_heads, h_begin + pr.group);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const float* xg =
      static_cast<const float*>(pr.x) + bi * pr.sx.b + t0 * pr.sx.l;
  stage_f32<N>(bs,
               static_cast<const float*>(pr.b) + bi * pr.sb.b + t0 * pr.sb.l,
               pr.sb.l, Q, valid, pr.vec);
  group_cumsums<Q>(dts, cum, pr, bi, t0, valid, h_begin, h_end);
  __syncthreads();
  group_weights<Q>(ws, dts, cum, pr, bi, chunk, h_begin, h_end);
  for (int h = h_begin; h < h_end; ++h) {
    __syncthreads();
    stage_f32<P>(xs, xg + h * pr.sx.h, pr.sx.l, Q, valid, pr.vec);
    __syncthreads();
    const int64_t head = static_cast<int64_t>(bi) * pr.n_heads + h;
    const float* w = ws + (h - h_begin) * Q;

    float upd[kPc][kNc];
#pragma unroll
    for (int i = 0; i < kPc; ++i)
#pragma unroll
      for (int m = 0; m < kNc; ++m) upd[i][m] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float wj = w[j];
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
    float* out = pr.states + (head * pr.chunks + chunk) * (P * N);
#pragma unroll
    for (int i = 0; i < kPc; ++i)
#pragma unroll
      for (int m = 0; m < kNc; ++m)
        out[(ty + 16 * i) * N + tx + 16 * m] = upd[i][m];
  }
}

// ---- phase B: state passing --------------------------------------------

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(hopper::pack_bf16(v.x, v.y), hopper::pack_bf16(v.z, v.w));
}

// Four consecutive elements of one (row, head)'s P x N state per thread,
// serial over the chunks; the loads of eight chunks at a time are in flight
// together (they do not depend on the chain).
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) state_pass(Problem pr) {
  constexpr int kPN = P * N;
  hopper::launch_dependents();  // the chunk scan may start its prologue
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= kPN) return;
  const int64_t head =
      static_cast<int64_t>(blockIdx.z) * pr.n_heads + blockIdx.y;
  const float* in = pr.states + head * pr.chunks * kPN + e;
  const float* s_last = pr.s_last + head * pr.chunks;
  T* out = static_cast<T*>(pr.s_in) + head * pr.chunks * kPN + e;
  constexpr int kBatch = 8;
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < pr.chunks; c0 += kBatch) {
    float4 v[kBatch];
    float s[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < pr.chunks) {
        v[k] = *reinterpret_cast<const float4*>(in + (c0 + k) * kPN);
        s[k] = s_last[c0 + k];
      }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < pr.chunks) {
        store4(out + (c0 + k) * kPN, run);
        const float d = expf(s[k]);
        run = make_float4(d * run.x + v[k].x, d * run.y + v[k].y,
                          d * run.z + v[k].z, d * run.w + v[k].w);
      }
  }
  if (pr.state != nullptr) store4(pr.state + head * kPN + e, run);
}

// ---- phase C: chunk scan -----------------------------------------------

template <int P, int N>
constexpr size_t scan_tc_smem() {
  return sizeof(bf16) * (2 * static_cast<size_t>(kQtc) * (N + 8) +
                         3 * kQtc * (P + 8) + 2 * P * (N + 8)) +
         sizeof(float) * 2 * kMaxGroup * kQtc;
}

// Warp w owns rows 16 w .. 16 w + 15 of the chunk. C B^T (its 16 x 16 (w +
// 1) causal part) stays in the warp's registers for every head of the
// group; per head: y = exp(s) o (C S_in^T), then += M x with M built from
// those registers and rounded to bf16. dt and s of every head of the
// group are made once, up front; the next head's x and S_in (cp.async into
// the other buffers) are in flight during the current head's products; y
// leaves through shared memory in 16-byte rows, each warp storing its own.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) chunk_scan_tc(Problem pr) {
  constexpr int Q = kQtc, kLdN = N + 8, kLdP = P + 8;
  static_assert(Q == 16 * kThreads / 32, "one warp per 16 rows");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem);  // Q x kLdN: C
  bf16* bs = cs + Q * kLdN;                  // Q x kLdN: B
  bf16* xb = bs + Q * kLdN;                  // 2 x Q x kLdP: x, two heads
  bf16* ys = xb + 2 * Q * kLdP;              // Q x kLdP: y of one head
  bf16* sb = ys + Q * kLdP;                  // 2 x P x kLdN: S_in, two heads
  float* dts = reinterpret_cast<float*>(sb + 2 * P * kLdN);  // G x Q: dt
  float* cum = dts + kMaxGroup * Q;                          // G x Q: s_t

  const int chunk = blockIdx.x, bi = blockIdx.z;
  const int t0 = chunk * Q, valid = min(Q, pr.len - t0);
  const int h_begin = blockIdx.y * pr.group;
  const int h_end = min(pr.n_heads, h_begin + pr.group);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const int i0 = 16 * warp + g, i1 = i0 + 8;  // this lane's rows

  const bf16* xg =
      static_cast<const bf16*>(pr.x) + bi * pr.sx.b + t0 * pr.sx.l;
  const bf16* sg = static_cast<const bf16*>(pr.s_in) +
                   static_cast<int64_t>(bi) * pr.n_heads * pr.chunks * P * N +
                   static_cast<int64_t>(chunk) * P * N;
  const int64_t s_head = static_cast<int64_t>(pr.chunks) * P * N;
  stage_bf16<N>(cs, kLdN,
                static_cast<const bf16*>(pr.c) + bi * pr.sc.b + t0 * pr.sc.l,
                pr.sc.l, Q, valid, pr.vec);
  stage_bf16<N>(bs, kLdN,
                static_cast<const bf16*>(pr.b) + bi * pr.sb.b + t0 * pr.sb.l,
                pr.sb.l, Q, valid, pr.vec);
  hopper::cp_async_commit();
  stage_bf16<P>(xb, kLdP, xg + h_begin * pr.sx.h, pr.sx.l, Q, valid, pr.vec);
  hopper::cp_async_commit();
  group_cumsums<Q>(dts, cum, pr, bi, t0, valid, h_begin, h_end);
  hopper::cp_async_wait<1>();  // C and B
  __syncthreads();

  // cb[jt]: C B^T at rows i0, i1 and columns 8 jt + 2 t, + 1 (jt <= 2 w + 1)
  float cb[Q / 8][4];
#pragma unroll
  for (int i = 0; i < Q / 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) cb[i][k] = 0.0f;
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t a[4];
    hopper::ldmatrix_x4(a, cs + (16 * warp + (mi & 1) * 8 + mr) * kLdN +
                               16 * ks + (mi >> 1) * 8);
#pragma unroll
    for (int jp = 0; jp < Q / 16; ++jp) {
      if (jp <= warp) {
        uint32_t bf[4];
        hopper::ldmatrix_x4(bf, bs + (16 * jp + (mi >> 1) * 8 + mr) * kLdN +
                                    16 * ks + (mi & 1) * 8);
        hopper::mma_bf16_m16n8k16(cb[2 * jp], a, bf[0], bf[1]);
        hopper::mma_bf16_m16n8k16(cb[2 * jp + 1], a, bf[2], bf[3]);
      }
    }
  }

  // all of the above reads inputs only, so it overlaps the state passing;
  // S_in is its output
  hopper::wait_dependencies();
  stage_bf16<N>(sb, kLdN, sg + h_begin * s_head, N, P, P, true);
  hopper::cp_async_commit();
  for (int h = h_begin; h < h_end; ++h) {
    const int cur = (h - h_begin) & 1;
    __syncthreads();  // the previous head's readers of the tiles are done
    if (h + 1 < h_end) {
      stage_bf16<P>(xb + (cur ^ 1) * Q * kLdP, kLdP, xg + (h + 1) * pr.sx.h,
                    pr.sx.l, Q, valid, pr.vec);
      stage_bf16<N>(sb + (cur ^ 1) * P * kLdN, kLdN, sg + (h + 1) * s_head,
                    N, P, P, true);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // this head's x and S_in
    __syncthreads();
    const bf16* xs = xb + cur * Q * kLdP;
    const bf16* ss = sb + cur * P * kLdN;
    const float* dts_h = dts + (h - h_begin) * Q;
    const float* cum_h = cum + (h - h_begin) * Q;

    // y = exp(s) o (C S_in^T): A = C (rows i, K = n), B = S_in^T (K = n,
    // columns p), S_in stored (p, n)
    float acc[P / 8][4];
#pragma unroll
    for (int i = 0; i < P / 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
#pragma unroll 2
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t a[4], bf[P / 16][4];
      hopper::ldmatrix_x4(a, cs + (16 * warp + (mi & 1) * 8 + mr) * kLdN +
                                 16 * ks + (mi >> 1) * 8);
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp)
        hopper::ldmatrix_x4(bf[pp], ss + (16 * pp + (mi >> 1) * 8 + mr) *
                                             kLdN + 16 * ks + (mi & 1) * 8);
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        hopper::mma_bf16_m16n8k16(acc[2 * pp], a, bf[pp][0], bf[pp][1]);
        hopper::mma_bf16_m16n8k16(acc[2 * pp + 1], a, bf[pp][2], bf[pp][3]);
      }
    }
    const float s0 = cum_h[i0], s1 = cum_h[i1];
    const float e0 = expf(s0), e1 = expf(s1);
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      acc[i][0] *= e0;
      acc[i][1] *= e0;
      acc[i][2] *= e1;
      acc[i][3] *= e1;
    }

    // y += M x: M[i][j] = (C B^T)[i][j] exp(s_i - s_j) dt_j for j <= i,
    // rounded to bf16 as the A fragment (so exp by ex2.approx of log2-
    // scaled sums: its error is far below that rounding); B = x (K = j,
    // columns p), stored (j, p): transposing loads, in flight while M is
    // built. Warp w builds w + 1 column blocks: the causal tile.
    constexpr float kLog2e = 1.4426950408889634f;
    const float l0 = s0 * kLog2e, l1 = s1 * kLog2e;
#pragma unroll
    for (int kp = 0; kp < Q / 16; ++kp) {
      if (kp <= warp) {
        uint32_t bf[P / 16][4];
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp)
          hopper::ldmatrix_x4_trans(
              bf[pp], xs + (16 * kp + (mi & 1) * 8 + mr) * kLdP + 16 * pp +
                          (mi >> 1) * 8);
        // this lane's columns: ja, ja + 1 (tile 2 kp), jb, jb + 1 (2 kp + 1)
        const int ja = 16 * kp + 2 * t, jb = ja + 8;
        const int js[4] = {ja, ja + 1, jb, jb + 1};
        float lj[4], dj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lj[c] = cum_h[js[c]] * kLog2e;
          dj[c] = dts_h[js[c]];
        }
        auto m = [&](float v, int i, float li, int c) {
          return js[c] <= i ? v * hopper::exp2_approx(li - lj[c]) * dj[c]
                            : 0.0f;
        };
        uint32_t a[4];
        a[0] = hopper::pack_bf16(m(cb[2 * kp][0], i0, l0, 0),
                                 m(cb[2 * kp][1], i0, l0, 1));
        a[1] = hopper::pack_bf16(m(cb[2 * kp][2], i1, l1, 0),
                                 m(cb[2 * kp][3], i1, l1, 1));
        a[2] = hopper::pack_bf16(m(cb[2 * kp + 1][0], i0, l0, 2),
                                 m(cb[2 * kp + 1][1], i0, l0, 3));
        a[3] = hopper::pack_bf16(m(cb[2 * kp + 1][2], i1, l1, 2),
                                 m(cb[2 * kp + 1][3], i1, l1, 3));
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          hopper::mma_bf16_m16n8k16(acc[2 * pp], a, bf[pp][0], bf[pp][1]);
          hopper::mma_bf16_m16n8k16(acc[2 * pp + 1], a, bf[pp][2],
                                    bf[pp][3]);
        }
      }
    }

    // y: the warp's 16 rows into shared memory, then out in 16-byte rows
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      const int col = 8 * i + 2 * t;
      *reinterpret_cast<uint32_t*>(ys + i0 * kLdP + col) =
          hopper::pack_bf16(acc[i][0], acc[i][1]);
      *reinterpret_cast<uint32_t*>(ys + i1 * kLdP + col) =
          hopper::pack_bf16(acc[i][2], acc[i][3]);
    }
    __syncwarp();
    bf16* yh = static_cast<bf16*>(pr.y) + bi * pr.sy.b + h * pr.sy.h;
    constexpr int kRowChunks = P / 8;  // 16-byte pieces of a row of y
#pragma unroll
    for (int k = lane; k < 16 * kRowChunks; k += 32) {
      const int r = 16 * warp + k / kRowChunks, c = (k % kRowChunks) * 8;
      if (r < valid)
        *reinterpret_cast<uint4*>(yh + (t0 + r) * pr.sy.l + c) =
            *reinterpret_cast<const uint4*>(ys + r * kLdP + c);
    }
    __syncwarp();  // the warp's rows of ys are read before it writes again
  }
}

template <int P, int N>
constexpr size_t scan_f32_smem() {
  return sizeof(float) *
         (2 * static_cast<size_t>(kQf) * (N + 1) + kQf * (P + 1) +
          kQf * (kQf + 1) + P * (N + 1) + (2 * kMaxGroup + 1) * kQf);
}

// Each thread owns a 4 x 4 block of the score tile (rows ty*4 .. ty*4+3,
// columns tx + 16 j; kept in registers for every head of the group) and a
// 4 x P/16 block of y.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) chunk_scan_f32(Problem pr) {
  constexpr int Q = kQf, kPc = P / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);  // Q x (N + 1): C
  float* bs = cs + Q * (N + 1);                // Q x (N + 1): B
  float* xs = bs + Q * (N + 1);                // Q x (P + 1): x
  float* ms = xs + Q * (P + 1);                // Q x (Q + 1): M
  float* ss = ms + Q * (Q + 1);                // P x (N + 1): S_in
  float* dts = ss + P * (N + 1);               // G x Q: dt
  float* cum = dts + kMaxGroup * Q;            // G x Q: s_t
  float* ecum = cum + kMaxGroup * Q;           // Q: exp(s_t), one head

  const int chunk = blockIdx.x, bi = blockIdx.z;
  const int t0 = chunk * Q, valid = min(Q, pr.len - t0);
  const int h_begin = blockIdx.y * pr.group;
  const int h_end = min(pr.n_heads, h_begin + pr.group);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  stage_f32<N>(cs,
               static_cast<const float*>(pr.c) + bi * pr.sc.b + t0 * pr.sc.l,
               pr.sc.l, Q, valid, pr.vec);
  stage_f32<N>(bs,
               static_cast<const float*>(pr.b) + bi * pr.sb.b + t0 * pr.sb.l,
               pr.sb.l, Q, valid, pr.vec);
  group_cumsums<Q>(dts, cum, pr, bi, t0, valid, h_begin, h_end);
  __syncthreads();
  float cb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cb[i][j] = 0.0f;
  for (int k = 0; k < N; ++k) {
    float cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = cs[(ty * 4 + i) * (N + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * (N + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] += cv[i] * bv[j];
  }

  const float* xg =
      static_cast<const float*>(pr.x) + bi * pr.sx.b + t0 * pr.sx.l;
  hopper::wait_dependencies();  // S_in, the state passing's output
  for (int h = h_begin; h < h_end; ++h) {
    const int64_t head = static_cast<int64_t>(bi) * pr.n_heads + h;
    __syncthreads();
    stage_f32<P>(xs, xg + h * pr.sx.h, pr.sx.l, Q, valid, pr.vec);
    stage_f32<N>(ss,
                 static_cast<const float*>(pr.s_in) +
                     (head * pr.chunks + chunk) * (P * N),
                 N, P, P, true);
    __syncthreads();
    const float* dts_h = dts + (h - h_begin) * Q;
    const float* cum_h = cum + (h - h_begin) * Q;
    if (tid < Q) ecum[tid] = expf(cum_h[tid]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        ms[r * (Q + 1) + col] =
            col <= r ? cb[i][j] * expf(cum_h[r] - cum_h[col]) * dts_h[col]
                     : 0.0f;
      }
    }
    __syncthreads();

    float acc[4][kPc], off[4][kPc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kPc; ++c) acc[i][c] = off[i][c] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      float mv[4], xv[kPc];
#pragma unroll
      for (int i = 0; i < 4; ++i) mv[i] = ms[(ty * 4 + i) * (Q + 1) + j];
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
    float* yh = static_cast<float*>(pr.y) + bi * pr.sy.b + h * pr.sy.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < valid) {
        float* yrow = yh + (t0 + r) * pr.sy.l;
#pragma unroll
        for (int c = 0; c < kPc; ++c)
          yrow[tx + 16 * c] = acc[i][c] + ecum[r] * off[i][c];
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The three phases of one instance on `stream`.
template <typename T, int P, int N>
cudaError_t launch_phases(const Problem& pr, int batch, cudaStream_t stream) {
  constexpr bool kTc = sizeof(T) == 2;
  constexpr size_t smem_a = kTc ? state_tc_smem<P, N>() : state_f32_smem<P, N>();
  constexpr size_t smem_c = kTc ? scan_tc_smem<P, N>() : scan_f32_smem<P, N>();
  void (*const state_kernel)(Problem) =
      kTc ? chunk_state_tc<P, N> : chunk_state_f32<P, N>;
  void (*const scan_kernel)(Problem) =
      kTc ? chunk_scan_tc<P, N> : chunk_scan_f32<P, N>;
  static const cudaError_t attr = [&] {
    const cudaError_t e = opt_in(state_kernel, smem_a);
    return e != cudaSuccess ? e : opt_in(scan_kernel, smem_c);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(pr.chunks, (pr.n_heads + pr.group - 1) / pr.group, batch);
  state_kernel<<<grid, kThreads, smem_a, stream>>>(pr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 pass_grid((P * N / 4 + kThreads - 1) / kThreads, pr.n_heads,
                       batch);
  state_pass<T, P, N><<<pass_grid, kThreads, 0, stream>>>(pr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the chunk scan starts its prologue while the state passing runs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_c;
  cfg.stream = stream;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = overlap;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scan_kernel, pr);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_state_dim(int state_dim, const Problem& pr, int batch,
                             cudaStream_t stream) {
  switch (state_dim) {
    case 32:
      return launch_phases<T, P, 32>(pr, batch, stream);
    case 64:
      return launch_phases<T, P, 64>(pr, batch, stream);
    case 128:
      return launch_phases<T, P, 128>(pr, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dims(int head_dim, int state_dim, const Problem& pr,
                        int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_state_dim<T, 32>(state_dim, pr, batch, stream);
    case 64:
      return launch_state_dim<T, 64>(state_dim, pr, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The arguments of one call, packed by the wrapper in one buffer
// (`ops.py`, `_POINTERS` then `_LAYOUT`): x (B, L, H, P), dt (B, L, H) float32, a_log (H,)
// float32 contiguous, b and c (B, L, N), y (B, L, H, P); x, b, c and y of
// one dtype (0: float32, 1: bfloat16), read and written through the 13
// element strides in `strides` (batch, sequence and head of x and dt,
// batch and sequence of b and c, batch, sequence and head of y; the last
// axis of x, b, c and y has stride 1, and the rows of y are 16-byte
// aligned). `state`, when not null, receives the final state (B, H, P, N)
// float32, contiguous. `states` (B, H, chunks, P, N) float32, `s_last`
// (B, H, chunks) float32 and `s_in` (B, H, chunks, P, N) of x's dtype are
// contiguous scratch, 16-byte aligned, with chunks = ceil(len / tile);
// `tile` must be the instance's (128 for bfloat16, 64 for float32). Each
// CTA of phases A and C takes `group` heads. `vec` says that x, b and c
// and their strides allow 16-byte loads.
struct Args {
  const void* x;
  const void* dt;
  const void* a_log;
  const void* b;
  const void* c;
  void* y;
  void* state;
  void* states;
  void* s_last;
  void* s_in;
  int32_t vec, pad;
  int64_t strides[13];
  int32_t batch, len, n_heads, head_dim, state_dim, dtype, tile, group;
};
static_assert(sizeof(Args) == 224, "Args must match the wrapper's packing");

// Makes three launches on `stream` (or, for len 0, clears `state`) and
// returns a CUDA error code: 0 when every launch was accepted. The caller
// checks shapes, types, devices and strides.
extern "C" int ssd_scan_launch(const Args* a, void* stream) {
  if (a->dtype != 0 && a->dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->tile != (a->dtype == 1 ? kQtc : kQf) || a->group < 1 ||
      a->group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->batch <= 0 || a->n_heads <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->len <= 0) {
    if (a->state == nullptr) return static_cast<int>(cudaSuccess);
    return static_cast<int>(cudaMemsetAsync(
        a->state, 0,
        sizeof(float) * a->batch * a->n_heads * a->head_dim * a->state_dim,
        s));
  }
  const int64_t* st = a->strides;
  const Problem pr{
      a->x, static_cast<const float*>(a->dt),
      static_cast<const float*>(a->a_log), a->b, a->c, a->y,
      static_cast<float*>(a->state), static_cast<float*>(a->states),
      static_cast<float*>(a->s_last), a->s_in,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], 0}, Strides{st[8], st[9], 0},
      Strides{st[10], st[11], st[12]}, a->len, a->n_heads,
      (a->len + a->tile - 1) / a->tile, a->group, a->vec};
  const cudaError_t err =
      a->dtype == 0
          ? launch_dims<float>(a->head_dim, a->state_dim, pr, a->batch, s)
          : launch_dims<bf16>(a->head_dim, a->state_dim, pr, a->batch, s);
  return static_cast<int>(err);
}
