// Mamba2 SSD (state-space duality) scan, forward and gradient.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (pallas_call in ssd_scan).  Per head, with the log-decay a <= 0 and the
// state h (N, P) starting at 0:  h_t = exp(a_t) h_{t-1} + b_t x_t^T,
// y_t = c_t^T h_t.  b and c (N wide) are shared by every head.  The TPU
// kernel walks a grid (heads, chunks) whose chunk axis runs in order and
// carries h in VMEM scratch: COX's inter-warp loop, h its replicated
// cross-region variable.  Blocks of a CUDA grid run in no order, so here
// the chunk loop is a loop inside the block: one block per (head, batch
// row) walks the sequence tile by tile and carries h in shared memory.
// Per tile of T rows (the dual form, exact for any tile length, so T is
// this kernel's own choice; the caller's chunk only fixes the reference's
// divisibility rule), with A = the cumulative sum of a within the tile and
// A_T its last entry:
//
//   y = ((C B^T) .* L) X + exp(A) .* (C h),  L[i,j] = exp(A_i - A_j) [i >= j]
//   h <- exp(A_T) h + (B .* exp(A_T - A))^T X
//
// with the exponent masked before exp, so no entry overflows.  A tail tile
// (S not a multiple of T) is padded with zero rows and a = 0, which add
// nothing to y or h.
//
// Bound: operations.  At mamba2-130m's training shape (B 8, S 4,096, 24
// heads, P 64, N 128, f32) the dual form does ~40 GFLOP against ~0.44 GB
// of inputs and outputs, ~90 operations a byte.  This first version
// computes the products with f32 FMAs on the CUDA cores (the f32 card-vs-
// CPU checks need f32 accuracy): 256 threads as a 16 x 16 grid, each
// thread a register block of outputs whose rows and columns are strided by
// 16, operands read from shared memory whose rows are padded by one word,
// so a warp's reads fall in distinct banks.  One block per (head, batch
// row), ~130-220 KB of shared memory each: one block per SM.
//
// cox_ssd_scan_bwd is the gradient (the TPU kernel has none: the reference
// trains through autodiff of its plain chunked form).  The forward, when
// asked, writes the state entering each tile to `states` (B, H, tiles, N,
// P); the backward walks the tiles in reverse and carries dH = dL/dh_out
// (zero after the last tile).  Per tile, with E[i,j] = exp(A_i - A_j)
// [i >= j], CB = C B^T, G[i,j] = dy_i . x_j, w_j = exp(A_T - A_j):
//
//   dx_j = sum_i E CB[i,j] dy_i + w_j dH^T b_j
//   db_j = sum_i E G[i,j] c_i + w_j dH x_j             (this head's part)
//   dc_i = sum_j E G[i,j] b_j + exp(A_i) h_in dy_i     (this head's part)
//   dA_k = sum_j T[k,j] - sum_i T[i,k] + exp(A_k) dy_k . (c_k^T h_in) - W_k,
//          T = E .* CB .* G,  W_j = w_j b_j^T dH x_j,
//          dA_{T-1} += sum_j W_j + exp(A_T) <dH, h_in>
//   da   = the reverse cumulative sum of dA within the tile
//   dH  <- exp(A_T) dH + sum_i exp(A_i) c_i dy_i^T
//
// b and c are shared across heads, so db and dc are sums over heads: each
// block writes its head's part to (B, H, S, N) scratch and a second kernel
// sums the heads in order.  No atomics: the gradient is deterministic.
// Every row reduction is a fixed loop or a fixed shuffle tree.
//
// All inputs f32 (the model path casts them: src/repro/models/layers.py
// mamba2_apply).  x, b and c are read through their strides (batch,
// sequence, head) with the last axis contiguous, so b and c may be slices
// of the conv output; a through its three strides.  y, dy and the
// gradients are contiguous.  Built for N, P in {16, 32, 64, 128}.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

// shared floats of each kernel at tile length T
constexpr size_t fwd_floats(int T, int N, int P) {
  return static_cast<size_t>(T) * (P + 1) + 2 * static_cast<size_t>(T) * (N + 1) +
         static_cast<size_t>(N) * (P + 1) + static_cast<size_t>(T) * (T + 1) + 2 * T;
}
constexpr size_t bwd_floats(int T, int N, int P) {
  return 2 * static_cast<size_t>(T) * (P + 1) + 2 * static_cast<size_t>(T) * (N + 1) +
         2 * static_cast<size_t>(N) * (P + 1) + 3 * static_cast<size_t>(T) * (T + 1) +
         2 * 16 * static_cast<size_t>(T) + 6 * T + 32;
}

// The tile length: 64 rows, or 32 where the backward's tiles would not fit
// a block's shared memory (N = P = 128).  The forward uses the same tile,
// since the backward reads the states it saves at each tile's entry.
template <int N, int P> struct Tile {
  static constexpr int T = bwd_floats(64, N, P) * sizeof(float) <= MAX_SMEM ? 64 : 32;
  static_assert(bwd_floats(T, N, P) * sizeof(float) <= MAX_SMEM, "tile does not fit");
  static_assert(fwd_floats(T, N, P) * sizeof(float) <= MAX_SMEM, "tile does not fit");
};

struct Strides {  // in elements
  long long xb, xs, xh;  // x (B, S, H, P): batch, sequence, head
  long long ab, as, ah;  // a (B, S, H)
  long long bb, bs;      // b (B, S, N)
  long long cb, cs;      // c (B, S, N)
};

// The tile loaders: rows past the tile's last row read as zero.
template <int T, int N>
__device__ __forceinline__ void load_bc(const float* __restrict__ b, const float* __restrict__ c,
                                        float* bs, float* cs, long long boff, long long bstride,
                                        long long coff, long long cstride, int rows) {
  constexpr int BN = N + 1;
  for (int e = threadIdx.x; e < T * N; e += THREADS) {
    const int r = e / N, n = e % N;
    const bool in = r < rows;
    bs[r * BN + n] = in ? b[boff + r * bstride + n] : 0.0f;
    cs[r * BN + n] = in ? c[coff + r * cstride + n] : 0.0f;
  }
}

template <int T, int P>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst,
                                          long long off, long long stride, int rows) {
  constexpr int XP = P + 1;
  for (int e = threadIdx.x; e < T * P; e += THREADS) {
    const int r = e / P, p = e % P;
    dst[r * XP + p] = r < rows ? src[off + r * stride + p] : 0.0f;
  }
}

// A[r] = a[0] + ... + a[r] over the tile (a = 0 past the last row), in order
template <int T>
__device__ __forceinline__ void cumsum_a(const float* __restrict__ a, float* As, long long off,
                                         long long stride, int rows) {
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int r = 0; r < T; ++r) {
      acc += r < rows ? a[off + r * stride] : 0.0f;
      As[r] = acc;
    }
  }
}

template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ c,
                   float* __restrict__ y, float* __restrict__ states, int S, int H,
                   Strides st) {
  constexpr int T = Tile<N, P>::T;
  constexpr int XP = P + 1, BN = N + 1, TT = T + 1;
  constexpr int R = T / 16, C = P / 16, RN = N / 16;
  extern __shared__ float smem[];
  float* xs = smem;           // T x XP
  float* bs = xs + T * XP;    // T x BN
  float* cs = bs + T * BN;    // T x BN
  float* hs = cs + T * BN;    // N x XP: the carried state
  float* ss = hs + N * XP;    // T x TT: (C B^T) .* L
  float* As = ss + T * TT;    // T
  float* ws = As + T;         // T: exp(A_T - A_j)
  const int head = blockIdx.x, bat = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_tiles = (S + T - 1) / T;
  for (int e = threadIdx.x; e < N * XP; e += THREADS) hs[e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = t * T;
    const int rows = min(T, S - s0);
    __syncthreads();  // the previous tile is done with every buffer
    load_rows<T, P>(x, xs, bat * st.xb + s0 * st.xs + head * st.xh, st.xs, rows);
    load_bc<T, N>(b, c, bs, cs, bat * st.bb + s0 * st.bs, st.bs, bat * st.cb + s0 * st.cs,
                     st.cs, rows);
    cumsum_a<T>(a, As, bat * st.ab + s0 * st.as + head * st.ah, st.as, rows);
    __syncthreads();
    const float AT = As[T - 1];
    if (threadIdx.x < T) ws[threadIdx.x] = expf(AT - As[threadIdx.x]);

    // scores: (C B^T) .* L, masked before exp
    {
      float acc[R][R] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) cv[i] = cs[(ty + 16 * i) * BN + n];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = bs[(tx + 16 * j) * BN + n];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = ty + 16 * i, q = tx + 16 * j;
          ss[r * TT + q] = r >= q ? acc[i][j] * expf(As[r] - As[q]) : 0.0f;
        }
    }
    __syncthreads();

    // y = scores X + exp(A) .* (C h)
    {
      float intra[R][C] = {}, inter[R][C] = {};
      const int jend = ty + 16 * (R - 1) + 1;  // scores past this thread's last row are 0
#pragma unroll 4
      for (int j = 0; j < jend; ++j) {
        float sv[R], xv[C];
#pragma unroll
        for (int i = 0; i < R; ++i) sv[i] = ss[(ty + 16 * i) * TT + j];
#pragma unroll
        for (int k = 0; k < C; ++k) xv[k] = xs[j * XP + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int k = 0; k < C; ++k) intra[i][k] = fmaf(sv[i], xv[k], intra[i][k]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[R], hv[C];
#pragma unroll
        for (int i = 0; i < R; ++i) cv[i] = cs[(ty + 16 * i) * BN + n];
#pragma unroll
        for (int k = 0; k < C; ++k) hv[k] = hs[n * XP + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int k = 0; k < C; ++k) inter[i][k] = fmaf(cv[i], hv[k], inter[i][k]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const float eA = expf(As[r]);
        float* out = y + ((static_cast<long long>(bat) * S + s0 + r) * H + head) * P;
#pragma unroll
        for (int k = 0; k < C; ++k) out[tx + 16 * k] = intra[i][k] + eA * inter[i][k];
      }
    }
    __syncthreads();  // every thread is done reading h

    // h <- exp(A_T) h + (B .* w)^T X; the entry state saved for the backward
    {
      float acc[RN][C] = {};
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        float bv[RN], xv[C];
        const float wj = ws[j];
#pragma unroll
        for (int i = 0; i < RN; ++i) bv[i] = bs[j * BN + ty + 16 * i] * wj;
#pragma unroll
        for (int k = 0; k < C; ++k) xv[k] = xs[j * XP + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int k = 0; k < C; ++k) acc[i][k] = fmaf(bv[i], xv[k], acc[i][k]);
      }
      const float eT = expf(AT);
      float* save = states == nullptr
                        ? nullptr
                        : states + ((static_cast<long long>(bat) * H + head) * n_tiles + t) * N * P;
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int n = ty + 16 * i, p = tx + 16 * k;
          const float old = hs[n * XP + p];
          if (save != nullptr) save[n * P + p] = old;
          hs[n * XP + p] = eT * old + acc[i][k];
        }
    }
  }
}

template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ c,
                   const float* __restrict__ dy, const float* __restrict__ states,
                   float* __restrict__ dx, float* __restrict__ da, float* __restrict__ db_part,
                   float* __restrict__ dc_part, int S, int H, Strides st) {
  constexpr int T = Tile<N, P>::T;
  constexpr int XP = P + 1, BN = N + 1, TT = T + 1;
  constexpr int R = T / 16, C = P / 16, RN = N / 16;
  extern __shared__ float smem[];
  float* xs = smem;            // T x XP
  float* dys = xs + T * XP;    // T x XP
  float* bs = dys + T * XP;    // T x BN
  float* cs = bs + T * BN;     // T x BN
  float* hin = cs + T * BN;    // N x XP: the state entering the tile
  float* dH = hin + N * XP;    // N x XP: dL/d(the state leaving the tile)
  float* m1 = dH + N * XP;     // T x TT: E .* CB
  float* m2 = m1 + T * TT;     // T x TT: E .* G
  float* m3 = m2 + T * TT;     // T x TT: E .* CB .* G
  float* wpart = m3 + T * TT;  // 16 x T: W_j's parts, one per thread column
  float* upart = wpart + 16 * T;  // 16 x T: (h_in dy_i) . c_i's parts
  float* As = upart + 16 * T;  // T
  float* ws = As + T;          // T: exp(A_T - A_j)
  float* eAs = ws + T;         // T: exp(A_i)
  float* rsum = eAs + T;       // T: row sums of m3
  float* csum = rsum + T;      // T: column sums of m3
  float* dA = csum + T;        // T
  float* red = dA + T;         // 32
  const int head = blockIdx.x, bat = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_tiles = (S + T - 1) / T;
  for (int e = threadIdx.x; e < N * XP; e += THREADS) dH[e] = 0.0f;
  const long long bh = static_cast<long long>(bat) * H + head;

  for (int t = n_tiles - 1; t >= 0; --t) {
    const int s0 = t * T;
    const int rows = min(T, S - s0);
    __syncthreads();  // the previous tile is done with every buffer
    load_rows<T, P>(x, xs, bat * st.xb + s0 * st.xs + head * st.xh, st.xs, rows);
    load_rows<T, P>(dy, dys, (static_cast<long long>(bat) * S + s0) * H * P + head * P,
                    static_cast<long long>(H) * P, rows);
    load_bc<T, N>(b, c, bs, cs, bat * st.bb + s0 * st.bs, st.bs, bat * st.cb + s0 * st.cs,
                     st.cs, rows);
    cumsum_a<T>(a, As, bat * st.ab + s0 * st.as + head * st.ah, st.as, rows);
    const float* hsave = states + (bh * n_tiles + t) * N * P;
    for (int e = threadIdx.x; e < N * P; e += THREADS) hin[(e / P) * XP + e % P] = hsave[e];
    __syncthreads();
    const float AT = As[T - 1];
    if (threadIdx.x < T) {
      ws[threadIdx.x] = expf(AT - As[threadIdx.x]);
      eAs[threadIdx.x] = expf(As[threadIdx.x]);
    }

    // E .* CB, E .* G and their product, E masked before exp
    {
      float cb[R][R] = {}, g[R][R] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) cv[i] = cs[(ty + 16 * i) * BN + n];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = bs[(tx + 16 * j) * BN + n];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float dv[R], xv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) dv[i] = dys[(ty + 16 * i) * XP + p];
#pragma unroll
        for (int j = 0; j < R; ++j) xv[j] = xs[(tx + 16 * j) * XP + p];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) g[i][j] = fmaf(dv[i], xv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = ty + 16 * i, q = tx + 16 * j;
          const float e = r >= q ? expf(As[r] - As[q]) : 0.0f;
          const float ecb = e * cb[i][j];
          m1[r * TT + q] = ecb;
          m2[r * TT + q] = e * g[i][j];
          m3[r * TT + q] = ecb * g[i][j];
        }
    }
    __syncthreads();

    // dx_j = sum_i m1[i,j] dy_i + w_j dH^T b_j
    {
      float intra[R][C] = {}, inter[R][C] = {};
#pragma unroll 4
      for (int i = ty; i < T; ++i) {  // m1[i, j] = 0 for i < j
        float mv[R], dv[C];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) mv[jj] = m1[i * TT + ty + 16 * jj];
#pragma unroll
        for (int k = 0; k < C; ++k) dv[k] = dys[i * XP + tx + 16 * k];
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
#pragma unroll
          for (int k = 0; k < C; ++k) intra[jj][k] = fmaf(mv[jj], dv[k], intra[jj][k]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float bv[R], hv[C];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) bv[jj] = bs[(ty + 16 * jj) * BN + n];
#pragma unroll
        for (int k = 0; k < C; ++k) hv[k] = dH[n * XP + tx + 16 * k];
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
#pragma unroll
          for (int k = 0; k < C; ++k) inter[jj][k] = fmaf(bv[jj], hv[k], inter[jj][k]);
      }
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        const int j = ty + 16 * jj;
        if (j >= rows) continue;
        float* out = dx + ((static_cast<long long>(bat) * S + s0 + j) * H + head) * P;
#pragma unroll
        for (int k = 0; k < C; ++k) out[tx + 16 * k] = intra[jj][k] + ws[j] * inter[jj][k];
      }
    }

    // db_j = sum_i m2[i,j] c_i + w_j dH x_j; W_j's part b_j . (dH x_j)
    {
      float intra[R][RN] = {}, inter[R][RN] = {};
#pragma unroll 2
      for (int i = ty; i < T; ++i) {  // m2[i, j] = 0 for i < j
        float mv[R], cv[RN];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) mv[jj] = m2[i * TT + ty + 16 * jj];
#pragma unroll
        for (int k = 0; k < RN; ++k) cv[k] = cs[i * BN + tx + 16 * k];
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
#pragma unroll
          for (int k = 0; k < RN; ++k) intra[jj][k] = fmaf(mv[jj], cv[k], intra[jj][k]);
      }
#pragma unroll 2
      for (int p = 0; p < P; ++p) {
        float xv[R], hv[RN];
#pragma unroll
        for (int jj = 0; jj < R; ++jj) xv[jj] = xs[(ty + 16 * jj) * XP + p];
#pragma unroll
        for (int k = 0; k < RN; ++k) hv[k] = dH[(tx + 16 * k) * XP + p];
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
#pragma unroll
          for (int k = 0; k < RN; ++k) inter[jj][k] = fmaf(xv[jj], hv[k], inter[jj][k]);
      }
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        const int j = ty + 16 * jj;
        float wp = 0.0f;
#pragma unroll
        for (int k = 0; k < RN; ++k) wp = fmaf(bs[j * BN + tx + 16 * k], inter[jj][k], wp);
        wpart[tx * T + j] = wp;
        if (j >= rows) continue;
        float* out = db_part + ((bh * S) + s0 + j) * N;
#pragma unroll
        for (int k = 0; k < RN; ++k) out[tx + 16 * k] = intra[jj][k] + ws[j] * inter[jj][k];
      }
    }

    // dc_i = sum_j m2[i,j] b_j + exp(A_i) h_in dy_i; u_i's part c_i . (h_in dy_i)
    {
      float intra[R][RN] = {}, inter[R][RN] = {};
      const int jend = ty + 16 * (R - 1) + 1;  // m2[i, j] = 0 for j > i
#pragma unroll 2
      for (int j = 0; j < jend; ++j) {
        float mv[R], bv[RN];
#pragma unroll
        for (int ii = 0; ii < R; ++ii) mv[ii] = m2[(ty + 16 * ii) * TT + j];
#pragma unroll
        for (int k = 0; k < RN; ++k) bv[k] = bs[j * BN + tx + 16 * k];
#pragma unroll
        for (int ii = 0; ii < R; ++ii)
#pragma unroll
          for (int k = 0; k < RN; ++k) intra[ii][k] = fmaf(mv[ii], bv[k], intra[ii][k]);
      }
#pragma unroll 2
      for (int p = 0; p < P; ++p) {
        float dv[R], hv[RN];
#pragma unroll
        for (int ii = 0; ii < R; ++ii) dv[ii] = dys[(ty + 16 * ii) * XP + p];
#pragma unroll
        for (int k = 0; k < RN; ++k) hv[k] = hin[(tx + 16 * k) * XP + p];
#pragma unroll
        for (int ii = 0; ii < R; ++ii)
#pragma unroll
          for (int k = 0; k < RN; ++k) inter[ii][k] = fmaf(dv[ii], hv[k], inter[ii][k]);
      }
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int i = ty + 16 * ii;
        float up = 0.0f;
#pragma unroll
        for (int k = 0; k < RN; ++k) up = fmaf(cs[i * BN + tx + 16 * k], inter[ii][k], up);
        upart[tx * T + i] = up;
        if (i >= rows) continue;
        float* out = dc_part + ((bh * S) + s0 + i) * N;
#pragma unroll
        for (int k = 0; k < RN; ++k) out[tx + 16 * k] = intra[ii][k] + eAs[i] * inter[ii][k];
      }
    }

    // the row and column sums of T = m3, in order
    if (threadIdx.x < T) {
      float s = 0.0f;
      for (int q = 0; q < T; ++q) s += m3[threadIdx.x * TT + q];
      rsum[threadIdx.x] = s;
    } else if (threadIdx.x < 2 * T) {
      const int q = threadIdx.x - T;
      float s = 0.0f;
      for (int r = 0; r < T; ++r) s += m3[r * TT + q];
      csum[q] = s;
    }
    __syncthreads();  // dx, db and dc are done reading dH

    // <dH, h_in>, then dH <- exp(A_T) dH + sum_i exp(A_i) c_i dy_i^T
    float dot = 0.0f;
    {
      float acc[RN][C] = {};
#pragma unroll 4
      for (int i = 0; i < T; ++i) {
        float cv[RN], dv[C];
        const float e = eAs[i];
#pragma unroll
        for (int k = 0; k < RN; ++k) cv[k] = cs[i * BN + ty + 16 * k] * e;
#pragma unroll
        for (int q = 0; q < C; ++q) dv[q] = dys[i * XP + tx + 16 * q];
#pragma unroll
        for (int k = 0; k < RN; ++k)
#pragma unroll
          for (int q = 0; q < C; ++q) acc[k][q] = fmaf(cv[k], dv[q], acc[k][q]);
      }
      const float eT = expf(AT);
#pragma unroll
      for (int k = 0; k < RN; ++k)
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int idx = (ty + 16 * k) * XP + tx + 16 * q;
          const float old = dH[idx];
          dot = fmaf(old, hin[idx], dot);
          dH[idx] = eT * old + acc[k][q];
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL_MASK, dot, off);
    if (lane == 0) red[warp] = dot;
    __syncthreads();

    // dA per row, then da = its reverse cumulative sum within the tile
    if (threadIdx.x < T) {
      const int k = threadIdx.x;
      float u = 0.0f, w = 0.0f;
      for (int q = 0; q < 16; ++q) {
        u += upart[q * T + k];
        w += wpart[q * T + k];
      }
      const float wk = ws[k] * w;
      dA[k] = rsum[k] - csum[k] + eAs[k] * u - wk;
      rsum[k] = wk;  // W_k, summed below
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float dot_all = 0.0f;
      for (int q = 0; q < THREADS / 32; ++q) dot_all += red[q];
      float w_all = 0.0f;
      for (int k = 0; k < T; ++k) w_all += rsum[k];
      dA[T - 1] += w_all + expf(AT) * dot_all;
      float acc = 0.0f;
      for (int k = T - 1; k >= 0; --k) {
        acc += dA[k];
        if (k < rows) da[(static_cast<long long>(bat) * S + s0 + k) * H + head] = acc;
      }
    }
  }
}

// out[b, s, n] = sum over h of part[b, h, s, n], in order; blockIdx.y
// picks db (0) or dc (1)
__global__ void __launch_bounds__(THREADS)
    head_sum_kernel(const float* __restrict__ db_part, const float* __restrict__ dc_part,
                    float* __restrict__ db, float* __restrict__ dc, long long per_batch, int H,
                    long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= total) return;
  const float* part = blockIdx.y == 0 ? db_part : dc_part;
  float* out = blockIdx.y == 0 ? db : dc;
  const long long bat = e / per_batch, rem = e % per_batch;
  const float* src = part + bat * H * per_batch + rem;
  float s = 0.0f;
  for (int h = 0; h < H; ++h) s += src[h * per_batch];
  out[e] = s;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int N, int P>
int launch_fwd(const float* x, const float* a, const float* b, const float* c, float* y,
               float* states, int B, int S, int H, const Strides& st, cudaStream_t stream) {
  constexpr int T = Tile<N, P>::T;
  const size_t smem = fwd_floats(T, N, P) * sizeof(float);
  cudaError_t err = allow_smem(ssd_fwd_kernel<N, P>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd_kernel<N, P><<<dim3(H, B), THREADS, smem, stream>>>(x, a, b, c, y, states, S, H, st);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int P>
int launch_bwd(const float* x, const float* a, const float* b, const float* c, const float* dy,
               const float* states, float* dx, float* da, float* db, float* dc,
               float* db_part, float* dc_part, int B, int S, int H, const Strides& st,
               cudaStream_t stream) {
  constexpr int T = Tile<N, P>::T;
  const size_t smem = bwd_floats(T, N, P) * sizeof(float);
  cudaError_t err = allow_smem(ssd_bwd_kernel<N, P>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel<N, P><<<dim3(H, B), THREADS, smem, stream>>>(
      x, a, b, c, dy, states, dx, da, db_part, dc_part, S, H, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_batch = static_cast<long long>(S) * N;
  const long long total = per_batch * B;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  head_sum_kernel<<<dim3(blocks, 2), THREADS, 0, stream>>>(db_part, dc_part, db, dc, per_batch,
                                                          H, total);
  return static_cast<int>(cudaGetLastError());
}

// the (N, P) pairs the kernels are built for
#define COX_SSD_SIZES(X)                                                        \
  X(16, 16) X(16, 32) X(16, 64) X(16, 128) X(32, 16) X(32, 32) X(32, 64)        \
  X(32, 128) X(64, 16) X(64, 32) X(64, 64) X(64, 128) X(128, 16) X(128, 32)     \
  X(128, 64) X(128, 128)

Strides make_strides(long long xb, long long xs, long long xh, long long ab, long long as,
                     long long ah, long long bb, long long bs, long long cb, long long cs) {
  return Strides{xb, xs, xh, ab, as, ah, bb, bs, cb, cs};
}

bool bad_shape(int B, int S, int H) {
  return B <= 0 || B > 65535 || S <= 0 || H <= 0;
}

}  // namespace

// The tile length the kernels use for state size N and head dim P (the
// states buffer holds ceil(S / tile) states a head), or 0 if they are not
// built for (N, P).
extern "C" int cox_ssd_scan_tile(int N, int P) {
#define COX_SSD_TILE(n, p) \
  if (N == n && P == p) return Tile<n, p>::T;
  COX_SSD_SIZES(COX_SSD_TILE)
#undef COX_SSD_TILE
  return 0;
}

// y (B, S, H, P) contiguous from x (B, S, H, P), a (B, S, H), b, c (B, S,
// N), all f32, read through the strides given (in elements; the last axis
// of x, b and c contiguous).  states, if not null, receives the state
// entering each tile: (B, H, ceil(S / tile), N, P) f32.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an argument the kernel does not take.
extern "C" int cox_ssd_scan(const void* x, const void* a, const void* b, const void* c, void* y,
                            void* states, int B, int S, int H, int P, int N, long long xb,
                            long long xs, long long xh, long long ab, long long as, long long ah,
                            long long bb, long long bs, long long cb, long long cs,
                            void* stream) {
  if (bad_shape(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = make_strides(xb, xs, xh, ab, as, ah, bb, bs, cb, cs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *af = static_cast<const float*>(a);
  const float *bf = static_cast<const float*>(b), *cf = static_cast<const float*>(c);
  float *yf = static_cast<float*>(y), *sf = static_cast<float*>(states);
#define COX_SSD_FWD(n, p) \
  if (N == n && P == p) return launch_fwd<n, p>(xf, af, bf, cf, yf, sf, B, S, H, st, s);
  COX_SSD_SIZES(COX_SSD_FWD)
#undef COX_SSD_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of cox_ssd_scan: dx (B, S, H, P), da (B, S, H), db, dc (B,
// S, N), contiguous f32, from the forward's inputs (same strides), its
// saved states and dy (B, S, H, P) contiguous.  db_part and dc_part are
// f32 scratch of B * H * S * N values each.  Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for an
// argument the kernels do not take.
extern "C" int cox_ssd_scan_bwd(const void* x, const void* a, const void* b, const void* c,
                                const void* dy, const void* states, void* dx, void* da,
                                void* db, void* dc, void* db_part, void* dc_part, int B, int S,
                                int H, int P, int N, long long xb, long long xs, long long xh,
                                long long ab, long long as, long long ah, long long bb,
                                long long bs, long long cb, long long cs, void* stream) {
  if (bad_shape(B, S, H) || states == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = make_strides(xb, xs, xh, ab, as, ah, bb, bs, cb, cs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *af = static_cast<const float*>(a);
  const float *bf = static_cast<const float*>(b), *cf = static_cast<const float*>(c);
  const float *dyf = static_cast<const float*>(dy), *sf = static_cast<const float*>(states);
  float *dxf = static_cast<float*>(dx), *daf = static_cast<float*>(da);
  float *dbf = static_cast<float*>(db), *dcf = static_cast<float*>(dc);
  float *dbp = static_cast<float*>(db_part), *dcp = static_cast<float*>(dc_part);
#define COX_SSD_BWD(n, p)                                                                      \
  if (N == n && P == p)                                                                        \
    return launch_bwd<n, p>(xf, af, bf, cf, dyf, sf, dxf, daf, dbf, dcf, dbp, dcp, B, S, H, st, \
                            s);
  COX_SSD_SIZES(COX_SSD_BWD)
#undef COX_SSD_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
