// Mamba2 SSD (state-space duality) scan, forward and gradient, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (pallas_call in ssd_scan).  Per head, with the log-decay a <= 0 and the
// state h (N, P) starting at 0:  h_t = exp(a_t) h_{t-1} + b_t x_t^T,
// y_t = c_t^T h_t.  b and c (N wide) are shared by every head.  The TPU
// kernel walks a grid (heads, chunks) whose chunk axis runs in order and
// carries h in VMEM scratch.  Here the sequence is cut into tiles of T rows
// and every (batch row, tile) is a block of its own (the SSD algorithm of
// Dao & Gu, "Transformers are SSMs", section 6).  Per tile, with A the
// cumulative sum of a within the tile and A_T its last entry (the dual
// form, exact for any T):
//
//   y = ((C B^T) .* L) X + exp(A) .* (C h_in),  L[i,j] = exp(A_i - A_j) [i >= j]
//   h_out = exp(A_T) h_in + S,  S = (B .* exp(A_T - A))^T X
//
// with the exponent masked before exp, so no entry overflows.  Only the
// N x P axpy h_out = exp(A_T) h_in + S is sequential across tiles; the
// products are not.  So a block computes its tile's C B^T once for all
// heads, and per head S and the intra-tile output first, then waits for
// h_in, publishes h_out and finishes y.  h_in comes from the block of the
// previous tile through global memory behind a flag (a chained scan: CUB's
// decoupled look-back with a look-back of one).  Blocks take their tile
// from an atomic ticket in tile order, so a block waits only on one that
// is already running and the grid cannot deadlock; the ticket and the
// flags are the only atomics, and every sum keeps a fixed order.  The exchange buffer is
// `states` (B, H, tiles, N, P), the state entering each tile, which the
// backward reads.  A tail tile (S not a multiple of T) is padded with zero
// rows and a = 0, which add nothing to y or h.
//
// The products run on the tensor cores at f32 accuracy: 3xTF32.  Each f32
// operand v is split into hi, v cut to TF32 (toward zero), and lo, the
// rest cut the same way, and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b
// with f32 accumulation (mma.sync m16n8k8, three instructions for one
// f32-accurate product).  Plain TF32 misses the kernels' tolerance, 1e-4 of
// the largest magnitude (tests/test_torch_ssd_rounding.py: 5.8e-4 at a
// mamba2 head, against about 1e-6 for this split and for f32 FMAs).  The
// masks, decays and cumulative sums stay f32 on the CUDA cores; the tile's
// cumulative sum is one warp's shuffle scan.
// Operands are read from shared memory whose rows are padded so that a
// fragment's 32 loads fall in 32 banks: an operand whose k runs along its
// rows is read with k = (t, t + 4) for lane t of a group ("natural") and
// one whose k runs down its columns with k = (2t, 2t + 1) ("paired"), so a
// row pitch of 4 (mod 32) words serves both; two operands of the backward
// read with a two-way conflict.
//
// The tile: T = 64 rows, or 32 where the backward's tiles would not fit a
// block's shared memory (N = P = 128).  At mamba2-130m's training shape
// (B 8, S 4,096, 24 heads, P 64, N 128) T = 64 gives 512 blocks of 16
// warps, 3.9 waves of one block an SM, 98 GFLOP of TF32 products forward
// and 403 MB of states; T = 128 would halve the states and add a fifth to
// the products, but its backward tiles do not fit in 227 KB.  The forward
// loads the next head's X by cp.async while it computes this one's, and
// masks C B^T once a head into shared memory ((C B^T) .* L, one exp an
// entry), so the intra-tile product's operands are plain loads and its
// triangular rows cost their warps no more than the others'.
//
// cox_ssd_scan_bwd is the gradient (the TPU kernel has none: the reference
// trains through autodiff of its plain chunked form).  It walks the same
// chain in reverse, carrying dH = dL/dh_out (zero after the last tile)
// through a second exchange buffer.  Per tile and head, with E[i,j] =
// exp(A_i - A_j) [i >= j], CB = C B^T, G = dY X^T, w_j = exp(A_T - A_j):
//
//   dX = (E .* CB)^T dY + w .* (B dH)
//   dB = sum over heads of (E .* G)^T C + w .* (X dH^T)
//   dC = sum over heads of (E .* G) B + exp(A) .* (dY h_in^T)
//   dA_k = sum_j T[k,j] - sum_i T[i,k] + exp(A_k) dy_k . (c_k^T h_in) - W_k,
//          T = E .* CB .* G,  W_j = w_j b_j^T dH x_j,
//          dA_{T-1} += sum_j W_j + exp(A_T) <dH, h_in>
//   da   = the reverse cumulative sum of dA within the tile
//   dH  <- exp(A_T) dH + (exp(A) .* C)^T dY      (the chained part)
//
// A block owns a (batch row, tile) and walks its heads in order, so db and
// dc are summed over the heads in registers: no scratch, no atomics on
// data, the same bits every run.
//
// Bound: operations.  At the training shape and T = 64 the forward does
// 32.8 GFLOP of f32-accurate products (98 GFLOP as TF32) against 0.84 GB
// of inputs, outputs and states, the backward 91 GFLOP (273 as TF32).  The
// least time for the scan's least work with its products as 3xTF32 at 495
// TFLOP/s is 0.17 ms forward and 0.38 backward (chip_smoke.py's
// bound_3xtf32_ms); the kernels take about six times that on the H100
// (PERF.md).  mma.sync reaches about 300 TFLOP/s of TF32 there, and each
// product's fragments cost loads and splits, so the products are bound by
// instruction issue; a head's chain step and barriers add about a quarter
// (scripts/ssd_phases.py).  The operand splits, done once a tile instead
// of once a fragment, and fewer barriers are what is left.
//
// All inputs f32 (the model path casts them: src/repro/models/layers.py
// mamba2_apply).  x, b and c are read through their strides (batch,
// sequence, head) with the last axis contiguous, so b and c may be slices
// of the conv output; a through its three strides.  y, dy and the
// gradients are contiguous.  Built for N, P in {16, 32, 64, 128}.
#include "common.cuh"
#include "wgmma.cuh"  // cp.async

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

// Row pitches (floats): 4 (mod 32) for every operand tile, 8 (mod 32) for
// the two read only as a natural column operand.
__host__ __device__ constexpr int pitch4(int cols) { return cols + 4; }
__host__ __device__ constexpr int pitch8(int cols) { return cols + 8; }

// shared floats of each kernel at tile length T
__host__ __device__ constexpr size_t fwd_floats(int T, int N, int P) {
  return 2 * static_cast<size_t>(T) * pitch4(N) + 2 * static_cast<size_t>(T) * pitch4(P) +
         2 * static_cast<size_t>(T) * pitch8(T) + static_cast<size_t>(N) * pitch8(P) + 6 * T;
}
__host__ __device__ constexpr size_t bwd_floats(int T, int N, int P) {
  return 2 * static_cast<size_t>(T) * pitch4(N) + 2 * static_cast<size_t>(T) * pitch4(P) +
         2 * static_cast<size_t>(T) * pitch4(T) + static_cast<size_t>(N) * pitch4(P) +
         static_cast<size_t>(N) * pitch8(P) + 5 * T + 2 * WARPS * T + WARPS;
}

template <int N, int P> struct Tile {
  static constexpr int T = bwd_floats(64, N, P) * sizeof(float) <= MAX_SMEM ? 64 : 32;
  static_assert(bwd_floats(T, N, P) * sizeof(float) <= MAX_SMEM, "tile does not fit");
  static_assert(fwd_floats(T, N, P) * sizeof(float) <= MAX_SMEM, "tile does not fit");
};

// How the warps tile an R x C output: WR x WC warps, each MT x NT tiles of
// 16 x 8; warps past WR * WC sit the product out.  Warp w takes column
// w % WC and row w / WC: an SM runs warp w on its sub-partition w % 4, so
// each sub-partition gets every row of the triangular products, not one.
template <int R, int C> struct WarpGrid {
  static constexpr int WR = R / 16 < 4 ? R / 16 : 4;
  static constexpr int WC = C / 8 < WARPS / WR ? C / 8 : WARPS / WR;
  static constexpr int MT = R / 16 / WR, NT = C / 8 / WC;
  static constexpr int ACTIVE = WR * WC;
  __device__ static int row0(int warp) { return (warp / WC) * 16 * MT; }
  __device__ static int col0(int warp) { return (warp % WC) * 8 * NT; }
};

struct Strides {  // in elements
  long long xb, xs, xh;  // x (B, S, H, P): batch, sequence, head
  long long ab, as, ah;  // a (B, S, H)
  long long bb, bs;      // b (B, S, N)
  long long cb, cs;      // c (B, S, N)
};

// ---------------------------------------------------------------------------
// 3xTF32 products on the tensor cores
// ---------------------------------------------------------------------------

// v = hi + lo + (less than 2^-20 |v|): hi is v cut to TF32's 10-bit
// mantissa (toward zero), lo the rest cut the same way.  A mask, a
// subtraction and a mask; cvt.rna.tf32.f32 has no instruction on sm_90 and
// costs four (CUTLASS's fast f32 split does the same).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// fn(mt, nt, e, row, col) over one warp's accumulator by pairs: pair e of
// tile (mt, nt) holds elements 2e and 2e + 1, at (row, col) and (row, col +
// 1) relative to the warp's tile; the indices are compile-time once
// unrolled, so arrays indexed by them stay in registers
template <int MT, int NT, typename F>
__device__ __forceinline__ void for_pair(F fn) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) fn(mt, nt, e, 16 * mt + g + 8 * e, 8 * nt + 2 * t);
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

template <int MT, int NT>
__device__ __forceinline__ void add_acc(float (&sum)[MT][NT][4], const float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][nt][e] += acc[mt][nt][e];
}

// acc += A B over k in [k_begin, k_end) (multiples of 8), for one warp's
// MT x NT tiles of 16 x 8: fa(m, k) is A at the warp's row m, fb(k, n) is B
// at its column n.  Lane (g, t) = (lane / 4, lane % 4) reads k = k0 + t and
// k0 + t + 4, or with PAIRED k0 + 2t and k0 + 2t + 1 (mma's k order is free
// as long as A and B share it).  Accumulator element e of a tile sits at
// row g + 8 (e / 2), column 2t + e % 2.  The small terms lo hi + hi lo sum
// into accumulators of their own, added at the end: two independent mma
// chains a tile, and each chain's neighbours are the other tiles'.
template <int MT, int NT, bool PAIRED, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], int k_begin, int k_end,
                                         FA fa, FB fb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float small[MT][NT][4] = {};
#pragma unroll 4
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    const int ka = PAIRED ? k0 + 2 * t : k0 + t;
    const int kb = PAIRED ? ka + 1 : ka + 4;
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = 16 * mt + g;
      split_tf32(fa(m, ka), ah[mt][0], al[mt][0]);
      split_tf32(fa(m + 8, ka), ah[mt][1], al[mt][1]);
      split_tf32(fa(m, kb), ah[mt][2], al[mt][2]);
      split_tf32(fa(m + 8, kb), ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + g;
      split_tf32(fb(ka, n), bh[nt][0], bl[nt][0]);
      split_tf32(fb(kb, n), bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(small[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(small[mt][nt], ah[mt], bl[nt]);
  }
  add_acc(acc, small);
}

// fn(row, col, acc[mt][nt][e]) over one warp's accumulator, row and column
// relative to the warp's tile
template <int MT, int NT, typename F>
__device__ __forceinline__ void for_acc(float (&acc)[MT][NT][4], F fn) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(16 * mt + g + 8 * (e / 2), 8 * nt + 2 * t + e % 2, acc[mt][nt][e]);
}

// For one warp's tile acc at (row r0, column q0) of a T-row output: out[r]
// = sum over the warp's columns q of m[r, q] acc[r, q] (m with pitch ld;
// the four lanes of a row summed by shuffles, in a fixed order), then
// acc[r, :] *= scale[r].
template <int MT, int NT>
__device__ __forceinline__ void row_dot_scale(float (&acc)[MT][NT][4], const float* m, int ld,
                                              int r0, int q0, const float* scale, float* out) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 16 * mt + g + 8 * half;
      float s = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = acc[mt][nt][2 * half + e];
          s = fmaf(m[r * ld + q0 + 8 * nt + 2 * t + e], v, s);
          v *= scale[r];
        }
      s += __shfl_xor_sync(FULL_MASK, s, 1);
      s += __shfl_xor_sync(FULL_MASK, s, 2);
      if (t == 0) out[r] = s;
    }
}

// ---------------------------------------------------------------------------
// tiles, decays and the chain's flags
// ---------------------------------------------------------------------------

// Rows [0, rows) of a T x W tile (row r at src + r * stride, W contiguous
// floats) into dst with pitch ld, by cp.async; rows past `rows` land as
// zero.  vec: the source rows are 16-byte aligned.  The copies land while
// the block computes; a cp_async_wait and a barrier make them visible.
template <int T, int W>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, long long stride,
                                          int rows, float* dst, int ld, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < T * W / 4; e += THREADS) {
      const int r = e / (W / 4), q = (e % (W / 4)) * 4;
      wg::cp_async16(wg::smem_u32(dst + r * ld + q), src + (r < rows ? r * stride + q : 0),
                     r < rows ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < T * W; e += THREADS) {
      const int r = e / W, q = e % W;
      wg::cp_async4(wg::smem_u32(dst + r * ld + q), src + (r < rows ? r * stride + q : 0),
                    r < rows ? 4 : 0);
    }
  }
}

// One lane's T / 32 consecutive entries of a over the tile (0 past the
// last row)
template <int T>
__device__ __forceinline__ void load_decays(const float* __restrict__ a, long long off,
                                            long long stride, int rows, float (&v)[T / 32]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < T / 32; ++e) {
    const int r = lane * (T / 32) + e;
    v[e] = r < rows ? __ldg(a + off + r * stride) : 0.0f;
  }
}

// One warp, from load_decays' values: A = the cumulative sum of a over the
// tile, w = exp(A_T - A), eA = exp(A).  Each lane sums its entries in
// order, then an inclusive shuffle scan runs over the lanes: a fixed
// order, the same bits every run.
template <int T>
__device__ __forceinline__ void decays_of(const float (&v)[T / 32], float* As, float* ws,
                                          float* eAs) {
  constexpr int E = T / 32;
  const int lane = threadIdx.x % 32;
  float run = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) run += v[e];
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += u;
  }
  run = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) run = 0.0f;
  float A[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += v[e];
    A[e] = run;
  }
  const float AT = __shfl_sync(FULL_MASK, run, 31);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = lane * E + e;
    As[r] = A[e];
    ws[r] = expf(AT - A[e]);
    eAs[r] = expf(A[e]);
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Thread 0 waits for a neighbour tile's flag.  The neighbour holds an
// earlier ticket, so it is running or done; a wait of seconds means a
// fault, and traps rather than hanging the card.
__device__ __forceinline__ void wait_flag(const int* flag) {
  unsigned spins = 0;
  while (ld_acquire(flag) == 0) {
    __nanosleep(64);
    if (++spins == (1u << 26)) __trap();
  }
}

// Raise a flag once every thread's stores of the exchange buffer are done:
// the barrier orders them before thread 0's release store (the pattern of
// CUTLASS's semaphore), and the reader's acquire load pairs with it.
__device__ __forceinline__ void publish(int* flag, bool raise) {
  __syncthreads();
  if (threadIdx.x == 0 && raise) st_release(flag, 1);
}

__device__ __forceinline__ int take_ticket(int* counter) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  return ticket;
}

// C B^T (T x T, over N) into cbs (pitch ldt), once a block for all heads
template <int T, int N>
__device__ __forceinline__ void tile_cb(const float* cs, const float* bs, float* cbs, int ldt) {
  using W = WarpGrid<T, T>;
  constexpr int LN = pitch4(N);
  const int warp = threadIdx.x / 32;
  if (warp >= W::ACTIVE) return;
  const int r0 = W::row0(warp), q0 = W::col0(warp);
  float acc[W::MT][W::NT][4] = {};
  warp_mma<W::MT, W::NT, false>(
      acc, 0, N, [&](int m, int k) { return cs[(r0 + m) * LN + k]; },
      [&](int k, int n) { return bs[(q0 + n) * LN + k]; });
  for_acc(acc, [&](int r, int q, float v) { cbs[(r0 + r) * ldt + q0 + q] = v; });
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ c,
                   float* __restrict__ y, float* __restrict__ states, int* __restrict__ sync,
                   int B, int S, int H, Strides st, int vec) {
  constexpr int T = Tile<N, P>::T;
  constexpr int LN = pitch4(N), LP = pitch4(P), LT = pitch8(T), LH = pitch8(P);
  using WS = WarpGrid<N, P>;  // S = (B .* w)^T X
  using WY = WarpGrid<T, P>;  // y
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;           // T x LN
  float* cs = bs + T * LN;    // T x LN
  float* xbuf = cs + T * LN;  // 2 x T x LP: X of this head and of the next
  float* cbs = xbuf + 2 * T * LP;  // T x LT: C B^T
  float* ms = cbs + T * LT;   // T x LT: this head's (C B^T) .* L
  float* hs = ms + T * LT;    // N x LH: the state entering the tile
  float* decays = hs + N * LH;  // 2 x 3T: A, exp(A_T - A), exp(A) of this head and the next
  const int n_tiles = (S + T - 1) / T;
  const int ticket = take_ticket(sync);
  int* flags = sync + 1;  // (B, H, tiles): states[b, h, tile] is written
  const int tile = ticket / B, bat = ticket % B;
  const int s0 = tile * T, rows = min(T, S - s0);
  const int warp = threadIdx.x / 32;
  const float* x_tile = x + bat * st.xb + s0 * st.xs;
  const long long a_tile = bat * st.ab + s0 * st.as;

  load_tile<T, N>(b + bat * st.bb + s0 * st.bs, st.bs, rows, bs, LN, vec);
  load_tile<T, N>(c + bat * st.cb + s0 * st.cs, st.cs, rows, cs, LN, vec);
  load_tile<T, P>(x_tile, st.xs, rows, xbuf, LP, vec);
  wg::cp_async_commit();
  float a_next[T / 32];
  if (warp == WARPS - 1) {
    load_decays<T>(a, a_tile, st.as, rows, a_next);
    decays_of<T>(a_next, decays, decays + T, decays + 2 * T);
    if (H > 1) load_decays<T>(a, a_tile + st.ah, st.as, rows, a_next);
  }
  wg::cp_async_wait<0>();
  __syncthreads();
  tile_cb<T, N>(cs, bs, cbs, LT);

  for (int head = 0; head < H; ++head) {
    float* xs = xbuf + (head % 2) * T * LP;
    const float* As = decays + (head % 2) * 3 * T;
    const float* ws = As + T;   // exp(A_T - A_j)
    const float* eAs = ws + T;  // exp(A_i)
    __syncthreads();  // the previous head is done with the other X and decays, ms and hs
    if (head + 1 < H)  // the next head's X lands while this one computes
      load_tile<T, P>(x_tile + (head + 1) * st.xh, st.xs, rows, xbuf + ((head + 1) % 2) * T * LP,
                      LP, vec);
    wg::cp_async_commit();
    // (C B^T) .* L once a head, the exponent masked before exp; the next
    // head's decays meanwhile
    for (int e = threadIdx.x; e < T * T; e += THREADS) {
      const int i = e / T, k = e % T;
      ms[i * LT + k] = i >= k ? cbs[i * LT + k] * __expf(As[i] - As[k]) : 0.0f;
    }
    if (warp == WARPS - 1 && head + 1 < H) {
      float* next = decays + ((head + 1) % 2) * 3 * T;
      decays_of<T>(a_next, next, next + T, next + 2 * T);
      if (head + 2 < H) load_decays<T>(a, a_tile + (head + 2) * st.ah, st.as, rows, a_next);
    }
    wg::cp_async_wait<1>();  // this head's X
    __syncthreads();

    // the tile's own work: S and the intra-tile output
    float sacc[WS::MT][WS::NT][4] = {};
    float yacc[WY::MT][WY::NT][4] = {};
    const int n0 = WS::row0(warp), p0 = WS::col0(warp);
    if (warp < WS::ACTIVE)
      warp_mma<WS::MT, WS::NT, true>(
          sacc, 0, T, [&](int m, int k) { return bs[k * LN + n0 + m] * ws[k]; },
          [&](int k, int n) { return xs[k * LP + p0 + n]; });
    const int i0 = WY::row0(warp), q0 = WY::col0(warp);
    if (warp < WY::ACTIVE)  // L[i, j] = 0 for j > i: k stops at the warp's last row
      warp_mma<WY::MT, WY::NT, true>(
          yacc, 0, i0 + 16 * WY::MT,
          [&](int m, int k) { return ms[(i0 + m) * LT + k]; },
          [&](int k, int n) { return xs[k * LP + q0 + n]; });

    // the chain: h_in from the previous tile, h_out to the next
    const long long bh = static_cast<long long>(bat) * H + head;
    float* h_in = states + (bh * n_tiles + tile) * N * P;
    if (tile > 0 && threadIdx.x == 0) wait_flag(flags + bh * n_tiles + tile);
    __syncthreads();
    if (warp < WS::ACTIVE) {
      const float eT = expf(As[T - 1]);
      float2 h[WS::MT][WS::NT][2];
      for_pair<WS::MT, WS::NT>([&](int mt, int nt, int e, int r, int q) {
        const float2* src = reinterpret_cast<const float2*>(h_in + (n0 + r) * P + p0 + q);
        h[mt][nt][e] = tile > 0 ? __ldcg(src) : make_float2(0.0f, 0.0f);
      });
      for_pair<WS::MT, WS::NT>([&](int mt, int nt, int e, int r, int q) {
        const int n = n0 + r, p = p0 + q;
        const float2 v = h[mt][nt][e];
        if (tile == 0) *reinterpret_cast<float2*>(h_in + n * P + p) = v;
        hs[n * LH + p] = v.x;
        hs[n * LH + p + 1] = v.y;
        if (tile + 1 < n_tiles)  // h_out, the next tile's h_in
          __stcg(reinterpret_cast<float2*>(h_in + N * P + n * P + p),
                 make_float2(fmaf(eT, v.x, sacc[mt][nt][2 * e]),
                             fmaf(eT, v.y, sacc[mt][nt][2 * e + 1])));
      });
    }
    publish(flags + bh * n_tiles + tile + 1, tile + 1 < n_tiles);

    // y = intra + exp(A) .* (C h_in)
    if (warp < WY::ACTIVE) {
      float inter[WY::MT][WY::NT][4] = {};
      warp_mma<WY::MT, WY::NT, false>(
          inter, 0, N, [&](int m, int k) { return cs[(i0 + m) * LN + k]; },
          [&](int k, int n) { return hs[k * LH + q0 + n]; });
      float* out = y + ((static_cast<long long>(bat) * S + s0) * H + head) * P;
      for_pair<WY::MT, WY::NT>([&](int mt, int nt, int e, int r, int q) {
        const int i = i0 + r;
        if (i >= rows) return;
        const float eA = eAs[i];
        *reinterpret_cast<float2*>(out + static_cast<long long>(i) * H * P + q0 + q) =
            make_float2(fmaf(eA, inter[mt][nt][2 * e], yacc[mt][nt][2 * e]),
                        fmaf(eA, inter[mt][nt][2 * e + 1], yacc[mt][nt][2 * e + 1]));
      });
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int N, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ c,
                   const float* __restrict__ dy, const float* __restrict__ states,
                   float* __restrict__ dx, float* __restrict__ da, float* __restrict__ db,
                   float* __restrict__ dc, float* __restrict__ dh_x, int* __restrict__ sync,
                   int B, int S, int H, Strides st, int vec) {
  constexpr int T = Tile<N, P>::T;
  constexpr int LN = pitch4(N), LP = pitch4(P), LT = pitch4(T), LH = pitch8(P);
  using WT = WarpGrid<T, T>;  // G = dY X^T
  using WU = WarpGrid<N, P>;  // the chained term (exp(A) .* C)^T dY
  using WX = WarpGrid<T, P>;  // dX
  using WB = WarpGrid<T, N>;  // dB, dC
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;             // T x LN
  float* cs = bs + T * LN;      // T x LN
  float* xs = cs + T * LN;      // T x LP
  float* dys = xs + T * LP;     // T x LP
  float* cbs = dys + T * LP;    // T x LT: C B^T
  float* egs = cbs + T * LT;    // T x LT: E .* G
  float* hin = egs + T * LT;    // N x LP: the state entering the tile
  float* dhs = hin + N * LP;    // N x LH: dL/d(the state leaving the tile)
  float* As = dhs + N * LH;     // T
  float* ws = As + T;           // T: exp(A_T - A_j)
  float* eAs = ws + T;          // T: exp(A_i)
  float* rsum = eAs + T;        // T: row sums of E .* CB .* G
  float* csum = rsum + T;       // T: its column sums
  float* upart = csum + T;      // WARPS x T: dy_i . (c_i^T h_in), a part per warp column
  float* wpart = upart + WARPS * T;  // WARPS x T: b_j^T dH x_j, a part per warp column
  float* red = wpart + WARPS * T;    // WARPS: <dH, h_in>, a part per warp
  const int n_tiles = (S + T - 1) / T;
  const int ticket = take_ticket(sync);
  int* flags = sync + 1;  // (B, H, tiles): dh_x[b, h, tile] is written
  const int tile = n_tiles - 1 - ticket / B, bat = ticket % B;
  const int s0 = tile * T, rows = min(T, S - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<T, N>(b + bat * st.bb + s0 * st.bs, st.bs, rows, bs, LN, vec);
  load_tile<T, N>(c + bat * st.cb + s0 * st.cs, st.cs, rows, cs, LN, vec);
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  __syncthreads();
  tile_cb<T, N>(cs, bs, cbs, LT);

  const int j0 = WB::row0(warp), m0 = WB::col0(warp);  // dB and dC tiles
  float db_tot[WB::MT][WB::NT][4] = {}, dc_tot[WB::MT][WB::NT][4] = {};
  for (int head = 0; head < H; ++head) {
    const long long bh = static_cast<long long>(bat) * H + head;
    __syncthreads();  // the previous head is done with every per-head buffer
    load_tile<T, P>(x + bat * st.xb + s0 * st.xs + head * st.xh, st.xs, rows, xs, LP, vec);
    load_tile<T, P>(dy + (static_cast<long long>(bat) * S + s0) * H * P + head * P,
                    static_cast<long long>(H) * P, rows, dys, LP, vec);
    load_tile<N, P>(states + (bh * n_tiles + tile) * N * P, P, N, hin, LP, true);
    wg::cp_async_commit();
    if (warp == WARPS - 1) {
      float av[T / 32];
      load_decays<T>(a, bat * st.ab + s0 * st.as + head * st.ah, st.as, rows, av);
      decays_of<T>(av, As, ws, eAs);
    }
    wg::cp_async_wait<0>();
    __syncthreads();

    // E .* G into egs; the chained term U = (exp(A) .* C)^T dY in registers
    if (warp < WT::ACTIVE) {
      const int r0 = WT::row0(warp), q0 = WT::col0(warp);
      float acc[WT::MT][WT::NT][4] = {};
      warp_mma<WT::MT, WT::NT, false>(
          acc, 0, P, [&](int m, int k) { return dys[(r0 + m) * LP + k]; },
          [&](int k, int n) { return xs[(q0 + n) * LP + k]; });
      for_acc(acc, [&](int r, int q, float v) {
        const int i = r0 + r, j = q0 + q;
        egs[i * LT + j] = i >= j ? __expf(As[i] - As[j]) * v : 0.0f;
      });
    }
    float uacc[WU::MT][WU::NT][4] = {};
    const int n0 = WU::row0(warp), p0 = WU::col0(warp);
    if (warp < WU::ACTIVE)
      warp_mma<WU::MT, WU::NT, true>(
          uacc, 0, T, [&](int m, int k) { return cs[k * LN + n0 + m] * eAs[k]; },
          [&](int k, int n) { return dys[k * LP + p0 + n]; });
    __syncthreads();  // egs is written

    // the row and column sums of E .* CB .* G, each in order
    if (threadIdx.x < T) {
      float s = 0.0f;
      for (int q = 0; q < T; ++q) s = fmaf(cbs[threadIdx.x * LT + q], egs[threadIdx.x * LT + q], s);
      rsum[threadIdx.x] = s;
    } else if (threadIdx.x < 2 * T) {
      const int q = threadIdx.x - T;
      float s = 0.0f;
      for (int r = 0; r < T; ++r) s = fmaf(cbs[r * LT + q], egs[r * LT + q], s);
      csum[q] = s;
    }

    // the chain: dH from the next tile, exp(A_T) dH + U to the previous one
    float* dh_in = dh_x + (bh * n_tiles + tile) * N * P;
    if (tile + 1 < n_tiles && threadIdx.x == 0) wait_flag(flags + bh * n_tiles + tile);
    __syncthreads();
    float dot = 0.0f;
    if (warp < WU::ACTIVE) {
      const float eT = expf(As[T - 1]);
      float2 d[WU::MT][WU::NT][2];
      for_pair<WU::MT, WU::NT>([&](int mt, int nt, int e, int r, int q) {
        const float2* src = reinterpret_cast<const float2*>(dh_in + (n0 + r) * P + p0 + q);
        d[mt][nt][e] = tile + 1 < n_tiles ? __ldcg(src) : make_float2(0.0f, 0.0f);
      });
      for_pair<WU::MT, WU::NT>([&](int mt, int nt, int e, int r, int q) {
        const int n = n0 + r, p = p0 + q;
        const float2 v = d[mt][nt][e];
        dhs[n * LH + p] = v.x;
        dhs[n * LH + p + 1] = v.y;
        dot = fmaf(v.x, hin[n * LP + p], dot);
        dot = fmaf(v.y, hin[n * LP + p + 1], dot);
        if (tile > 0)  // the previous tile's dH
          __stcg(reinterpret_cast<float2*>(dh_in - N * P + n * P + p),
                 make_float2(fmaf(eT, v.x, uacc[mt][nt][2 * e]),
                             fmaf(eT, v.y, uacc[mt][nt][2 * e + 1])));
      });
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL_MASK, dot, off);
    if (lane == 0) red[warp] = dot;
    publish(flags + bh * n_tiles + tile - 1, tile > 0);

    // dX = (E .* CB)^T dY + w .* (B dH)
    if (warp < WX::ACTIVE) {
      const int r0 = WX::row0(warp), q0 = WX::col0(warp);
      float acc[WX::MT][WX::NT][4] = {};
      warp_mma<WX::MT, WX::NT, false>(
          acc, 0, N, [&](int m, int k) { return bs[(r0 + m) * LN + k]; },
          [&](int k, int n) { return dhs[k * LH + q0 + n]; });
      for_acc(acc, [&](int r, int, float& v) { v *= ws[r0 + r]; });
      warp_mma<WX::MT, WX::NT, true>(  // E[i, j] = 0 for i < j: k starts at the warp's first row
          acc, r0, T,
          [&](int m, int k) {
            const int j = r0 + m;
            return k >= j ? cbs[k * LT + j] * __expf(As[k] - As[j]) : 0.0f;
          },
          [&](int k, int n) { return dys[k * LP + q0 + n]; });
      float* out = dx + ((static_cast<long long>(bat) * S + s0) * H + head) * P;
      for_acc(acc, [&](int r, int q, float v) {
        if (r0 + r < rows) out[static_cast<long long>(r0 + r) * H * P + q0 + q] = v;
      });
    }

    // this head's dB and dC, each summed into the block's total
    if (warp < WB::ACTIVE) {
      float* wcol = wpart + (warp % WB::WC) * T;
      float* ucol = upart + (warp % WB::WC) * T;
      float acc[WB::MT][WB::NT][4] = {};
      // w .* (X dH^T) + (E .* G)^T C, W_j's part b_j . (dH x_j) on the way
      warp_mma<WB::MT, WB::NT, false>(
          acc, 0, P, [&](int m, int k) { return xs[(j0 + m) * LP + k]; },
          [&](int k, int n) { return dhs[(m0 + n) * LH + k]; });
      row_dot_scale(acc, bs, LN, j0, m0, ws, wcol);
      warp_mma<WB::MT, WB::NT, true>(  // (E .* G)[i, j] = 0 for i < j
          acc, j0, T, [&](int m, int k) { return egs[k * LT + j0 + m]; },
          [&](int k, int n) { return cs[k * LN + m0 + n]; });
      add_acc(db_tot, acc);

      // exp(A) .* (dY h_in^T) + (E .* G) B, u_i's part c_i . (h_in dy_i) on the way
      zero_acc(acc);
      warp_mma<WB::MT, WB::NT, false>(
          acc, 0, P, [&](int m, int k) { return dys[(j0 + m) * LP + k]; },
          [&](int k, int n) { return hin[(m0 + n) * LP + k]; });
      row_dot_scale(acc, cs, LN, j0, m0, eAs, ucol);
      warp_mma<WB::MT, WB::NT, false>(  // (E .* G)[i, j] = 0 for j > i
          acc, 0, j0 + 16 * WB::MT, [&](int m, int k) { return egs[(j0 + m) * LT + k]; },
          [&](int k, int n) { return bs[k * LN + m0 + n]; });
      add_acc(dc_tot, acc);
    }
    __syncthreads();  // the parts are written

    // dA per row, then da = its reverse cumulative sum within the tile (one
    // warp, each lane T / 32 consecutive rows, a fixed order)
    if (warp == 0) {
      constexpr int E = T / 32;
      float d[E], wsum = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = lane * E + e;
        float u = 0.0f, wv = 0.0f;
        for (int q = 0; q < WB::WC; ++q) {
          u += upart[q * T + k];
          wv += wpart[q * T + k];
        }
        const float wk = ws[k] * wv;
        d[e] = rsum[k] - csum[k] + eAs[k] * u - wk;
        wsum += wk;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(FULL_MASK, wsum, off);
      float dot_all = 0.0f;
      for (int q = 0; q < WARPS; ++q) dot_all += red[q];
      if (lane == 31) d[E - 1] += wsum + expf(As[T - 1]) * dot_all;
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) run += d[e];
      float incl = run;  // the sum over this lane's rows and every later lane's
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(FULL_MASK, incl, o);
        if (lane + o < 32) incl += v;
      }
      run = __shfl_down_sync(FULL_MASK, incl, 1);
      if (lane == 31) run = 0.0f;
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        run += d[e];
        const int k = lane * E + e;
        if (k < rows) da[(static_cast<long long>(bat) * S + s0 + k) * H + head] = run;
      }
    }
  }

  if (warp < WB::ACTIVE) {
    const long long base = static_cast<long long>(bat) * S + s0;
    for_acc(db_tot, [&](int r, int q, float v) {
      if (j0 + r < rows) db[(base + j0 + r) * N + m0 + q] = v;
    });
    for_acc(dc_tot, [&](int r, int q, float v) {
      if (j0 + r < rows) dc[(base + j0 + r) * N + m0 + q] = v;
    });
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int N, int P>
int launch_fwd(const float* x, const float* a, const float* b, const float* c, float* y,
               float* states, int* sync, int B, int S, int H, const Strides& st, int vec,
               cudaStream_t stream) {
  constexpr int T = Tile<N, P>::T;
  const size_t smem = fwd_floats(T, N, P) * sizeof(float);
  cudaError_t err = allow_smem(ssd_fwd_kernel<N, P>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * ((S + T - 1) / T);
  ssd_fwd_kernel<N, P><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      x, a, b, c, y, states, sync, B, S, H, st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int P>
int launch_bwd(const float* x, const float* a, const float* b, const float* c, const float* dy,
               const float* states, float* dx, float* da, float* db, float* dc, float* dh_x,
               int* sync, int B, int S, int H, const Strides& st, int vec, cudaStream_t stream) {
  constexpr int T = Tile<N, P>::T;
  const size_t smem = bwd_floats(T, N, P) * sizeof(float);
  cudaError_t err = allow_smem(ssd_bwd_kernel<N, P>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * ((S + T - 1) / T);
  ssd_bwd_kernel<N, P><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      x, a, b, c, dy, states, dx, da, db, dc, dh_x, sync, B, S, H, st, vec);
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

// x, b and c rows load as 16-byte vectors: aligned bases, strides of whole
// vectors
int vector_rows(const void* x, const void* b, const void* c, const Strides& st) {
  const auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const auto v4 = [](long long s) { return s % 4 == 0; };
  return al(x) && al(b) && al(c) && v4(st.xb) && v4(st.xs) && v4(st.xh) && v4(st.bb) &&
         v4(st.bs) && v4(st.cb) && v4(st.cs);
}

bool bad_shape(int B, int S, int H) {
  return B <= 0 || S <= 0 || H <= 0;
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
// of x, b and c contiguous).  states receives the state entering each
// tile, (B, H, ceil(S / tile), N, P) f32; it is also the chain's exchange
// buffer, so it is required.  sync: 1 + B * H * tiles int32, zero (the
// ticket counter and the tiles' flags).  One kernel.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an argument the kernel does not take.
extern "C" int cox_ssd_scan(const void* x, const void* a, const void* b, const void* c, void* y,
                            void* states, void* sync, int B, int S, int H, int P, int N,
                            long long xb, long long xs, long long xh, long long ab, long long as,
                            long long ah, long long bb, long long bs, long long cb, long long cs,
                            void* stream) {
  if (bad_shape(B, S, H) || states == nullptr || sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = make_strides(xb, xs, xh, ab, as, ah, bb, bs, cb, cs);
  const int vec = vector_rows(x, b, c, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *af = static_cast<const float*>(a);
  const float *bf = static_cast<const float*>(b), *cf = static_cast<const float*>(c);
  float *yf = static_cast<float*>(y), *sf = static_cast<float*>(states);
  int* sy = static_cast<int*>(sync);
#define COX_SSD_FWD(n, p) \
  if (N == n && P == p) return launch_fwd<n, p>(xf, af, bf, cf, yf, sf, sy, B, S, H, st, vec, s);
  COX_SSD_SIZES(COX_SSD_FWD)
#undef COX_SSD_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of cox_ssd_scan: dx (B, S, H, P), da (B, S, H), db, dc (B,
// S, N), contiguous f32, from the forward's inputs (same strides), its
// saved states and dy (B, S, H, P) contiguous.  dh_x is f32 scratch shaped
// as states (the chain's exchange buffer for dH); sync as the forward's,
// zero.  One kernel.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for an argument the kernel does not
// take.
extern "C" int cox_ssd_scan_bwd(const void* x, const void* a, const void* b, const void* c,
                                const void* dy, const void* states, void* dx, void* da,
                                void* db, void* dc, void* dh_x, void* sync, int B, int S, int H,
                                int P, int N, long long xb, long long xs, long long xh,
                                long long ab, long long as, long long ah, long long bb,
                                long long bs, long long cb, long long cs, void* stream) {
  if (bad_shape(B, S, H) || states == nullptr || dh_x == nullptr || sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = make_strides(xb, xs, xh, ab, as, ah, bb, bs, cb, cs);
  const int vec = vector_rows(x, b, c, st) && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *af = static_cast<const float*>(a);
  const float *bf = static_cast<const float*>(b), *cf = static_cast<const float*>(c);
  const float *dyf = static_cast<const float*>(dy), *sf = static_cast<const float*>(states);
  float *dxf = static_cast<float*>(dx), *daf = static_cast<float*>(da);
  float *dbf = static_cast<float*>(db), *dcf = static_cast<float*>(dc);
  float* dhf = static_cast<float*>(dh_x);
  int* sy = static_cast<int*>(sync);
#define COX_SSD_BWD(n, p)                                                                       \
  if (N == n && P == p)                                                                         \
    return launch_bwd<n, p>(xf, af, bf, cf, dyf, sf, dxf, daf, dbf, dcf, dhf, sy, B, S, H, st, \
                            vec, s);
  COX_SSD_SIZES(COX_SSD_BWD)
#undef COX_SSD_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
