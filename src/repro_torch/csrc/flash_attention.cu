// Flash attention for training and prefill, batched: the forward and its
// gradient, built twice: bf16 on the tensor cores, f32 on the CUDA cores.
//
// Forward (cox_flash_attention) replaces the TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention).  Same semantics: logits s = q . k / sqrt(D) in f32,
// masked positions take -1e30 (causal: k <= q; with a window also q - k <
// window; the window applies only when causal), the running max, sum and
// accumulator are f32, a row with no valid position keeps lsum == 0 -> 1,
// and the output is in q's dtype.  A masked entry adds exactly 0 to the
// sums here (p = 0), where the Pallas kernel adds exp(0) = 1 for a tile
// whose row is wholly masked and wipes it with alpha = 0 once a valid tile
// comes: the same result, with no NaN from exp(-inf - -inf) possible.  KV
// tiles wholly above the diagonal, and wholly below the window, are
// skipped.  The forward also writes the row's log-sum-exp, lse = m +
// log(l) (f32, (B, H, S)), for the backward.
//
// Backward (cox_flash_attention_bwd) computes the gradient; the TPU
// kernel has none (the reference trains through its plain XLA path).  It
// is FlashAttention-2's backward with recomputation from lse:
//   1. delta = rowsum(dO * O) in f32;
//   2. dK, dV: one block per (k tile, kv head, batch row) loops over the
//      query heads of its group and the q tiles that see its k tile, so
//      GQA is summed inside the block, with no atomics.  In bf16 the group
//      may be split over several blocks (nsplit, picked by the wrapper when
//      the grid would fill the card less than twice, as at MQA's one kv
//      head): each writes f32 partial dK, dV, and a fourth kernel sums the
//      splits in order and rounds to bf16;
//   3. dQ: one block per (q tile, q head, batch row) loops over k tiles.
// P = exp(s - lse) is recomputed with the forward's arithmetic;
// dS = P * (dP - delta); dV += P^T dO; dK += dS^T q / sqrt(D);
// dQ += dS K / sqrt(D).  Every output is written by one block, in a fixed
// order: deterministic.  Outputs are in the input dtype, accumulated in f32.
//
// Layout: q (B, S, H, D), k and v (B, S, Hkv, D) are read in place through
// their strides (D contiguous): the layouts attention_apply produces, so
// no transposed copy.  o, dO, dq, dk and dv are contiguous.  Built for
// D in {64, 128}.
//
// Bound: operations.  At the training shape (S = 4,096, D = 128) a tile
// pair does 2 * 64 * 64 * 128 multiply-adds per product against 64 KB of
// K/V in bf16, far above the card's ~295 operations per byte: matrix
// products for the tensor cores.
//
// bf16 (namespace flash_tc): wgmma on the tensor cores, f32 accumulation.  One
// warpgroup (128 threads) a block, 64-row tiles, two blocks an SM.  Tiles
// arrive by cp.async into 128-byte-swizzled shared memory (wgmma.cuh), the
// next K/V (or Q/dO) tile's copy in flight during this tile's products
// (two stages).  The forward: S = Q K^T from shared memory (bf16 in, f32
// out, scaled after the product), the online softmax on the accumulator
// registers, then O += P V with P from registers: P's accumulator layout
// is the A fragment's, so P never goes through shared memory.  (Q's A
// fragments kept in registers across the K/V tiles came out wrong at
// D = 64 on the card, with no compiler warning; read from shared memory
// by each tile's product they are right at both widths.)  P is
// split into P_hi = bf16(p) and P_lo = bf16(p - P_hi), two products into
// one f32 accumulator: P rounded once to bf16 misses the output's one-bf16-
// step tolerance in 5-9 % of entries (tests/test_torch_attention_rounding.py),
// so the forward does three products of tensor work for its two.  The
// backward rounds P and dS once each (its tolerance holds): S^T = K Q^T and
// dP^T = V dO^T from shared memory, dV += P^T dO and dK += dS^T Q with P^T,
// dS^T from registers; dQ's kernel likewise with dQ += dS K.
//
// f32: CUDA-core FMAs (the f32 path must hold 1e-4, which TF32 tensor
// cores would not); only the f32 cross-checks reach it.  One 64 x 64 tile
// pair at a time, tiles held in shared memory as f32 with rows padded by
// one word so the column reads of the products are free of bank
// conflicts, and each thread of a 16 x 16 layout keeps a 4 x 4 block of
// scores and a 4 x (D / 16) block of the accumulator in registers.  Its
// rows ty + 16 i are the same in the score and the accumulator blocks, so
// the online softmax's row max and sum reduce over 16 lanes with
// __shfl_xor_sync and stay in registers.  q is scaled before the product.
// Under the causal mask the q tiles run last-first, the heaviest first.
#include <cmath>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;  // a 16 x 16 layout
constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile (== BQ: the loops rely on it)
constexpr int PP = BK + 1;    // padded pitch of a score tile
constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

struct Strides {
  long long b, s, h;
};

struct Mask {
  long long S;
  bool causal;
  long long window;
  __device__ __forceinline__ bool ok(long long qi, long long kj) const {
    if (qi >= S || kj >= S) return false;
    if (!causal) return true;
    return kj <= qi && (window == 0 || qi - kj < window);
  }
  // the range [begin, end) of 64-row k tiles that q tile qt sees
  __device__ __forceinline__ void k_tiles(long long qt, long long* begin,
                                          long long* end) const {
    const long long nk = (S + BK - 1) / BK;
    *begin = 0;
    *end = nk;
    if (!causal) return;
    const long long q0 = qt * BQ;
    *end = min(nk, (q0 + BQ - 1) / BK + 1);  // k0 <= the tile's last row
    if (window > 0) {  // keep tile j iff its last key j*BK + BK-1 > q0 - window
      const long long t = q0 - window - BK + 2;
      *begin = t <= 0 ? 0 : (t + BK - 1) / BK;
    }
  }
  // the range [begin, end) of q tiles that see k tile kt
  __device__ __forceinline__ void q_tiles(long long kt, long long* begin,
                                          long long* end) const {
    const long long nq = (S + BQ - 1) / BQ;
    *begin = 0;
    *end = nq;
    if (!causal) return;
    const long long k0 = kt * BK;
    *begin = k0 / BQ;  // q tiles whose last row reaches k0
    if (window > 0) {  // keep q tile t iff t*BQ - (k0 + BK-1) < window
      *end = min(nq, (k0 + BK - 2 + window) / BQ + 1);
    }
  }
};

// Rows [row0, row0 + 64) of one head of a (B, S, H, D) tensor into a
// 64 x (D + 1) f32 tile, each value times mul; rows past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ base,
                                          long long stride_s, long long row0,
                                          long long S, float mul) {
  constexpr int P = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const long long pos = row0 + r;
    dst[r * P + d] = pos < S ? to_f32(base[pos * stride_s + d]) * mul : 0.0f;
  }
}

// The 64 values of rows [row0, row0 + 64) of one (b, h) row of a (B, H, S)
// f32 array; rows past S get fill.
__device__ __forceinline__ void load_row_stats(float* dst, const float* __restrict__ src,
                                               long long row0, long long S,
                                               float fill) {
  for (int i = threadIdx.x; i < 64; i += THREADS) {
    dst[i] = row0 + i < S ? src[row0 + i] : fill;
  }
}

// acc[i][c] += sum_d a[(ty + 16 i) * P + d] * b[(tx + 16 c) * P + d]
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * P + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(tx + 16 * c) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
}

// acc[i][j] += sum_c s[(ty + 16 i) * PP + c] * b[c * P + tx + 16 j]
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* s,
                                         const float* b, int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    float sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sv[i] = s[(ty + 16 * i) * PP + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float bv = b[c * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sv[i], bv, acc[i][j]);
    }
  }
}

// reduce over the 16 lanes of a half-warp (the threads of one row block)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (D + 1) + BQ * PP);
}
template <int D> constexpr size_t dkdv_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BK + 2 * BQ) * (D + 1) + 2 * BK * PP + 2 * BQ);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (static_cast<size_t>(2 * BQ + 2 * BK) * (D + 1) + BQ * PP + 2 * BQ);
}

// One block per (q tile, q head, batch row).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int H, int Hkv, Strides qs, Strides ks, Strides vs, Mask mask,
                     float scale) {
  constexpr int P = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * P;
  float* v_s = k_s + BK * P;
  float* p_s = v_s + BK * P;
  const long long S = mask.S;
  const long long qt = gridDim.x - 1 - blockIdx.x;  // last (heaviest) tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long q0 = qt * BQ;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_tile<T, D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S, scale);

  float acc[4][DJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }
  long long kt0, kt1;
  mask.k_tiles(qt, &kt0, &kt1);
  for (long long kt = kt0; kt < kt1; ++kt) {
    const long long k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done (and q_s is loaded)
    load_tile<T, D>(k_s, kb, ks.s, k0, S, 1.0f);
    load_tile<T, D>(v_s, vb, vs.s, k0, S, 1.0f);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);
    // online softmax over the tile, rows ty + 16 i held by 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = q0 + ty + 16 * i;
      bool ok[4];
      float tmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = mask.ok(qi, k0 + tx + 16 * c);
        if (ok[c]) tmax = fmaxf(tmax, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.0f;
        p_s[(ty + 16 * i) * PP + tx + 16 * c] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_acc<D>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float lsum = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = o + ((static_cast<long long>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / lsum);
    // a row with no valid position: lse = +inf, so the backward's p is 0
    if (tx == 0) {
      lse[(static_cast<long long>(b) * H + h) * S + qi] =
          l[i] == 0.0f ? INFINITY : m[i] + logf(l[i]);
    }
  }
}

// delta = rowsum(dO * O), one warp per (b, s, h) row of the contiguous
// (B, S, H, D) o and dO; written to (B, H, S).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int H, long long S, int D, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* orow = o + row * D;
  const T* grow = dout + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(grow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, off);
  if (lane == 0) {
    const long long h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[(b * H + h) * S + s] = acc;
  }
}

// One block per (k tile, kv head, batch row): dK and dV of its 64 keys,
// summed over the g query heads of the group and the q tiles that see it.
// The scores are computed transposed, key rows ty + 16 i by query columns
// tx + 16 c, so the block's P^T and dS^T rows are its dK/dV rows.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv,
                          Strides qs, Strides ks, Strides vs, Mask mask, float scale) {
  constexpr int P = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * P;
  float* q_s = v_s + BK * P;
  float* do_s = q_s + BQ * P;
  float* pt_s = do_s + BQ * P;
  float* dst_s = pt_s + BK * PP;
  float* lse_s = dst_s + BK * PP;
  float* dl_s = lse_s + BQ;
  const long long S = mask.S;
  const long long kt = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z, g = H / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long k0 = kt * BK;
  load_tile<T, D>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, S, 1.0f);
  load_tile<T, D>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, S, 1.0f);

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.0f;
  }
  long long qt0, qt1;
  mask.q_tiles(kt, &qt0, &qt1);
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* gb = dout + static_cast<long long>(b) * S * H * D + static_cast<long long>(h) * D;
    const float* lse_b = lse + (static_cast<long long>(b) * H + h) * S;
    const float* dl_b = delta + (static_cast<long long>(b) * H + h) * S;
    for (long long qt = qt0; qt < qt1; ++qt) {
      const long long q0 = qt * BQ;
      __syncthreads();  // the last tile's readers are done
      load_tile<T, D>(q_s, qb, qs.s, q0, S, scale);
      load_tile<T, D>(do_s, gb, static_cast<long long>(H) * D, q0, S, 1.0f);
      load_row_stats(lse_s, lse_b, q0, S, INFINITY);
      load_row_stats(dl_s, dl_b, q0, S, 0.0f);
      __syncthreads();
      float st[4][4] = {}, dpt[4][4] = {};
      tile_dot<D>(st, k_s, q_s, ty, tx);   // S^T = K (q * scale)^T
      tile_dot<D>(dpt, v_s, do_s, ty, tx);  // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long kj = k0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = tx + 16 * c;
          const float p = mask.ok(q0 + qc, kj) ? expf(st[i][c] - lse_s[qc]) : 0.0f;
          pt_s[(ty + 16 * i) * PP + qc] = p;
          dst_s[(ty + 16 * i) * PP + qc] = p * (dpt[i][c] - dl_s[qc]);
        }
      }
      __syncthreads();
      tile_acc<D>(dva, pt_s, do_s, ty, tx);  // dV += P^T dO
      tile_acc<D>(dka, dst_s, q_s, ty, tx);  // dK += dS^T (q * scale)
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + kj) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(dka[i][j]);
      dv[off + tx + 16 * j] = from_f32<T>(dva[i][j]);
    }
  }
}

// One block per (q tile, q head, batch row): dQ of its 64 queries over the
// k tiles it sees.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int Hkv, Strides qs, Strides ks,
                        Strides vs, Mask mask, float scale) {
  constexpr int P = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * P;
  float* k_s = do_s + BQ * P;
  float* v_s = k_s + BK * P;
  float* ds_s = v_s + BK * P;
  float* lse_s = ds_s + BQ * PP;
  float* dl_s = lse_s + BQ;
  const long long S = mask.S;
  const long long qt = gridDim.x - 1 - blockIdx.x;  // last (heaviest) tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long q0 = qt * BQ;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_tile<T, D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S, scale);
  const T* gb = dout + static_cast<long long>(b) * S * H * D + static_cast<long long>(h) * D;
  load_tile<T, D>(do_s, gb, static_cast<long long>(H) * D, q0, S, 1.0f);
  load_row_stats(lse_s, lse + (static_cast<long long>(b) * H + h) * S, q0, S, INFINITY);
  load_row_stats(dl_s, delta + (static_cast<long long>(b) * H + h) * S, q0, S, 0.0f);

  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.0f;
  }
  long long kt0, kt1;
  mask.k_tiles(qt, &kt0, &kt1);
  for (long long kt = kt0; kt < kt1; ++kt) {
    const long long k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(k_s, kb, ks.s, k0, S, 1.0f);
    load_tile<T, D>(v_s, vb, vs.s, k0, S, 1.0f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);    // S = (q * scale) K^T
    tile_dot<D>(dp, do_s, v_s, ty, tx);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = mask.ok(q0 + r, k0 + tx + 16 * c) ? expf(s[i][c] - lse_s[r]) : 0.0f;
        ds_s[r * PP + tx + 16 * c] = p * (dp[i][c] - dl_s[r]);
      }
    }
    __syncthreads();
    tile_acc<D>(dqa, ds_s, k_s, ty, tx);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    T* row = dq + ((static_cast<long long>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f32<T>(dqa[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

namespace flash_tc {

using bf16 = __nv_bfloat16;
constexpr int WG = 128;             // one warpgroup a block
constexpr int T = wg::TILE_ROWS;    // rows of every q and k tile
static_assert(T == BQ && T == BK, "Mask's tile ranges count 64-row tiles");
constexpr int NS = T / 2;           // a 64 x 64 score accumulator, per thread
constexpr uint32_t STATS_BYTES = 2 * T * sizeof(float);  // a q tile's lse and delta

template <int D> __host__ __device__ constexpr uint32_t tile_bytes() { return T * D * 2; }
// the forward: Q, and two stages of (K, V); 1 KB to align the tiles
template <int D> constexpr size_t fwd_smem() { return 5 * tile_bytes<D>() + 1024; }
// dK/dV: K, V, and two stages of (Q, dO) and of (lse, delta)
template <int D> constexpr size_t dkdv_smem() { return 6 * tile_bytes<D>() + 2 * STATS_BYTES + 1024; }
// dQ: Q, dO, and two stages of (K, V)
template <int D> constexpr size_t dq_smem() { return 6 * tile_bytes<D>() + 1024; }

__device__ __forceinline__ uint32_t align1024(uint32_t a) { return (a + 1023u) & ~1023u; }

// cp.async of rows [row0, row0 + 64) of one head (row stride stride_s
// values, D contiguous) into a swizzled tile; rows past S as zeros.
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ base,
                                                long long stride_s, long long row0,
                                                long long S) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < T * CPR / WG; ++i) {
    const int idx = threadIdx.x + i * WG;
    const int r = idx / CPR, cc = idx % CPR;
    const long long pos = row0 + r;
    const bool in = pos < S;
    wg::cp_async16(dst + wg::chunk_offset(r, cc), base + (in ? pos : 0) * stride_s + cc * 8,
                   in ? 16 : 0);
  }
}

// cp.async of the 64 values [row0, row0 + 64) of an lse row (threads
// 0-63) and of a delta row (64-127) to dst and dst + 256; past S zeros.
__device__ __forceinline__ void load_stats_async(uint32_t dst, const float* __restrict__ lse_row,
                                                 const float* __restrict__ dl_row,
                                                 long long row0, long long S) {
  const int i = threadIdx.x % T, which = threadIdx.x / T;
  const bool in = row0 + i < S;
  const float* src = which == 0 ? lse_row : dl_row;
  wg::cp_async4(dst + which * T * 4 + 4 * i, src + (in ? row0 + i : 0), in ? 4 : 0);
}

// whether any pair of q tile q0 and k tile k0 is masked (or past S)
__device__ __forceinline__ bool tile_needs_mask(const Mask& m, long long q0, long long k0) {
  if (q0 + T > m.S || k0 + T > m.S) return true;
  if (!m.causal) return false;
  return k0 + T - 1 > q0 || (m.window > 0 && q0 + T - 1 - k0 >= m.window);
}

// the row (of the tile's 64) and column of this thread's accumulator entry i
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1); }

template <int N> __device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
  }
}

// score columns 16 j .. 16 j + 15 as an A fragment, rounded once to bf16
__device__ __forceinline__ void to_frag(const float (&s)[NS], int j, uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = wg::pack_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
}

// acc (64 x D) += A (64 x 16, registers) * rows 16 kk .. 16 kk + 15 of an
// MN-major tile (the k index along the tile's rows)
template <int D>
__device__ __forceinline__ void mma_out(float (&acc)[D / 2], const uint32_t (&a)[4],
                                        uint32_t tile, int kk) {
  if constexpr (D == 128) {
    wg::mma_rs_n128(acc, a, wg::desc_mn(tile, kk), 1);
  } else {
    wg::mma_rs_n64(acc, a, wg::desc_mn(tile, kk), 1);
  }
}

// One block per (q head, batch row, q tile), the heaviest q tiles first.
template <int D>
__global__ void __launch_bounds__(WG, 2)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int H, int Hkv, Strides qs, Strides ks, Strides vs, Mask mask, float scale) {
  constexpr uint32_t TB = tile_bytes<D>();
  constexpr int NO = D / 2;  // the 64 x D output accumulator, per thread
  extern __shared__ uint8_t tc_smem[];
  const uint32_t base = align1024(wg::smem_u32(tc_smem));
  const uint32_t q_s = base, kv_s = base + TB;  // stage s: K at kv_s + 2 TB s, V after it
  const long long S = mask.S;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const long long qt = gridDim.z - 1 - blockIdx.z;
  const long long q0 = qt * T;
  const int r0 = acc_row(0);
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  long long kt0, kt1;
  mask.k_tiles(qt, &kt0, &kt1);

  load_tile_async<D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S);
  wg::cp_async_commit();
  load_tile_async<D>(kv_s, kb, ks.s, kt0 * T, S);
  load_tile_async<D>(kv_s + TB, vb, vs.s, kt0 * T, S);
  wg::cp_async_commit();

  float acc[NO], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  const long long n_tiles = kt1 - kt0;
  for (long long it = 0; it < n_tiles; ++it) {
    const uint32_t k_s = kv_s + 2 * TB * (it & 1), v_s = k_s + TB;
    const long long k0 = (kt0 + it) * T;
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      const uint32_t nk_s = kv_s + 2 * TB * ((it + 1) & 1);
      load_tile_async<D>(nk_s, kb, ks.s, k0 + T, S);
      load_tile_async<D>(nk_s + TB, vb, vs.s, k0 + T, S);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.0f;
    wg::fence_acc(s);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wg::mma_ss_n64(s, wg::desc_k(q_s, kk), wg::desc_k(k_s, kk), kk);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(s);

    // the online softmax: rows r0 (entries 4 j, 4 j + 1) and r0 + 8
    // (4 j + 2, 4 j + 3), each shared by the 4 lanes of a quad
    const bool need = tile_needs_mask(mask, q0, k0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float x = s[i] * scale;
      s[i] = need && !mask.ok(q0 + acc_row(i), k0 + acc_col(i)) ? -INFINITY : x;
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      alpha[hr] = __expf(m[hr] - m_new);
      m[hr] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __expf(s[4 * j + 2 * hr + e] - m_new);  // 0 where masked
          s[4 * j + 2 * hr + e] = p;
          sum += p;
        }
      }
      l[hr] = l[hr] * alpha[hr] + sum;  // this lane's part of the row sum
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P_hi V + P_lo V
    uint32_t hi[T / 16][4], lo[T / 16][4];
#pragma unroll
    for (int j = 0; j < T / 16; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) wg::split_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1], hi[j][r], lo[j][r]);
    }
    fence_frags(hi);
    fence_frags(lo);
    wg::fence_acc(acc);
    wg::fence();
#pragma unroll
    for (int j = 0; j < T / 16; ++j) {
      mma_out<D>(acc, hi[j], v_s, j);
      mma_out<D>(acc, lo[j], v_s, j);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(acc);
    __syncthreads();  // this stage's tiles are read: the next copy may overwrite them
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(FULL_MASK, l[hr], 1);
    l[hr] += __shfl_xor_sync(FULL_MASK, l[hr], 2);
  }
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int hr = (i >> 1) & 1;
    const long long qi = q0 + r0 + 8 * hr;
    if (qi >= S) continue;
    const float lsum = l[hr] == 0.0f ? 1.0f : l[hr];
    bf16* orow = o + ((static_cast<long long>(b) * S + qi) * H + h) * D;
    *reinterpret_cast<uint32_t*>(orow + acc_col(i)) = wg::pack_bf16(acc[i] / lsum, acc[i + 1] / lsum);
    // a row with no valid position: lse = +inf, so the backward's p is 0
    if (i < 4 && threadIdx.x % 4 == 0) {
      lse[(static_cast<long long>(b) * H + h) * S + qi] =
          l[hr] == 0.0f ? INFINITY : m[hr] + logf(l[hr]);
    }
  }
}

// One block per (kv head and split, batch row, k tile), the heaviest k
// tiles (the first, under the causal mask) first.  The block's query heads
// are split `split` of nsplit of its group; with nsplit > 1 it writes f32
// partial dK, dV to part ([2][nsplit][B, S, Hkv, D]: dK's, then dV's).
template <int D, bool PARTIAL>
__global__ void __launch_bounds__(WG, 2)
    dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                int nsplit, int H, int Hkv, Strides qs, Strides ks, Strides vs, Mask mask,
                float scale) {
  constexpr uint32_t TB = tile_bytes<D>();
  constexpr int NO = D / 2;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t raw = wg::smem_u32(tc_smem), base = align1024(raw);
  const uint8_t* sp = tc_smem + (base - raw);
  // K, V; stage s: Q at qd_s + 2 TB s, dO after it, lse and delta at st_s + STATS_BYTES s
  const uint32_t k_s = base, v_s = base + TB, qd_s = base + 2 * TB, st_s = base + 6 * TB;
  const long long S = mask.S;
  const int split = blockIdx.x % nsplit, hk = blockIdx.x / nsplit, b = blockIdx.y;
  const int per = H / Hkv / nsplit, h0 = hk * (H / Hkv) + split * per;
  const long long kt = blockIdx.z, k0 = kt * T;
  long long qt0, qt1;
  mask.q_tiles(kt, &qt0, &qt1);
  const long long nq = qt1 - qt0, n_it = per * nq;
  const long long do_ss = static_cast<long long>(H) * D;  // dO is contiguous (B, S, H, D)
  const bf16* do_b = dout + static_cast<long long>(b) * S * do_ss;

  // the tiles of step it (query head h0 + it / nq, q tile qt0 + it % nq)
  auto load_step = [&](long long it) {
    const int h = h0 + static_cast<int>(it / nq);
    const long long q0 = (qt0 + it % nq) * T;
    const uint32_t dst = qd_s + 2 * TB * (it & 1);
    load_tile_async<D>(dst, q + b * qs.b + h * qs.h, qs.s, q0, S);
    load_tile_async<D>(dst + TB, do_b + static_cast<long long>(h) * D, do_ss, q0, S);
    const long long row = (static_cast<long long>(b) * H + h) * S;
    load_stats_async(st_s + STATS_BYTES * (it & 1), lse + row, delta + row, q0, S);
  };
  load_tile_async<D>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, S);
  load_tile_async<D>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, S);
  wg::cp_async_commit();
  load_step(0);
  wg::cp_async_commit();

  float dva[NO], dka[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dva[i] = dka[i] = 0.0f;
  for (long long it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_step(it + 1);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();
    const long long q0 = (qt0 + it % nq) * T;
    const uint32_t q_s = qd_s + 2 * TB * (it & 1), do_s = q_s + TB;
    const float* lse_s = reinterpret_cast<const float*>(sp + (st_s - base) + STATS_BYTES * (it & 1));
    const float* dl_s = lse_s + T;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float st[NS], dpt[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.0f;
    wg::fence_acc(st);
    wg::fence_acc(dpt);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wg::mma_ss_n64(st, wg::desc_k(k_s, kk), wg::desc_k(q_s, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wg::mma_ss_n64(dpt, wg::desc_k(v_s, kk), wg::desc_k(do_s, kk), kk);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(st);
    wg::fence_acc(dpt);

    const bool need = tile_needs_mask(mask, q0, k0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qc = acc_col(i);
      const float p = !need || mask.ok(q0 + qc, k0 + acc_row(i)) ? __expf(st[i] * scale - lse_s[qc]) : 0.0f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - dl_s[qc]);
    }
    // dV += P^T dO, dK += dS^T Q (its 1/sqrt(D) at the end)
    uint32_t pf[T / 16][4], df[T / 16][4];
#pragma unroll
    for (int j = 0; j < T / 16; ++j) {
      to_frag(st, j, pf[j]);
      to_frag(dpt, j, df[j]);
    }
    fence_frags(pf);
    fence_frags(df);
    wg::fence_acc(dva);
    wg::fence_acc(dka);
    wg::fence();
#pragma unroll
    for (int j = 0; j < T / 16; ++j) mma_out<D>(dva, pf[j], do_s, j);
#pragma unroll
    for (int j = 0; j < T / 16; ++j) mma_out<D>(dka, df[j], q_s, j);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(dva);
    wg::fence_acc(dka);
    __syncthreads();
  }

  const long long n = static_cast<long long>(gridDim.y) * S * Hkv * D;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const long long kj = k0 + acc_row(i);
    if (kj >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + kj) * Hkv + hk) * D + acc_col(i);
    if constexpr (PARTIAL) {
      float* pk = part + split * n + off;
      *reinterpret_cast<float2*>(pk) = make_float2(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<float2*>(pk + nsplit * n) = make_float2(dva[i], dva[i + 1]);
    } else {
      *reinterpret_cast<uint32_t*>(dk + off) = wg::pack_bf16(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = wg::pack_bf16(dva[i], dva[i + 1]);
    }
  }
}

// dK, dV = the sum of the splits' partials, in split order, rounded to
// bf16; four values a thread.
__global__ void __launch_bounds__(256)
    dkdv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, long long n, int nsplit) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const long long e = is_v ? i - n : i;
  const float* src = part + (is_v ? nsplit * n : 0) + e;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < nsplit; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<uint2*>((is_v ? dv : dk) + e) =
      make_uint2(wg::pack_bf16(acc.x, acc.y), wg::pack_bf16(acc.z, acc.w));
}

// One block per (q head, batch row, q tile), the heaviest q tiles first.
template <int D>
__global__ void __launch_bounds__(WG, 2)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Hkv,
              Strides qs, Strides ks, Strides vs, Mask mask, float scale) {
  constexpr uint32_t TB = tile_bytes<D>();
  constexpr int NO = D / 2;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t base = align1024(wg::smem_u32(tc_smem));
  const uint32_t q_s = base, do_s = base + TB, kv_s = base + 2 * TB;  // stage s: K at kv_s + 2 TB s
  const long long S = mask.S;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const long long qt = gridDim.z - 1 - blockIdx.z;
  const long long q0 = qt * T;
  const int r0 = acc_row(0);
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const long long row = (static_cast<long long>(b) * H + h) * S;
  float lse_r[2], dl_r[2];  // rows r0 and r0 + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long qi = q0 + r0 + 8 * hr;
    lse_r[hr] = qi < S ? lse[row + qi] : 0.0f;
    dl_r[hr] = qi < S ? delta[row + qi] : 0.0f;
  }
  long long kt0, kt1;
  mask.k_tiles(qt, &kt0, &kt1);

  const long long do_ss = static_cast<long long>(H) * D;
  load_tile_async<D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile_async<D>(do_s, dout + static_cast<long long>(b) * S * do_ss + static_cast<long long>(h) * D,
                     do_ss, q0, S);
  wg::cp_async_commit();
  load_tile_async<D>(kv_s, kb, ks.s, kt0 * T, S);
  load_tile_async<D>(kv_s + TB, vb, vs.s, kt0 * T, S);
  wg::cp_async_commit();

  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.0f;
  const long long n_tiles = kt1 - kt0;
  for (long long it = 0; it < n_tiles; ++it) {
    const uint32_t k_s = kv_s + 2 * TB * (it & 1), v_s = k_s + TB;
    const long long k0 = (kt0 + it) * T;
    if (it + 1 < n_tiles) {
      const uint32_t nk_s = kv_s + 2 * TB * ((it + 1) & 1);
      load_tile_async<D>(nk_s, kb, ks.s, k0 + T, S);
      load_tile_async<D>(nk_s + TB, vb, vs.s, k0 + T, S);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();

    // S = Q K^T, dP = dO V^T
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.0f;
    wg::fence_acc(s);
    wg::fence_acc(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wg::mma_ss_n64(s, wg::desc_k(q_s, kk), wg::desc_k(k_s, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wg::mma_ss_n64(dp, wg::desc_k(do_s, kk), wg::desc_k(v_s, kk), kk);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(s);
    wg::fence_acc(dp);

    const bool need = tile_needs_mask(mask, q0, k0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hr = (i >> 1) & 1;
      const float p = !need || mask.ok(q0 + acc_row(i), k0 + acc_col(i))
                          ? __expf(s[i] * scale - lse_r[hr])
                          : 0.0f;
      s[i] = p * (dp[i] - dl_r[hr]);  // dS
    }
    uint32_t df[T / 16][4];
#pragma unroll
    for (int j = 0; j < T / 16; ++j) to_frag(s, j, df[j]);
    fence_frags(df);
    wg::fence_acc(dqa);
    wg::fence();
#pragma unroll
    for (int j = 0; j < T / 16; ++j) mma_out<D>(dqa, df[j], k_s, j);  // dQ += dS K
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(dqa);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const long long qi = q0 + acc_row(i);
    if (qi >= S) continue;
    bf16* out = dq + ((static_cast<long long>(b) * S + qi) * H + h) * D + acc_col(i);
    *reinterpret_cast<uint32_t*>(out) = wg::pack_bf16(dqa[i] * scale, dqa[i + 1] * scale);
  }
}

}  // namespace flash_tc

// Above 48 KB a block's dynamic shared memory needs an opt-in; set it on
// every launch (a cheap runtime call).
template <typename K> int allow_smem(K kern, size_t bytes) {
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

unsigned n_tiles(long long S) { return static_cast<unsigned>((S + BQ - 1) / BQ); }

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
            int Hkv, Strides qs, Strides ks, Strides vs, Mask mask, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<float, D>;
  const size_t smem = fwd_smem<D>();
  int err = allow_smem(kern, smem);
  if (err != 0) return err;
  kern<<<dim3(n_tiles(mask.S), H, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, Hkv, qs, ks, vs, mask, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int Hkv, Strides qs, Strides ks, Strides vs, Mask mask, float scale, cudaStream_t stream) {
  using flash_tc::bf16;
  auto kern = flash_tc::fwd_kernel<D>;
  const size_t smem = flash_tc::fwd_smem<D>();
  int err = allow_smem(kern, smem);
  if (err != 0) return err;
  kern<<<dim3(H, B, n_tiles(mask.S)), flash_tc::WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, Hkv, qs, ks, vs, mask, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int H, long long S,
                 int D, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned blocks = static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  delta_kernel<T><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(o),
                                                  static_cast<const T*>(dout), delta, H, S, D,
                                                  rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
            const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H, int Hkv,
            Strides qs, Strides ks, Strides vs, Mask mask, float scale, cudaStream_t stream) {
  using T = float;
  int err = launch_delta<T>(o, dout, delta, B, H, mask.S, D, stream);
  if (err != 0) return err;
  auto kv_kern = flash_bwd_dkdv_kernel<T, D>;
  err = allow_smem(kv_kern, dkdv_smem<D>());
  if (err != 0) return err;
  kv_kern<<<dim3(n_tiles(mask.S), Hkv, B), THREADS, dkdv_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H,
      Hkv, qs, ks, vs, mask, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  auto q_kern = flash_bwd_dq_kernel<T, D>;
  err = allow_smem(q_kern, dq_smem<D>());
  if (err != 0) return err;
  q_kern<<<dim3(n_tiles(mask.S), H, B), THREADS, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Hkv, qs, ks, vs,
      mask, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, float* part,
             int nsplit, int B, int H, int Hkv, Strides qs, Strides ks, Strides vs, Mask mask,
             float scale, cudaStream_t stream) {
  using flash_tc::bf16;
  int err = launch_delta<bf16>(o, dout, delta, B, H, mask.S, D, stream);
  if (err != 0) return err;
  const dim3 kv_grid(Hkv * nsplit, B, n_tiles(mask.S));
  const size_t kv_smem = flash_tc::dkdv_smem<D>();
  auto args = [&](auto kern) {
    kern<<<kv_grid, flash_tc::WG, kv_smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), part, nsplit, H, Hkv, qs, ks, vs, mask, scale);
  };
  if (nsplit > 1) {
    auto kern = flash_tc::dkdv_kernel<D, true>;
    err = allow_smem(kern, kv_smem);
    if (err != 0) return err;
    args(kern);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const long long n = static_cast<long long>(B) * mask.S * Hkv * D;
    const unsigned blocks = static_cast<unsigned>((2 * n / 4 + 255) / 256);
    flash_tc::dkdv_reduce_kernel<<<blocks, 256, 0, stream>>>(part, static_cast<bf16*>(dk),
                                                      static_cast<bf16*>(dv), n, nsplit);
  } else {
    auto kern = flash_tc::dkdv_kernel<D, false>;
    err = allow_smem(kern, kv_smem);
    if (err != 0) return err;
    args(kern);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  auto q_kern = flash_tc::dq_kernel<D>;
  err = allow_smem(q_kern, flash_tc::dq_smem<D>());
  if (err != 0) return err;
  q_kern<<<dim3(H, B, n_tiles(mask.S)), flash_tc::WG, flash_tc::dq_smem<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Hkv, qs, ks, vs,
      mask, scale);
  return static_cast<int>(cudaGetLastError());
}

// a model's scale: finite and above 0
bool valid_scale(float scale) { return scale > 0.0f && scale <= 3.0e38f; }

bool valid_shape(int B, int H, int Hkv, long long S, long long window) {
  // the bf16 grids put B and the q or k tiles on their y and z dimensions
  return B > 0 && B <= 65535 && Hkv > 0 && H > 0 && H <= 65535 && H % Hkv == 0 && S > 0 &&
         n_tiles(S) <= 65535 && window >= 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an argument the kernel does not take.  lse is
// f32 (B, H, S), of the scaled logits (q . k) * scale; the wrapper passes
// scale = 1/sqrt(D) unless the model gives its own.  bf16 rows (every base
// and stride of q, k, v) must lie on 16-byte boundaries: the wrapper checks
// it.
extern "C" int cox_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int Hkv, long long S, int D,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh, int causal,
                                   long long window, float scale, int dtype, void* stream) {
  if (!valid_shape(B, H, Hkv, S, window) || !valid_scale(scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const Mask mask{S, causal != 0, window};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == COX_F32 && D == 64) return fwd_f32<64>(q, k, v, o, l, B, H, Hkv, qs, ks, vs, mask, scale, s);
  if (dtype == COX_F32 && D == 128) return fwd_f32<128>(q, k, v, o, l, B, H, Hkv, qs, ks, vs, mask, scale, s);
  if (dtype == COX_BF16 && D == 64) return fwd_bf16<64>(q, k, v, o, l, B, H, Hkv, qs, ks, vs, mask, scale, s);
  if (dtype == COX_BF16 && D == 128) return fwd_bf16<128>(q, k, v, o, l, B, H, Hkv, qs, ks, vs, mask, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an argument the kernels do not take.  o, dout
// and dq are contiguous (B, S, H, D), dk and dv contiguous (B, S, Hkv, D);
// lse is the forward's; delta is f32 scratch of B * H * S values.  nsplit
// (bf16 only; 1 for f32) splits each kv head's query-head group over that
// many dK/dV blocks, and divides it; above 1, part is f32 scratch of 2 *
// nsplit * B * S * Hkv * D values.  scale is the forward's.
extern "C" int cox_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, void* part,
                                       int nsplit, int B, int H, int Hkv, long long S, int D,
                                       long long qsb, long long qss, long long qsh,
                                       long long ksb, long long kss, long long ksh,
                                       long long vsb, long long vss, long long vsh,
                                       int causal, long long window, float scale, int dtype,
                                       void* stream) {
  if (!valid_shape(B, H, Hkv, S, window) || !valid_scale(scale) || nsplit < 1 || (H / Hkv) % nsplit != 0 ||
      static_cast<long long>(Hkv) * nsplit > 2147483647LL || (nsplit > 1 && part == nullptr) ||
      (dtype != COX_BF16 && nsplit != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const Mask mask{S, causal != 0, window};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == COX_F32 && D == 64)
    return bwd_f32<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv, qs, ks, vs, mask, scale, s);
  if (dtype == COX_F32 && D == 128)
    return bwd_f32<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv, qs, ks, vs, mask, scale, s);
  if (dtype == COX_BF16 && D == 64)
    return bwd_bf16<64>(q, k, v, o, dout, l, dl, dq, dk, dv, pt, nsplit, B, H, Hkv, qs, ks, vs, mask, scale, s);
  if (dtype == COX_BF16 && D == 128)
    return bwd_bf16<128>(q, k, v, o, dout, l, dl, dq, dk, dv, pt, nsplit, B, H, Hkv, qs, ks, vs, mask, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
