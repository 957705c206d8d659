// Flash attention for training and prefill, batched: the forward and its
// gradient.
//
// Forward (cox_flash_attention) replaces the TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention).  Same semantics: q is scaled by 1/sqrt(D) in f32,
// s = (q * scale) . k, masked positions take -1e30 (causal: k <= q; with
// a window also q - k < window; the window applies only when causal), the
// running max, sum and accumulator are f32, a row with no valid position
// keeps lsum == 0 -> 1, and the output is in q's dtype.  A masked entry
// adds exactly 0 to the sums here (p = 0), where the Pallas kernel adds
// exp(0) = 1 for a tile whose row is wholly masked and wipes it with
// alpha = 0 once a valid tile comes: the same result, with no NaN from
// exp(-inf - -inf) possible.  KV tiles wholly above the diagonal, and
// wholly below the window, are skipped.  The forward also writes the row's
// log-sum-exp, lse = m + log(l) (f32, (B, H, S)), for the backward.
//
// Backward (cox_flash_attention_bwd) computes the gradient; the TPU
// kernel has none (the reference trains through its plain XLA path).  It
// is FlashAttention-2's backward with recomputation from lse:
//   1. delta = rowsum(dO * O) in f32;
//   2. dK, dV: one block per (batch row, kv head, k tile) loops over the
//      g query heads of its group and the q tiles that see its k tile, so
//      GQA is summed inside the block, with no atomics;
//   3. dQ: one block per (batch row, q head, q tile) loops over k tiles.
// P = exp(s - lse) is recomputed with the forward's arithmetic;
// dS = P * (dP - delta); dV += P^T dO; dK += dS^T (q * scale);
// dQ += dS K * scale.  Every output is written by one block, in a fixed
// order: deterministic.  Outputs are in the input dtype, accumulated in f32.
//
// Layout: q (B, S, H, D), k and v (B, S, Hkv, D) are read in place through
// their strides (D contiguous): the layouts attention_apply produces, so
// no transposed copy.  o, dO, dq, dk and dv are contiguous.  Built for
// D in {64, 128} and f32 or bf16.
//
// Bound: operations.  At the training shape (S = 4,096, D = 128) a tile
// pair does 2 * 64 * 64 * 128 multiply-adds per product against 64 KB of
// K/V in bf16, far above the card's ~295 operations per byte: these are
// matrix products for the tensor cores.  This first version is simple and
// right instead: CUDA-core f32 FMAs (the f32 path must hold 1e-4, which
// TF32 tensor cores would not), one 64 x 64 tile pair at a time, tiles
// held in shared memory as f32 with rows padded by one word so the column
// reads of the products are free of bank conflicts, and each thread of a
// 16 x 16 layout keeps a 4 x 4 block of scores and a 4 x (D / 16) block of
// the accumulator in registers.  Its rows ty + 16 i are the same in the
// score and the accumulator blocks, so the online softmax's row max and
// sum reduce over 16 lanes with __shfl_xor_sync and stay in registers.
// Under the causal mask the q tiles run last-first, the heaviest first.
// mma.sync or wgmma with TMA, and a pipelined load, are later work.
#include <cmath>

#include "common.cuh"

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

// Above 48 KB a block's dynamic shared memory needs an opt-in; set it on
// every launch (a cheap runtime call).
template <typename K> int allow_smem(K kern, size_t bytes) {
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

float scale_of(int D) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))); }

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
        int Hkv, Strides qs, Strides ks, Strides vs, Mask mask, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = fwd_smem<D>();
  int err = allow_smem(kern, smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((mask.S + BQ - 1) / BQ), H, B);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), lse, H,
                                        Hkv, qs, ks, vs, mask, scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H, int Hkv,
        Strides qs, Strides ks, Strides vs, Mask mask, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * mask.S * H;
  const unsigned dblocks = static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  delta_kernel<T><<<dblocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, mask.S, D, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const unsigned ntiles = static_cast<unsigned>((mask.S + BK - 1) / BK);
  auto kv_kern = flash_bwd_dkdv_kernel<T, D>;
  err = allow_smem(kv_kern, dkdv_smem<D>());
  if (err != 0) return err;
  kv_kern<<<dim3(ntiles, Hkv, B), THREADS, dkdv_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H,
      Hkv, qs, ks, vs, mask, scale_of(D));
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  auto q_kern = flash_bwd_dq_kernel<T, D>;
  err = allow_smem(q_kern, dq_smem<D>());
  if (err != 0) return err;
  q_kern<<<dim3(ntiles, H, B), THREADS, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Hkv, qs, ks, vs,
      mask, scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int B, int H, int Hkv, long long S, long long window) {
  return B > 0 && B <= 65535 && Hkv > 0 && H > 0 && H <= 65535 && H % Hkv == 0 && S > 0 &&
         (S + BQ - 1) / BQ <= 2147483647LL && window >= 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an argument the kernel does not take.  lse is
// f32 (B, H, S).
extern "C" int cox_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int Hkv, long long S, int D,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh, int causal,
                                   long long window, int dtype, void* stream) {
  if (!valid_shape(B, H, Hkv, S, window)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const Mask mask{S, causal != 0, window};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == COX_F32 && D == 64) return fwd<float, 64>(q, k, v, o, l, B, H, Hkv, qs, ks, vs, mask, s);
  if (dtype == COX_F32 && D == 128) return fwd<float, 128>(q, k, v, o, l, B, H, Hkv, qs, ks, vs, mask, s);
  if (dtype == COX_BF16 && D == 64) return fwd<__nv_bfloat16, 64>(q, k, v, o, l, B, H, Hkv, qs, ks, vs, mask, s);
  if (dtype == COX_BF16 && D == 128) return fwd<__nv_bfloat16, 128>(q, k, v, o, l, B, H, Hkv, qs, ks, vs, mask, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an argument the kernels do not take.  o, dout
// and dq are contiguous (B, S, H, D), dk and dv contiguous (B, S, Hkv, D);
// lse is the forward's; delta is f32 scratch of B * H * S values.
extern "C" int cox_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B,
                                       int H, int Hkv, long long S, int D, long long qsb,
                                       long long qss, long long qsh, long long ksb,
                                       long long kss, long long ksh, long long vsb,
                                       long long vss, long long vsh, int causal,
                                       long long window, int dtype, void* stream) {
  if (!valid_shape(B, H, Hkv, S, window)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const Mask mask{S, causal != 0, window};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == COX_F32 && D == 64)
    return bwd<float, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv, qs, ks, vs, mask, s);
  if (dtype == COX_F32 && D == 128)
    return bwd<float, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv, qs, ks, vs, mask, s);
  if (dtype == COX_BF16 && D == 64)
    return bwd<__nv_bfloat16, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv, qs, ks, vs, mask, s);
  if (dtype == COX_BF16 && D == 128)
    return bwd<__nv_bfloat16, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv, qs, ks, vs, mask, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
