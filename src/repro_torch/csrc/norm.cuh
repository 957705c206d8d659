// RMS norm and layer norm over the last axis, and their gradients: one
// forward kernel and one backward kernel, each templated on LN (layer
// norm: centred, with a bias).  rmsnorm.cu and layernorm.cu instantiate
// them behind their C entry points.
//
//   rms norm:   y = x * rsqrt(mean(x^2) + eps) * w
//   layer norm: y = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * w + b
//
// Replaces the TPU kernels src/repro/kernels/norms.py::_rmsnorm_kernel
// (pallas_call in rmsnorm) and ::_layernorm_kernel (pallas_call in
// layernorm).  Same semantics: the statistics and the scaling in f32, the
// output in x's dtype (f32, bf16 or f16); w (and b) have a dtype of their
// own (f32 beside a bf16 x on the serving and training paths, whose norm
// weights are f32).  The layer norm's variance takes two passes, as the
// reference: the mean first, then the mean of the centred squares.
// E[x^2] - mean^2 would lose the variance's digits on rows whose mean is
// large beside their spread.  The rms norm is the same code with mean = 0
// (x - 0 is exact, so it computes (x * inv) * w, the reference's order).
//
// Bound: memory.  A few operations per element against 2 x sizeof(x)
// bytes moved, far below the card's ~295 operations per byte.  The TPU
// kernels held an 8-row tile in VMEM; here one block takes one row and
// reads it from device memory once: each thread loads its 16-byte vectors
// of the row into registers (up to VPT of them), each sum is reduced with
// __shfl_xor_sync and one shared-memory step, the layer norm's centred
// squares come from the same registers, and the normalised values are
// written from them.  A row 6,144 wide fits the registers in f32, bf16 and
// f16; a wider row re-reads the part beyond them (from L2).  A row that
// does not start on a 16-byte boundary, and the ragged tail of a width
// that is not a multiple of the vector, take scalar loads.  w and b are
// read with scalar loads: one row each, shared by every block, kept in
// L1/L2.
//
// The gradient (the TPU kernels have none: the reference trains through
// its plain XLA path), with rstd the forward's rsqrt, xh = (x - mean) *
// rstd and g = dy * w: dx = rstd * (g - mean(g) - xh * mean(g * xh)), where
// the rms norm has no mean(g) term; dw = the sum over rows of dy * xh, and
// for the layer norm db = the sum over rows of dy.  All in f32; dx in x's
// dtype, dw and db in w's.  Also bound by memory (x and dy read, dx
// written).  Two passes, so that dw and db are deterministic: (1) each
// block takes a range of rows; per row it reduces the sums over the block,
// writes dx and adds dy * xh (and dy) into its own f32 partial rows in
// shared memory (each thread owns its columns: no atomics), and at the end
// writes the partial rows out; (2) a column reduction sums the blocks'
// partial rows in a fixed order.  The row's later reads hit L1/L2.  Scalar
// loads: any alignment and width; the width is bounded by the partial
// rows' shared memory.
#pragma once

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VPT = 6;  // vectors a thread keeps in registers: 6,144 f32
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

// Sum each of v[0..K) over the block; every thread gets the sums.  red
// holds K x WARPS floats and is free again when this returns.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*red)[WARPS]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(FULL_MASK, v[i], off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) red[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = lane < WARPS ? red[i][lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(FULL_MASK, v[i], off);
  }
  __syncthreads();
}

// The columns of one row that a thread owns beyond its registers: the
// vectors past its first VPT, then the scalar tail.  f(j, x[j] in f32).
template <typename T, typename F>
__device__ __forceinline__ void each_beyond(const T* row, long long nvec, long long cols,
                                            F f) {
  constexpr int N = Vec<T>::N;
  const uint4* vrow = reinterpret_cast<const uint4*>(row);
  for (long long i = threadIdx.x + static_cast<long long>(VPT) * THREADS; i < nvec;
       i += THREADS) {
    Vec<T> v;
    v.raw = vrow[i];
#pragma unroll
    for (int k = 0; k < N; ++k) f(i * N + k, to_f32(v.get(k)));
  }
  for (long long j = nvec * N + threadIdx.x; j < cols; j += THREADS) f(j, to_f32(row[j]));
}

// One block per row.
template <bool LN, typename T, typename W>
__global__ void __launch_bounds__(THREADS)
    norm_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                T* __restrict__ y, long long cols, float eps) {
  __shared__ float red[1][WARPS];
  const long long base = static_cast<long long>(blockIdx.x) * cols;
  const T* row = x + base;
  T* out = y + base;
  constexpr int N = Vec<T>::N;
  const bool vec = aligned16(row) && aligned16(out);
  const long long nvec = vec ? cols / N : 0;
  const uint4* vrow = reinterpret_cast<const uint4*>(row);
  const float n = static_cast<float>(cols);

  // pass 1: registers for the first VPT vectors of each thread, and the
  // sum of x (layer norm) or of x^2 (rms norm)
  float held[VPT][N];
  float s[1] = {0.0f};
  auto first = [&](long long, float v) { s[0] += LN ? v : v * v; };
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const long long i = threadIdx.x + static_cast<long long>(r) * THREADS;
    if (i < nvec) {
      Vec<T> v;
      v.raw = vrow[i];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        held[r][k] = to_f32(v.get(k));
        first(0, held[r][k]);
      }
    }
  }
  each_beyond(row, nvec, cols, first);
  block_sum<1>(s, red);
  float mean = 0.0f;
  if constexpr (LN) {
    // pass 2: the centred sum of squares
    mean = s[0] / n;
    s[0] = 0.0f;
    auto centred = [&](long long, float v) { s[0] += (v - mean) * (v - mean); };
#pragma unroll
    for (int r = 0; r < VPT; ++r) {
      const long long i = threadIdx.x + static_cast<long long>(r) * THREADS;
      if (i < nvec) {
#pragma unroll
        for (int k = 0; k < N; ++k) centred(0, held[r][k]);
      }
    }
    each_beyond(row, nvec, cols, centred);
    block_sum<1>(s, red);
  }
  const float inv = rsqrtf(s[0] / n + eps);

  // normalise and store in x's dtype: ((x - mean) * inv) * w (+ b)
  auto norm = [&](long long j, float v) {
    const float o = (v - mean) * inv * to_f32(w[j]);
    if constexpr (LN) return from_f32<T>(o + to_f32(b[j]));
    return from_f32<T>(o);
  };
  uint4* vout = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const long long i = threadIdx.x + static_cast<long long>(r) * THREADS;
    if (i < nvec) {
      Vec<T> o;
#pragma unroll
      for (int k = 0; k < N; ++k) o.set(k, norm(i * N + k, held[r][k]));
      vout[i] = o.raw;
    }
  }
  each_beyond(row, nvec, cols, [&](long long j, float v) { out[j] = norm(j, v); });
}

// Pass 1 of the gradient: rows [blockIdx.x * per, ...) of x and dy; dx,
// and this block's partial rows in part[blockIdx.x] (f32: dw's cols, then
// for the layer norm db's).
template <bool LN, typename T, typename W>
__global__ void __launch_bounds__(THREADS)
    norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                    long long rows, long long cols, float eps) {
  constexpr int R = LN ? 2 : 1;  // partial rows
  constexpr int K = LN ? 3 : 2;  // row sums: (x - mean)^2, g * (x - mean), g
  extern __shared__ float acc_s[];
  __shared__ float red[K][WARPS];
  for (long long j = threadIdx.x; j < R * cols; j += THREADS) acc_s[j] = 0.0f;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
  const float n = static_cast<float>(cols);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * cols;
    const T* gr = dy + row * cols;
    float mean = 0.0f;
    if constexpr (LN) {
      float s[1] = {0.0f};
      for (long long j = threadIdx.x; j < cols; j += THREADS) s[0] += to_f32(xr[j]);
      block_sum<1>(s, red);
      mean = s[0] / n;
    }
    float t[K] = {};
    for (long long j = threadIdx.x; j < cols; j += THREADS) {
      const float d = to_f32(xr[j]) - mean;
      const float g = to_f32(gr[j]) * to_f32(w[j]);
      t[0] += d * d;
      t[1] += g * d;
      if constexpr (LN) t[2] += g;
    }
    block_sum<K>(t, red);
    const float rstd = rsqrtf(t[0] / n + eps);
    const float mean_gxh = t[1] * rstd / n;
    const float mean_g = LN ? t[K - 1] / n : 0.0f;
    T* dxr = dx + row * cols;
    for (long long j = threadIdx.x; j < cols; j += THREADS) {
      const float gv = to_f32(gr[j]);
      const float xh = (to_f32(xr[j]) - mean) * rstd;
      dxr[j] = from_f32<T>(rstd * (gv * to_f32(w[j]) - mean_g - xh * mean_gxh));
      acc_s[j] += gv * xh;  // column j belongs to this thread alone
      if constexpr (LN) acc_s[cols + j] += gv;
    }
  }
  __syncthreads();  // the write below reads columns across threads
  float* out = part + static_cast<long long>(blockIdx.x) * R * cols;
  for (long long j = threadIdx.x; j < R * cols; j += THREADS) out[j] = acc_s[j];
}

// Pass 2: column j of the nblk partial rows (each nr x cols), summed in
// order: dw[j] for j < cols, else db[j - cols].
template <typename W>
__global__ void __launch_bounds__(THREADS)
    partial_reduce_kernel(const float* __restrict__ part, W* __restrict__ dw,
                          W* __restrict__ db, int nblk, long long cols, int nr) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long width = nr * cols;
  if (j >= width) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s += part[static_cast<long long>(b) * width + j];
  if (j < cols) {
    dw[j] = from_f32<W>(s);
  } else {
    db[j - cols] = from_f32<W>(s);
  }
}

template <bool LN, typename T, typename W>
int fwd(const void* x, const void* w, const void* b, void* y, long long rows,
        long long cols, float eps, cudaStream_t stream) {
  norm_kernel<LN, T, W><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const W*>(b),
      static_cast<T*>(y), cols, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool LN, typename T, typename W>
int bwd(const void* x, const void* w, const void* dy, void* dx, void* dw, void* db,
        float* part, int nblk, long long rows, long long cols, float eps,
        cudaStream_t stream) {
  constexpr int R = LN ? 2 : 1;
  auto kern = norm_bwd_kernel<LN, T, W>;
  const size_t smem = R * static_cast<size_t>(cols) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(nblk), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, cols, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((R * cols + THREADS - 1) / THREADS);
  partial_reduce_kernel<W><<<blocks, THREADS, 0, stream>>>(
      part, static_cast<W*>(dw), static_cast<W*>(db), nblk, cols, R);
  return static_cast<int>(cudaGetLastError());
}

// f(T{}, W{}) for x's dtype T and w's dtype W, or cudaErrorInvalidValue
template <typename T, typename F> int with_w(int wdtype, F f) {
  switch (wdtype) {
    case COX_F32: return f(T{}, float{});
    case COX_BF16: return f(T{}, __nv_bfloat16{});
    case COX_F16: return f(T{}, __half{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
template <typename F> int with_types(int dtype, int wdtype, F f) {
  switch (dtype) {
    case COX_F32: return with_w<float>(wdtype, f);
    case COX_BF16: return with_w<__nv_bfloat16>(wdtype, f);
    case COX_F16: return with_w<__half>(wdtype, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool fwd_ok(long long rows, long long cols) {
  return rows > 0 && rows <= 2147483647LL && cols > 0;
}
bool bwd_ok(int nr, int nblk, long long rows, long long cols) {
  return rows > 0 && cols > 0 && nblk > 0 && nblk <= rows &&
         nr * static_cast<size_t>(cols) * sizeof(float) <= MAX_SMEM - 1024;
}

}  // namespace
