// RMS norm over the last axis: y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the TPU kernel src/repro/kernels/norms.py::_rmsnorm_kernel
// (pallas_call in rmsnorm).  Same semantics: the sum of squares and the
// scaling in f32, the output in x's dtype (f32, bf16 or f16); w has a
// dtype of its own (f32 beside a bf16 x on the serving path, whose norm
// weights are f32).
//
// Bound: memory.  Three operations per element against 2 x sizeof(x)
// bytes moved, far below the card's ~295 operations per byte.  The TPU
// kernel held an 8-row tile in VMEM; here one block takes one row and
// reads it from device memory once: each thread loads its 16-byte
// vectors of the row into registers (up to VPT of them), the sum of
// squares is reduced with __shfl_xor_sync and one shared-memory step,
// and the scaled values are written from the same registers.  A
// qwen2.5-14b row (5,120 wide) fits the registers in f32, bf16 and f16;
// a wider row re-reads the part beyond them (from L2).  A row that does
// not start on a 16-byte boundary, and the ragged tail of a width that is
// not a multiple of the vector, take scalar loads.  w is read with scalar
// loads: it is one row, shared by every block, and stays in L1/L2.
//
// cox_rmsnorm_bwd computes the gradient (the TPU kernel has none: the
// reference trains through its plain XLA path).  With r = rsqrt(mean(x^2)
// + eps), dx = r * (w * dy) - x * r^3 * mean(x * w * dy) and dw = the sum
// over rows of dy * x * r, all in f32; dx in x's dtype, dw in w's.  Also
// bound by memory (x and dy read, dx written).  Two passes, so that dw is
// deterministic: (1) each block takes a range of rows; per row it sums
// x^2 and x * w * dy over the row (block reduction), then writes dx and
// adds dy * x * r into its own f32 partial dw row in shared memory (each
// thread owns its columns: no atomics); at the end it writes the partial
// row out; (2) a column reduction sums the blocks' partial rows in a fixed
// order.  The row's second read hits L1/L2.  Scalar loads: any alignment
// and width; the width is bounded by the partial row's shared memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VPT = 5;  // vectors a thread keeps in registers: 5,120 f32

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                   long long cols, float eps) {
  const long long base = static_cast<long long>(blockIdx.x) * cols;
  const T* row = x + base;
  T* out = y + base;
  constexpr int N = Vec<T>::N;
  const bool vec = aligned16(row) && aligned16(out);
  const long long nvec = vec ? cols / N : 0;
  const uint4* vrow = reinterpret_cast<const uint4*>(row);

  // pass over the row: registers for the first VPT vectors of each thread
  float held[VPT][N];
  float ss = 0.0f;
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const long long i = threadIdx.x + static_cast<long long>(r) * THREADS;
    if (i < nvec) {
      Vec<T> v;
      v.raw = vrow[i];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        held[r][k] = to_f32(v.get(k));
        ss += held[r][k] * held[r][k];
      }
    }
  }
  for (long long i = threadIdx.x + static_cast<long long>(VPT) * THREADS; i < nvec;
       i += THREADS) {
    Vec<T> v;
    v.raw = vrow[i];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float f = to_f32(v.get(k));
      ss += f * f;
    }
  }
  for (long long j = nvec * N + threadIdx.x; j < cols; j += THREADS) {
    const float f = to_f32(row[j]);
    ss += f * f;
  }

  // warp collective (red_add), then across the block's warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(FULL_MASK, ss, off);
  __shared__ float partial[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  ss = lane < THREADS / 32 ? partial[lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(FULL_MASK, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(cols) + eps);

  // scale and store in x's dtype: (x * inv) * w, the reference's order
  uint4* vout = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const long long i = threadIdx.x + static_cast<long long>(r) * THREADS;
    if (i < nvec) {
      Vec<T> o;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        o.set(k, from_f32<T>(held[r][k] * inv * to_f32(w[i * N + k])));
      }
      vout[i] = o.raw;
    }
  }
  for (long long i = threadIdx.x + static_cast<long long>(VPT) * THREADS; i < nvec;
       i += THREADS) {
    Vec<T> v, o;
    v.raw = vrow[i];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      o.set(k, from_f32<T>(to_f32(v.get(k)) * inv * to_f32(w[i * N + k])));
    }
    vout[i] = o.raw;
  }
  for (long long j = nvec * N + threadIdx.x; j < cols; j += THREADS) {
    out[j] = from_f32<T>(to_f32(row[j]) * inv * to_f32(w[j]));
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* y, long long rows, long long cols,
            float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), cols, eps);
}

template <typename T>
int launch_w(const void* x, const void* w, void* y, long long rows, long long cols,
             float eps, int wdtype, cudaStream_t stream) {
  switch (wdtype) {
    case COX_F32: launch<T, float>(x, w, y, rows, cols, eps, stream); break;
    case COX_BF16: launch<T, __nv_bfloat16>(x, w, y, rows, cols, eps, stream); break;
    case COX_F16: launch<T, __half>(x, w, y, rows, cols, eps, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

// sum a and b over the block; every thread gets both sums
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*red)[THREADS / 32]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(FULL_MASK, a, off);
    b += __shfl_xor_sync(FULL_MASK, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = lane < THREADS / 32 ? red[0][lane] : 0.0f;
  b = lane < THREADS / 32 ? red[1][lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(FULL_MASK, a, off);
    b += __shfl_xor_sync(FULL_MASK, b, off);
  }
  __syncthreads();  // red is free for the next row
}

// Pass 1: rows [blockIdx.x * per, ...) of x and dy; dx, and this block's
// partial dw in part[blockIdx.x] (f32, cols wide).
template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part, long long rows, long long cols, float eps) {
  extern __shared__ float dw_s[];
  __shared__ float red[2][THREADS / 32];
  for (long long j = threadIdx.x; j < cols; j += THREADS) dw_s[j] = 0.0f;
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
  const float n = static_cast<float>(cols);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * cols;
    const T* gr = dy + row * cols;
    float ss = 0.0f, sd = 0.0f;
    for (long long j = threadIdx.x; j < cols; j += THREADS) {
      const float xv = to_f32(xr[j]);
      ss += xv * xv;
      sd += xv * to_f32(w[j]) * to_f32(gr[j]);
    }
    block_sum2(ss, sd, red);
    const float r = rsqrtf(ss / n + eps);
    const float c = sd / n * r * r * r;
    T* dxr = dx + row * cols;
    for (long long j = threadIdx.x; j < cols; j += THREADS) {
      const float xv = to_f32(xr[j]), gv = to_f32(gr[j]);
      dxr[j] = from_f32<T>(r * (to_f32(w[j]) * gv) - xv * c);
      dw_s[j] += gv * xv * r;  // column j belongs to this thread alone
    }
  }
  float* out = part + static_cast<long long>(blockIdx.x) * cols;
  for (long long j = threadIdx.x; j < cols; j += THREADS) out[j] = dw_s[j];
}

// Pass 2: dw[j] = the sum of the nblk partial rows, in order.
template <typename W>
__global__ void __launch_bounds__(THREADS)
    dw_reduce_kernel(const float* __restrict__ part, W* __restrict__ dw, int nblk,
                     long long cols) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= cols) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s += part[static_cast<long long>(b) * cols + j];
  dw[j] = from_f32<W>(s);
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
               float* part, int nblk, long long rows, long long cols, float eps,
               cudaStream_t stream) {
  auto kern = rmsnorm_bwd_kernel<T, W>;
  const size_t smem = static_cast<size_t>(cols) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(nblk), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, cols, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((cols + THREADS - 1) / THREADS);
  dw_reduce_kernel<W><<<blocks, THREADS, 0, stream>>>(part, static_cast<W*>(dw), nblk, cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_w(const void* x, const void* w, const void* dy, void* dx, void* dw,
                 float* part, int nblk, long long rows, long long cols, float eps,
                 int wdtype, cudaStream_t stream) {
  switch (wdtype) {
    case COX_F32:
      return launch_bwd<T, float>(x, w, dy, dx, dw, part, nblk, rows, cols, eps, stream);
    case COX_BF16:
      return launch_bwd<T, __nv_bfloat16>(x, w, dy, dx, dw, part, nblk, rows, cols, eps, stream);
    case COX_F16:
      return launch_bwd<T, __half>(x, w, dy, dx, dw, part, nblk, rows, cols, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The gradient of cox_rmsnorm: dx (rows, cols) in x's dtype and dw (cols)
// in w's, from x, w and dy.  part is f32 scratch of nblk * cols values
// (nblk blocks, each taking a range of rows).  Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for an
// argument the kernels do not take.
extern "C" int cox_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                               void* dw, void* part, int nblk, long long rows,
                               long long cols, float eps, int dtype, int wdtype,
                               void* stream) {
  if (rows <= 0 || cols <= 0 || nblk <= 0 || nblk > rows ||
      static_cast<size_t>(cols) * sizeof(float) > MAX_SMEM - 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case COX_F32: return launch_bwd_w<float>(x, w, dy, dx, dw, p, nblk, rows, cols, eps, wdtype, s);
    case COX_BF16:
      return launch_bwd_w<__nv_bfloat16>(x, w, dy, dx, dw, p, nblk, rows, cols, eps, wdtype, s);
    case COX_F16: return launch_bwd_w<__half>(x, w, dy, dx, dw, p, nblk, rows, cols, eps, wdtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an argument the kernel does not take.
extern "C" int cox_rmsnorm(const void* x, const void* w, void* y, long long rows,
                           long long cols, float eps, int dtype, int wdtype,
                           void* stream) {
  if (rows <= 0 || rows > 2147483647LL || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case COX_F32: err = launch_w<float>(x, w, y, rows, cols, eps, wdtype, s); break;
    case COX_BF16:
      err = launch_w<__nv_bfloat16>(x, w, y, rows, cols, eps, wdtype, s);
      break;
    case COX_F16: err = launch_w<__half>(x, w, y, rows, cols, eps, wdtype, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
