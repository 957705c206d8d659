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

}  // namespace

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
