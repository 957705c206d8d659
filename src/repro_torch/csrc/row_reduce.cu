// Row reduction (rows, cols) -> (rows,): sum, max or absmax.
//
// Replaces the TPU kernel src/repro/kernels/warp_reduce.py::_reduce_kernel
// (pallas_call in row_reduce).  Same semantics: f32 accumulation, `sum`
// returns f32, `max`/`absmax` return the input dtype; max propagates NaN.
//
// Bound: memory.  Each element is read once and does one add or compare,
// far below the card's ~295 operations per byte, so the time is the bytes
// over the 3.35 TB/s of HBM.  The design keeps every byte moving once:
// one block per row, threads striding over the columns with 16-byte
// vector loads (a scalar tail, and a scalar path for a row whose start is
// not 16-byte aligned), f32 accumulators in registers, a warp reduction
// with __shfl_xor_sync and one shared-memory step across warps.  Speed
// beyond that (several rows per block for short rows) is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
enum Op { OP_SUM = 0, OP_MAX = 1, OP_ABSMAX = 2 };

template <int OP> __device__ __forceinline__ float combine(float acc, float v) {
  if (OP == OP_SUM) return acc + v;
  if (OP == OP_MAX) return nan_max(acc, v);
  return nan_max(acc, fabsf(v));
}

template <int OP> __device__ __forceinline__ float merge(float a, float b) {
  return OP == OP_SUM ? a + b : nan_max(a, b);
}

template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
    row_reduce_kernel(const T* __restrict__ x, void* __restrict__ out, long long cols) {
  const T* row = x + static_cast<long long>(blockIdx.x) * cols;
  float acc = OP == OP_SUM ? 0.0f : -INFINITY;
  long long start = 0;
  if (aligned16(row)) {
    constexpr int N = Vec<T>::N;
    const long long nvec = cols / N;
    const uint4* vrow = reinterpret_cast<const uint4*>(row);
    for (long long i = threadIdx.x; i < nvec; i += THREADS) {
      Vec<T> v;
      v.raw = vrow[i];
#pragma unroll
      for (int k = 0; k < N; ++k) acc = combine<OP>(acc, to_f32(v.get(k)));
    }
    start = nvec * N;
  }
  for (long long j = start + threadIdx.x; j < cols; j += THREADS) {
    acc = combine<OP>(acc, to_f32(row[j]));
  }
  // warp collective (red_add / red_max), then across the block's warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = merge<OP>(acc, __shfl_xor_sync(FULL_MASK, acc, off));
  }
  __shared__ float partial[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < THREADS / 32 ? partial[lane] : (OP == OP_SUM ? 0.0f : -INFINITY);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = merge<OP>(acc, __shfl_xor_sync(FULL_MASK, acc, off));
    }
    if (lane == 0) {
      if (OP == OP_SUM) {
        static_cast<float*>(out)[blockIdx.x] = acc;
      } else {
        static_cast<T*>(out)[blockIdx.x] = from_f32<T>(acc);
      }
    }
  }
}

template <typename T>
void launch(const void* x, void* out, long long rows, long long cols, int op,
            cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  dim3 grid(static_cast<unsigned>(rows));
  if (op == OP_SUM) {
    row_reduce_kernel<T, OP_SUM><<<grid, THREADS, 0, stream>>>(xt, out, cols);
  } else if (op == OP_MAX) {
    row_reduce_kernel<T, OP_MAX><<<grid, THREADS, 0, stream>>>(xt, out, cols);
  } else {
    row_reduce_kernel<T, OP_ABSMAX><<<grid, THREADS, 0, stream>>>(xt, out, cols);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an argument the kernel does not take.
extern "C" int cox_row_reduce(const void* x, void* out, long long rows, long long cols,
                              int dtype, int op, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || cols <= 0 || op < 0 || op > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case COX_F32: launch<float>(x, out, rows, cols, op, s); break;
    case COX_BF16: launch<__nv_bfloat16>(x, out, rows, cols, op, s); break;
    case COX_F16: launch<__half>(x, out, rows, cols, op, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
