// Row reduction (rows, cols) -> (rows,): sum, max or absmax.
//
// Replaces the TPU kernel src/repro/kernels/warp_reduce.py::_reduce_kernel
// (pallas_call in row_reduce).  Same semantics: f32 accumulation, `sum`
// returns f32, `max`/`absmax` return the input dtype; max propagates NaN.
//
// Bound: memory.  Each element is read once and does one add or compare
// (a compensated add: six), far below the card's ~295 operations per
// byte, so the time is the bytes over the 3.35 TB/s of HBM.  The design
// keeps every byte moving once: one block per row, threads striding over
// the columns with 16-byte vector loads (a scalar tail, and a scalar path
// for a row whose start is not 16-byte aligned), f32 accumulators in
// registers, a warp reduction with __shfl_xor_sync and one shared-memory
// step across warps.  The sum is compensated: each thread keeps the exact
// rounding error of every add (TwoSum) beside its sum, and the tree merges
// (sum, error) pairs the same way.  A plain f32 sum in this order (each of
// 256 threads adding ~600 values of a 152,064-wide row in sequence) lay up
// to 4.9e-4 from the f64 sum, against 2.0e-4 for torch.sum; compensated,
// it is within an ulp or two of the result.  Speed beyond that (several
// rows per block for short rows) is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
enum Op { OP_SUM = 0, OP_MAX = 1, OP_ABSMAX = 2 };

template <int OP> __device__ __forceinline__ float combine(float acc, float v) {
  if (OP == OP_MAX) return nan_max(acc, v);
  return nan_max(acc, fabsf(v));
}

// A row's running value: (sum, error) for OP_SUM, the max otherwise.
template <int OP> struct Acc {
  float a = OP == OP_SUM ? 0.0f : -INFINITY;
  float c = 0.0f;
  __device__ __forceinline__ void add(float v) {
    if (OP == OP_SUM) {
      two_sum_add(a, c, v);
    } else {
      a = combine<OP>(a, v);
    }
  }
  __device__ __forceinline__ void merge(float a2, float c2) {
    if (OP == OP_SUM) {
      two_sum_add(a, c, a2);
      c += c2;
    } else {
      a = nan_max(a, a2);
    }
  }
  __device__ __forceinline__ void merge_lanes(int off) {
    const float a2 = __shfl_xor_sync(FULL_MASK, a, off);
    const float c2 = __shfl_xor_sync(FULL_MASK, c, off);
    merge(a2, c2);
  }
};

template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
    row_reduce_kernel(const T* __restrict__ x, void* __restrict__ out, long long cols) {
  const T* row = x + static_cast<long long>(blockIdx.x) * cols;
  Acc<OP> acc;
  long long start = 0;
  if (aligned16(row)) {
    constexpr int N = Vec<T>::N;
    const long long nvec = cols / N;
    const uint4* vrow = reinterpret_cast<const uint4*>(row);
    for (long long i = threadIdx.x; i < nvec; i += THREADS) {
      Vec<T> v;
      v.raw = vrow[i];
#pragma unroll
      for (int k = 0; k < N; ++k) acc.add(to_f32(v.get(k)));
    }
    start = nvec * N;
  }
  for (long long j = start + threadIdx.x; j < cols; j += THREADS) {
    acc.add(to_f32(row[j]));
  }
  // warp collective (red_add / red_max), then across the block's warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc.merge_lanes(off);
  __shared__ float partial[2][THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    partial[0][warp] = acc.a;
    partial[1][warp] = acc.c;
  }
  __syncthreads();
  if (warp == 0) {
    Acc<OP> all;
    if (lane < THREADS / 32) all.merge(partial[0][lane], partial[1][lane]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) all.merge_lanes(off);
    if (lane == 0) {
      if (OP == OP_SUM) {
        static_cast<float*>(out)[blockIdx.x] = all.a + all.c;
      } else {
        static_cast<T*>(out)[blockIdx.x] = from_f32<T>(all.a);
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
