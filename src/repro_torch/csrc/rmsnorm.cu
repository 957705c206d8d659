// RMS norm over the last axis, y = x * rsqrt(mean(x^2) + eps) * w, and its
// gradient: norm.cuh's kernels with LN = false (mean 0, no bias, no db).
//
// Replaces the TPU kernel src/repro/kernels/norms.py::_rmsnorm_kernel
// (pallas_call in rmsnorm); the gradient has no TPU kernel.  The design,
// the semantics and the bound are norm.cuh's.
#include "norm.cuh"

// Each entry point returns cudaGetLastError() after its launches (0 on
// success), or cudaErrorInvalidValue for an argument the kernels do not
// take.  w has the dtype wdtype.  The forward runs teams of `warps` warps
// a row, `teams` of them a block, on `blocks` blocks (kernels/norms.py
// norm_plan).

extern "C" int cox_rmsnorm(const void* x, const void* w, void* y, long long rows,
                           long long cols, float eps, int dtype, int wdtype, int warps,
                           int teams, int blocks, void* stream) {
  if (!fwd_ok(rows, cols, warps, teams, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, wdtype, [&](auto t, auto wt) {
    return fwd<false, decltype(t), decltype(wt)>(x, w, nullptr, y, rows, cols, eps, warps,
                                                 teams, blocks, s);
  });
}

// The gradient of cox_rmsnorm: dx (rows, cols) in x's dtype and dw (cols)
// in w's, from x, w and dy.  Pass 1 runs teams of `warps` warps a row,
// `teams` of them a block, on nblk blocks of `per` rows each, holding the
// rows' 16-byte vectors or not (`hold`); part is f32 scratch of nblk * cols
// values (a partial row a block), which pass 2 sums with `splits` warps a
// block (kernels/norms.py norm_bwd_plan).
extern "C" int cox_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                               void* dw, void* part, long long rows, long long cols,
                               float eps, int dtype, int wdtype, int warps, int teams,
                               int nblk, long long per, int hold, int splits,
                               void* stream) {
  if (!bwd_ok(rows, cols, warps, teams, nblk, per, splits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, wdtype, [&](auto t, auto wt) {
    return bwd<false, decltype(t), decltype(wt)>(x, w, dy, dx, dw, nullptr, p, rows, cols, eps,
                                                 warps, teams, nblk, per, hold != 0, splits, s);
  });
}
