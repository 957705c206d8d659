// Layer norm over the last axis, y = (x - mean) * rsqrt(var + eps) * w + b,
// and its gradient: norm.cuh's kernels with LN = true (the variance in
// two passes, the bias, and db beside dw).
//
// Replaces the TPU kernel src/repro/kernels/norms.py::_layernorm_kernel
// (pallas_call in layernorm); the gradient has no TPU kernel.  The design,
// the semantics and the bound are norm.cuh's.
#include "norm.cuh"

// Each entry point returns cudaGetLastError() after its launches (0 on
// success), or cudaErrorInvalidValue for an argument the kernels do not
// take.  w and b have the dtype wdtype.  The forward runs teams of `warps`
// warps a row, `teams` of them a block, on `blocks` blocks
// (kernels/norms.py norm_plan).

extern "C" int cox_layernorm(const void* x, const void* w, const void* b, void* y,
                             long long rows, long long cols, float eps, int dtype,
                             int wdtype, int warps, int teams, int blocks, void* stream) {
  if (!fwd_ok(rows, cols, warps, teams, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, wdtype, [&](auto t, auto wt) {
    return fwd<true, decltype(t), decltype(wt)>(x, w, b, y, rows, cols, eps, warps, teams,
                                                blocks, s);
  });
}

// The gradient of cox_layernorm: dx (rows, cols) in x's dtype, dw and db
// (cols) in w's, from x, w and dy (b does not enter it).  The plan's
// arguments are cox_rmsnorm_bwd's; part is f32 scratch of nblk * 2 * cols
// values.
extern "C" int cox_layernorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                                 void* dw, void* db, void* part, long long rows,
                                 long long cols, float eps, int dtype, int wdtype, int warps,
                                 int teams, int nblk, long long per, int hold,
                                 int splits, void* stream) {
  if (!bwd_ok(rows, cols, warps, teams, nblk, per, splits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, wdtype, [&](auto t, auto wt) {
    return bwd<true, decltype(t), decltype(wt)>(x, w, dy, dx, dw, db, p, rows, cols, eps, warps,
                                                teams, nblk, per, hold != 0, splits, s);
  });
}
