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
// kernels held an 8-row tile in VMEM; here a team of 1 to 8 warps takes a
// row at a time, and a block holds several teams (norm_kernel):
//
// - A thread owns fixed columns: its 16-byte vectors t, t + team threads,
//   ..., up to HELD values (24, in f32: 6 vectors of f32 or 3 of bf16), so
//   a warp holds 768 columns and a team of ceil(cols / 768) warps (at
//   most 8) a whole row of up to 6,144 in registers.  A wider row keeps
//   the part beyond them in device memory and re-reads it (from L2).
// - Each team walks a few rows (kernels/norms.py NORM_ROWS): blockIdx *
//   teams + team, + grid * teams, ...  w and b (the held columns) are
//   copied once per block into shared memory, 16 bytes a cp.async, and
//   serve every row of the block; and the loads of a team's next row
//   are issued before the current row's reductions, so memory stays busy
//   through them.  The grid is several waves, which the card's scheduler
//   balances; one persistent wave (about 21 rows a team) was slower on
//   the H100 (scripts/memory_kernels.py --team-rows).
// - A row's sums: __shfl_xor_sync within each warp, then, for a team of
//   several warps, the warps' partial sums through shared memory in warp
//   order behind a named barrier of the team alone (none for a warp).
//   The layer norm's centred squares come from the same registers.
// - kernels/norms.py norm_plan picks warps a row, teams a block and the
//   grid from the width and the card.  A row that does not start on a
//   16-byte boundary, or a width that is not a multiple of the vector,
//   takes scalar loads for every column, as do unaligned w and b.
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
#include "wgmma.cuh"  // cp.async

namespace {

constexpr int THREADS = 256;  // the backward's blocks
constexpr int WARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90
// the forward: x values a thread keeps in registers (f32), warps a row at
// most, and threads a block at most (kernels/norms.py NORM_*)
constexpr int HELD = 24;
constexpr int MAX_ROW_WARPS = 8;
constexpr int MAX_BLOCK = 256;

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

__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The sum of v over a team of `warps` warps; every thread of the team
// gets it.  red holds the team's warp partials; the caller alternates
// between two such slots, so one barrier a sum suffices.
__device__ __forceinline__ float team_sum(float v, float* red, int warps, int team) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  if (warps == 1) return v;
  const int t = threadIdx.x % (32 * warps);
  if (t % 32 == 0) red[t / 32] = v;
  team_barrier(1 + team, 32 * warps);
  float s = 0.0f;
  for (int w = 0; w < warps; ++w) s += red[w];
  return s;
}

// Teams of `warps` warps, blockDim.x / (32 * warps) of them a block, each
// walking rows blockIdx.x * teams + team, + gridDim.x * teams, ...
// Dynamic shared memory: w, then b (layer norm), in their dtype, for the
// columns held in registers.  An SM holds 768 threads of 2-byte rows, 512 of f32
// rows, whose held vectors take twice the registers.
template <bool LN, typename T, typename W>
__global__ void __launch_bounds__(MAX_BLOCK, sizeof(T) == 4 ? 2 : 3)
    norm_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                T* __restrict__ y, long long rows, long long cols, float eps, int warps) {
  constexpr int N = Vec<T>::N;
  constexpr int VPT = HELD / N;  // vectors a thread holds
  extern __shared__ __align__(16) float wb_s[];
  __shared__ float red[2][MAX_BLOCK / 32][MAX_ROW_WARPS];
  const int tt = 32 * warps;  // threads a team
  const int teams = blockDim.x / tt;
  const int team = threadIdx.x / tt, t = threadIdx.x % tt;
  const bool vec = cols % N == 0 && aligned16(x) && aligned16(y);
  const long long nvec = vec ? cols / N : 0;
  const long long held = min(nvec, static_cast<long long>(VPT) * tt);  // vectors a row
  const float n = static_cast<float>(cols);
  const long long stride = static_cast<long long>(gridDim.x) * teams;
  long long row = static_cast<long long>(blockIdx.x) * teams + team;

  uint4 raw[VPT];  // the held vectors of the team's next row, as loaded
  auto load = [&](long long r) {
    if (r >= rows) return;
    const uint4* vrow = reinterpret_cast<const uint4*>(x + r * cols);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const long long i = t + static_cast<long long>(k) * tt;
      if (i < held) raw[k] = vrow[i];
    }
  };
  load(row);

  // w and b of the held columns, in their own dtype, once for the block's
  // rows: 16-byte asynchronous copies, all in flight at once beside the
  // row's loads (scalar copies where w or b is off a 16-byte boundary)
  const long long hc = held * N;
  constexpr int NW = 16 / sizeof(W);
  W* w_s = reinterpret_cast<W*>(wb_s);
  W* b_s = w_s + (hc + NW - 1) / NW * NW;  // 16-byte aligned
  if (hc % NW == 0 && aligned16(w) && (!LN || aligned16(b))) {
    for (long long i = threadIdx.x; i < hc / NW; i += blockDim.x) {
      wg::cp_async16(wg::smem_u32(w_s + i * NW), w + i * NW, 16);
      if constexpr (LN) wg::cp_async16(wg::smem_u32(b_s + i * NW), b + i * NW, 16);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
  } else {
    for (long long j = threadIdx.x; j < hc; j += blockDim.x) {
      w_s[j] = w[j];
      if constexpr (LN) b_s[j] = b[j];
    }
  }
  __syncthreads();

  for (int it = 0; row < rows; row += stride, ++it) {
    const T* xr = x + row * cols;
    T* out = y + row * cols;
    float v[VPT][N];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      Vec<T> xv;
      xv.raw = raw[k];
#pragma unroll
      for (int e = 0; e < N; ++e) v[k][e] = to_f32(xv.get(e));
    }
    load(row + stride);  // in flight through this row's sums

    // the columns beyond the registers: vectors past the held ones, then
    // the scalar tail (every column on the scalar path); f(j, x[j])
    auto beyond = [&](auto f) {
      const uint4* vrow = reinterpret_cast<const uint4*>(xr);
      for (long long i = held + t; i < nvec; i += tt) {
        Vec<T> xv;
        xv.raw = vrow[i];
#pragma unroll
        for (int e = 0; e < N; ++e) f(i * N + e, to_f32(xv.get(e)));
      }
      for (long long j = nvec * N + t; j < cols; j += tt) f(j, to_f32(xr[j]));
    };
    auto each_held = [&](auto f) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (t + static_cast<long long>(k) * tt < held) {
#pragma unroll
          for (int e = 0; e < N; ++e) f(k, e);
        }
      }
    };

    // the sum of x (layer norm) or of x^2 (rms norm)
    float s = 0.0f;
    each_held([&](int k, int e) { s += LN ? v[k][e] : v[k][e] * v[k][e]; });
    beyond([&](long long, float xv) { s += LN ? xv : xv * xv; });
    s = team_sum(s, red[LN ? 0 : it & 1][team], warps, team);
    float mean = 0.0f;
    if constexpr (LN) {
      // the centred sum of squares
      mean = s / n;
      s = 0.0f;
      each_held([&](int k, int e) { s += (v[k][e] - mean) * (v[k][e] - mean); });
      beyond([&](long long, float xv) { s += (xv - mean) * (xv - mean); });
      s = team_sum(s, red[1][team], warps, team);
    }
    const float inv = rsqrtf(s / n + eps);

    // ((x - mean) * inv) * w (+ b), stored in x's dtype
    uint4* vout = reinterpret_cast<uint4*>(out);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const long long i = t + static_cast<long long>(k) * tt;
      if (i < held) {
        Vec<T> o;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float r = (v[k][e] - mean) * inv * to_f32(w_s[i * N + e]);
          if constexpr (LN) {
            o.set(e, from_f32<T>(r + to_f32(b_s[i * N + e])));
          } else {
            o.set(e, from_f32<T>(r));
          }
        }
        vout[i] = o.raw;
      }
    }
    beyond([&](long long j, float xv) {
      const float r = (xv - mean) * inv * to_f32(w[j]);
      if constexpr (LN) {
        out[j] = from_f32<T>(r + to_f32(b[j]));
      } else {
        out[j] = from_f32<T>(r);
      }
    });
  }
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
        long long cols, float eps, int warps, int teams, int blocks, cudaStream_t stream) {
  constexpr int N = Vec<T>::N, NW = 16 / sizeof(W);
  const long long held = min(cols / N, static_cast<long long>(HELD / N) * 32 * warps);
  const long long padded = (held * N + NW - 1) / NW * NW;  // w's, b's offset
  const size_t smem = (LN ? 2 : 1) * sizeof(W) * static_cast<size_t>(padded);
  auto kern = norm_kernel<LN, T, W>;
  // above 48 KB a block's shared memory needs an opt-in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(2 * sizeof(float) * HELD * MAX_BLOCK));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  kern<<<static_cast<unsigned>(blocks), teams * 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const W*>(b),
      static_cast<T*>(y), rows, cols, eps, warps);
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

bool fwd_ok(long long rows, long long cols, int warps, int teams, int blocks) {
  return rows > 0 && cols > 0 && warps >= 1 && warps <= MAX_ROW_WARPS && teams >= 1 &&
         teams * 32 * warps <= MAX_BLOCK && blocks >= 1;
}
bool bwd_ok(int nr, int nblk, long long rows, long long cols) {
  return rows > 0 && cols > 0 && nblk > 0 && nblk <= rows &&
         nr * static_cast<size_t>(cols) * sizeof(float) <= MAX_SMEM - 1024;
}

}  // namespace
