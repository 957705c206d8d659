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
// dtype, dw and db in w's.  Bound: memory (x and dy read, dx written).
// Two passes, so that dw and db are deterministic (one writer per value,
// sums in a fixed order, no atomics):
//
// - Pass 1 (norm_bwd_kernel) takes the forward's layout: a team of
//   ceil(cols / 768) warps a row, several teams a block, a thread owning
//   the same 16-byte column vectors of every row.  It holds x and dy of
//   those columns in registers, read once a row from a ring of two rows in
//   shared memory that cp.async fills (the next row's copies in flight
//   through the current row's sums; registers, not shared memory, are what
//   run short), holds w in shared memory once a block, and sums dy * xh
//   (and dy) for its columns across its team's rows in f32 registers,
//   stored 16 bytes a thread at the end.  A row needs one team reduction
//   of two sums (rms: x^2 and g * x; the layer norm two: x and g, then
//   (x - mean)^2 and g * (x - mean)), by warp shuffles and the team's
//   named barrier; no block-wide barrier a row.
//   A block takes a contiguous range of rows, its teams interleaved in
//   it; at the end it adds its teams' sums in team order (through shared
//   memory; straight from registers for a team alone) and writes one
//   partial row (dw's cols, then db's).  Columns beyond the held ones,
//   and every column of a row off a 16-byte boundary or of a ragged
//   width, are re-read from L2 and summed in shared-memory partial rows
//   that the owning thread alone updates; rows so wide that those leave
//   the ring no room hold no columns.  A few hundred blocks, two an SM
//   (kernels/norms.py norm_bwd_plan): a few hundred partial rows.
// - Pass 2 (partial_reduce_kernel) sums the partial rows column by
//   column: a block takes 32 columns and splits the partial rows among
//   its warps in contiguous ranges of at most 16, each summed in order,
//   then the ranges in order; enough blocks and short chains that it
//   takes a few microseconds.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"  // cp.async

namespace {

constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90
// x values a thread keeps in registers (f32), warps a row at most, and
// threads a block at most (kernels/norms.py NORM_*)
constexpr int HELD = 24;
constexpr int MAX_ROW_WARPS = 8;
constexpr int MAX_BLOCK = 256;
constexpr int MAX_SPLITS = 32;  // the backward's pass 2: warps a block
constexpr int RING = 2;  // the backward's ring of rows in shared memory

// The 16-byte vectors of a row that a team of tt threads holds in
// registers: none where the rows take scalar loads.
template <typename T>
__host__ __device__ __forceinline__ long long held_vectors(bool vec, long long cols, int tt) {
  constexpr int N = 16 / sizeof(T);
  return vec ? min(cols / N, static_cast<long long>(HELD / N) * tt) : 0;
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
  const long long held = held_vectors<T>(vec, cols, tt);  // vectors a row
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

// The sums a and b over a team of `warps` warps; every thread of the
// team gets them.  red holds each warp's pair; the caller alternates
// between two such slots, so one barrier a sum suffices.
__device__ __forceinline__ void team_sum2(float& a, float& b, float (*red)[2], int warps,
                                          int team) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(FULL_MASK, a, off);
    b += __shfl_xor_sync(FULL_MASK, b, off);
  }
  if (warps == 1) return;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp][0] = a;
    red[warp][1] = b;
  }
  team_barrier(1 + team, 32 * warps);
  a = b = 0.0f;
  for (int w = team * warps; w < (team + 1) * warps; ++w) {
    a += red[w][0];
    b += red[w][1];
  }
}

// Pass 1 of the gradient.  Block b takes rows [b * per, (b + 1) * per):
// team k of its teams rows b * per + k, + teams, ...; dx, and the block's
// partial rows in part[b] (f32: dw's cols, then for the layer norm db's).
// With `hold` a thread holds its columns' 16-byte vectors: it copies them,
// of x and dy, into its own slots of a ring of RING rows in shared memory
// by cp.async, the next row's while it sums the current one (each thread
// reads only what it copied, so no barrier), and takes its row from there
// into registers; without, it holds none (the widest rows, whose partial
// rows fill shared memory).  Dynamic shared memory: w of the held columns,
// in its dtype; the ring; then the f32 partial rows of columns [lo, cols)
// for each team, where lo is the held width for a team alone (its held sums
// go straight to part) and 0 for several (their held sums meet there).
template <bool LN, typename T, typename W>
__global__ void __launch_bounds__(MAX_BLOCK, sizeof(T) == 4 ? 1 : 2)
    norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                    long long rows, long long cols, float eps, int warps, long long per,
                    bool hold) {
  constexpr int N = Vec<T>::N;
  constexpr int VPT = HELD / N;  // vectors a thread holds
  constexpr int R = LN ? 2 : 1;  // partial rows
  extern __shared__ __align__(16) float bwd_s[];
  __shared__ float red[2][MAX_BLOCK / 32][2];
  const int tt = 32 * warps;  // threads a team
  const int teams = blockDim.x / tt;
  const int team = threadIdx.x / tt, t = threadIdx.x % tt;
  const bool vec = cols % N == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  const long long nvec = vec ? cols / N : 0;
  const long long held = hold ? held_vectors<T>(vec, cols, tt) : 0;
  const long long hc = held * N;  // held columns
  const float n = static_cast<float>(cols);
  const long long r0 = static_cast<long long>(blockIdx.x) * per;
  const long long r1 = min(rows, r0 + per);
  long long row = r0 + team;

  // shared memory: w (16-byte aligned), the ring, the partial rows
  constexpr int NW = 16 / sizeof(W);
  W* w_s = reinterpret_cast<W*>(bwd_s);
  uint4* ring = reinterpret_cast<uint4*>(bwd_s) + (hc + NW - 1) / NW;
  const long long lo = teams == 1 ? hc : 0;
  const long long aw = cols - lo;  // columns of the shared partial rows
  float* acc = reinterpret_cast<float*>(ring + RING * teams * 2 * held);
  auto slot = [&](int s, int a, long long i) {  // x (a = 0) or dy's vector i of ring row s
    return ring + ((static_cast<long long>(s) * teams + team) * 2 + a) * held + i;
  };
  auto fetch = [&](long long r, int s) {  // row r's held vectors into ring row s
    if (r < r1) {
      const uint4* vx = reinterpret_cast<const uint4*>(x + r * cols);
      const uint4* vdy = reinterpret_cast<const uint4*>(dy + r * cols);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const long long i = t + static_cast<long long>(k) * tt;
        if (i < held) {
          wg::cp_async16(wg::smem_u32(slot(s, 0, i)), vx + i, 16);
          wg::cp_async16(wg::smem_u32(slot(s, 1, i)), vdy + i, 16);
        }
      }
    }
    wg::cp_async_commit();
  };

  // w of the held columns, once for the block's rows (as the forward's),
  // then the first row
  if (hc % NW == 0 && aligned16(w)) {
    for (long long i = threadIdx.x; i < hc / NW; i += blockDim.x) {
      wg::cp_async16(wg::smem_u32(w_s + i * NW), w + i * NW, 16);
    }
  } else {
    for (long long j = threadIdx.x; j < hc; j += blockDim.x) w_s[j] = w[j];
  }
  wg::cp_async_commit();
  fetch(row, 0);
  for (long long j = threadIdx.x; j < teams * R * aw; j += blockDim.x) acc[j] = 0.0f;
  wg::cp_async_wait<1>();  // w has landed
  __syncthreads();
  float* acc_t = acc + team * R * aw - lo;  // this team's, indexed by column

  float dw_r[VPT][N] = {}, db_r[VPT][N] = {};  // db_r: the layer norm's
  int slot_red = 0;
  for (int it = 0; row < r1; row += teams, ++it) {
    uint4 cx[VPT], cdy[VPT];
    if (held) {
      wg::cp_async_wait<0>();  // this row's vectors have landed
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const long long i = t + static_cast<long long>(k) * tt;
        if (i < held) {
          cx[k] = *slot(it % RING, 0, i);
          cdy[k] = *slot(it % RING, 1, i);
        }
      }
      // into the ring row that the previous row left (read before its sums)
      fetch(row + teams, (it + 1) % RING);
    }
    const T* xr = x + row * cols;
    const T* gr = dy + row * cols;
    auto xv = [&](int k, int e) {
      Vec<T> v;
      v.raw = cx[k];
      return to_f32(v.get(e));
    };
    auto dyv = [&](int k, int e) {
      Vec<T> v;
      v.raw = cdy[k];
      return to_f32(v.get(e));
    };
    auto wv = [&](int k, int e) { return to_f32(w_s[(t + k * tt) * N + e]); };
    // f(k, e) for each held value; g(j, x[j], dy[j]) for the columns
    // beyond them: vectors past the held ones, then the scalar tail
    auto each_held = [&](auto f) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (t + static_cast<long long>(k) * tt < held) {
#pragma unroll
          for (int e = 0; e < N; ++e) f(k, e);
        }
      }
    };
    auto beyond = [&](auto g) {
      const uint4* vx = reinterpret_cast<const uint4*>(xr);
      const uint4* vdy = reinterpret_cast<const uint4*>(gr);
      for (long long i = held + t; i < nvec; i += tt) {
        Vec<T> a, d;
        a.raw = vx[i];
        d.raw = vdy[i];
#pragma unroll
        for (int e = 0; e < N; ++e) g(i * N + e, to_f32(a.get(e)), to_f32(d.get(e)));
      }
      for (long long j = nvec * N + t; j < cols; j += tt) g(j, to_f32(xr[j]), to_f32(gr[j]));
    };

    float mean = 0.0f, mean_g = 0.0f, s0 = 0.0f, s1 = 0.0f;
    if constexpr (LN) {
      // the sums of x and of g
      each_held([&](int k, int e) {
        s0 += xv(k, e);
        s1 += dyv(k, e) * wv(k, e);
      });
      beyond([&](long long j, float a, float d) {
        s0 += a;
        s1 += d * to_f32(w[j]);
      });
      team_sum2(s0, s1, red[slot_red], warps, team);
      slot_red ^= 1;
      mean = s0 / n;
      mean_g = s1 / n;
      s0 = s1 = 0.0f;
    }
    // the sums of (x - mean)^2 and of g * (x - mean)
    each_held([&](int k, int e) {
      const float d = xv(k, e) - mean;
      s0 += d * d;
      s1 += dyv(k, e) * wv(k, e) * d;
    });
    beyond([&](long long j, float a, float g) {
      const float d = a - mean;
      s0 += d * d;
      s1 += g * to_f32(w[j]) * d;
    });
    team_sum2(s0, s1, red[slot_red], warps, team);
    slot_red ^= 1;
    const float rstd = rsqrtf(s0 / n + eps);
    const float mean_gxh = s1 * rstd / n;

    // dx, stored in x's dtype; dy * xh (and dy) into the column sums
    uint4* vout = reinterpret_cast<uint4*>(dx + row * cols);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const long long i = t + static_cast<long long>(k) * tt;
      if (i < held) {
        Vec<T> o;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float d = dyv(k, e), xh = (xv(k, e) - mean) * rstd;
          o.set(e, from_f32<T>(rstd * (d * wv(k, e) - mean_g - xh * mean_gxh)));
          dw_r[k][e] += d * xh;
          if constexpr (LN) db_r[k][e] += d;
        }
        vout[i] = o.raw;
      }
    }
    T* dxr = dx + row * cols;
    beyond([&](long long j, float a, float d) {
      const float xh = (a - mean) * rstd;
      dxr[j] = from_f32<T>(rstd * (d * to_f32(w[j]) - mean_g - xh * mean_gxh));
      acc_t[j] += d * xh;  // column j belongs to this thread alone
      if constexpr (LN) acc_t[aw + j] += d;
    });
  }

  // the held columns' sums: to part for a team alone, else beside the
  // other teams'; then every column's sum over the teams, in team order
  float* out = part + static_cast<long long>(blockIdx.x) * R * cols;
  // (16-byte stores: a held row's width is a multiple of 4)
  float* dst = teams == 1 ? out : acc_t;
  const long long dst_r = teams == 1 ? cols : aw;  // between dw's and db's
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const long long i = t + static_cast<long long>(k) * tt;
    if (i < held) {
      float4* dw4 = reinterpret_cast<float4*>(dst + i * N);
      float4* db4 = reinterpret_cast<float4*>(dst + dst_r + i * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float* v = dw_r[k] + 4 * q;
        dw4[q] = make_float4(v[0], v[1], v[2], v[3]);
        if constexpr (LN) {
          const float* u = db_r[k] + 4 * q;
          db4[q] = make_float4(u[0], u[1], u[2], u[3]);
        }
      }
    }
  }
  __syncthreads();
  for (long long j = threadIdx.x; j < R * aw; j += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < teams; ++k) s += acc[k * R * aw + j];
    out[j / aw * cols + lo + j % aw] = s;
  }
}

// Pass 2: column j of the nblk partial rows (each nr x cols): dw[j] for
// j < cols, else db[j - cols].  A block takes 32 columns; its warp s
// sums partial rows [s * q, (s + 1) * q) in order, and the warps' sums
// are added in warp order.
template <typename W>
__global__ void __launch_bounds__(32 * MAX_SPLITS)
    partial_reduce_kernel(const float* __restrict__ part, W* __restrict__ dw,
                          W* __restrict__ db, int nblk, long long cols, int nr) {
  __shared__ float red[MAX_SPLITS][32];
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32, splits = blockDim.x / 32;
  const long long width = nr * cols;
  const long long j = static_cast<long long>(blockIdx.x) * 32 + lane;
  const int q = (nblk + splits - 1) / splits;
  const int b1 = min(nblk, (s + 1) * q);
  float acc = 0.0f;
  if (j < width) {
#pragma unroll 16
    for (int b = s * q; b < b1; ++b) acc += part[static_cast<long long>(b) * width + j];
  }
  red[s][lane] = acc;
  __syncthreads();
  if (s != 0 || j >= width) return;
  float sum = 0.0f;
  for (int k = 0; k < splits; ++k) sum += red[k][lane];
  if (j < cols) {
    dw[j] = from_f32<W>(sum);
  } else {
    db[j - cols] = from_f32<W>(sum);
  }
}

template <bool LN, typename T, typename W>
int fwd(const void* x, const void* w, const void* b, void* y, long long rows,
        long long cols, float eps, int warps, int teams, int blocks, cudaStream_t stream) {
  constexpr int N = Vec<T>::N, NW = 16 / sizeof(W);
  const long long held = held_vectors<T>(true, cols, 32 * warps);
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

// The backward's dynamic shared memory (kernels/norms.py bwd_smem): w of
// the held columns, the ring, then the teams' partial rows of columns
// [lo, cols).
template <bool LN, typename T, typename W>
size_t bwd_smem(bool vec, long long cols, int warps, int teams, bool hold) {
  constexpr int NW = 16 / sizeof(W);
  const long long held = hold ? held_vectors<T>(vec, cols, 32 * warps) : 0;
  const long long hc = held * Vec<T>::N;
  const long long aw = cols - (teams == 1 ? hc : 0);
  return 16 * static_cast<size_t>((hc + NW - 1) / NW + RING * teams * 2 * held) +
         sizeof(float) * static_cast<size_t>(teams * (LN ? 2 : 1) * aw);
}

template <bool LN, typename T, typename W>
int bwd(const void* x, const void* w, const void* dy, void* dx, void* dw, void* db,
        float* part, long long rows, long long cols, float eps, int warps, int teams,
        int nblk, long long per, bool hold, int splits, cudaStream_t stream) {
  constexpr int R = LN ? 2 : 1;
  const bool vec = cols % Vec<T>::N == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  const size_t smem = bwd_smem<LN, T, W>(vec, cols, warps, teams, hold);
  auto kern = norm_bwd_kernel<LN, T, W>;
  // above 48 KB a block's shared memory needs an opt-in, once per device,
  // up to what the kernel's static shared memory leaves
  static size_t limit[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (limit[dev] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int most = static_cast<int>(MAX_SMEM - attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit[dev] = static_cast<size_t>(most);
  }
  if (smem > limit[dev]) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(nblk), teams * 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, cols, eps, warps, per, hold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((R * cols + 31) / 32);
  partial_reduce_kernel<W><<<blocks, 32 * splits, 0, stream>>>(
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
// the backward's plan (kernels/norms.py norm_bwd_plan): every row in one
// block's range, teams of whole warps
bool bwd_ok(long long rows, long long cols, int warps, int teams, int nblk, long long per,
            int splits) {
  return rows > 0 && cols > 0 && warps >= 1 && warps <= MAX_ROW_WARPS && teams >= 1 &&
         teams * 32 * warps <= MAX_BLOCK && nblk >= 1 && per >= 1 &&
         static_cast<long long>(nblk) * per >= rows && splits >= 1 && splits <= MAX_SPLITS;
}

}  // namespace
