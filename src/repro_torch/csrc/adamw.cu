// AdamW's step over every leaf of a parameter tree in two multi-tensor
// kernels: cox_adamw_sumsq (the gradients' global norm, with
// cox_adamw_finalize's one small block) and cox_adamw_apply (the fused
// update, in place).
//
// Replaces no pl.pallas_call: the JAX package (src/repro/optim/adamw.py)
// leaves the update to XLA, whose fusion makes one pass of each leaf.
// The port's eager PyTorch ran ~12 f32 elementwise kernels a leaf, each
// reading and writing full-width f32 tensors, after casting every bf16
// gradient to a new f32 tensor.
//
// Bound: bytes.  A bf16 parameter moves 24 B a step at the least (its
// gradient read twice, for the norm and for the update; the parameter
// read and written; both f32 moments read and written), an f32 one 32 B,
// for ~20 flops: far below the card's ~295 operations a byte.  The design
// answers that bound with one read and one write of each tensor: nothing
// allocated at a parameter's width, streaming loads and stores
// (__ldcs/__stcs: nothing is reused), 16-byte vectors, each thread
// holding UNROLL units of 8 elements of all four tensors in flight before
// it computes.  A persistent grid walks the (leaf, chunk) pairs of a
// whole dtype group; the group's table of pointers and sizes is the
// kernel's argument, by value (at most 4 KB), so nothing is copied to the
// device and nothing waits on the host.  A leaf's ragged tail, and a leaf
// of which any tensor starts off a 16-byte boundary, take a scalar path.
//
// The norm is bitwise repeatable: each block writes one partial (a
// compensated f32 sum) to a slot of its own, and one block sums the slots
// in a fixed order, then writes the norm and the clip scale to the
// device; no float atomics.  The update does the eager path's arithmetic
// (kernels/adamw.py apply_plain) per element, in f32 and in the same
// order, each operation rounded alone by the __f*_rn intrinsics, which
// the compiler never contracts into an FMA.
#include "common.cuh"

// A launch's leaves, mirrored by kernels/build.py AdamWTable (its size
// checked against cox_adamw_layout's): leaf i's chunks are
// [chunk_start[i], chunk_start[i + 1]) of the launch's.
constexpr int ADAMW_MAX_LEAVES = 80;
struct AdamWTable {
  long long chunk_start[ADAMW_MAX_LEAVES + 1];
  long long numel[ADAMW_MAX_LEAVES];
  void* p[ADAMW_MAX_LEAVES];
  const void* g[ADAMW_MAX_LEAVES];
  float* m[ADAMW_MAX_LEAVES];
  float* v[ADAMW_MAX_LEAVES];
  int n;
};

namespace {

// kernels/adamw.py reads CHUNK and the blocks an SM holds of each kernel
// (the persistent grids' size) through cox_adamw_layout
constexpr int THREADS = 256;
constexpr int UNIT = 8;    // elements a thread takes at once: 16 B of bf16
constexpr int UNROLL = 2;  // units a thread holds in flight
constexpr long long CHUNK = THREADS * UNIT * UNROLL;
constexpr int SUMSQ_BLOCKS_PER_SM = 8;
constexpr int APPLY_BLOCKS_PER_SM = 3;

// 8 values of T in 16-byte vectors
template <typename T> struct Unit {
  static constexpr int NV = sizeof(T) * UNIT / 16;
  uint4 raw[NV];
  __device__ __forceinline__ void load(const T* src) {
    const uint4* q = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < NV; ++i) raw[i] = __ldcs(q + i);
  }
  __device__ __forceinline__ void store(T* dst) const {
    uint4* q = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = 0; i < NV; ++i) __stcs(q + i, raw[i]);
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const T*>(raw)[i]);
  }
  __device__ __forceinline__ void set(int i, float x) {
    reinterpret_cast<T*>(raw)[i] = from_f32<T>(x);
  }
};

// Chunk ch of the launch: its leaf (advanced from the block's last one,
// since a block's chunks only grow) and its elements [lo, hi).
struct Span {
  long long lo, hi;
};
__device__ __forceinline__ Span find(const AdamWTable& t, long long ch, int& leaf) {
  while (ch >= t.chunk_start[leaf + 1]) ++leaf;
  const long long lo = (ch - t.chunk_start[leaf]) * CHUNK;
  return {lo, min(lo + CHUNK, t.numel[leaf])};
}

// The block's (sum, error) pairs merged in a fixed order; thread 0's
// return value is the total.
__device__ float block_total(float s, float c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_xor_sync(FULL_MASK, s, off);
    const float c2 = __shfl_xor_sync(FULL_MASK, c, off);
    two_sum_add(s, c, s2);
    c += c2;
  }
  __shared__ float partial[2][THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    partial[0][warp] = s;
    partial[1][warp] = c;
  }
  __syncthreads();
  if (warp != 0) return 0.0f;
  s = lane < THREADS / 32 ? partial[0][lane] : 0.0f;
  c = lane < THREADS / 32 ? partial[1][lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_xor_sync(FULL_MASK, s, off);
    const float c2 = __shfl_xor_sync(FULL_MASK, c, off);
    two_sum_add(s, c, s2);
    c += c2;
  }
  return s + c;
}

// One block's sum of squares of its chunks' gradients: each chunk's
// share of a thread (at most 16 values) in a plain f32 sum, the chunks
// compensated.
template <typename G>
__global__ void __launch_bounds__(THREADS, SUMSQ_BLOCKS_PER_SM)
    sumsq_kernel(const __grid_constant__ AdamWTable t, float* __restrict__ partials) {
  float s = 0.0f, c = 0.0f;
  int leaf = 0;
  const long long chunks = t.chunk_start[t.n];
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const Span sp = find(t, ch, leaf);
    const G* g = static_cast<const G*>(t.g[leaf]);
    float part = 0.0f;
    long long e0 = sp.lo;
    if (aligned16(g)) {
      const long long units = (sp.hi - sp.lo) / UNIT;
      Unit<G> x[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long u = threadIdx.x + k * THREADS;
        if (u < units) x[k].load(g + sp.lo + u * UNIT);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        if (threadIdx.x + k * THREADS < units) {
#pragma unroll
          for (int i = 0; i < UNIT; ++i) part = fmaf(x[k].get(i), x[k].get(i), part);
        }
      }
      e0 = sp.lo + units * UNIT;
    }
    for (long long e = e0 + threadIdx.x; e < sp.hi; e += THREADS) {
      const float x = to_f32(g[e]);
      part = fmaf(x, x, part);
    }
    two_sum_add(s, c, part);
  }
  const float total = block_total(s, c);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// The slots summed in a fixed order: out[0] the norm, out[1] the clip
// scale min(clip / max(norm, 1e-12), 1) as the eager path rounds it
// (a reciprocal, then a product), or 1 without clipping; NaN stays NaN.
__global__ void __launch_bounds__(THREADS)
    finalize_kernel(const float* __restrict__ partials, int n, float* __restrict__ out, float clip) {
  float s = 0.0f, c = 0.0f;
  for (int i = threadIdx.x; i < n; i += THREADS) two_sum_add(s, c, partials[i]);
  const float total = block_total(s, c);
  if (threadIdx.x != 0) return;
  const float norm = __fsqrt_rn(total);
  float scale = 1.0f;
  if (clip != 0.0f) {
    const float lo = norm < 1e-12f ? 1e-12f : norm;
    const float r = __fmul_rn(__fdiv_rn(1.0f, lo), clip);
    scale = r > 1.0f ? 1.0f : r;
  }
  out[0] = norm;
  out[1] = scale;
}

// b1, 1 - b1, b2, 1 - b2 (each rounded from the double once), eps and the
// weight decay, in f32
struct Hyper {
  float b1, c1, b2, c2, eps, wd;
};

// One element's update, in the eager path's order
__device__ __forceinline__ void adamw_element(float g, float& m, float& v, float& p, float scale,
                                              float lr, float b1c, float b2c, const Hyper& h) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float mhat = __fdiv_rn(m, b1c);
  const float vhat = __fdiv_rn(v, b2c);
  const float step = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  const float delta = __fadd_rn(step, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, delta));
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS, APPLY_BLOCKS_PER_SM)
    apply_kernel(const __grid_constant__ AdamWTable t, const float* __restrict__ scale_p,
                 const float* __restrict__ lr_p, const float* __restrict__ b1c_p,
                 const float* __restrict__ b2c_p, const Hyper h) {
  const float scale = *scale_p, lr = *lr_p, b1c = *b1c_p, b2c = *b2c_p;
  int leaf = 0;
  const long long chunks = t.chunk_start[t.n];
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const Span sp = find(t, ch, leaf);
    P* p = static_cast<P*>(t.p[leaf]);
    const G* g = static_cast<const G*>(t.g[leaf]);
    float* m = t.m[leaf];
    float* v = t.v[leaf];
    long long e0 = sp.lo;
    if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
      const long long units = (sp.hi - sp.lo) / UNIT;
      Unit<G> gx[UNROLL];
      Unit<P> px[UNROLL];
      Unit<float> mx[UNROLL], vx[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long u = threadIdx.x + k * THREADS;
        if (u < units) {
          const long long at = sp.lo + u * UNIT;
          gx[k].load(g + at);
          px[k].load(p + at);
          mx[k].load(m + at);
          vx[k].load(v + at);
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long u = threadIdx.x + k * THREADS;
        if (u < units) {
#pragma unroll
          for (int i = 0; i < UNIT; ++i) {
            float mi = mx[k].get(i), vi = vx[k].get(i), pi = px[k].get(i);
            adamw_element(gx[k].get(i), mi, vi, pi, scale, lr, b1c, b2c, h);
            mx[k].set(i, mi);
            vx[k].set(i, vi);
            px[k].set(i, pi);
          }
          const long long at = sp.lo + u * UNIT;
          px[k].store(p + at);
          mx[k].store(m + at);
          vx[k].store(v + at);
        }
      }
      e0 = sp.lo + units * UNIT;
    }
    for (long long e = e0 + threadIdx.x; e < sp.hi; e += THREADS) {
      float mi = m[e], vi = v[e], pi = to_f32(p[e]);
      adamw_element(to_f32(g[e]), mi, vi, pi, scale, lr, b1c, b2c, h);
      m[e] = mi;
      v[e] = vi;
      p[e] = from_f32<P>(pi);
    }
  }
}

bool table_ok(const AdamWTable& t) { return t.n >= 1 && t.n <= ADAMW_MAX_LEAVES; }

template <typename P>
void launch_apply(const AdamWTable& t, const float* scale, const float* lr, const float* b1c,
                  const float* b2c, const Hyper& h, int blocks, int g_dtype, cudaStream_t s) {
  if (g_dtype == COX_F32) {
    apply_kernel<P, float><<<blocks, THREADS, 0, s>>>(t, scale, lr, b1c, b2c, h);
  } else {
    apply_kernel<P, __nv_bfloat16><<<blocks, THREADS, 0, s>>>(t, scale, lr, b1c, b2c, h);
  }
}

bool dtype_ok(int d) { return d == COX_F32 || d == COX_BF16; }

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for an argument it does not take.  Gradients and
// parameters are f32 or bf16, the moments f32.

// partials[0, blocks): each block's sum of squares of the table's
// gradients
extern "C" int cox_adamw_sumsq(AdamWTable table, float* partials, int blocks, int g_dtype,
                               void* stream) {
  if (!table_ok(table) || blocks <= 0 || !dtype_ok(g_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == COX_F32) {
    sumsq_kernel<float><<<blocks, THREADS, 0, s>>>(table, partials);
  } else {
    sumsq_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(table, partials);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0] = sqrt(sum of partials[0, n)), out[1] the clip scale (clip 0:
// no clipping, scale 1)
extern "C" int cox_adamw_finalize(const float* partials, int n, float* out, float clip,
                                  void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  finalize_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(partials, n, out, clip);
  return static_cast<int>(cudaGetLastError());
}

// The update of the table's leaves in place, reading the clip scale, the
// learning rate and the bias corrections from device memory
extern "C" int cox_adamw_apply(AdamWTable table, const float* scale, const float* lr,
                               const float* b1c, const float* b2c, float b1, float c1, float b2,
                               float c2, float eps, float wd, int blocks, int p_dtype,
                               int g_dtype, void* stream) {
  if (!table_ok(table) || blocks <= 0 || !dtype_ok(p_dtype) || !dtype_ok(g_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{b1, c1, b2, c2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == COX_F32) {
    launch_apply<float>(table, scale, lr, b1c, b2c, h, blocks, g_dtype, s);
  } else {
    launch_apply<__nv_bfloat16>(table, scale, lr, b1c, b2c, h, blocks, g_dtype, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0, 5): the elements of a chunk, the blocks an SM holds of
// cox_adamw_sumsq and of cox_adamw_apply, the leaves a table holds, and
// the table's size in bytes
extern "C" int cox_adamw_layout(long long* out) {
  out[0] = CHUNK;
  out[1] = SUMSQ_BLOCKS_PER_SM;
  out[2] = APPLY_BLOCKS_PER_SM;
  out[3] = ADAMW_MAX_LEAVES;
  out[4] = static_cast<long long>(sizeof(AdamWTable));
  return 0;
}
