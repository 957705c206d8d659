// Decode attention: one query token per head against a KV cache, batched.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_decode_kernel
// (pallas_call in flash_decode).  Same semantics: q is scaled by 1/sqrt(D)
// in f32, the running max, sum and accumulator are f32, positions >= kv_len
// are masked with -1e30 and tiles wholly past kv_len are skipped (kv_len > S
// means every position is valid), a head with no valid position keeps
// lsum == 0 -> 1 and returns zeros, and the output is in q's dtype.
//
// Layout: q (B, H, D) and out (B, H, D) contiguous; the caches are read in
// place in their (B, S, Hkv, D) layout through their strides (D
// contiguous, rows 16-byte aligned), where the TPU wrapper transposed them
// to (Hkv, S, D) first.  kv_len is (B,) int32 on the device.  Built for
// D in {64, 128} and f32 or bf16, what the ported configs and the
// reference sweeps use.
//
// Bound: memory.  Each K/V element is read once and serves the g = H/Hkv
// query heads of its kv head with 2 operations each: g operations per
// byte in bf16 (5 for qwen2.5-14b), far below the card's ~295.  Design:
// one block per (kv head, batch row, split of S) serves that kv head's g
// query heads, so each K/V row leaves device memory once.  B x Hkv alone
// is 32 blocks at the serving shape and 64 at the long-context headline,
// too few for 132 SMs, and a block alone is bound by the latency of its
// dependent steps; so the valid positions are split into nsplit ranges
// (the wrapper picks nsplit for about four blocks per SM) and a second
// kernel combines the ranges' partial (max, sum, acc) exactly as the
// online softmax combines tiles.  A block walks its range in tiles of BK
// rows; cp.async copies the next K and V tiles into shared memory while
// the block works on the current ones (two stages).  Rows are padded by
// 16 bytes so the 16-byte reads of the score step are free of bank
// conflicts.  Per tile:
//   1. scores: thread -> (row, heads), a dot product over D from shared memory;
//   2. online softmax: one warp per head, max and sum with __shfl_xor_sync;
//   3. acc = acc * alpha + p @ V: thread -> (head, d), V read down a column.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 32;  // rows per tile; kernels/flash_attention.py TILE_ROWS
constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one block, in bytes: K stages 0 and 1, V stages 0 and
// 1, then f32 q (g, D), scores/probabilities (g, BK), acc (g, D), and the
// running max, sum and rescale factor (g each).
template <typename T, int D> struct Layout {
  static constexpr int ROW = D * static_cast<int>(sizeof(T)) + 16;
  static constexpr int CHUNKS = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int TILE = BK * ROW;
  static size_t bytes(int g) {
    return 4 * static_cast<size_t>(TILE) +
           sizeof(float) * (static_cast<size_t>(g) * (2 * D + BK) + 3 * g);
  }
};

// One block per (kv head, batch row, split).  With nsplit == 1 it writes
// the output; otherwise its range's unnormalised state, to part_ml
// (B, Hkv, nsplit, 2, g: max then sum) and part_acc (B, Hkv, nsplit, g, D).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_len,
                        T* __restrict__ out, float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int H, int Hkv, long long S,
                        long long ksb, long long kss, long long ksh, long long vsb,
                        long long vss, long long vsh, float scale) {
  using L = Layout<T, D>;
  constexpr int N = Vec<T>::N;
  constexpr int HG = THREADS / BK;  // head groups of the score step
  extern __shared__ __align__(16) unsigned char smem[];
  const int hkv = blockIdx.x, b = blockIdx.y, split = blockIdx.z, tid = threadIdx.x;
  const int nsplit = gridDim.z;
  const int g = H / Hkv;
  unsigned char* ktile = smem;
  unsigned char* vtile = smem + 2 * L::TILE;
  float* q_s = reinterpret_cast<float*>(smem + 4 * L::TILE);
  float* p_s = q_s + g * D;
  float* acc_s = p_s + g * BK;
  float* m_s = acc_s + g * D;
  float* l_s = m_s + g;
  float* a_s = l_s + g;

  const long long len = kv_len[b];
  const long long n = len < 0 ? 0 : (len < S ? len : S);  // valid positions
  const int ntiles = static_cast<int>((n + BK - 1) / BK);
  const int per_split = (ntiles + nsplit - 1) / nsplit;
  const int t_begin = split * per_split;
  const int t_end = min(t_begin + per_split, ntiles);
  const T* kb = k + b * ksb + hkv * ksh;
  const T* vb = v + b * vsb + hkv * vsh;

  auto load_tile = [&](int t, int stage) {
    for (int i = tid; i < BK * L::CHUNKS; i += THREADS) {
      const int r = i / L::CHUNKS, c = i % L::CHUNKS;
      const long long pos = static_cast<long long>(t) * BK + r;
      unsigned char* ks = ktile + stage * L::TILE + r * L::ROW + c * 16;
      unsigned char* vs = vtile + stage * L::TILE + r * L::ROW + c * 16;
      if (pos < n) {
        cp_async16(ks, reinterpret_cast<const unsigned char*>(kb + pos * kss) + c * 16);
        cp_async16(vs, reinterpret_cast<const unsigned char*>(vb + pos * vss) + c * 16);
      } else {  // past kv_len (or S): zeros, so the row adds nothing to p @ V
        *reinterpret_cast<uint4*>(ks) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };

  if (t_begin < t_end) load_tile(t_begin, 0);
  const long long qoff = (static_cast<long long>(b) * H + static_cast<long long>(hkv) * g) * D;
  for (int i = tid; i < g * D; i += THREADS) {
    q_s[i] = to_f32(q[qoff + i]) * scale;
    acc_s[i] = 0.0f;
  }
  for (int h = tid; h < g; h += THREADS) {
    m_s[h] = NEG_INF;
    l_s[h] = 0.0f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 1. scores of row r for heads hg, hg + HG, ...; masked past kv_len
    {
      const int r = tid % BK;
      const long long pos = static_cast<long long>(t) * BK + r;
      const uint4* krow =
          reinterpret_cast<const uint4*>(ktile + stage * L::TILE + r * L::ROW);
      for (int h = tid / BK; h < g; h += HG) {
        const float4* qh = reinterpret_cast<const float4*>(q_s + h * D);
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c) {
          Vec<T> kv;
          kv.raw = krow[c];
#pragma unroll
          for (int e = 0; e < N; e += 4) {
            const float4 qv = qh[(c * N + e) / 4];
            s += qv.x * to_f32(kv.get(e)) + qv.y * to_f32(kv.get(e + 1)) +
                 qv.z * to_f32(kv.get(e + 2)) + qv.w * to_f32(kv.get(e + 3));
          }
        }
        p_s[h * BK + r] = pos < n ? s : NEG_INF;
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per head (warp red_max / red_add)
    for (int h = warp; h < g; h += WARPS) {
      float* ph = p_s + h * BK;
      float tmax = NEG_INF;
#pragma unroll
      for (int r = lane; r < BK; r += 32) tmax = fmaxf(tmax, ph[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL_MASK, tmax, off));
      }
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, tmax);
      float sum = 0.0f;
#pragma unroll
      for (int r = lane; r < BK; r += 32) {
        const float p = expf(ph[r] - m_new);
        ph[r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p @ V, thread -> (head, d); two partial
    //    sums halve the dependent chain
    {
      const unsigned char* vt = vtile + stage * L::TILE;
      for (int i = tid; i < g * D; i += THREADS) {
        const int h = i / D, d = i % D;
        const float* ph = p_s + h * BK;
        float a0 = acc_s[i] * a_s[h], a1 = 0.0f;
#pragma unroll
        for (int r = 0; r < BK; r += 2) {
          a0 += ph[r] * to_f32(reinterpret_cast<const T*>(vt + r * L::ROW)[d]);
          a1 += ph[r + 1] * to_f32(reinterpret_cast<const T*>(vt + (r + 1) * L::ROW)[d]);
        }
        acc_s[i] = a0 + a1;
      }
    }
    __syncthreads();
  }

  if (nsplit == 1) {
    for (int i = tid; i < g * D; i += THREADS) {
      const float lsum = l_s[i / D];
      out[qoff + i] = from_f32<T>(acc_s[i] / (lsum == 0.0f ? 1.0f : lsum));
    }
    return;
  }
  const long long slot = (static_cast<long long>(b) * Hkv + hkv) * nsplit + split;
  for (int i = tid; i < g * D; i += THREADS) part_acc[slot * g * D + i] = acc_s[i];
  for (int h = tid; h < g; h += THREADS) {
    part_ml[slot * 2 * g + h] = m_s[h];
    part_ml[slot * 2 * g + g + h] = l_s[h];
  }
}

// Combines the splits, one thread per output element of (B, H, D): the
// largest max M over the splits, each split's sum and acc rescaled by
// exp(m - M), then acc / sum with the lsum == 0 -> 1 guard.  An empty
// split holds (-1e30, 0, 0) and adds nothing; a row with no valid
// position gives zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                   T* __restrict__ out, int H, int Hkv, int D, int nsplit, long long total) {
  const long long o = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (o >= total) return;
  const int g = H / Hkv;
  const long long row = o / D;  // b * H + query head
  const int d = static_cast<int>(o % D);
  const int hq = static_cast<int>(row % H), hkv = hq / g, h = hq % g;
  const long long b = row / H;
  const float* ml = part_ml + (b * Hkv + hkv) * nsplit * 2 * g;
  const float* acc_in = part_acc + ((b * Hkv + hkv) * nsplit * g + h) * D + d;
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, ml[s * 2 * g + h]);
  float lsum = 0.0f, acc = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(ml[s * 2 * g + h] - m);
    lsum += ml[s * 2 * g + g + h] * w;
    acc += acc_in[static_cast<long long>(s) * g * D] * w;
  }
  out[o] = from_f32<T>(acc / (lsum == 0.0f ? 1.0f : lsum));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* out,
           float* part, int nsplit, int B, int H, int Hkv, long long S,
           const long long* ks, const long long* vs, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::bytes(H / Hkv);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_decode_kernel<T, D>;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  // above 48 KB a block's shared memory needs an opt-in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(MAX_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    // the whole carveout as shared memory: room for several blocks per SM
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  dim3 grid(static_cast<unsigned>(Hkv), static_cast<unsigned>(B),
            static_cast<unsigned>(nsplit));
  // part: the splits' (max, sum) then their acc, both f32
  float* part_ml = part;
  float* part_acc = part + static_cast<long long>(B) * Hkv * nsplit * 2 * (H / Hkv);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      static_cast<T*>(out), part_ml, part_acc, H, Hkv, S, ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale);
  if (nsplit > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(B) * H * D;
    const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
    combine_kernel<T><<<blocks, THREADS, 0, stream>>>(
        part_ml, part_acc, static_cast<T*>(out), H, Hkv, D, nsplit, total);
  }
  return 0;
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* kv_len, void* out,
             float* part, int nsplit, int B, int H, int Hkv, long long S, int D,
             const long long* ks, const long long* vs, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, kv_len, out, part, nsplit, B, H, Hkv, S, ks, vs, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, out, part, nsplit, B, H, Hkv, S, ks, vs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an argument the kernel does not take.  part
// is f32 scratch of B * Hkv * nsplit * (H / Hkv) * (D + 2) values when
// nsplit > 1 (unused when nsplit == 1).
extern "C" int cox_flash_decode(const void* q, const void* k, const void* v,
                                const void* kv_len, void* out, void* part, int nsplit,
                                int B, int H, int Hkv, long long S, int D, long long ksb,
                                long long kss, long long ksh, long long vsb,
                                long long vss, long long vsh, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || H <= 0 || H % Hkv != 0 || S <= 0 ||
      nsplit <= 0 || nsplit > 65535 || (nsplit > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* scratch = static_cast<float*>(part);
  const long long ks[3] = {ksb, kss, ksh};
  const long long vs[3] = {vsb, vss, vsh};
  const int* len = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case COX_F32:
      err = launch_d<float>(q, k, v, len, out, scratch, nsplit, B, H, Hkv, S, D, ks, vs, s);
      break;
    case COX_BF16:
      err = launch_d<__nv_bfloat16>(q, k, v, len, out, scratch, nsplit, B, H, Hkv, S, D, ks, vs, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
