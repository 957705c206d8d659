// Decode attention: one query token per head against a KV cache, batched.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_decode_kernel
// (pallas_call in flash_decode).  Same semantics: q is scaled by 1/sqrt(D)
// in f32, the running max, sum and accumulator are f32, positions >= kv_len
// are masked with -1e30 and tiles wholly past kv_len are skipped (kv_len > S
// means every position is valid), a head with no valid position keeps
// lsum == 0 -> 1 and returns zeros, and the output is in q's dtype.
// On request (a non-null lse) it also writes each head's log-sum-exp of
// its scaled scores, f32 (B, H): m + log(sum), -inf for a head with no
// valid position; the mesh decode combines sequence slabs by it.
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
// byte in bf16 (5 for qwen2.5-14b), far below the card's ~295.  So the
// design keeps device memory busy and spends few instructions per byte:
//
// - One block per (kv head, group of G query heads, batch row, split of
//   S): G is the largest divisor of g up to 8 (the wrapper's
//   head_group), so q and the accumulators of G heads fit in registers;
//   a larger g (MQA: 48) takes g / G blocks that read the same K/V rows at
//   the same time, the later ones from L2.  The valid positions are split
//   into nsplit ranges and a second kernel combines the ranges' partial
//   (max, sum, acc) exactly as the online softmax combines tiles, in split
//   order.  The wrapper's num_splits fills about one wave of two blocks
//   an SM (8 warps an SM read as fast as 12).  At B 8 x 8 kv heads that
//   leaves 8 of 132 SMs one block; two grids that share the tiles evenly
//   among the SMs (a block's range crossing units, or a warp per kv head
//   over the same positions) were slower on the H100, for a cause not
//   measured.
// - A lane owns one 16-byte column chunk of a row (C = D * sizeof(T) / 16
//   lanes a row, 32 / C rows a warp load) and applies all G heads to it
//   from registers: q * scale for its chunk in f32, and its chunk of the G
//   accumulators.  A row's partial dot products are summed over its C
//   lanes with __shfl_xor_sync.  So every K and V element is read from
//   shared memory once, in a 16-byte load, by the lane that copied it.
// - Each warp walks its own tiles (STEPS warp loads of K, then of V) with
//   its own running max, sum and accumulator, and its own cp.async ring of
//   STAGES tiles: a lane copies exactly the chunks it later reads, so the
//   loop has no barrier at all (cp.async.wait_group makes a thread's own
//   copies visible to it).  Rows past kv_len are not read (zero-filled).
//   Per tile: the scores of STEPS loads, one max over the tile, one
//   rescale of the accumulators, then p @ V.  The scores are kept in log2
//   units, so each exponential is one ex2.
// - At the end of the range the warps' states are combined once, in warp
//   order, through shared memory: the only barrier of the kernel.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STEPS = 4;      // warp loads of K (and of V) a tile
constexpr int STAGES = 3;     // tiles a warp's cp.async ring holds
constexpr int MAX_GROUP = 8;  // query heads a block (kernels/flash_attention.py MAX_GROUP)
constexpr int LOAD_BYTES = 32 * 16;                 // one warp load: 16 bytes a lane
constexpr int TILE_BYTES = 2 * STEPS * LOAD_BYTES;  // K then V: 4 KB
constexpr int SMEM = WARPS * STAGES * TILE_BYTES;   // 48 KB: no opt-in
constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the natural log-sum-exp of a head from its max m (log2 units) and its
// sum: -inf when no position was valid
__device__ __forceinline__ float log_sum(float m, float lsum) {
  return lsum == 0.0f ? -INFINITY : m * 0.6931471805599453f + logf(lsum);
}

// 2^x: the scores are kept in log2 units (q is scaled by 1/sqrt(D), then
// by log2 e), so each exponential is one MUFU.EX2
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D> struct Geo {
  static constexpr int N = Vec<T>::N;  // elements of a 16-byte chunk
  static constexpr int C = D / N;      // lanes a row
  static constexpr int RW = 32 / C;    // rows a warp load
  static constexpr int RT = RW * STEPS;  // rows a tile
};

// One block per (kv head x group, batch row, split).  With nsplit == 1 it
// writes the output; otherwise its range's unnormalised state, to part_ml
// (B, Hkv, nsplit, 2, g: max, in log2 units, then sum) and part_acc (B,
// Hkv, nsplit, g, D).  An SM holds 2 blocks (kernels/flash_attention.py
// BLOCKS_PER_SM): 8 warps keep HBM as busy as 12 did.
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS, 2)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_len,
                        T* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part_ml, float* __restrict__ part_acc, int H,
                        int Hkv, long long S,
                        long long ksb, long long kss, long long ksh, long long vsb,
                        long long vss, long long vsh, float scale) {
  using Ge = Geo<T, D>;
  constexpr int N = Ge::N, C = Ge::C, RW = Ge::RW, RT = Ge::RT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = H / Hkv, ngroups = g / G;
  const int hkv = blockIdx.x / ngroups, grp = blockIdx.x % ngroups;
  const int b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / C, chunk = lane % C;  // row of a warp load, column chunk

  const long long len = kv_len[b];
  const long long n = len < 0 ? 0 : (len < S ? len : S);  // valid positions
  const long long ntiles = (n + RT - 1) / RT;
  const long long per_split = (ntiles + nsplit - 1) / nsplit;
  const long long t_begin = split * per_split;
  const long long t_end = min(t_begin + per_split, ntiles);
  // this warp's tiles: t_begin + warp, + WARPS, ... below t_end
  const long long first = t_begin + warp;
  const int count = first < t_end ? static_cast<int>((t_end - first + WARPS - 1) / WARPS) : 0;

  const T* kb = k + b * ksb + hkv * ksh + chunk * N;
  const T* vb = v + b * vsb + hkv * vsh + chunk * N;
  unsigned char* ring = smem + warp * STAGES * TILE_BYTES + lane * 16;

  // tile j of this warp into stage j % STAGES: STEPS loads of K, then of V;
  // rows past kv_len (or S) are zero-filled without a read.  An empty
  // group past the last tile keeps the wait count below uniform.
  auto issue = [&](int j) {
    if (j < count) {
      const long long row0 = (first + static_cast<long long>(j) * WARPS) * RT + sub;
      unsigned char* st = ring + (j % STAGES) * TILE_BYTES;
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const long long row = row0 + i * RW;
        const bool ok = row < n;
        cp_async16(st + i * LOAD_BYTES, ok ? kb + row * kss : kb, ok ? 16 : 0);
        cp_async16(st + (STEPS + i) * LOAD_BYTES, ok ? vb + row * vss : vb, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  // q * scale for this lane's chunk, G heads, in f32, then in log2 units
  const long long h0 = static_cast<long long>(hkv) * g + static_cast<long long>(grp) * G;
  const T* qb = q + (static_cast<long long>(b) * H + h0) * D + chunk * N;
  float qf[G][N];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < N; ++e) qf[h][e] = to_f32(qb[h * D + e]) * scale * LOG2E;
  }
  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[h][e] = 0.0f;
  }

  for (int j = 0; j < count; ++j) {
    issue(j + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // tile j has landed
    const unsigned char* st = ring + (j % STAGES) * TILE_BYTES;
    const long long row0 = (first + static_cast<long long>(j) * WARPS) * RT + sub;

    // scores: each lane's chunk against the G heads, summed over the row's lanes
    float s[STEPS][G];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      Vec<T> kv;
      kv.raw = *reinterpret_cast<const uint4*>(st + i * LOAD_BYTES);
      float kf[N];
#pragma unroll
      for (int e = 0; e < N; ++e) kf[e] = to_f32(kv.get(e));
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < N; ++e) d = fmaf(qf[h][e], kf[e], d);
#pragma unroll
        for (int off = C / 2; off > 0; off >>= 1) d += __shfl_xor_sync(FULL_MASK, d, off);
        s[i][h] = d;
      }
    }
    if ((first + static_cast<long long>(j) * WARPS + 1) * RT > n) {  // the last tile: mask
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
#pragma unroll
        for (int h = 0; h < G; ++h) s[i][h] = row0 + i * RW < n ? s[i][h] : NEG_INF;
      }
    }

    // online softmax over the tile: one max (over the warp's rows), one
    // rescale; each lane sums the p of its own rows
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mt = s[0][h];
#pragma unroll
      for (int i = 1; i < STEPS; ++i) mt = fmaxf(mt, s[i][h]);
#pragma unroll
      for (int off = C; off < 32; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, off));
      const float m_new = fmaxf(m[h], mt);
      const float alpha = exp2_(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        s[i][h] = exp2_(s[i][h] - m_new);
        l[h] += s[i][h];
      }
    }

    // acc += p @ V
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      Vec<T> vv;
      vv.raw = *reinterpret_cast<const uint4*>(st + (STEPS + i) * LOAD_BYTES);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float ve = to_f32(vv.get(e));
#pragma unroll
        for (int h = 0; h < G; ++h) acc[h][e] = fmaf(s[i][h], ve, acc[h][e]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; the ring is free

  // the warp's rows share m: sum l and acc over its row groups, then park
  // the warp's state in its own ring: m, l (G each), acc (G, D)
#pragma unroll
  for (int off = C; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      l[h] += __shfl_xor_sync(FULL_MASK, l[h], off);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[h][e] += __shfl_xor_sync(FULL_MASK, acc[h][e], off);
    }
  }
  __syncwarp();  // every lane of the warp is done reading the ring
  auto state = [&](int w) {
    return reinterpret_cast<float*>(smem + w * STAGES * TILE_BYTES);
  };
  if (sub == 0) {
    float* ws = state(warp);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (chunk == 0) {
        ws[h] = m[h];
        ws[G + h] = l[h];
      }
#pragma unroll
      for (int e = 0; e < N; ++e) ws[2 * G + h * D + chunk * N + e] = acc[h][e];
    }
  }
  __syncthreads();

  // the block's state, the warps combined in order, as the splits are
  const long long slot = (static_cast<long long>(b) * Hkv + hkv) * nsplit + split;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float mb = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, state(w)[h]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* ws = state(w);
      const float c = exp2_(ws[h] - mb);
      lsum += ws[G + h] * c;
      a += ws[2 * G + h * D + d] * c;
    }
    const int hg = grp * G + h;  // head within the kv head's g
    if (nsplit == 1) {
      out[(static_cast<long long>(b) * H + h0 + h) * D + d] =
          from_f32<T>(a / (lsum == 0.0f ? 1.0f : lsum));
      if (lse != nullptr && d == 0) lse[static_cast<long long>(b) * H + h0 + h] = log_sum(mb, lsum);
    } else {
      part_acc[(slot * g + hg) * D + d] = a;
      if (d == 0) {
        part_ml[slot * 2 * g + hg] = mb;
        part_ml[slot * 2 * g + g + hg] = lsum;
      }
    }
  }
}

// Combines the splits, one thread per output element of (B, H, D): the
// largest max M over the splits, each split's sum and acc rescaled by
// 2^(m - M) (log2 units), then acc / sum with the lsum == 0 -> 1 guard.  An empty
// split holds (-1e30, 0, 0) and adds nothing; a row with no valid
// position gives zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                   T* __restrict__ out, float* __restrict__ lse, int H, int Hkv, int D,
                   int nsplit, long long total) {
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
    const float w = exp2_(ml[s * 2 * g + h] - m);
    lsum += ml[s * 2 * g + g + h] * w;
    acc += acc_in[static_cast<long long>(s) * g * D] * w;
  }
  out[o] = from_f32<T>(acc / (lsum == 0.0f ? 1.0f : lsum));
  if (lse != nullptr && d == 0) lse[row] = log_sum(m, lsum);
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* out,
           float* lse, float* part, int nsplit, int B, int H, int Hkv, long long S,
           const long long* ks, const long long* vs, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int g = H / Hkv;
  dim3 grid(static_cast<unsigned>(Hkv * (g / G)), static_cast<unsigned>(B),
            static_cast<unsigned>(nsplit));
  // part: the splits' (max, sum) then their acc, both f32
  float* part_ml = part;
  float* part_acc = part + static_cast<long long>(B) * Hkv * nsplit * 2 * g;
  flash_decode_kernel<T, D, G><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      static_cast<T*>(out), lse, part_ml, part_acc, H, Hkv, S, ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], scale);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(B) * H * D;
    const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
    combine_kernel<T><<<blocks, THREADS, 0, stream>>>(
        part_ml, part_acc, static_cast<T*>(out), lse, H, Hkv, D, nsplit, total);
  }
  return 0;
}

template <typename T, int D>
int launch_g(int group, const void* q, const void* k, const void* v, const int* kv_len,
             void* out, float* lse, float* part, int nsplit, int B, int H, int Hkv, long long S,
             const long long* ks, const long long* vs, cudaStream_t stream) {
#define COX_DECODE_GROUP(G) \
  case G: return launch<T, D, G>(q, k, v, kv_len, out, lse, part, nsplit, B, H, Hkv, S, ks, vs, stream);
  switch (group) {
    COX_DECODE_GROUP(1)
    COX_DECODE_GROUP(2)
    COX_DECODE_GROUP(3)
    COX_DECODE_GROUP(4)
    COX_DECODE_GROUP(5)
    COX_DECODE_GROUP(6)
    COX_DECODE_GROUP(7)
    COX_DECODE_GROUP(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef COX_DECODE_GROUP
}

template <typename T>
int launch_d(int D, int group, const void* q, const void* k, const void* v,
             const int* kv_len, void* out, float* lse, float* part, int nsplit, int B, int H,
             int Hkv, long long S, const long long* ks, const long long* vs,
             cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_g<T, 64>(group, q, k, v, kv_len, out, lse, part, nsplit, B, H, Hkv, S, ks, vs,
                             stream);
    case 128:
      return launch_g<T, 128>(group, q, k, v, kv_len, out, lse, part, nsplit, B, H, Hkv, S, ks, vs,
                              stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an argument the kernel does not take.  group
// is the query heads a block serves (it divides H / Hkv, at most 8).
// part is f32 scratch of B * Hkv * nsplit * (H / Hkv) * (D + 2) values
// when nsplit > 1 (unused when nsplit == 1).  lse is null, or f32 (B, H)
// for each head's log-sum-exp.
extern "C" int cox_flash_decode(const void* q, const void* k, const void* v,
                                const void* kv_len, void* out, void* lse, void* part,
                                int nsplit,
                                int group, int B, int H, int Hkv, long long S, int D,
                                long long ksb, long long kss, long long ksh, long long vsb,
                                long long vss, long long vsh, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || H <= 0 || H % Hkv != 0 || S <= 0 ||
      nsplit <= 0 || nsplit > 65535 || (nsplit > 1 && part == nullptr) || group <= 0 ||
      group > MAX_GROUP || (H / Hkv) % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* scratch = static_cast<float*>(part);
  float* lse_out = static_cast<float*>(lse);
  const long long ks[3] = {ksb, kss, ksh};
  const long long vs[3] = {vsb, vss, vsh};
  const int* len = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case COX_F32:
      err = launch_d<float>(D, group, q, k, v, len, out, lse_out, scratch, nsplit, B, H, Hkv, S, ks, vs, s);
      break;
    case COX_BF16:
      err = launch_d<__nv_bfloat16>(D, group, q, k, v, len, out, lse_out, scratch, nsplit, B, H,
                                    Hkv, S, ks, vs, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
