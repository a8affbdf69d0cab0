// K7: the core of Restormer's multi-Dconv-head transposed attention (MDTA;
// Zamir et al., CVPR 2022, restormer_arch.py::Attention), in one launch:
// from the depthwise conv's output qkv (N,H,W,3C) to each (image, head)'s
// d x d attention matrix
//
//   A = softmax_rows( (q k^T) / (|q_i| |k_j|) * temperature_head )
//
// where q and k are the head's d channels of the first and second C
// channels over all H*W pixels, |.| a channel's L2 norm over the pixels
// (clamped below at 1e-12, as F.normalize clamps it) and the softmax over j.
// A * v and the 1x1 projection are left to the caller, which folds A into
// the projection's weights (models/restormer.py).
//
// No TPU kernel precedes it: the JAX package serves no attention model.
//
// What bounds it on an H100: the Gram matrix costs 2 d operations per
// pixel and channel against 8 bytes, so at d = 48 (the published heads of
// every level but the last) it is bound by reading q and k, and at d = 96
// (decoder level 1 and the refinement) nearly balanced.  Hence:
//   * grid (splits, N * heads): a block sums the Gram matrix and the 2d
//     sums of squares over one contiguous run of pixels, so that about two
//     blocks run per SM whatever N and the head count are;
//   * a block is groups of threads, each group one thread per 8 x 4 tile
//     of the Gram matrix (at least 2 d threads, rounded up to a warp; d <=
//     96), as many groups as make about 384 threads: four at d = 48, one
//     at d = 96.  A group stages kPix pixels of the head's q and k channels
//     at a time in shared memory of its own (16-byte loads of consecutive
//     channels of a pixel where d and C are multiples of 4), and each
//     thread keeps its tile in registers: three 16-byte shared-memory reads
//     feed 32 FMAs.  The groups take alternate chunks of the block's run,
//     then add their sums into the first group's, in group order.  With
//     one group of 96 threads a block (two blocks an SM), K7 ran at 8.5% of
//     its bound at d = 48: the loads' latency, with six warps an SM;
//   * a block writes its partial sums to a workspace; the last block of an
//     (image, head) to finish (a counter, after a fence) adds the splits'
//     partials in split order, divides by the norms, applies the
//     temperature and takes the softmax of each row.  The order of every
//     sum is fixed, so two runs are bit-equal.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTI = 8;        // a thread's Gram tile: rows (q channels)
constexpr int kTJ = 4;        // and columns (k channels)
constexpr int kMaxD = 96;     // head sizes up to this (Restormer's largest)
constexpr int kPix = 32;      // pixels a group stages at a time
constexpr int kThreads = 384;  // a block's threads, about (groups below)

__host__ __device__ __forceinline__ int round8(int v) { return (v + 7) / 8 * 8; }

// A group's threads: one per Gram tile, at least 2 d (the sums of
// squares), rounded up to a warp.
__host__ __device__ __forceinline__ int group_threads(int d) {
  int t = ((d + kTI - 1) / kTI) * ((d + kTJ - 1) / kTJ);
  if (t < 2 * d) t = 2 * d;
  return (t + 31) / 32 * 32;
}

__host__ __device__ __forceinline__ int groups_of(int d) {
  const int g = kThreads / group_threads(d);
  return g < 1 ? 1 : g;
}

// dynamic shared memory: each group's q and k stages, reused at the end
// for the groups' partial sums (one group's d x d + 2 d at a time)
__host__ __device__ __forceinline__ int smem_floats(int d) {
  const int stages = groups_of(d) * 2 * kPix * round8(d);
  const int sums = d * d + 2 * d;
  return stages > sums ? stages : sums;
}

// part: (N * heads, splits, d * d + 2 d) f32; count: (N * heads) int, zero
// before the launch and zero again after it; attn: (N * heads, d, d).
// vec: q and k rows can be read as float4 (d and C multiples of 4, qkv
// 16-byte aligned).
// Two blocks an SM: at most 85 registers a thread (with a bound of 512
// threads and no count of blocks ptxas took 119, and at d = 96 one block
// of 288 threads ran an SM: 1.62 against 1.16 ms at 1024^2).
__global__ void __launch_bounds__(kThreads, 2) mdta_attention_kernel(
    const float* __restrict__ qkv, const float* __restrict__ temperature,
    float* __restrict__ part, int* __restrict__ count, float* __restrict__ attn,
    long long hw, int c, int heads, int d, long long pix_per_split, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float norms[2 * kMaxD];
  __shared__ int last;
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int gt = group_threads(d), ngroups = groups_of(d);
  const int threads = gt * ngroups;
  const int t = threadIdx.x % gt, g = threadIdx.x / gt;
  const int nh = blockIdx.y;
  const int head = nh % heads;
  const long long n = nh / heads;
  const int splits = gridDim.x;
  const int ds = round8(d);
  const int tj = (d + kTJ - 1) / kTJ;
  const int ti = (d + kTI - 1) / kTI;
  const int i0 = (t / tj) * kTI, j0 = (t % tj) * kTJ;
  const bool tiled = t < ti * tj;
  const long long c3 = 3LL * c;
  const float* q = qkv + n * hw * c3 + (long long)head * d;
  const float* k = q + c;
  const long long p0 = blockIdx.x * pix_per_split;
  const long long p1 = min(hw, p0 + pix_per_split);
  float* sq = smem + g * 2 * kPix * ds;
  float* sk = sq + kPix * ds;

  float acc[kTI][kTJ];
  for (int i = 0; i < kTI; ++i)
    for (int j = 0; j < kTJ; ++j) acc[i][j] = 0.f;
  float ssq = 0.f;  // thread t < 2d: the sum of squares of q (t < d) or k
  // group g takes the chunks g, g + groups, ... of kPix pixels: every
  // group takes the same number of steps, so the block's barriers match
  const long long chunks = p1 > p0 ? (p1 - p0 + kPix - 1) / kPix : 0;
  const long long steps = (chunks + ngroups - 1) / ngroups;
  for (long long step = 0; step < steps; ++step) {
    const long long pb = p0 + (step * ngroups + g) * kPix;
    const int np = pb < p1 ? (int)min((long long)kPix, p1 - pb) : 0;
    __syncthreads();  // the previous step's reads are done
    if (vec) {
      const int ds4 = ds / 4;
      for (int e = t; e < kPix * ds4; e += gt) {
        const int p = e / ds4, ch = 4 * (e % ds4);
        float4 vq = make_float4(0.f, 0.f, 0.f, 0.f), vk = vq;
        if (p < np && ch < d) {
          const long long off = (pb + p) * c3 + ch;
          vq = *reinterpret_cast<const float4*>(q + off);
          vk = *reinterpret_cast<const float4*>(k + off);
        }
        *reinterpret_cast<float4*>(&sq[p * ds + ch]) = vq;
        *reinterpret_cast<float4*>(&sk[p * ds + ch]) = vk;
      }
    } else {
      for (int e = t; e < kPix * ds; e += gt) {
        const int p = e / ds, ch = e % ds;
        float vq = 0.f, vk = 0.f;
        if (p < np && ch < d) {
          const long long off = (pb + p) * c3 + ch;
          vq = q[off];
          vk = k[off];
        }
        sq[p * ds + ch] = vq;
        sk[p * ds + ch] = vk;
      }
    }
    __syncthreads();
    if (tiled) {
      for (int p = 0; p < np; ++p) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sq[p * ds + i0]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sq[p * ds + i0 + 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&sk[p * ds + j0]);
        const float a[kTI] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[kTJ] = {b4.x, b4.y, b4.z, b4.w};
        for (int i = 0; i < kTI; ++i)
          for (int j = 0; j < kTJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (t < 2 * d) {
      const float* s = t < d ? sq + t : sk + (t - d);
      for (int p = 0; p < np; ++p) ssq = fmaf(s[p * ds], s[p * ds], ssq);
    }
  }

  // the groups' sums into group 0's registers, group by group in order
  const int m_tile = d * d;
  for (int from = 1; from < ngroups; ++from) {
    __syncthreads();
    if (g == from) {
      if (tiled)
        for (int i = 0; i < kTI; ++i)
          for (int j = 0; j < kTJ; ++j)
            if (i0 + i < d && j0 + j < d)
              smem[(i0 + i) * d + j0 + j] = acc[i][j];
      if (t < 2 * d) smem[m_tile + t] = ssq;
    }
    __syncthreads();
    if (g == 0) {
      if (tiled)
        for (int i = 0; i < kTI; ++i)
          for (int j = 0; j < kTJ; ++j)
            if (i0 + i < d && j0 + j < d)
              acc[i][j] += smem[(i0 + i) * d + j0 + j];
      if (t < 2 * d) ssq += smem[m_tile + t];
    }
  }

  const long long m = (long long)d * d + 2 * d;
  float* mine = part + ((long long)nh * splits + blockIdx.x) * m;
  if (g == 0) {
    if (tiled)
      for (int i = 0; i < kTI; ++i)
        for (int j = 0; j < kTJ; ++j)
          if (i0 + i < d && j0 + j < d) mine[(i0 + i) * d + j0 + j] = acc[i][j];
    if (t < 2 * d) mine[m_tile + t] = ssq;
  }

  // the last block of this (image, head) to finish sums the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&count[nh], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = part + (long long)nh * splits * m;
  float* a = attn + (long long)nh * d * d;
  for (long long e = threadIdx.x; e < m; e += threads) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += all[sp * m + e];
    if (e < m_tile)
      a[e] = s;
    else
      norms[e - m_tile] = fmaxf(sqrtf(s), 1e-12f);
  }
  __syncthreads();
  const float temp = temperature[head];
  for (int i = threadIdx.x; i < d; i += threads) {
    float* row = a + (long long)i * d;
    const float nq = norms[i];
    float mx = -INFINITY;
    for (int j = 0; j < d; ++j) {
      const float v = row[j] / (nq * norms[d + j]) * temp;
      row[j] = v;
      mx = fmaxf(mx, v);
    }
    float sum = 0.f;
    for (int j = 0; j < d; ++j) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < d; ++j) row[j] = row[j] / sum;
  }
  if (threadIdx.x == 0) count[nh] = 0;
}

}  // namespace

// The workspace's size in floats for (n, heads, d, splits); the wrapper
// allocates it and a zeroed (n * heads) int counter.
extern "C" long long cid_mdta_workspace(int n, int heads, int d, int splits) {
  return (long long)n * heads * splits * ((long long)d * d + 2LL * d);
}

// How many splits of the pixels a launch uses: about two blocks an SM,
// each with at least kPix pixels.
extern "C" int cid_mdta_splits(int n, int heads, long long hw) {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  const long long per = (long long)n * heads;
  long long splits = (2LL * sms + per - 1) / per;
  const long long most = (hw + kPix - 1) / kPix;
  if (splits > most) splits = most;
  return (int)(splits < 1 ? 1 : splits);
}

// qkv (N, hw, 3C) f32 contiguous, temperature (heads,) f32 -> attn (N,
// heads, d, d) f32 with d = C / heads <= 96; part and count as above.
extern "C" int cid_mdta_attention(const void* qkv, const void* temperature,
                                  void* part, void* count, void* attn, int n,
                                  long long hw, int c, int heads, int splits,
                                  void* stream) {
  if (n < 1 || hw < 1 || heads < 1 || c % heads != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int d = c / heads;
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const long long blocks_y = (long long)n * heads;
  if (blocks_y > 65535) return (int)cudaErrorInvalidConfiguration;
  const int threads = group_threads(d) * groups_of(d);
  const int smem = smem_floats(d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mdta_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && c % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  const long long per = (hw + splits - 1) / splits;
  const dim3 grid((unsigned)splits, (unsigned)blocks_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mdta_attention_kernel<<<grid, threads, smem, s>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(temperature),
      static_cast<float*>(part), static_cast<int*>(count),
      static_cast<float*>(attn), hw, c, heads, d, per, vec);
  return (int)cudaGetLastError();
}
