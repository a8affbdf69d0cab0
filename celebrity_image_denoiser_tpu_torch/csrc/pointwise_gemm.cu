// K9: a 1x1 convolution over NHWC float32 pixel rows as a GEMM on the
// tensor cores, with BiasFree LayerNorm folded in as a row scale and the
// block's residual add in its epilogue: Restormer's 1x1 convs (qkv,
// MDTA's projection of A v, GDFN's project_in and project_out, the
// decoder's channel reductions).
//
// Replaces no kernel of the JAX package, which has no Restormer; it
// replaces cuBLAS's float32 GEMMs (the CUDA cores: float32 serving turns
// TF32 off) and PyTorch's LayerNorm passes (a Welford reduction and two
// broadcast passes a LayerNorm, the normalised tensor written and read
// back) on the served model's path.
//
//   y[i, :] = r_i * (a[i, :] . w^T) + res[i, :]
//
// a: M pixel rows of K channels, row i at a + i * lda (the v slice of
// MDTA's qkv has lda = 3C); w: N x K, shared by the batch or one per image
// (MDTA's W_eff = W_proj blockdiag(A_h)); res: M x N or none; y: M x N.
// r_i = 1 / sqrt(var(a[i, :]) + 1e-5) where the call folds a LayerNorm,
// else 1.  BiasFree LayerNorm is x / sqrt(var(x) + eps) * g with no mean
// taken out, so LN(x) W^T = r (x (W diag(g))^T): the caller folds g into
// w, and what is left is one scale a row.
//
// What bounds it on an H100: per launch max(2 M K N at 495 / 3 TFLOP/s,
// the bytes of a, y, res and w at 3.35 TB/s).  At Restormer's
// full-resolution levels (C 48 and 96, 1M pixels at a 1024^2 input) K N
// is small and the launch is bound by its bytes; at the latent and level
// 3 (C 384 and 192) by its operations.
//
// Design (each choice timed against its alternatives on an H100; the
// numbers are in PERF.md's findings):
//   * float32 as three TF32 products on wgmma m64n128k8 (as K2's and K3's
//     f32 bodies, conv_mma.cuh's last section): a_lo b_hi + a_hi b_lo +
//     a_hi b_hi, hi = tf32(v), lo = tf32(v - hi); one TF32 product misses
//     the float32 tolerance.  A is split in registers as ldmatrix delivers
//     it; B comes split and K-major from the wrapper
//     (ops/cuda/pointwise_gemm.py::gemm_weights), made once per loaded
//     weights (per call for W_eff).  N = 128 a wgmma: half the splits and
//     instructions a FLOP of N = 64 with two 64-row tiles a warpgroup.
//   * a tile is 128 rows x 128 output channels (a pass): two consumer
//     warpgroups of one 64-row wgmma tile each; a work item is one
//     32-channel chunk of K of one pass: the rows' 32 channels (16 KB) and
//     the chunk's hi and lo B tiles (32 KB), through a ring of four stages
//     filled by two producer warpgroups (the register split of conv_mma.cuh's
//     kernels).  The ring runs on mbarriers: each producer thread arrives
//     on a stage's "full" barrier once its copies have landed
//     (cp.async.mbarrier.arrive), each consumer warp on its "empty" one
//     once its products are done, so copies, products and stores overlap
//     where a block-wide barrier an item serialised them.
//   * persistent blocks (one per SM) walk units of a tile and ppu passes:
//     with two tiles an SM or more a block takes all of a tile's passes
//     (the LayerNorm's variance is taken once, a's rows stay in L2), with
//     fewer one pass (the latent: 128 tiles), so that the passes fill the
//     card.  Tiles never straddle two images, so a per-image B is one
//     pointer a unit.
//   * rows whose stride or start is not a multiple of 16 bytes (GDFN's
//     hidden widths 127, 255, 510, 1021 as project_out's K) are copied
//     4 bytes at a time (cp.async, through L1), the rest 16.
//   * each chunk's 12 products go into a fresh accumulator, added to the
//     running total rounded to nearest: the tensor cores' accumulation
//     truncates (conv_mma.cuh's mma_taps_tf32).  No split-K, no atomics:
//     each output's summation order is fixed and two runs are bit-equal.
//   * the LayerNorm's variance comes from the A fragments that feed the
//     products: a quad of lanes holds a row's channels q and q + 4 of every
//     k8 step, so each lane sums its values shifted by its first one (and
//     their squares) over a chunk, merges the chunk's mean and M2 into its
//     running ones, and the quad merges its four by Chan's formula --
//     centred throughout, never E[x^2] - E[x]^2, which cancels when a
//     pixel's channel mean is large against its spread.  The merge takes
//     the lower lane first on every lane, so the four lanes of a row
//     compute the same r.  No normalised tensor is written.
//   * the epilogue multiplies by r where a LayerNorm was folded, adds the
//     residual, its loads all in flight before the first store, and stores
//     float32 channel pairs.
#include <cstdint>

#include "conv_mma.cuh"

namespace {

using namespace cid;

constexpr int kKC = 32;                 // f32 channels of K per work item
constexpr int kSteps = kKC / 8;         // k8 steps per item
constexpr int kNB = 128;                // output channels per pass (wgmma N)
constexpr int kConsumerWGs = 2;         // a 64-row wgmma tile each
constexpr int kRows = 64 * kConsumerWGs;  // pixel rows per tile
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kProducers = 256;
constexpr int kThreads = kConsumers + kProducers;
// setmaxnreg: kConsumers x 216 + kProducers x 40 = 65,536
constexpr int kConsumerRegs = 216, kProducerRegs = 40;
constexpr int kRowBytes = kKC * 4;      // one row's chunk in shared memory
constexpr int kABytes = kRows * kRowBytes;
constexpr int kTileBytes = kNB * 32;     // one k8 step's hi (or lo) B tile
constexpr int kBBytes = kSteps * 2 * kTileBytes;
constexpr int kStages = 4;
// the stages, then each stage's two barriers (full, empty)
constexpr int kSmem = kStages * (kABytes + kBBytes) + 2 * kStages * 8;
constexpr float kEps = 1e-5f;  // models/restormer.py::LN_EPS

struct Gemm {
  const float* a;
  long long lda;      // floats between rows of a
  const float* w;     // split weights (gemm_weights), image 0's
  long long w_img;    // floats between images' split weights (0: shared)
  const float* res;   // M x N, or null
  float* y;           // M x N
  long long hw;       // rows per image
  int K, N;
  int tiles_img;      // tiles per image
  int npass, nchunks;
  int ppu;            // passes per unit: 1, or all of a tile's (npass)
  int vec;            // a's rows 16-byte aligned, K % 4 == 0
  int ln;             // fold a LayerNorm: scale row i by r_i
  int pair_ok;        // y and res 8-byte aligned, N even
};

__device__ __forceinline__ float bits_f32(uint32_t u) {
#ifdef CID_EMULATE_MMA
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#else
  return __uint_as_float(u);
#endif
}

// 1 / x rounded to nearest (no division's slow path)
__device__ __forceinline__ float rcp(float x) {
#ifdef CID_EMULATE_MMA
  volatile float r = 1.f / x;
  return r;
#else
  return __frcp_rn(x);
#endif
}

// Where a unit (a tile and ppu consecutive passes) lies: rows [r0, rend)
// of image img, its first pass pass0.
struct Unit {
  long long r0, rend;
  int img, pass0;
  __device__ __forceinline__ Unit(const Gemm& g, int unit) {
    const int per_tile = g.npass / g.ppu;
    const int tile = unit / per_tile;
    pass0 = (unit % per_tile) * g.ppu;
    img = tile / g.tiles_img;
    r0 = img * g.hw + (long long)(tile % g.tiles_img) * kRows;
    rend = (img + 1) * g.hw;
  }
};

// The block's walk over its items: chunk innermost, then the unit's
// passes, then its units.
struct Cursor {
  int unit, pass, chunk;  // pass: within the unit
  __device__ __forceinline__ void start() {
    unit = blockIdx.x;
    pass = chunk = 0;
  }
  __device__ __forceinline__ void advance(const Gemm& g) {
    if (++chunk < g.nchunks) return;
    chunk = 0;
    if (++pass < g.ppu) return;
    pass = 0;
    unit += gridDim.x;
  }
};

// Stage channels [c0, c0 + 32) of the unit's kRows rows: row r is 128 bytes,
// its 16-byte piece j at j ^ (r & 7), so the eight rows of one ldmatrix
// matrix fall on distinct banks; zeros beyond K and beyond the image.
__device__ __forceinline__ void load_rows(unsigned char* dst, const Gemm& g,
                                          const Unit& u, int c0, int ptid) {
  // a thread keeps its channel piece and walks rows STEP apart, so its
  // source and destination advance by constants (row & 7 stays fixed)
  const uint32_t d0 = mma::smem_u32(dst);
  if (g.vec) {
    constexpr int STEP = kProducers / 8;  // rows a pass of the threads
    static_assert(STEP % 8 == 0, "a thread's rows keep their row & 7");
    const int j = ptid % 8, r0 = ptid / 8, c = c0 + 4 * j;
    const bool cok = c < g.K;
    const float* src = g.a + (u.r0 + r0) * g.lda + c;
    uint32_t d = d0 + r0 * kRowBytes + ((j ^ (r0 & 7)) << 4);
    long long left = u.rend - u.r0 - r0;  // rows of the image from here
#pragma unroll 4
    for (int r = r0; r < kRows; r += STEP) {
      const bool ok = cok && left > 0;
      mma::cp_async16(d, ok ? src : g.a, ok);
      src += STEP * g.lda;
      d += STEP * kRowBytes;
      left -= STEP;
    }
  } else {
    constexpr int STEP = kProducers / kKC;
    static_assert(STEP % 8 == 0, "a thread's rows keep their row & 7");
    const int ch = ptid % kKC, r0 = ptid / kKC, c = c0 + ch;
    const bool cok = c < g.K;
    const float* src = g.a + (u.r0 + r0) * g.lda + c;
    uint32_t d =
        d0 + r0 * kRowBytes + (((ch >> 2) ^ (r0 & 7)) << 4) + (ch & 3) * 4;
    long long left = u.rend - u.r0 - r0;
#pragma unroll 4
    for (int r = r0; r < kRows; r += STEP) {
      const bool ok = cok && left > 0;
      mma::cp_async4(d, ok ? src : g.a, ok);
      src += STEP * g.lda;
      d += STEP * kRowBytes;
      left -= STEP;
    }
  }
}

// One lane's running sums for the two rows it holds (rows g and g + 8 of
// its warp's 16, index h).  Within a 32-channel chunk it sums v = x -
// shift and v^2, shift being the row's first value this lane saw, so v is
// centred to within the row's spread; at the chunk's end the chunk's mean
// and M2 (sum of squared deviations from its mean) merge into the running
// ones by Chan's formula.  The counts are the same for both rows.
struct RowStats {
  float shift[2], mean[2], m2[2], s1[2], s2[2];
  float n, nc;  // values merged; values of the chunk so far
  __device__ __forceinline__ void reset() {
    n = nc = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      shift[h] = mean[h] = m2[h] = s1[h] = s2[h] = 0.f;
  }
  // one channel of the lane's rows, x[h]; first: the unit's first
  __device__ __forceinline__ void add(const float (&x)[2], bool first) {
    nc += 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (first) shift[h] = x[h];
      const float v = x[h] - shift[h];
      s1[h] += v;
      s2[h] += v * v;
    }
  }
  __device__ __forceinline__ void end_chunk() {
    if (nc == 0.f) return;
    const float inv = rcp(nc), nn = n + nc;
    const float wb = nc * rcp(nn), wab = n * wb;  // nc / n', n nc / n'
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mc = s1[h] * inv;
      const float qc = fmaxf(s2[h] - s1[h] * mc, 0.f);
      const float d = mc - mean[h];
      mean[h] += d * wb;
      m2[h] += qc + d * d * wab;
      s1[h] = s2[h] = 0.f;
    }
    n = nn;
    nc = 0.f;
  }
  // Chan's merge over the quad (lanes 4g .. 4g + 3 hold the same rows),
  // the lower lane's sums first on every lane; then r = 1 / sqrt(M2 / n +
  // eps) for each row.
  __device__ __forceinline__ void row_scales(float (&r)[2]) {
    const int q = threadIdx.x % 4;
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      const bool lower = (q & m) == 0;
      const float n_o = mma::shfl_xor(n, m);
      const float na = lower ? n : n_o, nb = lower ? n_o : n;
      const float nn = na + nb;
      const float wb = nb * rcp(nn), wab = na * wb;  // nb / n, na nb / n
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s_o = mma::shfl_xor(shift[h], m);
        const float m_o = mma::shfl_xor(mean[h], m);
        const float q_o = mma::shfl_xor(m2[h], m);
        const float sa = lower ? shift[h] : s_o, sb = lower ? s_o : shift[h];
        const float ma = lower ? mean[h] : m_o, mb = lower ? m_o : mean[h];
        const float qa = lower ? m2[h] : q_o, qb = lower ? q_o : m2[h];
        if (nb == 0.f) {
          shift[h] = sa, mean[h] = ma, m2[h] = qa;
        } else if (na == 0.f) {
          shift[h] = sb, mean[h] = mb, m2[h] = qb;
        } else {
          const float d = (sb - sa) + (mb - ma);
          shift[h] = sa;
          mean[h] = ma + d * wb;
          m2[h] = qa + qb + d * d * wab;
        }
      }
      n = nn;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) r[h] = 1.f / sqrtf(m2[h] / n + kEps);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
pointwise_gemm_kernel(Gemm g, int total_units) {
  extern __shared__ __align__(1024) unsigned char smem_pw[];
  unsigned char* ast = smem_pw;                      // [S][kABytes]
  unsigned char* wst = smem_pw + kStages * kABytes;  // [S][kBBytes]
  // stage s is full once every producer thread's copies into it have
  // landed, and empty once every consumer warp has finished reading it
  const uint32_t bars = mma::smem_u32(wst + kStages * kBBytes);
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int tid = threadIdx.x;
  if (tid == 0)
    for (int s = 0; s < kStages; ++s) {
      mma::mbar_init(full(s), kProducers);
      mma::mbar_init(empty(s), kConsumers / 32);
    }
  __syncthreads();
  const int my_units =
      (total_units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nitems = my_units * g.ppu * g.nchunks;
  const int nk8 = g.nchunks * kSteps;  // k8 steps of the split weights

  if (tid >= kConsumers) {
    mma::setmaxnreg_dec<kProducerRegs>();
    const int ptid = tid - kConsumers;
    Cursor ahead;
    ahead.start();
    for (int item = 0; item < nitems; ++item) {
      const int stage = item % kStages;
      if (item >= kStages)
        mma::mbar_wait(empty(stage), (item / kStages - 1) & 1);
      const Unit u(g, ahead.unit);
      load_rows(ast + stage * kABytes, g, u, ahead.chunk * kKC, ptid);
      // a k8 step's hi and lo tiles are 2 * kTileBytes, two 4096-byte
      // blocks of the copier's
      conv::load_weights_tf32<kBBytes / 4096, kProducers>(
          wst + stage * kBBytes,
          g.w + u.img * g.w_img +
              ((size_t)(u.pass0 + ahead.pass) * nk8 + ahead.chunk * kSteps) *
                  (2 * kTileBytes / 4),
          ptid);
      mma::cp_async_mbar_arrive(full(stage));
      ahead.advance(g);
    }
    mma::cp_async_wait<0>();
    return;
  }
  mma::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int q = lane % 4, khalf = conv::ldm_khalf();
  // the tile row this lane points ldmatrix at
  const int prow = wg * 64 + warp * 16 + conv::ldm_row();

  Cursor cur;
  cur.start();
  float acc[64], part[64];
  RowStats st;
  float r[2];  // the unit's row scales, from its first pass
  for (int item = 0; item < nitems; ++item) {
    const int stage = item % kStages;
    mma::mbar_wait(full(stage), (item / kStages) & 1);
    mma::fence_proxy_async();
    const uint32_t abase = mma::smem_u32(ast + stage * kABytes);
    const uint32_t bbase = mma::smem_u32(wst + stage * kBBytes);
    const int c0 = cur.chunk * kKC;
    // the variance is taken in a unit's first pass; the others reuse r
    const bool stats = g.ln && cur.pass == 0;
    if (stats && cur.chunk == 0) st.reset();
    uint32_t a[2][2][4];  // [buffer][hi, lo][register]
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int par = s & 1;
      uint32_t raw[4];
      mma::ldmatrix_x4(raw, abase + prow * kRowBytes +
                                (((2 * s + khalf) ^ (prow & 7)) << 4));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma::tf32_split(raw[i], a[par][0][i], a[par][1][i]);
      mma::wgmma_fence();
      const uint32_t hi = bbase + s * 2 * kTileBytes;
      const uint32_t lo = hi + kTileBytes;
#ifdef CID_TF32_NO_CORRECTION
      mma::wgmma_m64n128k8_tf32(part, a[par][0], mma::wgmma_desc_k32(hi),
                                s > 0);
#else
      mma::wgmma_m64n128k8_tf32(part, a[par][1], mma::wgmma_desc_k32(hi),
                                s > 0);
      mma::wgmma_m64n128k8_tf32(part, a[par][0], mma::wgmma_desc_k32(lo),
                                true);
      mma::wgmma_m64n128k8_tf32(part, a[par][0], mma::wgmma_desc_k32(hi),
                                true);
#endif
      mma::wgmma_commit();
      // the variance's updates run while the products do: channels 8s + q
      // (raw 0 and 1: rows g, g + 8) and 8s + q + 4 (raw 2 and 3)
      if (stats) {
        if (c0 + 8 * s + q < g.K)
          st.add({bits_f32(raw[0]), bits_f32(raw[1])},
                 cur.chunk == 0 && s == 0);
        if (c0 + 8 * s + q + 4 < g.K)
          st.add({bits_f32(raw[2]), bits_f32(raw[3])}, false);
      }
      mma::wgmma_wait<1>();  // the other buffer's products are done
    }
    mma::wgmma_wait<0>();
    mma::warp_sync();
    if (lane == 0) mma::mbar_arrive(empty(stage));
    if (stats) st.end_chunk();
#pragma unroll
    for (int e = 0; e < 64; ++e)
      acc[e] = cur.chunk == 0 ? part[e] : acc[e] + part[e];
    if (cur.chunk == g.nchunks - 1) {
      const Unit u(g, cur.unit);
      if (stats) {
        st.row_scales(r);
      } else if (!g.ln) {
        r[0] = r[1] = 1.f;
      }
      const int n0 = (u.pass0 + cur.pass) * kNB;
      const long long row0 = u.r0 + wg * 64 + warp * 16 + lane / 4;
      // the residual's pairs first, all loads in flight at once (part's
      // registers are free now); zeros where nothing is read
      float2 rv[2][kNB / 8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + 8 * h;
        const float* res = g.res + row * g.N;
#pragma unroll
        for (int i = 0; i < kNB / 8; ++i) {
          const int co = n0 + 8 * i + 2 * q;
          rv[h][i] = make_float2(0.f, 0.f);
          if (g.res == nullptr || row >= u.rend || co >= g.N) continue;
          if (co + 1 < g.N && g.pair_ok) {
            rv[h][i] = *reinterpret_cast<const float2*>(res + co);
          } else {
            rv[h][i].x = res[co];
            if (co + 1 < g.N) rv[h][i].y = res[co + 1];
          }
        }
      }
      // acc[4i + 2h .. + 1]: row g + 8h, channels n0 + 8i + 2q and + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + 8 * h;
        if (row >= u.rend) continue;
        float* out = g.y + row * g.N;
#pragma unroll
        for (int i = 0; i < kNB / 8; ++i)
          conv::store_pair_f32(
              out, n0 + 8 * i + 2 * q, g.N,
              make_float2(acc[4 * i + 2 * h] * r[h] + rv[h][i].x,
                          acc[4 * i + 2 * h + 1] * r[h] + rv[h][i].y),
              g.pair_ok);
      }
    }
    cur.advance(g);
  }
}

}  // namespace

// y (images * hw rows, N) = r * (a w^T) + res.  a: row i at a + i * lda
// (floats); wk: gemm_weights' split weights, (ceil(N / 128), 4 ceil(K /
// 32), 2, 128, 8) f32 an image, images w_img floats apart (0: shared);
// res: y's shape, or null; ln: fold a LayerNorm (r_i = 1 / sqrt(var(a_i)
// + 1e-5)), else r = 1.
extern "C" int cid_pointwise_gemm(const void* a, long long lda,
                                  const void* wk, long long w_img,
                                  const void* res, void* y, int images,
                                  long long hw, int K, int N, int ln,
                                  cudaStream_t stream) {
  if (a == nullptr || wk == nullptr || y == nullptr || images < 1 ||
      hw < 1 || K < 1 || N < 1 || lda < K || w_img < 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles_img = (hw + kRows - 1) / kRows;
  const long long tiles = images * tiles_img;
  const int npass = (N + kNB - 1) / kNB;
  const int sms = conv::sm_count();
  // with two tiles or more an SM, a block takes all of a tile's passes (a
  // row's variance is taken once); with fewer, one pass, so that the
  // passes fill the card
  const int ppu = tiles >= 2LL * sms ? npass : 1;
  const long long units = tiles * (npass / ppu);
  if (!cid::grid_fits(units * ppu * ((K + kKC - 1) / kKC)) || sms <= 0)
    return (int)cudaErrorInvalidConfiguration;
  const float* af = static_cast<const float*>(a);
  const float* rf = static_cast<const float*>(res);
  float* yf = static_cast<float*>(y);
  const auto a8 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
  };
  const Gemm g{af,
               lda,
               static_cast<const float*>(wk),
               w_img,
               rf,
               yf,
               hw,
               K,
               N,
               (int)tiles_img,
               npass,
               (K + kKC - 1) / kKC,
               ppu,
               lda % 4 == 0 && K % 4 == 0 && conv::aligned16(af),
               ln != 0,
               N % 2 == 0 && a8(yf) && (rf == nullptr || a8(rf))};
  cudaError_t err = cudaFuncSetAttribute(
      pointwise_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  pointwise_gemm_kernel<<<grid, kThreads, kSmem, stream>>>(g,
                                                                 (int)units);
  return (int)cudaGetLastError();
}
