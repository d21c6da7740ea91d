// Banded local Smith-Waterman by anti-diagonals, a warp per pair, for
// Hopper (sm_90a): the layouts of the SW experiment harness.
//
// X2 replaces the three Pallas kernels of exp/sw_variants.py, reached
// through `sw_pallas_exp` (:170): `_kernel_v1` (:32, int32), `_kernel_v2`
// (:95, int16 state) and `_kernel_v3` (:326, int32 with G interleaved pair
// groups).  All three compute K3's function (csrc/sw.cu): per pair the best
// cell of the banded local DP (match, mismatch, linear gap; H = 0 on row and
// column 0), ties to the highest H, then the smallest anti-diagonal
// d = i + j, then the smallest i; score, qend and tend (1-based), all 0 when
// no cell is positive.  Codes compare as integers (int16 in v2).
//
// One kernel template, two layouts of the state:
//   swv_kernel<PACKED = false, K, G, FLAGS>  int32, one slot a register:
//     v1 is G = 1, v3 is G = 2 or 4; FLAGS are v1's timing ablations
//     (no_ts, no_s1, no_mask, no_best), compile-time, never compared;
//   swv_kernel<PACKED = true, K, 1, 0>       v2: two neighbouring slots as
//     int16 halves of one 32-bit register, SIMD (__vadd2, __vmaxs2, ...).
//
// Design: a warp walks G pairs along the anti-diagonals d = 2 .. the last
// in-band one.  Lane l holds query slots p = l * K .. l * K + K - 1
// (slot p is row i = p + 1; K = 1, 2, 4, 8 covers Lq <= 32 K).  Per step:
//   - s1 (the up neighbours, slot p - 1 on d - 1) is a shift inside the
//     thread plus one __shfl_up_sync across lanes (lane 0 takes 0);
//   - s2 (the diagonal neighbours, d - 2) is the last step's s1;
//   - the target code of slot p on d is t[d - p - 2], read from the
//     pair's reversed, padded target window in shared memory (-1 outside
//     0..Lt-1), so one step reads consecutive words in slot order; v2 reads
//     two int16 codes as one funnel-shifted 32-bit word;
//   - v = max(s2 + sub, max(up, left) + gap, 0), one DPX instruction
//     (__viaddmax_s32_relu / __viaddmax_s16x2_relu) after the max and add;
//   - cells outside the band or the lengths (per-slot d_lo / d_hi, the
//     harness's `_dlohi`) store 0, which is exact for local SW with gap <= 0;
//   - each slot keeps its best H and the first d that reached it (strict >).
// The final step takes max H, then min d among those, then min slot, by a
// warp butterfly on (H, d, p): the tie order of banded_sw_batch.  The loop
// stops at the warp's last in-band anti-diagonal, so ragged pairs stop early.
//
// What bounds it: about 12 integer operations per in-band cell (the
// harness's CostEstimate counts 12 per cell), but a warp does 32 K slots a
// step whatever the band, so out-of-band slots cost too; bytes are small
// (codes read once, 12 bytes written per pair).  A block holds 1..8 warps
// (the harness's pair_tile / 32; 4 by default); a warp's G windows take
// G * (Lt + 64 K) words of shared memory (half that in v2).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSmemMax = 232448;   // bytes of shared memory a block may opt in
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoTs = 1, kNoS1 = 2, kNoMask = 4, kNoBest = 8;

struct Best {
  int v, d, p;
};

__device__ __forceinline__ void take(Best& b, int v, int d, int p) {
  if (v > b.v || (v == b.v && (d < b.d || (d == b.d && p < b.p)))) {
    b.v = v;
    b.d = d;
    b.p = p;
  }
}

// (max H, then min d, then min slot) over the warp; every lane gets it
__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v = __shfl_xor_sync(kFull, b.v, o);
    const int d = __shfl_xor_sync(kFull, b.d, o);
    const int p = __shfl_xor_sync(kFull, b.p, o);
    take(b, v, d, p);
  }
  return b;
}

__device__ __forceinline__ void store(Best b, int n, int32_t* score,
                                      int32_t* qend, int32_t* tend) {
  const bool has = b.v > 0;
  const int qe = has ? b.p + 1 : 0;
  score[n] = b.v;
  qend[n] = qe;
  tend[n] = has ? b.d - qe : 0;
}

__device__ __forceinline__ uint32_t pack16(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         (static_cast<uint32_t>(hi) << 16);
}

template <bool PACKED, int K, int G, int FLAGS>
__global__ void __launch_bounds__(kMaxWarps * 32)
swv_kernel(const int32_t* __restrict__ q,      // (N, Lq)
           const int32_t* __restrict__ t,      // (N, Lt)
           const int32_t* __restrict__ qlen,
           const int32_t* __restrict__ tlen,   // (N,)
           int N, int Lq, int Lt, int band, int match, int mismatch, int gap,
           int32_t* __restrict__ score, int32_t* __restrict__ qend,
           int32_t* __restrict__ tend) {
  constexpr int Lqp = 32 * K;                  // slots a warp holds
  extern __shared__ __align__(16) int32_t swv_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = lane * K;                     // this lane's first slot
  const int win = Lt + 2 * Lqp;                // window length in codes
  // window y holds t[Lt - 1 + Lqp - y] (-1 outside 0..Lt-1); slot p reads
  // y = Lt + 1 + Lqp - d + p on anti-diagonal d
  const int ybase = Lt + 1 + Lqp + p0;
  const int pair0 = (blockIdx.x * (blockDim.x >> 5) + warp) * G;
  int dend = 1;

  if constexpr (!PACKED) {
    const int wwin = win;                      // int32 words a window
    int32_t* rw = swv_smem + warp * G * wwin;
    int qv[G][K], dlo[G][K], dhi[G][K], ad1[G][K], s2[G][K], bv[G][K],
        bd[G][K];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n = pair0 + g;
      const bool live = n < N;
      const int ql = live ? min(max(qlen[n], 0), Lq) : 0;
      const int tl = live ? min(tlen[n], Lt) : 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p = p0 + k, i = p + 1;
        qv[g][k] = (live && p < Lq) ? q[static_cast<size_t>(n) * Lq + p] : 0;
        dlo[g][k] = i + max(1, i - band);
        dhi[g][k] = i <= ql ? i + min(tl, i + band) : -1;
        ad1[g][k] = s2[g][k] = bv[g][k] = bd[g][k] = 0;
      }
      if (ql >= 1) dend = max(dend, ql + min(tl, ql + band));
      for (int y = lane; y < win; y += 32) {
        const int u = Lt - 1 + Lqp - y;
        rw[g * wwin + y] = (live && u >= 0 && u < Lt)
                               ? t[static_cast<size_t>(n) * Lt + u] : -1;
      }
    }
    __syncwarp();
    if (FLAGS & kNoMask) dend = Lq + Lt;
    for (int d = 2; d <= dend; ++d) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        int s1[K];
        if (FLAGS & kNoS1) {
#pragma unroll
          for (int k = 0; k < K; ++k) s1[k] = ad1[g][k];
        } else {
          const int up = __shfl_up_sync(kFull, ad1[g][K - 1], 1);
          s1[0] = lane == 0 ? 0 : up;
#pragma unroll
          for (int k = 1; k < K; ++k) s1[k] = ad1[g][k - 1];
        }
        const int32_t* w = rw + g * wwin + ((FLAGS & kNoTs) ? p0 : ybase - d);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int sub = qv[g][k] == w[k] ? match : mismatch;
          const int mg = max(ad1[g][k], s1[k]) + gap;
          int v = __viaddmax_s32_relu(s2[g][k], sub, mg);
          if (!(FLAGS & kNoMask)) {
            v = (d >= dlo[g][k] && d <= dhi[g][k]) ? v : 0;
          }
          if (!(FLAGS & kNoBest) && v > bv[g][k]) {
            bv[g][k] = v;
            bd[g][k] = d;
          }
          s2[g][k] = s1[k];
          ad1[g][k] = v;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Best b{-1, INT_MAX, INT_MAX};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // without best tracking the last state stands in, so the sweep
        // still feeds the output and is not dead code
        take(b, (FLAGS & kNoBest) ? ad1[g][k] : bv[g][k], bd[g][k], p0 + k);
      }
      b = warp_best(b);
      const int n = pair0 + g;
      if (lane == 0 && n < N) store(b, n, score, qend, tend);
    }
  } else {
    static_assert(K % 2 == 0 && G == 1 && FLAGS == 0, "v2 layout");
    constexpr int H = K / 2;                   // packed words a lane
    const int wwin = (win + 1) / 2 + 1;        // + 1: the funnel's last read
    uint32_t* rw = reinterpret_cast<uint32_t*>(swv_smem) + warp * wwin;
    int16_t* rw16 = reinterpret_cast<int16_t*>(rw);
    const int n = pair0;
    const bool live = n < N;
    const int ql = live ? min(max(qlen[n], 0), Lq) : 0;
    const int tl = live ? min(tlen[n], Lt) : 0;
    uint32_t q2[H], dlo2[H], dhi2[H], ad1[H], s2[H], bv[H], bd[H];
#pragma unroll
    for (int m = 0; m < H; ++m) {
      int c[2], lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 2 * m + h, i = p + 1;
        c[h] = (live && p < Lq) ? q[static_cast<size_t>(n) * Lq + p] : 0;
        lo[h] = i + max(1, i - band);
        hi[h] = i <= ql ? i + min(tl, i + band) : -1;
      }
      q2[m] = pack16(c[0], c[1]);
      dlo2[m] = pack16(lo[0], lo[1]);
      dhi2[m] = pack16(hi[0], hi[1]);
      ad1[m] = s2[m] = bv[m] = bd[m] = 0u;
    }
    if (ql >= 1) dend = ql + min(tl, ql + band);
    for (int y = lane; y < 2 * wwin; y += 32) {
      const int u = Lt - 1 + Lqp - y;
      rw16[y] = static_cast<int16_t>(
          (live && u >= 0 && u < Lt) ? t[static_cast<size_t>(n) * Lt + u]
                                     : -1);
    }
    __syncwarp();
    const uint32_t match2 = pack16(match, match);
    const uint32_t mism2 = pack16(mismatch, mismatch);
    const uint32_t gap2 = pack16(gap, gap);
    for (int d = 2; d <= dend; ++d) {
      const uint32_t d2 = pack16(d, d);
      const int y0 = ybase - d;                // halfword of slot p0
      const unsigned sh = (y0 & 1) * 16;
      const uint32_t* w = rw + (y0 >> 1);
      const uint32_t up = __shfl_up_sync(kFull, ad1[H - 1], 1);
      uint32_t prev = lane == 0 ? 0u : up;
      uint32_t wlo = w[0];
#pragma unroll
      for (int m = 0; m < H; ++m) {
        const uint32_t whi = w[m + 1];
        const uint32_t ts2 = __funnelshift_r(wlo, whi, sh);
        wlo = whi;
        // slots (2m - 1, 2m) of the last step: the up neighbours
        const uint32_t s1 = __byte_perm(prev, ad1[m], 0x5432);
        prev = ad1[m];
        const uint32_t eq = __vcmpeq2(q2[m], ts2);
        const uint32_t sub2 = (eq & match2) | (~eq & mism2);
        const uint32_t mg = __vadd2(__vmaxs2(ad1[m], s1), gap2);
        uint32_t v = __viaddmax_s16x2_relu(s2[m], sub2, mg);
        v &= __vcmpges2(d2, dlo2[m]) & __vcmples2(d2, dhi2[m]);
        const uint32_t gt = __vcmpgts2(v, bv[m]);
        bd[m] = (gt & d2) | (~gt & bd[m]);
        bv[m] = __vmaxs2(bv[m], v);
        s2[m] = s1;
        ad1[m] = v;
      }
    }
    Best b{-1, INT_MAX, INT_MAX};
#pragma unroll
    for (int m = 0; m < H; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = static_cast<int16_t>(bv[m] >> (16 * h));
        const int dd = static_cast<int16_t>(bd[m] >> (16 * h));
        take(b, v, dd, p0 + 2 * m + h);
      }
    }
    b = warp_best(b);
    if (lane == 0 && live) store(b, n, score, qend, tend);
  }
}

template <bool PACKED, int K, int G>
size_t smem_bytes(int Lt, int warps) {
  const size_t win = static_cast<size_t>(Lt) + 64 * K;
  return warps * (PACKED ? ((win + 1) / 2 + 1) * 4 : G * win * 4);
}

template <bool PACKED, int K, int G, int FLAGS>
cudaError_t launch_v(const int32_t* q, const int32_t* t, const int32_t* ql,
                     const int32_t* tl, int N, int Lq, int Lt, int band,
                     int match, int mismatch, int gap, int warps,
                     int32_t* score, int32_t* qend, int32_t* tend,
                     cudaStream_t s) {
  const size_t smem = smem_bytes<PACKED, K, G>(Lt, warps);
  if (Lq > 32 * K || smem > static_cast<size_t>(kSmemMax)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      swv_kernel<PACKED, K, G, FLAGS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int per_block = warps * G;
  swv_kernel<PACKED, K, G, FLAGS>
      <<<(N + per_block - 1) / per_block, warps * 32, smem, s>>>(
      q, t, ql, tl, N, Lq, Lt, band, match, mismatch, gap, score, qend,
      tend);
  return cudaGetLastError();
}

template <bool PACKED, int K, int G, int FLAGS>
cudaError_t attrs_v(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, swv_kernel<PACKED, K, G, FLAGS>);
}

// (PACKED, K, G, FLAGS) of every instantiation: v1 at K 1..8, its 15
// ablations at K 4 (the harness's timing shape, Lq 128), v3 at G 2 and 4,
// v2 at K 2..8
#define HGA_SWV_CASES(X)                                                    \
  X(false, 1, 1, 0) X(false, 2, 1, 0) X(false, 4, 1, 0) X(false, 8, 1, 0)   \
  X(false, 4, 1, 1) X(false, 4, 1, 2) X(false, 4, 1, 3) X(false, 4, 1, 4)   \
  X(false, 4, 1, 5) X(false, 4, 1, 6) X(false, 4, 1, 7) X(false, 4, 1, 8)   \
  X(false, 4, 1, 9) X(false, 4, 1, 10) X(false, 4, 1, 11)                   \
  X(false, 4, 1, 12) X(false, 4, 1, 13) X(false, 4, 1, 14)                  \
  X(false, 4, 1, 15)                                                        \
  X(false, 1, 2, 0) X(false, 2, 2, 0) X(false, 4, 2, 0)                     \
  X(false, 1, 4, 0) X(false, 2, 4, 0) X(false, 4, 4, 0)                     \
  X(true, 2, 1, 0) X(true, 4, 1, 0) X(true, 8, 1, 0)

}  // namespace

extern "C" {

// Launches one X2 instantiation on `stream`, `warps` (1..8) warps a block.
// q, t int32 (N, Lq), (N, Lt); lengths (N,).  Returns the launch's
// cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue without
// launching when (packed, K, G, flags) has no instantiation, Lq > 32 K, or
// the windows do not fit 227 KB of shared memory.
int hga_swv_launch(const void* q, const void* t, const void* qlen,
                   const void* tlen, int N, int Lq, int Lt, int band,
                   int match, int mismatch, int gap, int packed, int K, int G,
                   int flags, int warps, void* score, void* qend, void* tend,
                   void* stream) {
  if (N <= 0 || Lq <= 0 || Lt <= 0 || band < 0 || gap > 0 || warps < 1 ||
      warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto m = [](void* p) { return static_cast<int32_t*>(p); };
#define HGA_CASE(pk, k, g, f)                                              \
  if ((packed != 0) == pk && K == k && G == g && flags == f) {             \
    return static_cast<int>(launch_v<pk, k, g, f>(                         \
        c(q), c(t), c(qlen), c(tlen), N, Lq, Lt, band, match, mismatch,    \
        gap, warps, m(score), m(qend), m(tend), s));                       \
  }
  HGA_SWV_CASES(HGA_CASE)
#undef HGA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation, as the loaded module reports them.
int hga_swv_attrs(int packed, int K, int G, int flags, int* regs,
                  int* local_bytes) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaErrorInvalidValue;
#define HGA_CASE(pk, k, g, f)                                           \
  if ((packed != 0) == pk && K == k && G == g && flags == f) {          \
    e = attrs_v<pk, k, g, f>(&a);                                       \
  }
  HGA_SWV_CASES(HGA_CASE)
#undef HGA_CASE
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
