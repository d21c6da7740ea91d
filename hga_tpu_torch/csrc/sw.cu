// Banded local Smith-Waterman (linear gap), score and end cell, for Hopper
// (sm_90a).
//
// Both kernels replace the Pallas kernel `_sw_kernel`
// (hga_tpu/ops/align_pallas.py:66): per pair, the best cell of the local DP
// over cells (i, j), 1 <= i <= min(qlen, Lq), 1 <= j <= min(tlen, Lt),
// |j - i| <= band, with
//   H[i][j] = max(0, H[i-1][j-1] + (q[i-1] == t[j-1] ? match : mismatch),
//                 H[i-1][j] + gap, H[i][j-1] + gap),   H = 0 on row/col 0.
// Codes compare as int32 values, so the padding codes 4 and -1 match only
// themselves.  Ties break by the highest H, then the smallest anti-diagonal
// d = i + j, then the smallest i: the order the reference's anti-diagonal
// sweep gives with a strict `>`.  Outputs: score = best (>= 0), qend = i and
// tend = j of the best cell (1-based), all 0 when no cell is positive.  It
// is the scored refine of the short-read overlap route (config 3 and
// compute_overlaps), forward at band 64 and reverse at band 128.
//
// Two routes, chosen by the wrapper (ops/align_cuda.py) from the shape
// alone:
//
// K3' sw_diag_kernel<K> (Lq <= 256 and the windows fit 227 KB a block): a
// warp per pair along the anti-diagonals d = 2 .. the pair's last in-band
// one, the reference's full-width layout.  Lane l holds query slots
// p = l * K .. l * K + K - 1 (slot p is row i = p + 1), K = 1, 2, 4, 8 the
// smallest with 32 K >= Lq.  Per step:
//   - s1 (the up neighbours, slot p - 1 on d - 1) is a shift inside the
//     thread plus one __shfl_up_sync across lanes (lane 0 takes 0);
//   - s2 (the diagonal neighbours, d - 2) is the last step's s1;
//   - the target code of slot p on d is t[d - p - 2], read from the pair's
//     reversed window in shared memory, -1 outside 0..Lt-1, so one step
//     reads consecutive words in slot order; the padding is read only on
//     cells that the bounds below zero (j < 1 or j > Lt);
//   - v = max(s2 + sub, max(up, left) + gap, 0) in one DPX instruction
//     (__viaddmax_s32_relu) after the max and the add;
//   - cells outside the band or the lengths store 0 (per-slot bounds
//     dlo = i + max(1, i - band), dhi = i + min(tlen, i + band), -1 past
//     qlen), exact for local SW with gap <= 0: every stored H is >= 0 and
//     a leaked 0 cannot beat a cell's own candidates;
//   - each slot keeps its best H and the first d that reached it (strict >).
// A warp butterfly on (H, d, p) then takes max H, min d, min slot.  The
// operands are the caller's row-major (N, L) codes: a warp loads its own
// pair's rows.  4 warps a block (fewer when the windows need it).
//
// K3 sw_kernel<SMEM> (Lq > 256, or a target too long for the windows): one
// thread per pair, rows i swept in order, the row's band of 2 * band + 1
// cells held in one buffer indexed k = j - i + band and updated in place;
// ties compare (H, -d, -i) since a row sweep meets cells in another order.
// The buffer lives in shared memory laid out [slot][thread], 32 threads a
// block; above 227 KB a block (band > 907) in a device-memory scratch laid
// out [slot][pair].  Codes are read from transposed (L, N) copies.
//
// What bounds K3': about 12 int32 operations per in-band cell (the Pallas
// CostEstimate counts 12), but a warp does 32 K slot-steps per
// anti-diagonal whatever the band, so out-of-band slots cost too (at the
// refine's forward shape, Lq 112, Lt 184, band 64, a third of the swept
// slot-steps of a full-length pair are in band); bytes are small (codes
// read once, 12 bytes written per pair).  What the design does about it: K is the smallest that
// holds the query, the loop stops at the pair's own last in-band
// anti-diagonal (ragged reverse-pass pairs stop early), the cell is one DPX
// instruction and the neighbour exchange one shuffle; 1024 warps at
// N = 4096 fill the 132 SMs.  A band-window layout (band + 1 slots per
// anti-diagonal) would drop the out-of-band slots and is later work.
// K3 is bound by the per-cell chain along a row, serial within a pair.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kDiagWarps = 4;         // most warps a K3' block holds
constexpr int kSmemMax = 232448;      // bytes of shared memory a block may opt in
constexpr unsigned kFull = 0xffffffffu;

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
sw_kernel(const int32_t* __restrict__ qT,     // (Lq, N)
          const int32_t* __restrict__ tT,     // (Lt, N)
          const int32_t* __restrict__ qlen,
          const int32_t* __restrict__ tlen,   // (N,)
          int N, int Lq, int Lt, int band, int match, int mismatch, int gap,
          int32_t* __restrict__ scratch,      // (2 * band + 2, N) if !SMEM
          int32_t* __restrict__ score, int32_t* __restrict__ qend,
          int32_t* __restrict__ tend) {
  extern __shared__ int32_t smem[];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int slots = 2 * band + 2;
  int32_t* buf = SMEM ? smem + threadIdx.x : scratch + n;
  const size_t stride = SMEM ? kThreads : static_cast<size_t>(N);
  for (int k = 0; k < slots; ++k) buf[k * stride] = 0;
  const int ql = min(max(qlen[n], 0), Lq);
  const int tl = min(max(tlen[n], 0), Lt);
  int best = 0, bd = 0, bi = 0;
  for (int i = 1; i <= ql; ++i) {
    const int jlo = max(1, i - band);
    const int jhi = min(tl, i + band);
    if (jlo > jhi) break;  // tl < i - band: every later row is empty too
    const int qc = qT[static_cast<size_t>(i - 1) * N + n];
    int k = jlo - i + band;
    int diag = buf[k * stride];  // H[i-1][jlo-1]
    int left = 0;                // H[i][jlo-1]: column 0 or out of band
    for (int j = jlo; j <= jhi; ++j, ++k) {
      const int up = buf[(k + 1) * stride];  // H[i-1][j]
      const int tc = tT[static_cast<size_t>(j - 1) * N + n];
      const int h = max(max(diag + (qc == tc ? match : mismatch), 0),
                        max(up, left) + gap);
      buf[k * stride] = h;
      const int d = i + j;
      if (h > best || (h == best && d < bd)) {
        best = h;
        bd = d;
        bi = i;
      }
      diag = up;
      left = h;
    }
  }
  score[n] = best;
  qend[n] = best > 0 ? bi : 0;
  tend[n] = best > 0 ? bd - bi : 0;
}

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

template <int K>
__global__ void __launch_bounds__(kDiagWarps * 32)
sw_diag_kernel(const int32_t* __restrict__ q,     // (N, Lq)
               const int32_t* __restrict__ t,     // (N, Lt)
               const int32_t* __restrict__ qlen,
               const int32_t* __restrict__ tlen,  // (N,)
               int N, int Lq, int Lt, int band, int match, int mismatch,
               int gap, int32_t* __restrict__ score,
               int32_t* __restrict__ qend, int32_t* __restrict__ tend) {
  constexpr int Lqp = 32 * K;                  // slots a warp holds
  extern __shared__ __align__(16) int32_t diag_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;                          // the whole warp leaves
  const int p0 = lane * K;                     // this lane's first slot
  // window y holds t[Lt - 1 + Lqp - y] (-1 outside 0..Lt-1); slot p reads
  // y = Lt + 1 + Lqp + p - d on anti-diagonal d, inside 1 .. win - 2
  const int win = Lt + 2 * Lqp;
  int32_t* rw = diag_smem + warp * win;
  const int ql = min(max(qlen[n], 0), Lq);
  const int tl = min(tlen[n], Lt);
  int qv[K], dlo[K], dhi[K], ad1[K], s2[K], bv[K], bd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = p0 + k, i = p + 1;
    qv[k] = p < Lq ? q[static_cast<size_t>(n) * Lq + p] : 0;
    dlo[k] = i + max(1, i - band);
    dhi[k] = i <= ql ? i + min(tl, i + band) : -1;
    ad1[k] = s2[k] = bv[k] = bd[k] = 0;
  }
  // dhi grows with i, so row ql holds the last in-band anti-diagonal
  const int dend = ql >= 1 ? ql + min(tl, ql + band) : 1;
  for (int y = lane; y < win; y += 32) {
    const int u = Lt - 1 + Lqp - y;
    rw[y] = (u >= 0 && u < Lt) ? t[static_cast<size_t>(n) * Lt + u] : -1;
  }
  __syncwarp();
  const int32_t* wbase = rw + Lt + 1 + Lqp + p0;
  for (int d = 2; d <= dend; ++d) {
    const int up = __shfl_up_sync(kFull, ad1[K - 1], 1);
    int s1[K];
    s1[0] = lane == 0 ? 0 : up;
#pragma unroll
    for (int k = 1; k < K; ++k) s1[k] = ad1[k - 1];
    const int32_t* w = wbase - d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int sub = qv[k] == w[k] ? match : mismatch;
      const int mg = max(ad1[k], s1[k]) + gap;
      int v = __viaddmax_s32_relu(s2[k], sub, mg);
      v = (d >= dlo[k] && d <= dhi[k]) ? v : 0;
      if (v > bv[k]) {
        bv[k] = v;
        bd[k] = d;
      }
      s2[k] = s1[k];
      ad1[k] = v;
    }
  }
  Best b{-1, INT_MAX, INT_MAX};
#pragma unroll
  for (int k = 0; k < K; ++k) take(b, bv[k], bd[k], p0 + k);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {           // every lane gets the best
    const int v = __shfl_xor_sync(kFull, b.v, o);
    const int d = __shfl_xor_sync(kFull, b.d, o);
    const int p = __shfl_xor_sync(kFull, b.p, o);
    take(b, v, d, p);
  }
  if (lane == 0) {
    const bool has = b.v > 0;
    const int qe = has ? b.p + 1 : 0;
    score[n] = b.v;
    qend[n] = qe;
    tend[n] = has ? b.d - qe : 0;
  }
}

template <int K>
cudaError_t launch_diag(const int32_t* q, const int32_t* t, const int32_t* ql,
                        const int32_t* tl, int N, int Lq, int Lt, int band,
                        int match, int mismatch, int gap, int warps,
                        int32_t* score, int32_t* qend, int32_t* tend,
                        cudaStream_t s) {
  const size_t smem = static_cast<size_t>(warps) * (Lt + 64 * K) * 4;
  if (Lq > 32 * K || smem > static_cast<size_t>(kSmemMax)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      sw_diag_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sw_diag_kernel<K><<<(N + warps - 1) / warps, warps * 32, smem, s>>>(
      q, t, ql, tl, N, Lq, Lt, band, match, mismatch, gap, score, qend, tend);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3' on `stream`: q, t int32 (N, Lq), (N, Lt) row-major, K slots
// a lane (1, 2, 4, 8; 32 K >= Lq), `warps` pairs a block (1..4), whose
// windows of Lt + 64 K int32 each must fit kSmemMax.  Returns the launch's
// cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue without
// launching.
int hga_sw_diag_launch(const void* q, const void* t, const void* qlen,
                       const void* tlen, int N, int Lq, int Lt, int band,
                       int match, int mismatch, int gap, int K, int warps,
                       void* score, void* qend, void* tend, void* stream) {
  if (N <= 0 || Lq < 0 || Lt < 0 || band < 0 || gap > 0 || warps < 1 ||
      warps > kDiagWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto m = [](void* p) { return static_cast<int32_t*>(p); };
  switch (K) {
#define HGA_CASE(k)                                                        \
  case k:                                                                  \
    return static_cast<int>(launch_diag<k>(                                \
        c(q), c(t), c(qlen), c(tlen), N, Lq, Lt, band, match, mismatch,    \
        gap, warps, m(score), m(qend), m(tend), s));
    HGA_CASE(1) HGA_CASE(2) HGA_CASE(4) HGA_CASE(8)
#undef HGA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches K3 on `stream`; band must already be clamped to max(Lq, Lt) by
// the caller.  scratch == null runs the shared-memory kernel (2 * band + 2
// slots of 32 threads must fit kSmemMax); otherwise scratch holds
// (2 * band + 2) * N int32.  Returns the launch's cudaGetLastError()
// (0 = cudaSuccess), or cudaErrorInvalidValue without launching.
int hga_sw_rows_launch(const void* qT, const void* tT, const void* qlen,
                       const void* tlen, int N, int Lq, int Lt, int band,
                       int match, int mismatch, int gap, void* scratch,
                       void* score, void* qend, void* tend, void* stream) {
  if (N <= 0 || band < 0 || gap > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto m = [](void* p) { return static_cast<int32_t*>(p); };
  const int blocks = (N + kThreads - 1) / kThreads;
  if (scratch == nullptr) {
    const size_t smem = static_cast<size_t>(2 * band + 2) * kThreads * 4;
    if (smem > static_cast<size_t>(kSmemMax)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t e = cudaFuncSetAttribute(
        sw_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    sw_kernel<true><<<blocks, kThreads, smem, s>>>(
        c(qT), c(tT), c(qlen), c(tlen), N, Lq, Lt, band, match, mismatch,
        gap, nullptr, m(score), m(qend), m(tend));
  } else {
    sw_kernel<false><<<blocks, kThreads, 0, s>>>(
        c(qT), c(tT), c(qlen), c(tlen), N, Lq, Lt, band, match, mismatch,
        gap, m(scratch), m(score), m(qend), m(tend));
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation: K3' at K (route 0), K3 with shared memory (route 1) or
// with the device scratch (route 2).
int hga_sw_attrs(int route, int K, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaErrorInvalidValue;
  if (route == 1) {
    e = cudaFuncGetAttributes(&a, sw_kernel<true>);
  } else if (route == 2) {
    e = cudaFuncGetAttributes(&a, sw_kernel<false>);
  } else if (route == 0) {
    switch (K) {
      case 1: e = cudaFuncGetAttributes(&a, sw_diag_kernel<1>); break;
      case 2: e = cudaFuncGetAttributes(&a, sw_diag_kernel<2>); break;
      case 4: e = cudaFuncGetAttributes(&a, sw_diag_kernel<4>); break;
      case 8: e = cudaFuncGetAttributes(&a, sw_diag_kernel<8>); break;
      default: break;
    }
  }
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
