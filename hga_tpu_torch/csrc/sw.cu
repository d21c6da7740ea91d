// Banded local Smith-Waterman (linear gap), score and end cell, for Hopper
// (sm_90a).
//
// The four kernels replace the Pallas kernel `_sw_kernel`
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
// compute_overlaps), forward at band b and reverse at band 2 b.
//
// Three routes, chosen by the wrapper (ops/align_cuda.py) from the shape
// alone, and a fourth kernel that only timing comparisons force:
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
// K3'' sw_band_kernel<K> (the other shapes whose clamped band + 1 <= 256
// and whose staged codes fit 227 KB a block; the 300 bp refine at Lq 320
// among them): a warp per pair along the anti-diagonals, over a window of
// band + 1 slots that moves with the band instead of the whole query axis.
// On anti-diagonal d the in-band rows are i0(d) .. i0(d) + band with
// i0(d) = ceil((d - band) / 2); slot s holds row i = i0(d) + s and column
// j = d - i.  Lane l holds slots l * K .. l * K + K - 1, K = 1 .. 8 the
// smallest with 32 K >= band + 1, so the slot count does not depend on Lq.
// i0 advances on every other d: delta = i0(d) - i0(d - 1) = (d - band) & 1.
//   - diagonal (i - 1, j - 1): the same slot two steps back, in a register;
//   - delta 0: up (i - 1, j) is slot s - 1 and left (i, j - 1) slot s on
//     d - 1 (one __shfl_up_sync, lane 0 takes 0);
//   - delta 1: up is slot s and left slot s + 1 (one __shfl_down_sync,
//     lane 31 takes 0).
// The loop runs the two parities as two unrolled steps, so a step has one
// shuffle and no select on delta, and the two register arrays trade roles
// without a move.  The query and the reversed target are staged in shared
// memory, -1 outside the codes, with margins so that every slot of every
// step from d = 1 to the pair's last reads inside them; a step reads
// q[i - 1] and t[j - 1] at consecutive addresses in slot order, and only
// masked cells read a margin.  Cells store 0 outside 1 <= i <= qlen and
// 1 <= j <= tlen (per-slot bounds on d: i >= 1 iff d >= band - 2 s + 1,
// j >= 1 iff d >= 2 s + 2 - band, i <= qlen iff d <= 2 (qlen - s) + band,
// j <= tlen iff d <= 2 (tlen + s) + 1 - band) and outside the band: slots
// past band never hold a cell, and slot band overshoots it by one on
// delta-1 steps.  The 0 is exact for the reason given for K3'.  Each slot
// keeps (H, d) with a strict >; a slot's row follows from d, so the
// butterfly takes max H, min d, min slot (on one d the smallest slot is
// the smallest i) and qend = i0(d) + s.  The loop stops at the pair's last
// in-band anti-diagonal, qlen + min(tlen, qlen + band).  4 warps a block
// (fewer when the windows need it).
//
// K3''' sw_wide_kernel<K> and sw_wide_mem_kernel<SCRATCH> (every other
// shape: a clamped band above 255, or a query too long for the K3''
// windows; no length or band cap): the K3'' slot schedule, with
//   - no length cap: the query and reversed-target windows are staged per
//     chunk of kWideChunk (256) anti-diagonals, kWideChunk / 2 + S codes
//     each (S the pair's slots), refilled as the band moves, so a pair's
//     shared memory does not grow with Lq (band 64: 1,800 B a pair);
//   - the band + 1 slots across the lanes and the warps of a block: 32 K
//     slots a warp (K = 1 .. 8), nw = ceil((band + 1) / 256) warps a pair
//     (at most 8: bands up to 2047 in registers).  Inside a warp the
//     neighbour exchange is the K3'' shuffle; across warps a delta-0 step
//     needs the last slot of the warp below and a delta-1 step the first
//     slot of the warp above, which each warp publishes in shared memory
//     after its step (the parities alternate, so the two words
//     double-buffer each other) before one __syncthreads.  One warp a pair
//     (nw = 1) runs 4 pairs a block and no block barrier.  The bests reduce
//     by the warp butterfly, then across the pair's warps in shared memory;
//   - past 2048 slots, the slots in memory (sw_wide_mem_kernel): one pair a
//     block of 512 threads, thread x on slots x, x + 512, ...; two rows of
//     band + 3 int32 in shared memory up to band 29,053 (227 KB), past it
//     in a device scratch (N, 2, band + 3); the neighbours read from the
//     rows, one __syncthreads a step, a running best a thread (its slots
//     in order within a step, the steps in order: the same tie rule), codes
//     loaded from the caller's rows only for cells in the band and the
//     lengths.
//
// K3 sw_kernel<SMEM> (forced only, beside K3''' on the same inputs): one
// thread per pair, rows i swept in order, the row's band of 2 * band + 1
// cells held in one buffer indexed k = j - i + band and updated in place;
// ties compare (H, -d, -i) since a row sweep meets cells in another order.
// The buffer lives in shared memory laid out [slot][thread], 32 threads a
// block; above 227 KB a block (band > 907) in a device-memory scratch laid
// out [slot][pair].  Codes are read from transposed (L, N) copies.
//
// What bounds them: about 12 int32 operations per in-band cell
// (the Pallas CostEstimate counts 12); bytes are small (codes read once,
// 12 bytes written per pair).  K3' does 32 K slot-steps per anti-diagonal
// whatever the band, so out-of-band slots cost too (at the refine's
// forward shape, Lq 112, Lt 184, band 64, a third of the swept slot-steps
// of a full-length pair are in band).  What the design does about it: K is
// the smallest that holds the query, the loop stops at the pair's own last
// in-band anti-diagonal (ragged reverse-pass pairs stop early), the cell
// is one DPX instruction and the neighbour exchange one shuffle; 1024
// warps at N = 4096 fill the 132 SMs.  K3'' sweeps 32 K >= band + 1 slots
// an anti-diagonal, so at Lq 320 over half of its slot-steps are in band,
// and 4096 warps (one a pair) fill the card where K3's 128 blocks of one
// warp left one warp an SM, each cell a serial chain through shared
// memory.  It pays one more shared-memory read a cell (the query code,
// which moves with the window) and one more compare on delta-1 steps.
// K3''' adds, over K3'', a window refill every 256 anti-diagonals and, at
// nw > 1, a block barrier and a shared-memory word a step; N 4096 pairs at
// nw warps each launch 4096 nw warps (31 nw an SM).  K3 is bound by the
// per-cell chain along a row, serial within a pair.

#include <algorithm>
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

// K3'' geometry: ceil(x / 2) for either sign.  i0(d) = ceil((d - band) / 2)
// is the row of slot 0 on anti-diagonal d and f(d) = d - i0(d) its column;
// slot s holds (i0(d) + s, f(d) - s).
__host__ __device__ __forceinline__ int ceil_half(int x) {
  return x >= 0 ? (x + 1) / 2 : -((-x) / 2);
}

// The staged windows of one pair: qs[x] = q[qlo + x] for x < qwin and
// ts[y] = t[thi - y] for y < twin (-1 outside the codes), wide enough for
// every slot of every anti-diagonal 1 .. dmax + 1, where dmax =
// Lq + min(Lt, Lq + band) is the last one any pair can reach (the loop
// runs its steps in pairs, so it may take one step past a pair's last).
struct BandGeom {
  int qlo, qwin, thi, twin;
};

BandGeom band_geom(int Lq, int Lt, int band, int K) {
  const int S = 32 * K;
  const int dmax = std::max(Lq + std::min(Lt, Lq + band), 2);
  const int i1 = ceil_half(1 - band), ie = ceil_half(dmax + 1 - band);
  BandGeom g;
  g.qlo = i1 - 1;                          // row i0(1) - 1, slot 0
  g.qwin = ie + S - 2 - g.qlo + 1;         // up to row i0(dmax + 1) + S - 1
  g.thi = (dmax + 1 - ie) - 1;             // column f(dmax + 1), slot 0
  g.twin = g.thi - ((1 - i1) - S) + 1;     // down to column f(1) - S + 1
  return g;
}

// One anti-diagonal d of K3'' (and K3''') at parity DELTA: X holds the
// slots' H on d - 2 and takes d's, Y holds d - 1.  qp[k] and tp[k] are the
// codes of slot p0 + k; eb is this lane's k of slot band (any value if
// none); edge is the neighbour on d - 1 past the warp's first slot (DELTA
// 0) or last slot (DELTA 1): 0 at a pair's edge, else the adjacent warp's.
template <int K, int DELTA>
__device__ __forceinline__ void band_step(
    int d, int lane, int eb, int edge, const int32_t* qp, const int32_t* tp,
    int match,
    int mismatch, int gap, const int (&dlo)[K], const int (&dhi)[K],
    int (&X)[K], const int (&Y)[K], int (&bv)[K], int (&bd)[K]) {
  int nb[K];  // the neighbour on d - 1 besides slot s: s - 1 or s + 1
  if (DELTA == 0) {
    const int up = __shfl_up_sync(kFull, Y[K - 1], 1);
    nb[0] = lane == 0 ? edge : up;
#pragma unroll
    for (int k = 1; k < K; ++k) nb[k] = Y[k - 1];
  } else {
    const int dn = __shfl_down_sync(kFull, Y[0], 1);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) nb[k] = Y[k + 1];
    nb[K - 1] = lane == 31 ? edge : dn;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int sub = qp[k] == tp[k] ? match : mismatch;
    const int mg = max(Y[k], nb[k]) + gap;
    int v = __viaddmax_s32_relu(X[k], sub, mg);
    bool in = d >= dlo[k] && d <= dhi[k];
    if (DELTA == 1) in = in && k != eb;  // slot band is out of the band
    v = in ? v : 0;
    if (v > bv[k]) {
      bv[k] = v;
      bd[k] = d;
    }
    X[k] = v;
  }
}

template <int K>
__global__ void __launch_bounds__(kDiagWarps * 32)
sw_band_kernel(const int32_t* __restrict__ q,     // (N, Lq)
               const int32_t* __restrict__ t,     // (N, Lt)
               const int32_t* __restrict__ qlen,
               const int32_t* __restrict__ tlen,  // (N,)
               int N, int Lq, int Lt, int band, int match, int mismatch,
               int gap, BandGeom g, int32_t* __restrict__ score,
               int32_t* __restrict__ qend, int32_t* __restrict__ tend) {
  extern __shared__ __align__(16) int32_t band_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;                          // the whole warp leaves
  const int p0 = lane * K;                     // this lane's first slot
  int32_t* qs = band_smem + warp * (g.qwin + g.twin);
  int32_t* ts = qs + g.qwin;
  const int ql = min(max(qlen[n], 0), Lq);
  const int tl = min(tlen[n], Lt);
  for (int x = lane; x < g.qwin; x += 32) {
    const int u = g.qlo + x;
    qs[x] = (u >= 0 && u < Lq) ? q[static_cast<size_t>(n) * Lq + u] : -1;
  }
  for (int y = lane; y < g.twin; y += 32) {
    const int u = g.thi - y;
    ts[y] = (u >= 0 && u < Lt) ? t[static_cast<size_t>(n) * Lt + u] : -1;
  }
  __syncwarp();
  int dlo[K], dhi[K], A[K], B[K], bv[K], bd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = p0 + k;
    dlo[k] = max(band - 2 * s + 1, 2 * s + 2 - band);
    dhi[k] = s <= band ? min(2 * (ql - s) + band, 2 * (tl + s) + 1 - band)
                       : -1;
    A[k] = B[k] = bv[k] = bd[k] = 0;
  }
  const int eb = band - p0;
  const int dend = ql >= 1 ? ql + min(tl, ql + band) : 1;
  // start on the first anti-diagonal of parity 0 (d = 1 holds no cell);
  // the pointers hold d0 - 1's window: i0(d0 - 1) = i0(d0), f one less
  const int d0 = 2 - (band & 1);
  const int i0 = (d0 - band) / 2;              // exact: d0 - band is even
  const int32_t* qp = qs + (i0 - 1 - g.qlo) + p0;
  const int32_t* tp = ts + (g.thi - (d0 - i0 - 1) + 1) + p0;
  for (int d = d0; d <= dend; d += 2) {
    --tp;                                      // delta 0: f(d) = f(d-1) + 1
    band_step<K, 0>(d, lane, eb, 0, qp, tp, match, mismatch, gap, dlo, dhi,
                    A, B, bv, bd);
    ++qp;                                      // delta 1: i0(d) = i0(d-1) + 1
    band_step<K, 1>(d + 1, lane, eb, 0, qp, tp, match, mismatch, gap, dlo,
                    dhi, B, A, bv, bd);
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
    const int qe = has ? ceil_half(b.d - band) + b.p : 0;
    score[n] = b.v;
    qend[n] = qe;
    tend[n] = has ? b.d - qe : 0;
  }
}

template <int K>
cudaError_t launch_band(const int32_t* q, const int32_t* t, const int32_t* ql,
                        const int32_t* tl, int N, int Lq, int Lt, int band,
                        int match, int mismatch, int gap, int warps,
                        int32_t* score, int32_t* qend, int32_t* tend,
                        cudaStream_t s) {
  const BandGeom g = band_geom(Lq, Lt, band, K);
  const size_t smem = static_cast<size_t>(warps) * (g.qwin + g.twin) * 4;
  if (band + 1 > 32 * K || smem > static_cast<size_t>(kSmemMax)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      sw_band_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sw_band_kernel<K><<<(N + warps - 1) / warps, warps * 32, smem, s>>>(
      q, t, ql, tl, N, Lq, Lt, band, match, mismatch, gap, g, score, qend,
      tend);
  return cudaGetLastError();
}

// K3''' geometry.  Register slots: 32 K slots a warp, nw warps a pair
// (slot s on thread s / K of the pair, thread = warp * 32 + lane), one pair
// a block when nw > 1, `pairs` pairs a block of one warp each when nw = 1.
// A pair's shared memory: the query window and the reversed target window
// of one chunk of kWideChunk anti-diagonals (wide_win codes each) and two
// exchange words a warp.
constexpr int kWideChunk = 256;   // anti-diagonals one staged window serves
constexpr int kWideWarps = 8;     // most warps a block (and a pair)
constexpr int kMemThreads = 512;  // threads a pair with the slots in memory

__host__ __device__ __forceinline__ int wide_win(int S) {
  return kWideChunk / 2 + S;
}

__device__ __forceinline__ void pair_sync(int nw) {
  if (nw > 1) {
    __syncthreads();  // nw > 1: the block is one pair
  } else {
    __syncwarp();
  }
}

template <int K>
__global__ void __launch_bounds__(kWideWarps * 32)
sw_wide_kernel(const int32_t* __restrict__ q,     // (N, Lq)
               const int32_t* __restrict__ t,     // (N, Lt)
               const int32_t* __restrict__ qlen,
               const int32_t* __restrict__ tlen,  // (N,)
               int N, int Lq, int Lt, int band, int match, int mismatch,
               int gap, int nw, int32_t* __restrict__ score,
               int32_t* __restrict__ qend, int32_t* __restrict__ tend) {
  extern __shared__ __align__(16) int32_t wide_smem[];
  __shared__ int red_v[kWideWarps], red_d[kWideWarps], red_p[kWideWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pairs = (blockDim.x >> 5) / nw;
  const int pp = warp / nw;                    // the block's pair
  const int wp = warp - pp * nw;               // this warp's place in it
  const int n = blockIdx.x * pairs + pp;
  if (n >= N) return;                          // the whole pair leaves
  const int S = 32 * K * nw;                   // slots a pair
  const int win = wide_win(S);
  int32_t* qs = wide_smem + pp * (2 * win + 2 * nw);
  int32_t* ts = qs + win;
  int32_t* xf = ts + win;      // each warp's first slot, after delta-0 steps
  int32_t* xl = xf + nw;       // each warp's last slot, after delta-1 steps
  const int tid = wp * 32 + lane;
  const int nt = nw * 32;
  const int p0 = tid * K;                      // this lane's first slot
  const int ql = min(max(qlen[n], 0), Lq);
  const int tl = min(tlen[n], Lt);
  int dlo[K], dhi[K], A[K], B[K], bv[K], bd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = p0 + k;
    dlo[k] = max(band - 2 * s + 1, 2 * s + 2 - band);
    dhi[k] = s <= band ? min(2 * (ql - s) + band, 2 * (tl + s) + 1 - band)
                       : -1;
    A[k] = B[k] = bv[k] = bd[k] = 0;
  }
  if (tid < nw) xf[tid] = xl[tid] = 0;
  const int eb = band - p0;
  const int dend = ql >= 1 ? ql + min(tl, ql + band) : 1;
  const int d0 = 2 - (band & 1);               // the first parity-0 step
  const int32_t* qrow = q + static_cast<size_t>(n) * Lq;
  const int32_t* trow = t + static_cast<size_t>(n) * Lt;
  for (int dc = d0; dc <= dend; dc += kWideChunk) {
    // the windows of anti-diagonals dc .. dc + kWideChunk - 1: qs[x] =
    // q[i0(dc) - 1 + x], ts[x] = t[f(dc) + kWideChunk / 2 - 1 - x], -1
    // outside the codes
    pair_sync(nw);
    const int i0c = (dc - band) / 2;           // exact: dc - band is even
    const int qb = i0c - 1;
    const int tb = dc - i0c + kWideChunk / 2 - 1;
    for (int x = tid; x < win; x += nt) {
      const int u = qb + x, v = tb - x;
      qs[x] = (u >= 0 && u < Lq) ? __ldg(qrow + u) : -1;
      ts[x] = (v >= 0 && v < Lt) ? __ldg(trow + v) : -1;
    }
    pair_sync(nw);
    // the pointers hold dc - 1's window: i0(dc - 1) = i0(dc), f one less
    const int32_t* qp = qs + p0;
    const int32_t* tp = ts + kWideChunk / 2 + 1 + p0;
    const int dstop = min(dc + kWideChunk - 2, dend);
    for (int d = dc; d <= dstop; d += 2) {
      --tp;                                    // delta 0: f(d) = f(d-1) + 1
      const int e0 = wp > 0 ? xl[wp - 1] : 0;
      band_step<K, 0>(d, lane, eb, e0, qp, tp, match, mismatch, gap, dlo,
                      dhi, A, B, bv, bd);
      if (nw > 1) {
        if (lane == 0) xf[wp] = A[0];
        __syncthreads();
      }
      ++qp;                                    // delta 1: i0(d) = i0(d-1) + 1
      const int e1 = wp + 1 < nw ? xf[wp + 1] : 0;
      band_step<K, 1>(d + 1, lane, eb, e1, qp, tp, match, mismatch, gap, dlo,
                      dhi, B, A, bv, bd);
      if (nw > 1) {
        if (lane == 31) xl[wp] = B[K - 1];
        __syncthreads();
      }
    }
  }
  Best b{-1, INT_MAX, INT_MAX};
#pragma unroll
  for (int k = 0; k < K; ++k) take(b, bv[k], bd[k], p0 + k);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v = __shfl_xor_sync(kFull, b.v, o);
    const int d = __shfl_xor_sync(kFull, b.d, o);
    const int p = __shfl_xor_sync(kFull, b.p, o);
    take(b, v, d, p);
  }
  if (nw > 1) {
    if (lane == 0) {
      red_v[wp] = b.v;
      red_d[wp] = b.d;
      red_p[wp] = b.p;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nw; ++w) take(b, red_v[w], red_d[w], red_p[w]);
    }
  }
  if (tid == 0) {
    const bool has = b.v > 0;
    const int qe = has ? ceil_half(b.d - band) + b.p : 0;
    score[n] = b.v;
    qend[n] = qe;
    tend[n] = has ? b.d - qe : 0;
  }
}

// K3''' with the slots in memory (a band too wide for the register slots):
// one pair a block of kMemThreads threads, thread x holding slots x, x +
// kMemThreads, ...; two rows of band + 3 int32 (slots -1 .. band + 1, the
// two outer ones 0) in shared memory, or in the device scratch (SCRATCH,
// (N, 2, band + 3)) past 227 KB; one __syncthreads a step.  Codes load
// from the caller's rows, only for cells in the band and the lengths.
template <bool SCRATCH>
__global__ void __launch_bounds__(kMemThreads)
sw_wide_mem_kernel(const int32_t* __restrict__ q,     // (N, Lq)
                   const int32_t* __restrict__ t,     // (N, Lt)
                   const int32_t* __restrict__ qlen,
                   const int32_t* __restrict__ tlen,  // (N,)
                   int N, int Lq, int Lt, int band, int match, int mismatch,
                   int gap, int32_t* __restrict__ scratch,
                   int32_t* __restrict__ score, int32_t* __restrict__ qend,
                   int32_t* __restrict__ tend) {
  extern __shared__ __align__(16) int32_t mem_smem[];
  __shared__ int red_v[kMemThreads / 32], red_d[kMemThreads / 32],
      red_p[kMemThreads / 32];
  const int n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = band + 3;
  int32_t* rows = SCRATCH ? scratch + static_cast<size_t>(n) * 2 * R
                          : mem_smem;
  for (int x = tid; x < 2 * R; x += kMemThreads) rows[x] = 0;
  __syncthreads();
  int32_t* X = rows + 1;                       // d - 2, takes d
  int32_t* Y = rows + R + 1;                   // d - 1
  const int ql = min(max(qlen[n], 0), Lq);
  const int tl = min(tlen[n], Lt);
  const int dend = ql >= 1 ? ql + min(tl, ql + band) : 1;
  const int32_t* qrow = q + static_cast<size_t>(n) * Lq;
  const int32_t* trow = t + static_cast<size_t>(n) * Lt;
  int bv = 0, bd = 0, bp = 0;
  for (int d = 2; d <= dend; ++d) {
    const int delta = (d - band) & 1;
    const int i0 = ceil_half(d - band);
    const int f = d - i0;
    for (int s = tid; s <= band; s += kMemThreads) {
      const bool in = d >= max(band - 2 * s + 1, 2 * s + 2 - band) &&
                      d <= min(2 * (ql - s) + band,
                               2 * (tl + s) + 1 - band) &&
                      !(delta == 1 && s == band);
      int v = 0;
      if (in) {
        const int qc = __ldg(qrow + i0 + s - 1);
        const int tc = __ldg(trow + f - s - 1);
        const int sub = qc == tc ? match : mismatch;
        const int mg = max(Y[s], Y[s - 1 + 2 * delta]) + gap;
        v = __viaddmax_s32_relu(X[s], sub, mg);
      }
      if (v > bv) {
        bv = v;
        bd = d;
        bp = s;
      }
      X[s] = v;
    }
    __syncthreads();
    int32_t* swap = X;
    X = Y;
    Y = swap;
  }
  Best b{bv, bd, bp};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v = __shfl_xor_sync(kFull, b.v, o);
    const int d = __shfl_xor_sync(kFull, b.d, o);
    const int p = __shfl_xor_sync(kFull, b.p, o);
    take(b, v, d, p);
  }
  if (lane == 0) {
    red_v[warp] = b.v;
    red_d[warp] = b.d;
    red_p[warp] = b.p;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kMemThreads / 32; ++w) {
      take(b, red_v[w], red_d[w], red_p[w]);
    }
    const bool has = b.v > 0;
    const int qe = has ? ceil_half(b.d - band) + b.p : 0;
    score[n] = b.v;
    qend[n] = qe;
    tend[n] = has ? b.d - qe : 0;
  }
}

template <int K>
cudaError_t launch_wide(const int32_t* q, const int32_t* t, const int32_t* ql,
                        const int32_t* tl, int N, int Lq, int Lt, int band,
                        int match, int mismatch, int gap, int nw, int pairs,
                        int32_t* score, int32_t* qend, int32_t* tend,
                        cudaStream_t s) {
  const int S = 32 * K * nw;
  const size_t smem =
      static_cast<size_t>(pairs) * (2 * wide_win(S) + 2 * nw) * 4;
  if (band + 1 > S || nw < 1 || pairs < 1 || (nw > 1 && pairs != 1) ||
      nw * pairs > kWideWarps || smem > static_cast<size_t>(kSmemMax)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      sw_wide_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sw_wide_kernel<K><<<(N + pairs - 1) / pairs, 32 * nw * pairs, smem, s>>>(
      q, t, ql, tl, N, Lq, Lt, band, match, mismatch, gap, nw, score, qend,
      tend);
  return cudaGetLastError();
}

cudaError_t launch_wide_mem(const int32_t* q, const int32_t* t,
                            const int32_t* ql, const int32_t* tl, int N,
                            int Lq, int Lt, int band, int match, int mismatch,
                            int gap, int32_t* scratch, int32_t* score,
                            int32_t* qend, int32_t* tend, cudaStream_t s) {
  if (scratch != nullptr) {
    sw_wide_mem_kernel<true><<<N, kMemThreads, 0, s>>>(
        q, t, ql, tl, N, Lq, Lt, band, match, mismatch, gap, scratch, score,
        qend, tend);
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(2) * (band + 3) * 4;
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sw_wide_mem_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sw_wide_mem_kernel<false><<<N, kMemThreads, smem, s>>>(
      q, t, ql, tl, N, Lq, Lt, band, match, mismatch, gap, nullptr, score,
      qend, tend);
  return cudaGetLastError();
}

// Calls f(the instantiation of a route at K): K3' (route 0), K3 with shared
// memory (1) or the device scratch (2), K3'' (3), K3''' (4; K 0: its slots
// in shared memory) and K3''' with its slots in the device scratch (5).
template <class F>
cudaError_t with_kernel(int route, int K, F&& f) {
  switch (route * 16 + K) {
    case 0 * 16 + 1: return f(sw_diag_kernel<1>);
    case 0 * 16 + 2: return f(sw_diag_kernel<2>);
    case 0 * 16 + 4: return f(sw_diag_kernel<4>);
    case 0 * 16 + 8: return f(sw_diag_kernel<8>);
    case 3 * 16 + 1: return f(sw_band_kernel<1>);
    case 3 * 16 + 2: return f(sw_band_kernel<2>);
    case 3 * 16 + 3: return f(sw_band_kernel<3>);
    case 3 * 16 + 4: return f(sw_band_kernel<4>);
    case 3 * 16 + 5: return f(sw_band_kernel<5>);
    case 3 * 16 + 6: return f(sw_band_kernel<6>);
    case 3 * 16 + 7: return f(sw_band_kernel<7>);
    case 3 * 16 + 8: return f(sw_band_kernel<8>);
    case 4 * 16 + 0: return f(sw_wide_mem_kernel<false>);
    case 4 * 16 + 1: return f(sw_wide_kernel<1>);
    case 4 * 16 + 2: return f(sw_wide_kernel<2>);
    case 4 * 16 + 3: return f(sw_wide_kernel<3>);
    case 4 * 16 + 4: return f(sw_wide_kernel<4>);
    case 4 * 16 + 5: return f(sw_wide_kernel<5>);
    case 4 * 16 + 6: return f(sw_wide_kernel<6>);
    case 4 * 16 + 7: return f(sw_wide_kernel<7>);
    case 4 * 16 + 8: return f(sw_wide_kernel<8>);
    default: break;
  }
  if (route == 1) return f(sw_kernel<true>);
  if (route == 2) return f(sw_kernel<false>);
  if (route == 5) return f(sw_wide_mem_kernel<true>);
  return cudaErrorInvalidValue;
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

// Launches K3'' on `stream`: q, t int32 (N, Lq), (N, Lt) row-major, K slots
// a lane (1 .. 8; 32 K >= band + 1, the band already clamped to
// max(Lq, Lt) by the caller), `warps` pairs a block (1..4), whose staged
// windows (band_geom) must fit kSmemMax.  Returns the launch's
// cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue without
// launching.
int hga_sw_band_launch(const void* q, const void* t, const void* qlen,
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
    return static_cast<int>(launch_band<k>(                                \
        c(q), c(t), c(qlen), c(tlen), N, Lq, Lt, band, match, mismatch,    \
        gap, warps, m(score), m(qend), m(tend), s));
    HGA_CASE(1) HGA_CASE(2) HGA_CASE(3) HGA_CASE(4) HGA_CASE(5) HGA_CASE(6)
    HGA_CASE(7) HGA_CASE(8)
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

// Launches K3''' on `stream`: q, t int32 (N, Lq), (N, Lt) row-major, the
// band already clamped to max(Lq, Lt).  K = 1 .. 8 runs the register
// slots: 32 K slots a warp, nw warps a pair (32 K nw >= band + 1), `pairs`
// pairs a block (pairs > 1 only at nw = 1; nw x pairs <= 8), the pairs'
// windows (2 (kWideChunk / 2 + 32 K nw) + 2 nw int32 each) fitting
// kSmemMax together.  K = 0 runs the slots in memory: two rows of band + 3
// int32 in shared memory (scratch null; they must fit kSmemMax) or in
// `scratch`, (N, 2, band + 3) int32.  Returns the launch's
// cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue without
// launching.
int hga_sw_wide_launch(const void* q, const void* t, const void* qlen,
                       const void* tlen, int N, int Lq, int Lt, int band,
                       int match, int mismatch, int gap, int K, int nw,
                       int pairs, void* scratch, void* score, void* qend,
                       void* tend, void* stream) {
  if (N <= 0 || Lq < 0 || Lt < 0 || band < 0 || gap > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto m = [](void* p) { return static_cast<int32_t*>(p); };
  switch (K) {
    case 0:
      return static_cast<int>(launch_wide_mem(
          c(q), c(t), c(qlen), c(tlen), N, Lq, Lt, band, match, mismatch,
          gap, m(scratch), m(score), m(qend), m(tend), s));
#define HGA_CASE(k)                                                        \
  case k:                                                                  \
    return static_cast<int>(launch_wide<k>(                                \
        c(q), c(t), c(qlen), c(tlen), N, Lq, Lt, band, match, mismatch,    \
        gap, nw, pairs, m(score), m(qend), m(tend), s));
    HGA_CASE(1) HGA_CASE(2) HGA_CASE(3) HGA_CASE(4) HGA_CASE(5) HGA_CASE(6)
    HGA_CASE(7) HGA_CASE(8)
#undef HGA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation: K3' at K (route 0), K3 with shared memory (route 1) or
// with the device scratch (route 2), K3'' at K (route 3), K3''' at K
// (route 4; K 0: its slots in shared memory) or with its slots in the
// device scratch (route 5).
int hga_sw_attrs(int route, int K, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t e = with_kernel(route, K, [&](auto kernel) {
    return cudaFuncGetAttributes(&a, kernel);
  });
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

// Blocks of `threads` threads and `smem` dynamic bytes one SM holds at
// once, of the instantiation hga_sw_attrs names.
int hga_sw_occupancy(int route, int K, int threads, int smem, int* blocks) {
  return static_cast<int>(with_kernel(route, K, [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t r = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (r != cudaSuccess) return r;
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         threads, smem);
  }));
}

}  // extern "C"
