// Banded local Smith-Waterman (linear gap), score and end cell, for Hopper
// (sm_90a).
//
// K3 (sw_kernel) replaces the Pallas kernel `_sw_kernel`
// (hga_tpu/ops/align_pallas.py:66): per pair, the best cell of the local DP
// over cells (i, j), 1 <= i <= min(qlen, Lq), 1 <= j <= min(tlen, Lt),
// |j - i| <= band, with
//   H[i][j] = max(0, H[i-1][j-1] + (q[i-1] == t[j-1] ? match : mismatch),
//                 H[i-1][j] + gap, H[i][j-1] + gap),   H = 0 on row/col 0.
// Codes compare as int32 values, so the padding codes 4 and -1 match only
// themselves.  Ties break by the highest H, then the smallest anti-diagonal
// d = i + j, then the smallest i: the order the reference's anti-diagonal
// sweep gives with a strict `>`.  A row sweep meets cells in another order,
// so it compares (H, -d, -i) lexicographically.  Outputs: score = best
// (>= 0), qend = i and tend = j of the best cell (1-based), all 0 when no
// cell is positive.  It is the scored refine of the short-read overlap
// route (config 3 and compute_overlaps), forward at band 64 and reverse at
// band 128.
//
// Design: one thread per pair, rows i swept in order, the row's band of
// 2 * band + 1 cells held in one buffer indexed k = j - i + band.  Row i
// reads H[i-1][j-1] at slot k and H[i-1][j] at slot k + 1 and writes H[i][j]
// at slot k, so one ascending pass updates the buffer in place: the diagonal
// value rides in a register from the previous cell's up read, the left value
// too.  Slots a row does not write hold 0 (never written, or band edges),
// which is exact for local SW with gap <= 0: every stored H is >= 0 and a
// leaked 0 cannot beat a cell's own candidates.  The buffer lives in shared
// memory laid out [slot][thread] (conflict-free), 32 threads a block so that
// 4096 pairs spread over 128 blocks; above 227 KB a block (band > 907) it
// falls back to a device-memory scratch laid out [slot][pair].  Codes are
// read from transposed (L, N) copies so a warp's 32 threads read 32
// neighbouring words per column.  Any Lq and Lt.
//
// What bounds it: about 12 integer operations per in-band cell, serial
// along a row within a pair (the left dependency); bytes are small (int32
// codes read once, 12 bytes written per pair).  At N = 4096 one warp per SM
// cannot hide the shared-memory latency of the per-cell chain, so the kernel
// runs well above its operation bound; a warp per pair along anti-diagonals
// (the reference's layout) is the faster design and later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kSmemMax = 232448;  // bytes of shared memory a block may opt in

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

}  // namespace

extern "C" {

// Launches K3 on `stream`; band must already be clamped to max(Lq, Lt) by
// the caller.  scratch == null runs the shared-memory kernel (2 * band + 2
// slots of 32 threads must fit kSmemMax); otherwise scratch holds
// (2 * band + 2) * N int32.  Returns the launch's cudaGetLastError()
// (0 = cudaSuccess), or cudaErrorInvalidValue without launching.
int hga_sw_launch(const void* qT, const void* tT, const void* qlen,
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

// Registers per thread and local (spill) bytes per thread of the
// shared-memory (smem != 0) or device-scratch instantiation.
int hga_sw_attrs(int smem, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t e = smem ? cudaFuncGetAttributes(&a, sw_kernel<true>)
                             : cudaFuncGetAttributes(&a, sw_kernel<false>);
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
