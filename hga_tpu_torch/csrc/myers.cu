// Bit-parallel Myers/Hyyro semi-global edit distance for Hopper (sm_90a).
//
// K1 (myers_kernel<W, false>) replaces the Pallas kernel `_myers_kernel`
// (hga_tpu/ops/myers_pallas.py:47): per pair, dist = min_j D[m][j] and
// tend = the smallest such j (1-based), both 0 when qlen = 0.  It is the
// long-read overlap gate.
// K2 (myers_kernel<W, true>) replaces `_myers_planes_kernel`
// (hga_tpu/ops/myers_pallas.py:106): the same recurrence, plus the Pv/Mv
// words stored after every target column into int32 planes laid out
// (Lt, N, W), the layout the plane-based traceback
// (hga_tpu_torch/ops/pileup.py) reads.  It is the correction/polish DP.
//
// Design: one thread per pair, 128 threads a block.  The W query words are
// template-unrolled into registers (W = 1..24), so the adder carry chain and
// the cross-word shift carries are W - 1 dependent register ops per column.
// Words are uint32_t: the block sum (Eq & Pv) + Pv + carry overflows bit 31
// by design, which signed int would make undefined.  Target codes are read
// column-major from a transposed (Lt, N) copy so that the 32 threads of a
// warp read 32 neighbouring words per column; query planes arrive (W, N)
// for the same reason.
//
// What bounds it: per column and word about 20 integer ALU operations, all
// serial within a pair, so the kernel is bound by integer issue rate and, at
// N = 4096 pairs (32 blocks on 132 SMs), by occupancy.  K2 additionally
// writes 8 * W bytes per pair and column straight to device memory.
// Making either fast (several pairs per thread, a pair split over a warp, a
// traceback fused into K2) is later work; this version is the simple one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M31 = 0x7fffffffu;
constexpr int kThreads = 128;

template <int W, bool PLANES>
__global__ void __launch_bounds__(kThreads)
myers_kernel(const int32_t* __restrict__ q0p, const int32_t* __restrict__ q1p,
             const int32_t* __restrict__ vqp,
             const int32_t* __restrict__ mendp,   // (W, N) each
             const int32_t* __restrict__ tT,      // (Lt, N)
             const int32_t* __restrict__ qlen,
             const int32_t* __restrict__ tlen,    // (N,)
             int N, int Lt,
             int32_t* __restrict__ dist, int32_t* __restrict__ tend,
             int32_t* __restrict__ pvp,
             int32_t* __restrict__ mvp) {         // (Lt, N, W) or null
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  uint32_t q0[W], q1[W], vq[W], mend[W], pv[W], mv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    q0[w] = static_cast<uint32_t>(q0p[w * N + n]);
    q1[w] = static_cast<uint32_t>(q1p[w * N + n]);
    vq[w] = static_cast<uint32_t>(vqp[w * N + n]);
    mend[w] = static_cast<uint32_t>(mendp[w * N + n]);
    pv[w] = M31;
    mv[w] = 0u;
  }
  const int ql = qlen[n];
  const int tl = tlen[n];
  int score = ql, best = ql, bj = 0;
  for (int j = 0; j < Lt; ++j) {
    const int tc = tT[static_cast<size_t>(j) * N + n];
    const uint32_t t0 = 0u - static_cast<uint32_t>(tc & 1);
    const uint32_t t1 = 0u - static_cast<uint32_t>((tc >> 1) & 1);
    // full validity compare: any code outside 0..3 never matches
    const uint32_t tvm = (tc >= 0 && tc < 4) ? 0xffffffffu : 0u;
    uint32_t cin = 0u, cp = 0u, cm = 0u, pb = 0u, mb = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t eq = (vq[w] & ~((q0[w] ^ t0) | (q1[w] ^ t1))) & tvm;
      const uint32_t xv = eq | mv[w];
      const uint32_t sw = (eq & pv[w]) + pv[w] + cin;
      cin = sw >> 31;                       // adder carry out of bit 31
      const uint32_t xh = ((sw & M31) ^ pv[w]) | eq;
      uint32_t ph = mv[w] | ~(xh | pv[w]);
      uint32_t mh = pv[w] & xh;
      pb |= ph & mend[w];
      mb |= mh & mend[w];
      const uint32_t ncp = (ph >> 30) & 1u;  // shift carries out of bit 30
      const uint32_t ncm = (mh >> 30) & 1u;
      ph = ((ph << 1) & M31) | cp;
      mh = ((mh << 1) & M31) | cm;
      cp = ncp;
      cm = ncm;
      pv[w] = (mh | ~(xv | ph)) & M31;
      mv[w] = ph & xv;
      if (PLANES) {
        const size_t o = (static_cast<size_t>(j) * N + n) * W + w;
        pvp[o] = static_cast<int32_t>(pv[w]);
        mvp[o] = static_cast<int32_t>(mv[w]);
      }
    }
    score += (pb != 0u ? 1 : 0) - (mb != 0u ? 1 : 0);
    if (score < best && j < tl) {
      best = score;
      bj = j + 1;
    }
  }
  dist[n] = ql == 0 ? 0 : best;
  tend[n] = ql == 0 ? 0 : bj;
}

template <int W>
void launch_w(bool planes, const int32_t* q0, const int32_t* q1,
              const int32_t* vq, const int32_t* mend, const int32_t* tT,
              const int32_t* qlen, const int32_t* tlen, int N, int Lt,
              int32_t* dist, int32_t* tend, int32_t* pvp, int32_t* mvp,
              cudaStream_t stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  if (planes) {
    myers_kernel<W, true><<<blocks, kThreads, 0, stream>>>(
        q0, q1, vq, mend, tT, qlen, tlen, N, Lt, dist, tend, pvp, mvp);
  } else {
    myers_kernel<W, false><<<blocks, kThreads, 0, stream>>>(
        q0, q1, vq, mend, tT, qlen, tlen, N, Lt, dist, tend, pvp, mvp);
  }
}

template <int W>
cudaError_t attrs_w(bool planes, cudaFuncAttributes* a) {
  return planes ? cudaFuncGetAttributes(a, myers_kernel<W, true>)
                : cudaFuncGetAttributes(a, myers_kernel<W, false>);
}

#define HGA_WORD_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) \
  X(13) X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24)

}  // namespace

extern "C" {

// Launches K1 (pvp == mvp == null) or K2 on `stream`.  Returns the launch's
// cudaGetLastError() (0 = cudaSuccess); W outside 1..24 returns
// cudaErrorInvalidValue without launching.
int hga_myers_launch(const void* q0, const void* q1, const void* vq,
                     const void* mend, const void* tT, const void* qlen,
                     const void* tlen, int N, int Lt, int W, void* dist,
                     void* tend, void* pvp, void* mvp, void* stream) {
  const bool planes = pvp != nullptr;
  auto* s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto m = [](void* p) { return static_cast<int32_t*>(p); };
  switch (W) {
#define HGA_CASE(w)                                                        \
  case w:                                                                  \
    launch_w<w>(planes, c(q0), c(q1), c(vq), c(mend), c(tT), c(qlen),      \
                c(tlen), N, Lt, m(dist), m(tend), m(pvp), m(mvp), s);      \
    break;
    HGA_WORD_CASES(HGA_CASE)
#undef HGA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation, as the loaded module reports them.
int hga_myers_attrs(int W, int planes, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaErrorInvalidValue;
  switch (W) {
#define HGA_CASE(w) \
  case w:           \
    e = attrs_w<w>(planes != 0, &a); \
    break;
    HGA_WORD_CASES(HGA_CASE)
#undef HGA_CASE
    default:
      break;
  }
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
