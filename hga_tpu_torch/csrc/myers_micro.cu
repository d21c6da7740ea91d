// Myers semi-global edit distance with targets staged in slabs of columns,
// for Hopper (sm_90a).
//
// X1 (myers_slab_kernel<W>) replaces the Pallas kernel `_kernel_b`
// (exp/myers_micro.py:58): K1's function (csrc/myers.cu) — per pair,
// dist = min_j D[m][j] and tend = the smallest such j (1-based), both 0
// when qlen = 0 — from precomputed query bit-planes, with the targets read
// in slabs of BLK columns.  On the TPU the slab amortised the loop carry and
// the dynamic addressing of one column per step.
//
// Design: one thread per pair, as in K1; the W query words unrolled into
// registers (W = 1..24, a template parameter), uint32 arithmetic.  A block
// holds P pairs (P = 16 * S, chosen by the wrapper).  Each outer step
// stages the next slab — BLK target columns of the block's P
// pairs — in shared memory: codes are int8 (0..3 match, 4 for every other
// code: the wrapper maps them, so 4 and -1 stay apart from 0..3), laid out
// [column][pair], and the block loads them as 32-bit words, P / 4 threads a
// column, coalesced.  Then every thread runs BLK column steps from the slab,
// unrolled by 8 (BLK is a run-time knob so that sweeping it builds nothing
// new).  The targets arrive transposed (Lt, Np) with Np a multiple of P, so
// every slab load is whole words and aligned.
//
// What bounds it: as K1, about 20 integer operations per word, column and
// pair, serial within a pair — integer issue rate; the slab adds two
// __syncthreads a slab and cuts the target bytes 4x against K1's int32.
// The column step is K1's (csrc/myers.cu), repeated here so the two kernels
// build apart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M31 = 0x7fffffffu;
constexpr int kSmemMax = 232448;  // bytes of shared memory a block may opt in

template <int W>
__global__ void myers_slab_kernel(
    const int32_t* __restrict__ q0p, const int32_t* __restrict__ q1p,
    const int32_t* __restrict__ vqp,
    const int32_t* __restrict__ mendp,   // (W, N) each
    const int8_t* __restrict__ tT,       // (Lt, Np), Np % blockDim.x == 0
    const int32_t* __restrict__ qlen,
    const int32_t* __restrict__ tlen,    // (N,)
    int N, int Np, int Lt, int blk,
    int32_t* __restrict__ dist, int32_t* __restrict__ tend) {
  extern __shared__ uint32_t slab_words[];   // [blk][P / 4]
  const int8_t* slab = reinterpret_cast<const int8_t*>(slab_words);
  const int P = blockDim.x;
  const int wpc = P / 4;                     // 32-bit words per column
  const int n0 = blockIdx.x * P;
  const int n = n0 + threadIdx.x;
  const bool live = n < N;
  uint32_t q0[W], q1[W], vq[W], mend[W], pv[W], mv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    q0[w] = live ? static_cast<uint32_t>(q0p[w * N + n]) : 0u;
    q1[w] = live ? static_cast<uint32_t>(q1p[w * N + n]) : 0u;
    vq[w] = live ? static_cast<uint32_t>(vqp[w * N + n]) : 0u;
    mend[w] = live ? static_cast<uint32_t>(mendp[w * N + n]) : 0u;
    pv[w] = M31;
    mv[w] = 0u;
  }
  const int ql = live ? qlen[n] : 0;
  const int tl = live ? tlen[n] : 0;
  int score = ql, best = ql, bj = 0;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(tT);
  for (int j0 = 0; j0 < Lt; j0 += blk) {
    const int cols = min(blk, Lt - j0);
    __syncthreads();                         // the last slab is consumed
    for (int idx = threadIdx.x; idx < cols * wpc; idx += P) {
      const int r = idx / wpc;
      const int w = idx - r * wpc;
      slab_words[idx] =
          src[(static_cast<size_t>(j0 + r) * Np + n0) / 4 + w];
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < cols; ++r) {
      const int j = j0 + r;
      const int tc = slab[r * P + threadIdx.x];
      const uint32_t t0 = 0u - static_cast<uint32_t>(tc & 1);
      const uint32_t t1 = 0u - static_cast<uint32_t>((tc >> 1) & 1);
      const uint32_t tvm = (tc >= 0 && tc < 4) ? 0xffffffffu : 0u;
      uint32_t cin = 0u, cp = 0u, cm = 0u, pb = 0u, mb = 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t eq = (vq[w] & ~((q0[w] ^ t0) | (q1[w] ^ t1))) & tvm;
        const uint32_t xv = eq | mv[w];
        const uint32_t sw = (eq & pv[w]) + pv[w] + cin;
        cin = sw >> 31;
        const uint32_t xh = ((sw & M31) ^ pv[w]) | eq;
        uint32_t ph = mv[w] | ~(xh | pv[w]);
        uint32_t mh = pv[w] & xh;
        pb |= ph & mend[w];
        mb |= mh & mend[w];
        const uint32_t ncp = (ph >> 30) & 1u;
        const uint32_t ncm = (mh >> 30) & 1u;
        ph = ((ph << 1) & M31) | cp;
        mh = ((mh << 1) & M31) | cm;
        cp = ncp;
        cm = ncm;
        pv[w] = (mh | ~(xv | ph)) & M31;
        mv[w] = ph & xv;
      }
      score += (pb != 0u ? 1 : 0) - (mb != 0u ? 1 : 0);
      if (score < best && j < tl) {
        best = score;
        bj = j + 1;
      }
    }
  }
  if (live) {
    dist[n] = ql == 0 ? 0 : best;
    tend[n] = ql == 0 ? 0 : bj;
  }
}

template <int W>
cudaError_t launch_w(const int32_t* q0, const int32_t* q1, const int32_t* vq,
                     const int32_t* mend, const int8_t* tT,
                     const int32_t* qlen, const int32_t* tlen, int N, int Np,
                     int Lt, int pairs, int blk, int32_t* dist,
                     int32_t* tend, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(blk) * pairs;
  cudaError_t e = cudaFuncSetAttribute(
      myers_slab_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  myers_slab_kernel<W><<<Np / pairs, pairs, smem, s>>>(
      q0, q1, vq, mend, tT, qlen, tlen, N, Np, Lt, blk, dist, tend);
  return cudaGetLastError();
}

template <int W>
cudaError_t attrs_w(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, myers_slab_kernel<W>);
}

#define HGA_WORD_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) \
  X(13) X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24)

}  // namespace

extern "C" {

// Launches X1 on `stream`: planes (W, N), targets int8 (Lt, Np), `pairs`
// threads a block (a multiple of 4, dividing Np, at most 1024), slabs of
// `blk` columns (blk * pairs bytes of shared memory, at most 227 KB).
// Returns the launch's cudaGetLastError() (0 = cudaSuccess), or
// cudaErrorInvalidValue without launching.
int hga_myers_slab_launch(const void* q0, const void* q1, const void* vq,
                          const void* mend, const void* tT, const void* qlen,
                          const void* tlen, int N, int Np, int Lt, int W,
                          int pairs, int blk, void* dist, void* tend,
                          void* stream) {
  if (N <= 0 || Lt < 0 || blk <= 0 || pairs <= 0 || pairs % 4 != 0 ||
      pairs > 1024 || Np % pairs != 0 || Np < N ||
      static_cast<size_t>(blk) * pairs > static_cast<size_t>(kSmemMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto m = [](void* p) { return static_cast<int32_t*>(p); };
  const auto* t8 = static_cast<const int8_t*>(tT);
  switch (W) {
#define HGA_CASE(w)                                                       \
  case w:                                                                 \
    return static_cast<int>(launch_w<w>(c(q0), c(q1), c(vq), c(mend), t8, \
                                        c(qlen), c(tlen), N, Np, Lt,      \
                                        pairs, blk, m(dist), m(tend), s));
    HGA_WORD_CASES(HGA_CASE)
#undef HGA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation, as the loaded module reports them.
int hga_myers_slab_attrs(int W, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaErrorInvalidValue;
  switch (W) {
#define HGA_CASE(w) \
  case w:           \
    e = attrs_w<w>(&a); \
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
