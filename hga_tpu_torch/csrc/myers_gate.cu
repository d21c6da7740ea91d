// Bit-parallel Myers/Hyyro semi-global edit distance, the overlap gate, for
// Hopper (sm_90a).
//
// K1' (myers_gate_kernel<W, G>) replaces the Pallas kernel `_myers_kernel`
// (hga_tpu/ops/myers_pallas.py:47): per pair, dist = min_j D[m][j] over the
// columns j < tlen and tend = the smallest such j (1-based), both 0 when
// qlen = 0.  It is the long-read overlap gate and the short-read route's
// gate (config 3).  Its planes-storing sibling K2 stays in myers.cu.
//
// Design: one pair on a group of G lanes (G = 1, or the smallest power of
// two >= W), 32 / G pairs a warp, 128 threads a block.  Lane w of a group
// holds the WL = ceil(W / G) query words w * WL .. w * WL + WL - 1 (one word
// when G >= W, all W when G = 1); lanes past the last word idle.
//   - Query planes in the kernel: each lane reads its words' 31 codes from
//     the caller's row-major (N, Lq) codes and builds q0, q1 (the code's low
//     and high bit) and vq (position < qlen and code < 4, the rule of
//     ops/myers.query_planes bit for bit), and the end bit of position
//     qlen - 1 in the word that holds it.
//   - A pipeline across words: at step s, lane w runs target column
//     j = s - w for its words.  Its three carry-ins (the adder carry out of
//     bit 31, the Ph and Mh shift carries out of bit 30) are what lane w - 1
//     produced for column j at step s - 1, one __shfl_up_sync of a packed
//     word; lane 0 of the group takes 0.  Lt + A - 1 steps, A the lanes
//     that hold words.
//   - Word arithmetic as K1 and K2: uint32 words (the block sum overflows
//     bit 31 by design), results masked to 31 bits, target validity tested
//     on the full code (codes outside 0..3 never match).
//   - Targets: each warp stages its pairs' target rows into shared memory
//     as int8 codes (outside 0..3 as 4), kChunk columns at a time plus the
//     A - 1 columns the pipeline's skew needs, coalesced; rows are an odd
//     number of words apart so the groups read distinct banks.  The query
//     codes and each chunk's target codes are loaded with many loads in
//     flight: at a few warps an SM nothing else hides their latency.
//   - Score: only the lane whose word holds the end bit moves the score;
//     it keeps best and bj over columns j < tlen (strict <) and writes dist
//     and tend (lane 0 when no word holds it: qlen <= 0 or qlen > 31 W).
// G = 1 is one thread per pair with every word in registers, the previous
// K1 layout with the planes built in the kernel; the wrapper picks G per W
// from a table its chip measurement filled in (ops/myers_cuda.py).
//
// What bounds it: about 20 int32 operations per word, column and pair
// (integer issue rate).  The previous K1 (one thread per pair) ran a serial
// chain of W words x ~20 dependent operations per column in one thread, on
// 32 blocks at N = 4096, far from that bound.  Spreading the words over
// lanes shortens the chain per step to one word (plus a shuffle), and puts
// 512 warps (W 4) to 2048 warps (W 14) on the card instead of 128.  It
// costs a shuffle, a shared-memory read and the score bookkeeping per lane
// and step, and idle lanes where G > W.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M31 = 0x7fffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPayload = 31;
constexpr int kChunk = 128;             // target columns staged at a time
constexpr unsigned kFull = 0xffffffffu;

constexpr int group_of(int W) {         // the smallest power of two >= W
  return W <= 1 ? 1 : W <= 2 ? 2 : W <= 4 ? 4 : W <= 8 ? 8 : W <= 16 ? 16
                                                                     : 32;
}

template <int W, int G>
struct Geo {
  static constexpr int WL = (W + G - 1) / G;        // words a lane
  static constexpr int A = (W + WL - 1) / WL;       // lanes that hold words
  static constexpr int P = 32 / G;                  // pairs a warp
  static constexpr int SPAN = kChunk + A - 1;       // columns a staged row
  static constexpr int ROW = ((SPAN + 3) / 4 | 1) * 4;  // bytes, odd words
  static_assert(W % WL == 0, "every lane that holds words holds WL");
};

template <int W, int G>
__global__ void __launch_bounds__(kThreads)
myers_gate_kernel(const int32_t* __restrict__ q,      // (N, Lq)
                  const int32_t* __restrict__ t,      // (N, Lt)
                  const int32_t* __restrict__ qlen,
                  const int32_t* __restrict__ tlen,   // (N,)
                  int N, int Lq, int Lt,
                  int32_t* __restrict__ dist, int32_t* __restrict__ tend) {
  using Gm = Geo<W, G>;
  constexpr int WL = Gm::WL, A = Gm::A;
  __shared__ int8_t stage[kWarps][Gm::P * Gm::ROW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / G;                 // the warp's pair of this lane
  const int w = lane % G;                 // this lane's place in its group
  const int pair0 = (blockIdx.x * kWarps + warp) * Gm::P;
  const int n = pair0 + g;
  const bool live = n < N;
  const int ql = live ? qlen[n] : 0;
  const int tl = live ? tlen[n] : 0;

  uint32_t q0[WL], q1[WL], vq[WL], mend[WL], pv[WL], mv[WL];
#pragma unroll
  for (int k = 0; k < WL; ++k) {
    const int wi = w * WL + k;
    uint32_t b0 = 0u, b1 = 0u, bv = 0u, me = 0u;
    if (live && w < A) {
      const int32_t* row = q + static_cast<size_t>(n) * Lq;
#pragma unroll
      for (int b = 0; b < kPayload; ++b) {      // 31 loads in flight
        const int pos = wi * kPayload + b;
        const int code = pos < Lq ? row[pos] : 4;
        if (pos < ql && code < 4) {
          b0 |= static_cast<uint32_t>(code & 1) << b;
          b1 |= static_cast<uint32_t>((code >> 1) & 1) << b;
          bv |= 1u << b;
        }
      }
      if (ql > 0 && (ql - 1) / kPayload == wi) {
        me = 1u << ((ql - 1) % kPayload);
      }
    }
    q0[k] = b0;
    q1[k] = b1;
    vq[k] = bv;
    mend[k] = me;
    pv[k] = M31;
    mv[k] = 0u;
  }

  int score = ql, best = ql, bj = 0;
  uint32_t out = 0u;           // carries out of this lane's last word
  const int steps = Lt + A - 1;
  int8_t* rows = stage[warp];
  const int8_t* mine = rows + g * Gm::ROW + (A - 1 - w);
  for (int s0 = 0; s0 < steps; s0 += kChunk) {
    // stage columns s0 - (A - 1) .. s0 + kChunk - 1 of the warp's pairs,
    // 32 neighbouring columns of one row a round, 16 rounds of loads in
    // flight (one warp an SM scheduler hides no load latency)
    __syncwarp();
    const int c0 = s0 - (A - 1);
    constexpr int PER = (Gm::SPAN + 31) / 32;   // rounds a row
#pragma unroll 16
    for (int it = 0; it < Gm::P * PER; ++it) {
      const int pp = it / PER, c = (it % PER) * 32 + lane;
      const int m = pair0 + pp, col = c0 + c;
      int code = 4;
      if (c < Gm::SPAN && m < N && col >= 0 && col < Lt) {
        code = t[static_cast<size_t>(m) * Lt + col];
        code = (code >= 0 && code < 4) ? code : 4;
      }
      if (c < Gm::SPAN) rows[pp * Gm::ROW + c] = static_cast<int8_t>(code);
    }
    __syncwarp();
    const int send = min(kChunk, steps - s0);
    for (int s = 0; s < send; ++s) {
      uint32_t in = 0u;
      if constexpr (G > 1) in = __shfl_up_sync(kFull, out, 1, G);
      const int j = s0 + s - w;
      if (w < A && j >= 0 && j < Lt) {
        const int tc = mine[s];           // column j
        const uint32_t t0 = 0u - static_cast<uint32_t>(tc & 1);
        const uint32_t t1 = 0u - static_cast<uint32_t>((tc >> 1) & 1);
        const uint32_t tvm = tc < 4 ? 0xffffffffu : 0u;
        uint32_t cin = 0u, cp = 0u, cm = 0u, pb = 0u, mb = 0u;
        if (w > 0) {
          cin = in & 1u;
          cp = (in >> 1) & 1u;
          cm = (in >> 2) & 1u;
        }
#pragma unroll
        for (int k = 0; k < WL; ++k) {
          const uint32_t eq = (vq[k] & ~((q0[k] ^ t0) | (q1[k] ^ t1))) & tvm;
          const uint32_t xv = eq | mv[k];
          const uint32_t sw = (eq & pv[k]) + pv[k] + cin;
          cin = sw >> 31;                       // adder carry out of bit 31
          const uint32_t xh = ((sw & M31) ^ pv[k]) | eq;
          uint32_t ph = mv[k] | ~(xh | pv[k]);
          uint32_t mh = pv[k] & xh;
          pb |= ph & mend[k];
          mb |= mh & mend[k];
          const uint32_t ncp = (ph >> 30) & 1u;  // shift carries out of bit 30
          const uint32_t ncm = (mh >> 30) & 1u;
          ph = ((ph << 1) & M31) | cp;
          mh = ((mh << 1) & M31) | cm;
          cp = ncp;
          cm = ncm;
          pv[k] = (mh | ~(xv | ph)) & M31;
          mv[k] = ph & xv;
        }
        out = cin | (cp << 1) | (cm << 2);
        score += (pb != 0u ? 1 : 0) - (mb != 0u ? 1 : 0);
        if (score < best && j < tl) {
          best = score;
          bj = j + 1;
        }
      }
    }
  }
  const int e = ql > 0 ? (ql - 1) / kPayload : 0;
  const int writer = (ql > 0 && e < W) ? e / WL : 0;
  if (live && w == writer) {
    dist[n] = ql == 0 ? 0 : best;
    tend[n] = ql == 0 ? 0 : bj;
  }
}

template <int W, int G>
cudaError_t launch_g(const int32_t* q, const int32_t* t, const int32_t* ql,
                     const int32_t* tl, int N, int Lq, int Lt, int32_t* dist,
                     int32_t* tend, cudaStream_t s) {
  constexpr int per_block = kWarps * Geo<W, G>::P;
  myers_gate_kernel<W, G><<<(N + per_block - 1) / per_block, kThreads, 0, s>>>(
      q, t, ql, tl, N, Lq, Lt, dist, tend);
  return cudaGetLastError();
}

#define HGA_WORD_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) \
  X(13) X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24)

}  // namespace

extern "C" {

// Launches K1' on `stream`: q, t int32 (N, Lq), (N, Lt) row-major,
// W = ceil(Lq / 31) words (1..24), G = 1 or the smallest power of two >= W
// lanes a pair.  Returns the launch's cudaGetLastError() (0 = cudaSuccess),
// or cudaErrorInvalidValue without launching.
int hga_myers_gate_launch(const void* q, const void* t, const void* qlen,
                          const void* tlen, int N, int Lq, int Lt, int W,
                          int G, void* dist, void* tend, void* stream) {
  if (N <= 0 || Lq < 0 || Lt < 0 || Lq > W * kPayload) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto m = [](void* p) { return static_cast<int32_t*>(p); };
  switch (W) {
#define HGA_CASE(w)                                                          \
  case w:                                                                    \
    if (G == 1) {                                                            \
      return static_cast<int>(launch_g<w, 1>(c(q), c(t), c(qlen), c(tlen),   \
                                             N, Lq, Lt, m(dist), m(tend), s)); \
    }                                                                        \
    if (G == group_of(w)) {                                                  \
      return static_cast<int>(launch_g<w, group_of(w)>(                      \
          c(q), c(t), c(qlen), c(tlen), N, Lq, Lt, m(dist), m(tend), s));    \
    }                                                                        \
    break;
    HGA_WORD_CASES(HGA_CASE)
#undef HGA_CASE
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation, as the loaded module reports them.
int hga_myers_gate_attrs(int W, int G, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaErrorInvalidValue;
  switch (W) {
#define HGA_CASE(w)                                                     \
  case w:                                                               \
    if (G == 1) {                                                       \
      e = cudaFuncGetAttributes(&a, myers_gate_kernel<w, 1>);           \
    } else if (G == group_of(w)) {                                      \
      e = cudaFuncGetAttributes(&a, myers_gate_kernel<w, group_of(w)>); \
    }                                                                   \
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
