// Bit-parallel Myers/Hyyro semi-global edit distance with the Pv/Mv planes,
// for Hopper (sm_90a).
//
// K2s (myers_planes_kernel<W, G>) replaces the Pallas kernel
// `_myers_planes_kernel` (hga_tpu/ops/myers_pallas.py:106): per pair, dist =
// min_j D[m][j] and tend = the smallest such j (1-based), both 0 when qlen
// = 0, plus the Pv/Mv words stored after every target column into int32
// planes laid out (Lt, N, W), the layout the plane-based traceback
// (hga_tpu_torch/ops/pileup.py) reads.  It is the planes DP of
// exp/bench_corr_tb; the correction path runs K2' (myers_votes.cu), which
// keeps the planes on chip.  K2 (myers_kernel<W>, one thread a pair, W
// 1-24) stays beside it only for timing comparisons on the same inputs.
//
// K2s design, K1''s split DP (myers_gate.cu) with the planes stored: one
// pair on a group of G lanes (G = the smallest power of two >= W up to a
// warp's 32), 32 / G pairs a warp, 128 threads a block; lane w holds the
// WL = ceil(W / G) query words w * WL .. w * WL + WL - 1, built in the
// kernel from the caller's row-major (N, Lq) codes.  At step s lane w runs
// target column s - w, with the carries lane w - 1 made for that column at
// step s - 1 (one __shfl_up_sync); the warp stages its pairs' target rows
// in shared memory as int8 codes, kChunk columns at a time.  The register
// route (W 1-34) keeps a lane's words in registers; the wide route (W = 0
// in the template: any W at run time, G = 32, WL = ceil(W / 32)) keeps
// them lane-interleaved in dynamic shared memory, or in a device scratch.
//
// The planes: a column's words leave the lanes over A = ceil(W / WL) steps
// (the skew), so each warp keeps a ring of A columns in shared memory, the
// Pv then Mv words of its 32 / G pairs, W apiece; lane w writes its words
// of column s - w there at step s, and after the step, when column s - A + 1
// is whole, the warp stores that column's 32 / G x W words of each plane
// as one contiguous run of the (Lt, N, W) planes (its pairs are
// neighbours in N), coalesced.  The register route's rings are static
// (at most 31 KB a block, W 31-32); the wide route's follow its words in
// dynamic shared memory where both fit 227 KB a block (W up to ~200),
// else each lane stores its own words.
//
// What bounds it: 8 W bytes per pair and column written to device memory
// (byte-bound at every W; 2 x Lt x N x W x 4 bytes of planes), about 20
// integer operations per word, column and pair beside.  The split design
// keeps every lane that holds a word busy and 32 / G pairs a warp resident
// (1,024 warps at N 4096 and W 4) where K2 ran one thread a pair, 32
// blocks on 132 SMs, storing each thread's W words W ints apart from its
// neighbour's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M31 = 0x7fffffffu;
constexpr int kThreads = 128;

template <int W>
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
             int32_t* __restrict__ mvp) {         // (Lt, N, W)
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
      const size_t o = (static_cast<size_t>(j) * N + n) * W + w;
      pvp[o] = static_cast<int32_t>(pv[w]);
      mvp[o] = static_cast<int32_t>(mv[w]);
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
void launch_w(const int32_t* q0, const int32_t* q1, const int32_t* vq,
              const int32_t* mend, const int32_t* tT, const int32_t* qlen,
              const int32_t* tlen, int N, int Lt, int32_t* dist,
              int32_t* tend, int32_t* pvp, int32_t* mvp,
              cudaStream_t stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  myers_kernel<W><<<blocks, kThreads, 0, stream>>>(
      q0, q1, vq, mend, tT, qlen, tlen, N, Lt, dist, tend, pvp, mvp);
}

#define HGA_WORD_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) \
  X(13) X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24)

// ---------------------------------------------------------------- K2s

constexpr int kWarps = kThreads / 32;
constexpr int kPayload = 31;
constexpr int kChunk = 128;             // target columns staged at a time
constexpr int kPlanes = 5;              // q0, q1, vq, pv, mv: a word's state
constexpr unsigned kFull = 0xffffffffu;

constexpr int group_of(int W) {         // the smallest power of two >= W
  return W <= 1 ? 1 : W <= 2 ? 2 : W <= 4 ? 4 : W <= 8 ? 8 : W <= 16 ? 16
                                                                     : 32;
}

// W > 0: the register route, W compiled in; W = 0: the wide route (G 32)
template <int W, int G>
struct Geo {
  static constexpr int WL = W > 0 ? (W + G - 1) / G : 0;  // 0: at run time
  static constexpr int A = W > 0 ? (W + WL - 1) / WL : 32;  // at most
  static constexpr int P = 32 / G;                  // pairs a warp
  static constexpr int SPAN = kChunk + A - 1;       // columns a staged row
  static constexpr int ROW = ((SPAN + 3) / 4 | 1) * 4;  // bytes, odd words
  // a warp's ring: A columns of its pairs' Pv then Mv words (register route)
  static constexpr int RING = W > 0 ? 2 * A * P * W : 1;
};

// A lane's words (plane p: 0 q0, 1 q1, 2 vq, 3 pv, 4 mv): registers on the
// register route ...
template <int WL>
struct Words {
  uint32_t v[kPlanes][WL];
  __device__ __forceinline__ uint32_t& at(int p, int k) { return v[p][k]; }
};

// ... or memory on the wide route: `base` is this lane's first word
template <>
struct Words<0> {
  uint32_t* base;
  int wl;
  __device__ __forceinline__ uint32_t& at(int p, int k) {
    return base[(p * wl + k) * 32];
  }
};

struct PlanesArgs {
  const int32_t* q;      // (N, Lq)
  const int32_t* t;      // (N, Lt)
  const int32_t* qlen;   // (N,)
  const int32_t* tlen;   // (N,)
  int32_t* dist;
  int32_t* tend;
  int32_t* pvp;          // (Lt, N, W)
  int32_t* mvp;          // (Lt, N, W)
  uint32_t* words;       // the wide route's word scratch, or null
  int N, Lq, Lt, W, wl;
  int ring;              // wide route: 1 = rings in dynamic shared memory
};

template <int W_, int G>
__global__ void __launch_bounds__(kThreads)
myers_planes_kernel(const PlanesArgs a) {
  using Gm = Geo<W_, G>;
  const int W = W_ > 0 ? W_ : a.W;
  const int WL = W_ > 0 ? Gm::WL : a.wl;
  const int A = (W + WL - 1) / WL;
  __shared__ int8_t stage[kWarps][Gm::P * Gm::ROW];
  __shared__ uint32_t sring[kWarps][Gm::RING];
  extern __shared__ __align__(16) uint32_t dyn[];   // wide: words, rings
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / G;                 // the warp's pair of this lane
  const int w = lane % G;                 // this lane's place in its group
  const int pair0 = (blockIdx.x * kWarps + warp) * Gm::P;
  const int n = pair0 + g;
  const bool live = n < a.N;
  const int ql = live ? __ldg(a.qlen + n) : 0;
  const int tl = live ? __ldg(a.tlen + n) : 0;
  const int PW = Gm::P * W;               // a column's run of the warp's pairs
  const size_t per = static_cast<size_t>(kPlanes) * WL * 32;

  Words<Gm::WL> ws;
  uint32_t* ring = sring[warp];
  if constexpr (W_ == 0) {
    ws.wl = WL;
    ws.base = (a.words != nullptr
                   ? a.words + (static_cast<size_t>(blockIdx.x) * kWarps +
                                warp) * per
                   : dyn + warp * per) + lane;
    ring = a.ring ? dyn + (a.words != nullptr ? 0 : kWarps * per) +
                        static_cast<size_t>(warp) * 2 * A * W
                  : nullptr;
  }
  uint32_t mend[W_ > 0 ? Gm::WL : 1];
  int ek = -1;
  uint32_t ebit = 0u;
#pragma unroll
  for (int k = 0; k < WL; ++k) {
    const int wi = w * WL + k;
    uint32_t b0 = 0u, b1 = 0u, bv = 0u, me = 0u;
    if (live && w < A) {
      const int32_t* row = a.q + static_cast<size_t>(n) * a.Lq;
#pragma unroll
      for (int b = 0; b < kPayload; ++b) {      // 31 loads in flight
        const int pos = wi * kPayload + b;
        const int code = pos < a.Lq ? __ldg(row + pos) : 4;
        if (pos < ql && code < 4) {
          b0 |= static_cast<uint32_t>(code & 1) << b;
          b1 |= static_cast<uint32_t>((code >> 1) & 1) << b;
          bv |= 1u << b;
        }
      }
      if (ql > 0 && wi < W && (ql - 1) / kPayload == wi) {
        ek = k;
        ebit = me = 1u << ((ql - 1) % kPayload);
      }
    }
    if constexpr (W_ > 0) mend[k] = me;
    ws.at(0, k) = b0;
    ws.at(1, k) = b1;
    ws.at(2, k) = bv;
    ws.at(3, k) = M31;
    ws.at(4, k) = 0u;
  }

  int score = ql, best = ql, bj = 0;
  uint32_t out = 0u;           // carries out of this lane's last word
  const int cols = a.Lt;
  const int steps = cols + A - 1;
  const int live_pairs = min(Gm::P, a.N - pair0);   // >= 1 for a live warp
  int8_t* rows = stage[warp];
  for (int s0 = 0; s0 < steps; s0 += kChunk) {
    const int c0 = s0 - (A - 1);          // the first staged column
    {
      // columns c0 .. c0 + kChunk + A - 2 of the warp's pairs, 32
      // neighbouring columns of one row a round, many loads in flight
      const int span = kChunk + A - 1;
      constexpr int PER = (Gm::SPAN + 31) / 32;   // rounds a row
      __syncwarp();
#pragma unroll 16
      for (int it = 0; it < Gm::P * PER; ++it) {
        const int pp = it / PER, c = (it % PER) * 32 + lane;
        const int m = pair0 + pp, col = c0 + c;
        int code = 4;
        if (c < span && m < a.N && col >= 0 && col < cols) {
          code = __ldg(a.t + static_cast<size_t>(m) * a.Lt + col);
          code = (code >= 0 && code < 4) ? code : 4;
        }
        if (c < span) rows[pp * Gm::ROW + c] = static_cast<int8_t>(code);
      }
      __syncwarp();
    }
    const int8_t* mine = rows + g * Gm::ROW + (A - 1 - w);
    const int send = min(kChunk, steps - s0);
    for (int s = 0; s < send; ++s) {
      uint32_t in = 0u;
      if constexpr (G > 1) in = __shfl_up_sync(kFull, out, 1, G);
      const int j = s0 + s - w;           // this lane's column
      if (w < A && j >= 0 && j < cols) {
        const int tc = mine[s];
        const uint32_t t0 = 0u - static_cast<uint32_t>(tc & 1);
        const uint32_t t1 = 0u - static_cast<uint32_t>((tc >> 1) & 1);
        const uint32_t tvm = tc < 4 ? 0xffffffffu : 0u;
        uint32_t cin = 0u, cp = 0u, cm = 0u, pb = 0u, mb = 0u;
        if (w > 0) {
          cin = in & 1u;
          cp = (in >> 1) & 1u;
          cm = (in >> 2) & 1u;
        }
        uint32_t* slot = ring != nullptr
                             ? ring + (j % A) * 2 * PW + g * W + w * WL
                             : nullptr;
#pragma unroll
        for (int k = 0; k < WL; ++k) {
          const uint32_t pv = ws.at(3, k), mv = ws.at(4, k);
          const uint32_t eq =
              (ws.at(2, k) & ~((ws.at(0, k) ^ t0) | (ws.at(1, k) ^ t1))) &
              tvm;
          const uint32_t xv = eq | mv;
          const uint32_t sw = (eq & pv) + pv + cin;
          cin = sw >> 31;                       // adder carry out of bit 31
          const uint32_t xh = ((sw & M31) ^ pv) | eq;
          uint32_t ph = mv | ~(xh | pv);
          uint32_t mh = pv & xh;
          if constexpr (W_ > 0) {
            pb |= ph & mend[k];
            mb |= mh & mend[k];
          } else if (k == ek) {
            pb = ph & ebit;
            mb = mh & ebit;
          }
          const uint32_t ncp = (ph >> 30) & 1u;  // shift carries out of bit 30
          const uint32_t ncm = (mh >> 30) & 1u;
          ph = ((ph << 1) & M31) | cp;
          mh = ((mh << 1) & M31) | cm;
          cp = ncp;
          cm = ncm;
          const uint32_t npv = (mh | ~(xv | ph)) & M31;
          const uint32_t nmv = ph & xv;
          ws.at(3, k) = npv;
          ws.at(4, k) = nmv;
          if (w * WL + k < W) {
            if (slot != nullptr) {
              slot[k] = npv;
              slot[PW + k] = nmv;
            } else if (live) {
              const size_t o =
                  (static_cast<size_t>(j) * a.N + n) * W + w * WL + k;
              a.pvp[o] = static_cast<int32_t>(npv);
              a.mvp[o] = static_cast<int32_t>(nmv);
            }
          }
        }
        out = cin | (cp << 1) | (cm << 2);
        score += (pb != 0u ? 1 : 0) - (mb != 0u ? 1 : 0);
        if (score < best && j < tl) {
          best = score;
          bj = j + 1;
        }
      }
      if (ring != nullptr) {
        // column s0 + s - (A - 1) is whole: the warp stores its pairs' run
        // of W words a pair, Pv then Mv, contiguous in the (Lt, N, W)
        // planes; the slot is free for the next step's lane 0 after it
        __syncwarp();
        const int cf = s0 + s - (A - 1);
        if (cf >= 0 && cf < cols && live_pairs > 0) {
          const uint32_t* src = ring + (cf % A) * 2 * PW;
          const size_t o = (static_cast<size_t>(cf) * a.N + pair0) * W;
          for (int x = lane; x < live_pairs * W; x += 32) {
            a.pvp[o + x] = static_cast<int32_t>(src[x]);
            a.mvp[o + x] = static_cast<int32_t>(src[PW + x]);
          }
        }
        __syncwarp();
      }
    }
  }
  const int e = ql > 0 ? (ql - 1) / kPayload : 0;
  const int writer = (ql > 0 && e < W) ? e / WL : 0;
  if (live && w == writer) {
    a.dist[n] = ql == 0 ? 0 : best;
    a.tend[n] = ql == 0 ? 0 : bj;
  }
}

#define HGA_SPLIT_CASES(X) \
  X(25) X(26) X(27) X(28) X(29) X(30) X(31) X(32) X(33) X(34)

// Calls f(the K2s instantiation for W, or the wide route's for wl > 0,
// its pairs a block).
template <class F>
cudaError_t planes_dispatch(int W, int wl, F&& f) {
  if (wl > 0) {
    if (W < 1 || wl != (W + 31) / 32) return cudaErrorInvalidValue;
    return f(myers_planes_kernel<0, 32>, kWarps);
  }
  switch (W) {
#define HGA_CASE(w) \
  case w:           \
    return f(myers_planes_kernel<w, group_of(w)>, kThreads / group_of(w));
    HGA_WORD_CASES(HGA_CASE)
    HGA_SPLIT_CASES(HGA_CASE)
#undef HGA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`.  Returns the launch's cudaGetLastError()
// (0 = cudaSuccess); W outside 1..24 or null planes return
// cudaErrorInvalidValue without launching.
int hga_myers_launch(const void* q0, const void* q1, const void* vq,
                     const void* mend, const void* tT, const void* qlen,
                     const void* tlen, int N, int Lt, int W, void* dist,
                     void* tend, void* pvp, void* mvp, void* stream) {
  if (pvp == nullptr || mvp == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto m = [](void* p) { return static_cast<int32_t*>(p); };
  switch (W) {
#define HGA_CASE(w)                                                        \
  case w:                                                                  \
    launch_w<w>(c(q0), c(q1), c(vq), c(mend), c(tT), c(qlen), c(tlen), N,  \
                Lt, m(dist), m(tend), m(pvp), m(mvp), s);                  \
    break;
    HGA_WORD_CASES(HGA_CASE)
#undef HGA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes per thread of K2 at W, as
// the loaded module reports them.
int hga_myers_attrs(int W, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaErrorInvalidValue;
  switch (W) {
#define HGA_CASE(w)                               \
  case w:                                         \
    e = cudaFuncGetAttributes(&a, myers_kernel<w>); \
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

// Launches K2s on `stream`: q, t int32 (N, Lq), (N, Lt) row-major, W =
// ceil(Lq / 31) query words; dist, tend (N,) and the Pv/Mv planes (Lt, N,
// W).  The register route (wl = 0): W 1-34, group_of(W) lanes a pair, the
// rings in static shared memory.  The wide route (wl = ceil(W / 32)): any
// W, 32 lanes a pair, each lane's words in `smem` dynamic bytes (4 warps x
// 5 x wl x 32 x 4) or, with `words` given, in that scratch (blocks x 4
// warps x 5 x wl x 32 uint32); with ring = 1 the warps' rings (4 x 2 x A x
// W x 4 bytes, A = ceil(W / wl)) follow in `smem`, else each lane stores
// its own words.  Returns the launch's cudaGetLastError() (0 =
// cudaSuccess), or cudaErrorInvalidValue without launching.
int hga_myers_planes_launch(const void* q, const void* t, const void* qlen,
                            const void* tlen, int N, int Lq, int Lt, int W,
                            int wl, int ring, void* words, int smem,
                            void* dist, void* tend, void* pvp, void* mvp,
                            void* stream) {
  if (N <= 0 || Lq < 0 || Lt < 0 || W < 1 || Lq > W * kPayload ||
      pvp == nullptr || mvp == nullptr || smem < 0 ||
      (wl == 0 && (W > 34 || smem != 0 || ring != 0 || words != nullptr)) ||
      (wl > 0 && words == nullptr && smem == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  PlanesArgs a{static_cast<const int32_t*>(q),
               static_cast<const int32_t*>(t),
               static_cast<const int32_t*>(qlen),
               static_cast<const int32_t*>(tlen),
               static_cast<int32_t*>(dist),
               static_cast<int32_t*>(tend),
               static_cast<int32_t*>(pvp),
               static_cast<int32_t*>(mvp),
               static_cast<uint32_t*>(words),
               N, Lq, Lt, W, wl, ring};
  return static_cast<int>(
      planes_dispatch(W, wl, [&](auto kernel, int per_block) {
        if (smem > 48 * 1024) {
          const cudaError_t r = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
          if (r != cudaSuccess) return r;
        }
        kernel<<<(N + per_block - 1) / per_block, kThreads, smem, s>>>(a);
        return cudaGetLastError();
      }));
}

// Registers per thread and local (spill) bytes per thread of K2s at W (the
// wide route with wl > 0), as the loaded module reports them.
int hga_myers_planes_attrs(int W, int wl, int* regs, int* local_bytes) {
  cudaFuncAttributes fa{};
  const cudaError_t e = planes_dispatch(W, wl, [&](auto kernel, int) {
    return cudaFuncGetAttributes(&fa, kernel);
  });
  if (e == cudaSuccess) {
    *regs = fa.numRegs;
    *local_bytes = static_cast<int>(fa.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
