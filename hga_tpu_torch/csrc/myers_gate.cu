// Bit-parallel Myers/Hyyro semi-global edit distance, the overlap gate, for
// Hopper (sm_90a).
//
// K1' (myers_gate_kernel<W, G, WIN>) replaces the Pallas kernel `_myers_kernel`
// (hga_tpu/ops/myers_pallas.py:47): per pair, dist = min_j D[m][j] over the
// columns j < tlen and tend = the smallest such j (1-based), both 0 when
// qlen = 0.  It is the long-read overlap gate and the short-read route's
// gate (config 3).  Its planes-storing sibling K2 stays in myers.cu.
//
// Design: one pair on a group of G lanes (G = 1, or the smallest power of
// two >= W up to a warp's 32), 32 / G pairs a warp, 128 threads a block.
// Lane w of a group holds the WL = ceil(W / G) query words w * WL ..
// w * WL + WL - 1 on the A = ceil(W / WL) lanes that hold words; lanes past
// them idle.  A spare word past W (the last lane's, where WL does not
// divide W) computes on empty planes, has no effect on the words below it
// and is never loaded or stored as state.
//   - Query planes in the kernel: each lane reads its words' 31 codes from
//     the caller's row-major (N, Lq) codes and builds q0, q1 (the code's low
//     and high bit) and vq (position < qlen and code < 4, the rule of
//     ops/myers.query_planes bit for bit); the end bit of position qlen - 1
//     is a mask a word on the register route, one word index and one bit
//     (ek, ebit) on the wide route, on the lane that holds it.
//   - A pipeline across words: at step s, lane w runs target column
//     j = s - w for its words.  Its three carry-ins (the adder carry out of
//     bit 31, the Ph and Mh shift carries out of bit 30) are what lane w - 1
//     produced for column j at step s - 1, one __shfl_up_sync of a packed
//     word; lane 0 of the group takes 0.  Columns + A - 1 steps.
//   - Word arithmetic as K1 and K2: uint32 words (the block sum overflows
//     bit 31 by design), results masked to 31 bits, target validity tested
//     on the full code (codes outside 0..3 never match).
//   - Targets: each warp stages its pairs' target rows into shared memory
//     as int8 codes (outside 0..3 as 4), kChunk columns at a time plus the
//     A - 1 columns the pipeline's skew needs, coalesced; rows are an odd
//     number of words apart so the groups read distinct banks.  The query
//     codes and each chunk's target codes are loaded with many loads in
//     flight: at a few warps an SM nothing else hides their latency.
//   - Shared target (segment_identity: every pair against one row of
//     2 x genome + 1 columns): the caller passes a single target row and
//     `shared` = 1; every pair reads row 0.  All pairs of a block then want
//     the same columns at each step, so the block stages them once,
//     kSharedChunk columns at a time (a __syncthreads on each side), and
//     every group reads the staged byte at the same address (a broadcast).
//   - Score: only the lane whose word holds the end bit moves the score;
//     it keeps best and bj over columns j0 + j < tlen (strict <) and writes
//     dist and tend (lane 0 when no word holds it: qlen <= 0 or qlen > 31 W).
//   - Carried state (`carry` = 1; the ring engine, parallel/ring_myers.py,
//     runs the target in column chunks, one a rank): the DP starts from the
//     caller's column state instead of column 0's and returns the state it
//     ends in, one int32 row of 2 W + 3 a pair: pv[W], mv[W] (31-bit
//     words), score, best, bj.  j0 is the chunk's global first column: the
//     tlen mask and bj stay global.  Nothing else crosses a chunk edge: the
//     carries into lane w at a chunk's first column come from lane w - 1 on
//     that same column, as inside a chunk.
//
// Two routes.  The register route (W 1-34, W compiled in) keeps a lane's
// words in registers: G = 1 (one thread a pair, W <= 24) or the split
// design (one word a lane up to W 32, two at W 33-34).  The wide route
// (W = 0 in the template: any W at run time, G = 32, one pair a warp, WL =
// ceil(W / 32) words a lane) keeps each lane's q0, q1, vq, pv and mv words
// in memory, 20 B a word, lane-interleaved (word k of lane w at k * 32 + w,
// so a warp's access hits 32 banks): in the block's dynamic shared memory
// where 4 warps' words fit it, else in a device scratch the wrapper
// allocates.  No word count is listed and none is capped: a query of Lq
// bases takes W = ceil(Lq / 31) words on the wide route past 34.
//
// Target windows (blockIdx.y; ops/myers_cuda.gate_route picks them).  The
// DP is sequential in columns but not in windows.  Semi-global distance
// with a free start has D[i][j] <= i (the empty span costs i), and a span
// of L columns costs at least L - i; so every optimal alignment of a row
// i <= 31 W ending at column j starts at or after column j - 2 i.  Window
// k owns columns [k win, (k + 1) win) and, for k >= 1, starts a fresh DP
// (column 0's state: pv all ones, mv 0, score = qlen) at k win - H with
// H = 2 x 31 x W <= win: every D[i][j] of an owned column, and with them
// every Pv/Mv word, equals the one-sweep DP's bit for bit (with `carry`,
// the carried DP's: its columns too start anywhere from global column 0).
// Window 0 starts from column 0 (or the carried state) and alone keeps the
// start value (best, bj) = (qlen, 0) (or the carried pair); every other
// window starts at best = INT_MAX and counts only its owned columns under
// the global tlen mask.  Each window's writer lane takes an atomicMin of
// (best, bj) packed lexicographically into one uint64 slot a pair (best
// biased to order as unsigned), which is the one-sweep rule: the least
// best, and on ties the smallest column, because the strict < keeps the
// first column within a window.  A second small kernel writes dist, tend
// and, with `carry`, the state's best and bj; the last window stores pv,
// mv and score, exact by the span bound.  One window (S = 1) is the plain
// single sweep, with no slot and no second kernel: it runs the instantiation
// without windows (WIN = false), which compiles the window bookkeeping out
// of every step (the per-pair gates run only that one).  Windows run on the
// split design (G = group_of(W)) and the wide route.
//
// What bounds it: about 20 int32 operations per word, column and pair
// (integer issue rate).  Spreading the words over lanes shortens the chain
// per step to one word (plus a shuffle); at a few warps an SM the step
// chain's latency, not the issue rate, bounds it, which the windows repair
// for the shared-row modes (few pairs against millions of columns: 1,307
// warps of 2 pairs at segment_identity's 1 Mb shape).  It costs a shuffle,
// a shared-memory read and the score bookkeeping per lane and step, idle
// lanes where G > W, and (S - 1) H columns of halo.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M31 = 0x7fffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPayload = 31;
constexpr int kChunk = 128;             // target columns staged at a time
constexpr int kSharedChunk = 1024;      // ... a block at a time, shared row
constexpr int kRegMaxWords = 34;        // the register route's W
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

struct GateArgs {
  const int32_t* q;      // (N, Lq)
  const int32_t* t;      // (N, Lt) or (1, Lt)
  const int32_t* qlen;   // (N,)
  const int32_t* tlen;   // (N,)
  const int32_t* st_in;  // (N, 2 W + 3), carry only
  int32_t* st_out;       // (N, 2 W + 3), carry only
  int32_t* dist;
  int32_t* tend;
  unsigned long long* slot;  // (N,) with S > 1 windows, else null
  uint32_t* words;       // wide route's word scratch, or null (shared memory)
  int N, Lq, Lt, W, wl, shared, j0, carry, win, halo;
};

__device__ __forceinline__ unsigned long long slot_key(int best, int bj) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(best) ^
                                          0x80000000u) << 32) |
         static_cast<uint32_t>(bj);
}

template <int W_, int G, bool WIN>
__global__ void __launch_bounds__(kThreads)
myers_gate_kernel(const GateArgs a) {
  using Gm = Geo<W_, G>;
  const int W = W_ > 0 ? W_ : a.W;
  const int WL = W_ > 0 ? Gm::WL : a.wl;
  const int A = (W + WL - 1) / WL;
  __shared__ int8_t stage[kWarps][Gm::P * Gm::ROW];
  __shared__ int8_t srow[kSharedChunk + Gm::A - 1];  // the shared row
  extern __shared__ __align__(16) uint32_t dyn[];   // wide route's words
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / G;                 // the warp's pair of this lane
  const int w = lane % G;                 // this lane's place in its group
  const int pair0 = (blockIdx.x * kWarps + warp) * Gm::P;
  const int n = pair0 + g;
  const bool live = n < a.N;
  const int ql = live ? __ldg(a.qlen + n) : 0;
  const int tl = live ? __ldg(a.tlen + n) : 0;
  const int S = 2 * W + 3;                // a pair's state row
  // this window: launch columns [lo, hi), owned from `own` (all Lt columns
  // without windows)
  const int own = WIN ? static_cast<int>(blockIdx.y) * a.win : 0;
  const int lo = WIN && blockIdx.y > 0 ? own - a.halo : 0;
  const int hi = WIN ? min(own + a.win, a.Lt) : a.Lt;
  const bool first = !WIN || blockIdx.y == 0;
  const bool last = !WIN || blockIdx.y + 1 == gridDim.y;
  const int32_t* st = a.carry && live && first
                          ? a.st_in + static_cast<size_t>(n) * S
                          : nullptr;

  Words<Gm::WL> ws;
  if constexpr (W_ == 0) {
    const size_t per = static_cast<size_t>(kPlanes) * WL * 32;
    ws.wl = WL;
    ws.base = (a.words != nullptr
                   ? a.words + ((static_cast<size_t>(blockIdx.y) * gridDim.x +
                                 blockIdx.x) * kWarps + warp) * per
                   : dyn + warp * per) + lane;
  }
  // the end bit: a mask a word on the register route (no compare a word
  // and step), its word and bit on the wide route
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
    const bool mine = st != nullptr && w < A && wi < W;
    ws.at(0, k) = b0;
    ws.at(1, k) = b1;
    ws.at(2, k) = bv;
    ws.at(3, k) = mine ? static_cast<uint32_t>(st[wi]) : M31;
    ws.at(4, k) = mine ? static_cast<uint32_t>(st[W + wi]) : 0u;
  }

  int score = ql, best = first ? ql : INT_MAX, bj = 0;
  if (st != nullptr) {
    score = st[2 * W];
    best = st[2 * W + 1];
    bj = st[2 * W + 2];
  }
  uint32_t out = 0u;           // carries out of this lane's last word
  const int cols = hi - lo;
  const int steps = cols + A - 1;
  int8_t* rows = stage[warp];
  const int chunk = a.shared ? kSharedChunk : kChunk;
  for (int s0 = 0; s0 < steps; s0 += chunk) {
    const int c0 = lo + s0 - (A - 1);     // the first staged launch column
    const int8_t* mine;
    if (a.shared) {
      // columns c0 .. c0 + kSharedChunk + A - 2 of the one row, once a
      // block: 128 neighbouring columns a round, every round in flight
      const int span = kSharedChunk + A - 1;
      __syncthreads();
#pragma unroll
      for (int it = 0; it < (kSharedChunk + Gm::A - 1 + kThreads - 1) /
                                kThreads; ++it) {
        const int c = it * kThreads + threadIdx.x, col = c0 + c;
        int code = 4;
        if (c < span && col >= lo && col < hi) {
          code = __ldg(a.t + col);
          code = (code >= 0 && code < 4) ? code : 4;
        }
        if (c < span) srow[c] = static_cast<int8_t>(code);
      }
      __syncthreads();
      mine = srow + (A - 1 - w);
    } else {
      // columns c0 .. c0 + kChunk + A - 2 of the warp's pairs, 32
      // neighbouring columns of one row a round, 16 rounds of loads in
      // flight (one warp an SM scheduler hides no load latency)
      const int span = kChunk + A - 1;
      constexpr int PER = (Gm::SPAN + 31) / 32;   // rounds a row
      __syncwarp();
#pragma unroll 16
      for (int it = 0; it < Gm::P * PER; ++it) {
        const int pp = it / PER, c = (it % PER) * 32 + lane;
        const int m = pair0 + pp, col = c0 + c;
        int code = 4;
        if (c < span && m < a.N && col >= lo && col < hi) {
          code = __ldg(a.t + static_cast<size_t>(m) * a.Lt + col);
          code = (code >= 0 && code < 4) ? code : 4;
        }
        if (c < span) rows[pp * Gm::ROW + c] = static_cast<int8_t>(code);
      }
      __syncwarp();
      mine = rows + g * Gm::ROW + (A - 1 - w);
    }
    const int send = min(chunk, steps - s0);
    for (int s = 0; s < send; ++s) {
      uint32_t in = 0u;
      if constexpr (G > 1) in = __shfl_up_sync(kFull, out, 1, G);
      const int jj = s0 + s - w;          // the window's column
      if (w < A && jj >= 0 && jj < cols) {
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
          ws.at(3, k) = (mh | ~(xv | ph)) & M31;
          ws.at(4, k) = ph & xv;
        }
        out = cin | (cp << 1) | (cm << 2);
        score += (pb != 0u ? 1 : 0) - (mb != 0u ? 1 : 0);
        const int j = lo + jj;            // the launch's column
        if (score < best && (!WIN || j >= own) && a.j0 + j < tl) {
          best = score;
          bj = a.j0 + j + 1;
        }
      }
    }
  }
  const int e = ql > 0 ? (ql - 1) / kPayload : 0;
  const int writer = (ql > 0 && e < W) ? e / WL : 0;
  if (live && w == writer) {
    if constexpr (WIN) {
      atomicMin(a.slot + n, slot_key(best, bj));
    } else {
      a.dist[n] = ql == 0 ? 0 : best;
      a.tend[n] = ql == 0 ? 0 : bj;
    }
  }
  if (a.carry && live && last) {
    int32_t* so = a.st_out + static_cast<size_t>(n) * S;
    if (w < A) {
#pragma unroll
      for (int k = 0; k < WL; ++k) {
        if (w * WL + k < W) {
          so[w * WL + k] = static_cast<int32_t>(ws.at(3, k));
          so[W + w * WL + k] = static_cast<int32_t>(ws.at(4, k));
        }
      }
    }
    if (w == writer) {
      so[2 * W] = score;
      if (!WIN) {
        so[2 * W + 1] = best;
        so[2 * W + 2] = bj;
      }
    }
  }
}

// The windows' reduction: each pair's lexicographic minimum (best, bj) as
// dist and tend, and with `carry` as the state's best and bj.
__global__ void myers_gate_reduce_kernel(const unsigned long long* slot,
                                         const int32_t* qlen, int N, int W,
                                         int carry, int32_t* st_out,
                                         int32_t* dist, int32_t* tend) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const unsigned long long key = slot[n];
  const int best = static_cast<int>(static_cast<uint32_t>(key >> 32) ^
                                    0x80000000u);
  const int bj = static_cast<int>(static_cast<uint32_t>(key));
  const int ql = qlen[n];
  dist[n] = ql == 0 ? 0 : best;
  tend[n] = ql == 0 ? 0 : bj;
  if (carry) {
    int32_t* so = st_out + static_cast<size_t>(n) * (2 * W + 3);
    so[2 * W + 1] = best;
    so[2 * W + 2] = bj;
  }
}

// W with both register designs (G = 1 holds 6 W words a thread: at most
// 24), and W with the split design alone (G = 32: one word a lane, two past
// 32); every W on the wide route (W = 0 here).  With windows (win), the
// split design and the wide route only.
#define HGA_WORD_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) \
  X(13) X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24)
#define HGA_SPLIT_CASES(X) \
  X(25) X(26) X(27) X(28) X(29) X(30) X(31) X(32) X(33) X(34)

// Calls f(the instantiation for (W, G, wl, win), its pairs a block).
template <class F>
cudaError_t dispatch(int W, int G, int wl, bool win, F&& f) {
  if (wl > 0) {
    if (G != 32 || W < 1 || wl != (W + 31) / 32) return cudaErrorInvalidValue;
    return win ? f(myers_gate_kernel<0, 32, true>, kWarps)
               : f(myers_gate_kernel<0, 32, false>, kWarps);
  }
  switch (W) {
#define HGA_CASE(w)                                                       \
  case w:                                                                 \
    if (G == group_of(w)) {                                               \
      return win ? f(myers_gate_kernel<w, group_of(w), true>,             \
                     kThreads / group_of(w))                              \
                 : f(myers_gate_kernel<w, group_of(w), false>,            \
                     kThreads / group_of(w));                             \
    }                                                                     \
    if (G == 1 && !win) return f(myers_gate_kernel<w, 1, false>, kThreads); \
    break;
    HGA_WORD_CASES(HGA_CASE)
#undef HGA_CASE
#define HGA_CASE(w)                                                       \
  case w:                                                                 \
    if (G == 32) {                                                        \
      return win ? f(myers_gate_kernel<w, 32, true>, kWarps)              \
                 : f(myers_gate_kernel<w, 32, false>, kWarps);            \
    }                                                                     \
    break;
    HGA_SPLIT_CASES(HGA_CASE)
#undef HGA_CASE
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K1' on `stream`: q, t int32 (N, Lq), (N, Lt) row-major — or,
// with shared = 1, t one row (1, Lt) that every pair runs against; W =
// ceil(Lq / 31) words.  The register route (wl = 0): W 1-34, G = the
// smallest power of two >= W lanes a pair (32 past 16 words), or G = 1 at
// W <= 24.  The wide route (wl = ceil(W / 32) > 0): any W, G = 32, the
// words in `smem` dynamic bytes a block (4 warps x 5 x wl x 32 x 4) or, with
// smem = 0, in `words` (a uint32 scratch of blocks x S x 4 warps x 5 x wl x
// 32).  With carry = 1 the DP starts over the chunk whose first column is
// global column j0 from the states st_in and writes the states it ends in
// to st_out, int32 (N, 2 W + 3) rows of pv[W], mv[W], score, best, bj (else
// both null).  S windows of `win` owned columns (win >= halo when S > 1;
// halo = 62 W suffices; the split design or the wide route); with S > 1,
// `slot` is a uint64 scratch of N that the launch fills.  Returns the first cudaError_t of the launches (0 =
// cudaSuccess), or cudaErrorInvalidValue without launching.
int hga_myers_gate_launch(const void* q, const void* t, const void* qlen,
                          const void* tlen, int N, int Lq, int Lt, int W,
                          int G, int wl, int shared, int j0,
                          const void* st_in, void* st_out, int S, int win,
                          int halo, void* slot, void* words, int smem,
                          void* dist, void* tend, void* stream) {
  const bool carry = st_in != nullptr;
  if (N <= 0 || Lq < 0 || Lt < 0 || W < 1 || Lq > W * kPayload || j0 < 0 ||
      (shared != 0 && shared != 1) || carry != (st_out != nullptr) ||
      S < 1 || S > 65535 || win < 1 ||
      static_cast<long long>(S - 1) * win >= (Lt > 0 ? Lt : 1) ||
      static_cast<long long>(S) * win < Lt ||
      (S > 1 && (halo < 2 * kPayload * W || win < halo || slot == nullptr)) ||
      (wl > 0 && smem == 0 && words == nullptr) || (wl == 0 && smem != 0) ||
      (wl == 0 && W > kRegMaxWords)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  GateArgs a{static_cast<const int32_t*>(q),
             static_cast<const int32_t*>(t),
             static_cast<const int32_t*>(qlen),
             static_cast<const int32_t*>(tlen),
             static_cast<const int32_t*>(st_in),
             static_cast<int32_t*>(st_out),
             static_cast<int32_t*>(dist),
             static_cast<int32_t*>(tend),
             S > 1 ? static_cast<unsigned long long*>(slot) : nullptr,
             smem == 0 ? static_cast<uint32_t*>(words) : nullptr,
             N, Lq, Lt, W, wl, shared, j0, carry ? 1 : 0, win, halo};
  if (S > 1) {
    const cudaError_t e = cudaMemsetAsync(slot, 0xff, sizeof(uint64_t) * N, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t e = dispatch(W, G, wl, S > 1, [&](auto kernel, int per_block) {
    if (smem > 48 * 1024) {
      const cudaError_t r = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (r != cudaSuccess) return r;
    }
    const dim3 grid((N + per_block - 1) / per_block, S);
    kernel<<<grid, kThreads, smem, s>>>(a);
    return cudaGetLastError();
  });
  if (e == cudaSuccess && S > 1) {
    myers_gate_reduce_kernel<<<(N + 255) / 256, 256, 0, s>>>(
        a.slot, a.qlen, N, W, a.carry, a.st_out, a.dist, a.tend);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation (wl > 0: the wide route; win: with windows), as the loaded
// module reports them.
int hga_myers_gate_attrs(int W, int G, int wl, int win, int* regs,
                         int* local_bytes) {
  cudaFuncAttributes fa{};
  const cudaError_t e = dispatch(W, G, wl, win != 0, [&](auto kernel, int) {
    return cudaFuncGetAttributes(&fa, kernel);
  });
  if (e == cudaSuccess) {
    *regs = fa.numRegs;
    *local_bytes = static_cast<int>(fa.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
