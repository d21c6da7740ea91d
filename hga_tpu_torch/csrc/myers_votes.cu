// One correction batch in one launch, for Hopper (sm_90a): the Myers planes
// DP, the identity gate, the plane traceback and the vote scatter.
//
// K2' (myers_votes_kernel<G, WL, SMEM>) replaces the Pallas kernel
// `_myers_planes_kernel` (hga_tpu/ops/myers_pallas.py:106) on the
// correction and polish paths, together with what consumed its planes
// there: the gate and the lockstep traceback of
// hga_tpu.models.correction._consensus_step_fn (votes_into) and
// hga_tpu.ops.pileup.accumulate_backbone_votes_myers.  Per pair:
//   1. the DP: dist = min_j D[m][j] over the columns j < tlen and tend = the
//      smallest such j (1-based), both 0 when qlen = 0, and the Pv/Mv words
//      after every target column, kept on chip;
//   2. the gate: ok = dist <= max_ed && qlen > 0 && tend > 0 with
//      max_ed = (int)(frac * (float)qlen) in float32 (round-to-nearest
//      product, truncation), frac the float32 value of 1 - min_identity;
//   3. the walk from (qlen, tend, dist) for at most `steps` moves, diag >
//      up > left, each move's column or insertion vote an int32 atomicAdd
//      into the flat vote buffer, weighted by qw[i - 1] (1 without qw).
//      Votes the reference sends to its sink (index size_all) are skipped.
//      A walk that reaches column 0 stops there: every vote needs j >= 1,
//      so the moves the reference takes after it cast nothing.
//
// Design: one warp a block, one pair on a group of G lanes (the smallest
// power of two >= W, at most 32), 32 / G pairs a warp; lane w holds query
// words w * WL .. w * WL + WL - 1 on the A = ceil(W / WL) lanes that hold
// words; a spare word past W (where WL does not divide W) computes on empty
// planes and stores nothing.  Two routes: the register route (W 1-34, WL
// compiled in: one word a lane up to W 32, two at W 33 and 34, the
// short-read route's pads up to 1024) keeps a lane's words in registers;
// the wide route (WL = 0 in the template: any W at run time, G = 32, WL =
// ceil(W / 32)) keeps each lane's q0, q1, vq, pv and mv words in memory,
// lane-interleaved (word k of lane w at k * 32 + w), in the block's dynamic
// shared memory after its staged targets where they fit, else in a device
// scratch; its planes live on the device scratch.
//   - The DP is K1''s split layout (csrc/myers_gate.cu): the query planes
//     are built in the kernel from the row-major (N, Lq) codes by
//     ops/myers.query_planes' rule bit for bit; at step s lane w runs target
//     column s - w for its words with the three carries lane w - 1 left at
//     step s - 1 (one packed __shfl_up_sync); targets are staged per warp
//     as int8 codes.
//   - Each column's (Pv, Mv) word pair goes to a plane row of the pair,
//     (column, word) major, in shared memory (SMEM), or in a device
//     scratch (!SMEM), the same kernel, chosen by shape: shared memory only
//     where it holds 4 such blocks an SM or more (the correction shape; at
//     band 64 W 1-6 and 9); with fewer, each step's dependent chain is left
//     bare, and the scratch, at 32 warps an SM, ran 1.6-3.2x faster
//     (ops/myers_cuda.votes_route).  Pair rows are a multiple of 32 words
//     plus 2 G apart, so the groups of a warp store to distinct banks at W
//     1, 2 and 4.  The wrapper cuts a batch whose scratch planes pass its
//     memory budget into sub-batches, one launch each (the votes are int32
//     atomic adds, so the cut changes no vote).
//   - The traceback runs on all G lanes of the pair in lockstep: lane w
//     takes the masked popcounts of its words of column j - 1, a butterfly of
//     __shfl_xor_sync sums them (D(i, j - 1)), every lane reads the two
//     vertical-delta bits and derives the same move; lane 0 of the group
//     casts the votes.  The warp loops while any of its pairs is active.
//
// What bounds it: integer throughput, ~20 operations per word, column and
// pair in the DP and about 40 a traceback step; bytes are the codes, the
// weights and the vote atomics (no planes leave the SM).  At the
// correction shape (Lq 112, W 4, Lt 184) a warp's planes take 47 KB, so
// shared memory caps residency at 4 warps an SM and nothing hides the
// latency of each step's dependent chain; one batch of 4096 pairs is about
// one wave on 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M31 = 0x7fffffffu;
constexpr int kPayload = 31;
constexpr int kChunk = 128;             // target columns staged at a time
constexpr int kRegMaxWords = 34;        // the register route's W
constexpr int kPerMax = (kChunk + 31 + 31) / 32;  // rounds a row (A <= 32)
constexpr int kPlanes = 5;              // q0, q1, vq, pv, mv: a word's state
constexpr int kNSym = 6;                // column vote symbols (ops/pileup)
constexpr unsigned kFull = 0xffffffffu;

constexpr int group_of(int W) {         // the smallest power of two >= W
  return W <= 1 ? 1 : W <= 2 ? 2 : W <= 4 ? 4 : W <= 8 ? 8 : W <= 16 ? 16
                                                                     : 32;
}

// bytes of a staged target row: kChunk + A - 1 columns (A lanes hold
// words), an odd number of 4-byte words so that the groups read distinct
// banks
__host__ __device__ inline int stage_row(int A) {
  return ((kChunk + A - 1 + 3) / 4 | 1) * 4;
}

__host__ __device__ inline int lanes_of(int W, int WL) {
  return (W + WL - 1) / WL;
}

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

template <int G, int WL_, bool SMEM>
__global__ void __launch_bounds__(32)
myers_votes_kernel(const int32_t* __restrict__ q,      // (N, Lq)
                   const int32_t* __restrict__ t,      // (N, Lt)
                   const int32_t* __restrict__ qlen,
                   const int32_t* __restrict__ tlen,
                   const int32_t* __restrict__ bb,
                   const int32_t* __restrict__ off,
                   const int32_t* __restrict__ lb,     // (N,)
                   const int32_t* __restrict__ qw,     // (N, Lq) or null
                   int N, int Lq, int Lt, int W, int wl, int stride,
                   int steps, int ins_slots, long long lpad, long long size_v,
                   long long size_all, float frac,
                   int32_t* __restrict__ dist, int32_t* __restrict__ tend,
                   int32_t* __restrict__ merged,
                   uint32_t* __restrict__ scratch,
                   uint32_t* __restrict__ words) {
  constexpr int P = 32 / G;                // pairs a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int WL = WL_ > 0 ? WL_ : wl;       // words a lane
  const int lane = threadIdx.x;
  const int g = lane / G;                  // the warp's pair of this lane
  const int w = lane % G;                  // this lane's place in its group
  const int n = blockIdx.x * P + g;
  const bool live = n < N;
  const int A = lanes_of(W, WL);           // lanes that hold words
  const int ROW = stage_row(A);
  const int SPAN = kChunk + A - 1;
  uint2* planes;                           // this pair's (column, word) row
  int8_t* rows;                            // the warp's staged targets
  if constexpr (SMEM) {
    planes = reinterpret_cast<uint2*>(reinterpret_cast<uint32_t*>(smem) +
                                      static_cast<size_t>(g) * stride);
    rows = reinterpret_cast<int8_t*>(smem) +
           static_cast<size_t>(P) * stride * 4;
  } else {
    planes = reinterpret_cast<uint2*>(
        scratch + (static_cast<size_t>(blockIdx.x) * P + g) * stride);
    rows = reinterpret_cast<int8_t*>(smem);
  }
  const int ql = live ? qlen[n] : 0;
  const int tl = live ? tlen[n] : 0;

  // ---- this lane's query words: ops/myers.query_planes' rule, bit for bit
  Words<WL_> ws;
  if constexpr (WL_ == 0) {
    // P = 1: after the staged row (a multiple of 4 bytes), or the scratch
    ws.wl = WL;
    ws.base = (words != nullptr
                   ? words + static_cast<size_t>(blockIdx.x) * kPlanes * WL * 32
                   : reinterpret_cast<uint32_t*>(smem + ROW)) + lane;
  }
  int ek = -1;                             // the end bit's word on this lane
  uint32_t ebit = 0u;
#pragma unroll
  for (int k = 0; k < WL; ++k) {
    const int wi = w * WL + k;
    uint32_t b0 = 0u, b1 = 0u, bv = 0u;
    if (live && wi < W) {
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
        ek = k;
        ebit = 1u << ((ql - 1) % kPayload);
      }
    }
    ws.at(0, k) = b0;
    ws.at(1, k) = b1;
    ws.at(2, k) = bv;
    ws.at(3, k) = M31;
    ws.at(4, k) = 0u;
  }

  // ---- the DP: lane w's words on column s - w at step s
  int score = ql, best = ql, bj = 0;
  uint32_t out = 0u;           // carries out of this lane's last word
  const int dp_steps = Lt + A - 1;
  const int8_t* mine = rows + g * ROW + (A - 1 - w);
  for (int s0 = 0; s0 < dp_steps; s0 += kChunk) {
    // stage columns s0 - (A - 1) .. s0 + kChunk - 1 of the warp's pairs,
    // 32 neighbouring columns of one row a round, many rounds in flight
    __syncwarp();
    const int c0 = s0 - (A - 1);
#pragma unroll 16
    for (int it = 0; it < P * kPerMax; ++it) {
      const int pp = it / kPerMax, c = (it % kPerMax) * 32 + lane;
      const int m = blockIdx.x * P + pp, col = c0 + c;
      int code = 4;
      if (c < SPAN && m < N && col >= 0 && col < Lt) {
        code = t[static_cast<size_t>(m) * Lt + col];
        code = (code >= 0 && code < 4) ? code : 4;
      }
      if (c < SPAN) rows[pp * ROW + c] = static_cast<int8_t>(code);
    }
    __syncwarp();
    const int send = min(kChunk, dp_steps - s0);
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
          if (k == ek) {
            pb = ph & ebit;
            mb = mh & ebit;
          }
          const uint32_t ncp = (ph >> 30) & 1u;  // shift carries out of bit 30
          const uint32_t ncm = (mh >> 30) & 1u;
          ph = ((ph << 1) & M31) | cp;
          mh = ((mh << 1) & M31) | cm;
          cp = ncp;
          cm = ncm;
          const uint32_t npv = (mh | ~(xv | ph)) & M31, nmv = ph & xv;
          ws.at(3, k) = npv;
          ws.at(4, k) = nmv;
          const int wi = w * WL + k;
          if (wi < W) planes[static_cast<size_t>(j) * W + wi] =
                          make_uint2(npv, nmv);
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
  __syncwarp();                 // the pair's planes, visible to its lanes

  // ---- dist and tend from the lane whose word holds the end bit
  const int e = ql > 0 ? (ql - 1) / kPayload : 0;
  const int writer = (ql > 0 && e < W) ? e / WL : 0;
  const int d_best = __shfl_sync(kFull, best, g * G + writer);
  const int d_bj = __shfl_sync(kFull, bj, g * G + writer);
  const int dres = ql == 0 ? 0 : d_best;
  const int tres = ql == 0 ? 0 : d_bj;
  if (live && w == writer) {
    dist[n] = dres;
    tend[n] = tres;
  }

  // ---- the gate, in float32 as the reference computes it
  const int max_ed = __float2int_rz(__fmul_rn(frac, __int2float_rn(ql)));
  bool active = live && dres <= max_ed && ql > 0 && tres > 0;
  int i = ql, j = tres, D = dres, run = 0;

  // ---- the walk and the votes
  const int32_t* qrow = q + static_cast<size_t>(live ? n : 0) * Lq;
  const int32_t* trow = t + static_cast<size_t>(live ? n : 0) * Lt;
  const long long bbn = live ? bb[n] : 0;
  const long long offn = live ? off[n] : 0;
  const long long lbn = live ? lb[n] : 0;
  const long long base_v = bbn * (lpad * kNSym);
  const long long base_i = bbn * (lpad * ins_slots * 4) + size_v;
  for (int step = 0; step < steps; ++step) {
    if (!__any_sync(kFull, active)) break;
    const size_t jm1 = min(max(j - 1, 0), Lt - 1);
    const size_t jm2 = min(max(j - 2, 0), Lt - 1);
    // D(i, j - 1): this lane's share of the prefix popcount of column j - 1
    int part = 0;
#pragma unroll
    for (int k = 0; k < WL; ++k) {
      const int wi = w * WL + k;
      if (wi < W) {
        const int nbits = min(max(i - kPayload * wi, 0), kPayload);
        const uint32_t mask = (1u << nbits) - 1u;
        const uint2 c = planes[jm2 * W + wi];
        part += __popc(c.x & mask) - __popc(c.y & mask);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      part += __shfl_xor_sync(kFull, part, o, G);
    }
    // vertical deltas at row i of columns j and j - 1 (bit i - 1)
    int dv_j = 0, dv_jm1 = 0;
    const int wi = (i - 1) / kPayload;
    if (i >= 1 && wi < W) {
      const int bi = (i - 1) % kPayload;
      const uint2 a = planes[jm1 * W + wi];
      const uint2 b = planes[jm2 * W + wi];
      dv_j = static_cast<int>((a.x >> bi) & 1u) -
             static_cast<int>((a.y >> bi) & 1u);
      dv_jm1 = static_cast<int>((b.x >> bi) & 1u) -
               static_cast<int>((b.y >> bi) & 1u);
    }
    if (j < 1) dv_j = 1;                  // column 0 holds D(i, 0) = i
    const int dl = j >= 2 ? part : i;     // D(i, j - 1)
    if (j < 2) dv_jm1 = 1;
    const int dd = dl - dv_jm1;           // D(i - 1, j - 1)
    const int qi = min(max(i - 1, 0), Lq - 1);
    const int qsym = active ? qrow[qi] : 0;
    const int tsym = active ? trow[jm1] : 0;
    const int sub = (qsym != tsym || qsym >= 4 || tsym >= 4) ? 1 : 0;
    const bool diag = active && j >= 1 && dd + sub == D;
    const bool up = active && dv_j == 1 && !diag;
    const bool left = active && j >= 1 && dl + 1 == D && !diag && !up;
    if (w == 0 && (diag || up || left)) {
      const long long colf = static_cast<long long>(j - 1) + offn;
      const bool in_rng = colf >= 0 && colf < lbn;
      const int wt = qw != nullptr ? qw[static_cast<size_t>(n) * Lq + qi] : 1;
      if ((diag || left) && in_rng) {
        const long long idx = base_v + colf * kNSym + (diag ? qsym : 4);
        if (idx >= 0 && idx < size_all) atomicAdd(merged + idx, wt);
      }
      if (up && in_rng && run < ins_slots && j >= 1) {
        const long long idx =
            base_i + (colf * ins_slots + min(max(run, 0), ins_slots - 1)) * 4 +
            min(max(qsym, 0), 3);
        if (idx >= 0 && idx < size_all) atomicAdd(merged + idx, wt);
      }
    }
    run = up ? run + 1 : 0;
    D -= diag ? sub : ((up || left) ? 1 : 0);
    i -= (diag || up) ? 1 : 0;
    j -= (diag || left) ? 1 : 0;
    active = active && (diag || up || left) && i >= 1 && j >= 1;
  }
}

// the instantiations (G, WL): (group_of(W), 1) up to W 32, (32, 2) at W
// 33-34, each with its planes in shared memory and in the scratch; the wide
// route (32, 0), planes in the scratch
#define HGA_INSTANCES(X) X(1, 1) X(2, 1) X(4, 1) X(8, 1) X(16, 1) X(32, 1) \
  X(32, 2)

inline int words_a_lane(int W) {
  const int G = group_of(W);
  return (W + G - 1) / G;
}

// Calls f(the instantiation for W, the plane home and the route (wl > 0:
// the wide route)).
template <class F>
cudaError_t dispatch(int W, int wl, bool scratch, F&& f) {
  if (wl > 0) {
    if (W < 1 || wl != (W + 31) / 32 || !scratch) {
      return cudaErrorInvalidValue;
    }
    return f(myers_votes_kernel<32, 0, false>);
  }
  if (W < 1 || W > kRegMaxWords) return cudaErrorInvalidValue;
  const int G = group_of(W), l = words_a_lane(W);
#define HGA_CASE(g, k)                                                 \
  if (G == g && l == k) {                                              \
    return scratch ? f(myers_votes_kernel<g, k, false>)                \
                   : f(myers_votes_kernel<g, k, true>);                \
  }
  HGA_INSTANCES(HGA_CASE)
#undef HGA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K2' on `stream`: q, t int32 (N, Lq), (N, Lt) row-major; qlen,
// tlen, bb, off, lb int32 (N,); qw int32 (N, Lq) or null; merged int32
// (size_all + 1,) updated in place (the last slot, the sink, untouched).
// W = ceil(Lq / 31) words, G = group_of(W); the register route (wl = 0) at
// W 1-34, the wide route (wl = ceil(W / 32), planes in the scratch) at any
// W.  `stride` words (even, >= 2 W Lt) a pair's plane row; `smem` dynamic
// bytes a block, at least what the route needs: 32 / G rows and the stage,
// or the stage alone with a scratch of (N rounded up to 32 / G) x stride
// words, and on the wide route with words = null the stage and 5 x wl x 32
// words (else `words` is a scratch of N x 5 x wl x 32).  Returns the
// launch's cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue
// without launching.
int hga_myers_votes_launch(const void* q, const void* t, const void* qlen,
                           const void* tlen, const void* bb, const void* off,
                           const void* lb, const void* qw, int N, int Lq,
                           int Lt, int W, int G, int wl, int stride,
                           int steps, int ins_slots, int smem,
                           long long lpad, long long size_v,
                           long long size_all, float frac, void* dist,
                           void* tend, void* merged, void* scratch,
                           void* words, void* stream) {
  if (W < 1 || G != group_of(W) || wl < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = 32 / G;
  const int A = lanes_of(W, wl > 0 ? wl : words_a_lane(W));
  const long long need =
      (scratch == nullptr ? static_cast<long long>(P) * stride * 4 : 0) +
      static_cast<long long>(P) * stage_row(A) +
      (wl > 0 && words == nullptr ? 4LL * kPlanes * wl * 32 : 0);
  if (N <= 0 || Lq < 0 || Lt < 0 || Lq > W * kPayload || stride % 2 != 0 ||
      static_cast<long long>(stride) < 2LL * W * Lt || steps < 0 ||
      ins_slots < 1 || smem < need || size_all < size_v || size_v < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto in = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(W, wl, scratch != nullptr, [&](auto k) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    k<<<(N + P - 1) / P, 32, smem, s>>>(
        in(q), in(t), in(qlen), in(tlen), in(bb), in(off), in(lb), in(qw), N,
        Lq, Lt, W, wl, stride, steps, ins_slots, lpad, size_v, size_all, frac,
        static_cast<int32_t*>(dist), static_cast<int32_t*>(tend),
        static_cast<int32_t*>(merged), static_cast<uint32_t*>(scratch),
        static_cast<uint32_t*>(words));
    return cudaGetLastError();
  }));
}

// Registers per thread and local (spill) bytes per thread of W's
// instantiation (scratch 0 = planes in shared memory; wl > 0 the wide
// route).
int hga_myers_votes_attrs(int W, int wl, int scratch, int* regs,
                          int* local_bytes) {
  cudaFuncAttributes fa{};
  const cudaError_t e = dispatch(W, wl, scratch != 0, [&](auto k) {
    return cudaFuncGetAttributes(&fa, k);
  });
  if (e == cudaSuccess) {
    *regs = fa.numRegs;
    *local_bytes = static_cast<int>(fa.localSizeBytes);
  }
  return static_cast<int>(e);
}

// Blocks (one warp each) resident on an SM at `smem` dynamic bytes a block.
int hga_myers_votes_occupancy(int W, int wl, int scratch, int smem,
                              int* blocks) {
  return static_cast<int>(dispatch(W, wl, scratch != 0, [&](auto k) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, 32, smem);
  }));
}

}  // extern "C"
