// One correction batch in one launch, for Hopper (sm_90a): the Myers planes
// DP, the identity gate, the plane traceback and the vote scatter.
//
// K2' (myers_votes_kernel<G, SMEM>) replaces the Pallas kernel
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
// words w * WL .. w * WL + WL - 1: one word (WL = 1) up to W 32, two at W 33
// and 34 (the short-read route's pads up to 1024), on A = ceil(W / WL)
// lanes; a spare word past W (the last lane at W 33) computes on empty
// planes and stores nothing.
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
//     1, 2 and 4.
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
constexpr int kMaxWords = 34;
constexpr int kPerMax = (kChunk + kMaxWords - 1 + 31) / 32;  // rounds a row
constexpr int kNSym = 6;                // column vote symbols (ops/pileup)
constexpr unsigned kFull = 0xffffffffu;

constexpr int group_of(int W) {         // the smallest power of two >= W
  return W <= 1 ? 1 : W <= 2 ? 2 : W <= 4 ? 4 : W <= 8 ? 8 : W <= 16 ? 16
                                                                     : 32;
}

// bytes of a staged target row: kChunk + W - 1 columns, an odd number of
// 4-byte words so that the groups read distinct banks
__host__ __device__ inline int stage_row(int W) {
  return ((kChunk + W - 1 + 3) / 4 | 1) * 4;
}

template <int G, int WL, bool SMEM>
__global__ void __launch_bounds__(32)
myers_votes_kernel(const int32_t* __restrict__ q,      // (N, Lq)
                   const int32_t* __restrict__ t,      // (N, Lt)
                   const int32_t* __restrict__ qlen,
                   const int32_t* __restrict__ tlen,
                   const int32_t* __restrict__ bb,
                   const int32_t* __restrict__ off,
                   const int32_t* __restrict__ lb,     // (N,)
                   const int32_t* __restrict__ qw,     // (N, Lq) or null
                   int N, int Lq, int Lt, int W, int stride, int steps,
                   int ins_slots, long long lpad, long long size_v,
                   long long size_all, float frac,
                   int32_t* __restrict__ dist, int32_t* __restrict__ tend,
                   int32_t* __restrict__ merged,
                   uint32_t* __restrict__ scratch) {
  constexpr int P = 32 / G;                // pairs a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int g = lane / G;                  // the warp's pair of this lane
  const int w = lane % G;                  // this lane's place in its group
  const int n = blockIdx.x * P + g;
  const bool live = n < N;
  const int A = (W + WL - 1) / WL;         // lanes that hold words
  const int ROW = stage_row(W);
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
  uint32_t q0[WL], q1[WL], vq[WL], mend[WL], pv[WL], mv[WL];
#pragma unroll
  for (int k = 0; k < WL; ++k) {
    const int wi = w * WL + k;
    uint32_t b0 = 0u, b1 = 0u, bv = 0u, me = 0u;
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
          const int wi = w * WL + k;
          if (wi < W) planes[j * W + wi] = make_uint2(pv[k], mv[k]);
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
    const int jm1 = min(max(j - 1, 0), Lt - 1);
    const int jm2 = min(max(j - 2, 0), Lt - 1);
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

template <int G, int WL, bool SMEM>
cudaError_t launch_g(const int32_t* const* in, int N, int Lq, int Lt, int W,
                     int stride, int steps, int ins_slots, int smem,
                     long long lpad, long long size_v, long long size_all,
                     float frac, int32_t* dist, int32_t* tend,
                     int32_t* merged, uint32_t* scratch, cudaStream_t s) {
  constexpr int P = 32 / G;
  cudaError_t e = cudaFuncSetAttribute(
      myers_votes_kernel<G, WL, SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  myers_votes_kernel<G, WL, SMEM><<<(N + P - 1) / P, 32, smem, s>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], N, Lq, Lt, W,
      stride, steps, ins_slots, lpad, size_v, size_all, frac, dist, tend,
      merged, scratch);
  return cudaGetLastError();
}

template <int G, int WL, bool SMEM>
cudaError_t attrs_g(int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t e =
      cudaFuncGetAttributes(&a, myers_votes_kernel<G, WL, SMEM>);
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
  }
  return e;
}

template <int G, int WL, bool SMEM>
cudaError_t occupancy_g(int smem, int* blocks) {
  const cudaError_t e = cudaFuncSetAttribute(
      myers_votes_kernel<G, WL, SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, myers_votes_kernel<G, WL, SMEM>, 32, smem);
}

// the instantiations (G, WL): (group_of(W), 1) up to W 32, (32, 2) at W
// 33-34; each with its planes in shared memory and in the scratch
#define HGA_INSTANCES(X) X(1, 1) X(2, 1) X(4, 1) X(8, 1) X(16, 1) X(32, 1) \
  X(32, 2)

inline int words_a_lane(int W) {
  const int G = group_of(W);
  return (W + G - 1) / G;
}

}  // namespace

extern "C" {

// Launches K2' on `stream`: q, t int32 (N, Lq), (N, Lt) row-major; qlen,
// tlen, bb, off, lb int32 (N,); qw int32 (N, Lq) or null; merged int32
// (size_all + 1,) updated in place (the last slot, the sink, untouched).
// W = ceil(Lq / 31) words (1..34), G = group_of(W); `stride` words (even,
// >= 2 W Lt) a pair's plane row; `smem` dynamic bytes a block, at least
// what the route needs (32 / G rows and the stage, or the stage alone with
// a scratch of (N rounded up to 32 / G) x stride words).  Returns the
// launch's cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue
// without launching.
int hga_myers_votes_launch(const void* q, const void* t, const void* qlen,
                           const void* tlen, const void* bb, const void* off,
                           const void* lb, const void* qw, int N, int Lq,
                           int Lt, int W, int G, int stride, int steps,
                           int ins_slots, int smem, long long lpad,
                           long long size_v, long long size_all, float frac,
                           void* dist, void* tend, void* merged,
                           void* scratch, void* stream) {
  const int P = G > 0 ? 32 / G : 0;
  const long long need =
      (scratch == nullptr ? static_cast<long long>(P) * stride * 4 : 0) +
      static_cast<long long>(P) * stage_row(W);
  if (N <= 0 || Lq < 0 || Lt < 0 || W < 1 || W > kMaxWords ||
      Lq > W * kPayload || G != group_of(W) || stride % 2 != 0 ||
      static_cast<long long>(stride) < 2LL * W * Lt || steps < 0 ||
      ins_slots < 1 || smem < need || size_all < size_v || size_v < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  const int32_t* in[8];
  const void* src[8] = {q, t, qlen, tlen, bb, off, lb, qw};
  for (int k = 0; k < 8; ++k) in[k] = static_cast<const int32_t*>(src[k]);
  auto* d = static_cast<int32_t*>(dist);
  auto* te = static_cast<int32_t*>(tend);
  auto* m = static_cast<int32_t*>(merged);
  auto* sc = static_cast<uint32_t*>(scratch);
  const int wl = words_a_lane(W);
#define HGA_CASE(g, l)                                                       \
  if (G == g && wl == l) {                                                   \
    return static_cast<int>(                                                 \
        sc == nullptr                                                        \
            ? launch_g<g, l, true>(in, N, Lq, Lt, W, stride, steps,          \
                                   ins_slots, smem, lpad, size_v, size_all,  \
                                   frac, d, te, m, sc, s)                    \
            : launch_g<g, l, false>(in, N, Lq, Lt, W, stride, steps,         \
                                    ins_slots, smem, lpad, size_v, size_all, \
                                    frac, d, te, m, sc, s));                 \
  }
  HGA_INSTANCES(HGA_CASE)
#undef HGA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread and local (spill) bytes per thread of W's
// instantiation (scratch 0 = planes in shared memory).
int hga_myers_votes_attrs(int W, int scratch, int* regs, int* local_bytes) {
  if (W < 1 || W > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const int G = group_of(W), wl = words_a_lane(W);
#define HGA_CASE(g, l)                                                    \
  if (G == g && wl == l) {                                                \
    return static_cast<int>(scratch ? attrs_g<g, l, false>(regs, local_bytes) \
                                    : attrs_g<g, l, true>(regs, local_bytes)); \
  }
  HGA_INSTANCES(HGA_CASE)
#undef HGA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks (one warp each) resident on an SM at `smem` dynamic bytes a block.
int hga_myers_votes_occupancy(int W, int scratch, int smem, int* blocks) {
  if (W < 1 || W > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const int G = group_of(W), wl = words_a_lane(W);
#define HGA_CASE(g, l)                                                     \
  if (G == g && wl == l) {                                                 \
    return static_cast<int>(scratch ? occupancy_g<g, l, false>(smem, blocks) \
                                    : occupancy_g<g, l, true>(smem, blocks)); \
  }
  HGA_INSTANCES(HGA_CASE)
#undef HGA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
