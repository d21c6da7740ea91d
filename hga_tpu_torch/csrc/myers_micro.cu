// Myers semi-global edit distance from precomputed query bit-planes, a pair
// split across lanes, with target slabs staged by asynchronous copies, for
// Hopper (sm_90a).
//
// X1 (myers_slab_kernel<WL>) replaces the Pallas kernel `_kernel_b`
// (exp/myers_micro.py:58): K1's function — per pair, dist = min_j D[m][j]
// over the columns j < tlen and tend = the smallest such j (1-based), both 0
// when qlen = 0 — from the query planes q0, q1, vq, mend (ops/myers
// .query_planes, int32 (N, W) row-major) and the targets (int32 (N, Lt)
// row-major), read in slabs of BLK columns.  On the TPU the slab amortised
// the loop carry and the dynamic addressing of one column a step; here it
// is what an asynchronous copy brings in while the last slab is consumed.
//
// Design:
//   - A pair across lanes: WL = ceil(W / 32) words a lane on A = ceil(W /
//     WL) lanes, P = floor(32 / A) pairs a warp packed side by side (groups
//     of A lanes, not of a power of two: at W 5, 6 pairs on 30 lanes); at W
//     1 a lane is a pair.  A spare word past W (where WL does not divide W)
//     has empty planes and touches nothing below it.  No word cap: WL 1-4
//     keep a lane's six planes (q0, q1, vq, mend, pv, mv) in registers (W up
//     to 128); past that (WL = 0 in the template) they live in a device
//     scratch the wrapper allocates, lane-interleaved (word k of plane p at
//     (p WL + k) 32 + lane, so a warp's access is one 128-byte line).
//   - The skewed schedule (K1''s): at step s, lane w runs column j = s - w
//     for its words.  It takes from lane w - 1, one __shfl_up_sync each,
//     what that lane produced for column j at step s - 1: the adder carry
//     out of bit 31, its last word's Ph << 1 and Mh << 1 (bit 31 is the
//     shift carry out of bit 30, taken in by a funnel shift), and the ORs
//     so far of (Ph & mend) and (Mh & mend) over the words below; lane 0 of
//     a group masks all five to 0.  So the last lane of a group holds the
//     whole OR for its column, and its score and (best, bj) over columns j
//     < tlen (strict <) are the pair's: every lane runs the same
//     branch-free bookkeeping on what it holds, a step's state commits only
//     on the lane's own column, and the last lane alone writes the result.
//     mend is read as a plane, any bits in any words, as the plain version
//     reads it.  Lt + A - 1 steps, unrolled by 4.
//   - Match masks: on the register route each lane builds, once a pair, the
//     match mask of every code for each of its words (vq & ~(q0 ^ c0 | q1 ^
//     c1) for codes 0..3, 0 for any other code) in a table in shared memory,
//     lane-interleaved, so a step reads its word's mask with one load
//     indexed by min(code, 4) instead of decoding the code.
//   - Target slabs: each warp stages its own pairs' slabs, so no block
//     barrier is needed.  Slab b holds columns b BLK - (A - 1) ..
//     (b + 1) BLK - 1 (the skew's A - 1 columns of halo) of the warp's P
//     pairs, as int32 codes (codes outside 0..3 match nothing, as they
//     arrive), one row a pair whose pitch is A mod 32 words so the groups'
//     lanes read 32 distinct banks.  The copies are cp.async (4 bytes, any
//     alignment: a row of the caller's targets starts anywhere) by the
//     warp's lanes, 32 neighbouring columns of a row a round, completed on
//     an mbarrier a buffer (cp.async.mbarrier.arrive.noinc, 32 arrivals).
//     Two buffers: slab b + 1 lands while slab b runs; after slab b's steps
//     a __syncwarp frees its buffer for slab b + 2.
//   - S pairs: a block holds 16 S pairs (the port's meaning of the
//     reference's S), ceil(16 S / P) groups of P pairs; a block has
//     min(groups, 32) warps and warp i runs groups i, i + warps, ... in
//     turn, so any S launches.
//   - Word arithmetic as K1 and K1' (uint32 words; the block sum overflows
//     bit 31 by design; results masked to 31 bits).
//
// What bounds it: about 20 int32 operations per word, column and pair
// (integer issue rate), serial along the columns of a pair.  Splitting the
// words over lanes turns a pair's W-word chain a column into a one-word
// chain a step plus a shuffle, and packing groups of A lanes keeps up to
// 32 of 32 lanes busy (K1''s power-of-two groups keep 20 of 32 at W 5).
// The wrapper reads the caller's planes and targets as they are: no
// transposed and no int8 copy a call.  The cost over the bound is what a
// lane does beside its word a step (five shuffles, two shared loads, the
// commit and the score: about as many instructions again), and, at few
// blocks (16 S pairs a block, 32 blocks at N 4096 and S 8), the SMs left
// idle.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M31 = 0x7fffffffu;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;           // 1024 threads a block
constexpr int kSmemMax = 232448;        // bytes of shared memory a block may opt in
constexpr int kPlanes = 6;              // q0, q1, vq, mend, pv, mv
constexpr int kRegWords = 4;            // words a lane in registers: W <= 128
constexpr int kBarBytes = kMaxWarps * 2 * 8;  // the static mbarriers

struct SlabArgs {
  const int32_t* q0;
  const int32_t* q1;
  const int32_t* vq;
  const int32_t* mend;   // (N, W) each
  const int32_t* t;      // (N, Lt)
  const int32_t* qlen;
  const int32_t* tlen;   // (N,)
  int32_t* dist;
  int32_t* tend;
  uint32_t* words;       // WL = 0: (blocks, warps, 6, wl, 32); else null
  int N, Lt, W, wl, A, P, pairs, blk, row, warps;
};

// A lane's words: registers (WL > 0) ...
template <int WL>
struct Words {
  uint32_t v[kPlanes][WL];
  __device__ __forceinline__ uint32_t& at(int p, int k) { return v[p][k]; }
};

// ... or the device scratch (WL = 0): `base` is this lane's first word
template <>
struct Words<0> {
  uint32_t* base;
  int wl;
  __device__ __forceinline__ uint32_t& at(int p, int k) {
    return base[(p * wl + k) * 32];
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// 4 bytes global -> shared, asynchronous (LDGSTS)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the barrier takes one arrival of this lane once its copies so far land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// int32 words of shared memory a warp's match-mask table takes: five codes
// (0..3, and every other) x WL words x 32 lanes on the register route
__host__ __device__ constexpr int peq_words(int WL) {
  return WL > 0 && WL <= kRegWords ? 5 * WL * 32 : 0;
}

template <int WL_>
__global__ void __launch_bounds__(kMaxWarps * 32)
myers_slab_kernel(const SlabArgs a) {
  extern __shared__ __align__(16) int32_t slab_smem[];
  __shared__ __align__(8) uint64_t bars[kMaxWarps][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = a.W, A = a.A, P = a.P, blk = a.blk;
  const int WL = WL_ > 0 ? WL_ : a.wl;
  const int g = lane / A;                  // the group's pair of this lane
  const int w = lane - g * A;              // its word lane in the pair
  const int span = blk + A - 1;            // columns a staged row
  int32_t* bufs = slab_smem + warp * (2 * P * a.row + peq_words(WL_));
  // this lane's match masks: mask of code c for word k at (c WL + k) 32
  uint32_t* peq = reinterpret_cast<uint32_t*>(bufs + 2 * P * a.row) + lane;
  uint64_t* bar = bars[warp];
  if (lane == 0) {
    mbar_init(&bar[0], 32);
    mbar_init(&bar[1], 32);
  }
  __syncwarp();
  unsigned phase = 0u;                     // each buffer's next parity
  Words<WL_> ws;
  if constexpr (WL_ == 0) {
    ws.wl = WL;
    ws.base = a.words +
              (static_cast<size_t>(blockIdx.x) * a.warps + warp) * kPlanes *
                  WL * 32 +
              lane;
  }
  // what lane 0 of a group keeps of the lane below: nothing
  const uint32_t keep = w > 0 ? 0xffffffffu : 0u;
  const uint32_t m0 = w > 0 ? M31 : M31 & ~1u;   // word 0's shifted Ph, Mh
  const int groups = (a.pairs + P - 1) / P;
  const int steps = a.Lt + A - 1;
  const int nslab = (steps + blk - 1) / blk;
  for (int gi = warp; gi < groups; gi += a.warps) {
    const int pb = blockIdx.x * a.pairs + gi * P;      // the group's pair 0
    const int np = min(P, min(a.pairs - gi * P, a.N - pb));
    if (np <= 0) continue;                 // uniform across the warp
    const int n = pb + g;
    const bool live = g < np;
#pragma unroll
    for (int k = 0; k < WL; ++k) {
      const int wi = w * WL + k;
      const bool mine = live && wi < W;
      const size_t at = static_cast<size_t>(n) * W + wi;
      const uint32_t q0 = mine ? static_cast<uint32_t>(__ldg(a.q0 + at)) : 0u;
      const uint32_t q1 = mine ? static_cast<uint32_t>(__ldg(a.q1 + at)) : 0u;
      const uint32_t vq = mine ? static_cast<uint32_t>(__ldg(a.vq + at)) : 0u;
      if constexpr (WL_ > 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          peq[(c * WL + k) * 32] = vq & ~((q0 ^ (0u - (c & 1))) |
                                          (q1 ^ (0u - ((c >> 1) & 1))));
        }
        peq[(4 * WL + k) * 32] = 0u;       // codes outside 0..3
      } else {
        ws.at(0, k) = q0;
        ws.at(1, k) = q1;
        ws.at(2, k) = vq;
      }
      ws.at(3, k) = mine ? static_cast<uint32_t>(__ldg(a.mend + at)) : 0u;
      ws.at(4, k) = M31;
      ws.at(5, k) = 0u;
    }
    const int ql = live ? __ldg(a.qlen + n) : 0;
    const int tl = live ? __ldg(a.tlen + n) : 0;
    int score = ql, best = ql, bj = 0;

    // slab b: columns b blk - (A - 1) .. (b + 1) blk - 1 of the np pairs
    auto stage = [&](int b) {
      int32_t* dst = bufs + (b & 1) * P * a.row;
      const int c0 = b * blk - (A - 1);
      for (int pp = 0; pp < np; ++pp) {
        const int32_t* src = a.t + static_cast<size_t>(pb + pp) * a.Lt;
        for (int r = lane; r < span; r += 32) {
          const int c = c0 + r;
          if (c >= 0 && c < a.Lt) cp_async4(dst + pp * a.row + r, src + c);
        }
      }
      cp_async_arrive(&bar[b & 1]);
    };
    stage(0);
    if (nslab > 1) stage(1);

    // sent to lane w + 1: the carry out of bit 31, the last word's Ph << 1
    // and Mh << 1 (bit 31: the carry out of bit 30), the ORs of Ph & mend
    // and Mh & mend over the words so far
    uint32_t o_c = 0u, o_p = 0u, o_m = 0u, o_pb = 0u, o_mb = 0u;
    for (int b = 0; b < nslab; ++b) {
      mbar_wait(&bar[b & 1], (phase >> (b & 1)) & 1u);
      phase ^= 1u << (b & 1);
      // an idle lane reads the group's first row (its steps commit nothing)
      const int32_t* mine = bufs + (b & 1) * P * a.row +
                            (g < P ? g : 0) * a.row + (A - 1 - w);
      const int s0 = b * blk;
      const int send = min(blk, steps - s0);
#pragma unroll 4
      for (int r = 0; r < send; ++r) {
        uint32_t cin = __shfl_up_sync(kFull, o_c, 1) & keep;
        uint32_t psh = __shfl_up_sync(kFull, o_p, 1);
        uint32_t msh = __shfl_up_sync(kFull, o_m, 1);
        uint32_t pbo = __shfl_up_sync(kFull, o_pb, 1) & keep;
        uint32_t mbo = __shfl_up_sync(kFull, o_mb, 1) & keep;
        const int jj = s0 + r - w;         // this lane's column
        const bool act = live && static_cast<unsigned>(jj) <
                                     static_cast<unsigned>(a.Lt);
        const int tc = mine[r];
        const unsigned cidx = min(static_cast<unsigned>(tc), 4u);
        uint32_t t0 = 0u, t1 = 0u, tvm = 0u;
        if constexpr (WL_ == 0) {
          t0 = 0u - static_cast<uint32_t>(tc & 1);
          t1 = 0u - static_cast<uint32_t>((tc >> 1) & 1);
          tvm = cidx < 4u ? 0xffffffffu : 0u;
        }
#pragma unroll
        for (int k = 0; k < WL; ++k) {
          const uint32_t pv = ws.at(4, k), mv = ws.at(5, k);
          uint32_t eq;
          if constexpr (WL_ > 0) {
            eq = peq[(cidx * WL + k) * 32];
          } else {
            eq = (ws.at(2, k) & ~((ws.at(0, k) ^ t0) | (ws.at(1, k) ^ t1))) &
                 tvm;
          }
          const uint32_t xv = eq | mv;
          const uint32_t sw = (eq & pv) + pv + cin;
          cin = sw >> 31;                  // adder carry out of bit 31
          const uint32_t xh = ((sw & M31) ^ pv) | eq;
          const uint32_t ph = mv | ~(xh | pv);
          const uint32_t mh = pv & xh;
          pbo |= ph & ws.at(3, k);
          mbo |= mh & ws.at(3, k);
          // shift in the word below's bit 30 (its Ph << 1's bit 31)
          const uint32_t msk = k == 0 ? m0 : M31;
          const uint32_t phs = __funnelshift_l(psh, ph, 1) & msk;
          const uint32_t mhs = __funnelshift_l(msh, mh, 1) & msk;
          psh = ph << 1;
          msh = mh << 1;
          const uint32_t npv = (mhs | ~(xv | phs)) & M31;
          const uint32_t nmv = phs & xv;
          ws.at(4, k) = act ? npv : pv;    // a step commits on its column
          ws.at(5, k) = act ? nmv : mv;
        }
        o_c = cin;
        o_p = psh;
        o_m = msh;
        o_pb = pbo;
        o_mb = mbo;
        // every lane runs the score on what it holds; the group's last
        // lane holds the whole column's ORs and alone writes the result
        const int ns = score + (pbo != 0u ? 1 : 0) - (mbo != 0u ? 1 : 0);
        score = act ? ns : score;
        const bool gain = act && ns < best && jj < tl;
        best = gain ? ns : best;
        bj = gain ? jj + 1 : bj;
      }
      __syncwarp();                        // slab b is consumed
      if (b + 2 < nslab) stage(b + 2);
    }
    if (live && w == A - 1) {
      a.dist[n] = ql == 0 ? 0 : best;
      a.tend[n] = ql == 0 ? 0 : bj;
    }
  }
}

// The launch geometry (the wrapper computes the same in
// exp/myers_micro.slab_geometry).
struct Geometry {
  int wl, A, P, warps, row;
  size_t smem;
};

Geometry geometry(int W, int pairs, int blk) {
  Geometry g;
  g.wl = (W + 31) / 32;
  g.A = (W + g.wl - 1) / g.wl;
  g.P = 32 / g.A;
  const int groups = (pairs + g.P - 1) / g.P;
  g.warps = groups < kMaxWarps ? groups : kMaxWarps;
  const int span = blk + g.A - 1;
  // the smallest pitch >= span that is A mod 32: the groups' lanes read
  // 32 distinct banks
  g.row = span + ((g.A - span) % 32 + 32) % 32;
  g.smem = static_cast<size_t>(g.warps) *
           (2 * g.P * g.row + peq_words(g.wl)) * 4;
  return g;
}

template <int WL>
cudaError_t launch_wl(const SlabArgs& a, int blocks, size_t smem,
                      cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      myers_slab_kernel<WL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  myers_slab_kernel<WL><<<blocks, a.warps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <class F>
cudaError_t dispatch(int wl, F&& f) {
  switch (wl <= kRegWords ? wl : 0) {
    case 1: return f(myers_slab_kernel<1>);
    case 2: return f(myers_slab_kernel<2>);
    case 3: return f(myers_slab_kernel<3>);
    case 4: return f(myers_slab_kernel<4>);
    default: return f(myers_slab_kernel<0>);
  }
}

}  // namespace

extern "C" {

// Launches X1 on `stream`: planes q0, q1, vq, mend int32 (N, W), targets t
// int32 (N, Lt), lengths (N,), all row-major as the caller holds them;
// `pairs` (16 S) pairs a block, slabs of `blk` columns.  Past W 128,
// `words` is a uint32 scratch of blocks x warps x 6 x ceil(W / 32) x 32
// (exp/myers_micro.slab_geometry); else null.  Returns the launch's
// cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue without
// launching (the slabs' shared memory past 227 KB a block among others).
int hga_myers_slab_launch(const void* q0, const void* q1, const void* vq,
                          const void* mend, const void* t, const void* qlen,
                          const void* tlen, int N, int Lt, int W, int pairs,
                          int blk, void* words, void* dist, void* tend,
                          void* stream) {
  if (N <= 0 || Lt < 0 || W < 1 || blk <= 0 || pairs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = geometry(W, pairs, blk);
  if (g.smem > static_cast<size_t>(kSmemMax - kBarBytes) ||
      (g.wl > kRegWords) != (words != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto c = [](const void* p) { return static_cast<const int32_t*>(p); };
  SlabArgs a{c(q0), c(q1), c(vq), c(mend), c(t), c(qlen), c(tlen),
             static_cast<int32_t*>(dist), static_cast<int32_t*>(tend),
             static_cast<uint32_t*>(words), N, Lt, W, g.wl, g.A, g.P,
             pairs, blk, g.row, g.warps};
  const int blocks = (N + pairs - 1) / pairs;
  auto* s = static_cast<cudaStream_t>(stream);
  switch (g.wl <= kRegWords ? g.wl : 0) {
    case 1: return static_cast<int>(launch_wl<1>(a, blocks, g.smem, s));
    case 2: return static_cast<int>(launch_wl<2>(a, blocks, g.smem, s));
    case 3: return static_cast<int>(launch_wl<3>(a, blocks, g.smem, s));
    case 4: return static_cast<int>(launch_wl<4>(a, blocks, g.smem, s));
    default: return static_cast<int>(launch_wl<0>(a, blocks, g.smem, s));
  }
}

// Registers per thread and local (spill) bytes per thread of the
// instantiation that runs W words, as the loaded module reports them.
int hga_myers_slab_attrs(int W, int* regs, int* local_bytes) {
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa{};
  const cudaError_t e = dispatch((W + 31) / 32, [&](auto kernel) {
    return cudaFuncGetAttributes(&fa, kernel);
  });
  if (e == cudaSuccess) {
    *regs = fa.numRegs;
    *local_bytes = static_cast<int>(fa.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
