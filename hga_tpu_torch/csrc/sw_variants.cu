// Banded local Smith-Waterman over the band window, for Hopper (sm_90a):
// the three layouts of the SW experiment harness.
//
// X2 replaces the three Pallas kernels of exp/sw_variants.py, reached
// through `sw_pallas_exp` (:170): `_kernel_v1` (:32, int32), `_kernel_v2`
// (:95, int16 state) and `_kernel_v3` (:326, int32 with G interleaved pair
// groups).  All three compute K3's function (csrc/sw.cu): per pair the best
// cell of the banded local DP (match, mismatch, linear gap; H = 0 on row and
// column 0; cells 1 <= i <= qlen, 1 <= j <= tlen, |j - i| <= band), ties to
// the highest H, then the smallest anti-diagonal d = i + j, then the
// smallest i; score, qend and tend (1-based), all 0 when no cell is
// positive.  Codes compare as integers (int16 in v2).
//
// The window.  A warp sweeps the anti-diagonals d, and on each one holds S
// slots, not the whole query:
//   - the band window (band + 1 < Lq): S = band + 1 slots on rows
//     i0(d) .. i0(d) + band, i0(d) = ceil((d - band) / 2), as K3'' does;
//     slot s holds (i0 + s, f - s) with f = d - i0.  i0 moves on every
//     other d (delta = (d - band) & 1): on a delta-0 step the up and left
//     neighbours are slots s - 1 and s of d - 1, on a delta-1 step slots s
//     and s + 1; the diagonal is slot s of d - 2.  The two parities run as
//     two unrolled steps, one shuffle each, the arrays trading roles.  Slot
//     band is out of the band on delta-1 steps and is zeroed there;
//   - the query (band + 1 >= Lq: the window would hold more rows than the
//     query has): S = Lq slots on rows 1 .. Lq, the up neighbour slot s - 1
//     of d - 1, left slot s of d - 1, the diagonal slot s - 1 of d - 2 (the
//     last step's up neighbours, kept).
// Cells outside the lengths and the band store 0 (per-slot bounds dlo <= d
// <= dhi), exact for local SW with gap <= 0.  Each slot keeps its best H and
// the first d that reached it (strict >); a reduction takes max H, min d,
// min slot (on one d the smallest slot is the smallest i).
//
// Codes: the query window and the reversed target window of each pair are
// staged in shared memory for a chunk of kChunk (256) anti-diagonals at a
// time (kChunk / 2 + Sw + 4 codes each, Sw the slots a pair sweeps;
// kChunk + Sw + 4 target codes on the query layout), -1 outside the codes,
// refilled as the band moves (K3''''s scheme), so a pair's shared memory
// grows with neither Lq nor Lt.  The
// operands are the caller's row-major int32 codes; the wrapper copies none.
//
// Three routes (exp/sw_variants.plan picks one from the shape):
//   swv_kernel<K, FLAGS>   int32, slots in registers.  G pairs a warp on
//     L = floor(32 / G) lanes each (v1: G 1, one pair a warp; v3: G 2, 4,
//     ... up to 32, the G pairs side by side in the warp and advanced in the
//     same step, each on its own window), K slots a lane, the smallest built
//     K with L K >= S.  v1's timing ablations (no_ts, no_s1, no_mask,
//     no_best, the reference's `_kernel_v1` flags) are compile-time FLAGS at
//     the ablation K, never compared.
//   swv_packed_kernel<H>   v2: two slots as the int16 halves of one 32-bit
//     register, H words a lane, one pair a warp (2 H x 32 >= S).  Each window
//     is staged at both halfword alignments (the codes, and the codes one
//     on), so every step reads the two codes of a word as one aligned word:
//     no funnel shift.  The code compare, the in-band masks and the best
//     update use 32-bit sign tricks on biased halves and one PRMT sign
//     spread each (no emulated __vcmp*2), the cell three DPX instructions.
//   swv_mem_kernel         past the register slots (S > L x 16, S > 512 in
//     v2, G > 32): the slots in memory.  A warp walks its G pairs, its 32
//     lanes over the G x S cells of a step, three rows of S + 2 int32 a pair
//     (d - 2, d - 1, d) and each slot's best, in the block's shared memory
//     or, past 227 KB a block, in a device scratch; one __syncwarp a step;
//     codes read from the caller's rows for the cells in the band only.
//
// What bounds it: about 12 integer operations per in-band cell (the
// harness's CostEstimate counts 12), but a warp does 32 K slot-steps a step
// whatever the band, so swept slots out of the band cost too.  Sweeping the
// band window instead of the query cuts them: at the timing shape (Lq 128,
// Lt 256, band 64) v1 sweeps 96 slots a step (K 3: 47% of its slot-steps in
// band) where the query layout swept 128 (35%); v3 at G 4 gives each pair
// 8 lanes of K 9, 72 slots (63%).  Bytes are small (codes read once, 12
// bytes written a pair).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSmemMax = 232448;   // bytes of shared memory a block may opt in
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;        // anti-diagonals one staged window serves
constexpr int kNoTs = 1, kNoS1 = 2, kNoMask = 4, kNoBest = 8;
constexpr int kRegSlots = 16;      // most slots a lane on the register route
constexpr int kPackedWords = 8;    // most packed words a lane (512 slots)
constexpr int kAblationK = 3;      // v1's ablations: the timing shape's K
constexpr uint32_t kSigns = 0x80008000u;

enum Route { kRegisters = 0, kPacked = 1, kMemory = 2 };

struct SwvArgs {
  const int32_t* q;      // (N, Lq)
  const int32_t* t;      // (N, Lt)
  const int32_t* qlen;
  const int32_t* tlen;   // (N,)
  int32_t* score;
  int32_t* qend;
  int32_t* tend;
  int32_t* scratch;      // the memory route's rows past 227 KB, else null
  int N, Lq, Lt, band, match, mismatch, gap;
  int G;                 // pairs a warp
  int L;                 // lanes a pair (register routes)
  int S;                 // slots a pair
  int query;             // 1: the query layout, 0: the band window
};

// ceil(x / 2) for either sign
__host__ __device__ __forceinline__ int ceil_half(int x) {
  return x >= 0 ? (x + 1) / 2 : -((-x) / 2);
}

// Codes a staged band window for Sw swept slots (even: int32 each on the
// int32 route; the packed route stages two int16 copies in the same room).
__host__ __device__ __forceinline__ int win_band(int Sw) {
  return (kChunk / 2 + Sw + 5) & ~1;
}

// int32 words of shared memory a pair on the register routes: the query
// and target band windows, or the query layout's target window of kChunk +
// Sw + 4 codes (two int16 copies in v2)
__host__ __device__ __forceinline__ int pair_words(int Sw) {
  return 2 * win_band(Sw);
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

// (max H, then min d, then min slot) over the L lanes of each group; lane
// lip 0 of a group gets its group's best (any L, groups side by side)
__device__ __forceinline__ Best group_best(Best b, int lip, int L) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v = __shfl_down_sync(kFull, b.v, o);
    const int d = __shfl_down_sync(kFull, b.d, o);
    const int p = __shfl_down_sync(kFull, b.p, o);
    if (lip + o < L) take(b, v, d, p);
  }
  return b;
}

__device__ __forceinline__ void store(const SwvArgs& a, Best b, int n) {
  const bool has = b.v > 0;
  const int qe = !has ? 0 : a.query ? b.p + 1 : ceil_half(b.d - a.band) + b.p;
  a.score[n] = b.v;
  a.qend[n] = qe;
  a.tend[n] = has ? b.d - qe : 0;
}

// the pair's last in-band anti-diagonal (1: none)
__device__ __forceinline__ int pair_dend(const SwvArgs& a, int ql, int tl) {
  return ql >= 1 ? ql + min(tl, ql + a.band) : 1;
}

// Per-slot bounds: cell of slot s on d is in the lengths and the band iff
// dlo <= d <= dhi (dhi -1: never), less slot band on delta-1 steps.
__device__ __forceinline__ void slot_bounds(const SwvArgs& a, bool live,
                                            int s, int ql, int tl, int& dlo,
                                            int& dhi) {
  const int band = a.band;
  if (a.query) {
    const int i = s + 1;
    dlo = i + max(1, i - band);
    dhi = (live && s < a.S && i <= ql) ? i + min(tl, i + band) : -1;
  } else {
    dlo = max(band - 2 * s + 1, 2 * s + 2 - band);
    dhi = (live && s <= band)
              ? min(2 * (ql - s) + band, 2 * (tl + s) + 1 - band)
              : -1;
  }
}

// Stage the windows of chunk dc for the warp's G pairs (all 32 lanes), wide
// enough for Sw swept slots: band: qs[x] = q[qb + x], ts[x] = t[tb - x];
// query: ts[x] = t[tb - x].  CODE is int32_t, or int16_t for the packed
// route's two copies (copy 1 one code on: q[qb + 1 + x], t[tb - 1 - x]).
template <typename CODE, bool TWO>
__device__ __forceinline__ void stage_chunk(const SwvArgs& a, int32_t* wbase,
                                            int pair0, int lane, int dc,
                                            int Sw) {
  const int PW = pair_words(Sw), WB = win_band(Sw);
  for (int gg = 0; gg < a.G; ++gg) {
    const int nn = pair0 + gg;
    if (nn >= a.N) break;
    int32_t* pw = wbase + gg * PW;
    const int32_t* qrow = a.q + static_cast<size_t>(nn) * a.Lq;
    const int32_t* trow = a.t + static_cast<size_t>(nn) * a.Lt;
    if (a.query) {
      const int tb = dc + kChunk - 1;
      const int len = kChunk + Sw + 4;
      CODE* ts = reinterpret_cast<CODE*>(pw);
      for (int x = lane; x < len; x += 32) {
        const int u = tb - x;
        ts[x] = static_cast<CODE>((u >= 0 && u < a.Lt) ? __ldg(trow + u) : -1);
        if (TWO) {
          ts[len + (len & 1) + x] = static_cast<CODE>(
              (u - 1 >= 0 && u - 1 < a.Lt) ? __ldg(trow + u - 1) : -1);
        }
      }
    } else {
      const int i0c = (dc - a.band) / 2;      // exact: dc - band is even
      const int qb = i0c - 1;
      const int tb = dc - i0c + kChunk / 2 - 1;
      CODE* qs = reinterpret_cast<CODE*>(pw);
      CODE* ts = reinterpret_cast<CODE*>(pw + WB);
      for (int x = lane; x < WB; x += 32) {
        const int u = qb + x, v = tb - x;
        qs[x] = static_cast<CODE>((u >= 0 && u < a.Lq) ? __ldg(qrow + u) : -1);
        ts[x] = static_cast<CODE>((v >= 0 && v < a.Lt) ? __ldg(trow + v) : -1);
        if (TWO) {
          qs[WB + x] = static_cast<CODE>(
              (u + 1 >= 0 && u + 1 < a.Lq) ? __ldg(qrow + u + 1) : -1);
          ts[WB + x] = static_cast<CODE>(
              (v - 1 >= 0 && v - 1 < a.Lt) ? __ldg(trow + v - 1) : -1);
        }
      }
    }
  }
}

// ------------------------------------------------------------ int32 route

// One anti-diagonal d.  MODE 0 / 1: the band window at delta 0 / 1, X holds
// the slots' H on d - 2 and takes d's, Y holds d - 1.  MODE 2: the query
// layout, X holds the last step's up neighbours (this step's diagonals) and
// takes this step's, Y holds d - 1 and takes d's.
template <int K, int MODE, int FLAGS>
__device__ __forceinline__ void reg_step(
    int d, int lip, int L, int eb, const int32_t* qp, const int32_t* tp,
    const int (&qv)[K], int match, int mismatch, int gap, const int (&dlo)[K],
    const int (&dhi)[K], int (&X)[K], int (&Y)[K], int (&bv)[K],
    int (&bd)[K]) {
  int nb[K];  // the neighbour on d - 1 besides slot s: s - 1 or s + 1
  if (FLAGS & kNoS1) {
#pragma unroll
    for (int k = 0; k < K; ++k) nb[k] = Y[k];
  } else if (MODE != 1) {
    const int up = __shfl_up_sync(kFull, Y[K - 1], 1);
    nb[0] = lip == 0 ? 0 : up;
#pragma unroll
    for (int k = 1; k < K; ++k) nb[k] = Y[k - 1];
  } else {
    const int dn = __shfl_down_sync(kFull, Y[0], 1);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) nb[k] = Y[k + 1];
    nb[K - 1] = lip == L - 1 ? 0 : dn;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int qc = MODE == 2 ? qv[k] : qp[k];
    const int sub = qc == tp[k] ? match : mismatch;
    const int mg = max(Y[k], nb[k]) + gap;
    int v = __viaddmax_s32_relu(X[k], sub, mg);
    if (!(FLAGS & kNoMask)) {
      bool in = d >= dlo[k] && d <= dhi[k];
      if (MODE == 1) in = in && k != eb;     // slot band is out of the band
      v = in ? v : 0;
    }
    if (!(FLAGS & kNoBest) && v > bv[k]) {
      bv[k] = v;
      bd[k] = d;
    }
    if (MODE == 2) {
      X[k] = nb[k];
      Y[k] = v;
    } else {
      X[k] = v;
    }
  }
}

template <int K, int FLAGS>
__global__ void __launch_bounds__(kMaxWarps * 32)
swv_kernel(const SwvArgs a) {
  extern __shared__ __align__(16) int32_t swv_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int L = a.L, S = a.S, band = a.band;
  const int g = lane / L;                 // the warp's pair of this lane
  const int lip = lane - g * L;           // its lane in the pair
  const int pair0 = (blockIdx.x * (blockDim.x >> 5) + warp) * a.G;
  const int n = pair0 + g;
  const bool live = g < a.G && n < a.N;
  const int p0 = lip * K;                 // this lane's first slot
  const int Sw = L * K;                   // slots a pair sweeps
  int32_t* wbase = swv_smem + warp * a.G * pair_words(Sw);
  // an idle lane reads pair 0's window: its cells are all masked
  const int32_t* pw = wbase + (g < a.G ? g : 0) * pair_words(Sw);
  const int ql = live ? min(max(__ldg(a.qlen + n), 0), a.Lq) : 0;
  const int tl = live ? min(__ldg(a.tlen + n), a.Lt) : 0;
  int qv[K], dlo[K], dhi[K], X[K], Y[K], bv[K], bd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = p0 + k;
    slot_bounds(a, live, s, ql, tl, dlo[k], dhi[k]);
    qv[k] = (live && a.query && s < a.Lq)
                ? __ldg(a.q + static_cast<size_t>(n) * a.Lq + s) : 0;
    X[k] = Y[k] = bv[k] = bd[k] = 0;
  }
  int dend = live ? pair_dend(a, ql, tl) : 1;
  dend = __reduce_max_sync(kFull, dend);  // the warp runs to its last pair's
  if (FLAGS & kNoMask) dend = a.Lq + a.Lt;
  const int eb = band - p0;               // this lane's k of slot band
  if (a.query) {
    for (int dc = 2; dc <= dend; dc += kChunk) {
      __syncwarp();
      stage_chunk<int32_t, false>(a, wbase, pair0, lane, dc, Sw);
      __syncwarp();
      // slot s reads ts[tb - d + s + 2]; the pointer holds d = dc - 1's
      const int32_t* tp = pw + ((FLAGS & kNoTs) ? p0 : kChunk + 2 + p0);
      const int dstop = min(dc + kChunk - 2, dend);
      for (int d = dc; d <= dstop; d += 2) {
        if (!(FLAGS & kNoTs)) --tp;
        reg_step<K, 2, FLAGS>(d, lip, L, eb, nullptr, tp, qv, a.match,
                              a.mismatch, a.gap, dlo, dhi, X, Y, bv, bd);
        if (!(FLAGS & kNoTs)) --tp;
        reg_step<K, 2, FLAGS>(d + 1, lip, L, eb, nullptr, tp, qv, a.match,
                              a.mismatch, a.gap, dlo, dhi, X, Y, bv, bd);
      }
    }
  } else {
    const int WB = win_band(Sw);
    for (int dc = 2 - (band & 1); dc <= dend; dc += kChunk) {
      __syncwarp();
      stage_chunk<int32_t, false>(a, wbase, pair0, lane, dc, Sw);
      __syncwarp();
      // the pointers hold dc - 1's window: i0(dc - 1) = i0(dc), f one less
      const int32_t* qp = pw + p0;
      const int32_t* tp = pw + WB + ((FLAGS & kNoTs) ? p0
                                                     : kChunk / 2 + 1 + p0);
      const int dstop = min(dc + kChunk - 2, dend);
      for (int d = dc; d <= dstop; d += 2) {
        if (!(FLAGS & kNoTs)) --tp;            // delta 0: f(d) = f(d-1) + 1
        reg_step<K, 0, FLAGS>(d, lip, L, eb, qp, tp, qv, a.match, a.mismatch,
                              a.gap, dlo, dhi, X, Y, bv, bd);
        ++qp;                                  // delta 1: i0(d) = i0(d-1) + 1
        reg_step<K, 1, FLAGS>(d + 1, lip, L, eb, qp, tp, qv, a.match,
                              a.mismatch, a.gap, dlo, dhi, Y, X, bv, bd);
      }
    }
  }
  Best b{-1, INT_MAX, INT_MAX};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // without best tracking the last state stands in, so the sweep still
    // feeds the output and is not dead code
    take(b, (FLAGS & kNoBest) ? X[k] + Y[k] : bv[k], bd[k], p0 + k);
  }
  b = group_best(b, lip, L);
  if (lip == 0 && live) store(a, b, n);
}

// ----------------------------------------------------------- packed route

__device__ __forceinline__ uint32_t pack16(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         (static_cast<uint32_t>(hi) << 16);
}

// 0xffff in each half whose bit 15 is set, else 0: one PRMT whose selector
// nibbles 9 and B replicate the sign of bytes 1 and 3 (__byte_perm reads
// only a nibble's low three bits, so the instruction is written out)
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBB99;" : "=r"(r) : "r"(x));
  return r;
}

// One anti-diagonal of the packed route (MODE as reg_step).  Q, T: this
// lane's words of codes (two slots a word); d2 = (d, d).
template <int H, int MODE>
__device__ __forceinline__ void packed_step(
    uint32_t d2, int lane, const uint32_t* Q, const uint32_t* T,
    const uint32_t (&q2)[H], uint32_t match2, uint32_t mism2, uint32_t gap2,
    const uint32_t (&nlo)[H], const uint32_t (&nhi)[H],
    const uint32_t (&ebm)[H], uint32_t (&X)[H], uint32_t (&Y)[H],
    uint32_t (&bv)[H], uint32_t (&bd)[H]) {
  uint32_t nb[H];
  if (MODE != 1) {  // slots s - 1: the halves one up, lane below for word 0
    const uint32_t up = __shfl_up_sync(kFull, Y[H - 1], 1);
    const uint32_t prev = lane == 0 ? 0u : up;
#pragma unroll
    for (int m = 0; m < H; ++m) {
      nb[m] = __byte_perm(m == 0 ? prev : Y[m - 1], Y[m], 0x5432);
    }
  } else {          // slots s + 1: the halves one down, lane above
    const uint32_t dn = __shfl_down_sync(kFull, Y[0], 1);
    const uint32_t next = lane == 31 ? 0u : dn;
#pragma unroll
    for (int m = 0; m < H; ++m) {
      nb[m] = __byte_perm(Y[m], m == H - 1 ? next : Y[m + 1], 0x5432);
    }
  }
#pragma unroll
  for (int m = 0; m < H; ++m) {
    // match where the two int16 codes are equal: a half of x = q ^ t is
    // nonzero iff bit 15 of x | ((x | 0x8000) - 1) is set
    const uint32_t x = (MODE == 2 ? q2[m] : Q[m]) ^ T[m];
    const uint32_t ne = spread(x | ((x | kSigns) - 0x00010001u));
    const uint32_t sub = (ne & mism2) | (~ne & match2);
    const uint32_t xs = __viaddmax_s16x2(X[m], sub, kSigns);   // X + sub
    uint32_t v = __viaddmax_s16x2_relu(__vimax_s16x2_relu(Y[m], nb[m]),
                                       gap2, xs);
    // in the lengths and the band: d >= dlo (bit 15 of d + 0x8000 - dlo)
    // and d <= dhi (bit 15 of dhi + 0x8000 - d); no half borrows
    const uint32_t in = spread((d2 + nlo[m]) & (nhi[m] - d2) & kSigns);
    v &= MODE == 1 ? in & ebm[m] : in;
    // a gain: bit 15 of bv + 0x8000 - v clear
    const uint32_t keep = spread(bv[m] + kSigns - v);
    bd[m] = (keep & bd[m]) | (~keep & d2);
    bv[m] = __vimax_s16x2_relu(bv[m], v);
    if (MODE == 2) {
      X[m] = nb[m];
      Y[m] = v;
    } else {
      X[m] = v;
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kMaxWarps * 32)
swv_packed_kernel(const SwvArgs a) {
  extern __shared__ __align__(16) int32_t swv_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int Sw = 64 * H;              // slots the pair sweeps
  const int band = a.band, WB = win_band(Sw);
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.N) return;                   // the whole warp leaves
  const int p0 = lane * 2 * H;            // this lane's first slot
  int32_t* wbase = swv_smem + warp * pair_words(Sw);
  const int ql = min(max(__ldg(a.qlen + n), 0), a.Lq);
  const int tl = min(__ldg(a.tlen + n), a.Lt);
  uint32_t q2[H], nlo[H], nhi[H], ebm[H], X[H], Y[H], bv[H], bd[H];
#pragma unroll
  for (int m = 0; m < H; ++m) {
    int c[2], lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = p0 + 2 * m + h;
      slot_bounds(a, true, s, ql, tl, lo[h], hi[h]);
      c[h] = (a.query && s < a.Lq)
                 ? __ldg(a.q + static_cast<size_t>(n) * a.Lq + s) : 0;
    }
    q2[m] = pack16(c[0], c[1]);
    nlo[m] = pack16(0x8000 - lo[0], 0x8000 - lo[1]);
    nhi[m] = pack16(hi[0] + 0x8000, hi[1] + 0x8000);
    const int sb = band - (p0 + 2 * m);   // slot band's half in this word
    ebm[m] = (a.query || sb < 0 || sb > 1) ? 0xffffffffu
                                           : (sb == 0 ? 0xffff0000u
                                                      : 0x0000ffffu);
    X[m] = Y[m] = bv[m] = bd[m] = 0u;
  }
  const int dend = pair_dend(a, ql, tl);
  const uint32_t match2 = pack16(a.match, a.match);
  const uint32_t mism2 = pack16(a.mismatch, a.mismatch);
  const uint32_t gap2 = pack16(a.gap, a.gap);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(wbase);
  if (a.query) {
    // ts copy 0 at int16 0, copy 1 (one code on) after it, word aligned
    const int len = kChunk + Sw + 4;
    const uint32_t* t0 = w32;
    const uint32_t* t1 = w32 + (len + (len & 1)) / 2;
    for (int dc = 2; dc <= dend; dc += kChunk) {
      __syncwarp();
      stage_chunk<int16_t, true>(a, wbase, n, lane, dc, Sw);
      __syncwarp();
      // slot p0 reads code x = kChunk + 1 + p0 at d = dc (odd), one less a
      // step: odd steps from copy 1 (word (x - 1) / 2), even from copy 0
      int xo = kChunk + 1 + p0;
      const int dstop = min(dc + kChunk - 2, dend);
      for (int d = dc; d <= dstop; d += 2) {
        packed_step<H, 2>(static_cast<uint32_t>(d) * 0x10001u, lane, nullptr,
                          t1 + (xo - 1) / 2, q2, match2, mism2, gap2, nlo,
                          nhi, ebm, X, Y, bv, bd);
        packed_step<H, 2>(static_cast<uint32_t>(d + 1) * 0x10001u, lane,
                          nullptr, t0 + (xo - 1) / 2, q2, match2, mism2,
                          gap2, nlo, nhi, ebm, X, Y, bv, bd);
        xo -= 2;
      }
    }
  } else {
    // q copies 0 and 1 in the first WB int32 words, t copies in the next
    const uint32_t* qw0 = w32;
    const uint32_t* qw1 = w32 + WB / 2;
    const uint32_t* tw0 = w32 + WB;
    const uint32_t* tw1 = w32 + WB + WB / 2;
    for (int dc = 2 - (band & 1); dc <= dend; dc += kChunk) {
      __syncwarp();
      stage_chunk<int16_t, true>(a, wbase, n, lane, dc, Sw);
      __syncwarp();
      // at d = dc slot p0 reads q code qo = p0 and t code to = kChunk / 2
      // + p0, both even; q moves up one on delta-1 steps, t down one on
      // delta-0 steps: four steps take the copies (0, 1, 1, 0) for q and
      // (0, 0, 1, 1) for t
      int qo = p0, to = kChunk / 2 + p0;
      const int dstop = min(dc + kChunk - 4, dend);
      for (int d = dc; d <= dstop; d += 4) {
        const uint32_t d2 = static_cast<uint32_t>(d) * 0x10001u;
        packed_step<H, 0>(d2, lane, qw0 + qo / 2, tw0 + to / 2, q2, match2,
                          mism2, gap2, nlo, nhi, ebm, X, Y, bv, bd);
        packed_step<H, 1>(d2 + 0x10001u, lane, qw1 + qo / 2, tw0 + to / 2,
                          q2, match2, mism2, gap2, nlo, nhi, ebm, Y, X, bv,
                          bd);
        packed_step<H, 0>(d2 + 0x20002u, lane, qw1 + qo / 2,
                          tw1 + to / 2 - 1, q2, match2, mism2, gap2, nlo,
                          nhi, ebm, X, Y, bv, bd);
        packed_step<H, 1>(d2 + 0x30003u, lane, qw0 + qo / 2 + 1,
                          tw1 + to / 2 - 1, q2, match2, mism2, gap2, nlo,
                          nhi, ebm, Y, X, bv, bd);
        qo += 2;
        to -= 2;
      }
    }
  }
  Best b{-1, INT_MAX, INT_MAX};
#pragma unroll
  for (int m = 0; m < H; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = static_cast<int16_t>(bv[m] >> (16 * h));
      const int dd = static_cast<int16_t>(bd[m] >> (16 * h));
      take(b, v, dd, p0 + 2 * m + h);
    }
  }
  b = group_best(b, lane, 32);
  if (lane == 0) store(a, b, n);
}

// ----------------------------------------------------------- memory route

// int32 words a pair on the memory route: three rows of S + 2 (slots -1 ..
// S, the outer two 0) and each slot's best H and d
__host__ __device__ __forceinline__ int mem_words(int S) {
  return 3 * (S + 2) + 2 * S;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
swv_mem_kernel(const SwvArgs a) {
  extern __shared__ __align__(16) int32_t swv_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = a.S, R = S + 2, band = a.band, G = a.G;
  const int PR = mem_words(S);
  const int pair0 = (blockIdx.x * (blockDim.x >> 5) + warp) * G;
  if (pair0 >= a.N) return;               // the whole warp leaves
  int32_t* base = a.scratch != nullptr
                      ? a.scratch + static_cast<size_t>(pair0) * PR
                      : swv_smem + static_cast<size_t>(warp) * G * PR;
  const int cells = G * S;
  for (int x = lane; x < G * PR; x += 32) base[x] = 0;
  int dend = 1;
  for (int gg = lane; gg < G; gg += 32) {
    const int nn = pair0 + gg;
    if (nn < a.N) {
      dend = max(dend, pair_dend(a, min(max(__ldg(a.qlen + nn), 0), a.Lq),
                                 min(__ldg(a.tlen + nn), a.Lt)));
    }
  }
  dend = __reduce_max_sync(kFull, dend);
  __syncwarp();
  int rot = 0;                            // row of d - 2; d - 1, d follow
  const int g0 = lane / S, s0 = lane - g0 * S;   // this lane's first cell
  for (int d = 2; d <= dend; ++d) {
    const int m1 = a.query ? 0 : (d - band) & 1;  // i0 moved at d
    const int m2 = a.query ? 0 : 1 - m1;          // ... at d - 1
    const int i0 = a.query ? 1 : ceil_half(d - band);
    const int rx = rot, ry = rot == 2 ? 0 : rot + 1, rz = ry == 2 ? 0 : ry + 1;
    int gg = g0, s = s0, cg = -1, ql = 0, tl = 0;
    for (int c = lane; c < cells; c += 32) {
      const int nn = pair0 + gg;
      int32_t* pr = base + gg * PR;
      const int32_t* Xr = pr + rx * R;
      const int32_t* Yr = pr + ry * R;
      if (gg != cg) {                     // this lane's cells moved to a pair
        cg = gg;
        ql = nn < a.N ? min(max(__ldg(a.qlen + nn), 0), a.Lq) : 0;
        tl = nn < a.N ? min(__ldg(a.tlen + nn), a.Lt) : 0;
      }
      const int i = i0 + s, j = d - i;
      int v = 0;
      if (i >= 1 && i <= ql && j >= 1 && j <= tl && j - i <= band &&
          i - j <= band) {
        const int qc = __ldg(a.q + static_cast<size_t>(nn) * a.Lq + i - 1);
        const int tc = __ldg(a.t + static_cast<size_t>(nn) * a.Lt + j - 1);
        const int sub = qc == tc ? a.match : a.mismatch;
        // row index slot + 1: up slot s - 1 + m1, left s + m1, diagonal
        // s - 1 + m1 + m2
        const int mg = max(Yr[s + m1], Yr[s + 1 + m1]) + a.gap;
        v = __viaddmax_s32_relu(Xr[s + m1 + m2], sub, mg);
      }
      pr[rz * R + s + 1] = v;
      int32_t* best = pr + 3 * R;
      if (v > best[s]) {
        best[s] = v;
        best[S + s] = d;
      }
      s += 32;                            // the next cell, c + 32
      while (s >= S) {
        s -= S;
        ++gg;
      }
    }
    __syncwarp();
    rot = ry;
  }
  for (int gg = 0; gg < G; ++gg) {
    const int nn = pair0 + gg;
    if (nn >= a.N) break;
    const int32_t* best = base + gg * PR + 3 * R;
    Best b{-1, INT_MAX, INT_MAX};
    for (int s = lane; s < S; s += 32) take(b, best[s], best[S + s], s);
    b = group_best(b, lane, 32);
    if (lane == 0) store(a, b, nn);
  }
}

// ------------------------------------------------------------------ host

template <class KERNEL>
cudaError_t launch(KERNEL kernel, const SwvArgs& a, int warps, size_t smem,
                   cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int per_block = warps * a.G;
  kernel<<<(a.N + per_block - 1) / per_block, warps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

// (K, FLAGS) of the int32 register route and H of the packed route: v1 and
// v3 at K 1-6, 8, 9, 10, 12, 16, v1's 15 ablations at kAblationK, v2 at H
// 1-4, 6, 8
#define HGA_SWV_K_CASES(X)                                                  \
  X(1, 0) X(2, 0) X(3, 0) X(4, 0) X(5, 0) X(6, 0) X(8, 0) X(9, 0)           \
  X(10, 0) X(12, 0) X(16, 0)                                                \
  X(3, 1) X(3, 2) X(3, 3) X(3, 4) X(3, 5) X(3, 6) X(3, 7) X(3, 8) X(3, 9)   \
  X(3, 10) X(3, 11) X(3, 12) X(3, 13) X(3, 14) X(3, 15)
#define HGA_SWV_H_CASES(X) X(1) X(2) X(3) X(4) X(6) X(8)

// Calls f(the instantiation of (route, K, flags)); cudaErrorInvalidValue
// where none is built.
template <class F>
cudaError_t dispatch(int route, int K, int flags, F&& f) {
  if (route == kMemory) return flags ? cudaErrorInvalidValue : f(swv_mem_kernel);
#define HGA_CASE(k, fl)                                                     \
  if (route == kRegisters && K == k && flags == fl) return f(swv_kernel<k, fl>);
  HGA_SWV_K_CASES(HGA_CASE)
#undef HGA_CASE
#define HGA_CASE(h)                                                         \
  if (route == kPacked && K == h && flags == 0) return f(swv_packed_kernel<h>);
  HGA_SWV_H_CASES(HGA_CASE)
#undef HGA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches one X2 route on `stream`, `warps` (1..8) warps a block: route 0
// (int32 slots in registers, K a lane, G pairs a warp on 32 / G lanes each,
// flags: v1's ablations), 1 (v2, K = H packed words a lane, G 1) or 2 (the
// slots in memory, any G; `scratch` an int32 buffer of blocks x warps x G x
// (5 S + 6) where shared memory cannot hold them, else null).  q, t int32
// (N, Lq), (N, Lt) row-major; lengths (N,).  S = band + 1 slots (band + 1 <
// Lq) or Lq (the query layout); band is clamped to Lq + Lt.  Returns the
// launch's cudaGetLastError() (0 = cudaSuccess), or cudaErrorInvalidValue
// without launching where (route, K, flags) has no instantiation or the
// shape does not fit it (exp/sw_variants.plan makes the same choice).
int hga_swv_launch(const void* q, const void* t, const void* qlen,
                   const void* tlen, int N, int Lq, int Lt, int band,
                   int match, int mismatch, int gap, int route, int K, int G,
                   int flags, int warps, void* scratch, void* score,
                   void* qend, void* tend, void* stream) {
  if (N <= 0 || Lq <= 0 || Lt <= 0 || band < 0 || gap > 0 || warps < 1 ||
      warps > kMaxWarps || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  band = static_cast<int>(
      static_cast<long long>(band) < static_cast<long long>(Lq) + Lt
          ? band : Lq + Lt);
  const bool query = band + 1 >= Lq;
  const int S = query ? Lq : band + 1;
  const int L = G <= 32 ? 32 / G : 0;
  size_t smem = 0;
  if (route == kRegisters) {
    if (L == 0 || static_cast<long long>(L) * K < S || K > kRegSlots ||
        (flags != 0 && (G != 1 || K != kAblationK))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = static_cast<size_t>(warps) * G * pair_words(L * K) * 4;
  } else if (route == kPacked) {
    if (G != 1 || flags != 0 || 64LL * K < S || K > kPackedWords ||
        Lq + Lt > 32767 - 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = static_cast<size_t>(warps) * pair_words(64 * K) * 4;
  } else if (route == kMemory) {
    if (flags != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (scratch == nullptr) {
      smem = static_cast<size_t>(warps) * G * mem_words(S) * 4;
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > static_cast<size_t>(kSmemMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SwvArgs a{static_cast<const int32_t*>(q), static_cast<const int32_t*>(t),
            static_cast<const int32_t*>(qlen),
            static_cast<const int32_t*>(tlen), static_cast<int32_t*>(score),
            static_cast<int32_t*>(qend), static_cast<int32_t*>(tend),
            static_cast<int32_t*>(scratch), N, Lq, Lt, band, match, mismatch,
            gap, G, L, S, query ? 1 : 0};
  auto* s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(route, K, flags, [&](auto kernel) {
    return launch(kernel, a, warps, smem, s);
  }));
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation (route, K, flags), as the loaded module reports them.
int hga_swv_attrs(int route, int K, int flags, int* regs, int* local_bytes) {
  cudaFuncAttributes fa{};
  const cudaError_t e = dispatch(route, K, flags, [&](auto kernel) {
    return cudaFuncGetAttributes(&fa, kernel);
  });
  if (e == cudaSuccess) {
    *regs = fa.numRegs;
    *local_bytes = static_cast<int>(fa.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
