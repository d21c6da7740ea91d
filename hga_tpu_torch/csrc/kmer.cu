// Canonical k-mer keys of a read batch, for Hopper (sm_90a).
//
// kmer_keys_kernel replaces no TPU kernel: the JAX package extracts k-mers
// with plain jnp (hga_tpu/ops/kmer.extract_kmers), which XLA fuses into one
// pass.  Its PyTorch counterpart (hga_tpu_torch/ops/kmer.extract_kmers)
// runs eagerly: k steps of shifts, ORs and complements over (R, m) int64
// planes, then the key packing and the sentinel mask, ~150 launches a batch
// of 65,536 reads, about 56% of the count's device time.  This kernel
// writes the same key tensor in one pass (ops/kmer.kmer_keys).
//
// What it computes, slot for slot the plain composition's tensor: for read
// r and position p < m = 16 W - k + 1, the window x of k 2-bit codes
// starting at base p (LSB first); fwd = x's codes in reverse order, rc = the
// complemented x in order; key = min(fwd, rc) ^ 2^63 (the int64 key of
// ops/count.pack_key), or SENTINEL_KEY (2^63 - 1) where p + k > length[r]
// or the window covers a flagged (bad) base.  Output: int64 (R * m,), row
// r's slots at r * m.
//
// What bounds it: the bytes it writes.  A batch reads 4 (W + BW + 1) bytes a
// read and writes 8 m, ~15 times as much (pad 112, k 21: 3.15 MB in, 48.2
// MB out, 15.3 us at 3.35 TB/s).  The design keeps the stores full and the
// per-slot work to a few dozen integer operations, so that the integer
// pipes stay under the memory's pace:
//
// * A block takes a tile of whole rows (about 4,096 slots, ops/kmer_cuda
//   SLOTS: 44 reads of 92 slots at the cell's shape), or, for reads with
//   more than 4,096 positions, 4,096 positions of one read.  Its slots are
//   contiguous in the output.
// * The tile's words are staged once a block in shared memory, with
//   coalesced loads, kStage of them in flight a thread: the packed words,
//   the same words with their codes in reverse order (rev2 of the words in
//   reverse), the bad-flag words and the lengths; each row padded by zero
//   words so that no read of a window is bounds-checked.  In the reversed
//   stream fwd is a plain window too, so a slot's fwd and rc are each two
//   funnel shifts of three words and one mask, with no per-slot bit
//   reversal.
// * A thread takes V = 2 neighbouring slots at a time where m is even (the
//   cell's m is 92), else V = 1.  The V windows lie in the same three
//   staged words of each stream, and the same two bad-flag words, so the
//   V keys share their 8 shared loads, and they leave in one 16-byte
//   store: each warp store is 512 contiguous bytes (256 at V = 1).  V = 4,
//   two 16-byte stores a thread, ran 1.2-1.4x slower than V = 2 at the
//   cell's shape (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// * The slot's row and position are stepped, not divided: one division a
//   thread a block.
// The geometry (rows a tile, positions a tile, shared bytes) is chosen by
// shape alone in the wrapper (ops/kmer_cuda.geometry); no shape needs more
// than the 48 KB of shared memory a block has without opting in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 4;       // staging loads a thread in flight
constexpr uint64_t kFlip = 0x8000000000000000ull;       // pack_key's 2^63
constexpr int64_t kSentinel = 0x7fffffffffffffffll;     // SENTINEL_KEY

// A word's 16 2-bit codes in reverse order.
__device__ __forceinline__ uint32_t rev2(uint32_t v) {
  const uint32_t b = __brev(v);
  return ((b >> 1) & 0x55555555u) | ((b & 0x55555555u) << 1);
}

__device__ __forceinline__ uint64_t pack64(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// V slots a thread at a time: positions p .. p + V - 1 of one read, V | m
// and V | p, so that the V windows of each stream lie in the same three
// words (and the bad flags in two) and, at V = 2, the keys leave in one
// 16-byte store.
template <int V>
__global__ void __launch_bounds__(kThreads)
kmer_keys_kernel(const uint32_t* __restrict__ packed,   // (R, W)
                 const uint32_t* __restrict__ bad,      // (R, BW)
                 const int32_t* __restrict__ length,    // (R,)
                 int R, int W, int BW, int k, int m,
                 int rows, int span, int tiles_row,
                 int64_t* __restrict__ out) {            // (R * m,)
  extern __shared__ uint32_t smem[];
  const int tile = blockIdx.x;
  const int r0 = (tile / tiles_row) * rows;
  const int p0 = (tile % tiles_row) * span;   // 0 or a multiple of 32
  const int nr = min(rows, R - r0);
  const int np = min(span, m - p0);
  // words of each row the tile's windows cover: [wa, wa + nw) packed,
  // [ba, ba + nb) bad; last base p0 + np - 1 + k - 1 <= 16 W - 1
  const int wa = p0 >> 4;
  const int nw = ((p0 + np + k - 2) >> 4) - wa + 1;
  const int ba = p0 >> 5;
  const int nb = ((p0 + np + k - 2) >> 5) - ba + 1;
  const int sw = nw + 2;          // a row's stride: two zero words after
  const int sb = nb + 1;          // one zero word after
  uint32_t* fw = smem;            // (nr, sw) the words
  uint32_t* rv = fw + nr * sw;    // (nr, sw) codes in reverse order
  uint32_t* bw = rv + nr * sw;    // (nr, sb) bad flags
  int32_t* len = reinterpret_cast<int32_t*>(bw + nr * sb);   // (nr,)

  // the staging: every thread's loads of a round are issued before its
  // first store, so that a block waits about one memory latency a round
  // (kStage loads a thread), not one a word
  const int n_f = nr * nw, n_b = nr * nb, n_all = n_f + n_b + nr;
  for (int i0 = threadIdx.x; i0 < n_all; i0 += kStage * kThreads) {
    uint32_t v[kStage] = {};
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n_f) {
        const int rr = i / nw;
        v[u] = packed[static_cast<int64_t>(r0 + rr) * W + wa + i - rr * nw];
      } else if (i < n_f + n_b) {
        const int j = i - n_f, rr = j / nb;
        v[u] = bad[static_cast<int64_t>(r0 + rr) * BW + ba + j - rr * nb];
      } else if (i < n_all) {
        v[u] = static_cast<uint32_t>(length[r0 + i - n_f - n_b]);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n_f) {
        const int rr = i / nw, c = i - rr * nw;
        fw[rr * sw + c] = v[u];
        rv[rr * sw + nw - 1 - c] = rev2(v[u]);
      } else if (i < n_f + n_b) {
        const int j = i - n_f, rr = j / nb;
        bw[rr * sb + j - rr * nb] = v[u];
      } else if (i < n_all) {
        len[i - n_f - n_b] = static_cast<int32_t>(v[u]);
      }
    }
  }
  for (int rr = threadIdx.x; rr < nr; rr += kThreads) {   // the zero words
    fw[rr * sw + nw] = fw[rr * sw + nw + 1] = 0u;
    rv[rr * sw + nw] = rv[rr * sw + nw + 1] = 0u;
    bw[rr * sb + nb] = 0u;
  }
  __syncthreads();

  const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1ull;
  const uint32_t bmask = k == 32 ? ~0u : (1u << k) - 1u;
  // base b of the staged words is base 16 nw - 1 - b of the reversed
  // stream, so the window of position pp there starts at 16 nw - k - pp;
  // qr - pp is where the group's last window (pp + V - 1) starts
  const int qr = 16 * nw - k - (V - 1);
  const int ng = np / V;          // groups a row
  const int step_r = kThreads / ng, step_g = kThreads - step_r * ng;
  int rr = threadIdx.x / ng, gg = threadIdx.x - rr * ng;
  while (rr < nr) {
    const int pp = gg * V;
    const int qv = qr - pp;
    const uint32_t* f = fw + rr * sw + (pp >> 4);
    const uint32_t* b = rv + rr * sw + (qv >> 4);
    const uint32_t* z = bw + rr * sb + (pp >> 5);
    const uint32_t f0 = f[0], f1 = f[1], f2 = f[2];
    const uint32_t b0 = b[0], b1 = b[1], b2 = b[2];
    const uint32_t z0 = z[0], z1 = z[1];
    const int of = (pp & 15) << 1, ov = (qv & 15) << 1, oz = pp & 31;
    const int room = len[rr] - k - p0 - pp;   // slot pp + j in range: j <= room
    int64_t key[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int o = of + 2 * j, u = ov + 2 * (V - 1 - j);
      const uint64_t rc = ~pack64(__funnelshift_r(f0, f1, o),
                                  __funnelshift_r(f1, f2, o)) & mask;
      const uint64_t fwd = pack64(__funnelshift_r(b0, b1, u),
                                  __funnelshift_r(b1, b2, u)) & mask;
      const uint32_t flags = __funnelshift_r(z0, z1, oz + j) & bmask;
      key[j] = flags == 0u && j <= room
                   ? static_cast<int64_t>((fwd < rc ? fwd : rc) ^ kFlip)
                   : kSentinel;
    }
    int64_t* dst = out + static_cast<int64_t>(r0 + rr) * m + p0 + pp;
    if constexpr (V == 1) {
      dst[0] = key[0];
    } else {
      *reinterpret_cast<longlong2*>(dst) = make_longlong2(key[0], key[1]);
    }
    gg += step_g;
    rr += step_r;
    if (gg >= ng) {
      gg -= ng;
      ++rr;
    }
  }
}

template <typename F>
cudaError_t dispatch(int V, F&& f) {
  switch (V) {
    case 1: return f(kmer_keys_kernel<1>);
    case 2: return f(kmer_keys_kernel<2>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: packed (R, W) and bad (R, BW) int32
// words, length (R,) int32, 1 <= k <= 32, m = 16 W - k + 1 >= 1, BW >=
// ceil((16 W) / 32); `rows` rows and `span` positions a tile (span = m
// where rows > 1, else a multiple of 32), `tiles_row` = ceil(m / span)
// tiles a row, `vec` slots a thread at a time (1, or 2 where m and span
// are even), `smem` dynamic bytes a block (the wrapper's geometry).  out: int64
// (R * m,), 16-byte aligned.  Returns the launch's cudaGetLastError() (0 =
// cudaSuccess), or cudaErrorInvalidValue without launching.
int hga_kmer_keys_launch(const void* packed, const void* bad,
                         const void* length, int R, int W, int BW, int k,
                         int rows, int span, int tiles_row, int vec,
                         int smem, void* out, void* stream) {
  const int m = 16 * W - k + 1;
  if (R <= 0 || W < 1 || k < 1 || k > 32 || m < 1 || 32 * BW < 16 * W ||
      rows < 1 || span < 1 || tiles_row < 1 ||
      static_cast<int64_t>(tiles_row) * span < m ||
      (rows > 1 && span != m) || (tiles_row > 1 && span % 32 != 0) ||
      vec < 1 || m % vec != 0 || span % vec != 0 || smem < 0 ||
      smem > 48 * 1024 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (static_cast<int64_t>(R) + rows - 1) / rows *
                        tiles_row;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dispatch(vec, [&](auto kernel) {
    kernel<<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
        static_cast<const uint32_t*>(packed),
        static_cast<const uint32_t*>(bad),
        static_cast<const int32_t*>(length), R, W, BW, k, m, rows, span,
        tiles_row, static_cast<int64_t*>(out));
    return cudaSuccess;
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes per thread of the kernel at
// `vec` slots a thread, as the loaded module reports them.
int hga_kmer_keys_attrs(int vec, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t e = dispatch(
      vec, [&](auto kernel) { return cudaFuncGetAttributes(&a, kernel); });
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
