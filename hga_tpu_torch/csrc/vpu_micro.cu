// int32 issue-rate probe for Hopper (sm_90a).
//
// X3 (vpu_kernel<C, STEPS>) replaces the Pallas kernel `kernel` inside
// `make` (exp/vpu_micro.py:16-25): on every element of an (R, 128) int32
// tile it starts C chains x_c = x + c, runs STEPS steps of
// x_g = max(x_g + 1, x_g) with g = step % C (C independent chains, so C-way
// instruction-level parallelism), and writes the chains' sum.  Adds wrap as
// two's complement, as in JAX, so max(x + 1, x) holds a chain at INT32_MAX.
//
// The trap: signed overflow is undefined in C++, so written with int the
// compiler may fold max(x + 1, x) into x + 1 and then a chain of STEPS
// increments into one add.  The chain is written with unsigned (wrapping)
// adds and a signed max, and the increment arrives as a kernel argument
// (`one` = 1), so neither the max nor the chain can be folded away.
// chip_smoke.py counts the add and min/max instructions that the SASS
// (cuobjdump -sass) actually holds and reports the rate from those: on
// sm_90a nvcc fuses each step's add and max into one VIADDMNMX (DPX), so a
// thread issues STEPS of them, not 2 * STEPS.
//
// Design: one element per thread, the C chains in registers, STEPS unrolled
// at compile time (a template parameter).  The JAX grid of 8 recomputes one
// tile on one TensorCore; here grid.y = `reps` copies of the tile run on the
// 132 SMs and each copy writes its own output row (reps, n), so no write is
// dead and nothing races.  The wrapper picks reps so that four full waves of
// 2048 resident threads on every SM run (128-thread blocks, 16 a SM): every
// SM partition holds 16 warps, enough to cover the add/max latency even at
// C = 1.
//
// What bounds it: integer issue rate alone — STEPS fused add/max
// instructions per element against 4 bytes read and 4 written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <int C, int STEPS>
__global__ void __launch_bounds__(kThreads)
vpu_kernel(const int32_t* __restrict__ x, int n, int one,
           int32_t* __restrict__ out) {   // (reps, n)
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int x0 = x[e];
  int xs[C];
#pragma unroll
  for (int c = 0; c < C; ++c) xs[c] = wrap_add(x0, c);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int g = s % C;
    xs[g] = max(wrap_add(xs[g], one), xs[g]);
  }
  int acc = xs[0];
#pragma unroll
  for (int c = 1; c < C; ++c) acc = wrap_add(acc, xs[c]);
  out[static_cast<size_t>(blockIdx.y) * n + e] = acc;
}

template <int C, int STEPS>
cudaError_t launch_cs(const int32_t* x, int n, int reps, int32_t* out,
                      cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads, reps);
  vpu_kernel<C, STEPS><<<grid, kThreads, 0, s>>>(x, n, 1, out);
  return cudaGetLastError();
}

template <int C, int STEPS>
cudaError_t attrs_cs(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, vpu_kernel<C, STEPS>);
}

#define HGA_VPU_CASES(X) \
  X(1, 16) X(2, 16) X(4, 16) X(8, 16) X(1, 2048) X(2, 2048) X(4, 2048) X(8, 2048)

}  // namespace

extern "C" {

// Launches X3 on `stream`: x holds n int32, out reps * n.  Returns the
// launch's cudaGetLastError() (0 = cudaSuccess); a (C, STEPS) without an
// instantiation, n <= 0 or reps outside 1..65535 returns
// cudaErrorInvalidValue without launching.
int hga_vpu_launch(const void* x, int n, int C, int steps, int reps,
                   void* out, void* stream) {
  if (n <= 0 || reps <= 0 || reps > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
#define HGA_CASE(c, st) \
  if (C == c && steps == st) return static_cast<int>(launch_cs<c, st>(xi, n, reps, o, s));
  HGA_VPU_CASES(HGA_CASE)
#undef HGA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread and local (spill) bytes per thread of one
// instantiation, as the loaded module reports them.
int hga_vpu_attrs(int C, int steps, int* regs, int* local_bytes) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaErrorInvalidValue;
#define HGA_CASE(c, st) \
  if (C == c && steps == st) e = attrs_cs<c, st>(&a);
  HGA_VPU_CASES(HGA_CASE)
#undef HGA_CASE
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // extern "C"
