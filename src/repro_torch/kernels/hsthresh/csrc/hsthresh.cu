// The two streaming passes of the hard threshold H_s, for NVIDIA Hopper, sm_90a.
//
// repro_hist replaces repro/kernels/hsthresh/kernel.py::hist_pallas
// (_hist_kernel): an int32 histogram, per row b of a (B, N) batch, of
//
//     bin = clamp((int)((|x| / vmax[b]) * nbins), 0, nbins - 1)
//
// repro_mask replaces mask_pallas (_mask_kernel): y = (|x| > t[b]) ? x : 0.
//
// The reference runs one (1, N) vector per call, vmapped over the rows of
// the solver's batch; both kernels here take the whole (B, N) batch, each row
// with its own vmax or t, in one launch.
//
// What bounds them on an H100 SXM (3.35 TB/s): bytes. hist reads 4*B*N
// bytes and writes 4*B*nbins; mask reads 4*B*N and writes 4*B*N. At the
// LOFAR size (N = 65,536, B = 1) that is well under a microsecond of
// traffic, so a launch costs more than the work: the design stays simple.
//
// Design, and what it does about that:
//   * hist: blocks run in any order and nothing carries between them, so
//     the Pallas kernel's output block revisited across a sequential grid
//     becomes atomics. The grid is (row chunks x B); each block zeroes nbins
//     int32 counters in shared memory (8 KB at nbins = 2,048), counts its
//     chunk with shared-memory atomics, then adds its nonzero counters to
//     the (B, nbins) output, which the wrapper zeroes, with global atomics.
//     Integer atomics are exact and order-free, so the histogram equals the
//     plain version bit for bit.
//   * The bin is computed as the reference computes it: an IEEE f32
//     division, then an IEEE f32 multiplication by nbins, truncated toward
//     zero, then clamped (__fdiv_rn / __fmul_rn: no fast division, no
//     contraction).
//   * The ragged N edge is masked, not padded. The reference's Pallas route
//     pads x with zeros, which land in bin 0 (repro/kernels/hsthresh/ops.py);
//     its plain route hsthresh_ref, which the JAX solver takes off the TPU,
//     does not pad, and this kernel follows that one. The two can differ
//     only when the pick reaches bin 0, i.e. when tail[0] <= s.
//   * mask: one thread per element of a (row chunk, row) grid; elementwise,
//     so bitwise equal to where(|x| > t, x, 0).
//
// Plain C interface, built with nvcc and loaded with ctypes: each entry
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHistChunk = 8192;      // elements of one row per hist block
constexpr int kMaskChunk = 4096;      // elements of one row per mask block
constexpr int kMaxBins = 12288;       // 48 KB of shared counters, no opt-in needed

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ x, const float* __restrict__ vmax,
            int* __restrict__ out, int N, int nbins) {
  extern __shared__ int bins[];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < nbins; i += kThreads) bins[i] = 0;
  __syncthreads();
  const float vm = vmax[b];
  const float nb = static_cast<float>(nbins);
  const float* row = x + static_cast<size_t>(b) * N;
  const int start = blockIdx.x * kHistChunk;
  const int stop = min(start + kHistChunk, N);
  for (int i = start + threadIdx.x; i < stop; i += kThreads) {
    const float q = __fmul_rn(__fdiv_rn(fabsf(__ldg(row + i)), vm), nb);
    int idx = static_cast<int>(q);                // truncation toward zero
    idx = idx < 0 ? 0 : (idx > nbins - 1 ? nbins - 1 : idx);
    atomicAdd(&bins[idx], 1);
  }
  __syncthreads();
  int* orow = out + static_cast<size_t>(b) * nbins;
  for (int i = threadIdx.x; i < nbins; i += kThreads)
    if (bins[i]) atomicAdd(&orow[i], bins[i]);
}

__global__ void __launch_bounds__(kThreads)
mask_kernel(const float* __restrict__ x, const float* __restrict__ t,
            float* __restrict__ y, int N) {
  const int b = blockIdx.y;
  const float tb = t[b];
  const size_t base = static_cast<size_t>(b) * N;
  const int start = blockIdx.x * kMaskChunk;
  const int stop = min(start + kMaskChunk, N);
  for (int i = start + threadIdx.x; i < stop; i += kThreads) {
    const float v = __ldg(x + base + i);
    y[base + i] = fabsf(v) > tb ? v : 0.0f;
  }
}

}  // namespace

// x (B, N) f32, vmax (B,) f32, out (B, nbins) int32 zeroed by the caller.
extern "C" int repro_hist(const float* x, const float* vmax, int* out, int B, int N,
                          int nbins, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || nbins <= 0 || nbins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + kHistChunk - 1) / kHistChunk),
                  static_cast<unsigned>(B));
  const size_t smem = sizeof(int) * static_cast<size_t>(nbins);
  hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, vmax, out, N, nbins);
  return static_cast<int>(cudaGetLastError());
}

// x (B, N) f32, t (B,) f32, y (B, N) f32.
extern "C" int repro_mask(const float* x, const float* t, float* y, int B, int N,
                          void* stream) {
  if (B <= 0 || B > 65535 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + kMaskChunk - 1) / kMaskChunk),
                  static_cast<unsigned>(B));
  mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, t, y, N);
  return static_cast<int>(cudaGetLastError());
}
