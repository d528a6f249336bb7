// Packed low-precision matmul on the CUDA cores of NVIDIA Hopper, sm_90a:
// the row walk for what the tensor-core kernel (qmm_wgmma.cu) does not take,
// group sizes that are no multiple of 16 codes and code arrays that do not
// start on a 16-byte boundary (a row-slice view: the tensor-core kernel
// reads codes by TMA and in aligned 16-byte chunks; this one reads bytes).
//
// repro_qmm replaces repro/kernels/qmm/kernel.py::qmm_pallas (_qmm_kernel)
// for codes off a 16-byte boundary: one scale per row (per_tensor and
// per_channel), the group kernel below with one group of the whole row.
//
// repro_qmm_group replaces repro/kernels/qmm/kernel.py::qmm_group_pallas
// (_qmm_group_kernel) for g not a multiple of 16 codes (g a multiple of the
// packing word 8 / bits): the block-scaled (per_block) packed Φ̂, with one
// scale per g contiguous codes:
//
//     y[m, n] = (sum_k x[m, k] * (c[n, k] - K_h) * scale[n, k / g]) / K_h
//
// x is (M, K) float32, c is (N, Kp) uint8 with Kp = ceil(K / vpb) and vpb =
// 8 / bits codes per byte (code i of a byte at bit bits*i, biased by +K_h),
// scale is (N, G) float32 with G = ceil(K / g), and the sum is accumulated in
// float32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores): the bytes N*Kp + 4*N*G + 4*M*K + 4*M*N over 3.35 TB/s, or,
// for large M, the 2*M*N*K float32 operations (FMAs on the CUDA cores).
//
// Design, and what it does about that:
//   * No padding. The Pallas version pads every operand to 8x128x(128*vpb)
//     blocks with a zero-code pad byte; here the ragged M, N and K edges are
//     masked in the kernel. x beyond K reads as 0, so a pad code adds exactly
//     +0 to the sum, as in the padded version.
//   * Independent blocks over N, each with a loop over the whole K row:
//     there is no sequential grid axis to carry a sum across blocks.
//   * The lanes of a row group walk the row's packed bytes, lane l taking
//     bytes l, l + tpr, l + 2*tpr, ... Code bytes are byte loads that a warp
//     coalesces into whole 32-byte sectors, and, more important, the x values
//     the lanes need are then adjacent too: x is the operand that dominates
//     the traffic inside the SM (vpb*BM floats for every code byte), so its
//     reads are the ones kept coalesced (vector loads of vpb floats where x
//     is aligned). Each byte is unpacked with shift and mask in registers.
//   * Long rows (Kp > 1024 bytes: the LOFAR forward orientation, K = 65,536)
//     get a whole 256-thread block each, x read through L1/L2. Short rows
//     (the adjoint orientation, K = 870, 218 bytes at 2 bits) get tpr <= 32
//     lanes each, so one warp serves several rows; the block stages its BM
//     rows of x in shared memory once (row stride padded to a multiple of 4,
//     zero-filled; at most 8 * 4096 floats = 128 KB, past the 48 KB default,
//     so the launcher opts each instantiation in to the larger carve-out)
//     and walks many row groups.
//   * Each thread keeps a register tile of BM <= 8 rows of M; grid.y walks the
//     M tiles (B up to 64 in the batched solver).
//   * A warp-shuffle reduction (and, for block rows, one pass through shared
//     memory) ends the sum.
//   * The group size g is a multiple of vpb (validate_group_packing),
//     so no byte straddles two groups and one scale is read per packed byte,
//     not per code: scale[n, b / (g / vpb)] for byte b, read through L1 (the
//     lanes of a warp walk neighbouring bytes, so they read one or two scale
//     words between them). The scale multiplies each code before its FMAs,
//     because it varies along the contraction; 1 / K_h (a power of two) is
//     applied once at the end. The ragged K edge is masked, not padded with
//     scale 1.0: a pad code of the last byte lies in the last (real) group
//     and meets an x that reads as 0, so it adds exactly +0.
//
// Plain C interface, built with nvcc and loaded with ctypes: repro_qmm_group
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockRowBytes = 1024;    // rows longer than this get a block each
constexpr int kMaxDevices = 64;

template <int BITS>
struct Fmt {
  static constexpr int kVpb = 8 / BITS;
  static constexpr int kHalf = (1 << (BITS - 1)) / 2;
  static constexpr unsigned kMask = (1u << BITS) - 1u;
};

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int V>
__device__ __forceinline__ void load_vec(float (&dst)[V], const float* src) {
  const typename Vec<V>::T v = *reinterpret_cast<const typename Vec<V>::T*>(src);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i] = f[i];
}

// Adds the vpb codes of packed byte `kb` of a row, times x, into acc[BM].
// xs: BM rows of x at stride ldx (shared memory when SMEM, else global rows
// at the offsets xoff[m]); vec: x may be read as aligned vectors of vpb.
// Each code is multiplied by the byte's group scale `sc` first.
template <int BITS, int BM, bool SMEM>
__device__ __forceinline__ void fma_byte(float (&acc)[BM], unsigned byte, float sc,
                                         const float* __restrict__ xs, int ldx,
                                         const size_t (&xoff)[BM], int kb, int K,
                                         bool vec) {
  using F = Fmt<BITS>;
  const int k0 = kb * F::kVpb;
  float xv[BM][F::kVpb];
  if constexpr (SMEM) {
#pragma unroll
    for (int m = 0; m < BM; ++m) load_vec<F::kVpb>(xv[m], xs + m * ldx + k0);
  } else if (vec) {
#pragma unroll
    for (int m = 0; m < BM; ++m) load_vec<F::kVpb>(xv[m], xs + xoff[m] + k0);
  } else {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int i = 0; i < F::kVpb; ++i)
        xv[m][i] = (k0 + i < K) ? __ldg(xs + xoff[m] + k0 + i) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < F::kVpb; ++i) {
    const float c = static_cast<float>(
        static_cast<int>((byte >> (BITS * i)) & F::kMask) - F::kHalf) * sc;
#pragma unroll
    for (int m = 0; m < BM; ++m) acc[m] = fmaf(xv[m][i], c, acc[m]);
  }
}

// BLOCK_ROW: one block per long row, x read from global memory; otherwise
// row groups of tpr lanes with x staged in shared memory. Byte b of a row
// takes scale[n, b / gbytes] (gbytes = g / vpb).
template <int BITS, int BM, bool BLOCK_ROW>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ c,
           const float* __restrict__ scale, float* __restrict__ y,
           int M, int N, int K, int Kp, int tpr, int ldx, int vec, int G, int gbytes) {
  extern __shared__ float4 smem_raw[];
  float* xsm = reinterpret_cast<float*>(smem_raw);
  using F = Fmt<BITS>;
  constexpr bool SMEM = !BLOCK_ROW;
  const int m0 = blockIdx.y * BM;

  size_t xoff[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) xoff[m] = static_cast<size_t>(min(m0 + m, M - 1)) * K;

  const float* xs = x;
  if constexpr (SMEM) {
    // BM rows of x, row stride ldx >= K (a multiple of 4), zero beyond K
    for (int i = threadIdx.x; i < BM * ldx; i += kThreads) {
      const int m = i / ldx, k = i - m * ldx;
      xsm[i] = (k < K) ? x[xoff[m] + k] : 0.0f;
    }
    __syncthreads();
    xs = xsm;
  }

  if constexpr (BLOCK_ROW) {
    const int n = blockIdx.x;
    float acc[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) acc[m] = 0.0f;
    const uint8_t* row = c + static_cast<size_t>(n) * Kp;
    const float* srow = scale + static_cast<size_t>(n) * G;
    for (int b = threadIdx.x; b < Kp; b += kThreads)
      fma_byte<BITS, BM, SMEM>(acc, __ldg(row + b), __ldg(srow + b / gbytes), xs, ldx, xoff,
                               b, K, vec);
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
    __shared__ float red[kThreads / 32][BM];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int m = 0; m < BM; ++m) red[warp][m] = acc[m];
    }
    __syncthreads();
    if (threadIdx.x < BM && m0 + threadIdx.x < M) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
      y[static_cast<size_t>(m0 + threadIdx.x) * N + n] = s * (1.0f / static_cast<float>(F::kHalf));
    }
  } else {
    // row groups of tpr lanes (a power of two <= 32), kThreads / tpr per block
    const int rpb = kThreads / tpr;
    const int lane = threadIdx.x % tpr;
    const int n_groups = (N + rpb - 1) / rpb;
    for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
      const int n = g * rpb + threadIdx.x / tpr;
      float acc[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) acc[m] = 0.0f;
      if (n < N) {
        const uint8_t* row = c + static_cast<size_t>(n) * Kp;
        const float* srow = scale + static_cast<size_t>(n) * G;
        for (int b = lane; b < Kp; b += tpr)
          fma_byte<BITS, BM, SMEM>(acc, __ldg(row + b), __ldg(srow + b / gbytes), xs, ldx,
                                   xoff, b, K, vec);
      }
#pragma unroll
      for (int m = 0; m < BM; ++m)
        for (int off = tpr >> 1; off > 0; off >>= 1)
          acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
      if (lane == 0 && n < N) {
        const float s = 1.0f / static_cast<float>(F::kHalf);
#pragma unroll
        for (int m = 0; m < BM; ++m)
          if (m0 + m < M) y[static_cast<size_t>(m0 + m) * N + n] = acc[m] * s;
      }
    }
  }
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return (dev < 0 || dev >= kMaxDevices) ? 0 : dev;
}

int num_sms() {
  static int cached[kMaxDevices] = {0};
  const int dev = current_device();
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 132;
}

// Lets the short-row instantiation take the dynamic shared memory its
// largest x tile needs (BM rows of up to kBlockRowBytes * vpb floats), once
// per instantiation and device.
template <int BITS, int BM>
cudaError_t opt_in_smem() {
  static bool done[kMaxDevices] = {false};
  const int dev = current_device();
  if (done[dev]) return cudaSuccess;
  const int most = static_cast<int>(sizeof(float)) * BM * kBlockRowBytes * Fmt<BITS>::kVpb;
  const cudaError_t err = cudaFuncSetAttribute(
      qmm_kernel<BITS, BM, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <int BITS, int BM>
cudaError_t launch(const float* x, const uint8_t* c, const float* scale, float* y,
                   int M, int N, int K, int Kp, int G, int gbytes, cudaStream_t stream) {
  constexpr int vpb = Fmt<BITS>::kVpb;
  const dim3 block(kThreads);
  const unsigned m_tiles = static_cast<unsigned>((M + BM - 1) / BM);
  const bool vec = (K % vpb == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % (4 * vpb) == 0);
  if (Kp > kBlockRowBytes) {
    const dim3 grid(static_cast<unsigned>(N), m_tiles);
    qmm_kernel<BITS, BM, true><<<grid, block, 0, stream>>>(
        x, c, scale, y, M, N, K, Kp, kThreads, K, vec, G, gbytes);
    return cudaGetLastError();
  }
  const cudaError_t err = opt_in_smem<BITS, BM>();
  if (err != cudaSuccess) return err;
  int tpr = 1;
  while (tpr < 32 && tpr < Kp) tpr <<= 1;
  const int rpb = kThreads / tpr;
  const int n_groups = (N + rpb - 1) / rpb;
  const int ldx = (Kp * vpb + 3) / 4 * 4;
  const size_t smem = sizeof(float) * static_cast<size_t>(BM) * ldx;
  // each block stages x once and walks many row groups
  const int blocks = n_groups < 4 * num_sms() ? n_groups : 4 * num_sms();
  const dim3 grid(static_cast<unsigned>(blocks), m_tiles);
  qmm_kernel<BITS, BM, false><<<grid, block, smem, stream>>>(
      x, c, scale, y, M, N, K, Kp, tpr, ldx, vec, G, gbytes);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const float* x, const uint8_t* c, const float* scale, float* y,
                        int M, int N, int K, int Kp, int G, int gbytes,
                        cudaStream_t stream) {
  if (M <= 1) return launch<BITS, 1>(x, c, scale, y, M, N, K, Kp, G, gbytes, stream);
  if (M <= 2) return launch<BITS, 2>(x, c, scale, y, M, N, K, Kp, G, gbytes, stream);
  if (M <= 4) return launch<BITS, 4>(x, c, scale, y, M, N, K, Kp, G, gbytes, stream);
  return launch<BITS, 8>(x, c, scale, y, M, N, K, Kp, G, gbytes, stream);
}

int dispatch(const float* x, const unsigned char* c, const float* scale, float* y,
             int M, int N, int K, int Kp, int bits, int G, int gbytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return static_cast<int>(launch_bits<2>(x, c, scale, y, M, N, K, Kp, G, gbytes, s));
    case 4: return static_cast<int>(launch_bits<4>(x, c, scale, y, M, N, K, Kp, G, gbytes, s));
    case 8: return static_cast<int>(launch_bits<8>(x, c, scale, y, M, N, K, Kp, G, gbytes, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int M, int N, int K, int Kp, int bits) {
  if (bits != 2 && bits != 4 && bits != 8) return true;
  return M <= 0 || N <= 0 || K < 0 || Kp != (K + 8 / bits - 1) / (8 / bits);
}

}  // namespace

// scale is (N,), one per row of c; c may start at any byte.
extern "C" int repro_qmm(const float* x, const unsigned char* c, const float* scale, float* y,
                         int M, int N, int K, int Kp, int bits, void* stream) {
  if (bad_shape(M, N, K, Kp, bits)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, c, scale, y, M, N, K, Kp, bits, 1, Kp > 0 ? Kp : 1, stream);
}

// scale is (N, ceil(K / group_size)); group_size a positive multiple of 8 / bits.
extern "C" int repro_qmm_group(const float* x, const unsigned char* c, const float* scale,
                               float* y, int M, int N, int K, int Kp, int bits,
                               int group_size, void* stream) {
  if (bad_shape(M, N, K, Kp, bits)) return static_cast<int>(cudaErrorInvalidValue);
  const int vpb = 8 / bits;
  if (group_size <= 0 || group_size % vpb) return static_cast<int>(cudaErrorInvalidValue);
  const int G = (K + group_size - 1) / group_size;
  return dispatch(x, c, scale, y, M, N, K, Kp, bits, G, group_size / vpb, stream);
}
