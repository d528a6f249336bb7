// Stochastic rounding of float32 values to int8 codes, for NVIDIA Hopper, sm_90a.
//
// repro_sqround replaces repro/kernels/sqround/kernel.py::sqround_pallas
// (_sqround_kernel). For every element, with K = 2^(bits-1) / 2:
//
//     scaled = clip(v / scale, -1, 1) * K
//     low    = floor(scaled)
//     code   = clip(low + [((u >> 8) * 2^-24) < scaled - low], -K, K)
//
// where u is the element's uint32 random word, drawn outside the kernel (the
// port's threefry random.bits, as jax.random.bits draws it for the
// reference), so the codes are a function of the inputs alone.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. It reads 4 bytes of v
// and 4 bytes of u and writes 1 byte of code per element, 9 bytes against a
// handful of float operations. At the LOFAR CS302 Φ (870 x 65,536 = 57M
// elements) that is 513 MB, 0.153 ms at the card's rate.
//
// Design, and what it does about that:
//   * One elementwise pass over the flat R*C elements with a grid-stride
//     loop, enough blocks to fill every SM. Where v, u and the codes are
//     16-, 16- and 4-byte aligned, each thread moves four elements per step
//     (float4, uint4, char4) to keep more bytes in flight; the last n % 4
//     elements, or all of them when unaligned, go one at a time. The ragged
//     edge is masked by the loop bound: nothing is padded to the reference's
//     block_r rows.
//   * The words arrive as 32-bit integers (the wrapper narrows the port's
//     int64 holder), 4 bytes per element on the stream and not 8.
//   * Codes equal the plain version bit for bit. Every rounding is spelled
//     out: the division is IEEE round-to-nearest (__fdiv_rn, not a multiply
//     by a reciprocal), the multiply and the subtraction use __fmul_rn and
//     __fsub_rn so that nvcc cannot contract them into an FMA, floorf is
//     exact, (u >> 8) * 2^-24 is exact in float32, and u01 < p_up is the
//     reference's comparison in float32.
//
// Plain C interface, built with nvcc and loaded with ctypes: the entry
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ int8_t code_of(float v, uint32_t u, float s, float kf) {
  const float q = fminf(fmaxf(__fdiv_rn(v, s), -1.0f), 1.0f);
  const float scaled = __fmul_rn(q, kf);
  const float low = floorf(scaled);
  const float p_up = __fsub_rn(scaled, low);
  const float u01 = __fmul_rn(static_cast<float>(u >> 8), 0x1p-24f);
  const float code = fminf(fmaxf(__fadd_rn(low, u01 < p_up ? 1.0f : 0.0f), -kf), kf);
  return static_cast<int8_t>(static_cast<int>(code));
}

__global__ void __launch_bounds__(kThreads)
sqround_kernel(const float* __restrict__ v, const uint32_t* __restrict__ u,
               const float* __restrict__ scale, int8_t* __restrict__ out,
               long long n, int K, bool vec) {
  const float s = *scale;
  const float kf = static_cast<float>(K);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const uint4* u4 = reinterpret_cast<const uint4*>(u);
    char4* o4 = reinterpret_cast<char4*>(out);
    for (long long i = first; i < n4; i += stride) {
      const float4 a = __ldg(v4 + i);
      const uint4 w = __ldg(u4 + i);
      o4[i] = make_char4(code_of(a.x, w.x, s, kf), code_of(a.y, w.y, s, kf),
                         code_of(a.z, w.z, s, kf), code_of(a.w, w.w, s, kf));
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = code_of(__ldg(v + i), __ldg(u + i), s, kf);
}

int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

}  // namespace

// v (n,) f32, u (n,) 32-bit words, scale (1,) f32 on the device, out (n,) int8;
// K the number of positive steps (1, 2 or 8 at bits 2, 4, 8).
extern "C" int repro_sqround(const float* v, const uint32_t* u, const float* scale,
                             int8_t* out, long long n, int K, void* stream) {
  if (n <= 0 || K <= 0 || K > 127) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const long long need = ((vec ? n / 4 : n) + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(kBlocksPerSm) * num_sms();
  const unsigned blocks = static_cast<unsigned>(need < 1 ? 1 : (need < most ? need : most));
  sqround_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, u, scale, out, n, K, vec);
  return static_cast<int>(cudaGetLastError());
}
