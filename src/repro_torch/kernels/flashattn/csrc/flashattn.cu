// Causal or full multi-head attention with grouped K/V heads (GQA), in one
// online-softmax pass on the CUDA cores of NVIDIA Hopper, sm_90a.
//
// Three entries replace repro/kernels/flashattn/kernel.py::flash_attention_pallas
// (_flash_kernel) where the tensor-core kernel of flashattn_wgmma.cu does
// not run:
//   * repro_flash_attention: float32 inputs, every head dim of the
//     reference's configs, D in {8, 16, 32, 64, 128, 160, 256};
//   * repro_flash_attention_core: bfloat16 and float16 inputs at the head
//     dims flashattn_wgmma.cu does not take, D in {8, 160, 256};
//   * repro_flash_attention_unaligned: any of the three types and head dims
//     when q, k or v does not start on a 16-byte boundary (a view into a
//     larger tensor): scalar loads, no vectors, no copy.
// 16-bit inputs are widened to float32 as they are loaded, so every entry
// computes in float32 and rounds once, when it stores o in q's type. For
// queries q (B, Hq, Sq, D) and keys and values k, v (B, Hkv, Sk, D), Hq a
// multiple of Hkv:
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / (Hq / Hkv), j]) v[b, h / (Hq / Hkv), j]
//
// over keys j < Sk, or, causal, j <= i + (Sk - Sq): the bottom-right
// alignment of the reference's oracle attention_ref (for Sq = Sk, j <= i, as
// the Pallas kernel masks it).
//
// What bounds it on an H100 SXM: operations. A causal pass does
// 4 * B * Hq * D * (number of visible (i, j) pairs) flops, against bytes of
// q, k, v and o read or written once. The products stay in full float32 (the
// reference computes float32 in float32; TF32 tensor cores would not meet its
// 2e-4), so the bound is the 67 TFLOP/s of the float32 CUDA cores this kernel
// uses: at the starcoder2-3b prefill width (Hq = 24, Hkv = 2, D = 128,
// S = 32,768) 6.6e12 flops, 99 ms, against 0.26 ms of bytes.
//
// Design (right and simple; the CUDA cores):
//   * The Pallas grid's sequential KV axis becomes a loop inside the block.
//     One block takes 64 query rows of one (b, h) and walks the KV tiles of
//     64 keys, keeping, as _flash_kernel keeps in VMEM scratch, a running row
//     max m, a row sum l and a float32 accumulator. Scores are masked with
//     the finite -1e30 and the output is acc / max(l, 1e-30).
//   * 256 threads, four per query row. A thread scores keys part + 4i of the
//     tile (16 of them) from float4 reads of its q row and the K tile in
//     shared memory, reduces the row max and sum with two shuffles among the
//     row's four lanes, and accumulates output columns CW(part + 4c) .. +CW-1
//     (CW = 4; 2 at D = 8). Rows are padded by 4 floats so that the four
//     lanes of a row, and the eight rows of a warp, hit different banks.
//   * Tiles are loaded as 16-byte vectors (4 float32 or 8 16-bit values)
//     when q, k and v start on a 16-byte boundary (rows are then aligned
//     too: D is a multiple of 8), else element by element.
//   * K and then V of a tile pass through one shared buffer; with the q
//     tile and the probabilities that is 83 KB at D = 128, two blocks per SM
//     (150 KB at D = 256: one).
//   * Causal: KV tiles strictly above the block's last row's diagonal are not
//     visited at all; the tiles that cross it and the ragged Sq and Sk edges
//     are masked element by element, so every length works without padding.
//     Blocks start with the heaviest query tiles (the last) to even out the
//     causal load.
//   * GQA: the block reads K/V head h / (Hq / Hkv) in place; no repeated
//     copies of K and V are made.
//
// Plain C interface, built with nvcc and loaded with ctypes: the entry
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                // query rows of a block, keys of a KV tile
constexpr int kParts = 4;                // threads per query row
constexpr int kThreads = kRows * kParts;
constexpr int kKeys = kRows / kParts;    // keys a thread scores per tile
constexpr int kLP = kRows + 4;           // padded row of the probability tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// CW consecutive floats of shared memory (CW = 2 or 4, aligned).
template <int CW>
__device__ __forceinline__ void load_cols(float (&dst)[CW], const float* p) {
  if constexpr (CW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
  }
}

// kRows rows of a (rows, D) array of T from row0 into shared memory as
// float32, row stride D + 4; rows at or past `rows` read as zeros. VEC:
// 16-byte loads (the array starts on a 16-byte boundary), else one element
// at a time.
template <typename T, int D, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int rows) {
  if constexpr (VEC) {
    constexpr int kE = 16 / sizeof(T);    // elements of one 16-byte load
    constexpr int kVec = D / kE;
    for (int idx = threadIdx.x; idx < kRows * kVec; idx += kThreads) {
      const int r = idx / kVec, c = (idx % kVec) * kE;
      float f[kE];
      if (row0 + r < rows) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < kE; ++i) f[i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kE; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kE; i += 4)
        *reinterpret_cast<float4*>(dst + r * (D + 4) + c + i) =
            make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      dst[r * (D + 4) + c] =
          row0 + r < rows ? to_f32(src[static_cast<size_t>(row0 + r) * D + c]) : 0.f;
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kRows * (D + 4) + kRows * kLP);
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(kThreads, D > 160 ? 1 : 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Hq, int Hkv, int Sq, int Sk, float scale, bool causal) {
  constexpr int LD = D + 4;
  constexpr int CW = D % 16 == 0 ? 4 : 2;    // output columns a thread holds together
  constexpr int kCols = D / (CW * kParts);   // column groups of a thread
  static_assert(D % 8 == 0 && kCols >= 1, "head dim");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kRows * LD;
  float* Ps = KVs + kRows * LD;

  const int qb = gridDim.x - 1 - blockIdx.x;      // heaviest causal blocks first
  const int bh = blockIdx.y;                      // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kRows;
  const int r = threadIdx.x / kParts, part = threadIdx.x % kParts;
  const int qi = q0 + r;
  const int off = Sk - Sq;                        // causal: row i sees keys j <= i + off
  const T* kbase = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vbase = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;

  load_tile<T, D, VEC>(Qs, q + static_cast<size_t>(bh) * Sq * D, q0, Sq);
  int n_kv = (Sk + kRows - 1) / kRows;
  if (causal) n_kv = min(n_kv, (min(q0 + kRows, Sq) - 1 + off) / kRows + 1);

  float m = kNegInf, l = 0.f;
  float acc[kCols][CW];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[c][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kRows;
    __syncthreads();                              // the last tile's P and V reads are done
    load_tile<T, D, VEC>(KVs, kbase, k0, Sk);
    __syncthreads();
    float s[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + d);
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(KVs + (part + kParts * i) * LD + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    float tmax = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int j = k0 + part + kParts * i;
      const bool seen = j < Sk && (!causal || j <= qi + off);
      s[i] = seen ? s[i] * scale : kNegInf;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      Ps[r * kLP + part + kParts * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[c][e] *= alpha;
    __syncthreads();                              // K reads done: the buffer takes V
    load_tile<T, D, VEC>(KVs, vbase, k0, Sk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kRows; ++j) {
      const float p = Ps[r * kLP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float vv[CW];
        load_cols<CW>(vv, KVs + j * LD + CW * (part + kParts * c));
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[c][e] = fmaf(p, vv[e], acc[c][e]);
      }
    }
  }
  if (qi < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e)
        orow[CW * (part + kParts * c) + e] = from_f32<T>(acc[c][e] / denom);
  }
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return (dev < 0 || dev >= kMaxDevices) ? 0 : dev;
}

template <typename T, int D, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                   int Sq, int Sk, float scale, bool causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool opted_in[kMaxDevices] = {false};   // above 48 KB needs the opt-in, once per device
  const int dev = current_device();
  if (!opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((Sq + kRows - 1) / kRows), static_cast<unsigned>(B * Hq));
  flash_kernel<T, D, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

// ALL: every head dim; otherwise only those flashattn_wgmma.cu does not take.
template <typename T, bool VEC, bool ALL>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Hq,
                     int Hkv, int Sq, int Sk, float scale, bool causal, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8, VEC>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    case 160: return launch<T, 160, VEC>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    case 256: return launch<T, 256, VEC>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    default: break;
  }
  if constexpr (ALL) {
    switch (D) {
      case 16: return launch<T, 16, VEC>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
      case 32: return launch<T, 32, VEC>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
      case 64: return launch<T, 64, VEC>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
      case 128: return launch<T, 128, VEC>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

bool bad_args(int B, int Hq, int Hkv, int Sq, int Sk, int causal) {
  return B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 ||
         static_cast<long long>(B) * Hq > 65535 || (causal && Sq > Sk);
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), o (B, Hq, Sq, D), contiguous and
// 16-byte aligned; dtype 0 (float32, the only one); D in {8, 16, 32, 64,
// 128, 160, 256}.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int Hq, int Hkv, int Sq, int Sk, int D, int dtype,
                                     float scale, int causal, void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, causal) || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_d<float, true, true>(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, scale,
                                                      causal != 0,
                                                      static_cast<cudaStream_t>(stream)));
}

// As repro_flash_attention for dtype 1 (bfloat16) or 2 (float16), D in {8,
// 160, 256}.
extern "C" int repro_flash_attention_core(const void* q, const void* k, const void* v, void* o,
                                          int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                          int dtype, float scale, int causal, void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, causal)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16, true, false>(D, q, k, v, o, B, Hq, Hkv, Sq,
                                                                 Sk, scale, causal != 0, s));
  if (dtype == 2)
    return static_cast<int>(launch_d<__half, true, false>(D, q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                                          scale, causal != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v at any address their type allows, o contiguous; dtype 0, 1 or 2;
// D in {8, 16, 32, 64, 128, 160, 256}.
extern "C" int repro_flash_attention_unaligned(const void* q, const void* k, const void* v,
                                               void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                                               int D, int dtype, float scale, int causal,
                                               void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, causal)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_d<float, false, true>(D, q, k, v, o, B, Hq, Hkv, Sq,
                                                                 Sk, scale, causal != 0, s));
    case 1: return static_cast<int>(launch_d<__nv_bfloat16, false, true>(
        D, q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal != 0, s));
    case 2: return static_cast<int>(launch_d<__half, false, true>(D, q, k, v, o, B, Hq, Hkv, Sq,
                                                                  Sk, scale, causal != 0, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
