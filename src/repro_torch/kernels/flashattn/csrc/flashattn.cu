// Causal or full multi-head attention with grouped K/V heads (GQA), in one
// online-softmax pass, for NVIDIA Hopper, sm_90a, for float32 inputs.
//
// repro_flash_attention replaces, for float32 inputs,
// repro/kernels/flashattn/kernel.py::flash_attention_pallas (_flash_kernel);
// bfloat16 and float16 inputs go to the tensor-core kernel of
// flashattn_wgmma.cu. For queries q (B, Hq, Sq, D) and keys and values k, v
// (B, Hkv, Sk, D), float32, Hq a multiple of Hkv:
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
//     row's four lanes, and accumulates output columns 4(part + 4c) .. +3.
//     Rows are padded by 4 floats so that the four lanes of a row, and the
//     eight rows of a warp, hit different banks.
//   * K and then V of a tile pass through one shared buffer; with the q
//     tile and the probabilities that is 83 KB at D = 128, two blocks per SM.
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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// kRows rows of a (rows, D) array from row0 into shared memory as float32,
// row stride D + 4; rows at or past `rows` read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int rows) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) x = load4(src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kRows * (D + 4) + kRows * kLP);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv, int Sq, int Sk,
             float scale, bool causal) {
  constexpr int LD = D + 4;
  constexpr int kCols = D / (4 * kParts);   // float4 column groups of a thread
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
  const float* kbase = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const float* vbase = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;

  load_tile<D>(Qs, q + static_cast<size_t>(bh) * Sq * D, q0, Sq);
  int n_kv = (Sk + kRows - 1) / kRows;
  if (causal) n_kv = min(n_kv, (min(q0 + kRows, Sq) - 1 + off) / kRows + 1);

  float m = kNegInf, l = 0.f;
  float acc[kCols][4];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kRows;
    __syncthreads();                              // the last tile's P and V reads are done
    load_tile<D>(KVs, kbase, k0, Sk);
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
    for (int c = 0; c < kCols; ++c) {
      acc[c][0] *= alpha;
      acc[c][1] *= alpha;
      acc[c][2] *= alpha;
      acc[c][3] *= alpha;
    }
    __syncthreads();                              // K reads done: the buffer takes V
    load_tile<D>(KVs, vbase, k0, Sk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kRows; ++j) {
      const float p = Ps[r * kLP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(KVs + j * LD + 4 * (part + kParts * c));
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
  }
  if (qi < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store4(orow + 4 * (part + kParts * c),
             make_float4(acc[c][0] / denom, acc[c][1] / denom, acc[c][2] / denom,
                         acc[c][3] / denom));
  }
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return (dev < 0 || dev >= kMaxDevices) ? 0 : dev;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                   int Sq, int Sk, float scale, bool causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool opted_in[kMaxDevices] = {false};   // above 48 KB needs the opt-in, once per device
  const int dev = current_device();
  if (!opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((Sq + kRows - 1) / kRows), static_cast<unsigned>(B * Hq));
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Hq, Hkv, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Hq,
                     int Hkv, int Sq, int Sk, float scale, bool causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    case 32: return launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    case 64: return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    case 128: return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), o (B, Hq, Sq, D), contiguous and
// 16-byte aligned; dtype 0 (float32, the only one); D in {16, 32, 64, 128}.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int Hq, int Hkv, int Sq, int Sk, int D, int dtype,
                                     float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 ||
      static_cast<long long>(B) * Hq > 65535 || (causal && Sq > Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_d(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal != 0, s));
}
