// Causal or full multi-head attention with grouped K/V heads (GQA) on the
// tensor cores of NVIDIA Hopper, sm_90a, for bfloat16 and float16 inputs.
//
// repro_flash_attention_tc replaces, for 16-bit inputs,
// repro/kernels/flashattn/kernel.py::flash_attention_pallas (_flash_kernel);
// float32 inputs keep the CUDA-core kernel of flashattn.cu. For queries q
// (B, Hq, Sq, D) and keys and values k, v (B, Hkv, Sk, D), Hq a multiple of
// Hkv:
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j],
//     g = h / (Hq / Hkv),
//
// over keys j < Sk, or, causal, j <= i + (Sk - Sq): the bottom-right
// alignment of the reference's oracle attention_ref. As _flash_kernel does,
// it keeps a running row max m, row sum l and a float32 accumulator, masks
// scores with the finite -1e30 and returns acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100 SXM: operations. A causal pass does
// 4 * B * Hq * D * (number of visible (i, j) pairs) flops against the bytes
// of q, k, v and o moved once; at the starcoder2-3b prefill width (Hq = 24,
// Hkv = 2, D = 128, S = 32,768) that is 6.6e12 flops, 6.7 ms at the 989
// TFLOP/s of the 16-bit tensor cores, against 0.24 ms of bytes.
//
// Design:
//   * One block of 384 threads owns one (b, h) and 128 query rows: warpgroup
//     0 is the producer (one thread starts every copy), warpgroups 1 and 2
//     are consumers of 64 rows each. Blocks take the heaviest causal query
//     tiles first, all heads of a tile together, so the query heads of one
//     K/V head share its tiles in L2.
//   * Loads: TMA, 3-D tensor maps (D, S, B*H) so that a ragged tile is zero
//     filled within its own head. Q is loaded once; K and V tiles of 128 keys
//     pass through a ring of 2 stages, each with a "full" mbarrier (TMA
//     bytes) and an "empty" one (the 256 consumer threads). Tiles are stored
//     in 64-column chunks of 128-byte rows with the 128-byte swizzle, the
//     layout wgmma reads; D = 16 and 32 are zero padded to 64 by the copy.
//   * S = Q K^T: wgmma m64n128k16, Q and K from shared memory (K-major), an
//     f32 accumulator in registers. Lane l of warp w holds rows 16w + l/4 and
//     +8, columns 8j + 2(l%4) + {0, 1}.
//   * Online softmax in f32 on the accumulator, in base 2 (scale * log2 e
//     folded into the scores); a row's 4 lanes reduce its max with two
//     shuffles; the row sum stays per lane until the epilogue. The causal
//     mask and the ragged edges are applied only on tiles that cross them.
//   * O += P V: P rounded to the input type in registers, where the score
//     accumulator's layout is wgmma's A fragment; V from shared memory as an
//     MN-major (transposed) B; O stays f32 in registers, divided by l and
//     rounded once when stored.
//
// Plain C interface, built with nvcc and loaded with ctypes: the entry
// encodes the tensor maps (cuTensorMapEncodeTiled, looked up at run time
// through the CUDA runtime, so nothing more is linked), launches on the
// given stream, does not synchronise, and returns a cudaError_t.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockM = 128;          // query rows of a block: two consumer warpgroups of 64
constexpr int kBlockN = 128;          // keys of a K/V tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kAtom = 64;             // 16-bit columns of one 128-byte swizzled row
constexpr int kChunkBytes = 128 * 128;  // one 64-column chunk of 128 rows
constexpr int kThreads = 384;         // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kWatchdogCycles = 1ll << 34;  // ~10 s: a wait this long is a fault
constexpr int kMaxDevices = 64;

// Shared memory of a block for padded head dim DP (64 or 128), from a
// 1024-byte aligned base: Q, the K ring, the V ring, the barriers.
template <int DP>
struct Layout {
  static constexpr int kChunks = DP / kAtom;
  static constexpr int kTile = kChunks * kChunkBytes;   // Q, or one stage of K or V
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete. A pipeline fault
// traps after ~10 s (the launch then reports an error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

// A (64-column, 128-row, 1) box of a 3-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
        "r"(row), "r"(plane)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all >> 4), layout 1 = 128B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FLASH_WGMMA_SS_N128(TY)                                                     \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define FLASH_WGMMA_RS_N64(TY)                                                     \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define FLASH_WGMMA_RS_N128(TY)                                                     \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))


// d (64 x 128) {=, +=} Q (64 x 16, shared, K-major) K^T (16 x 128, shared, K-major)
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (std::is_same<T, __half>::value) FLASH_WGMMA_SS_N128("f16");
  else FLASH_WGMMA_SS_N128("bf16");
}

// d (64 x DP) += P (64 x 16, registers) V (16 x DP, shared, MN-major)
template <typename T, int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (DP == 64) {
    if constexpr (std::is_same<T, __half>::value) FLASH_WGMMA_RS_N64("f16");
    else FLASH_WGMMA_RS_N64("bf16");
  } else {
    if constexpr (std::is_same<T, __half>::value) FLASH_WGMMA_RS_N128("f16");
    else FLASH_WGMMA_RS_N128("bf16");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to nearest even into one 32-bit pair, the lower column
// in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

__device__ __forceinline__ bool seen(int key, int row, int Sk, int off, int causal) {
  return key < Sk && (!causal || key <= row + off);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, T* __restrict__ o, int Hq, int Hkv,
                int Sq, int Sk, int D, float scale_log2, int causal) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;                        // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;        // heaviest causal tiles first
  const int q0 = qt * kBlockM;
  const int kv_plane = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int off = Sk - Sq;                          // causal: row i sees keys j <= i + off
  int n_kv = (Sk + kBlockN - 1) / kBlockN;
  if (causal) n_kv = min(n_kv, (min(q0 + kBlockM, Sq) - 1 + off) / kBlockN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {                          // producer warpgroup: one thread copies
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(smem + c * kChunkBytes, &map_q, q_full, c * kAtom, q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * L::kTile);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(smem + L::kK + s * L::kTile + c * kChunkBytes, &map_k, full + s, c * kAtom,
                   t * kBlockN, kv_plane);
          tma_load(smem + L::kV + s * L::kTile + c * kChunkBytes, &map_v, full + s, c * kAtom,
                   t * kBlockN, kv_plane);
        }
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128 - 1;             // consumer warpgroup: rows 64 cw ..
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row_first = q0 + 64 * cw;
  const int r0 = row_first + 16 * w + lane / 4;     // this lane's rows r0 and r0 + 8
  const int col = 2 * (lane % 4);                   // and columns 8j + col, + 1
  const uint32_t q_addr = smem_u32(smem) + 64 * 128 * cw;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % kStages;
    mbar_wait(full + s, (t / kStages) & 1);
    const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kTile);
    const uint32_t v_addr = smem_u32(smem + L::kV + s * L::kTile);

    float sc[kBlockN / 2];                          // scores, then base-2 logits
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t koff = (kk / 4) * kChunkBytes + (kk % 4) * 32;
      wgmma_qk<T>(sc, smem_desc(q_addr + koff, 16, 1024), smem_desc(k_addr + koff, 16, 1024),
                  kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= scale_log2;
    const int k0 = t * kBlockN;
    if (k0 + kBlockN > Sk || (causal && k0 + kBlockN - 1 > row_first + off)) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + col + e;
          if (!seen(key, r0, Sk, off, causal)) sc[4 * j + e] = kNegInf;
          if (!seen(key, r0 + 8, Sk, off, causal)) sc[4 * j + 2 + e] = kNegInf;
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    uint32_t p[kBlockN / 4];                        // P, 16-bit pairs: wgmma's A fragments
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const float p0 = ex2(sc[4 * j] - m0), p1 = ex2(sc[4 * j + 1] - m0);
      const float p2 = ex2(sc[4 * j + 2] - m1), p3 = ex2(sc[4 * j + 3] - m1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      p[2 * j] = pack2<T>(p0, p1);
      p[2 * j + 1] = pack2<T>(p2, p3);
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_pv<T, DP>(acc, *reinterpret_cast<const uint32_t(*)[4]>(p + 4 * kk),
                      smem_desc(v_addr + kk * 16 * 128, kChunkBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(p);
    fence_regs(acc);                                // P V has retired: acc holds tile t
    mbar_arrive(empty + s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  T* orow = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + col;
    if (c >= D) continue;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(orow + static_cast<size_t>(r0) * D + c) =
          pack2<T>(acc[4 * j] / den0, acc[4 * j + 1] / den0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(orow + static_cast<size_t>(r0 + 8) * D + c) =
          pack2<T>(acc[4 * j + 2] / den1, acc[4 * j + 3] / den1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (D, S, planes) tensor of 16-bit values, read in (64, 128, 1) boxes with
// the 128-byte swizzle; columns at or past D and rows at or past S read as 0.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int D,
            int S, int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {kAtom, kBlockN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return (dev < 0 || dev >= kMaxDevices) ? 0 : dev;
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                   int Sq, int Sk, int D, float scale, bool causal, cudaStream_t stream) {
  constexpr int smem = Layout<DP>::kBytes;
  static bool opted_in[kMaxDevices] = {false};   // above 48 KB needs the opt-in, once per device
  const int dev = current_device();
  if (!opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_q, map_k, map_v;
  if (!encode(fn, &map_q, q, type, D, Sq, B * Hq) || !encode(fn, &map_k, k, type, D, Sk, B * Hkv) ||
      !encode(fn, &map_v, v, type, D, Sk, B * Hkv))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((Sq + kBlockM - 1) / kBlockM));
  flash_tc_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, static_cast<T*>(o), Hq, Hkv, Sq, Sk, D, scale * kLog2e, causal ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                     int Sq, int Sk, int D, float scale, bool causal, cudaStream_t stream) {
  switch (D) {
    case 16:
    case 32:
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), o (B, Hq, Sq, D), contiguous and
// 16-byte aligned; dtype 1 for bfloat16, 2 for float16; D in {16, 32, 64, 128}.
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                                        int B, int Hq, int Hkv, int Sq, int Sk, int D, int dtype,
                                        float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 ||
      (Sq + kBlockM - 1) / kBlockM > 65535 || (causal && Sq > Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(
        launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, causal != 0, s));
  if (dtype == 2)
    return static_cast<int>(
        launch_d<__half>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, causal != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
