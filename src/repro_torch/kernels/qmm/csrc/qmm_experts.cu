// The expert products of a mixture-of-experts layer on the tensor cores of
// NVIDIA Hopper, sm_90a: a stack of E packed kernels applied to bf16 x in one
// launch, touching only the slots in use.
//
// repro_qmm_experts stands for repro/kernels/qmm/kernel.py::qmm_pallas (def
// :238, pallas_call :265) applied to each expert of a stack, the reference's
// einsum("ecd,edf->ecf", xe, materialize(W)) (repro/models/moe.py:56-58):
//
//     y[e, m, n] = (sum_k x[e, m, k] * (c[e, n, k] - K_h)) * scale[e, n] / K_h
//                                                  for m < rows[e], else 0
//
// x is (E, C, K) bf16, c is (E, N, Kp) uint8 with Kp = K / vpb and vpb = 8 /
// bits codes per byte (code i of a byte at bit bits*i, biased by +K_h),
// scale (E, N) f32, rows (E,) int32 on the card, y (E, C, N) f32.
//
// The rows contract. rows[e] is clamped to [0, C]. Rows m < rows[e] of y[e]
// are the product; rows m >= rows[e] are written as 0 whatever x holds there.
// Only the m-tiles that hold a row in use become work items, so an expert
// with rows[e] = 0 reads none of its codes and x rows past the last m-tile
// in use are never read; inside that m-tile, x is read up to rows[e] rounded
// up to 8 (a TMA box). So the result equals the full product exactly when
// x's rows past rows[e] are zero, which is what a mixture-of-experts
// dispatch gives: slots fill from 0 upward, so expert e's rows in use are a
// prefix. The host never reads rows.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), at
// qwen3-moe-30b-a3b's stacks (128 experts, 768 x 2,048 and 2,048 x 768, 4
// bits):
//   * C = 1 (a decode step): the bytes of the routed experts' codes, 0.79 MB
//     an expert and stack, about 12 us at the ~51 experts a layer that carry
//     a row; the 128 experts' codes are 0.030 ms.
//   * C = 320 (a prefill group's capacity): the operations, one bf16 pass,
//     2 E C N K = 129 GFLOP, 0.130 ms, beside 0.118 ms of bytes (codes, bf16
//     x, f32 y) for wi_gate; for wo the bytes, 0.149 ms (its f32 y is 335 MB).
// As built (PERF.md), C = 320 runs near the bytes of x, codes and y, and
// C = 1 at about 3x the routed codes' bytes.
//
// Design, and what it does about each:
//   * Exact in one piece. A code minus K_h is an integer in [-64, 64], exact
//     in bf16; a bf16 x is taken as it is; a bf16 product is exact in f32 and
//     the sums are f32, as the reference's own f32 sums. So x is read at 2
//     bytes a value and multiplied once: no split into pieces, no row maxima,
//     no prescale (those belong to f32 x, qmm_wgmma.cu).
//   * x is the wgmma B operand and comes by TMA, K-major with the 128-byte
//     swizzle (the layout of flashattn_wgmma.cu's K tile), from 3-D maps
//     over (K, C, E), so rows past C read as 0: one box of the m-tile's rows
//     when all are in use, else boxes of 32 and 8 rows. No thread touches x.
//   * One block covers a wide x tile: NB = 8 .. 160 x rows of one expert (the
//     wgmma's N), chosen on the host from C alone: C = 320 is two m-tiles of
//     160, C = 1 one of 8. Each code is unpacked once per NB x rows.
//   * The codes stay A, from registers: two consumer warpgroups of 64 code
//     rows each read their rows' 16-byte units of a stage from shared memory
//     and turn them into bf16 pairs in natural k order (x is not permuted):
//     byte gathers (prmt) put each code in the low byte of bf16 128.0, then
//     one bf16x2 subtract of 128 + K_h; at 4 bits 16 instructions give a
//     thread its 8 codes of a unit. The codes arrive by TMA in boxes of 128
//     rows x 32, 64 or 128 bytes (2, 4, 8 bits: 128 codes a stage) with the
//     matching swizzle, through a ring of mbarrier stages fed by one
//     producer thread. A stage's two x boxes are two wgmma groups, each from
//     A registers of its own, so one box's unpacking overlaps the other's
//     multiplies.
//   * Only the slots in use are work. Every block first scans rows (E
//     values) into an index of the active items, (expert, m-tile holding a
//     row in use, 128-row code tile), experts in order, so the code tiles of
//     one x tile run side by side and share it in L2. A persistent grid (one
//     block an SM) takes active items from an atomic counter, so the busy
//     experts' items spread over the SMs whatever the routing; the producer
//     hands each to the consumers through a small ring of its own and loads
//     its stages while they finish the one before. The other producer warps
//     write the zeros of y past each expert's last m-tile in use, beside the
//     products. No split-K: at C = 1 the routed experts' tiles (about 300
//     items of wi_gate, 800 of wo) already fill the SMs, and a split's
//     partials would cost a workspace and a ticket per item.
//   * Each output is one f32 sum over K in a fixed order, in one block: the
//     same inputs give the same bits, whichever block takes an item.
//   * A wait on an mbarrier that lasts ~10 s traps, so a pipeline fault
//     fails the launch instead of hanging the card.
//
// Plain C interface, built with nvcc and loaded with ctypes: the entry
// encodes the tensor maps, launches on the given stream, does not
// synchronise and returns a cudaError_t. The caller passes two int32
// counters that are zero; the kernel leaves them zero again. Launches that
// share counters must run on one stream.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 128;              // code rows (outputs n) of a tile: two consumer warpgroups of 64
constexpr int kDepth = 128;             // k of a stage: eight k16 steps
constexpr int kAtom = 64;               // bf16 columns of one 128-byte swizzled x row
constexpr int kBoxes = kDepth / kAtom;  // x boxes of a stage, four k16 steps each
constexpr int kBoxRows = 8;             // x rows of one TMA box
constexpr int kThreads = 384;           // producer warpgroup + two consumer warpgroups
constexpr int kProducers = 128;
constexpr int kConsumers = 256;
constexpr int kItemSlots = 4;           // the ring of work items handed to the consumers
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = 200 * 1024;
constexpr int kMaxSmem = 232448;        // what a block may use on an H100
constexpr long long kWatchdogCycles = 1ll << 34;  // ~10 s: a wait this long is a fault
constexpr int kMaxDevices = 64;
constexpr uint32_t kHigh = 0x43u;       // the high byte of bf16 128.0

template <int BITS>
struct Fmt {
  static constexpr int kVpb = 8 / BITS;
  static constexpr int kHalf = (1 << (BITS - 1)) / 2;                // K_h
  static constexpr int kRowBytes = kDepth / kVpb;                    // code bytes of a row a stage
  static constexpr int kUnits = kRowBytes / 16;                      // its 16-byte units: 2, 4, 8
  static constexpr int kSwz = kUnits - 1;                            // TMA swizzle of 32, 64, 128 B
  static constexpr int kCStage = kRows * kRowBytes;
  static constexpr uint32_t kBias = 0x43004300u + 0x00010001u * kHalf;  // bf16 128 + K_h, twice
};

// Shared memory of a block, from a 1024-byte aligned base: the x ring (two
// boxes of NB rows a stage), the code ring, the barriers, the item ring,
// then the experts' index (each one's first item and rows in use).
template <int BITS, int NB>
struct Layout {
  static constexpr int kXBox = NB * 128;
  static constexpr int kXStage = kBoxes * kXBox;
  static constexpr int kCStage = Fmt<BITS>::kCStage;
  static constexpr int kFit = kSmemBudget / (kXStage + kCStage);
  static constexpr int kStages = kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr int kX = 0;
  static constexpr int kC = kX + kStages * kXStage;
  static constexpr int kBars = kC + kStages * kCStage;
  static constexpr int kItems = kBars + 8 * (2 * kStages + 2 * kItemSlots);
  static constexpr int kExperts = kItems + 16 * kItemSlots;
  // + alignment slack; the launch adds the experts' index, 8 (E + 1) bytes
  static constexpr int kBytes = kExperts + 1024;
  static_assert(kStages >= 2, "ring");
  static_assert(kXBox % 1024 == 0 && kCStage % 1024 == 0, "swizzle alignment");
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

// One box of a 3-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(c2)
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x NB) {=, +=} A (64 x 16, registers, bf16) B (16 x NB, shared,
// K-major, 128-byte swizzle).
template <int NB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NB / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Byte o of row r of a code stage: TMA's swizzle of 32, 64 or 128 bytes
// (16-byte unit bits ^= address bits [7:...], from a 1024-byte aligned stage).
template <int BITS>
__device__ __forceinline__ uint32_t code_off(int r, int o) {
  const uint32_t a = static_cast<uint32_t>(r * Fmt<BITS>::kRowBytes + o);
  return a ^ (((a >> 7) & static_cast<uint32_t>(Fmt<BITS>::kSwz)) << 4);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  const uint32_t one = 0x3F803F80u;        // bf16 1.0 in both halves
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(one), "r"(b ^ 0x80008000u));
  return d;
}

// Two codes (c0 in byte 0, c1 in byte 1 of t, or bytes 2 and 3 when HIGH)
// as the bf16 pair (c0, c1) - K_h: each code under the high byte of 128.0.
template <int BITS, bool HIGH>
__device__ __forceinline__ uint32_t pair(uint32_t t) {
  return bf16x2_sub(__byte_perm(t, kHigh, HIGH ? 0x4342 : 0x4140), Fmt<BITS>::kBias);
}

// A of box b of a stage (k16 steps 4b .. 4b + 3) for the
// thread's rows r and r + 8 (t: the thread of the row's four): a[s] holds
// step 4b + s, [0] row r columns 2t, 2t + 1, [1] row r + 8 the same, [2] row
// r columns 2t + 8, 2t + 9, [3] row r + 8 the same (the wgmma A fragment),
// codes in natural k order, since x is not permuted. `sel`: the thread's
// byte selector (4 bits: byte t of two words; 8 bits: the pair at byte 2(t %
// 2) of a word), `sh`: its shift (2 bits: 4t).
template <int BITS>
__device__ __forceinline__ void fill(uint32_t (&a)[4][4], const uint8_t* cst, int b, int r, int t,
                                     uint32_t sel, uint32_t sh) {
  constexpr int kPerBox = 4 / Fmt<BITS>::kVpb;           // 16-byte units of a row a box
#pragma unroll
  for (int v = 0; v < kPerBox; ++v) {
    const int u = b * kPerBox + v;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 w = *reinterpret_cast<const uint4*>(cst + code_off<BITS>(r + 8 * h, 16 * u));
      if constexpr (BITS == 4) {
        // unit u is steps 2u (words x, y: codes 0-7, 8-15) and 2u + 1 (z, w);
        // the thread's codes 2t, 2t + 1 (and + 8) are the nibbles of byte t
        // of each word
        const uint32_t g = __byte_perm(__byte_perm(w.x, w.y, sel), __byte_perm(w.z, w.w, sel),
                                       0x5410);                     // byte t of x, y, z, w
        const uint32_t lo = g & 0x0F0F0F0Fu, hi = (g >> 4) & 0x0F0F0F0Fu;
        const uint32_t s0 = __byte_perm(lo, hi, 0x5140), s1 = __byte_perm(lo, hi, 0x7362);
        a[2 * v][h] = pair<BITS, false>(s0);
        a[2 * v][2 + h] = pair<BITS, true>(s0);
        a[2 * v + 1][h] = pair<BITS, false>(s1);
        a[2 * v + 1][2 + h] = pair<BITS, true>(s1);
      } else if constexpr (BITS == 2) {
        // unit u is steps 4u .. 4u + 3, a word each; codes 2t, 2t + 1 are
        // nibble t, codes 2t + 8, 2t + 9 nibble t + 4
        const uint32_t w4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t b = w4[s] >> sh;
          const uint32_t p = __byte_perm(b & 0x00030003u, (b >> 2) & 0x00030003u, 0x6240);
          a[s][h] = pair<BITS, false>(p);
          a[s][2 + h] = pair<BITS, true>(p);
        }
      } else {
        // unit u is step u: codes 2t, 2t + 1 are bytes 2t, 2t + 1, codes 2t
        // + 8, 2t + 9 bytes 2t + 8, 2t + 9
        const uint32_t wl = (t & 2) ? w.y : w.x, wh = (t & 2) ? w.w : w.z;
        a[v][h] = bf16x2_sub(__byte_perm(wl, kHigh, sel), Fmt<BITS>::kBias);
        a[v][2 + h] = bf16x2_sub(__byte_perm(wh, kHigh, sel), Fmt<BITS>::kBias);
      }
    }
  }
}

struct Args {
  const float* scale;
  const int* rows;
  float* y;
  int* counters;        // [0] the next item, [1] blocks done: zero on entry and exit
  int E, C, N, Kp;
  int tiles, chunks;    // 128-row code tiles of N, stages over K
};

// The active work items, experts in order: expert e's items are its m-tiles
// that hold a row in use, times the code tiles, (m-tile, tile) in that
// order; `first` holds, per expert, the index of its first item (E + 1
// entries) and `in_use` its rows in use.
template <int NB>
__device__ __forceinline__ int4 item_of(const Args& a, const int* first, const int* in_use, int w) {
  int lo = 0, hi = a.E;                              // the expert: first[lo] <= w < first[lo + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= w) lo = mid;
    else hi = mid;
  }
  const int local = w - first[lo];
  const int mt = local / a.tiles;
  return make_int4(lo, mt, local - mt * a.tiles, min(in_use[lo] - mt * NB, NB));
}

template <int BITS, int NB>
__global__ void __launch_bounds__(kThreads, 1)
qmm_experts_kernel(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap xmap8,
                   const __grid_constant__ CUtensorMap xmap32,
                   const __grid_constant__ CUtensorMap xmap_tile, const Args a) {
  using F = Fmt<BITS>;
  using L = Layout<BITS, NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* item_full = empty + L::kStages;
  uint64_t* item_empty = item_full + kItemSlots;
  int4* items = reinterpret_cast<int4*>(smem + L::kItems);
  int* first = reinterpret_cast<int*>(smem + L::kExperts);      // E + 1 entries
  int* in_use = first + a.E + 1;                                  // E entries

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);                 // the producer's expect_tx, then the TMA bytes
      mbar_init(empty + s, kConsumers);
    }
    for (int i = 0; i < kItemSlots; ++i) {
      mbar_init(item_full + i, 1);
      mbar_init(item_empty + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 && threadIdx.x < kProducers) {
    // ---- producer warps 1-3: y's rows past each expert's last m-tile in
    // use (a contiguous span of y[e]) are 0; a warp an expert, the grid's
    // warps in turn
    const int warps = (kProducers / 32 - 1) * static_cast<int>(gridDim.x);
    const int lane = threadIdx.x % 32;
    for (int e = static_cast<int>(blockIdx.x) * (kProducers / 32 - 1) + threadIdx.x / 32 - 1;
         e < a.E; e += warps) {
      const int used = min(max(__ldg(a.rows + e), 0), a.C);
      const int r = min((used + NB - 1) / NB * NB, a.C);
      float* span = a.y + (static_cast<size_t>(e) * a.C + r) * a.N;
      const size_t n = static_cast<size_t>(a.C - r) * a.N;
      if (a.N % 4 == 0) {
        for (size_t i = lane; i < n / 4; i += 32)
          reinterpret_cast<float4*>(span)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (size_t i = lane; i < n; i += 32) span[i] = 0.f;
      }
    }
    return;
  }
  if (threadIdx.x < 32) {
    // ---- producer warp 0: the active items' index (each expert's first
    // item, by a scan over the experts), then one thread takes items from
    // the counter, hands each to the consumers (expert, m-tile, tile, x rows
    // in use) and starts its stages' TMA boxes: the code tile, and x, a box
    // of the tile's rows when all are in use, else boxes of 32 and 8 rows up
    // to the rows in use rounded up to 8.
    const int lane = threadIdx.x;
    int carry = 0;
    for (int e0 = 0; e0 < a.E; e0 += 32) {
      const int e = e0 + lane;
      const int used = e < a.E ? min(max(__ldg(a.rows + e), 0), a.C) : 0;
      int v = (used + NB - 1) / NB * a.tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += up;
      }
      if (e < a.E) {
        first[e + 1] = carry + v;
        in_use[e] = used;
      }
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    if (lane != 0) return;
    first[0] = 0;
    const int n_work = carry;
    int j = 0;                                    // ring position, across items
    for (int i = 0;; ++i) {
      const int w = atomicAdd(a.counters, 1);
      const int is = i % kItemSlots;
      mbar_wait(item_empty + is, ((i / kItemSlots) & 1) ^ 1);
      if (w >= n_work) {
        items[is] = make_int4(-1, 0, 0, 0);
        mbar_arrive(item_full + is);
        // the last block to finish zeroes the counter for the next launch
        if (atomicAdd(a.counters + 1, 1) == static_cast<int>(gridDim.x) - 1) {
          atomicExch(a.counters, 0);
          atomicExch(a.counters + 1, 0);
        }
        return;
      }
      const int4 it = item_of<NB>(a, first, in_use, w);   // (e, mt, tile, mv)
      items[is] = it;
      mbar_arrive(item_full + is);
      const int rows8 = (it.w + kBoxRows - 1) / kBoxRows * kBoxRows;
      const uint32_t bytes = F::kCStage + kBoxes * rows8 * 128u;
      for (int c = 0; c < a.chunks; ++c, ++j) {
        const int slot = j % L::kStages;
        mbar_wait(empty + slot, ((j / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + slot, bytes);
        const int k0 = c * kDepth;
        tma_load(smem + L::kC + slot * L::kCStage, &cmap, full + slot, c * F::kRowBytes,
                 it.z * kRows, it.x);
        uint8_t* xs = smem + L::kX + slot * L::kXStage;
        for (int b = 0; b < kBoxes; ++b) {
          const int col = k0 + b * kAtom, m0 = it.y * NB;
          uint8_t* dst = xs + b * L::kXBox;
          if (rows8 == NB) {
            tma_load(dst, &xmap_tile, full + slot, col, m0, it.x);
            continue;
          }
          int done = 0;
          for (; done + 32 <= rows8; done += 32)
            tma_load(dst + done * 128, &xmap32, full + slot, col, m0 + done, it.x);
          for (; done < rows8; done += kBoxRows)
            tma_load(dst + done * 128, &xmap8, full + slot, col, m0 + done, it.x);
        }
      }
    }
  }

  // ---- consumer warpgroups: code rows 64 cw .. 64 cw + 63 of a tile
  const int ct = threadIdx.x - kProducers;
  const int cw = ct / 128;
  const int wq = (ct / 32) % 4, lane = ct % 32;
  const int t = lane % 4;
  const int r0 = 64 * cw + 16 * wq + lane / 4;       // this thread's rows r0 and r0 + 8
  const uint32_t sel = BITS == 4 ? static_cast<uint32_t>(t | ((t + 4) << 4))
                                 : ((t & 1) ? 0x4342u : 0x4140u);
  const uint32_t sh = 4u * t;
  const float inv = 1.0f / static_cast<float>(F::kHalf);
  int j = 0;                                         // ring position, across items
  for (int i = 0;; ++i) {
    const int is = i % kItemSlots;
    mbar_wait(item_full + is, (i / kItemSlots) & 1);
    const int4 it = items[is];                       // (e, mt, tile, mv)
    mbar_arrive(item_empty + is);
    if (it.x < 0) break;
    float acc[NB / 2];
#pragma unroll
    for (int q = 0; q < NB / 2; ++q) acc[q] = 0.f;
    // A stage is two x boxes of four k16 steps each; each box's A is filled
    // into registers of its own and issued as one wgmma group. A box's
    // registers are filled again once the group that read them has retired
    // (at most one group in flight), so filling one box overlaps the other's
    // multiplies, and a stage is released once both its groups have retired.
    uint32_t a0[4][4], a1[4][4];
    for (int c = 0; c < a.chunks; ++c, ++j) {
      const int slot = j % L::kStages;
      mbar_wait(full + slot, (j / L::kStages) & 1);
      const uint8_t* cst = smem + L::kC + slot * L::kCStage;
      const uint32_t xa = smem_u32(smem + L::kX + slot * L::kXStage);
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
        uint32_t (&af)[4][4] = b ? a1 : a0;
        wgmma_wait<1>();                             // the group that read af has retired
        fence_regs(af);
        if (b == 1 && c > 0) mbar_arrive(empty + (j - 1) % L::kStages);   // and the last stage's
        fill<BITS>(af, cst, b, r0, t, sel, sh);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_rs<NB>(acc, af[s], smem_desc(xa + b * L::kXBox + s * 32, 16, 1024), 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a0);
    fence_regs(a1);
    mbar_arrive(empty + (j - 1) % L::kStages);

    // ---- epilogue: acc / K_h times the row scale at x rows < mv, 0 at x
    // rows mv .. of the tile inside C
    const int m0 = it.y * NB, n0 = it.z * kRows, mv = it.w;
    const int m_in = min(NB, a.C - m0);              // the tile's rows inside C
    const size_t row0 = static_cast<size_t>(it.x) * a.C + m0;
    int nn[2];
    float mult[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      nn[h] = n0 + r0 + 8 * h;
      mult[h] = nn[h] < a.N ? __ldg(a.scale + static_cast<size_t>(it.x) * a.N + nn[h]) * inv
                            : 0.f;
    }
#pragma unroll
    for (int q = 0; q < NB / 2; ++q) {
      const int ml = 8 * (q >> 2) + 2 * t + (q & 1), h = (q >> 1) & 1;
      if (ml < m_in && nn[h] < a.N)
        a.y[(row0 + ml) * a.N + nn[h]] = ml < mv ? acc[q] * mult[h] : 0.f;
    }
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

// A (D0, D1, D2) tensor of `unit`-byte elements, read in (B0, B1, 1) boxes;
// elements past its edges read as 0.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int unit,
            int d0, int d1, int d2, int b0, int b1, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * unit,
                                 static_cast<cuuint64_t>(d1) * d0 * unit};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// x rows of an m-tile: the smallest of these that holds C / ceil(C / 160).
constexpr int kTileRows[] = {8, 16, 32, 64, 96, 128, 160};

int tile_rows(int C) {
  const int most = kTileRows[sizeof(kTileRows) / sizeof(int) - 1];
  const int tiles = (C + most - 1) / most;
  const int per = (C + tiles - 1) / tiles;
  for (int nb : kTileRows)
    if (per <= nb) return nb;
  return most;
}

template <int BITS, int NB>
cudaError_t launch(const void* x, const void* c, const Args& a, cudaStream_t stream) {
  using L = Layout<BITS, NB>;
  const auto kernel = qmm_experts_kernel<BITS, NB>;
  const int bytes = L::kBytes + 8 * (a.E + 1);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  static int opted[kMaxDevices] = {0};              // the dynamic shared memory opted into
  const int dev = current_device();
  if (opted[dev] < bytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = bytes;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  constexpr CUtensorMapSwizzle kCodeSwizzle = BITS == 2   ? CU_TENSOR_MAP_SWIZZLE_32B
                                              : BITS == 4 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_128B;
  const int K = a.Kp * Fmt<BITS>::kVpb;
  CUtensorMap cmap, xmap8, xmap32, xmap_tile;
  if (!encode(fn, &cmap, c, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.Kp, a.N, a.E,
              Fmt<BITS>::kRowBytes, kRows, kCodeSwizzle) ||
      !encode(fn, &xmap8, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, a.C, a.E, kAtom, kBoxRows,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(fn, &xmap32, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, a.C, a.E, kAtom, 32,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(fn, &xmap_tile, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, a.C, a.E, kAtom, NB,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // every block takes items from the counter: as many blocks as SMs, or as
  // the items there would be with every row in use
  const long long most = static_cast<long long>(a.E) * ((a.C + NB - 1) / NB) * a.tiles;
  const unsigned grid = static_cast<unsigned>(most < num_sms() ? most : num_sms());
  kernel<<<grid, kThreads, bytes, stream>>>(cmap, xmap8, xmap32, xmap_tile, a);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_nb(const void* x, const void* c, const Args& a, cudaStream_t stream) {
  switch (tile_rows(a.C)) {
    case 8: return launch<BITS, 8>(x, c, a, stream);
    case 16: return launch<BITS, 16>(x, c, a, stream);
    case 32: return launch<BITS, 32>(x, c, a, stream);
    case 64: return launch<BITS, 64>(x, c, a, stream);
    case 96: return launch<BITS, 96>(x, c, a, stream);
    case 128: return launch<BITS, 128>(x, c, a, stream);
    default: return launch<BITS, 160>(x, c, a, stream);
  }
}

}  // namespace

// x (E, C, K) bf16 and c (E, N, Kp) uint8, both starting on a 16-byte
// boundary, with K a multiple of 8 and Kp = K * bits / 8 a multiple of 16;
// scale (E, N) f32; rows (E,) int32; y (E, C, N) f32 on a 16-byte boundary;
// counters two int32 that are zero.
extern "C" int repro_qmm_experts(const void* x, const unsigned char* c, const float* scale,
                                 const int* rows, float* y, int* counters, int E, int C, int N,
                                 int K, int Kp, int bits, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0 || C <= 0 || N <= 0 || K <= 0 || K % 8 || Kp != K / (8 / bits) || Kp % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(c) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(E) * C * ((N + kRows - 1) / kRows);
  if (items > 0x7FFFFFFFll || static_cast<long long>(E) * N > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.scale = scale;
  a.rows = rows;
  a.y = y;
  a.counters = counters;
  a.E = E;
  a.C = C;
  a.N = N;
  a.Kp = Kp;
  a.tiles = (N + kRows - 1) / kRows;
  a.chunks = (K + kDepth - 1) / kDepth;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return static_cast<int>(launch_nb<2>(x, c, a, s));
    case 4: return static_cast<int>(launch_nb<4>(x, c, a, s));
    default: return static_cast<int>(launch_nb<8>(x, c, a, s));
  }
}
