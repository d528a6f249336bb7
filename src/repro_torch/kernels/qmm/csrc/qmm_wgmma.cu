// Packed low-precision matmul (qmm) on the tensor cores of NVIDIA Hopper, sm_90a.
//
// Three entries share one kernel:
//
// repro_qmm_tc replaces repro/kernels/qmm/kernel.py::qmm_pallas (def :238,
// pallas_call :265), the per-tensor / per-channel packed Φ̂:
//
//     y[m, n] = (sum_k x[m, k] * (c[n, k] - K_h)) * scale[n] / K_h
//
// repro_qmm_group_tc replaces qmm_group_pallas (def :188, pallas_call :221),
// the block-scaled (per_block) Φ̂, one scale per g contiguous codes, for g a
// multiple of 16 codes (other g keep the CUDA-core row walk of qmm.cu):
//
//     y[m, n] = (sum_k x[m, k] * (c[n, k] - K_h) * scale[n, k / g]) / K_h
//
// repro_qmm_tc_batched applies repro_qmm_tc's function to a stack of E
// kernels in one launch (the expert products of a mixture-of-experts layer,
// the reference's einsum("ecd,edf->ecf", xe, materialize(W)) at
// repro/models/moe.py:56-58):
//
//     y[e, m, n] = (sum_k x[e, m, k] * (c[e, n, k] - K_h)) * scale[e, n] / K_h
//
// The expert rides on the work items: x and y are read as (E * M, K) and
// (E * M, N), the codes as (E * N, Kp), and each m-tile of x belongs to one
// expert, whose code rows, scales, split-K partials and tickets it uses. A
// 2-D call is the case E = 1.
//
// x is (M, K) float32, c is (N, Kp) uint8 with Kp = ceil(K / vpb) and vpb =
// 8 / bits codes per byte (code i of a byte at bit bits*i, biased by +K_h).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at M = 1
// and M = 8 the bytes, N*Kp codes (+ 4*N*ceil(K/g) scale bytes) plus x and y
// moved once: 4.3-4.9 us at the LOFAR CS302 shapes in 2 bits. The CUDA-core
// kernel it replaces sat at 6-11x that (x re-read through L2 by every row,
// codes one byte per load, f32 FMAs: 2*M*N*K of them bound it at 13.6 us at
// M = 8 and 109 us at M = 64). At M = 64 the tensor work below is 22 GFLOP,
// 22 us at the bf16 peak, beside 9.3 us of bytes. As built, this kernel is
// bound by instruction issue, not bytes: unpacking a code costs about 1.5
// instructions in the consumers, splitting x about 8 per value in the
// producer, and the SM's four schedulers are the limit (PERF.md).
//
// Design, and what it does about that:
//   * The contraction runs on wgmma (m64nNk16, bf16 in, f32 accumulate), and
//     stays exact. A code minus K_h is an integer in [-64, 64], exact in
//     bf16. An f32 x is exactly hi + mid + lo, three bf16 pieces (hi =
//     bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); exact for
//     2^-110 <= |x| < 2^128 - 2^119), and a bf16 product is exact in f32.
//   * Every f32 x gets there. The block takes the largest |x| of each x row
//     over each work item's range of K: one read of that range, for its
//     first four ranges by the consumer warps while the producer starts its
//     copies (they are idle until the first stage lands), for any later one
//     by the producer (in a call of its own, so that its registers do not
//     crowd the loop). A row whose largest |x| lies in [2^-40, 2^64) is
//     split as it is: every x down to 2^-70 of the largest is in the exact
//     range, and sums stay below 2^101. Any other row is scaled by a power
//     of two, 2^E with E = 64 - floor(log2 max|x|), which puts its largest
//     |x| in [2^64, 2^65): scaling by a power of two is exact, every x down
//     to 2^-174 of the largest splits exactly, and the sums keep the same
//     headroom. (Smaller x count below f32's own rounding of the sum.) The
//     epilogue scales the f32 result back by 2^-(E + log2 K_h) (ldexpf,
//     exact unless the result itself overflows or falls below the normal
//     range, as the reference's own sum would) before the row scale, so
//     rows of ordinary x compute exactly what they did without the
//     prescale. One power of two per row cannot cover f32's whole range:
//     an x more than 2^70 (scaled rows: 2^174) below its row's largest
//     rounds in the lo piece, by at most 2^-134 of the scaled row, which
//     only shows where every larger x of the row meets a zero code.
//     The three pieces of x row m are three B columns; the epilogue sums
//     them in f32 as hi + (mid + lo). A row with one nonzero code c thus
//     gives fl(c * x) exactly, as the f32 reference does: mid + lo = x - hi
//     has at most 16 significant bits, so c * (mid + lo) is exact and only
//     the last sum rounds. ((hi + mid) + lo rounds twice: hi + mid can span
//     more than 24 bits when x - hi is small.)
//   * A (the Φ̂ rows) comes from registers: one block is 128 rows of Φ̂, two
//     consumer warpgroups of 64. Each consumer thread reads its own codes
//     from shared memory and turns them into bf16 pairs in place: the code
//     goes into the low mantissa of bf16 128.0 (lop3 or prmt), then one
//     bf16x2 subtract of 128 + K_h. An 8-bit code (0..128) is added, not
//     or-ed, to 0x4300: 0x4300 + 128 is bf16 256.0.
//   * The contraction order is free, so x is permuted instead of the codes.
//     Within a k16 step, thread t of a row's four holds four codes c0..c3
//     as A columns 2t <- c0, 2t+1 <- c2, 2t+8 <- c1, 2t+9 <- c3. Word
//     layout (per-row scales, and groups of 16 * vpb codes): thread t's
//     aligned 4-byte word of each 16-byte block of a row holds its codes
//     of vpb steps, so one load feeds vpb steps. Step layout (groups of 16
//     or 32 codes at 2 and 4 bits): step s holds codes 16s .. 16s + 15, so
//     no step straddles a group. The producer writes x into B in the same
//     order.
//   * x arrives as the B operand: producer threads split x[:, chunk] and
//     write hi, mid and lo into shared memory K-major with the 128-byte
//     swizzle (the layout of flashattn_wgmma.cu's K tile), so x is read once
//     per block and stage, not once per row. A block takes up to Mt = 32
//     rows of x (n = 96 B columns; 16 rows, n = 48, for the group kernel,
//     whose two temporaries would not fit registers at 96; the plan's
//     64-row tile would need a 192 KB B stage at 2 bits); larger M walks
//     m-tiles. The three columns of one x row sit in one thread's
//     accumulator, so the epilogue needs no shuffle.
//   * Codes stream through a ring of stages of 128 rows x 64 bytes, with
//     "full" and "empty" mbarriers. Producer warp 0 starts one 2-D TMA box
//     (64-byte swizzle) per stage as soon as its slot is free, when rows are
//     a multiple of 16 bytes (the LOFAR forward, Kp = 16,384). Otherwise
//     (the adjoint's 218-byte rows, ragged shapes) the three other producer
//     warps copy the aligned 16-byte chunks around each row's window with
//     cp.async and realign them with funnel shifts, never reading outside
//     the code array (its start must be 16-byte aligned). Bytes past Kp and
//     rows past N read as 0; they meet x columns that are 0, or land in
//     rows that are not stored.
//   * Those three warps copy everything a stage needs (x, the code chunks,
//     the scales) a whole ring ahead into their own staging slots with
//     cp.async, so no global load latency stands in their loop. Integer
//     work is 32-bit (a 64-bit division is a called routine, slow while the
//     instruction cache is cold), and loops over items stay rolled to keep
//     the kernel small, so the first TMA starts early.
//   * Split-K: a 128-row tile of the forward orientation (N = 870: 7 tiles)
//     would leave most SMs idle, so K is cut into S parts, enough to fill
//     the SMs twice (S from N, K and the SM count only, never M). Each part
//     writes its partial sum to a workspace; the last block of a tile, found
//     by an atomic ticket, adds the partials in the fixed order s = 0 ..
//     S-1, eight loads in flight. No float atomics: the same inputs give
//     the same bits, and row b of a batch computes what a single row
//     computes. Blocks walk work items (m-tile, split, tile) in a loop, so
//     the short adjoint tiles keep the ring full across items; small
//     configurations fit two blocks on an SM.
//   * The k16 steps run in units of U steps, two units at a time: both
//     units' A registers are filled, then both are issued, then waited for.
//     No register a wgmma reads is written while one is in flight (ptxas
//     serializes every wgmma otherwise, C7513); the two consumer warpgroups,
//     and the blocks beside them on the SM, fill while the others multiply.
//     At n <= 48 the two units run into two accumulators, so their chains
//     overlap.
//   * Group scales: U (4, 2 or 1) divides g/16 and each unit runs into a
//     fresh temporary, two of them: the first unit's pieces are summed and
//     added as acc += scale[n, grp] * tmp while the second's wgmma runs.
//     The producer stages the scales with the codes, one per row and unit.
//   * A wait on an mbarrier that lasts ~10 s traps (clock64 watchdog), so a
//     pipeline fault fails the launch instead of hanging the card.
//
// Plain C interface, built with nvcc and loaded with ctypes: the entries
// encode the tensor map (cuTensorMapEncodeTiled, looked up at run time
// through the CUDA runtime), launch on the given stream, do not synchronise
// and return a cudaError_t. The caller passes the split-K workspace (S * M * N
// floats, S from repro_qmm_tc_batched_splits at E = 1) and ticket counters
// that are zero; the kernel leaves them zero again. Launches that share
// counters must run on one stream.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 128;                 // Φ̂ rows of a block: two consumer warpgroups of 64
constexpr int kRowBytes = 64;              // code bytes of a row in one stage
constexpr int kCodeStage = kRows * kRowBytes;
constexpr int kThreads = 384;              // producer warpgroup + two consumer warpgroups
constexpr int kProducers = 128;            // warp 0 starts the TMA boxes, warps 1-3 the rest
constexpr int kData = 96;                  // the producer threads that copy and write out
constexpr int kConsumers = 256;
constexpr int kSmemBudget = 212 * 1024;    // the rings of one block
constexpr int kSmallBudget = 110 * 1024;   // ... of one of two blocks on an SM
constexpr long long kWatchdogCycles = 1ll << 34;  // ~10 s: a wait this long is a fault
constexpr int kMaxDevices = 64;
constexpr int kPre = 4;                    // x ranges whose row maxima a block takes up front

template <int BITS>
struct Fmt {
  static constexpr int kVpb = 8 / BITS;
  static constexpr int kShift = BITS == 2 ? 2 : (BITS == 4 ? 1 : 0);  // log2(vpb)
  static constexpr int kHalf = (1 << (BITS - 1)) / 2;
  static constexpr int kLog2Half = BITS == 2 ? 0 : (BITS == 4 ? 2 : 6);
  static constexpr int kCodes = kRowBytes * kVpb;       // codes of a row per stage
  static constexpr int kSteps = kCodes / 16;            // k16 steps per stage: 16, 8, 4
};

// NB B columns: Mpt x rows per thread (three columns each), Mt per block.
template <int NB>
struct Cols {
  static constexpr int kMpt = (NB / 4) / 3;             // 16 -> 1, 24 -> 2, 48 -> 4, 96 -> 8
  static constexpr int kMt = 4 * kMpt;
  static_assert(NB % 8 == 0 && kMpt >= 1, "NB");
};

// Per stage, what the data threads copy ahead with cp.async into a staging
// slot: x quads and scales (each thread reads back its own), and, when the
// codes do not come by TMA, the aligned 16-byte chunks around each row's
// window (shared: realigned after a barrier among the data threads).
template <int BITS, int NB, int U, bool GROUP>
struct Stage {
  static constexpr int kXItems = (Cols<NB>::kMt * Fmt<BITS>::kCodes / 4 + kData - 1) / kData;
  static constexpr int kUnits = Fmt<BITS>::kSteps / U;
  static constexpr int kChunks = kRows * (kRowBytes / 16 + 1);   // aligned 16-byte chunks
  // bytes of one staging slot: x quads (item-major over the data threads),
  // the code chunks of 128 rows (five per row), the scales of each row
  static constexpr int kX = 0;
  static constexpr int kW = kX + kXItems * kData * 16;
  static constexpr int kS = kW + kChunks * 16;
  static constexpr int kBytes = kS + (GROUP ? kUnits * kRows * 4 : 0);
};

// Shared memory of a block, from a 1024-byte aligned base: the B ring, the
// code ring, the scale ring (group kernel), the producers' staging ring,
// then the barriers and a flag.
template <int BITS, int NB, int U, bool GROUP>
struct Layout {
  using St = Stage<BITS, NB, U, GROUP>;
  static constexpr int kBStage = NB * Fmt<BITS>::kCodes * 2;
  static constexpr int kUnits = Fmt<BITS>::kSteps / U;
  static constexpr int kSStage = GROUP ? kRows * kUnits * 4 : 0;
  static constexpr int kPStage = (St::kBytes + 1023) / 1024 * 1024;
  static constexpr int kStage = kBStage + kCodeStage + kSStage + kPStage;
  // two or more stages in kSmallBudget let two blocks share an SM
  static constexpr int kSmall = kSmallBudget / kStage >= 2;
  static constexpr int kFit = (kSmall ? kSmallBudget : kSmemBudget) / kStage;
  static constexpr int kStages = kFit > 6 ? 6 : kFit;
  static constexpr int kB = 0;
  static constexpr int kC = kB + kStages * kBStage;
  static constexpr int kS = kC + kStages * kCodeStage;
  static constexpr int kP = kS + kStages * kSStage;
  static constexpr int kBars = kP + kStages * kPStage;
  // per stage, the exponent E of each x row of its work item; the
  // producers' row maxima, exponents and scale factors of the current range
  static constexpr int kMt = Cols<NB>::kMt;
  static constexpr int kE = kBars + 16 * kStages + 16;
  static constexpr int kRow = kE + 4 * kStages * kMt;
  // the block's first kPre x ranges: (m-tile, split) keys, their number,
  // their rows' largest |x|
  static constexpr int kPreKey = kRow + 16 * kMt + 16;
  static constexpr int kPreMax = kPreKey + 8 * kPre + 16;
  static constexpr int kBytes = kPreMax + 4 * kPre * kMt + 1024;  // + alignment slack
  static_assert(kStages >= 2, "ring");
  static_assert(kUnits % 2 == 0, "units go in pairs");
  static_assert(kBStage % 1024 == 0 && kSStage % 512 == 0, "alignment");
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

// A (64-byte, 128-row) box of the 2-D code map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
        "r"(row)
      : "memory");
}

// Generic-proxy writes to shared memory (B, codes, scales) become visible
// to the async proxy (wgmma) once the barrier that follows completes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cp.async: `bytes` (<= size) bytes from global memory, the rest of the
// size zero-filled; completion is per thread (commit / wait groups).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<24>(float (&d)[12], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
// Byte o of row r of a code stage: TMA's 64-byte swizzle (16-byte unit bits
// [4:5] ^= address bits [7:8], from a 512-byte aligned stage).
__device__ __forceinline__ uint32_t code_off(int r, int o) {
  const uint32_t a = static_cast<uint32_t>(r * kRowBytes + o);
  return a ^ (((a >> 7) & 3u) << 4);
}

// Byte offset of B element (column col, permuted k kl) in a B stage of NB
// columns: 64-k atoms of NB 128-byte rows, 128-byte swizzle.
template <int NB>
__device__ __forceinline__ uint32_t b_off(int col, int kl) {
  return static_cast<uint32_t>((kl >> 6) * NB * 128 + col * 128 +
                               ((((kl & 63) >> 3) ^ (col & 7)) << 4) + (kl & 7) * 2);
}

// B column of piece p (0 hi, 1 mid, 2 lo) of the block's x row ml: thread
// t = ml / Mpt of a row's four holds rows t*Mpt .. in its accumulator slots
// q = 3i + p, i.e. columns 8(q/2) + 2t + q%2.
template <int NB>
__device__ __forceinline__ int b_col(int ml, int p) {
  constexpr int mpt = Cols<NB>::kMpt;
  const int q = 3 * (ml % mpt) + p;
  return 8 * (q >> 1) + 2 * (ml / mpt) + (q & 1);
}

// The permuted k of x quad qd (codes 4 qd .. 4 qd + 3 of a stage, c0..c3 of
// one thread's four) for the (c0, c2) pair; (c1, c3) is 8 further. Step
// layout: step qd / 4, thread qd % 4. Word layout (thread t's aligned word
// of a 16-byte block holds its codes of vpb steps): block qd / (4 vpb),
// thread (qd % (4 vpb)) / vpb, step vpb * block + qd % vpb.
template <int BITS, bool WORD>
__device__ __forceinline__ int x_col0(int qd) {
  if constexpr (WORD) {
    constexpr int vpb = Fmt<BITS>::kVpb;
    const int blk = qd / (4 * vpb), p4 = qd - blk * 4 * vpb;
    return 16 * (vpb * blk + p4 % vpb) + 2 * (p4 / vpb);
  } else {
    return 16 * (qd >> 2) + 2 * (qd & 3);
  }
}

// The accumulator register of slot q (see b_col) for row half h (rows l/4, +8).
__device__ __forceinline__ constexpr int acc_idx(int q, int h) {
  return 4 * (q >> 1) + 2 * h + (q & 1);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  const uint32_t one = 0x3F803F80u;        // bf16 1.0 in both halves
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(one), "r"(b ^ 0x80008000u));
  return d;
}

// The thread's four codes c0..c3 of one row and k16 step (low 8, 16 or 32
// bits of q) as bf16 pairs lo = (c0, c2) - K_h and hi = (c1, c3) - K_h.
template <int BITS>
__device__ __forceinline__ void unpack(uint32_t q, uint32_t& lo, uint32_t& hi) {
  constexpr uint32_t kExp = 0x43004300u;                  // bf16 128.0, both halves
  constexpr uint32_t kBias = 0x43004300u + 0x00010001u * Fmt<BITS>::kHalf;  // 128 + K_h
  uint32_t a, b;
  if constexpr (BITS == 2) {
    const uint32_t p = q * 0x1001u;                       // the byte at bits 0 and 12
    a = (p & 0x00030003u) | kExp;
    b = ((p >> 2) & 0x00030003u) | kExp;
  } else if constexpr (BITS == 4) {
    const uint32_t p = __byte_perm(q, 0, 0x4140);          // [b0, 0, b1, 0]
    a = (p & 0x000F000Fu) | kExp;
    b = ((p >> 4) & 0x000F000Fu) | kExp;
  } else {
    a = __byte_perm(q, 0x43, 0x4240);                      // 0x43 above c0 and c2: 128 + c
    b = __byte_perm(q, 0x43, 0x4341);
  }
  lo = bf16x2_sub(a, kBias);
  hi = bf16x2_sub(b, kBias);
}

// Step layout: codes of row r of a stage for k16 step ks, thread t of the
// row's four (1, 2 or 4 bytes: codes 16 ks + 4t .. + 3).
template <int BITS>
__device__ __forceinline__ uint32_t fetch(const uint8_t* stage, int r, int ks, int t) {
  const int o = (16 * ks + 4 * t) >> Fmt<BITS>::kShift;
  const uint8_t* p = stage + code_off(r, o);
  if constexpr (BITS == 2) return *p;
  else if constexpr (BITS == 4) return *reinterpret_cast<const uint16_t*>(p);
  else return *reinterpret_cast<const uint32_t*>(p);
}

// Word layout: step s of word w = (w, w >> 4) of a thread, as in unpack.
template <int BITS>
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t w4, int s, uint32_t& lo,
                                            uint32_t& hi) {
  if constexpr (BITS == 2) {
    constexpr uint32_t kExp = 0x43004300u, kBias = 0x43014301u;
    const uint32_t p = __byte_perm(w, w4, 0x4400 + 0x1111 * s);   // [b, b, b >> 4, ..]
    lo = bf16x2_sub((p & 0x00030003u) | kExp, kBias);
    hi = bf16x2_sub(((p >> 2) & 0x00030003u) | kExp, kBias);
  } else {
    unpack<BITS>(w >> (16 * s), lo, hi);
  }
}

// x = hi + mid + lo for two floats, as bf16 pairs (xa in the low halves).
__device__ __forceinline__ void split3(float xa, float xb, uint32_t& h, uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(xa, xb);
  const float2 hf = __bfloat1622float2(hv);
  const float ra = __fsub_rn(xa, hf.x), rb = __fsub_rn(xb, hf.y);
  const __nv_bfloat162 mv = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(mv);
  const __nv_bfloat162 lv = __floats2bfloat162_rn(__fsub_rn(ra, mf.x), __fsub_rn(rb, mf.y));
  h = *reinterpret_cast<const uint32_t*>(&hv);
  m = *reinterpret_cast<const uint32_t*>(&mv);
  l = *reinterpret_cast<const uint32_t*>(&lv);
}

// 16 code bytes from a byte offset `sh` / 8 into five aligned words, of
// which the first `valid` are kept (the rest 0).
__device__ __forceinline__ uint4 realign16(const uint32_t (&w)[5], uint32_t sh, int valid) {
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t v = __funnelshift_r(w[j], w[j + 1], sh);
    const int keep = valid - 4 * j;
    o[j] = keep >= 4 ? v : (keep <= 0 ? 0u : v & ((1u << (8 * keep)) - 1u));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// E for a row whose largest |x| has the bits u (sign cleared): 0 when that
// |x| lies in [2^-40, 2^64) (or the row is zero, or holds inf or nan), else
// the power of two that puts it in [2^64, 2^65), in [-63, 213].
__device__ __forceinline__ int row_exponent(uint32_t u) {
  if (u == 0u || u >= 0x7f800000u) return 0;
  const int be = static_cast<int>(u >> 23);
  const int e = be ? be - 127 : (31 - __clz(static_cast<int>(u))) - 149;  // floor(log2)
  return (e >= -40 && e < 64) ? 0 : 64 - e;
}

// 2^k as a float, k in [-126, 127].
__device__ __forceinline__ float pow2(int k) { return __int_as_float((k + 127) << 23); }

struct Args {
  const float* x;
  const uint8_t* c;
  const float* scale;
  float* y;
  float* ws;            // S * M * N partial sums (S > 1)
  int* counters;        // one ticket per (row tile, m-tile), zero on entry and exit
  int M, N, K, Kp;
  int S, m_tiles, chunks;  // split-K parts, m-tiles, 64-byte code chunks per row
  int G, group_size;       // group kernel: scale is (N, G)
  int tma, xvec;           // codes by TMA; x rows read as float4
  int E, Mb;               // kernels in the stack (1 for a 2-D call), x rows of each
};

// The largest |x| (its bits, sign cleared) of each of the rows m0 .. m0 + mv
// - 1 of x over the columns [k_lo, k_hi), atomicMax-ed into rmax (zeroed by
// the caller), by warp wid of nw: rows are dealt to warps (a row to several
// warps, in slices, when rows are fewer than warps); the lanes of a warp
// read neighbouring units (UNIT = 4: float4, where x rows are 16-byte aligned
// and k_lo, k_hi are multiples of 4; else single floats), eight each in
// flight, and one lane adds the warp's maximum.
template <int UNIT>
__device__ __noinline__ void range_max_units(const float* x, int K, int m0, int mv, int k_lo,
                                             int k_hi, int wid, int nw, uint32_t* rmax) {
  const int lane = threadIdx.x & 31;
  const int nq = (k_hi - k_lo) / UNIT;
  const int slices = mv < nw ? nw / mv : 1;
#pragma unroll 1
  for (int task = wid; task < mv * slices; task += nw) {
    const int ml = task / slices, sl = task - ml * slices;
    const int u0 = nq * sl / slices, u1 = nq * (sl + 1) / slices;
    const float* row = x + static_cast<size_t>(m0 + ml) * K + k_lo;
    uint32_t cur = 0u;
#pragma unroll 1
    for (int base = u0; base < u1; base += 8 * 32) {
      float f[8][UNIT];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int u = base + 32 * v + lane;
        if (u < u1) {
          if constexpr (UNIT == 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(row) + u);
            f[v][0] = q.x;
            f[v][1] = q.y;
            f[v][2] = q.z;
            f[v][3] = q.w;
          } else {
            f[v][0] = __ldg(row + u);
          }
        } else {
#pragma unroll
          for (int e = 0; e < UNIT; ++e) f[v][e] = 0.f;
        }
      }
#pragma unroll
      for (int v = 0; v < 8; ++v)
#pragma unroll
        for (int e = 0; e < UNIT; ++e) cur = max(cur, __float_as_uint(f[v][e]) & 0x7fffffffu);
    }
    cur = __reduce_max_sync(0xffffffffu, cur);
    if (lane == 0 && cur) atomicMax(rmax + ml, cur);
  }
}

__device__ __forceinline__ void range_max(const Args& a, int m0, int mv, int k_lo, int k_hi,
                                          int wid, int nw, uint32_t* rmax) {
  if (a.xvec) range_max_units<4>(a.x, a.K, m0, mv, k_lo, k_hi, wid, nw, rmax);
  else range_max_units<1>(a.x, a.K, m0, mv, k_lo, k_hi, wid, nw, rmax);
}

// Work item w = mt + E * m_tiles * (split + S * tile): m-tile mt of x
// (m-tile mt % m_tiles of kernel mt / m_tiles of the stack), split-K part
// `split` of 128-row tile `tile` of that kernel's Φ̂. A block walks items w
// = blockIdx.x, + gridDim.x, ...; its ring runs on across items, so the
// producer loads the next item's stages while the consumers finish one.
struct Work {
  int mt, split, tile, c_begin, n_iter;
};

__device__ __forceinline__ Work work_item(const Args& a, int w) {
  Work k;
  const int mts = a.E * a.m_tiles;
  const int ts = w / mts;
  k.mt = w - ts * mts;
  k.tile = ts / a.S;
  k.split = ts - k.tile * a.S;
  const int q = a.chunks / a.S, r = a.chunks - q * a.S;   // parts of q or q + 1 chunks
  k.c_begin = k.split * q + min(k.split, r);
  k.n_iter = q + (k.split < r ? 1 : 0);
  return k;
}

// The x rows of m-tile mt of MT rows: the first, m0, of the (E * Mb, K) x
// and y, the valid ones, mv, and the first code row, nb, of its kernel in
// the (E * N, Kp) codes.
struct Span {
  int m0, mv, nb;
};

template <int MT>
__device__ __forceinline__ Span span(const Args& a, int mt) {
  const int e = mt / a.m_tiles, ml = (mt - e * a.m_tiles) * MT;
  return Span{e * a.Mb + ml, min(MT, a.Mb - ml), e * a.N};
}

template <int BITS, int NB, int U, bool GROUP>
__global__ void __launch_bounds__(kThreads, Layout<BITS, NB, U, GROUP>::kSmall ? 2 : 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap map, const Args args) {
  using F = Fmt<BITS>;
  using L = Layout<BITS, NB, U, GROUP>;
  constexpr int kMpt = Cols<NB>::kMpt;
  constexpr int kMt = Cols<NB>::kMt;
  constexpr int kUnits = L::kUnits;
  constexpr int kQuads = F::kCodes / 4;                   // x quads of a row per stage
  constexpr bool kWord = U >= F::kVpb;                    // units of whole words
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  int* last_flag = reinterpret_cast<int*>(empty + L::kStages);
  const int n_work = ((args.N + kRows - 1) / kRows) * args.S * args.E * args.m_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, kData + 1);          // the data threads, + the TMA's (or one stand-in)
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's first kPre x ranges (m-tile, split) and their rows'
  // maxima: taken by the consumer warps, idle until the first stage lands,
  // while the producer starts its copies; barrier 3 hands them over (the
  // consumers arrive, the data threads wait once, at their first range).
  // The producer takes any later range itself.
  int2* pre_key = reinterpret_cast<int2*>(smem + L::kPreKey);
  int* pre_n = reinterpret_cast<int*>(pre_key + kPre);
  const uint32_t* pre_max = reinterpret_cast<const uint32_t*>(smem + L::kPreMax);
  constexpr int kHandOver = kData + kConsumers;

  if (threadIdx.x < kProducers) {
    // ---- producer warpgroup. Warp 0 (one thread) starts each stage's TMA
    // box of codes as soon as the slot is free. Warps 1-3 copy, a whole ring
    // ahead, the global data a stage needs into staging slots (cp.async):
    // x, the scales and, when the codes do not come by TMA, the aligned
    // 16-byte chunks around each row's window. Once the slot is free they
    // write it out: x split into B, the codes realigned, the scales. No
    // global load latency stands in their loop. All walk the block's stage
    // sequence, (work item, chunk) per ring position, with cursors.
    using St = Stage<BITS, NB, U, GROUP>;
    const int tid = threadIdx.x;
    const uintptr_t c_lo = reinterpret_cast<uintptr_t>(args.c);
    const uintptr_t c_hi = c_lo + static_cast<size_t>(args.E) * args.N * args.Kp;
    struct Cursor {
      int wi, it;
      Work wk;
    };
    auto settle = [&](Cursor& c) {                 // the first stage at or after c
      while (c.wi < n_work && c.it >= c.wk.n_iter) {
        c.it = 0;
        c.wi += gridDim.x;
        if (c.wi < n_work) c.wk = work_item(args, c.wi);
      }
    };
    Cursor out{static_cast<int>(blockIdx.x), 0, work_item(args, blockIdx.x)};
    settle(out);
    if (tid < 32) {
      if (tid == 0 && args.tma) {
        for (int j = 0; out.wi < n_work; ++j) {
          const int slot = j % L::kStages;
          mbar_wait(empty + slot, ((j / L::kStages) & 1) ^ 1);
          mbar_expect_tx(full + slot, kCodeStage);
          tma_load(smem + L::kC + slot * kCodeStage, &map, full + slot,
                   (out.wk.c_begin + out.it) * kRowBytes,
                   span<kMt>(args, out.wk.mt).nb + out.wk.tile * kRows);
          ++out.it;
          settle(out);
        }
      }
      return;
    }
    const int dt = tid - 32;                       // data thread 0 .. 95
    uint32_t* rmax = reinterpret_cast<uint32_t*>(smem + L::kRow);   // the range's row maxima
    int* rexp = reinterpret_cast<int*>(rmax + kMt);                  // ... their exponents E
    float* rf1 = reinterpret_cast<float*>(rexp + kMt);               // 2^min(E, 127)
    float* rf2 = rf1 + kMt;                                          // 2^(E - min(E, 127))
    int* eslot = reinterpret_cast<int*>(smem + L::kE);               // E per stage and row
    int e_mt = -1, e_split = -1;                   // the x range the factors are for
    bool scaled = false;                           // some row of that range has E != 0
    bool handed = false;                           // the consumers' maxima have arrived
    // the 64-byte window of code row r of a stage starts at byte `at`; its
    // aligned 16-byte chunks j = 0..4 are staged at (5 r + j) * 16
    Cursor pf = out;
    for (int j = -L::kStages; out.wi < n_work; ++j) {
      if (j >= 0) {
        // ---- write out stage j from its staging slot
        const int slot = j % L::kStages;
        const Work& wk = out.wk;
        const Span sp = span<kMt>(args, wk.mt);
        const int n0 = wk.tile * kRows, m0 = sp.m0, mv = sp.mv;
        const int chunk = wk.c_begin + out.it;
        if (out.it == 0 && (wk.mt != e_mt || wk.split != e_split)) {
          // a new x range (m-tile, split): the largest |x| of each of its
          // rows (taken up front, or now), then the power of two that
          // scales the row
          e_mt = wk.mt;
          e_split = wk.split;
          if (!handed) {
            asm volatile("bar.sync 3, %0;\n" ::"n"(kHandOver) : "memory");
            handed = true;
          }
          int pre = -1;
          for (int p = 0; p < *pre_n; ++p)
            if (pre_key[p].x == wk.mt && pre_key[p].y == wk.split) pre = p;
          asm volatile("bar.sync 2, %0;\n" ::"n"(kData) : "memory");   // old factors are read
          const uint32_t* maxima = rmax;
          if (pre >= 0) {
            maxima = pre_max + pre * kMt;
          } else {
            if (dt < kMt) rmax[dt] = 0u;
            asm volatile("bar.sync 2, %0;\n" ::"n"(kData) : "memory");
            range_max(args, m0, mv, wk.c_begin * F::kCodes,
                      min(args.K, (wk.c_begin + wk.n_iter) * F::kCodes), dt / 32, kData / 32,
                      rmax);
            asm volatile("bar.sync 2, %0;\n" ::"n"(kData) : "memory");
          }
          int e = 0;
          if (dt < kMt) {
            e = row_exponent(maxima[dt]);
            const int e1 = min(e, 127);
            rexp[dt] = e;
            rf1[dt] = pow2(e1);
            rf2[dt] = pow2(e - e1);
          }
          // every data thread learns whether any row is scaled; the factors
          // are visible past this barrier
          uint32_t any;
          asm volatile("{\n.reg .pred p, q;\nsetp.ne.s32 q, %1, 0;\n"
                       "bar.red.or.pred p, 2, %2, q;\nselp.u32 %0, 1, 0, p;\n}\n"
                       : "=r"(any) : "r"(e), "n"(kData) : "memory");
          scaled = any != 0;
        }
        cp_async_wait<L::kStages - 1>();          // this thread's copies of stage j
        mbar_wait(empty + slot, ((j / L::kStages) & 1) ^ 1);
        const uint8_t* pst = smem + L::kP + slot * L::kPStage;
        if (!args.tma) {
          asm volatile("bar.sync 2, %0;\n" ::"n"(kData) : "memory");   // every chunk has landed
          uint8_t* cst = smem + L::kC + slot * kCodeStage;
#pragma unroll 1
          for (int item = dt; item < kRows * (kRowBytes / 16); item += kData) {
            const int r = item >> 2, u = item & 3, n = n0 + r;
            const int col = chunk * kRowBytes + 16 * u;
            const int valid = n < args.N ? min(16, args.Kp - col) : 0;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (valid > 0) {
              const uint32_t o = static_cast<uint32_t>(
                  (c_lo + static_cast<size_t>(sp.nb + n) * args.Kp + chunk * kRowBytes) & 15) +
                  16 * u;
              const uint32_t* wsrc = reinterpret_cast<const uint32_t*>(
                  pst + St::kW + (5 * r) * 16 + (o & ~3u));
              uint32_t w5[5];
#pragma unroll
              for (int i = 0; i < 5; ++i) w5[i] = (i == 4 && (o & 3) == 0) ? 0u : wsrc[i];
              v = realign16(w5, (o & 3) * 8, valid);
            }
            *reinterpret_cast<uint4*>(cst + code_off(r, 16 * u)) = v;
          }
          if (dt == 0) mbar_arrive(full + slot);  // stands in for the TMA's arrival
          asm volatile("bar.sync 2, %0;\n" ::"n"(kData) : "memory");   // the chunks are read
        }
        // x[m0 .. m0 + mv, chunk's codes] -> B, permuted within each k16 step
        uint8_t* bst = smem + L::kB + slot * L::kBStage;
#pragma unroll 1
        for (int q = 0; q < St::kXItems; ++q) {
          const int item = dt + kData * q;
          if (item >= mv * kQuads) break;
          const int ml = item / kQuads, qd = item - ml * kQuads;
          float4 v = *reinterpret_cast<const float4*>(pst + St::kX + item * 16);
          const int kl0 = x_col0<BITS, kWord>(qd);       // (c0, c2) columns; (c1, c3) at + 8
          if (scaled) {                                  // x · 2^E, exactly
            const float f1 = rf1[ml], f2 = rf2[ml];
            v = make_float4(__fmul_rn(__fmul_rn(v.x, f1), f2), __fmul_rn(__fmul_rn(v.y, f1), f2),
                            __fmul_rn(__fmul_rn(v.z, f1), f2), __fmul_rn(__fmul_rn(v.w, f1), f2));
          }
          uint32_t p0[3], p1[3];
          split3(v.x, v.z, p0[0], p0[1], p0[2]);
          split3(v.y, v.w, p1[0], p1[1], p1[2]);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const int col = b_col<NB>(ml, p);
            *reinterpret_cast<uint32_t*>(bst + b_off<NB>(col, kl0)) = p0[p];
            *reinterpret_cast<uint32_t*>(bst + b_off<NB>(col, kl0 + 8)) = p1[p];
          }
        }
        if (dt < kMt) eslot[slot * kMt + dt] = rexp[dt];
        if constexpr (GROUP) {
          float* sst = reinterpret_cast<float*>(smem + L::kS + slot * L::kSStage);
#pragma unroll 1
          for (int item = dt; item < kRows * kUnits; item += kData)
            sst[item] = *reinterpret_cast<const float*>(pst + St::kS + item * 4);
        }
        fence_proxy_async();
        mbar_arrive(full + slot);
        ++out.it;
        settle(out);
      }
      // ---- copy stage j + kStages into the slot stage j has just left
      if (pf.wi < n_work) {
        const Work& wk = pf.wk;
        const Span sp = span<kMt>(args, wk.mt);
        const int n0 = wk.tile * kRows, m0 = sp.m0, mv = sp.mv;
        const int chunk = wk.c_begin + pf.it;
        const int slot = (j + L::kStages) % L::kStages;
        const uint32_t st = smem_u32(smem + L::kP + slot * L::kPStage);
        const int k_first = chunk * F::kCodes;
#pragma unroll 1
        for (int q = 0; q < St::kXItems; ++q) {
          const int item = dt + kData * q;
          if (item >= mv * kQuads) break;
          const int ml = item / kQuads, k = k_first + 4 * (item - ml * kQuads);
          const float* xr = args.x + static_cast<size_t>(m0 + ml) * args.K;
          const uint32_t dst = st + St::kX + item * 16;
          if (args.xvec) {
            cp_async16(dst, xr + (k < args.K ? k : 0), 4 * max(0, min(4, args.K - k)));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cp_async4(dst + 4 * e, xr + (k + e < args.K ? k + e : 0), k + e < args.K ? 4 : 0);
          }
        }
        if (!args.tma) {
          // the stage's window of each code row: its aligned 16-byte chunks
#pragma unroll 1
          for (int item = dt; item < St::kChunks; item += kData) {
            const int r = item / 5, i = item - 5 * r, n = n0 + r;
            const int col = chunk * kRowBytes;
            if (n >= args.N || col >= args.Kp) continue;
            const uintptr_t at = c_lo + static_cast<size_t>(sp.nb + n) * args.Kp + col;
            const uintptr_t ca = (at & ~static_cast<uintptr_t>(15)) + 16 * i;
            const uintptr_t end = at + min(kRowBytes, args.Kp - col);   // the window's end
            if (ca >= end) continue;
            cp_async16(st + St::kW + item * 16, reinterpret_cast<const void*>(ca),
                       c_hi - ca >= 16 ? 16 : static_cast<int>(c_hi - ca));
          }
        }
        if constexpr (GROUP) {
#pragma unroll 1
          for (int item = dt; item < kRows * kUnits; item += kData) {
            const int u = item / kRows, r = item - u * kRows, n = n0 + r;
            const int grp = (k_first + 16 * U * u) / args.group_size;
            const bool ok = n < args.N && grp < args.G;
            cp_async4(st + St::kS + item * 4,
                      args.scale + (ok ? static_cast<size_t>(sp.nb + n) * args.G + grp : 0),
                      ok ? 4 : 0);
          }
        }
        ++pf.it;
        settle(pf);
      }
      cp_async_commit();                            // one group per ring position, even empty
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumer warpgroups. First, the row maxima of the block's first
  // x ranges (see above), handed to the producer through barrier 3.
  {
    const int ct = threadIdx.x - kProducers;
    uint32_t* maxima = reinterpret_cast<uint32_t*>(smem + L::kPreMax);
    if (ct == 0) {
      int n = 0;
      for (int w = blockIdx.x; w < n_work && n < kPre; w += gridDim.x) {
        const Work wk = work_item(args, w);
        bool seen = false;
        for (int p = 0; p < n; ++p) seen |= pre_key[p].x == wk.mt && pre_key[p].y == wk.split;
        if (!seen) pre_key[n++] = make_int2(wk.mt, wk.split);
      }
      *pre_n = n;
    }
    for (int i = ct; i < kPre * kMt; i += kConsumers) maxima[i] = 0u;
    asm volatile("bar.sync 4, %0;\n" ::"n"(kConsumers) : "memory");
    const int q = args.chunks / args.S, r = args.chunks - q * args.S;
    for (int p = 0; p < *pre_n; ++p) {
      const int split = pre_key[p].y;
      const Span sp = span<kMt>(args, pre_key[p].x);
      const int c_begin = split * q + min(split, r);
      const int c_end = c_begin + q + (split < r ? 1 : 0);
      range_max(args, sp.m0, sp.mv, c_begin * F::kCodes,
                min(args.K, c_end * F::kCodes), ct / 32, kConsumers / 32, maxima + p * kMt);
    }
    asm volatile("bar.arrive 3, %0;\n" ::"n"(kHandOver) : "memory");
  }

  // ---- consumer warpgroups: rows 64 cw .. 64 cw + 63 of a tile
  const int cw = threadIdx.x / 128 - 1;
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = 64 * cw + 16 * w + lane / 4;        // this thread's rows r0 and r0 + 8
  uint32_t aa[U][4], ab[U][4];                       // A fragments, two sets in ping-pong
#pragma unroll
  for (int kk = 0; kk < U; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) aa[kk][j] = ab[kk][j] = 0u;

  // one unit: U k16 steps of a code stage from step u * U, A into `a`
  auto fill = [&](uint32_t (&a)[U][4], const uint8_t* cst, int u) {
    if constexpr (kWord) {
      constexpr int vpb = F::kVpb;
#pragma unroll
      for (int wq = 0; wq < U / vpb; ++wq) {
        const int o = 16 * ((u * U) / vpb + wq) + 4 * t;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cst + code_off(r0, o));
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cst + code_off(r0 + 8, o));
#pragma unroll
        for (int sw = 0; sw < vpb; ++sw) {
          unpack_word<BITS>(w0, w0 >> 4, sw, a[wq * vpb + sw][0], a[wq * vpb + sw][2]);
          unpack_word<BITS>(w1, w1 >> 4, sw, a[wq * vpb + sw][1], a[wq * vpb + sw][3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < U; ++kk) {
        const int ks = u * U + kk;
        unpack<BITS>(fetch<BITS>(cst, r0, ks, t), a[kk][0], a[kk][2]);
        unpack<BITS>(fetch<BITS>(cst, r0 + 8, ks, t), a[kk][1], a[kk][3]);
      }
    }
  };
  // d (+)= A B over one unit; the first step starts d afresh unless `keep`
  auto issue = [&](uint32_t (&a)[U][4], float (&d)[NB / 2], uint64_t desc, int u, bool keep) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < U; ++kk) {
      const int ks = u * U + kk;                     // + the step's offset in B, >> 4
      wgmma_rs<NB>(d, a[kk], desc + (((ks >> 2) * NB * 128 + (ks & 3) * 32) >> 4),
                   (keep || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
  };

  const int* eslot = reinterpret_cast<const int*>(smem + L::kE);
  int g = 0;                                         // ring position, across work items
  for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x) {
    const Work wk = work_item(args, wi);
    const Span sp = span<kMt>(args, wk.mt);
    const int n0 = wk.tile * kRows, m0 = sp.m0, mv = sp.mv;
    float part[kMpt][2];                             // per x row and row half
    int ex[kMpt];                                    // E of each x row, from the item's last stage
#pragma unroll
    for (int i = 0; i < kMpt; ++i) {
      part[i][0] = part[i][1] = 0.f;
      ex[i] = 0;
    }
    // the x rows' exponents (the same in every stage of an item), read from
    // the last stage before it is released, so that they hold no register
    // while wgmma runs
    auto read_exponents = [&](int slot) {
#pragma unroll
      for (int i = 0; i < kMpt; ++i) ex[i] = eslot[slot * kMt + t * kMpt + i];
    };
    // Units go in pairs: both A sets are filled, then both units issued, then
    // waited for. No register a wgmma reads is written while one is in flight
    // (ptxas serializes every wgmma otherwise); the two consumer warpgroups,
    // and the blocks beside them on the SM, fill while the others multiply.
    if constexpr (!GROUP) {
      // the two units of a pair run into two accumulators (one at NB = 96,
      // where registers are short), so their wgmma chains overlap
      constexpr bool kTwo = NB <= 48;
      float acc[NB / 2], acc2[kTwo ? NB / 2 : 1];
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (kTwo ? NB / 2 : 1); ++i) acc2[i] = 0.f;
      for (int it = 0; it < wk.n_iter; ++it, ++g) {
        const int slot = g % L::kStages;
        mbar_wait(full + slot, (g / L::kStages) & 1);
        const uint8_t* cst = smem + L::kC + slot * kCodeStage;
        const uint64_t desc = smem_desc(smem_u32(smem + L::kB + slot * L::kBStage), 16, 1024);
#pragma unroll
        for (int u = 0; u < kUnits; u += 2) {
          fill(aa, cst, u);
          fill(ab, cst, u + 1);
          fence_regs(acc);
          issue(aa, acc, desc, u, true);
          if constexpr (kTwo) {
            fence_regs(acc2);
            issue(ab, acc2, desc, u + 1, true);
          } else {
            issue(ab, acc, desc, u + 1, true);
          }
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(acc2);
          fence_regs(aa);
          fence_regs(ab);
        }
        if (it == wk.n_iter - 1) read_exponents(slot);
        mbar_arrive(empty + slot);
      }
      if constexpr (kTwo) {
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) acc[i] += acc2[i];
      }
#pragma unroll
      for (int i = 0; i < kMpt; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          part[i][h] = acc[acc_idx(3 * i, h)] +
                       (acc[acc_idx(3 * i + 1, h)] + acc[acc_idx(3 * i + 2, h)]);
    } else {
      float ta[NB / 2], tb[NB / 2];                  // unit temporaries
      // part += scale * (hi + (mid + lo)) of a retired unit u; sst: its scales
      auto combine = [&](float (&d)[NB / 2], const float* sst, int u) {
        const float s0 = sst[u * kRows + r0], s1 = sst[u * kRows + r0 + 8];
#pragma unroll
        for (int i = 0; i < kMpt; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = d[acc_idx(3 * i, h)] +
                            (d[acc_idx(3 * i + 1, h)] + d[acc_idx(3 * i + 2, h)]);
            part[i][h] = fmaf(h ? s1 : s0, v, part[i][h]);
          }
      };
      for (int it = 0; it < wk.n_iter; ++it, ++g) {
        const int slot = g % L::kStages;
        mbar_wait(full + slot, (g / L::kStages) & 1);
        const uint8_t* cst = smem + L::kC + slot * kCodeStage;
        const uint64_t desc = smem_desc(smem_u32(smem + L::kB + slot * L::kBStage), 16, 1024);
        const float* sst = reinterpret_cast<const float*>(smem + L::kS + slot * L::kSStage);
#pragma unroll
        for (int u = 0; u < kUnits; u += 2) {
          fill(aa, cst, u);
          fill(ab, cst, u + 1);
          fence_regs(ta);
          fence_regs(tb);
          issue(aa, ta, desc, u, false);
          issue(ab, tb, desc, u + 1, false);
          wgmma_wait<1>();                           // ta has retired; tb may still run
          fence_regs(ta);
          combine(ta, sst, u);
          wgmma_wait<0>();
          fence_regs(tb);
          fence_regs(aa);
          fence_regs(ab);
          combine(tb, sst, u + 1);
        }
        if (it == wk.n_iter - 1) read_exponents(slot);
        mbar_arrive(empty + slot);
      }
    }

    // ---- epilogue: part / K_h (for a scaled row, part · 2^-(E + log2 K_h)),
    // times the row scale; or those split-K partials and their sum. Both
    // are exact scalings, so an unscaled row rounds once, at the row scale,
    // as without the prescale.
    float mult[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + r0 + 8 * h;
      mult[h] = GROUP ? 1.0f : (n < args.N ? __ldg(args.scale + sp.nb + n) : 0.f);
    }
#pragma unroll
    for (int i = 0; i < kMpt; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        part[i][h] = ex[i] == 0 ? part[i][h] * (1.0f / static_cast<float>(F::kHalf))
                                : ldexpf(part[i][h], -(ex[i] + F::kLog2Half));
    if (args.S == 1) {
#pragma unroll
      for (int i = 0; i < kMpt; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ml = t * kMpt + i, m = m0 + ml, n = n0 + r0 + 8 * h;
          if (ml < mv && n < args.N)
            args.y[static_cast<size_t>(m) * args.N + n] = part[i][h] * mult[h];
        }
      continue;
    }
    const size_t MN = static_cast<size_t>(args.M) * args.N;
#pragma unroll
    for (int i = 0; i < kMpt; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ml = t * kMpt + i, m = m0 + ml, n = n0 + r0 + 8 * h;
        if (ml < mv && n < args.N)
          args.ws[wk.split * MN + static_cast<size_t>(m) * args.N + n] = part[i][h];
      }
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (threadIdx.x == kProducers) {
      int* ticket = args.counters + wk.tile * args.E * args.m_tiles + wk.mt;
      const int got = atomicAdd(ticket, 1);
      *last_flag = got == args.S - 1;
      if (got == args.S - 1) *ticket = 0;           // zero again for the next launch
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (!*last_flag) continue;
    __threadfence();
    // each output sums s = 0 .. S-1 in order; the thread's outputs share
    // batches of loads, so many are in flight at once
    float sum[kMpt][2];
    size_t at[kMpt][2];
    bool ok[kMpt][2];
#pragma unroll
    for (int i = 0; i < kMpt; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ml = t * kMpt + i, m = m0 + ml, n = n0 + r0 + 8 * h;
        ok[i][h] = ml < mv && n < args.N;
        at[i][h] = ok[i][h] ? static_cast<size_t>(m) * args.N + n : 0;
        sum[i][h] = 0.f;
      }
    constexpr int kBatch = kMpt >= 4 ? 4 : 16 / (2 * kMpt);
    for (int p = 0; p < args.S; p += kBatch) {
      float v[kBatch][kMpt][2];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
#pragma unroll
        for (int i = 0; i < kMpt; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            v[q][i][h] = p + q < args.S ? __ldcg(args.ws + (p + q) * MN + at[i][h]) : 0.f;
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
#pragma unroll
        for (int i = 0; i < kMpt; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (p + q < args.S) sum[i][h] += v[q][i][h];
    }
#pragma unroll
    for (int i = 0; i < kMpt; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ok[i][h]) args.y[at[i][h]] = sum[i][h] * mult[h];
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

// The (N, Kp) code array as a 2-D map of bytes read in (64, 128) boxes with
// the 64-byte swizzle; columns at or past Kp and rows at or past N read as 0.
bool encode_codes(CUtensorMap* map, const void* c, int N, int Kp) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box[2] = {kRowBytes, kRows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(c), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

int n_chunks(int Kp) { return (Kp + kRowBytes - 1) / kRowBytes; }

// Split-K parts: as many as fill the SMs twice with the row tiles (two
// blocks share an SM where they fit), keeping at least four stages per
// part. A function of the tiles (E * ceil(N / 128)), Kp and the card, never
// of M.
int splits_for(int tiles, int Kp) {
  const int most = n_chunks(Kp) / 4;
  int s = 2 * num_sms() / tiles;
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

int splits(int N, int Kp) { return splits_for((N + kRows - 1) / kRows, Kp); }

template <int BITS, int NB, int U, bool GROUP>
cudaError_t launch(Args a, cudaStream_t stream) {
  using L = Layout<BITS, NB, U, GROUP>;
  static int per_sm[kMaxDevices] = {0};            // resident blocks per SM, once per device
  const int dev = current_device();
  if (!per_sm[dev]) {
    cudaError_t err = cudaFuncSetAttribute(qmm_wgmma_kernel<BITS, NB, U, GROUP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, qmm_wgmma_kernel<BITS, NB, U, GROUP>,
                                                        kThreads, L::kBytes);
    if (err != cudaSuccess) return err;
    per_sm[dev] = n > 0 ? n : 1;
  }
  CUtensorMap map;
  if (a.tma) {
    if (!encode_codes(&map, a.c, a.E * a.N, a.Kp)) return cudaErrorInvalidValue;
  } else {
    memset(&map, 0, sizeof(map));
  }
  a.m_tiles = (a.Mb + Cols<NB>::kMt - 1) / Cols<NB>::kMt;
  const long long work =
      static_cast<long long>((a.N + kRows - 1) / kRows) * a.S * a.E * a.m_tiles;
  if (work > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  const long long room = static_cast<long long>(per_sm[dev]) * num_sms();
  const unsigned grid = static_cast<unsigned>(work < room ? work : room);
  qmm_wgmma_kernel<BITS, NB, U, GROUP><<<grid, kThreads, L::kBytes, stream>>>(map, a);
  return cudaGetLastError();
}

// The B width for the x rows of one kernel, Mb: n = 16, 24, 48 or 96
// columns (x rows per block 4, 8, 16, 32); the group kernel stops at 48.
template <int BITS, int U, bool GROUP>
cudaError_t launch_nb(const Args& a, cudaStream_t stream) {
  if (a.Mb <= 4) return launch<BITS, 16, U, GROUP>(a, stream);
  if (a.Mb <= 8) return launch<BITS, 24, U, GROUP>(a, stream);
  if (GROUP || a.Mb <= 16) return launch<BITS, 48, U, GROUP>(a, stream);
  return launch<BITS, GROUP ? 48 : 96, U, GROUP>(a, stream);
}

bool bad_shape(const void* c, int M, int N, int K, int Kp, int bits) {
  if (bits != 2 && bits != 4 && bits != 8) return true;
  if (reinterpret_cast<uintptr_t>(c) % 16) return true;     // TMA and 16-byte chunk copies
  return M <= 0 || N <= 0 || K < 0 || Kp != (K + 8 / bits - 1) / (8 / bits);
}

Args make_args(const float* x, const unsigned char* c, const float* scale, float* y, float* ws,
               int* counters, int M, int N, int K, int Kp) {
  Args a;
  a.x = x;
  a.c = c;
  a.scale = scale;
  a.y = y;
  a.ws = ws;
  a.counters = counters;
  a.M = M;
  a.N = N;
  a.K = K;
  a.Kp = Kp;
  a.S = splits(N, Kp);
  a.m_tiles = 1;
  a.chunks = n_chunks(Kp);
  a.G = 1;
  a.group_size = 16;
  a.tma = Kp > 0 && Kp % 16 == 0;
  a.xvec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  a.E = 1;
  a.Mb = M;
  return a;
}

}  // namespace

// Split-K parts of a call at (E, N, Kp), E = 1 for a 2-D call: the workspace
// holds S * E * M * N floats.
extern "C" int repro_qmm_tc_batched_splits(int E, int N, int Kp) {
  if (E <= 0 || N <= 0 || Kp < 0) return 0;
  return splits_for(E * ((N + kRows - 1) / kRows), Kp);
}

// x (M, K) f32, c (N, Kp) uint8 starting on a 16-byte boundary, scale (N,)
// f32, y (M, N) f32, ws S * M * N f32, counters ceil(N / 128) * ceil(M / 4)
// int32 that are zero.
extern "C" int repro_qmm_tc(const float* x, const unsigned char* c, const float* scale, float* y,
                            float* ws, int* counters, int M, int N, int K, int Kp, int bits,
                            void* stream) {
  if (bad_shape(c, M, N, K, Kp, bits)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, c, scale, y, ws, counters, M, N, K, Kp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return static_cast<int>(launch_nb<2, 4, false>(a, s));
    case 4: return static_cast<int>(launch_nb<4, 4, false>(a, s));
    default: return static_cast<int>(launch_nb<8, 2, false>(a, s));
  }
}

// As repro_qmm_tc with scale (N, ceil(K / group_size)), group_size a
// positive multiple of 16.
extern "C" int repro_qmm_group_tc(const float* x, const unsigned char* c, const float* scale,
                                  float* y, float* ws, int* counters, int M, int N, int K, int Kp,
                                  int bits, int group_size, void* stream) {
  if (bad_shape(c, M, N, K, Kp, bits) || group_size <= 0 || group_size % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, c, scale, y, ws, counters, M, N, K, Kp);
  a.G = (K + group_size - 1) / group_size;
  a.group_size = group_size;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int j = group_size / 16;                   // k16 steps per group
  switch (bits) {
    case 2: return static_cast<int>(j % 4 == 0 ? launch_nb<2, 4, true>(a, s)
                                               : launch_nb<2, 1, true>(a, s));
    case 4: return static_cast<int>(j % 4 == 0 ? launch_nb<4, 4, true>(a, s)
                                               : launch_nb<4, 1, true>(a, s));
    default: return static_cast<int>(j % 2 == 0 ? launch_nb<8, 2, true>(a, s)
                                                : launch_nb<8, 1, true>(a, s));
  }
}

// x (E, M, K) f32, c (E, N, Kp) uint8 starting on a 16-byte boundary, scale
// (E, N) f32, y (E, M, N) f32, ws S * E * M * N f32 (S from
// repro_qmm_tc_batched_splits), counters ceil(N / 128) * E * ceil(M / 4)
// int32 that are zero: y[e] = x[e] @ dequant(c[e])^T * scale[e], one launch.
extern "C" int repro_qmm_tc_batched(const float* x, const unsigned char* c, const float* scale,
                                    float* y, float* ws, int* counters, int E, int M, int N,
                                    int K, int Kp, int bits, void* stream) {
  if (E <= 0 || bad_shape(c, M, N, K, Kp, bits)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(E) * M > 0x7FFFFFFFll || static_cast<long long>(E) * N > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, c, scale, y, ws, counters, E * M, N, K, Kp);
  a.E = E;
  a.Mb = M;
  a.S = splits_for(E * ((N + kRows - 1) / kRows), Kp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return static_cast<int>(launch_nb<2, 4, false>(a, s));
    case 4: return static_cast<int>(launch_nb<4, 4, false>(a, s));
    default: return static_cast<int>(launch_nb<8, 2, false>(a, s));
  }
}
