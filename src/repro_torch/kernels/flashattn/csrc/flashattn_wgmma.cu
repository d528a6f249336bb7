// Causal or full multi-head attention with grouped K/V heads (GQA) on the
// tensor cores of NVIDIA Hopper, sm_90a, for bfloat16 and float16 inputs.
//
// Two entries replace, for 16-bit inputs,
// repro/kernels/flashattn/kernel.py::flash_attention_pallas (_flash_kernel);
// float32 inputs keep the CUDA-core kernel of flashattn.cu:
//   * repro_flash_attention_tc: q, k and v on a 16-byte boundary, every head
//     dim of the reference's configs, D in {8, 16, 32, 64, 128, 160, 256};
//     tiles are copied by TMA;
//   * repro_flash_attention_tc_unaligned: the same when q, k or v starts off
//     a 16-byte boundary (a view into a larger tensor, which TMA cannot
//     address): the producer warpgroup copies the raw rows in and shifts them
//     into place, and no copy of the view is made in device memory.
// For queries q (B, Hq, Sq, D) and keys and values k, v (B, Hkv, Sk, D), Hq a
// multiple of Hkv:
//
//     o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j],
//     g = h / (Hq / Hkv),
//
// over the keys j < Sk that row i sees: query row i sits at key position
// i + off, and sees key j when (!causal || j <= i + off) and (win == 0 ||
// i + off - j < win). off = Sk - Sq is the bottom-right alignment of the
// reference's oracle attention_ref; off = q_offset with a window win is the
// sliding-window (local) attention of repro/models/layers.py's
// chunked_attention (_attn_mask), which recurrentgemma-2b's prefill runs at
// D = 256. Not causal, a window hides only the keys too far back. Every row
// must see a key (the entries refuse arguments under which one does not). As
// _flash_kernel does, it keeps a running row max m, row sum l and a float32
// accumulator, masks scores with the finite -1e30 and returns
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100 SXM: operations. A causal pass does
// 4 * B * Hq * D * (number of visible (i, j) pairs) flops against the bytes
// of q, k, v and o moved once; at the starcoder2-3b prefill width (Hq = 24,
// Hkv = 2, D = 128, S = 32,768) that is 6.6e12 flops, 6.7 ms at the 989
// TFLOP/s of the 16-bit tensor cores, against 0.24 ms of bytes.
//
// Design:
//   * One block of 384 threads owns one (b, h) and 128 query rows: warpgroup
//     0 is the producer, warpgroups 1 and 2 are consumers of 64 rows each.
//     The producer gives up registers (setmaxnreg: 40, or 64 where it
//     shifts tiles itself) and the consumers ask for them (232, or 216); but
//     ptxas still fits the consumers' code into the 168 registers a thread
//     has at launch, so at D = 256, where O alone is 128 floats a thread, the
//     consumers spill about 650 bytes (PERF.md has the cost). Blocks take
//     the heaviest causal query tiles first, all heads of a tile together,
//     so the query heads of one K/V head share its tiles in L2.
//   * Shared memory: Q (128 rows), a ring of K tiles and one of V tiles
//     (kBlockN rows each, kStages = 2), each with a "full" mbarrier and an
//     "empty" one (the 256 consumer threads). Tiles are stored in 64-column
//     chunks of 128-byte rows with the 128-byte swizzle, the layout wgmma
//     reads. The stored width DP is D rounded up to a chunk (D <= 64: 64;
//     160: 192), the columns past D zero. kBlockN per width, to fit the
//     227 KB a block may use: 128 up to D = 128 (160 KB at D = 128), 96 at
//     D = 160 (48 KB of Q + 4 x 36 KB = 192 KB; 128 would take 240 KB), 64 at
//     D = 256 (64 + 4 x 32 = 192 KB).
//   * Loads, aligned entry: TMA, 3-D tensor maps (D, S, B*H) so that a
//     ragged tile is zero filled within its own head; a "full" barrier
//     counts the bytes. Unaligned entry: the rows of a tile are contiguous
//     in a plane, and every row of a view is off its 16-byte boundary by the
//     same delta bytes (D is a multiple of 8). One producer thread copies a
//     tile's rows as raw bytes from the boundary before them (a 1-D bulk
//     copy, which needs only the boundary), into a raw slot for K and one for
//     V; the 128 producer threads then funnel-shift each 16-byte piece out of
//     the two aligned words that hold it and store it swizzled, zeros past S
//     and D, fence their stores into the async proxy (wgmma's) and arrive on
//     the "full" barrier, which counts the 128 threads. The copy of the next
//     tile's K starts as soon as this tile's K is shifted, and overlaps the
//     shift of V. The raw slots take room: at D = 160 the unaligned entry
//     has K/V tiles of 64 keys, at D = 256 a ring of one stage.
//   * S = Q K^T: wgmma m64n{kBlockN}k16, Q and K from shared memory
//     (K-major), over D/16 k-steps of 16 columns (4 for D <= 64), an f32
//     accumulator in registers. Lane l of warp w holds rows 16w + l/4 and
//     +8, columns 8j + 2(l%4) + {0, 1}.
//   * A block walks only the KV tiles some row of it sees: from the tile of
//     its first row's first key in the window to that of its last row's last
//     key (causal), so a window of W keys costs about W / S of a causal pass
//     at S >> W. Producer and consumers count the same tiles.
//   * Online softmax in f32 on the accumulator, in base 2 (scale * log2 e
//     folded into the scores); a row's 4 lanes reduce its max with two
//     shuffles; the row sum stays per lane until the epilogue. The causal
//     mask, the window's lower edge and the ragged edges are applied only on
//     tiles that cross them (a consumer warpgroup's 64 rows decide).
//   * O += P V: P rounded to the input type in registers, where the score
//     accumulator's layout is wgmma's A fragment; V from shared memory as an
//     MN-major (transposed) B, m64n{DN}k16 with DN = D (64 for D <= 64): at
//     D = 160 the third chunk's zero half is stored but not multiplied. O
//     stays f32 in registers, divided by l and rounded once when stored.
//
// Plain C interface, built with nvcc and loaded with ctypes: the aligned
// entry encodes the tensor maps (cuTensorMapEncodeTiled, looked up at run
// time through the CUDA runtime, so nothing more is linked); each entry
// launches on the given stream, does not synchronise, and returns a
// cudaError_t.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockM = 128;          // query rows of a block: two consumer warpgroups of 64
constexpr int kAtom = 64;             // 16-bit columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;        // one row of a 64-column chunk
constexpr int kThreads = 384;         // producer warpgroup + two consumer warpgroups
constexpr int kProducers = 128;
constexpr int kConsumers = 256;
constexpr int kMaxSmem = 232448;      // what a block may use on an H100
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kWatchdogCycles = 1ll << 34;  // ~10 s: a wait this long is a fault
constexpr int kMaxDevices = 64;

// Registers a thread of the producer and of a consumer warpgroup keeps after
// setmaxnreg; 128 * producer + 256 * consumer <= 384 * 168, the block's
// registers under __launch_bounds__(384, 1). ptxas compiles the consumers
// within 168 all the same, so a consumer must keep at least that.
template <bool kTma>
struct Regs {
  static constexpr int kProducer = kTma ? 40 : 64;
  static constexpr int kConsumer = kTma ? 232 : 216;
  static_assert(kProducers * kProducer + kConsumers * kConsumer <= kThreads * 168 &&
                    kConsumer >= 168, "registers of a block");
};

// Shared memory of a block for stored head width DP (a multiple of 64), K/V
// tiles of kBlockN keys, a ring of kStages and raw slots of RAW bytes
// (0 with TMA), from a 1024-byte aligned base: Q, the K ring, the V ring, the
// raw K and V rows, the barriers.
template <int DP, int kBlockN, int kStages, int RAW>
struct Layout {
  static constexpr int kChunks = DP / kAtom;
  static constexpr int kQChunk = kBlockM * kRowBytes;    // one 64-column chunk of Q
  static constexpr int kKVChunk = kBlockN * kRowBytes;   // one 64-column chunk of a K/V tile
  static constexpr int kQTile = kChunks * kQChunk;
  static constexpr int kKVTile = kChunks * kKVChunk;
  static constexpr int kK = kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kRawSlot = RAW;
  static constexpr int kRaw = kV + kStages * kKVTile;
  static constexpr int kBars = kRaw + 2 * kRawSlot;
  static constexpr int kBytes = kBars + 8 * (4 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(kKVChunk % 1024 == 0, "a chunk must start on the swizzle's 1024-byte period");
  static_assert(kBytes <= kMaxSmem, "shared memory of a block");
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

// Make this thread's generic stores to shared memory visible to the async
// proxy, through which wgmma reads its operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// One box of a 3-D tensor map (64 columns, the map's rows, 1 plane) into
// shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
        "r"(row), "r"(plane)
      : "memory");
}

// Bytes of a raw slot: kBlockN rows of up to DN 16-bit values, and the 16
// bytes before the first (none with TMA), in whole 128-byte lines.
__host__ __device__ constexpr int raw_slot(bool tma, int kBlockN, int DN) {
  return tma ? 0 : (kBlockN * 2 * DN + 16 + 127) / 128 * 128;
}

__device__ __forceinline__ void producers_sync() {   // the 128 producer threads only
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// How far a plane of 16-bit values (or any of its rows: a row is 2 * D
// bytes, a multiple of 16) starts past a 16-byte boundary.
__device__ __forceinline__ uint32_t misalignment(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) % 16);
}

// Rows row0 .. row0 + n - 1 of a (S, D) plane of 16-bit values at any 2-byte
// aligned address into shared memory at dst as raw bytes, from the 16-byte
// boundary at or before the first: one bulk copy of 2 * D * n bytes, and 16
// more when the rows are off the boundary (the 16-byte word that holds the
// last byte, so the copy stays within the allocation), completing on bar.
// Run by one thread.
__device__ __forceinline__ void bulk_rows(uint8_t* dst, const void* plane, int row0, int n, int D,
                                          uint64_t* bar) {
  const uint8_t* first = static_cast<const uint8_t*>(plane) + static_cast<size_t>(row0) * 2 * D;
  const uint32_t delta = misalignment(first);
  const uint32_t bytes = static_cast<uint32_t>(n) * 2 * D + (delta ? 16 : 0);
  fence_proxy_async();                              // the producers' reads of dst come first
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(first - delta), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Four 32-bit words starting S words and sh bits into the eight words w.
template <int S>
__device__ __forceinline__ uint4 window(const uint32_t (&w)[8], uint32_t sh) {
  return make_uint4(__funnelshift_r(w[S], w[S + 1], sh), __funnelshift_r(w[S + 1], w[S + 2], sh),
                    __funnelshift_r(w[S + 2], w[S + 3], sh),
                    __funnelshift_r(w[S + 3], w[S + 4], sh));
}

// The n rows bulk_rows brought to raw, S words and sh bits past the 16-byte
// boundary (S < 0: on it), into shared memory at dst as TMA would store
// them: 64-column chunks of ROWS 128-byte rows, 16-byte unit u of row r at
// unit u ^ (r % 8). Rows at or past n and columns at or past D are zeros.
// Run by the 128 producer threads, neighbours on neighbouring 16-byte pieces.
template <int ROWS, int CHUNKS, int S>
__device__ __forceinline__ void shift_rows_by(uint8_t* dst, const uint4* raw, uint32_t sh, int n,
                                              int D) {
  constexpr int kPieces = CHUNKS * kAtom / 8;   // 16-byte pieces of a stored row
  static_assert(ROWS * kPieces % kProducers == 0, "every thread takes as many pieces");
  const int pieces = D / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * kPieces; idx += kProducers) {
    const int r = idx / kPieces, pc = idx % kPieces;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && pc < pieces) {
      const uint4* w = raw + r * pieces + pc;      // the word that holds the piece's first byte
      if constexpr (S < 0) {
        val = w[0];
      } else {
        const uint4 lo = w[0], hi = w[1];
        const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        val = window<S>(x, sh);
      }
    }
    *reinterpret_cast<uint4*>(dst + (pc / 8) * ROWS * kRowBytes + r * kRowBytes +
                              (((pc % 8) ^ (r % 8)) << 4)) = val;
  }
}

// shift_rows_by for rows delta bytes past the boundary, the word to start
// from chosen once, outside the loop.
template <int ROWS, int CHUNKS>
__device__ __forceinline__ void shift_rows(uint8_t* dst, const uint8_t* raw, uint32_t delta, int n,
                                           int D) {
  const uint4* words = reinterpret_cast<const uint4*>(raw);
  const uint32_t sh = 8 * (delta % 4);
  if (delta == 0) return shift_rows_by<ROWS, CHUNKS, -1>(dst, words, sh, n, D);
  switch (delta / 4) {
    case 0: return shift_rows_by<ROWS, CHUNKS, 0>(dst, words, sh, n, D);
    case 1: return shift_rows_by<ROWS, CHUNKS, 1>(dst, words, sh, n, D);
    case 2: return shift_rows_by<ROWS, CHUNKS, 2>(dst, words, sh, n, D);
    default: return shift_rows_by<ROWS, CHUNKS, 3>(dst, words, sh, n, D);
  }
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

// wgmma.mma_async m64nNk16 with an f32 accumulator d of N/2 registers a
// thread: SS, A and B from shared memory (both K-major); RS, A from
// registers and B from shared memory, MN-major (transposed).

#define FLASH_WGMMA_SS_N64(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"  \
      :  \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define FLASH_WGMMA_SS_N96(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"  \
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"  \
      :  \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define FLASH_WGMMA_SS_N128(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"  \
      :  \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define FLASH_WGMMA_RS_N64(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
      :  \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define FLASH_WGMMA_RS_N128(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"  \
      :  \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define FLASH_WGMMA_RS_N160(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"  \
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"  \
      :  \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define FLASH_WGMMA_RS_N256(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"  \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"  \
      :  \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// d (64 x N) {=, +=} Q (64 x 16, shared, K-major) K^T (16 x N, shared, K-major)
template <typename T, int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 64) {
    if constexpr (kHalf) FLASH_WGMMA_SS_N64("f16");
    else FLASH_WGMMA_SS_N64("bf16");
  } else if constexpr (N == 96) {
    if constexpr (kHalf) FLASH_WGMMA_SS_N96("f16");
    else FLASH_WGMMA_SS_N96("bf16");
  } else {
    static_assert(N == 128, "K/V tile rows");
    if constexpr (kHalf) FLASH_WGMMA_SS_N128("f16");
    else FLASH_WGMMA_SS_N128("bf16");
  }
}

// d (64 x N) += P (64 x 16, registers) V (16 x N, shared, MN-major)
template <typename T, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 64) {
    if constexpr (kHalf) FLASH_WGMMA_RS_N64("f16");
    else FLASH_WGMMA_RS_N64("bf16");
  } else if constexpr (N == 128) {
    if constexpr (kHalf) FLASH_WGMMA_RS_N128("f16");
    else FLASH_WGMMA_RS_N128("bf16");
  } else if constexpr (N == 160) {
    if constexpr (kHalf) FLASH_WGMMA_RS_N160("f16");
    else FLASH_WGMMA_RS_N160("bf16");
  } else {
    static_assert(N == 256, "head width");
    if constexpr (kHalf) FLASH_WGMMA_RS_N256("f16");
    else FLASH_WGMMA_RS_N256("bf16");
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

__device__ __forceinline__ bool seen(int key, int row, int Sk, int off, int causal, int win) {
  return key < Sk && (!causal || key <= row + off) && (win == 0 || row + off - key < win);
}

__host__ __device__ constexpr int stored_width(int DN) {
  return (DN + kAtom - 1) / kAtom * kAtom;
}

// DN: the head width multiplied (D, or 64 for D <= 64); kTma: tiles by TMA
// (the maps are read) or by the producer's own loads (the pointers are).
template <typename T, int DN, int kBlockN, int kStages, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const T* __restrict__ q,
                const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o, int Hq,
                int Hkv, int Sq, int Sk, int D, float scale_log2, int causal, int off, int win) {
  using L = Layout<stored_width(DN), kBlockN, kStages, raw_slot(kTma, kBlockN, DN)>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* raw_q = empty + kStages;                // raw rows in (unaligned entry)
  uint64_t* raw_k = raw_q + 1;
  uint64_t* raw_v = raw_k + 1;

  const int bh = blockIdx.x;                        // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;        // heaviest causal tiles first
  const int q0 = qt * kBlockM;
  const int kv_plane = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  // the KV tiles t_lo .. t_lo + n_kv - 1 that some row q0 .. of the block sees
  const int key_hi = causal ? min(Sk, min(q0 + kBlockM, Sq) + off) : Sk;
  const int t_lo = win > 0 ? max(0, q0 + off - win + 1) / kBlockN : 0;
  const int n_kv = (key_hi + kBlockN - 1) / kBlockN - t_lo;

  if (threadIdx.x == 0) {
    const uint32_t arrivals = kTma ? 1 : kProducers;   // TMA: one arrival plus the bytes
    mbar_init(q_full, arrivals);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, arrivals);
      mbar_init(empty + s, kConsumers);
    }
    for (int i = 0; i < 3; ++i) mbar_init(raw_q + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {                             // producer warpgroup
    setmaxnreg_dec<Regs<kTma>::kProducer>();
    if constexpr (kTma) {                           // one thread starts every copy
      if (threadIdx.x == 0) {
        mbar_expect_tx(q_full, L::kQTile);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(smem + c * L::kQChunk, &map_q, q_full, c * kAtom, q0, bh);
        for (int t = 0; t < n_kv; ++t) {
          const int s = t % kStages;
          mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
          mbar_expect_tx(full + s, 2 * L::kKVTile);
          for (int c = 0; c < L::kChunks; ++c) {
            tma_load(smem + L::kK + s * L::kKVTile + c * L::kKVChunk, &map_k, full + s,
                     c * kAtom, (t_lo + t) * kBlockN, kv_plane);
            tma_load(smem + L::kV + s * L::kKVTile + c * L::kKVChunk, &map_v, full + s,
                     c * kAtom, (t_lo + t) * kBlockN, kv_plane);
          }
        }
      }
    } else {  // one thread starts bulk copies of raw rows, all 128 shift them into place
      static_assert(kBlockM * 2 * DN + 16 <= 2 * L::kRawSlot, "Q's raw rows fill both slots");
      const T* q_plane = q + static_cast<size_t>(bh) * Sq * D;
      const T* k_plane = k + static_cast<size_t>(kv_plane) * Sk * D;
      const T* v_plane = v + static_cast<size_t>(kv_plane) * Sk * D;
      uint8_t* raw_k_rows = smem + L::kRaw;
      uint8_t* raw_v_rows = raw_k_rows + L::kRawSlot;
      const bool lead = threadIdx.x == 0;
      const int q_rows = min(kBlockM, Sq - q0);
      if (lead) bulk_rows(raw_k_rows, q_plane, q0, q_rows, D, raw_q);
      mbar_wait(raw_q, 0);
      shift_rows<kBlockM, L::kChunks>(smem, raw_k_rows, misalignment(q_plane), q_rows, D);
      fence_proxy_async();
      mbar_arrive(q_full);
      producers_sync();                             // the raw slots are read: reuse them
      const int k_first = t_lo * kBlockN;
      if (lead) {
        bulk_rows(raw_k_rows, k_plane, k_first, min(kBlockN, Sk - k_first), D, raw_k);
        bulk_rows(raw_v_rows, v_plane, k_first, min(kBlockN, Sk - k_first), D, raw_v);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        const int k0 = k_first + t * kBlockN;
        const int rows = min(kBlockN, Sk - k0);
        const int next = t + 1 < n_kv ? min(kBlockN, Sk - k0 - kBlockN) : 0;   // of tile t + 1
        mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
        mbar_wait(raw_k, t & 1);
        shift_rows<kBlockN, L::kChunks>(smem + L::kK + s * L::kKVTile, raw_k_rows,
                                        misalignment(k_plane), rows, D);
        producers_sync();
        if (lead && next > 0) bulk_rows(raw_k_rows, k_plane, k0 + kBlockN, next, D, raw_k);
        mbar_wait(raw_v, t & 1);
        shift_rows<kBlockN, L::kChunks>(smem + L::kV + s * L::kKVTile, raw_v_rows,
                                        misalignment(v_plane), rows, D);
        fence_proxy_async();
        mbar_arrive(full + s);
        producers_sync();
        if (lead && next > 0) bulk_rows(raw_v_rows, v_plane, k0 + kBlockN, next, D, raw_v);
      }
    }
    return;
  }
  setmaxnreg_inc<Regs<kTma>::kConsumer>();

  const int cw = warpgroup - 1;                     // consumer warpgroup: rows 64 cw ..
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row_first = q0 + 64 * cw;
  const int r0 = row_first + 16 * w + lane / 4;     // this lane's rows r0 and r0 + 8
  const int col = 2 * (lane % 4);                   // and columns 8j + col, + 1
  const uint32_t q_addr = smem_u32(smem) + 64 * kRowBytes * cw;

  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % kStages;
    mbar_wait(full + s, (t / kStages) & 1);
    const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kKVTile);
    const uint32_t v_addr = smem_u32(smem + L::kV + s * L::kKVTile);

    float sc[kBlockN / 2];                          // scores, then base-2 logits
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DN / 16; ++kk) {          // 16 columns a step; chunk kk / 4
      const uint32_t cb = (kk % 4) * 32;
      wgmma_qk<T, kBlockN>(sc, smem_desc(q_addr + (kk / 4) * L::kQChunk + cb, 16, 1024),
                           smem_desc(k_addr + (kk / 4) * L::kKVChunk + cb, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= scale_log2;
    const int k0 = (t_lo + t) * kBlockN;
    if (k0 + kBlockN > Sk || (causal && k0 + kBlockN - 1 > row_first + off) ||
        (win > 0 && k0 <= row_first + 63 + off - win)) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + col + e;
          if (!seen(key, r0, Sk, off, causal, win)) sc[4 * j + e] = kNegInf;
          if (!seen(key, r0 + 8, Sk, off, causal, win)) sc[4 * j + 2 + e] = kNegInf;
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
    for (int j = 0; j < DN / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {     // 16 keys a step
      wgmma_pv<T, DN>(acc, *reinterpret_cast<const uint32_t(*)[4]>(p + 4 * kk),
                      smem_desc(v_addr + kk * 16 * kRowBytes, L::kKVChunk, 1024));
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
  for (int j = 0; j < DN / 8; ++j) {
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

// A (D, S, planes) tensor of 16-bit values, read in (64, rows, 1) boxes with
// the 128-byte swizzle; columns at or past D and rows at or past S read as 0.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int D,
            int S, int planes, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {kAtom, static_cast<cuuint32_t>(rows), 1};
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

template <typename T, int DN, int kBlockN, int kStages, bool kTma>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                   int Sq, int Sk, int D, float scale, bool causal, int off, int win,
                   cudaStream_t stream) {
  constexpr int smem =
      Layout<stored_width(DN), kBlockN, kStages, raw_slot(kTma, kBlockN, DN)>::kBytes;
  const auto kernel = flash_tc_kernel<T, DN, kBlockN, kStages, kTma>;
  static bool ready[kMaxDevices] = {false};     // checked and opted in, once per device
  const int dev = current_device();
  if (!ready[dev]) {
    // setmaxnreg moves registers within the block's own: a block launched
    // with fewer than 168 a thread would wait for ever, so refuse instead
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs < 168) return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  CUtensorMap map_q{}, map_k{}, map_v{};
  if constexpr (kTma) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    const CUtensorMapDataType type = std::is_same<T, __half>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!encode(fn, &map_q, q, type, D, Sq, B * Hq, kBlockM) ||
        !encode(fn, &map_k, k, type, D, Sk, B * Hkv, kBlockN) ||
        !encode(fn, &map_v, v, type, D, Sk, B * Hkv, kBlockN))
      return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((Sq + kBlockM - 1) / kBlockM));
  kernel<<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, D, scale * kLog2e,
      causal ? 1 : 0, off, win);
  return cudaGetLastError();
}

// The instantiation of each head dim: the width multiplied, the K/V tile
// rows and the ring's stages (the header says why). The unaligned entry's
// raw slots take room from the widest: D = 160 there has tiles of 64 keys,
// and D = 256 one stage.
template <typename T, bool kTma>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                     int Sq, int Sk, int D, float scale, bool causal, int off, int win,
                     cudaStream_t stream) {
  switch (D) {
    case 8:
    case 16:
    case 32:
    case 64:
      return launch<T, 64, 128, 2, kTma>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, causal, off,
                                         win, stream);
    case 128:
      return launch<T, 128, 128, 2, kTma>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, causal, off,
                                          win, stream);
    case 160:
      return launch<T, 160, kTma ? 96 : 64, 2, kTma>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale,
                                                     causal, off, win, stream);
    case 256:
      return launch<T, 256, 64, kTma ? 2 : 1, kTma>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale,
                                                    causal, off, win, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Whether a row would see no key: causal, row 0 (at position off) before key
// 0; with a window, the last row (at Sq - 1 + off) past key Sk - 1 by the
// window or more. The rows between see keys if these two do.
bool empty_rows(int Sq, int Sk, int causal, int off, int win) {
  return (causal && off < 0) ||
         (win > 0 && static_cast<long long>(Sq) - 1 + off - win >= Sk - 1);
}

template <bool kTma>
int entry(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
          int Sk, int D, int dtype, float scale, int causal, int off, int win, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Sk <= 0 || win < 0 ||
      (Sq + kBlockM - 1) / kBlockM > 65535 || empty_rows(Sq, Sk, causal, off, win))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16, kTma>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                                          scale, causal != 0, off, win, s));
  if (dtype == 2)
    return static_cast<int>(launch_d<__half, kTma>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale,
                                                   causal != 0, off, win, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), o (B, Hq, Sq, D), contiguous;
// q, k and v 16-byte aligned; dtype 1 for bfloat16, 2 for float16; D in
// {8, 16, 32, 64, 128, 160, 256}; off the key position of query row 0
// (Sk - Sq: bottom-right), win the sliding window (0: none).
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                                        int B, int Hq, int Hkv, int Sq, int Sk, int D, int dtype,
                                        float scale, int causal, int off, int win,
                                        void* stream) {
  return entry<true>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, dtype, scale, causal, off, win, stream);
}

// As repro_flash_attention_tc, with q, k and v at any address their type
// allows (o contiguous and aligned, as the wrapper allocates it).
extern "C" int repro_flash_attention_tc_unaligned(const void* q, const void* k, const void* v,
                                                  void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                                                  int D, int dtype, float scale, int causal,
                                                  int off, int win, void* stream) {
  return entry<false>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, dtype, scale, causal, off, win, stream);
}
