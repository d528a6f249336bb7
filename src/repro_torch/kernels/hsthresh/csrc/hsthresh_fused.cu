// The whole streaming hard threshold H_s in one launch, for NVIDIA Hopper,
// sm_90a: histogram, threshold pick, mask and tie fill of every row of a
// (B, N) float32 batch.
//
// repro_hsthresh replaces the chain that repro/kernels/hsthresh/ops.py::hsthresh
// runs around hist_pallas (kernel.py:40, pallas_call :48) and mask_pallas
// (kernel.py:62, pallas_call :69): for each row, as hsthresh_ref computes it,
//
//     vmax = max(max |x|, 1e-30)
//     hist[i] = #{ clamp(trunc((|x| / vmax) * nbins), 0, nbins - 1) == i }
//     idx = first i with sum_{j >= i} hist[j] <= s, or nbins if none
//     t = f32(idx) * vmax / nbins
//     y = where(|x| > t, x, 0), then the threshold-bin ties (t - vmax / nbins
//         <= |x| <= t, |x| > 0) kept in ascending index order until the
//         support reaches s.
//
// Every float operation is the reference's, in its order, with __fdiv_rn,
// __fmul_rn and __fsub_rn (no fast division, no contraction); the counts are
// integers and the max is order-free, so y equals the plain chain bit for bit.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes, 8 * B * N (x read once,
// y written once): 0.16 us at B = 1, N = 65,536. The plain chain it replaces
// (two kernels, hist and mask, and some 33 small tensor ops between them) is
// about 35 launches per call and reads x about six times; in the solver's
// host-bound loop the launches are the cost, not the bytes.
//
// Design, and what it does about that:
//   * One launch per call. Each row is one thread-block cluster of C <= 8
//     CTAs (grid C x B), C = ceil(N / 8,192): a CTA takes a contiguous chunk
//     of L = ceil(N / C) elements (rounded up to 4). When the chunk fits
//     shared memory (the resident case: every row up to ~390K elements at
//     2,048 bins) the CTA copies it in once with one bulk asynchronous copy
//     (cp.async.bulk on an mbarrier) for its 16-byte aligned middle and plain
//     loads for the ragged ends; every later pass reads shared memory. A
//     larger row streams its chunk from global memory in each pass instead.
//   * vmax: each CTA takes its chunk's max |x|; after a cluster barrier every
//     CTA reads all C of them over distributed shared memory (DSMEM).
//   * Histogram: nbins int counters in each CTA's shared memory. A lane bins
//     four independent elements per step (the division's latency is the
//     cost); a warp whose 32 elements share one bin adds them with one
//     atomic, so a flat row does not serialize on one counter (otherwise
//     plain atomics: on the H100 they beat grouping lanes by bin with
//     __match_any_sync).
//     The C histograms are summed over DSMEM in two steps: rank r sums slice
//     r of the bins over the cluster, then every CTA gathers the whole summed
//     histogram from the slices.
//   * The pick: every CTA runs the same suffix scan on the same counts, so
//     all ranks find the same idx and t and nothing is broadcast. The bins
//     whose suffix sum exceeds s are a prefix, so idx is their number.
//   * Mask and tie fill: each warp owns a contiguous segment of its CTA's
//     chunk, so warp order is index order. Each CTA counts its strict
//     survivors and ties (per warp), publishes its totals, and after a
//     cluster barrier reads the strict total of the row and the ties of the
//     lower ranks. A tie's global rank is then that prefix, plus the ties of
//     the lower warps, plus a ballot prefix within the warp; y is written
//     once.
//   * Five cluster barriers in all; the last one (split into arrive and
//     wait around the write of y) keeps every CTA's shared memory alive
//     until the others have read it.
//
// Plain C interface, built with nvcc and loaded with ctypes: repro_hsthresh
// launches on the given stream, does not synchronise, and returns a
// cudaError_t.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kChunkTarget = 8192;       // elements per CTA the cluster size aims at
constexpr int kMaxBins = 12288;          // as hsthresh.cu's hist
constexpr int kSmemBudget = 200 * 1024;  // dynamic shared memory of a CTA
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kWatchdogCycles = 1ll << 34;  // ~10 s: a wait this long is a fault

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Wait for phase 0 of the copy's mbarrier; a copy that never lands traps
// after ~10 s (the launch then reports an error) instead of hanging.
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (done) return;
    if (clock64() - t0 > kWatchdogCycles) __trap();
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Shared memory besides the dynamic part: what the passes reduce through and
// what a CTA publishes to the others of its cluster.
struct Scalars {
  uint64_t bar;                  // the bulk copy's mbarrier
  float warp_max[kWarps];
  int warp_a[kWarps], warp_b[kWarps];
  int warp_tied[kWarps];
  float cta_max;                 // published: this chunk's max |x|
  int cta_strict, cta_tied;      // published: strict survivors and ties of this chunk
  float vmax;
  int idx, strict_total, tied_before;
};

// RESIDENT: the chunk lives in shared memory after one copy; otherwise every
// pass reads it from global memory. Dynamic shared memory: hist (nbins int),
// slice (sb int), then, resident, the chunk (L + 4 floats, 16-byte aligned).
template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
hsthresh_kernel(const float* __restrict__ x, float* __restrict__ y, int N, int L, int nbins,
                int sb, int s) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scalars sh;
  int* hist = reinterpret_cast<int*>(smem);
  int* slice = hist + nbins;

  const size_t row0 = static_cast<size_t>(blockIdx.y) * N;
  const long long b64 = static_cast<long long>(r) * L;
  const int begin = static_cast<int>(b64 < N ? b64 : N);
  const int len = min(N - begin, L);
  const float* gsrc = x + row0 + begin;
  float* gdst = y + row0 + begin;

  for (int i = tid; i < nbins; i += kThreads) hist[i] = 0;
  const float* src = gsrc;
  if constexpr (RESIDENT) {
    // element i of the chunk at chunk[pad + i], so that the 16-byte aligned
    // middle of the global chunk lands on a 16-byte aligned address
    const uintptr_t ga = reinterpret_cast<uintptr_t>(gsrc);
    const int head = min(len, static_cast<int>(((16 - (ga & 15)) & 15) >> 2));
    const int nvec = (len - head) & ~3;
    const int pad = (4 - head) & 3;
    const uintptr_t cbase = (reinterpret_cast<uintptr_t>(slice + sb) + 15) & ~uintptr_t(15);
    float* chunk = reinterpret_cast<float*>(cbase) + pad;
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&sh.bar)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0 && nvec > 0)
      bulk_load(chunk + head, gsrc + head, static_cast<uint32_t>(nvec) * 4u, &sh.bar);
    for (int i = tid; i < head; i += kThreads) chunk[i] = gsrc[i];
    for (int i = head + nvec + tid; i < len; i += kThreads) chunk[i] = gsrc[i];
    if (nvec > 0) mbar_wait0(&sh.bar);
    __syncthreads();
    src = chunk;
  }

  // ---- vmax: the chunk's max |x|, then the row's over DSMEM
  float m = 0.f;
  for (int i = tid; i < len; i += kThreads) m = fmaxf(m, fabsf(src[i]));
  m = warp_max(m);
  if (lane == 0) sh.warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    float v = warp_max(lane < kWarps ? sh.warp_max[lane] : 0.f);
    if (lane == 0) sh.cta_max = v;
  }
  cluster.sync();                                            // 1: maxima published
  if (warp == 0) {
    const float v = warp_max(lane < C ? *cluster.map_shared_rank(&sh.cta_max, lane) : 0.f);
    if (lane == 0) sh.vmax = v < 1e-30f ? 1e-30f : v;      // clamp_min(amax, 1e-30)
  }
  __syncthreads();
  const float vm = sh.vmax;
  const float nb = static_cast<float>(nbins);

  // ---- the chunk's histogram: four independent elements a lane per step;
  // a warp whose 32 elements share one bin adds them with one atomic
  for (int base = warp * 32; base < len; base += 4 * kThreads) {
    int idx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads + lane;
      idx[u] = -1;
      if (i < len) {
        const float q = __fmul_rn(__fdiv_rn(fabsf(src[i]), vm), nb);
        const int k = static_cast<int>(q);                   // truncation toward zero
        idx[u] = k < 0 ? 0 : (k > nbins - 1 ? nbins - 1 : k);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int first = __shfl_sync(kFull, idx[u], 0);
      if (__all_sync(kFull, idx[u] == first)) {
        if (lane == 0 && first >= 0) atomicAdd(&hist[first], 32);
      } else if (idx[u] >= 0) {
        atomicAdd(&hist[idx[u]], 1);
      }
    }
  }
  cluster.sync();                                            // 2: histograms complete

  // ---- rank r sums slice r of the bins over the cluster ...
  {
    const int s0 = r * sb, s1 = min(nbins, s0 + sb);
    for (int i = s0 + tid; i < s1; i += kThreads) {
      int sum = 0;
      for (int q = 0; q < C; ++q) sum += cluster.map_shared_rank(hist, q)[i];
      slice[i - s0] = sum;
    }
  }
  cluster.sync();                                            // 3: slices summed
  // ... and every CTA gathers the whole row's histogram from the slices
  for (int i = tid; i < nbins; i += kThreads) {
    const int q = i / sb;
    hist[i] = cluster.map_shared_rank(slice, q)[i - q * sb];
  }
  __syncthreads();

  // ---- the pick: idx = number of bins whose suffix sum exceeds s
  {
    const int per = (nbins + kThreads - 1) / kThreads;
    const int lo = min(nbins, tid * per), hi = min(nbins, lo + per);
    int part = 0;
    for (int i = lo; i < hi; ++i) part += hist[i];
    int suf = part;                                          // sum over lanes >= lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(kFull, suf, off);
      if (lane + off < 32) suf += o;
    }
    if (lane == 0) sh.warp_a[warp] = suf;
    __syncthreads();
    int tail = suf - part;                                   // the bins after this thread's
    for (int w = warp + 1; w < kWarps; ++w) tail += sh.warp_a[w];
    int over = 0;
    for (int i = hi - 1; i >= lo; --i) {
      tail += hist[i];
      over += tail > s;
    }
    over = warp_sum(over);
    if (lane == 0) sh.warp_b[warp] = over;
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int w = 0; w < kWarps; ++w) n += sh.warp_b[w];
      sh.idx = n;
    }
    __syncthreads();
  }
  const float t = __fdiv_rn(__fmul_rn(static_cast<float>(sh.idx), vm), nb);
  const float lo_t = __fsub_rn(t, __fdiv_rn(vm, nb));         // t - binw

  // ---- strict survivors and ties, per warp segment (index order)
  const int seg = ((len + kWarps - 1) / kWarps + 31) & ~31;
  const int w0 = min(len, warp * seg), w1 = min(len, w0 + seg);
  {
    int n_strict = 0, n_tied = 0;
    for (int i = w0 + lane; i < w1; i += 32) {
      const float a = fabsf(src[i]);
      const bool st = a > t;
      n_strict += st;
      n_tied += !st && a >= lo_t && a > 0.f;
    }
    n_strict = warp_sum(n_strict);
    n_tied = warp_sum(n_tied);
    if (lane == 0) {
      sh.warp_a[warp] = n_strict;
      sh.warp_tied[warp] = n_tied;
    }
    __syncthreads();
    if (tid == 0) {
      int a = 0, b = 0;
      for (int w = 0; w < kWarps; ++w) {
        a += sh.warp_a[w];
        b += sh.warp_tied[w];
      }
      sh.cta_strict = a;
      sh.cta_tied = b;
    }
  }
  cluster.sync();                                            // 4: counts published
  if (warp == 0) {
    const int st = warp_sum(lane < C ? *cluster.map_shared_rank(&sh.cta_strict, lane) : 0);
    const int ti = warp_sum(lane < r ? *cluster.map_shared_rank(&sh.cta_tied, lane) : 0);
    if (lane == 0) {
      sh.strict_total = st;
      sh.tied_before = ti;
    }
  }
  cluster_arrive();                                          // 5: no more DSMEM reads
  __syncthreads();
  const int room = s - sh.strict_total;
  int offset = sh.tied_before;
  for (int w = 0; w < warp; ++w) offset += sh.warp_tied[w];

  // ---- y, once: strict survivors, and ties while their row rank < room
  for (int base = w0; base < w1; base += 32) {
    const int i = base + lane;
    float v = 0.f;
    bool st = false, ti = false;
    if (i < w1) {
      v = src[i];
      const float a = fabsf(v);
      st = a > t;
      ti = !st && a >= lo_t && a > 0.f;
    }
    const unsigned tied = __ballot_sync(kFull, ti);
    const int rank = offset + __popc(tied & ((1u << lane) - 1u));
    if (i < w1) gdst[i] = (st || (ti && rank < room)) ? v : 0.f;
    offset += __popc(tied);
  }
  cluster_wait();
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return (dev < 0 || dev >= kMaxDevices) ? 0 : dev;
}

template <bool RESIDENT>
cudaError_t launch(const float* x, float* y, int B, int N, int C, int L, int nbins, int sb,
                   int s, size_t smem, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {false};
  const int dev = current_device();
  if (!opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        hsthresh_kernel<RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C), static_cast<unsigned>(B), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, hsthresh_kernel<RESIDENT>, x, y, N, L, nbins, sb, s);
}

}  // namespace

// x, y (B, N) f32, contiguous (x may start anywhere a float can); s the
// support size (any int: the kernel clamps nothing, s < 0 keeps nothing);
// nbins in [1, 12,288].
extern "C" int repro_hsthresh(const float* x, float* y, int B, int N, int s, int nbins,
                              void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || nbins <= 0 || nbins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  int C = (N + kChunkTarget - 1) / kChunkTarget;
  C = C < 1 ? 1 : (C > kMaxCluster ? kMaxCluster : C);
  const long long per = (static_cast<long long>(N) + C - 1) / C;
  const int L = static_cast<int>((per + 3) & ~3ll);
  const int sb = (nbins + C - 1) / C;
  const size_t fixed = sizeof(int) * (static_cast<size_t>(nbins) + sb);
  const size_t resident = fixed + 16 + sizeof(float) * (static_cast<size_t>(L) + 4);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident <= static_cast<size_t>(kSmemBudget))
    return static_cast<int>(launch<true>(x, y, B, N, C, L, nbins, sb, s, resident, st));
  return static_cast<int>(launch<false>(x, y, B, N, C, L, nbins, sb, s, fixed, st));
}
