// Matmul with a BatchNorm-statistics epilogue (Hopper, sm_90a): a 1x1 NHWC
// convolution run as a GEMM that also emits the per-channel sum and sum of
// squares of its output, for the BatchNorm that consumes it.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas_fused.py:_kernel
// (entry matmul_stats -> _matmul_stats_raw). For x (M, K) row-major and the
// weight w as it lies in OIHW, (N, K) row-major:
//   acc[m, n] = sum_k x[m, k] * w[n, k]      in f32
//   y[m, n]   = acc[m, n] rounded to x's dtype
//   s1[n]     = sum_m acc[m, n],  s2[n] = sum_m acc[m, n]^2   (f32)
// The statistics come from the f32 accumulator, not from the rounded y.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16; x, w, y moved
// once each). The 33 launches of a ResNet-50 step (batch 128, 224x224) fall
// in three classes:
//   wide M, narrow K and N (M = 401408, K and N in 64..256; M = 100352,
//     K and N in 128..512; M = 25088, K and N in 256..1024 but for 1024x512):
//     bound by bytes, 0.019-0.092 ms a launch, y the largest stream;
//   M = 25088, K = 1024, N = 512 and M = 6272, K or N = 2048: bound by
//     operations, 0.013-0.027 ms a launch;
//   together 1.203 ms a step, of which 9 of 12 shapes (30 of 33 launches)
//     are byte-bound.
// The TPU kernel's point was to keep the statistics pass from re-reading y
// from device memory; here too they come out of the tile on chip.
//
// In float32 the same 33 launches are bound by 3xTF32 operations on the
// tensor cores (below) at 495 TFLOP/s where K and N reach 256 or more, by
// bytes (x and y in f32) elsewhere: 3.319 ms a step; the FP32 SIMT peak
// (67 TFLOP/s) would bound them at 6.93 ms.
//
// Four kernels, chosen per call by the wrapper (ops/matmul_stats.py
// kernel_route, a pure function of M, K, N, dtype and alignment):
//
// "wgmma" (bf16, K % 8 == 0, N % 8 == 0, x and w 16-byte aligned; all 33
// ResNet-50 pairs): mm_stats_wgmma_kernel, built the way Hopper GEMMs are.
//   Loads by TMA. x (M, K) and w (N, K) are 2-D tensor maps, K innermost,
//     with 128-byte swizzle; a K step is 64 bf16 = one 128-byte box row.
//     TMA zero-fills the ragged M, N and K edges (no masks), so zero rows
//     and columns add nothing to the sums. cuTensorMapEncodeTiled comes
//     through cudaGetDriverEntryPointByVersion (cudaGetDriverEntryPoint
//     before CUDA 12.5): no -lcuda.
//   A ring of S stages (x tile 128x64, w tile BNx64) with a full and an
//     empty mbarrier each. One producer thread keeps S K-steps in flight,
//     across tile boundaries: at K = 64 a tile is one step, so the ring
//     holds the next S tiles' operands while the current tile's epilogue
//     runs (the wmma kernel starts its ring anew in each tile, so at two or
//     four K-steps it never fills).
//   Two consumer warpgroups, 64 rows each, issue wgmma.mma_async m64nBNk16
//     (f32 accumulate) with A and B read from shared memory, both K-major,
//     the layout wgmma takes without a transpose; one group stays in
//     flight while the previous step's stage is released. setmaxnreg gives
//     the producer warpgroup's registers to the consumers (40 / 232).
//   A persistent grid: one block per SM (cudaDevAttrMultiProcessorCount),
//     tile = blockIdx.x + i * gridDim.x, the N-tiles of one M-tile
//     adjacent so that concurrent blocks share the x tile through L2.
//   BN chosen from M, N and the SM count (ops/matmul_stats.py
//     wgmma_tile_n): 64 up to 64 columns, 128 up to 128; wider, 256 or
//     128, whichever puts the fewer tile-columns on a block of the
//     persistent grid (rounds of one tile an SM times BN), 256 on a tie, so
//     that x is read once unless the rounds say otherwise. BM = 128.
//     Configurations (shared memory including 1 KB of alignment slack;
//     registers, from ptxas: 168 at launch, no spills; setmaxnreg 40 for
//     the producer warpgroup, 232 for the consumers):
//       BN  64: 8 stages, 218368 bytes of shared memory, 32 accumulators
//       BN 128: 5 stages, 206160 bytes of shared memory, 64 accumulators
//       BN 256: 3 stages, 230960 bytes of shared memory, 128 accumulators
//     At the step shapes on 132 SMs (M, K, N -> BN, tiles):
//       (401408, 64, 64) -> 64, 3136     (401408, 64, 256) -> 256, 3136
//       (401408, 256, 64) -> 64, 3136    (401408, 256, 128) -> 128, 3136
//       (100352, 128, 512) -> 256, 1568  (100352, 512, 128) -> 128, 784
//       (100352, 512, 256) -> 256, 784   (25088, 256, 1024) -> 256, 784
//       (25088, 1024, 256) -> 128, 392   (25088, 1024, 512) -> 256, 392
//       (6272, 512, 2048) -> 256, 392    (6272, 2048, 512) -> 256, 98
//     (25088, 1024, 256) takes 128: 392 tiles are 3 rounds of half-width
//     tiles against 2 rounds of 196 full ones. At (6272, 2048, 512) the 98
//     tiles fill 0.74 of the SMs; 128-wide tiles give 2 rounds of 196, no
//     fewer tile-columns, and were slower on the card.
//     Tried on the card and left out: deeper rings (4 and 6 stages) bought
//     with y staged 64 columns at a time (slower: the epilogue waits on
//     each store), clusters of two CTAs sharing the w tile by TMA
//     multicast (no faster: the main loop is not bound by L2 reads), and
//     a combination per warpgroup instead of per block (slower).
//   Statistics from registers. Each thread adds its two rows per column
//     (s1 and s2 in place of the accumulators, after y has left them) and
//     keeps the sums in registers over the block's tiles of one N-tile
//     (the tile order keeps a block on one N-tile when the grid is a
//     multiple of the N-tile count: 132 is for the step shapes' 1, 2 and
//     4, not for 8). At BN = 256 a
//     thread's 128 sums would not fit beside its 128 accumulators, so
//     each tile first folds them twice (below) into 32. The 8 lanes
//     sharing a column (lane bits 2-4 of the wgmma fragment) are folded by
//     a reduce-scatter of __shfl_xor_sync (16, 8, 4: each step halves the
//     values a lane holds, Q/2 + Q/4 + Q/8 shuffles for Q values, not 3Q);
//     when the N-tile changes and at the end, the 8 consumer warps meet in
//     a small shared buffer, are summed in warp order and added to the
//     block's row of partials (grid, 2, N). One reduce_partials launch
//     sums the blocks in a fixed order. No float atomics: two runs are
//     bitwise equal.
//   y from registers through a TMA store: rounded to bf16 and written by
//     stmatrix (four 8x8 matrices a warp instruction, the accumulator's
//     own fragment layout) into a 128-byte-swizzled staging tile, stored
//     with cp.async.bulk.tensor (TMA clips the ragged edges); the
//     warpgroup waits on cp.async.bulk.wait_group.read only before it
//     rewrites the staging tile, so the store drains under the next
//     tile's main loop.
//
// "tf32x3" (float32, K % 4 == 0, N % 4 == 0, x and w 16-byte aligned; all
// 33 ResNet-50 pairs): mm_stats_tf32x3_kernel, the wgmma kernel's
// schedule (producer warp, mbarrier ring, two consumer warpgroups,
// setmaxnreg 40 / 232, persistent grid, N-tiles of an M-tile adjacent)
// and its statistics from registers, on the tensor cores in TF32.
//   3xTF32: each operand a = big + small, big = cvt.rna.tf32(a), small =
//     cvt.rna.tf32(a - big) (a - big is exact in f32); per K-step of 8,
//     three wgmma.mma_async m64nBNk8 .tf32 into one f32 accumulator,
//     x_small w_big + x_big w_small + x_big w_big. Each product is off by
//     some 3 * 2^-22 of |x||w| (the dropped x_small w_small and the
//     rounding of the small terms), against 2^-11 for one TF32 pass: the
//     result agrees with a full FP32 product within 1e-5 of sum |x||w|,
//     but is not its bitwise FP32 FMA result. torch's allow_tf32 does not
//     switch it. Only rounded values reach the tensor cores.
//   w (at most N K = 1M floats a step shape) is split by a pre-pass,
//     split_tf32_kernel, into a (2, N, K) scratch; TMA loads the w_big and
//     w_small tiles. x is read once, as TMA loads it: a K box is 32 floats,
//     one 128-byte swizzled row. The consumers split it in registers and
//     feed A from registers (tf32 takes no transpose; x and w are both
//     K-major), reading the fragment from the swizzled stage by hand:
//     ldmatrix is b16 only. Those reads are free of bank conflicts (the 8
//     rows of a lane group are 8 swizzle chunks apart).
//   A loop writes a stage's A fragment into the same registers on every
//     K-step, so a warpgroup waits for its stage's wgmma group before the
//     next (an in-flight wgmma reads its A registers until it completes;
//     with one group left in flight, results came out wrong on the card);
//     the other warpgroup's group keeps the tensor cores busy.
//   What bounds it: not the tensor cores. Built with one TF32 product
//     instead of three it is only a fifth faster (4.02 against 5.01 ms a
//     step; python -m mxnet_tpu_torch.tools.b1_variants, NVIDIA H100 80GB
//     HBM3 at 700 W), so the main loop waits on the stages, 48 KB of x,
//     w_big and w_small from L2 for every 32-wide K step of a 128x128 tile
//     (4x bf16's bytes per product). Tried there and left out: reading the
//     next stage's A into a second register bank while the group runs
//     (5.04), unfolded running sums (5.02), 64-wide N-tiles everywhere with
//     5 stages (5.83).
//   y leaves in f32: st.shared.v2 pairs into a 128-byte-swizzled staging
//     tile (stmatrix is b16 only), one TMA store per 64x32 sub-tile, clipped
//     at the edges. BN = 256 does not fit with a full f32 staging tile, so
//     BN is 64 up to 64 columns, else 128 (ops/matmul_stats.py
//     tf32x3_tile_n). Configurations (shared memory including 1 KB of
//     alignment slack; registers, from ptxas: 168 at launch, no spills):
//       tf32x3 BN  64: 5 f32 stages, 201936 bytes of shared memory, 32 accumulators
//       tf32x3 BN 128: 3 f32 stages, 222512 bytes of shared memory, 64 accumulators
//     At BN = 128 the running sums are folded once per tile (32 registers
//     beside the 64 accumulators).
// "wmma" (bf16 shapes the TMA route cannot take: K or N not a multiple of
// 8, unaligned pointers): a tile kernel on mma.sync.
//   128x128 output tile per block of 8 warps, each warp 64x32 as 4x2
//   nvcuda::wmma 16x16x16 bf16 fragments (mma.sync, f32 accumulate). K runs
//   in steps of 32 through a ring of three shared-memory stages filled by
//   cp.async. Two blocks fit on an SM (at most 128 registers a thread, 68
//   KB of shared memory each). Copies are 16-byte cp.async when K % 8 == 0
//   and the pointers are 16-byte aligned, else element by element; ragged
//   edges are zero-filled, so any M, N, K works. y leaves in 16-byte stores
//   when N % 8 == 0.
// "f32" (float32 shapes the tf32x3 route cannot take: K or N not a
//   multiple of 4, unaligned pointers): 64x64 tile, 256 threads with 4x4
//   outputs each, FP32 FMA.
//   Epilogue (wmma and f32): the f32 accumulator tile goes to shared
//   memory; y is written from there, and each column's sum and sum of
//   squares over the tile's rows are reduced in a fixed order into a
//   per-M-tile partial buffer (tiles_m, 2, N).
// reduce_partials: sums partials over tiles or blocks in a fixed order (a
//   chunked first pass when there are many, then a final one), into stats
//   (2, N) = [s1; s2].
//
// The entry points launch on the caller's stream, do not synchronise and
// allocate nothing; each returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;

// bf16 tensor-core tile
constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32;
constexpr int kTcStages = 3;        // shared-memory ring of K-steps
constexpr int kTcLds = kTcBK + 8;   // bf16 pitch of a stage row: 80 bytes
constexpr int kTcLdc = kTcBN + 4;   // f32 pitch of the accumulator tile
constexpr int kTcStageElems = (kTcBM + kTcBN) * kTcLds;
constexpr size_t kTcStageBytes =
    kTcStages * kTcStageElems * sizeof(__nv_bfloat16);
constexpr size_t kTcCBytes = (size_t)kTcBM * kTcLdc * sizeof(float);
constexpr size_t kTcRedBytes = 2 * (kThreads / kTcBN) * kTcBN * sizeof(float);
constexpr size_t kTcSmem =
    (kTcStageBytes > kTcCBytes ? kTcStageBytes : kTcCBytes) + kTcRedBytes;

// f32 SIMT tile
constexpr int kF32BM = 64, kF32BN = 64, kF32BK = 16;

// partial reduction: tiles summed per block in the first pass
constexpr int kRedChunk = 64;
constexpr int kRedRows = 8;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Write the f32 accumulator tile Cs (BM x BN, pitch ldc) to y, element by
// element, rounded to T.
template <typename T, int BM, int BN>
__device__ __forceinline__ void store_y(const float* Cs, int ldc, T* y, int M,
                                        int N, int m0, int n0) {
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      y[(size_t)gm * N + gn] = from_f32<T>(Cs[r * ldc + c]);
  }
}

// bf16 y in 16-byte stores of 8 columns: needs N % 8 == 0 (each chunk is
// then wholly inside or outside the matrix) and ldc % 4 == 0
template <int BM, int BN>
__device__ __forceinline__ void store_y8(const float* Cs, int ldc,
                                         __nv_bfloat16* y, int M, int N,
                                         int m0, int n0) {
  for (int i = threadIdx.x; i < BM * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float4 a = *reinterpret_cast<const float4*>(Cs + r * ldc + c);
    const float4 b = *reinterpret_cast<const float4*>(Cs + r * ldc + c + 4);
    union { uint4 v; __nv_bfloat162 h[4]; } u;
    u.h[0] = __floats2bfloat162_rn(a.x, a.y);
    u.h[1] = __floats2bfloat162_rn(a.z, a.w);
    u.h[2] = __floats2bfloat162_rn(b.x, b.y);
    u.h[3] = __floats2bfloat162_rn(b.z, b.w);
    *reinterpret_cast<uint4*>(y + (size_t)gm * N + gn) = u.v;
  }
}

// Each column's sum and sum of squares over the tile's rows, in a fixed
// order, into this M-tile's row of part. Rows past M hold zeros (their x
// rows were zero-filled) and are skipped anyway.
template <int BM, int BN>
__device__ __forceinline__ void column_stats(const float* Cs, int ldc,
                                             float* red, float* part, int M,
                                             int N, int m0, int n0,
                                             int mtile) {
  constexpr int G = kThreads / BN;   // row groups per column
  const int c = threadIdx.x % BN, g = threadIdx.x / BN;
  const int rows = min(BM, M - m0);
  float a = 0.0f, b = 0.0f;
  for (int r = g; r < rows; r += G) {
    const float v = Cs[r * ldc + c];
    a += v;
    b += v * v;
  }
  red[g * BN + c] = a;
  red[(G + g) * BN + c] = b;
  __syncthreads();
  if (g == 0 && n0 + c < N) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      s1 += red[i * BN + c];
      s2 += red[(G + i) * BN + c];
    }
    part[((size_t)mtile * 2 + 0) * N + n0 + c] = s1;
    part[((size_t)mtile * 2 + 1) * N + n0 + c] = s2;
  }
}

// Copy 8 consecutive bf16 of row `row`, from column k, to shared memory
// at dst; zeros outside the matrix. VEC: one asynchronous 16-byte copy
// (cp.async, zero-filled when outside), completed by cp_async_wait; else
// element by element, visible after the next barrier.
template <bool VEC>
__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* base, int row,
                                      int rows, int k, int K) {
  if (VEC) {
    const bool in = row < rows && k < K;
    const __nv_bfloat16* src = in ? base + (size_t)row * K + k : base;
    const unsigned saddr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     saddr),
                 "l"(src), "r"(in ? 16 : 0));
    return;
  }
  union { uint4 v; unsigned short h[8]; } u;
  const unsigned short* p = reinterpret_cast<const unsigned short*>(base);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    u.h[j] = (row < rows && k + j < K) ? p[(size_t)row * K + k + j]
                                       : (unsigned short)0;
  *reinterpret_cast<uint4*>(dst) = u.v;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
mm_stats_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                     int M, int N, int K, int ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);   // reuses the stages
  float* red = reinterpret_cast<float*>(
      smem + (kTcStageBytes > kTcCBytes ? kTcStageBytes : kTcCBytes));

  const int ntile = blockIdx.x % ntiles, mtile = blockIdx.x / ntiles;
  const int m0 = mtile * kTcBM, n0 = ntile * kTcBN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;       // 2 x 4 warps

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // K-step kt goes to ring slot kt % kTcStages: each thread moves 2 chunks
  // of 8 bf16 of x and 2 of w
  auto fetch = [&](int kt) {
    __nv_bfloat16* As = stage + (kt % kTcStages) * kTcStageElems;
    __nv_bfloat16* Bs = As + kTcBM * kTcLds;
    const int k0 = kt * kTcBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = threadIdx.x + i * kThreads;
      const int r = ch / (kTcBK / 8), kc = (ch % (kTcBK / 8)) * 8;
      load8<VEC>(As + r * kTcLds + kc, x, m0 + r, M, k0 + kc, K);
      load8<VEC>(Bs + r * kTcLds + kc, w, n0 + r, N, k0 + kc, K);
    }
  };

  // ring of kTcStages slots: kTcStages - 1 steps in flight ahead of the
  // one the tensor cores work on; one commit group per step (empty past
  // the end) keeps the wait count uniform
  const int ktiles = (K + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ktiles) fetch(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();   // step kt landed; every warp is done with kt - 1
    if (kt + kTcStages - 1 < ktiles) fetch(kt + kTcStages - 1);
    cp_async_commit();
    const __nv_bfloat16* As = stage + (kt % kTcStages) * kTcStageElems;
    const __nv_bfloat16* Bs = As + kTcBM * kTcLds;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * kTcLds + kk,
                               kTcLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * kTcLds + kk,
                               kTcLds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the accumulator tile below overlays the ring

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * 64 + i * 16) * kTcLdc + wn * 32 + j * 16, acc[i][j],
          kTcLdc, wmma::mem_row_major);
  __syncthreads();
  if (N % 8 == 0)
    store_y8<kTcBM, kTcBN>(Cs, kTcLdc, y, M, N, m0, n0);
  else
    store_y<__nv_bfloat16, kTcBM, kTcBN>(Cs, kTcLdc, y, M, N, m0, n0);
  column_stats<kTcBM, kTcBN>(Cs, kTcLdc, red, part, M, N, m0, n0, mtile);
}

__global__ void __launch_bounds__(kThreads)
mm_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, float* __restrict__ part, int M,
                    int N, int K, int ntiles) {
  __shared__ float As[kF32BK][kF32BM + 4];   // transposed: As[k][m]
  __shared__ float Bs[kF32BK][kF32BN + 4];   // Bs[k][n]
  __shared__ float Cs[kF32BM * (kF32BN + 1)];
  __shared__ float red[2 * (kThreads / kF32BN) * kF32BN];

  const int ntile = blockIdx.x % ntiles, mtile = blockIdx.x / ntiles;
  const int m0 = mtile * kF32BM, n0 = ntile * kF32BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kF32BK) {
#pragma unroll
    for (int i = 0; i < (kF32BM * kF32BK) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kF32BK, k = e % kF32BK;
      const int gm = m0 + r, gn = n0 + r, gk = k0 + k;
      As[k][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
      Bs[k][r] = (gn < N && gk < K) ? w[(size_t)gn * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Cs[(ty + 16 * i) * (kF32BN + 1) + tx + 16 * j] = acc[i][j];
  __syncthreads();
  store_y<float, kF32BM, kF32BN>(Cs, kF32BN + 1, y, M, N, m0, n0);
  column_stats<kF32BM, kF32BN>(Cs, kF32BN + 1, red, part, M, N, m0, n0,
                               mtile);
}

// in (tiles, 2, N) -> out (ceil(tiles / chunk), 2, N): block (32, 8) over 32
// columns and one chunk of tiles; row group ry sums tiles ry, ry + 8, ...
// of the chunk, then the 8 groups are added in order.
__global__ void reduce_partials_kernel(const float* __restrict__ in,
                                       float* __restrict__ out, int tiles,
                                       int N, int chunk) {
  __shared__ float red[2][kRedRows][33];
  const int cx = threadIdx.x, ry = threadIdx.y;
  const int n = blockIdx.x * 32 + cx;
  const int t0 = blockIdx.y * chunk, t1 = min(tiles, t0 + chunk);
  float a = 0.0f, b = 0.0f;
  if (n < N) {
    for (int t = t0 + ry; t < t1; t += kRedRows) {
      a += in[((size_t)t * 2 + 0) * N + n];
      b += in[((size_t)t * 2 + 1) * N + n];
    }
  }
  red[0][ry][cx] = a;
  red[1][ry][cx] = b;
  __syncthreads();
  if (ry == 0 && n < N) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kRedRows; ++i) {
      s1 += red[0][i][cx];
      s2 += red[1][i][cx];
    }
    out[((size_t)blockIdx.y * 2 + 0) * N + n] = s1;
    out[((size_t)blockIdx.y * 2 + 1) * N + n] = s2;
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA loads, wgmma, a persistent warp-specialised schedule
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;        // two consumer warpgroups of 64 rows
constexpr int kWgBK = 64;         // 64 bf16 = one 128-byte swizzle row
constexpr int kWgThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kWgXBytes = kWgBM * kWgBK * 2;
constexpr int kSmemMax = 232448;  // a block's shared memory on an H100

template <int BN> struct WgCfg;
template <> struct WgCfg<64> { static constexpr int kStages = 8; };
template <> struct WgCfg<128> { static constexpr int kStages = 5; };
template <> struct WgCfg<256> { static constexpr int kStages = 3; };

// Shared memory of one block, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): the ring's stages (x tile,
// then w tile), the y staging tile (per warpgroup BN / 64 swizzled
// 64x64 sub-tiles of 8 KB), the 8 warps' column sums (rows skewed by a
// float every 32 columns: the 8 lane groups of a warp write 32 columns
// apart, into 8 banks), the mbarriers.
template <int BN> struct WgSmem {
  static constexpr int kStages = WgCfg<BN>::kStages;
  static constexpr int kStageBytes = kWgXBytes + BN * kWgBK * 2;
  static constexpr int kStaging = kStages * kStageBytes;
  static constexpr int kRed = kStaging + kWgBM * BN * 2;
  static constexpr int kRedPitch = BN + BN / 32;   // one float skew a 32
  static constexpr int kBar = kRed + 8 * 2 * kRedPitch * 4;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
  static_assert(kBytes <= kSmemMax, "shared memory over the H100's 227 KB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// spin until the phase of parity `parity` has completed; a wait of some
// ten seconds is a fault of the pipeline, and traps rather than hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 34))
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// box at (c0 inner, c1 rows) of `map` into shared memory at dst; the bytes
// complete on mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// four 8x8 bf16 matrices from the mma fragment layout (register i: this
// lane's two elements of matrix i) to shared memory; lane l gives the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.x4.m8n8.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// start address >> 4, leading byte offset 16 B (unused when swizzled),
// stride byte offset 1024 B (8 rows of 128 B), layout 1 = SWIZZLE_128B.
// Adding 2 to it steps 16 bf16 (32 B) along K inside the swizzle atom.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the compiler must not read accumulators across a wgmma wait
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN> struct Wgmma;

template <> struct Wgmma<64> {
  // d (+)= A (64x16, smem) * B (16x64, smem), f32 accumulate
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  // d (+)= A (64x16, smem) * B (16x128, smem), f32 accumulate
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  // d (+)= A (64x16, smem) * B (16x256, smem), f32 accumulate
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// One reduce-scatter step over the lanes that differ in lane bit `mask`:
// the lane with the bit set keeps d[H..2H), its partner d[0..H); each adds
// the partner's copy of what it keeps, into d[0..H).
template <int H, int R>
__device__ __forceinline__ void fold(float (&d)[R], int mask, bool up) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = d[i], hi = d[i + H];
    const float keep = up ? hi : lo, send = up ? lo : hi;
    d[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// The block's column sums of a BN-wide N-tile, taken from the wgmma
// accumulators of the two consumer warpgroups (consumer thread ct, 0..255).
// Each thread keeps its rows' sums in run (after F folds, for registers)
// over the tiles of one N-tile, and flushes them (the remaining folds, the
// 8 warps' combination in warp order, an add to the block's row of part)
// when the N-tile changes and at the end. Column sum e = stat * BN + c goes
// to part by the thread with e % 256 == ct, which zeroes its entries
// first. red: 8 warps x 2 rows of kPitch floats in shared memory.
template <int BN, int F> struct ColumnSums {
  static constexpr int Q = BN / 2;                // accumulators a thread holds
  static constexpr int E = (2 * BN + 255) / 256;  // column sums a thread owns
  static constexpr int R = Q >> F;                // running sums a thread holds
  static constexpr int kPitch = BN + BN / 32;     // one float skew a 32
  float run[R];
  float* red;
  float* prow;
  int N, ct, warp, lane, held_nt;

  __device__ __forceinline__ ColumnSums(float* red_, float* prow_, int n,
                                        int tiles_n, int ct_)
      : red(red_), prow(prow_), N(n), ct(ct_), warp(ct_ / 32),
        lane(ct_ % 32), held_nt(-1) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = ct + 256 * k;
      if (e >= 2 * BN) continue;
      for (int nt = 0; nt < tiles_n; ++nt) {
        const int c = nt * BN + e % BN;
        if (c < N) prow[(e / BN) * N + c] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) run[i] = 0.0f;
  }

  __device__ __forceinline__ void flush(int nt) {
    if constexpr (F < 1) fold<Q / 2>(run, 16, lane & 16);
    if constexpr (F < 2) fold<Q / 4>(run, 8, lane & 8);
    if constexpr (F < 3) fold<Q / 8>(run, 4, lane & 4);
    // run[i] now holds register (lane / 4) * Q / 8 + i's sum
#pragma unroll
    for (int i = 0; i < Q / 8; ++i) {
      const int p = (lane / 4) * (Q / 8) + i;
      const int c = 8 * (p / 4) + 2 * (lane % 4) + (p & 1);
      red[(warp * 2 + ((p >> 1) & 1)) * kPitch + c + c / 32] = run[i];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) run[i] = 0.0f;
    named_sync(3, 256);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = ct + 256 * k;
      if (e < 2 * BN) {
        const int stat = e / BN, c = e % BN, n = nt * BN + c;
        float v = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < 8; ++w8)
          v += red[(w8 * 2 + stat) * kPitch + c + c / 32];
        if (n < N) prow[stat * N + n] += v;
      }
    }
    named_sync(3, 256);   // red is rewritten by the next flush
  }

  // a tile of N-tile nt: the thread's two rows, in place (d[4j + e] <- s1,
  // d[4j + 2 + e] <- s2), folded F times, added to run
  __device__ __forceinline__ void add(float (&d)[Q], int nt) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = d[4 * j + e], b = d[4 * j + 2 + e];
        d[4 * j + e] = a + b;
        d[4 * j + 2 + e] = fmaf(a, a, b * b);
      }
    }
    if constexpr (F >= 1) fold<Q / 2>(d, 16, lane & 16);
    if constexpr (F >= 2) fold<Q / 4>(d, 8, lane & 8);
    if constexpr (F >= 3) fold<Q / 8>(d, 4, lane & 4);
    if (nt != held_nt) {
      if (held_nt >= 0) flush(held_nt);
      held_nt = nt;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) run[i] += d[i];
  }

  __device__ __forceinline__ void finish() {
    if (held_nt >= 0) flush(held_nt);
  }
};

// Persistent: block b takes tiles b, b + grid, ...; tile t is M-tile
// t / tiles_n, N-tile t % tiles_n. part (grid, 2, N) receives the block's
// column sums. Warpgroup 0 produces (one thread issues the TMA loads),
// warpgroups 1 and 2 multiply rows 0-63 and 64-127 of each tile.
//
// The wgmma accumulator of a m64nBN tile: lane l of warp w (of 4) holds,
// for each 8-column block j, d[4j + e] at row 16w + l/4 and d[4j + 2 + e]
// at row 16w + l/4 + 8, column 8j + 2(l % 4) + e, e in {0, 1}. Lanes that
// share l % 4 share columns.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
mm_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmw,
                      const __grid_constant__ CUtensorMap tmy,
                      float* __restrict__ part, int M, int N, int K,
                      int tiles_n, int tiles) {
  using L = WgSmem<BN>;
  constexpr int S = L::kStages;
  using Sums = ColumnSums<BN, (BN > 128 ? 2 : 0)>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L::kBar, empty0 = full0 + 8 * S;
  const int ktiles = (K + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);     // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 2);    // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: stage s of K-step `it` (counted across tiles) is free once
    // the consumers released round it / S - 1 of it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kWgBM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t xs = base + s * L::kStageBytes;
          mbar_expect_tx(full, L::kStageBytes);
          tma_load(xs, &tmx, full, kt * kWgBK, m0);
          tma_load(xs + kWgXBytes, &tmw, full, kt * kWgBK, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1;                        // rows 64g.. of each tile
  const int ct = threadIdx.x - 128;            // 0..255
  const int warp = ct / 32;                    // 0..7: the sums' order
  const int lane = threadIdx.x % 32;
  const bool leader = (ct % 128) == 0;         // issues stores, arrives
  const uint32_t staging = base + L::kStaging + g * (64 * BN * 2);
  // stmatrix: lane l addresses row l % 8 of 8x8 matrix l / 8 (rows 0-7 or
  // 8-15 of the warp's 16, of column block j or j + 1)
  const int srow = (warp % 4) * 16 + ((lane / 8) & 1) * 8 + lane % 8;
  const int scol = lane / 16;
  Sums sums(reinterpret_cast<float*>(smem + L::kRed),
            part + (size_t)blockIdx.x * 2 * N, N, tiles_n, ct);

  float d[Sums::Q];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % tiles_n;
    const int m0 = (tile / tiles_n) * kWgBM, n0 = nt * BN;
    // main loop: one wgmma group in flight; a stage is released once the
    // group that read it has completed
    int prev = 0;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      const uint32_t xs = base + s * L::kStageBytes;
      const uint64_t da = wg_desc(xs + g * 64 * 128);
      const uint64_t db = wg_desc(xs + kWgXBytes);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        Wgmma<BN>::mma(d, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      wg_commit();
      wg_wait<1>();
      if (kt > 0 && leader) mbar_arrive(empty0 + 8 * prev);
      prev = s;
    }
    wg_wait<0>();
    fence_regs(d);
    if (leader) mbar_arrive(empty0 + 8 * prev);

    // y: bf16 into the swizzled staging tile by stmatrix (four 8x8
    // matrices a warp instruction) once the warpgroup's previous store
    // has read it, then one TMA store per 64-column sub-tile
    if (leader) bulk_wait_read();
    named_sync(1 + g, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      const int cb = j + scol;
      stmatrix_x4(staging + (cb / 8) * 8192 + srow * 128 +
                      (((cb % 8) ^ (lane % 8)) << 4),
                  pack_bf16(d[4 * j], d[4 * j + 1]),
                  pack_bf16(d[4 * j + 2], d[4 * j + 3]),
                  pack_bf16(d[4 * j + 4], d[4 * j + 5]),
                  pack_bf16(d[4 * j + 6], d[4 * j + 7]));
    }
    fence_proxy_async();
    named_sync(1 + g, 128);
    if (leader) {
      const int r0 = m0 + 64 * g;
      if (r0 < M) {
#pragma unroll
        for (int st = 0; st < BN / 64; ++st)
          if (n0 + 64 * st < N)
            tma_store(&tmy, staging + st * 8192, n0 + 64 * st, r0);
      }
      bulk_commit();
    }
    sums.add(d, nt);
  }
  sums.finish();
  if (leader) bulk_wait();   // the staging tile outlives its last store
}

// ---------------------------------------------------------------------------
// float32 on Hopper: 3xTF32 on wgmma, on the wgmma route's schedule
// ---------------------------------------------------------------------------

constexpr int kTfBK = 32;                      // 32 f32 = one 128-byte row
constexpr int kTfXBytes = kWgBM * kTfBK * 4;   // the x tile of a stage

template <int BN> struct Tf32Cfg;
template <> struct Tf32Cfg<64> { static constexpr int kStages = 5; };
template <> struct Tf32Cfg<128> { static constexpr int kStages = 3; };

// Shared memory of one tf32x3 block, from a 1024-byte aligned base: the
// ring's stages (x tile 128x32, then w_big and w_small tiles BNx32, f32),
// the f32 y staging tile (per warpgroup BN / 32 swizzled 64x32 sub-tiles
// of 8 KB), the 8 warps' column sums, the mbarriers.
template <int BN> struct TfSmem {
  static constexpr int kStages = Tf32Cfg<BN>::kStages;
  static constexpr int kWBytes = BN * kTfBK * 4;
  static constexpr int kStageBytes = kTfXBytes + 2 * kWBytes;
  static constexpr int kStaging = kStages * kStageBytes;
  static constexpr int kRed = kStaging + kWgBM * BN * 4;
  static constexpr int kBar = kRed + 8 * 2 * (BN + BN / 32) * 4;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
  static_assert(kBytes <= kSmemMax, "shared memory over the H100's 227 KB");
};

// a rounded to TF32 (10 mantissa bits, the low 13 bits zero), nearest,
// ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = big + small + O(2^-22 |a|): big = tf32(a); a - big is exact in f32
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(a);
  small = to_tf32(a - __uint_as_float(big));
}

template <int BN> struct WgmmaTf32;

template <> struct WgmmaTf32<64> {
  // d += A (64x8 tf32, registers) * B (8x64 tf32, smem), f32 accumulate
  __device__ static __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <> struct WgmmaTf32<128> {
  // d += A (64x8 tf32, registers) * B (8x128 tf32, smem), f32 accumulate
  __device__ static __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

// w (N, K) f32 -> its two TF32 terms, w_big then w_small (each N x K):
// n4 float4s of w, grid-stride
__global__ void split_tf32_kernel(const float4* __restrict__ w,
                                  float4* __restrict__ big,
                                  float4* __restrict__ small, int n4) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    const float4 v = w[i];
    uint32_t b[4], s[4];
    split_tf32(v.x, b[0], s[0]);
    split_tf32(v.y, b[1], s[1]);
    split_tf32(v.z, b[2], s[2]);
    split_tf32(v.w, b[3], s[3]);
    big[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                         __uint_as_float(b[2]), __uint_as_float(b[3]));
    small[i] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                           __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

// The wgmma kernel's schedule and statistics on float32 x (M, K) and the
// split weight: per K-step of 8, d += x_small w_big + x_big w_small +
// x_big w_big, three wgmma.mma_async m64nBNk8 .tf32 into one f32
// accumulator. x is split in registers: A comes from registers, in the
// fragment layout of a 64x8 tf32 tile (lane l of warp w holds a0 at row
// 16w + l/4, column l % 4; a1 eight rows below; a2, a3 four columns to the
// right of a0, a1), read from the 128-byte-swizzled stage by hand (16-byte
// chunk c of row r lies at chunk c ^ (r % 8): ldmatrix is b16 only). B,
// w_big and w_small, comes from shared memory by descriptor, K-major.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
mm_stats_tf32x3_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmwb,
                       const __grid_constant__ CUtensorMap tmws,
                       const __grid_constant__ CUtensorMap tmy,
                       float* __restrict__ part, int M, int N, int K,
                       int tiles_n, int tiles) {
  using L = TfSmem<BN>;
  constexpr int S = L::kStages;
  using Sums = ColumnSums<BN, (BN > 64 ? 1 : 0)>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L::kBar, empty0 = full0 + 8 * S;
  const int ktiles = (K + kTfBK - 1) / kTfBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kWgBM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t xs = base + s * L::kStageBytes;
          mbar_expect_tx(full, L::kStageBytes);
          tma_load(xs, &tmx, full, kt * kTfBK, m0);
          tma_load(xs + kTfXBytes, &tmwb, full, kt * kTfBK, n0);
          tma_load(xs + kTfXBytes + L::kWBytes, &tmws, full, kt * kTfBK, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1;
  const int ct = threadIdx.x - 128;
  const int warp = ct / 32;
  const int lane = threadIdx.x % 32;
  const bool leader = (ct % 128) == 0;
  const uint32_t staging = base + L::kStaging + g * (64 * BN * 4);
  // the thread's rows of the warpgroup's 64: srow and srow + 8 (srow % 8
  // is lane / 4, the swizzle of both); of the stage's x tile, 64g more
  const int srow = (warp % 4) * 16 + lane / 4;
  const uint32_t arow = (64 * g + srow) * 128 + 4 * (lane % 4);
  const int sw = lane / 4;
  Sums sums(reinterpret_cast<float*>(smem + L::kRed),
            part + (size_t)blockIdx.x * 2 * N, N, tiles_n, ct);

  float d[Sums::Q];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % tiles_n;
    const int m0 = (tile / tiles_n) * kWgBM, n0 = nt * BN;
    // main loop: a stage's group completes before the next stage's A is
    // written (a loop writes the same registers on every K-step, and a
    // wgmma reads its A registers until it completes); the other
    // warpgroup's group keeps the tensor cores busy meanwhile
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      const uint32_t xs = base + s * L::kStageBytes;
      // A of the stage's 4 K-steps: columns 8kk + l % 4 (chunk 2kk) and
      // 8kk + 4 + l % 4 (chunk 2kk + 1), rows srow and srow + 8
      uint32_t ab[kTfBK / 8][4], as[kTfBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kTfBK / 8; ++kk) {
        const uint32_t p0 = xs + arow + (((2 * kk) ^ sw) << 4);
        const uint32_t p1 = xs + arow + (((2 * kk + 1) ^ sw) << 4);
        split_tf32(lds_f32(p0), ab[kk][0], as[kk][0]);
        split_tf32(lds_f32(p0 + 1024), ab[kk][1], as[kk][1]);
        split_tf32(lds_f32(p1), ab[kk][2], as[kk][2]);
        split_tf32(lds_f32(p1 + 1024), ab[kk][3], as[kk][3]);
      }
      const uint64_t db = wg_desc(xs + kTfXBytes);
      const uint64_t ds = wg_desc(xs + kTfXBytes + L::kWBytes);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTfBK / 8; ++kk) {
        WgmmaTf32<BN>::mma(d, as[kk], db + 2 * kk, (kt | kk) != 0);
        WgmmaTf32<BN>::mma(d, ab[kk], ds + 2 * kk, 1);
        WgmmaTf32<BN>::mma(d, ab[kk], db + 2 * kk, 1);
      }
      wg_commit();
      wg_wait<0>();
      if (leader) mbar_arrive(empty0 + 8 * s);
    }
    fence_regs(d);

    // y: f32 pairs into the swizzled staging tile by st.shared.v2 (column
    // 8j + 2(l % 4) is byte 32(j % 4) + 8(l % 4) of 32-column sub-tile
    // j / 4), then one TMA store per sub-tile
    if (leader) bulk_wait_read();
    named_sync(1 + g, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int chunk = 2 * (j % 4) + (lane % 4) / 2;
      const uint32_t a = staging + (j / 4) * 8192 + srow * 128 +
                         ((chunk ^ sw) << 4) + 8 * (lane % 2);
      sts_v2(a, d[4 * j], d[4 * j + 1]);
      sts_v2(a + 1024, d[4 * j + 2], d[4 * j + 3]);
    }
    fence_proxy_async();
    named_sync(1 + g, 128);
    if (leader) {
      const int r0 = m0 + 64 * g;
      if (r0 < M) {
#pragma unroll
        for (int st = 0; st < BN / 32; ++st)
          if (n0 + 32 * st < N)
            tma_store(&tmy, staging + st * 8192, n0 + 32 * st, r0);
      }
      bulk_commit();
    }
    sums.add(d, nt);
  }
  sums.finish();
  if (leader) bulk_wait();
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Errors of the driver API (tensor-map encoding) are returned as
// kDriverErr + CUresult, beside the runtime's cudaError_t codes.
constexpr int kDriverErr = 1 << 20;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
typedef CUresult (*GetErrorStringFn)(CUresult, const char**);

// a driver API function through the runtime (no -lcuda)
void* driver_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e =
      cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q);
#endif
  return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? fn : nullptr;
}

// 2-D tensor map of a row-major (rows, inner) array of bf16 (elem 2) or
// f32 (elem 4), 128-byte swizzle, box (box_rows, box_inner); out-of-bounds
// elements read as zero and are not written
int encode_map(CUtensorMap* map, const void* ptr, int elem_bytes, int inner,
               int rows, int box_inner, int box_rows) {
  static EncodeTiledFn fn = (EncodeTiledFn)driver_fn("cuTensorMapEncodeTiled");
  if (fn == nullptr) return kDriverErr + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map,
                        elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kDriverErr + (int)r;
}

// The opt-in above 48 KB of dynamic shared memory holds per function and
// device: set once for each of the first 64 devices (one `opted` per
// kernel). Then the persistent grid: min(part_rows, tiles) blocks.
template <typename Kernel>
int persistent_grid(Kernel kernel, int smem_bytes, bool (&opted)[64],
                    int tiles, int part_rows, int* grid) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= 64 || !opted[device]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    if (device < 64) opted[device] = true;
  }
  *grid = tiles < part_rows ? tiles : part_rows;
  return *grid < 1 ? (int)cudaErrorInvalidValue : 0;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, void* y, float* part,
                 int part_rows, int M, int N, int K, int* grid,
                 cudaStream_t s) {
  CUtensorMap tmx, tmw, tmy;
  int err = encode_map(&tmx, x, 2, K, M, kWgBK, kWgBM);
  if (!err) err = encode_map(&tmw, w, 2, K, N, kWgBK, BN);
  if (!err) err = encode_map(&tmy, y, 2, N, M, 64, 64);
  if (err) return err;
  static bool opted[64] = {};
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + kWgBM - 1) / kWgBM * tiles_n;
  err = persistent_grid(mm_stats_wgmma_kernel<BN>, WgSmem<BN>::kBytes, opted,
                        tiles, part_rows, grid);
  if (err) return err;
  mm_stats_wgmma_kernel<BN><<<*grid, kWgThreads, WgSmem<BN>::kBytes, s>>>(
      tmx, tmw, tmy, part, M, N, K, tiles_n, tiles);
  return (int)cudaGetLastError();
}

// wsplit (2, N, K) receives w's TF32 terms, then the tf32x3 kernel
template <int BN>
int launch_tf32x3(const float* x, const float* w, float* wsplit, float* y,
                  float* part, int part_rows, int M, int N, int K, int* grid,
                  cudaStream_t s) {
  const int n4 = (int)((long long)N * K / 4);
  split_tf32_kernel<<<std::min(ceil_div(n4, 256), 1056), 256, 0, s>>>(
      reinterpret_cast<const float4*>(w), reinterpret_cast<float4*>(wsplit),
      reinterpret_cast<float4*>(wsplit + (size_t)N * K), n4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tmx, tmwb, tmws, tmy;
  int err = encode_map(&tmx, x, 4, K, M, kTfBK, kWgBM);
  if (!err) err = encode_map(&tmwb, wsplit, 4, K, N, kTfBK, BN);
  if (!err) err = encode_map(&tmws, wsplit + (size_t)N * K, 4, K, N, kTfBK, BN);
  if (!err) err = encode_map(&tmy, y, 4, N, M, 32, 64);
  if (err) return err;
  static bool opted[64] = {};
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + kWgBM - 1) / kWgBM * tiles_n;
  err = persistent_grid(mm_stats_tf32x3_kernel<BN>, TfSmem<BN>::kBytes, opted,
                        tiles, part_rows, grid);
  if (err) return err;
  mm_stats_tf32x3_kernel<BN><<<*grid, kWgThreads, TfSmem<BN>::kBytes, s>>>(
      tmx, tmwb, tmws, tmy, part, M, N, K, tiles_n, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of x per block for dtype (0 float32, 1 bfloat16): the partial
// buffer holds ceil(M / this) tiles.
int matmul_stats_block_m(int dtype) { return dtype == 1 ? kTcBM : kF32BM; }

// Tiles summed per block in the first reduction pass: the scratch holds
// ceil(tiles_m / this) tiles when tiles_m exceeds it.
int matmul_stats_reduce_chunk() { return kRedChunk; }

// x (M, K) and w (N, K) row-major, both float32 (dtype 0) or bfloat16
// (dtype 1); y (M, N) of the same dtype; part (tiles_m, 2, N) f32;
// scratch (ceil(tiles_m / chunk), 2, N) f32, used when tiles_m > chunk;
// stats (2, N) f32 receives [s1; s2]. vec != 0 promises K % 8 == 0 and
// 16-byte aligned x and w (bfloat16 only). All on `device`, contiguous.
// Returns a cudaError_t (0 on success).
int matmul_stats(const void* x, const void* w, void* y, float* part,
                 float* scratch, float* stats, int M, int N, int K, int dtype,
                 int vec, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  int tiles;
  if (dtype == 1) {
    const int nt = ceil_div(N, kTcBN);
    tiles = ceil_div(M, kTcBM);
    // more than 48 KB of dynamic shared memory needs the opt-in; the
    // attribute is per function and per device, so it is set every call
    auto kernel = vec ? mm_stats_bf16_kernel<true>
                      : mm_stats_bf16_kernel<false>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kTcSmem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<tiles * nt, kThreads, kTcSmem, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
        part, M, N, K, nt);
  } else if (dtype == 0) {
    const int nt = ceil_div(N, kF32BN);
    tiles = ceil_div(M, kF32BM);
    mm_stats_f32_kernel<<<tiles * nt, kThreads, 0, s>>>(
        (const float*)x, (const float*)w, (float*)y, part, M, N, K, nt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 block(32, kRedRows);
  const float* in = part;
  if (tiles > kRedChunk) {
    const int chunks = ceil_div(tiles, kRedChunk);
    reduce_partials_kernel<<<dim3(ceil_div(N, 32), chunks), block, 0, s>>>(
        part, scratch, tiles, N, kRedChunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    in = scratch;
    tiles = chunks;
  }
  reduce_partials_kernel<<<dim3(ceil_div(N, 32), 1), block, 0, s>>>(
      in, stats, tiles, N, tiles);
  return (int)cudaGetLastError();
}

// Streaming multiprocessors of `device`: the persistent grid's size.
int matmul_stats_sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return n;
}

// The wgmma route. x (M, K), w (N, K), y (M, N) bfloat16, row-major,
// 16-byte aligned, K % 8 == 0 and N % 8 == 0 (TMA's 16-byte strides);
// bn the N-tile width (64, 128 or 256); part f32 scratch of part_rows
// rows of 2 N: the persistent grid takes min(part_rows, tiles) blocks, one
// row each (part_rows is the SM count for one block an SM); stats (2, N)
// f32 receives [s1; s2]. Returns 0, a cudaError_t, or kDriverErr +
// CUresult when a tensor map cannot be encoded.
int matmul_stats_wgmma(const void* x, const void* w, void* y, float* part,
                       float* stats, int M, int N, int K, int bn,
                       int part_rows, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  int err, grid = 0;
  if (bn == 64)
    err = launch_wgmma<64>(x, w, y, part, part_rows, M, N, K, &grid, s);
  else if (bn == 128)
    err = launch_wgmma<128>(x, w, y, part, part_rows, M, N, K, &grid, s);
  else if (bn == 256)
    err = launch_wgmma<256>(x, w, y, part, part_rows, M, N, K, &grid, s);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  reduce_partials_kernel<<<dim3(ceil_div(N, 32), 1), dim3(32, kRedRows), 0,
                           s>>>(part, stats, grid, N, grid);
  return (int)cudaGetLastError();
}

// The tf32x3 route. x (M, K), w (N, K), y (M, N) float32, row-major,
// 16-byte aligned, K % 4 == 0 and N % 4 == 0 (TMA's 16-byte strides);
// wsplit (2, N, K) float32 scratch for w's TF32 terms; bn the N-tile width
// (64 or 128); part and stats as for matmul_stats_wgmma. Returns 0, a
// cudaError_t, or kDriverErr + CUresult.
int matmul_stats_tf32x3(const void* x, const void* w, void* wsplit, void* y,
                        float* part, float* stats, int M, int N, int K,
                        int bn, int part_rows, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  int err, grid = 0;
  const float *xf = (const float*)x, *wf = (const float*)w;
  if (bn == 64)
    err = launch_tf32x3<64>(xf, wf, (float*)wsplit, (float*)y, part,
                            part_rows, M, N, K, &grid, s);
  else if (bn == 128)
    err = launch_tf32x3<128>(xf, wf, (float*)wsplit, (float*)y, part,
                             part_rows, M, N, K, &grid, s);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  reduce_partials_kernel<<<dim3(ceil_div(N, 32), 1), dim3(32, kRedRows), 0,
                           s>>>(part, stats, grid, N, grid);
  return (int)cudaGetLastError();
}

const char* matmul_stats_error_string(int err) {
  if (err < kDriverErr) return cudaGetErrorString((cudaError_t)err);
  static GetErrorStringFn fn = (GetErrorStringFn)driver_fn("cuGetErrorString");
  const char* msg = nullptr;
  if (fn == nullptr || fn((CUresult)(err - kDriverErr), &msg) != CUDA_SUCCESS ||
      msg == nullptr)
    return "cuTensorMapEncodeTiled failed (CUresult unknown)";
  return msg;
}

}  // extern "C"
