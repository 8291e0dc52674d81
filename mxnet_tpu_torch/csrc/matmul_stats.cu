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
// What bounds it on an H100. At ResNet-50's shapes (batch 128, 224x224)
// the 33 launches of a step move 3.97 GB and do 463.7 GFLOP: by the data
// sheet (3.35 TB/s, 989 TFLOP/s bf16) the wide-M, narrow-K layers of
// stages 1-2 are bound by bytes and the K >= 1024 layers of stages 3-4 by
// operations. The TPU kernel's point was to keep the statistics pass from
// re-reading y from device memory; here too they come out of the tile
// while it sits in shared memory.
//
// Design (a simple kernel that is right; wgmma, TMA and a persistent
// schedule are later work):
//   bf16: 128x128 output tile per block of 8 warps, each warp 64x32 as
//         4x2 nvcuda::wmma 16x16x16 bf16 fragments (mma.sync, f32
//         accumulate). K runs in steps of 32 through a ring of three
//         shared-memory stages filled by cp.async, so two steps' loads are
//         in flight while the tensor cores work on a third. Two blocks fit
//         on an SM (at most 128 registers a thread, 68 KB of shared memory
//         each), so one block's epilogue overlaps the other's loads.
//         Copies are 16-byte cp.async when K % 8 == 0 and the pointers are
//         16-byte aligned, else element by element; ragged edges are
//         zero-filled, so any M, N, K works. y leaves in 16-byte stores
//         when N % 8 == 0.
//   f32:  64x64 tile, 256 threads with 4x4 outputs each, FP32 FMA (no
//         TF32: the result must match a full-precision f32 product).
//   Epilogue (both): the f32 accumulator tile goes to shared memory; y is
//         written from there, and each column's sum and sum of squares over
//         the tile's rows are reduced in a fixed order into a per-M-tile
//         partial buffer (tiles_m, 2, N).
//   reduce_partials: sums the partials over M-tiles in a fixed order (a
//         chunked first pass when there are many tiles, then a final one),
//         into stats (2, N) = [s1; s2]. No float atomics anywhere, so two
//         runs give bitwise identical statistics.
//
// The entry points launch on the caller's stream, do not synchronise and
// allocate nothing; each returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

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

const char* matmul_stats_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
