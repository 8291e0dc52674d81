// Greedy class-aware NMS survival mask over score-sorted boxes (Hopper,
// sm_90a), the sweep inside MultiBoxDetection.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas_multibox.py:_nms_kernel
// (entry nms_alive). For each image b, over k boxes sorted by score:
//   iou(i, j)  as ops/contrib.py:_iou computes it (0 where union <= 0)
//   sup[i, j]  = iou(i, j) > thresh && (cls[i] == cls[j] || force)
//   alive      starts as score > 0; for i = 0..k-1 in order, a live i kills
//              every later j with sup[i, j]
//   out[b, j]  = 1.0f if j survives, else 0.0f
//
// What bounds it on an H100. The work is tiny: about 24*B*k bytes in
// (boxes, score, class), 4*B*k bytes out, and ~15*k*k/2 flops per image
// (at the H100 data sheet's 3.35 TB/s and 67 TFLOP/s FP32: about 0.1 us of
// memory traffic and 0.6 us of FP32 work at B=32, k=400).
// What limits it is the sweep's k-step dependent chain: whether row i
// suppresses anything depends on every earlier row.
//
// Design. The TPU kernel kept the whole (k, k) f32 IoU matrix in VMEM; at
// k = 400 that is 640 KB, more than a block's 227 KB of shared memory, and
// the sweep must work for any k (nms_topk = -1 gives k = all anchors). So
// the matrix is kept as bits:
//   1. nms_mask_kernel, grid (B, k/64, k/64), 64 threads: each thread
//      computes one 64-bit word of row i, the bits j > i in one 64-column
//      tile with sup[i, j]. The column tile's boxes sit in shared memory.
//      The words go to a scratch of B*k*ceil(k/64)*8 bytes (717 KB at
//      B=32, k=400), which stays in L2.
//   2. nms_sweep_kernel, one block per image: the alive set is ceil(k/64)
//      words in shared memory. Rows are taken one 64-row word W at a time.
//      One thread resolves the rows inside W in order (the chain, on
//      registers only; its row words are loaded 16 at a time ahead of use).
//      Then the rows of W that stay alive are final, and every thread
//      clears their suppressed bits from its own later words at once. So
//      the serial part is k register steps plus two barriers per 64 rows,
//      not k trips through memory.
// The IoU is computed in _iou's order with explicitly rounded operations
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn): no FMA contraction, so the
// mask equals the plain PyTorch version bit for bit, also near the
// threshold. thresh arrives already rounded to f32, as JAX compares.
//
// The entry point launches on the caller's stream, does not synchronise and
// allocates nothing; it returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // boxes per tile = bits per mask word
constexpr int kChunk = 16;      // row words loaded ahead in the sweep

typedef unsigned long long u64;

__device__ __forceinline__ float area_rn(float4 q) {
  return fmaxf(__fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y)), 0.0f);
}

__device__ __forceinline__ float iou_rn(float4 a, float area_a, float4 b,
                                        float area_b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, const float* __restrict__ cls,
                u64* __restrict__ mask, int k, int nwords, float thresh,
                int force) {
  const int b = blockIdx.x;
  const int rb = blockIdx.y;
  const int cb = blockIdx.z;
  const int i = rb * kTile + threadIdx.x;
  const float4* bb = boxes + (size_t)b * k;
  const float* cc = cls + (size_t)b * k;
  u64* row = mask + ((size_t)b * k + i) * nwords;
  if (cb < rb) {                // every column of this tile precedes row i
    if (i < k) row[cb] = 0ull;
    return;
  }
  __shared__ float4 sbox[kTile];
  __shared__ float sarea[kTile];
  __shared__ float scls[kTile];
  const int j0 = cb * kTile;
  const int ncols = min(kTile, k - j0);
  if (threadIdx.x < ncols) {
    const float4 q = bb[j0 + threadIdx.x];
    sbox[threadIdx.x] = q;
    sarea[threadIdx.x] = area_rn(q);
    scls[threadIdx.x] = cc[j0 + threadIdx.x];
  }
  __syncthreads();
  if (i >= k) return;
  const float4 a = bb[i];
  const float area_a = area_rn(a);
  const float ca = cc[i];
  u64 word = 0ull;
  for (int c = 0; c < ncols; ++c) {
    if (j0 + c <= i) continue;
    if ((force || ca == scls[c]) &&
        iou_rn(a, area_a, sbox[c], sarea[c]) > thresh)
      word |= 1ull << c;
  }
  row[cb] = word;
}

__global__ void __launch_bounds__(256)
nms_sweep_kernel(const u64* __restrict__ mask, const float* __restrict__ score,
                 float* __restrict__ out, int k, int nwords) {
  extern __shared__ u64 alive[];
  const int b = blockIdx.x;
  const u64* mb = mask + (size_t)b * k * nwords;
  const float* sb = score + (size_t)b * k;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
    const int j0 = w * kTile;
    const int n = min(kTile, k - j0);
    u64 word = 0ull;
    for (int c = 0; c < n; ++c)
      if (sb[j0 + c] > 0.0f) word |= 1ull << c;
    alive[w] = word;
  }
  __syncthreads();
  for (int W = 0; W < nwords; ++W) {
    const int i0 = W * kTile;
    if (threadIdx.x == 0) {
      // the chain: rows of word W in order, each suppressing later bits of
      // W only while it is itself alive
      const int n = min(kTile, k - i0);
      u64 a = alive[W];
      for (int r0 = 0; r0 < n; r0 += kChunk) {
        u64 m[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          m[q] = (r0 + q < n) ? mb[(size_t)(i0 + r0 + q) * nwords + W] : 0ull;
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          if ((a >> (r0 + q)) & 1ull) a &= ~m[q];
      }
      alive[W] = a;
    }
    __syncthreads();
    // the rows of W still alive are final: clear what they suppress in
    // every later word, one word per thread
    const u64 live = alive[W];
    if (live) {
      for (int w = W + 1 + threadIdx.x; w < nwords; w += blockDim.x) {
        u64 kill = 0ull;
        for (int r0 = 0; r0 < kTile; r0 += kChunk) {
          u64 v[kChunk];
#pragma unroll
          for (int q = 0; q < kChunk; ++q)
            v[q] = ((live >> (r0 + q)) & 1ull)
                       ? mb[(size_t)(i0 + r0 + q) * nwords + w] : 0ull;
#pragma unroll
          for (int q = 0; q < kChunk; ++q) kill |= v[q];
        }
        alive[w] &= ~kill;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    out[(size_t)b * k + j] = ((alive[j / kTile] >> (j % kTile)) & 1ull)
                                 ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

// boxes (batch, k, 4) f32 corners, 16-byte aligned; score, cls (batch, k)
// f32; mask scratch of batch*k*ceil(k/64) u64; out (batch, k) f32. All on
// `device`, all contiguous. Returns a cudaError_t (0 on success).
int multibox_nms_alive(const float* boxes, const float* score,
                       const float* cls, u64* mask, float* out, int batch,
                       int k, float thresh, int force, int device,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const int nwords = (k + kTile - 1) / kTile;
  nms_mask_kernel<<<dim3(batch, nwords, nwords), kTile, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), cls, mask, k, nwords, thresh,
      force);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int threads = ((nwords + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  nms_sweep_kernel<<<batch, threads, nwords * sizeof(u64), s>>>(
      mask, score, out, k, nwords);
  return (int)cudaGetLastError();
}

const char* multibox_nms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
