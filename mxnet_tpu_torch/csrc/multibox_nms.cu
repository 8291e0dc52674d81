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
// suppresses anything depends on every earlier row. So the design keeps
// every step of that chain close to the SM that walks it.
//
// The suppression relation is kept as bits: row i is ceil(k/64) 64-bit
// words, bit j of word w set when sup[i, 64w + j] and 64w + j > i (only the
// upper triangle, words w >= i/64, is ever read). The TPU kernel kept the
// (k, k) f32 IoU matrix in VMEM, 640 KB at k = 400, beyond a block's 227 KB
// of shared memory; as bits it is 22 KB. Two routes, chosen by the wrapper
// (ops/multibox_nms.py kernel_route) from k:
//
// Route "smem", one launch (nms_cluster_kernel), while the image's boxes,
// the mask and the alive words fit one block's shared memory (k <= 1250;
// the wrapper's smem_bytes gives the layout's size):
//   A thread-block cluster of C blocks per image (C = 1..8, picked by the
//   wrapper so that B*C is near the SM count). Every block stages the
//   image's boxes, areas and classes in its shared memory.
//   The mask: tasks of 32 rows x one 64-column word of the upper triangle
//   are dealt to the cluster's warps in turn; lane l forms row l's word on
//   its own over the 64 column boxes (read at one address for the warp),
//   with no branch and no warp operation in the loop, so that the columns
//   overlap: the IoU's intersection and union with explicitly rounded
//   operations, then q = inter * rcp.approx(uni) against the threshold
//   (iou_gt_fast: the answer is exact wherever q is more than 2^-18 of
//   the threshold away from it, and the rare pairs nearer it are redone
//   with the correctly rounded division). An image with a degenerate or
//   huge box takes the correctly rounded division for every pair. Each
//   word is stored straight into the leader block's (rank 0) shared
//   memory through distributed shared memory, word-major (word w of row i
//   at w * kp + i), so that the sweep reads a word's rows consecutively.
//   Distributed shared memory may be touched only once every block of the
//   cluster runs: each block arrives at a cluster barrier (relaxed) on
//   entry and waits on it after staging, before its first remote store.
//   The leader meanwhile takes the alive words from score > 0, 32 scores a
//   __ballot_sync. cluster.sync(); the other blocks exit (nothing reads
//   their shared memory), and one warp of the leader sweeps from its own
//   shared memory, word by word: what the kept rows of earlier words
//   suppress in word W (lane l takes rows l and l + 32 of each, two
//   __reduce_or_sync fold the lanes), then W's own chain. Rows of W that
//   suppress nothing in W cannot change it: when at most 12 alive rows
//   act, the warp visits just those in order; otherwise it walks all 64
//   on registers, two predicated instructions a row.
//   So the serial part is at most k register steps, all in the leader's
//   SM, with no scratch and no second launch.
// Route "l2", for larger k (nms_topk = -1 gives k = all anchors): two
// launches through a mask scratch of B*k*ceil(k/64)*8 bytes, which stays in
// L2.
//   1. nms_mask_kernel, grid (B, k/64, k/64), 64 threads: each thread
//      computes one word of row i for one 64-column tile whose boxes sit in
//      shared memory, with the correctly rounded division.
//   2. nms_sweep_kernel, one block per image: the alive words in shared
//      memory (by ballot), then per 64-row word one thread walks the chain
//      (its row words loaded 16 at a time ahead of use) and every thread
//      clears the suppressed bits from its own later words.
// The IoU is computed in _iou's order with explicitly rounded operations
// (__fsub_rn, __fmul_rn, __fadd_rn, and __fdiv_rn wherever the fast test
// is not sure): no FMA contraction, so the mask equals the plain PyTorch
// version bit for bit on both routes, also at and near the threshold.
// thresh arrives already rounded to f32, as JAX compares.
//
// Each entry point launches on the caller's stream, does not synchronise
// and allocates nothing; it returns the launch's cudaError_t (a cluster
// launch the card refuses is returned as such, never retried elsewhere).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;        // boxes per tile = bits per mask word
constexpr int kChunk = 16;       // row words loaded ahead in a sweep
constexpr int kClusterThreads = 256;
// the sweep visits the acting rows of a word one by one (a dependent
// shared-memory load each) up to this many, else runs the whole chain
// (python -m mxnet_tpu_torch.tools.nms_variants times both sweeps on
// inputs with some 5 and some 30 acting rows a word)
constexpr int kSparseRows = 12;

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

__device__ __forceinline__ bool suppresses(float4 a, float area_a, float ca,
                                           float4 b, float area_b, float cb,
                                           float thresh, int force) {
  return (force || ca == cb) && iou_rn(a, area_a, b, area_b) > thresh;
}

// alive words of one image: bit j of word j/64 set when score[j] > 0, 32
// scores a ballot, the block's warps taking 32-score halves in turn (both
// routes)
__device__ __forceinline__ void init_alive(const float* __restrict__ sb,
                                           int k, u64* alive) {
  unsigned* half = reinterpret_cast<unsigned*>(alive);
  const int lane = threadIdx.x & 31;
  const int nhalf = (k + 31) / 32;
  for (int h = threadIdx.x >> 5; h < nhalf; h += blockDim.x >> 5) {
    const int j = h * 32 + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, j < k && sb[j] > 0.0f);
    if (lane == 0) half[h] = bits;
  }
  if (threadIdx.x == 0 && (nhalf & 1)) half[nhalf] = 0u;
}

// ---------------------------------------------------------------------------
// route "smem": one launch, the mask in the cluster leader's shared memory
// ---------------------------------------------------------------------------

// The IoU part of sup[i, j] for the cluster kernel's hot loop, without a
// branch or a division, for boxes whose areas all lie in [2^-99, 2^125]:
// then inter <= min(area_a, area_b), so the union is positive and within
// [2^-100, 2^126], where inter * rcp.approx(uni) is within 2 ulps of
// inter/uni (rcp.approx within 1 ulp, the product rounded once). Where that
// q is further than tol = 2^-18 |thresh| + 2^-100
// from thresh, the correctly rounded quotient lies on the same side of
// thresh as q (the margin is 64 ulps of thresh or more), so gt is
// iou_rn(...) > thresh; `sure` says whether it is. The rest (an IoU within
// 2^-18 of the threshold) is left to iou_rn.
__device__ __forceinline__ void iou_gt_fast(float4 a, float area_a, float4 b,
                                           float area_b, float thresh,
                                           float tol, bool& gt, bool& sure) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // the union is a normal float: the reciprocal needs no range handling
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(uni));
  const float q = __fmul_rn(inter, r);
  sure = fabsf(q - thresh) > tol;
  gt = q > thresh;
}

__device__ __forceinline__ bool area_in_fast_range(float area) {
  return area >= 0x1p-99f && area <= 0x1p125f;
}

// the split cluster barrier: arrive without ordering memory (on entry, to
// say that this block runs), then wait until every block of the cluster
// has arrived (before the first access to another block's shared memory)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One step of the sweep's chain, for a row r of the word being resolved
// whose alive bit is `bit` of lo (r < 32) or of hi (r >= 32): while the row
// is alive, clear what it suppresses (m). Predicated, so that the chain's
// dependent path is a test and an and per row.
__device__ __forceinline__ void chain_step_lo(unsigned& lo, unsigned& hi,
                                              unsigned mlo, unsigned mhi,
                                              unsigned bit) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %0, %4;\n\t"
      "setp.ne.b32 p, t, 0;\n\t"
      "@p and.b32 %0, %0, %2;\n\t"
      "@p and.b32 %1, %1, %3;\n\t}"
      : "+r"(lo), "+r"(hi)
      : "r"(~mlo), "r"(~mhi), "r"(bit));
}

// rows 32..63 suppress only bits above 32
__device__ __forceinline__ void chain_step_hi(unsigned& hi, unsigned mhi,
                                              unsigned bit) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %0, %2;\n\t"
      "setp.ne.b32 p, t, 0;\n\t"
      "@p and.b32 %0, %0, %1;\n\t}"
      : "+r"(hi)
      : "r"(~mhi), "r"(bit));
}

__global__ void __launch_bounds__(kClusterThreads)
nms_cluster_kernel(const float4* __restrict__ boxes,
                   const float* __restrict__ score,
                   const float* __restrict__ cls, float* __restrict__ out,
                   int k, float thresh, int force) {
  // every block: the image's boxes, areas and classes, in k + 64 slots
  // (the slots past k are never used unmasked); the leader also holds the
  // mask, word-major (word w of row i at w * kp + i, kp = k rounded up to
  // even), the nwords alive words and 64 words of slack that the sweep may
  // read past the last row
  extern __shared__ float4 sbox[];
  cluster_arrive_relaxed();
  const int kb = k + kTile;
  const int kp = (k + 1) & ~1;
  float* const sarea = reinterpret_cast<float*>(sbox + kb);
  float* const scls = sarea + kb;
  u64* const local_mask = reinterpret_cast<u64*>(scls + kb);
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / csize;
  const int nwords = (k + kTile - 1) / kTile;
  u64* const alive = local_mask + (size_t)nwords * kp;
  u64* const mask = cluster.map_shared_rank(local_mask, 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kClusterThreads / 32;
  const float tol = 0x1p-18f * fabsf(thresh) + 0x1p-100f;
  const bool all_classes = force != 0;

  // the image's boxes, areas and classes into every block; the leader's
  // alive words
  bool all_fast = true;
  for (int j = threadIdx.x; j < k; j += kClusterThreads) {
    const float4 q = boxes[(size_t)b * k + j];
    sbox[j] = q;
    const float ar = area_rn(q);
    sarea[j] = ar;
    scls[j] = cls[(size_t)b * k + j];
    all_fast &= area_in_fast_range(ar);
  }
  if (rank == 0) init_alive(score + (size_t)b * k, k, alive);
  // whether every area of the image suits iou_gt_fast (the same in every
  // block of the cluster: each staged the whole image)
  const bool fast = __syncthreads_and(all_fast);
  // every block of the cluster runs from here: the leader's shared memory
  // may take remote stores
  cluster_wait();

  // the upper triangle, as tasks of 32 rows x one column word w (rows
  // 0 .. min(k, 64(w+1)) - 1: 2(w+1) tasks for w < nwords - 1, starting at
  // task w(w+1), ceil(k/32) for the last word), dealt to the cluster's
  // warps in turn; lane l forms row 32t + l's word on its own, the column
  // boxes read at one address for the warp, with no branch and no warp
  // operation, so that the 64 columns overlap
  const int ntasks = (nwords - 1) * nwords + (k + 31) / 32;
  for (int t = rank * kWarps + warp; t < ntasks; t += csize * kWarps) {
    int w = 0;
    while (w + 1 < nwords && (w + 1) * (w + 2) <= t) ++w;
    const int i = (t - w * (w + 1)) * 32 + lane;
    if (i >= k) continue;
    const float4 qa = sbox[i];
    const float aa = sarea[i];
    const float ca = scls[i];
    const int jbase = w * kTile;
    const float4* cb = sbox + jbase;
    const float* ab = sarea + jbase;
    const float* clb = scls + jbase;
    u64 word = 0ull;
    if (fast) {
      // columns j with i < j < k, as bits of the task's word
      const int lo_c = i - jbase + 1;     // first column after row i
      const int hi_c = k - jbase;         // columns at or past k
      const u64 valid =
          (lo_c >= kTile || hi_c <= 0)
              ? 0ull
              : ((~0ull << max(lo_c, 0)) &
                 (hi_c >= kTile ? ~0ull : (1ull << hi_c) - 1ull));
      unsigned glo = 0u, ghi = 0u, olo = 0u, ohi = 0u;
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        bool gt, sure;
        iou_gt_fast(qa, aa, cb[c], ab[c], thresh, tol, gt, sure);
        const bool same = all_classes | (ca == clb[c]);
        if (c < 32) {
          if (same & gt) glo |= 1u << c;
          if (same & !sure) olo |= 1u << c;
        } else {
          if (same & gt) ghi |= 1u << (c - 32);
          if (same & !sure) ohi |= 1u << (c - 32);
        }
      }
      word = ((u64)ghi << 32 | glo) & valid;
      // the rare pairs near the threshold, again with iou_rn
      for (u64 open = ((u64)ohi << 32 | olo) & valid; open;
           open &= open - 1) {
        const int c = __ffsll(open) - 1;
        const u64 bit = 1ull << c;
        word = iou_rn(qa, aa, cb[c], ab[c]) > thresh ? word | bit
                                                     : word & ~bit;
      }
    } else {
      // an image with a degenerate or huge box: every pair with iou_rn
      for (int c = 0; c < kTile; ++c)
        if (jbase + c > i && jbase + c < k &&
            suppresses(qa, aa, ca, cb[c], ab[c], clb[c], thresh, force))
          word |= 1ull << c;
    }
    mask[(size_t)w * kp + i] = word;
  }
  // every word and the alive words are in the leader's shared memory after
  // this; only the leader reads its shared memory from here on
  cluster.sync();
  if (rank != 0) return;

  if (warp == 0) {
    // lane w: word w's alive bits, then (once W = w is done) its final ones
    u64 own = lane < nwords ? alive[lane] : 0ull;
    for (int W = 0; W < nwords; ++W) {
      const u64* col = local_mask + (size_t)W * kp;
      // what the kept rows of the earlier words suppress in word W: lane l
      // takes rows l and l + 32 of each, the warp folds the lanes
      u64 kill = 0ull;
      for (int v = 0; v < W; ++v) {
        const u64 kept = __shfl_sync(0xffffffffu, own, v);
        kill |= col[v * kTile + lane] & (0ull - ((kept >> lane) & 1ull));
        kill |= col[v * kTile + lane + 32] &
                (0ull - ((kept >> (lane + 32)) & 1ull));
      }
      const u64 a0 = __shfl_sync(0xffffffffu, own, W) &
                     ~((u64)__reduce_or_sync(0xffffffffu, (unsigned)kill) |
                       ((u64)__reduce_or_sync(0xffffffffu,
                                              (unsigned)(kill >> 32))
                        << 32));
      const u64* rows = col + W * kTile;
      // the rows of W that suppress anything in W (rows past k read the
      // slack: their alive bits are 0, so they never act)
      const u64 acting = (u64)__ballot_sync(0xffffffffu, rows[lane] != 0ull) |
                         ((u64)__ballot_sync(0xffffffffu,
                                             rows[lane + 32] != 0ull) << 32);
      u64 a = a0;
      if (__popcll(acting & a0) <= kSparseRows) {
        // few: visit them in order, each while it is still alive
        for (u64 todo = acting & a; todo;) {
          const int r = __ffsll(todo) - 1;
          a &= ~rows[r];
          todo = acting & a & (~1ull << r);
        }
      } else {
        // many: the chain, the same on every lane: the rows of W in
        // order, each clearing later bits of W only while it is itself
        // alive (rows 0..31 reach both halves, rows 32..63 the high half
        // only); the rows are consecutive words, read 16 ahead at one
        // address for the warp
        unsigned lo = (unsigned)a0, hi = (unsigned)(a0 >> 32);
        u64 m[kChunk], next[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q) m[q] = rows[q];
#pragma unroll
        for (int r0 = 0; r0 < kTile; r0 += kChunk) {
          if (r0 + kChunk < kTile) {
#pragma unroll
            for (int q = 0; q < kChunk; ++q) next[q] = rows[r0 + kChunk + q];
          }
#pragma unroll
          for (int q = 0; q < kChunk; ++q) {
            const int r = r0 + q;
            if (r < 32)
              chain_step_lo(lo, hi, (unsigned)m[q], (unsigned)(m[q] >> 32),
                            1u << r);
            else
              chain_step_hi(hi, (unsigned)(m[q] >> 32), 1u << (r - 32));
          }
          if (r0 + kChunk < kTile) {
#pragma unroll
            for (int q = 0; q < kChunk; ++q) m[q] = next[q];
          }
        }
        a = (u64)hi << 32 | lo;
      }
      own = lane == W ? a : own;
    }
    if (lane < nwords) alive[lane] = own;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    out[(size_t)b * k + j] =
        ((alive[j / kTile] >> (j % kTile)) & 1ull) ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// route "l2": a mask kernel and a sweep kernel through a scratch in L2
// ---------------------------------------------------------------------------

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
    if (suppresses(a, area_a, ca, sbox[c], sarea[c], scls[c], thresh, force))
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
  init_alive(score + (size_t)b * k, k, alive);
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

// All entry points: boxes (batch, k, 4) f32 corners, 16-byte aligned;
// score, cls (batch, k) f32; out (batch, k) f32; all on `device`, all
// contiguous. Each returns a cudaError_t (0 on success).

// Route "smem": `cluster` blocks per image (1..8), `smem_bytes` of dynamic
// shared memory a block (k * (ceil(k/64) | 1) * 8 for the mask plus
// ceil(k/64) * 8 for the alive words, at most 227 KB).
int multibox_nms_alive_smem(const float* boxes, const float* score,
                            const float* cls, float* out, int batch, int k,
                            float thresh, int force, int cluster,
                            int smem_bytes, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_cluster_kernel,
                         reinterpret_cast<const float4*>(boxes), score, cls,
                         out, k, thresh, force);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Route "l2": mask scratch of batch*k*ceil(k/64) u64.
int multibox_nms_alive_l2(const float* boxes, const float* score,
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
