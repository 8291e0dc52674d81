// ImageRecordIter's per-pixel stage on the card: libjpeg's DCT-scale
// emulation, resize-short, crop, resize, mirror and normalize, from the
// decoded uint8 HWC images to the float32 NCHW batch, in one launch a batch.
//
// It replaces no TPU kernel: the JAX package does this work on the host, in
// ProcessOne (src/io/image_decode.cc:131-208) after libjpeg's decode. Here
// nvJPEG decodes at full size (mxnet_tpu_torch/jpeg_decode.py) and this
// kernel reads the images through a descriptor table, one row of 14 int64
// an image (mxnet_tpu_torch/ops/image_augment.py names the columns):
// offset, W, H, pitch, denom, w1, h1, nw, nh, x0, y0, cw, ch, mirror.
//
// Bound: bytes. The float32 batch is written once (128 x 3 x 224 x 224 x 4
// = 77,070,336 B at the ImageNet shape) and the source pixels behind each
// crop window are read; the stage does some 30 float operations a byte
// written, far below the card's ridge.
//
// Design. The output is cut into 32x32 tiles, one image each, and a block
// of 256 threads takes one tile. It pulls the tile's pixels back through
// the stages once, each stage's values held in shared memory as the uint8
// the C++ rounds them to, so reading one many times gives what
// recomputing it would:
//  1. Two warps read the descriptor, check it and write the tile's tap
//     tables, one an axis: the second Resize's (stage d) from each output
//     into the window of resize-short values it reads, and the resize-short
//     stage's (b) from each of those into the window of scaled pixels
//     (stage a's output) they read. src_len / dst_len is divided once an
//     axis and a stage, not once a tap.
//  2. The scaled window is staged in shared memory. At denom 1 its rows
//     are copied as aligned 16-byte words by cp.async,
//     whatever the row's alignment (nvJPEG's pitch is 3 * W, odd for odd
//     W: TMA's 16-byte strides do not fit); at denom > 1 each thread
//     writes one box average, read byte by byte from global memory, two
//     boxes in flight.
//  3. Where the crop is smaller than the output, the resize-short values
//     the tile reads are computed once into shared memory.
//  4. The last stage, mirror and normalize read shared memory only; each
//     thread writes 4 neighbouring x of one row as float4 streaming stores
//     into the three planes (the batch is larger than L2; scalar stores
//     where out_w % 4 != 0).
// Its cost is then the arithmetic of the blends, not the bytes: uint8 and
// float are converted through the float 2^23 (MAGIC), on the FP32 pipe,
// since the conversion unit would take 18 conversions a pixel at 16 a
// clock an SM.
// Windows are bounded whatever the data: the second Resize only enlarges
// (cw <= out_w), so its window spans at most TILE + 2 values an axis; the
// resize-short window is the span of its taps where that is at most
// 2 * (TILE + 2), else (a shrink past 2x, libjpeg's scale capped at 1/8)
// the two taps of each value, listed. No load reads outside `pixels`: a
// 16-byte word that reaches past either end is read byte by byte, and a
// descriptor whose image reaches outside the buffer, or that plan() cannot
// make (a denom other than 1, 2, 4 or 8, sizes that disagree), gives a
// tile of NaN and reads nothing.
//
// Exactness: every float operation is the host C++'s, in its order, spelled
// with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn so that nvcc contracts
// nothing into a fused multiply-add (cuda_build's flags leave contraction
// on). Given the same decoded pixels the kernel equals the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum {
  D_OFFSET = 0, D_W, D_H, D_PITCH, D_DENOM, D_W1, D_H1, D_NW, D_NH, D_X0,
  D_Y0, D_CW, D_CH, D_MIRROR, NDESC
};

constexpr int TILE = 32;                // output tile edge, x and y
constexpr int THREADS = 256;            // 8 threads a tile row, 4 x each
constexpr int RCAP = TILE + 2;          // resize-short values an axis
constexpr int SCAP = 2 * RCAP;          // scaled pixels an axis
constexpr int NV = 15;                  // 16-byte words a staged row
constexpr int SP = 16 * NV;             // bytes a staged row: 3 * SCAP + 36
constexpr int RP = 3 * RCAP;            // bytes a resize-short row
constexpr long long DIM_MAX = 1 << 24;  // sizes exact in float32
constexpr unsigned FULL = 0xffffffffu;

static_assert(SP >= 3 * SCAP + 15 + 1, "a staged row holds its lead");

// One output coordinate of Resize (image_decode.cc:91-118): the two source
// indices and the weight, each operation as the C++ rounds it, with
// s = src_len / dst_len taken once by the caller.
struct Tap {
  int i0, i1;
  float w;
};

__device__ __forceinline__ Tap tap(int o, float s, int src_len) {
  float f = __fsub_rn(__fmul_rn(__fadd_rn((float)o, 0.5f), s), 0.5f);
  Tap t;
  t.i0 = max(0, (int)floorf(f));
  t.i1 = min(src_len - 1, t.i0 + 1);
  t.w = __fsub_rn(f, (float)t.i0);
  if (t.w < 0.f) t.w = 0.f;
  return t;
}

// A float in [2^23, 2^24) holds an integer in its low mantissa bits: the
// kernel converts between uint8 and float through it, exactly, on the
// FP32 and integer pipes (Hopper's conversion unit does 16 a clock an SM,
// and a blend would need 6 conversions a channel).
constexpr float MAGIC = 8388608.f;

// The uint8 x as a float: the float whose bits are 2^23's | x, less 2^23.
__device__ __forceinline__ float u8f(uint32_t x) {
  return __fsub_rn(__int_as_float(0x4B000000 | x), MAGIC);
}

// v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx)
//   + v11 * wy * wx, then (uint8)(v + 0.5f), returned as 2^23 plus that
// value: v + 0.5f lies in [0.5, 256) (the four weights sum to at most
// 1 + 5e-7), so adding 2^23 rounded toward zero truncates it as the
// C++'s cast does.
__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float wy, float wx) {
  float ay = __fsub_rn(1.f, wy), ax = __fsub_rn(1.f, wx);
  float a = __fmul_rn(__fmul_rn(v00, ay), ax);
  float b = __fmul_rn(__fmul_rn(v01, ay), wx);
  float c = __fmul_rn(__fmul_rn(v10, wy), ax);
  float e = __fmul_rn(__fmul_rn(v11, wy), wx);
  float v = __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), e);
  return __fadd_rz(__fadd_rn(v, 0.5f), MAGIC);
}

// (a + cnt / 2) / cnt, a shift where cnt is a power of two
__device__ __forceinline__ int round_div(int a, int cnt) {
  return (cnt & (cnt - 1)) ? (a + cnt / 2) / cnt
                           : (a + cnt / 2) >> (__ffs(cnt) - 1);
}

// One axis of a tile's plan. Tile coordinate u (0 <= u < nF) is the final
// image's coordinate f_lo + u. With stage (d), its taps dk0/dk1/dw index
// the window of nC crop coordinates c_lo + k; without, k = u. Window entry
// k is resize-short coordinate off + c_lo + k; with stage (b), its taps
// bk0/bk1/bw index the nS scaled pixels sidx[]; without, sidx[k] is it.
struct Axis {
  short dk0[TILE], dk1[TILE];
  float dw[TILE];
  short bk0[RCAP], bk1[RCAP];
  float bw[RCAP];
  int sidx[SCAP];
  int nF, nC, nS, contiguous;
};

// A tile's plan and its window of scaled pixels.
struct Plan {
  Axis ax[2];                        // x, y
  long long d[NDESC];
  int refused[2];                    // by the x and y planning warps
};

struct Window {
  alignas(16) uint8_t S[SCAP * SP];  // scaled pixels, row k at k * SP
  int rowoff[SCAP];                  // lead bytes of each staged row
};

// Where tile t lies: image, first output column and row, and size.
struct Place {
  int img, tx0, ty0, nFx, nFy;
  __device__ Place(int t, int tiles, int tiles_x, int out_h, int out_w) {
    img = t / tiles;
    const int k = t - img * tiles;
    tx0 = (k % tiles_x) * TILE;
    ty0 = (k / tiles_x) * TILE;
    nFx = min(TILE, out_w - tx0);
    nFy = min(TILE, out_h - ty0);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warp-wide (lane = tile coordinate): one axis's tap tables and windows.
// Returns false where the window cannot be held (it can for every output
// narrower than 2^23, which the wrapper requires).
__device__ bool plan_axis(Axis& a, int lane, int f_lo, int nF, bool stage_d,
                          int c_len, int out_len, int off, bool stage_b,
                          int s_len, int r_len) {
  int c_lo = f_lo, nC = nF;
  if (stage_d) {
    float s = __fdiv_rn((float)c_len, (float)out_len);
    Tap t = tap(f_lo + min(lane, nF - 1), s, c_len);
    c_lo = __shfl_sync(FULL, t.i0, 0);
    nC = __shfl_sync(FULL, t.i1, nF - 1) - c_lo + 1;
    if (lane < nF) {
      a.dk0[lane] = (short)(t.i0 - c_lo);
      a.dk1[lane] = (short)(t.i1 - c_lo);
      a.dw[lane] = t.w;
    }
    if (nC > RCAP) return false;
  }
  int nS = nC, contiguous = 1;
  if (stage_b) {
    float s = __fdiv_rn((float)s_len, (float)r_len);
    const int r0 = off + c_lo;
    Tap t0 = tap(r0 + min(lane, nC - 1), s, s_len);
    Tap t1 = tap(r0 + min(lane + 32, nC - 1), s, s_len);
    const int lo = __shfl_sync(FULL, t0.i0, 0);
    const int hi0 = __shfl_sync(FULL, t0.i1, min(nC - 1, 31));
    const int hi1 = __shfl_sync(FULL, t1.i1, max(nC - 33, 0));
    const int hi = nC > 32 ? hi1 : hi0;
    contiguous = hi - lo + 1 <= SCAP;
    nS = contiguous ? hi - lo + 1 : 2 * nC;
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      const Tap& t = h ? t1 : t0;
      if (k < nC) {
        if (contiguous) {
          a.bk0[k] = (short)(t.i0 - lo);
          a.bk1[k] = (short)(t.i1 - lo);
        } else {
          a.bk0[k] = (short)(2 * k);
          a.bk1[k] = (short)(2 * k + 1);
          a.sidx[2 * k] = t.i0;
          a.sidx[2 * k + 1] = t.i1;
        }
        a.bw[k] = t.w;
      }
    }
    if (contiguous)
      for (int j = lane; j < nS; j += 32) a.sidx[j] = lo + j;
  } else {
    for (int j = lane; j < nS; j += 32) a.sidx[j] = off + c_lo + j;
  }
  if (lane == 0) {
    a.nF = nF;
    a.nC = nC;
    a.nS = nS;
    a.contiguous = contiguous;
  }
  return true;
}

// The descriptor as plan() makes it, its image inside `pixels`.
__device__ bool desc_ok(const long long* d, long long numel, int out_h,
                        int out_w) {
  const long long W = d[D_W], H = d[D_H], denom = d[D_DENOM];
  if (W < 1 || H < 1 || W >= DIM_MAX || H >= DIM_MAX ||
      (denom != 1 && denom != 2 && denom != 4 && denom != 8))
    return false;
  if (d[D_W1] != (W + denom - 1) / denom ||
      d[D_H1] != (H + denom - 1) / denom)
    return false;
  if (d[D_PITCH] < 3 * W || d[D_PITCH] >= (1LL << 31) || d[D_OFFSET] < 0 ||
      d[D_OFFSET] > numel - (H - 1) * d[D_PITCH] - 3 * W)
    return false;
  if (d[D_NW] < 1 || d[D_NH] < 1 || d[D_NW] >= DIM_MAX ||
      d[D_NH] >= DIM_MAX)
    return false;
  if (d[D_CW] < 1 || d[D_CH] < 1 || d[D_CW] > out_w || d[D_CH] > out_h)
    return false;
  return d[D_X0] >= 0 && d[D_Y0] >= 0 && d[D_X0] + d[D_CW] <= d[D_NW] &&
         d[D_Y0] + d[D_CH] <= d[D_NH];
}

// Warps 0 and 1 (tid their thread index): a tile's descriptor, checked,
// and its tap tables, warp 0 x (stage (e)'s mirror reads column
// out_w - 1 - x of the final image), warp 1 y.
__device__ void plan_tile(Plan& T, const long long* __restrict__ desc,
                          long long numel, const Place& P, int out_h,
                          int out_w, int tid) {
  const int lane = tid & 31;
  const long long mine =
      lane < NDESC ? __ldg(desc + (size_t)P.img * NDESC + lane) : 0;
  long long d[NDESC];
#pragma unroll
  for (int k = 0; k < NDESC; ++k) d[k] = __shfl_sync(FULL, mine, k);
  if (tid < NDESC) T.d[tid] = mine;
  bool ok = desc_ok(d, numel, out_h, out_w);
  if (ok) {
    const bool stage_d = d[D_CW] != out_w || d[D_CH] != out_h;
    const bool stage_b = d[D_NW] != d[D_W1] || d[D_NH] != d[D_H1];
    if (tid < 32)
      ok = plan_axis(T.ax[0], lane,
                     d[D_MIRROR] ? out_w - P.tx0 - P.nFx : P.tx0, P.nFx,
                     stage_d, (int)d[D_CW], out_w, (int)d[D_X0], stage_b,
                     (int)d[D_W1], (int)d[D_NW]);
    else
      ok = plan_axis(T.ax[1], lane, P.ty0, P.nFy, stage_d, (int)d[D_CH],
                     out_h, (int)d[D_Y0], stage_b, (int)d[D_H1],
                     (int)d[D_NH]);
  }
  if (lane == 0) T.refused[tid >> 5] = !ok;
}

// Stage (a) where it averages: the mean of each DENOM x DENOM box,
// clipped at the ragged edge, rounded to nearest, one scaled pixel a
// thread (a listed window at denom 1 reads its pixels so). Unrolled by two
// so that two boxes' loads are in flight.
template <int DENOM>
__device__ void stage_boxes(const Plan& T, Window& V,
                            const uint8_t* __restrict__ src, int pitch,
                            int W, int H, int tid) {
  const Axis& X = T.ax[0];
  const Axis& Y = T.ax[1];
  const int nSx = X.nS, total = Y.nS * nSx;
#pragma unroll 2
  for (int i = tid; i < total; i += THREADS) {
    const int k = i / nSx, j = i - k * nSx;
    if (j == 0) V.rowoff[k] = 0;
    const int xs = X.sidx[j] * DENOM, ys = Y.sidx[k] * DENOM;
    const int nx = min(DENOM, W - xs), ny = min(DENOM, H - ys);
    const uint8_t* p = src + (size_t)ys * pitch + 3 * xs;
    int a0 = 0, a1 = 0, a2 = 0;
#pragma unroll
    for (int dy = 0; dy < DENOM; ++dy)
#pragma unroll
      for (int dx = 0; dx < DENOM; ++dx)
        if (dy < ny && dx < nx) {
          const uint8_t* q = p + (size_t)dy * pitch + 3 * dx;
          a0 += __ldg(q);
          a1 += __ldg(q + 1);
          a2 += __ldg(q + 2);
        }
    const int cnt = nx * ny;
    uint8_t* s = V.S + k * SP + 3 * j;
    s[0] = (uint8_t)round_div(a0, cnt);
    s[1] = (uint8_t)round_div(a1, cnt);
    s[2] = (uint8_t)round_div(a2, cnt);
  }
}

// Stage (a) at denom 1 over a span of columns: each window row as the
// aligned 16-byte words that hold it, copied by cp.async (all of a
// thread's copies in flight at once, in no registers); a word that reaches
// past either end of `pixels` is read byte by byte (bytes outside it read
// as 0, never used).
__device__ void stage_rows(const Plan& T, Window& V,
                           const uint8_t* __restrict__ pixels,
                           long long numel, const uint8_t* src, int pitch,
                           int tid) {
  const Axis& X = T.ax[0];
  const Axis& Y = T.ax[1];
  const uintptr_t lo = (uintptr_t)pixels, hi = lo + (uintptr_t)numel;
  const int len = 3 * X.nS, items = Y.nS * NV;
  for (int i = tid; i < items; i += THREADS) {
    const int k = i / NV, v = i - k * NV;
    const uintptr_t p0 =
        (uintptr_t)(src + (size_t)Y.sidx[k] * pitch + 3 * X.sidx[0]);
    const int lead = (int)(p0 & 15);
    if (v == 0) V.rowoff[k] = lead;
    if (v >= (lead + len + 15) >> 4) continue;
    const uintptr_t at = (p0 & ~(uintptr_t)15) + 16 * v;
    uint8_t* dst = V.S + k * SP + 16 * v;
    if (at >= lo && at + 16 <= hi) {
      cp_async16(dst, at);
    } else {                                 // the buffer's first or last
      uint32_t b4[4] = {0, 0, 0, 0};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (at + b >= lo && at + b < hi)
          b4[b >> 2] |= (uint32_t)__ldg(reinterpret_cast<const uint8_t*>(
                            at + b)) << (8 * (b & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(b4[0], b4[1], b4[2], b4[3]);
    }
  }
  cp_async_commit();
}

// Stage (a) of a planned tile into its window.
__device__ void stage_tile(const Plan& T, Window& V,
                           const uint8_t* __restrict__ pixels,
                           long long numel, int tid) {
  if (T.refused[0] | T.refused[1]) return;
  const int W = (int)T.d[D_W], H = (int)T.d[D_H];
  const int pitch = (int)T.d[D_PITCH], denom = (int)T.d[D_DENOM];
  const uint8_t* src = pixels + T.d[D_OFFSET];
  if (denom == 1 && T.ax[0].contiguous)
    stage_rows(T, V, pixels, numel, src, pitch, tid);
  else if (denom == 1)
    stage_boxes<1>(T, V, src, pitch, W, H, tid);
  else if (denom == 2)
    stage_boxes<2>(T, V, src, pitch, W, H, tid);
  else if (denom == 4)
    stage_boxes<4>(T, V, src, pitch, W, H, tid);
  else
    stage_boxes<8>(T, V, src, pitch, W, H, tid);
}

struct Norm {
  float m[3], s[3];
};

// Stage (b) once a tile where stage (d) reads it, then (c)/(d) and (e):
// thread i writes 4 neighbouring x of tile row i / 8, as float4 streaming
// stores into the three planes where out_w % 4 == 0.
__device__ void compute_tile(const Plan& T, const Window& V, uint8_t* R,
                             const Place& P, int out_h, int out_w,
                             const Norm& nm, float* __restrict__ out,
                             int tid) {
  const int ty = tid >> 3, xq = (tid & 7) * 4;
  const size_t plane = (size_t)out_h * out_w;
  float* o = out + (size_t)P.img * 3 * plane + (size_t)(P.ty0 + ty) * out_w +
             P.tx0 + xq;
  if (T.refused[0] | T.refused[1]) {
    if (ty < P.nFy)
      for (int c = 0; c < 3; ++c)
        for (int i = 0; i < 4 && xq + i < P.nFx; ++i)
          o[c * plane + i] = __int_as_float(0x7fc00000);
    return;
  }
  const Axis& X = T.ax[0];
  const Axis& Y = T.ax[1];
  const bool mirror = T.d[D_MIRROR] != 0;
  const bool stage_d = T.d[D_CW] != out_w || T.d[D_CH] != out_h;
  const bool stage_b = T.d[D_NW] != T.d[D_W1] || T.d[D_NH] != T.d[D_H1];
  if (stage_d && stage_b) {
    const int nCx = X.nC, nCy = Y.nC;
    for (int i = tid; i < nCy * nCx; i += THREADS) {
      const int k = i / nCx, j = i - k * nCx;
      const int k0 = Y.bk0[k], k1 = Y.bk1[k];
      const uint8_t* r0 = V.S + k0 * SP + V.rowoff[k0];
      const uint8_t* r1 = V.S + k1 * SP + V.rowoff[k1];
      const int j0 = 3 * X.bk0[j], j1 = 3 * X.bk1[j];
      const float wy = Y.bw[k], wx = X.bw[j];
      uint8_t* r = R + k * RP + 3 * j;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        r[c] = (uint8_t)__float_as_int(
            blend(u8f(r0[j0 + c]), u8f(r0[j1 + c]), u8f(r1[j0 + c]),
                  u8f(r1[j1 + c]), wy, wx));
    }
    __syncthreads();
  }
  if (ty >= P.nFy) return;
  const bool interp = stage_d || stage_b;
  const short* kx0 = stage_d ? X.dk0 : X.bk0;
  const short* kx1 = stage_d ? X.dk1 : X.bk1;
  const float* wxs = stage_d ? X.dw : X.bw;
  int ky0 = ty, ky1 = ty;
  float wy = 0.f;
  if (interp) {
    ky0 = stage_d ? Y.dk0[ty] : Y.bk0[ty];
    ky1 = stage_d ? Y.dk1[ty] : Y.bk1[ty];
    wy = stage_d ? Y.dw[ty] : Y.bw[ty];
  }
  const uint8_t* r0;
  const uint8_t* r1;
  if (stage_d && stage_b) {
    r0 = R + ky0 * RP;
    r1 = R + ky1 * RP;
  } else {
    r0 = V.S + ky0 * SP + V.rowoff[ky0];
    r1 = V.S + ky1 * SP + V.rowoff[ky1];
  }
  float v[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xl = xq + i;
    if (xl >= P.nFx) break;
    const int u = mirror ? P.nFx - 1 - xl : xl;
    if (interp) {
      const int j0 = 3 * kx0[u], j1 = 3 * kx1[u];
      const float wx = wxs[u];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float p = __fsub_rn(
            blend(u8f(r0[j0 + c]), u8f(r0[j1 + c]), u8f(r1[j0 + c]),
                  u8f(r1[j1 + c]), wy, wx), MAGIC);
        v[c][i] = __fmul_rn(__fsub_rn(p, nm.m[c]), nm.s[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c][i] = __fmul_rn(__fsub_rn(u8f(r0[3 * u + c]), nm.m[c]), nm.s[c]);
    }
  }
  if ((out_w & 3) == 0 && xq + 4 <= P.nFx) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      __stcs(reinterpret_cast<float4*>(o + c * plane),
             make_float4(v[c][0], v[c][1], v[c][2], v[c][3]));
  } else {
    for (int c = 0; c < 3; ++c)
      for (int i = 0; i < 4 && xq + i < P.nFx; ++i) o[c * plane + i] = v[c][i];
  }
}

// One block a tile: plan, stage, compute, two barriers (three where the
// crop is smaller than the output and resize-short shrinks or enlarges).
// Where `listed` is not null, a tile whose resize-short window is listed
// adds 1 to it, so that a check can see that route run.
__global__ void __launch_bounds__(THREADS, 6)
image_augment_kernel(const uint8_t* __restrict__ pixels, long long numel,
                     const long long* __restrict__ desc, int out_h,
                     int out_w, int tiles_x, int tiles, Norm nm,
                     float* __restrict__ out, unsigned* listed) {
  __shared__ Plan plan;
  __shared__ Window win;
  __shared__ uint8_t R[RCAP * RP];   // resize-short window (stages b + d)
  const int tid = threadIdx.x;
  const Place P(blockIdx.x, tiles, tiles_x, out_h, out_w);
  if (tid < 64) plan_tile(plan, desc, numel, P, out_h, out_w, tid);
  __syncthreads();
  if (listed != nullptr && tid == 0 && !(plan.refused[0] | plan.refused[1]) &&
      !(plan.ax[0].contiguous & plan.ax[1].contiguous))
    atomicAdd(listed, 1u);
  stage_tile(plan, win, pixels, numel, tid);
  cp_async_wait_all();
  __syncthreads();
  compute_tile(plan, win, R, P, out_h, out_w, nm, out, tid);
}

}  // namespace

extern "C" {

// pixels: the decoded images, numel bytes; desc: int64 (n, 14) on the card;
// out: float32 (n, 3, out_h, out_w), out_h and out_w below 2^23, n tiles
// of 32x32 at most 2^31 - 1 in all; listed: null, or a counter on the
// card to which each tile whose resize-short window is listed (a shrink
// past 2x) adds 1. Launches one block a tile on `stream`; returns a
// cudaError_t.
int image_augment_launch(const uint8_t* pixels, long long numel,
                         const long long* desc, int n, int out_h, int out_w,
                         float m0, float m1, float m2, float s0, float s1,
                         float s2, int device, float* out, void* stream,
                         unsigned* listed) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (out_w + TILE - 1) / TILE;
  const long long tiles = (long long)tiles_x * ((out_h + TILE - 1) / TILE);
  const long long total = n * tiles;
  if (n < 1 || out_h < 1 || out_w < 1 || total > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Norm nm = {{m0, m1, m2}, {s0, s1, s2}};
  image_augment_kernel<<<(unsigned)total, THREADS, 0,
                         (cudaStream_t)stream>>>(
      pixels, numel, desc, out_h, out_w, tiles_x, (int)tiles, nm, out,
      listed);
  return (int)cudaGetLastError();
}

const char* image_augment_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
