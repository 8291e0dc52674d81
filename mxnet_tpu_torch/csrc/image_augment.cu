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
// One thread computes the three channels of one output pixel, pulling its
// value back through the stages: the second Resize's four taps (when the
// crop is smaller than the output) each read the resize-short stage's value,
// whose four taps each read the DCT-scale stage's box average of denom x
// denom full-size pixels. Each stage rounds to uint8 as the C++ does, so
// the chain is recomputed per pixel rather than stored: at ImageNet's sizes
// (denom 1) that is at most 16 reads of 3 bytes a pixel, from L1/L2.
//
// Exactness: every float operation is the host C++'s, in its order, spelled
// with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn so that nvcc contracts
// nothing into a fused multiply-add (cuda_build's flags leave contraction
// on). Given the same decoded pixels the kernel equals the plain PyTorch
// version bit for bit.
//
// Bound: bytes. The float32 batch is written once (128 x 3 x 224 x 224 x 4
// = 77,070,336 B at the ImageNet shape) and the source pixels behind each
// crop window are read; the stage does some 30 float operations a byte
// written, far below the card's ridge. Writes are coalesced (a warp covers
// 32 neighbouring x of one row, each of the three planes); reads gather.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum {
  D_OFFSET = 0, D_W, D_H, D_PITCH, D_DENOM, D_W1, D_H1, D_NW, D_NH, D_X0,
  D_Y0, D_CW, D_CH, D_MIRROR, NDESC
};

struct Desc {
  const uint8_t* src;
  int W, H, pitch, denom, w1, h1, nw, nh, x0, y0, cw, ch, mirror;
};

// Stage (a): the scaled image's pixel (x, y), 3 channels: a full-size pixel
// where denom is 1, else the mean of its denom x denom box, clipped at the
// ragged edge, rounded to nearest.
__device__ __forceinline__ void scaled_px(const Desc& d, int x, int y,
                                          int* out) {
  if (d.denom == 1) {
    const uint8_t* p = d.src + (size_t)y * d.pitch + (size_t)x * 3;
    out[0] = p[0];
    out[1] = p[1];
    out[2] = p[2];
    return;
  }
  int xs = x * d.denom, ys = y * d.denom;
  int xe = min(xs + d.denom, d.W), ye = min(ys + d.denom, d.H);
  int s0 = 0, s1 = 0, s2 = 0;
  for (int yy = ys; yy < ye; ++yy) {
    const uint8_t* row = d.src + (size_t)yy * d.pitch;
    for (int xx = xs; xx < xe; ++xx) {
      s0 += row[xx * 3];
      s1 += row[xx * 3 + 1];
      s2 += row[xx * 3 + 2];
    }
  }
  int cnt = (xe - xs) * (ye - ys);
  out[0] = (s0 + cnt / 2) / cnt;
  out[1] = (s1 + cnt / 2) / cnt;
  out[2] = (s2 + cnt / 2) / cnt;
}

// One output coordinate of Resize (image_decode.cc:91-118): the two source
// indices and the weight, each operation as the C++ rounds it.
struct Tap {
  int i0, i1;
  float w;
};

__device__ __forceinline__ Tap tap(int o, int src_len, int dst_len) {
  float s = __fdiv_rn((float)src_len, (float)dst_len);
  float f = __fsub_rn(__fmul_rn(__fadd_rn((float)o, 0.5f), s), 0.5f);
  Tap t;
  t.i0 = max(0, (int)floorf(f));
  t.i1 = min(src_len - 1, t.i0 + 1);
  t.w = __fsub_rn(f, (float)t.i0);
  if (t.w < 0.f) t.w = 0.f;
  return t;
}

// v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx)
//   + v11 * wy * wx, then (uint8)(v + 0.5f)
__device__ __forceinline__ int blend(int v00, int v01, int v10, int v11,
                                     float wy, float wx) {
  float ay = __fsub_rn(1.f, wy), ax = __fsub_rn(1.f, wx);
  float a = __fmul_rn(__fmul_rn((float)v00, ay), ax);
  float b = __fmul_rn(__fmul_rn((float)v01, ay), wx);
  float c = __fmul_rn(__fmul_rn((float)v10, wy), ax);
  float e = __fmul_rn(__fmul_rn((float)v11, wy), wx);
  float v = __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), e);
  return (int)(unsigned char)(int)__fadd_rn(v, 0.5f);
}

// Stage (b): the resize-short image's pixel (x, y).
__device__ __forceinline__ void short_px(const Desc& d, int x, int y,
                                         int* out) {
  if (d.nw == d.w1 && d.nh == d.h1) {
    scaled_px(d, x, y, out);
    return;
  }
  Tap ty = tap(y, d.h1, d.nh), tx = tap(x, d.w1, d.nw);
  int p00[3], p01[3], p10[3], p11[3];
  scaled_px(d, tx.i0, ty.i0, p00);
  scaled_px(d, tx.i1, ty.i0, p01);
  scaled_px(d, tx.i0, ty.i1, p10);
  scaled_px(d, tx.i1, ty.i1, p11);
  for (int c = 0; c < 3; ++c)
    out[c] = blend(p00[c], p01[c], p10[c], p11[c], ty.w, tx.w);
}

__global__ void image_augment_kernel(const uint8_t* __restrict__ pixels,
                                     const long long* __restrict__ desc,
                                     int out_h, int out_w, float m0,
                                     float m1, float m2, float s0, float s1,
                                     float s2, float* __restrict__ out) {
  const int img = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = out_h * out_w;
  if (pix >= plane) return;
  const long long* r = desc + (size_t)img * NDESC;
  Desc d;
  d.src = pixels + r[D_OFFSET];
  d.W = (int)r[D_W];
  d.H = (int)r[D_H];
  d.pitch = (int)r[D_PITCH];
  d.denom = (int)r[D_DENOM];
  d.w1 = (int)r[D_W1];
  d.h1 = (int)r[D_H1];
  d.nw = (int)r[D_NW];
  d.nh = (int)r[D_NH];
  d.x0 = (int)r[D_X0];
  d.y0 = (int)r[D_Y0];
  d.cw = (int)r[D_CW];
  d.ch = (int)r[D_CH];
  d.mirror = (int)r[D_MIRROR];

  const int y = pix / out_w, x = pix % out_w;
  // stage (e)'s mirror reads column out_w - 1 - x of the final image
  const int fx = d.mirror ? out_w - 1 - x : x;
  int v[3];
  if (d.cw == out_w && d.ch == out_h) {
    short_px(d, d.x0 + fx, d.y0 + y, v);            // stage (c) alone
  } else {                                           // stage (d)
    Tap ty = tap(y, d.ch, out_h), tx = tap(fx, d.cw, out_w);
    int p00[3], p01[3], p10[3], p11[3];
    short_px(d, d.x0 + tx.i0, d.y0 + ty.i0, p00);
    short_px(d, d.x0 + tx.i1, d.y0 + ty.i0, p01);
    short_px(d, d.x0 + tx.i0, d.y0 + ty.i1, p10);
    short_px(d, d.x0 + tx.i1, d.y0 + ty.i1, p11);
    for (int c = 0; c < 3; ++c)
      v[c] = blend(p00[c], p01[c], p10[c], p11[c], ty.w, tx.w);
  }
  float* o = out + (size_t)img * 3 * plane + pix;
  o[0] = __fmul_rn(__fsub_rn((float)v[0], m0), s0);
  o[plane] = __fmul_rn(__fsub_rn((float)v[1], m1), s1);
  o[2 * plane] = __fmul_rn(__fsub_rn((float)v[2], m2), s2);
}

}  // namespace

extern "C" {

// pixels: the decoded images; desc: int64 (n, 14) on the card; out: float32
// (n, 3, out_h, out_w). Launches on `stream`; returns a cudaError_t.
int image_augment_launch(const uint8_t* pixels, const long long* desc, int n,
                         int out_h, int out_w, float m0, float m1, float m2,
                         float s0, float s1, float s2, int device,
                         float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  dim3 grid((out_h * out_w + threads - 1) / threads, n);
  image_augment_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      pixels, desc, out_h, out_w, m0, m1, m2, s0, s1, s2, out);
  return (int)cudaGetLastError();
}

const char* image_augment_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
