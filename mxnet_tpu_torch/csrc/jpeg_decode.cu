// JPEG decode on the card for ImageRecordIter: host code that drives nvJPEG.
//
// The counterpart of the host route's libjpeg call (DecodeRGB,
// src/io/image_decode.cc:53-88): each JPEG of a batch is decoded at full
// size into interleaved RGB (NVJPEG_OUTPUT_RGBI), uint8 HWC, at the device
// pointer and pitch the caller gives (mxnet_tpu_torch/jpeg_decode.py puts
// the images one after another in one torch.empty buffer). The per-pixel
// stage that follows is csrc/image_augment.cu.
//
// Routes, chosen per image from its header alone (never from timing or the
// rest of the batch, so a batch decodes alike whichever worker takes it):
//  - "hardware": the H100's JPEG engines through NVJPEG_BACKEND_HARDWARE,
//    one batched call for every image nvjpegDecodeBatchedSupported accepts
//    (baseline Huffman at the subsamplings the engines take);
//  - "hybrid": the rest (progressive JPEGs, subsamplings the engines refuse)
//    one by one through nvjpegDecode on a NVJPEG_BACKEND_DEFAULT handle
//    (Huffman on the host, IDCT and colour conversion on the card).
//    nvjpegDecode returns before its work on the stream is done, and the
//    next decode overwrites what that work still reads: four threads
//    decoding batches call after call beside a busy card got 664 of 1536
//    images wrong, and with each image's stream synchronized before the
//    next decode none of 3072 (NVIDIA H100 80GB HBM3, 700.00 W). So each
//    image's decode is waited for before the next one starts; the other
//    decode threads keep the card busy meanwhile.
// An image whose header or decode nvJPEG rejects is a failed image, as one
// libjpeg rejects is on the host route.
//
// Loading: libnvjpeg is opened with dlopen at first use, from the path the
// Python side found (cuda_build's flags link no library, as
// csrc/rtc_launch.cu resolves cuLaunchKernel without -lcuda). Where <nvjpeg.h>
// is missing, the few types and entry points used here are declared below
// (nvJPEG's C interface is opaque handles, int enums and nvjpegImage_t, 4
// channel pointers and 4 pitches).
//
// Threads: the two handles are shared by the process (created once, under
// a mutex); each decoder object (jpeg_decoder_create) holds its own JPEG
// states and header parser and is used by one thread at a time. Work goes
// on the stream the caller passes.

#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

#if defined(__has_include)
#if __has_include(<nvjpeg.h>)
#include <nvjpeg.h>
#define MXT_HAVE_NVJPEG_H 1
#endif
#endif

#ifndef MXT_HAVE_NVJPEG_H
extern "C" {
typedef enum {
  NVJPEG_STATUS_SUCCESS = 0,
  NVJPEG_STATUS_NOT_INITIALIZED = 1,
  NVJPEG_STATUS_INVALID_PARAMETER = 2,
  NVJPEG_STATUS_BAD_JPEG = 3,
  NVJPEG_STATUS_JPEG_NOT_SUPPORTED = 4,
  NVJPEG_STATUS_ALLOCATOR_FAILURE = 5,
  NVJPEG_STATUS_EXECUTION_FAILED = 6,
  NVJPEG_STATUS_ARCH_MISMATCH = 7,
  NVJPEG_STATUS_INTERNAL_ERROR = 8,
  NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED = 9,
  NVJPEG_STATUS_INCOMPLETE_BITSTREAM = 10
} nvjpegStatus_t;
typedef enum {
  NVJPEG_CSS_444 = 0, NVJPEG_CSS_422 = 1, NVJPEG_CSS_420 = 2,
  NVJPEG_CSS_440 = 3, NVJPEG_CSS_411 = 4, NVJPEG_CSS_410 = 5,
  NVJPEG_CSS_GRAY = 6, NVJPEG_CSS_410V = 7, NVJPEG_CSS_UNKNOWN = -1
} nvjpegChromaSubsampling_t;
typedef enum { NVJPEG_OUTPUT_RGBI = 5 } nvjpegOutputFormat_t;
typedef enum {
  NVJPEG_BACKEND_DEFAULT = 0, NVJPEG_BACKEND_HYBRID = 1,
  NVJPEG_BACKEND_GPU_HYBRID = 2, NVJPEG_BACKEND_HARDWARE = 3
} nvjpegBackend_t;
#define NVJPEG_MAX_COMPONENT 4
typedef struct {
  unsigned char* channel[NVJPEG_MAX_COMPONENT];
  size_t pitch[NVJPEG_MAX_COMPONENT];
} nvjpegImage_t;
struct nvjpegHandle;
typedef struct nvjpegHandle* nvjpegHandle_t;
struct nvjpegJpegState;
typedef struct nvjpegJpegState* nvjpegJpegState_t;
struct nvjpegJpegStream;
typedef struct nvjpegJpegStream* nvjpegJpegStream_t;
struct nvjpegDevAllocator;
typedef struct nvjpegDevAllocator nvjpegDevAllocator_t;
struct nvjpegPinnedAllocator;
typedef struct nvjpegPinnedAllocator nvjpegPinnedAllocator_t;
}
#endif

namespace {

typedef nvjpegStatus_t (*CreateExFn)(nvjpegBackend_t, nvjpegDevAllocator_t*,
                                     nvjpegPinnedAllocator_t*, unsigned int,
                                     nvjpegHandle_t*);
typedef nvjpegStatus_t (*DestroyFn)(nvjpegHandle_t);
typedef nvjpegStatus_t (*StateCreateFn)(nvjpegHandle_t, nvjpegJpegState_t*);
typedef nvjpegStatus_t (*StateDestroyFn)(nvjpegJpegState_t);
typedef nvjpegStatus_t (*InfoFn)(nvjpegHandle_t, const unsigned char*,
                                 size_t, int*, nvjpegChromaSubsampling_t*,
                                 int*, int*);
typedef nvjpegStatus_t (*StreamCreateFn)(nvjpegHandle_t, nvjpegJpegStream_t*);
typedef nvjpegStatus_t (*StreamDestroyFn)(nvjpegJpegStream_t);
typedef nvjpegStatus_t (*StreamParseFn)(nvjpegHandle_t, const unsigned char*,
                                        size_t, int, int, nvjpegJpegStream_t);
typedef nvjpegStatus_t (*BatchedSupportedFn)(nvjpegHandle_t,
                                             nvjpegJpegStream_t, int*);
typedef nvjpegStatus_t (*BatchedInitFn)(nvjpegHandle_t, nvjpegJpegState_t,
                                        int, int, nvjpegOutputFormat_t);
typedef nvjpegStatus_t (*BatchedFn)(nvjpegHandle_t, nvjpegJpegState_t,
                                    const unsigned char* const*,
                                    const size_t*, nvjpegImage_t*,
                                    cudaStream_t);
typedef nvjpegStatus_t (*DecodeFn)(nvjpegHandle_t, nvjpegJpegState_t,
                                   const unsigned char*, size_t,
                                   nvjpegOutputFormat_t, nvjpegImage_t*,
                                   cudaStream_t);
typedef nvjpegStatus_t (*HwInfoFn)(nvjpegHandle_t, unsigned int*,
                                   unsigned int*);

struct Lib {
  void* so = nullptr;
  CreateExFn create_ex = nullptr;
  DestroyFn destroy = nullptr;
  StateCreateFn state_create = nullptr;
  StateDestroyFn state_destroy = nullptr;
  InfoFn info = nullptr;
  StreamCreateFn stream_create = nullptr;
  StreamDestroyFn stream_destroy = nullptr;
  StreamParseFn stream_parse = nullptr;
  BatchedSupportedFn batched_supported = nullptr;
  BatchedInitFn batched_init = nullptr;
  BatchedFn batched = nullptr;
  DecodeFn decode = nullptr;
  HwInfoFn hw_info = nullptr;
  nvjpegHandle_t hybrid = nullptr;    // NVJPEG_BACKEND_DEFAULT
  nvjpegHandle_t hardware = nullptr;  // NVJPEG_BACKEND_HARDWARE, or null
  int hw_status = -1;                 // nvjpegCreateEx's status for it
  unsigned hw_engines = 0, hw_cores = 0;
  char error[512] = {0};
};

std::mutex g_mu;
Lib g_lib;
bool g_tried = false;

template <typename F>
bool sym(void* so, const char* name, F* out, char* err, size_t errlen) {
  *out = reinterpret_cast<F>(dlsym(so, name));
  if (!*out) snprintf(err, errlen, "libnvjpeg has no symbol %s", name);
  return *out != nullptr;
}

// Open the library and create the shared handles once; false (with the
// reason in g_lib.error) where that fails.
bool open_lib(const char* path, int device) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_tried) return g_lib.hybrid != nullptr;
  g_tried = true;
  Lib& L = g_lib;
  L.so = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (!L.so) {
    snprintf(L.error, sizeof L.error, "dlopen(%s) failed: %s", path,
             dlerror());
    return false;
  }
  char* e = L.error;
  size_t n = sizeof L.error;
  if (!sym(L.so, "nvjpegCreateEx", &L.create_ex, e, n) ||
      !sym(L.so, "nvjpegDestroy", &L.destroy, e, n) ||
      !sym(L.so, "nvjpegJpegStateCreate", &L.state_create, e, n) ||
      !sym(L.so, "nvjpegJpegStateDestroy", &L.state_destroy, e, n) ||
      !sym(L.so, "nvjpegGetImageInfo", &L.info, e, n) ||
      !sym(L.so, "nvjpegJpegStreamCreate", &L.stream_create, e, n) ||
      !sym(L.so, "nvjpegJpegStreamDestroy", &L.stream_destroy, e, n) ||
      !sym(L.so, "nvjpegJpegStreamParse", &L.stream_parse, e, n) ||
      !sym(L.so, "nvjpegDecodeBatchedSupported", &L.batched_supported, e,
           n) ||
      !sym(L.so, "nvjpegDecodeBatchedInitialize", &L.batched_init, e, n) ||
      !sym(L.so, "nvjpegDecodeBatched", &L.batched, e, n) ||
      !sym(L.so, "nvjpegDecode", &L.decode, e, n))
    return false;
  L.hw_info = reinterpret_cast<HwInfoFn>(
      dlsym(L.so, "nvjpegGetHardwareDecoderInfo"));
  cudaError_t ce = cudaSetDevice(device);
  if (ce != cudaSuccess) {
    snprintf(L.error, sizeof L.error, "cudaSetDevice(%d): %s", device,
             cudaGetErrorString(ce));
    return false;
  }
  nvjpegStatus_t s =
      L.create_ex(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, 0, &L.hybrid);
  if (s != NVJPEG_STATUS_SUCCESS) {
    snprintf(L.error, sizeof L.error,
             "nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT) returned status %d",
             (int)s);
    L.hybrid = nullptr;
    return false;
  }
  L.hw_status = (int)L.create_ex(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr,
                                 0, &L.hardware);
  if (L.hw_status != NVJPEG_STATUS_SUCCESS) {
    L.hardware = nullptr;
  } else if (L.hw_info) {
    L.hw_info(L.hardware, &L.hw_engines, &L.hw_cores);
  }
  return true;
}

struct Decoder {
  int device = 0;
  nvjpegJpegState_t hybrid_state = nullptr;
  nvjpegJpegState_t hw_state = nullptr;
  nvjpegJpegStream_t parser = nullptr;
  std::vector<const unsigned char*> hw_data;
  std::vector<size_t> hw_len;
  std::vector<nvjpegImage_t> hw_dst;
  std::vector<int> hw_index;
};

}  // namespace

extern "C" {

void jpeg_decoder_destroy(void* p);

// A decoder for one thread at a time on `device`, or null with the reason
// in err. The first call opens `libpath` and makes the shared handles.
void* jpeg_decoder_create(const char* libpath, int device, char* err,
                          int errlen) {
  if (!open_lib(libpath, device)) {
    snprintf(err, errlen, "%s", g_lib.error);
    return nullptr;
  }
  cudaError_t ce = cudaSetDevice(device);
  if (ce != cudaSuccess) {
    snprintf(err, errlen, "cudaSetDevice(%d): %s", device,
             cudaGetErrorString(ce));
    return nullptr;
  }
  Decoder* d = new Decoder();
  d->device = device;
  nvjpegStatus_t s = g_lib.state_create(g_lib.hybrid, &d->hybrid_state);
  if (s == NVJPEG_STATUS_SUCCESS && g_lib.hardware)
    s = g_lib.stream_create(g_lib.hardware, &d->parser);
  if (s == NVJPEG_STATUS_SUCCESS && g_lib.hardware)
    s = g_lib.state_create(g_lib.hardware, &d->hw_state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    snprintf(err, errlen, "nvJPEG state creation returned status %d",
             (int)s);
    jpeg_decoder_destroy(d);
    return nullptr;
  }
  return d;
}

void jpeg_decoder_destroy(void* p) {
  Decoder* d = static_cast<Decoder*>(p);
  if (!d) return;
  if (d->hw_state) g_lib.state_destroy(d->hw_state);
  if (d->hybrid_state) g_lib.state_destroy(d->hybrid_state);
  if (d->parser) g_lib.stream_destroy(d->parser);
  delete d;
}

// What the hardware backend did at creation: its nvjpegCreateEx status (0
// when it initialised, -1 before the library was opened) and, where
// nvjpegGetHardwareDecoderInfo exists, the engines and cores it reports.
int jpeg_hardware_status(unsigned* engines, unsigned* cores) {
  std::lock_guard<std::mutex> lk(g_mu);
  *engines = g_lib.hw_engines;
  *cores = g_lib.hw_cores;
  return g_lib.hw_status;
}

// Per image: width and height (the luma's) from nvjpegGetImageInfo, the
// route (0 hardware, 1 hybrid) from the header alone, and status (0, or
// nvJPEG's status where it rejects the header). Returns the number
// rejected.
int jpeg_info(void* p, const unsigned char* const* data,
              const size_t* lengths, int n, int* widths, int* heights,
              int* route, int* status) {
  Decoder* d = static_cast<Decoder*>(p);
  int bad = 0;
  for (int i = 0; i < n; ++i) {
    int ncomp = 0, w[NVJPEG_MAX_COMPONENT] = {0}, h[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegChromaSubsampling_t css;
    nvjpegStatus_t s = g_lib.info(g_lib.hybrid, data[i], lengths[i], &ncomp,
                                  &css, w, h);
    widths[i] = w[0];
    heights[i] = h[0];
    route[i] = 1;
    if (s == NVJPEG_STATUS_SUCCESS && (w[0] <= 0 || h[0] <= 0))
      s = NVJPEG_STATUS_BAD_JPEG;
    if (s == NVJPEG_STATUS_SUCCESS && g_lib.hardware) {
      s = g_lib.stream_parse(g_lib.hardware, data[i], lengths[i], 0, 0,
                             d->parser);
      int unsupported = 1;
      if (s == NVJPEG_STATUS_SUCCESS &&
          g_lib.batched_supported(g_lib.hardware, d->parser, &unsupported) ==
              NVJPEG_STATUS_SUCCESS &&
          unsupported == 0)
        route[i] = 0;
    }
    status[i] = (int)s;
    if (s != NVJPEG_STATUS_SUCCESS) ++bad;
  }
  return bad;
}

// Decode n images to RGBI at dst[i] (row pitch pitch[i]) on `stream`:
// route 0 in one batched hardware call, route 1 one by one through the
// hybrid handle. status[i] is 0 or nvJPEG's status (a failed batched call
// marks each of its images). calls[0]/calls[1] get the hardware and hybrid
// calls made. Returns the number of failed images.
int jpeg_decode(void* p, const unsigned char* const* data,
                const size_t* lengths, int n, const int* route,
                unsigned char* const* dst, const size_t* pitch, void* stream,
                int* status, int* calls) {
  Decoder* d = static_cast<Decoder*>(p);
  calls[0] = calls[1] = 0;
  if (cudaSetDevice(d->device) != cudaSuccess) {
    for (int i = 0; i < n; ++i) status[i] = NVJPEG_STATUS_EXECUTION_FAILED;
    return n;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  d->hw_data.clear();
  d->hw_len.clear();
  d->hw_dst.clear();
  d->hw_index.clear();
  int bad = 0;
  for (int i = 0; i < n; ++i) {
    nvjpegImage_t img;
    memset(&img, 0, sizeof img);
    img.channel[0] = dst[i];
    img.pitch[0] = pitch[i];
    if (route[i] == 0 && g_lib.hardware && d->hw_state) {
      d->hw_data.push_back(data[i]);
      d->hw_len.push_back(lengths[i]);
      d->hw_dst.push_back(img);
      d->hw_index.push_back(i);
      continue;
    }
    nvjpegStatus_t s = g_lib.decode(g_lib.hybrid, d->hybrid_state, data[i],
                                    lengths[i], NVJPEG_OUTPUT_RGBI, &img, st);
    if (cudaStreamSynchronize(st) != cudaSuccess && s == NVJPEG_STATUS_SUCCESS)
      s = NVJPEG_STATUS_EXECUTION_FAILED;
    ++calls[1];
    status[i] = (int)s;
    if (s != NVJPEG_STATUS_SUCCESS) ++bad;
  }
  int m = (int)d->hw_index.size();
  if (m > 0) {
    nvjpegStatus_t s = g_lib.batched_init(g_lib.hardware, d->hw_state, m, 1,
                                          NVJPEG_OUTPUT_RGBI);
    if (s == NVJPEG_STATUS_SUCCESS)
      s = g_lib.batched(g_lib.hardware, d->hw_state, d->hw_data.data(),
                        d->hw_len.data(), d->hw_dst.data(), st);
    ++calls[0];
    for (int j = 0; j < m; ++j) {
      status[d->hw_index[j]] = (int)s;
      if (s != NVJPEG_STATUS_SUCCESS) ++bad;
    }
  }
  return bad;
}

}  // extern "C"
