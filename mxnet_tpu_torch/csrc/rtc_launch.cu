// The launch call of mx.rtc.Rtc (mxnet_tpu_torch/rtc.py): cuLaunchKernel
// behind one C function of five pointer arguments.
//
// Rtc.push is host-bound: a user kernel's device work is a few microseconds
// at most shapes, and its cost is the wrapper's Python. Calling
// cuLaunchKernel through ctypes converts eleven arguments on every push;
// this entry point takes the function, its context, a (grid, block) array
// made once per launch shape, the stream and the kernelParams array, so
// ctypes converts five pointers. It makes the function's context current
// in the calling thread where another one is (a thread that never touched
// CUDA has none; another library may have set its own), launches on the
// given stream with no dynamic shared memory, and returns the CUresult.
//
// The driver calls are resolved through the runtime's
// cudaGetDriverEntryPointByVersion (cudaGetDriverEntryPoint before CUDA
// 12.5), as csrc/matmul_stats.cu resolves its driver calls: no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

typedef CUresult (*LaunchFn)(CUfunction, unsigned, unsigned, unsigned,
                             unsigned, unsigned, unsigned, unsigned, CUstream,
                             void**, void**);
typedef CUresult (*GetCtxFn)(CUcontext*);
typedef CUresult (*SetCtxFn)(CUcontext);

void* entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &fn, 12000,
                                                   cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q);
#endif
  return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? fn
                                                                : nullptr;
}

struct Driver {
  GetCtxFn get_ctx = (GetCtxFn)entry("cuCtxGetCurrent");
  SetCtxFn set_ctx = (SetCtxFn)entry("cuCtxSetCurrent");
  LaunchFn launch = (LaunchFn)entry("cuLaunchKernel");
};

}  // namespace

extern "C" {

// dims: grid x, y, z then block x, y, z. Returns a CUresult (0 on success).
int rtc_launch(void* fn, void* ctx, const unsigned* dims, void* stream,
               void** params) {
  static const Driver drv{};
  if (!drv.get_ctx || !drv.set_ctx || !drv.launch)
    return (int)CUDA_ERROR_NOT_FOUND;
  CUcontext cur = nullptr;
  CUresult r = drv.get_ctx(&cur);
  if (r == CUDA_SUCCESS && cur != (CUcontext)ctx)
    r = drv.set_ctx((CUcontext)ctx);
  if (r != CUDA_SUCCESS) return (int)r;
  return (int)drv.launch((CUfunction)fn, dims[0], dims[1], dims[2], dims[3],
                         dims[4], dims[5], 0, (CUstream)stream, params,
                         nullptr);
}

}  // extern "C"
