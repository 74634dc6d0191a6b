// The stand-in runtime and nvJPEG behind include/: a host with no CUDA
// device. Every call fails; cudaGetDeviceCount says why, as the real
// runtime does in a process whose CUDA_VISIBLE_DEVICES is empty.
#include "cuda_runtime_api.h"
#include "nvjpeg.h"

cudaError_t cudaGetDeviceCount(int* count) {
  *count = 0;
  return cudaErrorNoDevice;
}
const char* cudaGetErrorString(cudaError_t error) {
  return error == cudaErrorNoDevice ? "no CUDA-capable device is detected"
                                    : "unknown error";
}
cudaError_t cudaStreamCreateWithFlags(cudaStream_t*, unsigned) {
  return cudaErrorNoDevice;
}
cudaError_t cudaStreamDestroy(cudaStream_t) { return cudaErrorNoDevice; }
cudaError_t cudaStreamSynchronize(cudaStream_t) { return cudaErrorNoDevice; }
cudaError_t cudaMalloc(void**, size_t) { return cudaErrorNoDevice; }
cudaError_t cudaFree(void*) { return cudaErrorNoDevice; }
cudaError_t cudaMemcpyAsync(void*, const void*, size_t, cudaMemcpyKind,
                            cudaStream_t) {
  return cudaErrorNoDevice;
}

#define FAIL { return NVJPEG_STATUS_NOT_INITIALIZED; }
nvjpegStatus_t nvjpegCreateSimple(nvjpegHandle_t*) FAIL
nvjpegStatus_t nvjpegJpegStateCreate(nvjpegHandle_t, nvjpegJpegState_t*) FAIL
nvjpegStatus_t nvjpegJpegStateDestroy(nvjpegJpegState_t) FAIL
nvjpegStatus_t nvjpegEncoderStateCreate(nvjpegHandle_t, nvjpegEncoderState_t*,
                                        cudaStream_t) FAIL
nvjpegStatus_t nvjpegEncoderStateDestroy(nvjpegEncoderState_t) FAIL
nvjpegStatus_t nvjpegEncoderParamsCreate(nvjpegHandle_t,
                                         nvjpegEncoderParams_t*,
                                         cudaStream_t) FAIL
nvjpegStatus_t nvjpegEncoderParamsDestroy(nvjpegEncoderParams_t) FAIL
nvjpegStatus_t nvjpegGetImageInfo(nvjpegHandle_t, const unsigned char*, size_t,
                                  int*, nvjpegChromaSubsampling_t*, int*,
                                  int*) FAIL
nvjpegStatus_t nvjpegDecode(nvjpegHandle_t, nvjpegJpegState_t,
                            const unsigned char*, size_t, nvjpegOutputFormat_t,
                            nvjpegImage_t*, cudaStream_t) FAIL
nvjpegStatus_t nvjpegEncoderParamsSetQuality(nvjpegEncoderParams_t, int,
                                             cudaStream_t) FAIL
nvjpegStatus_t nvjpegEncoderParamsSetOptimizedHuffman(nvjpegEncoderParams_t,
                                                      int, cudaStream_t) FAIL
nvjpegStatus_t nvjpegEncoderParamsSetSamplingFactors(
    nvjpegEncoderParams_t, nvjpegChromaSubsampling_t, cudaStream_t) FAIL
nvjpegStatus_t nvjpegEncodeImage(nvjpegHandle_t, nvjpegEncoderState_t,
                                 const nvjpegEncoderParams_t,
                                 const nvjpegImage_t*, nvjpegInputFormat_t,
                                 int, int, cudaStream_t) FAIL
nvjpegStatus_t nvjpegEncodeYUV(nvjpegHandle_t, nvjpegEncoderState_t,
                               const nvjpegEncoderParams_t,
                               const nvjpegImage_t*, nvjpegChromaSubsampling_t,
                               int, int, cudaStream_t) FAIL
nvjpegStatus_t nvjpegEncodeRetrieveBitstream(nvjpegHandle_t,
                                             nvjpegEncoderState_t,
                                             unsigned char*, size_t*,
                                             cudaStream_t) FAIL
