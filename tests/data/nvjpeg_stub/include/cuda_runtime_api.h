// A stand-in for the CUDA runtime's header, with only what
// mxtpu_torch/csrc/libmxtpu_io.cc's nvJPEG codec calls: it lets a host
// without the toolkit build that codec and see it fail as it does in a
// process with no CUDA device (tests/test_torch_native.py).
#pragma once
#include <cstddef>

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorNoDevice = 100 };
typedef struct CUstream_st* cudaStream_t;
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1, cudaMemcpyDeviceToHost = 2 };
#define cudaStreamNonBlocking 0x01

cudaError_t cudaGetDeviceCount(int* count);
const char* cudaGetErrorString(cudaError_t error);
cudaError_t cudaStreamCreateWithFlags(cudaStream_t* stream, unsigned flags);
cudaError_t cudaStreamDestroy(cudaStream_t stream);
cudaError_t cudaStreamSynchronize(cudaStream_t stream);
cudaError_t cudaMalloc(void** ptr, size_t size);
cudaError_t cudaFree(void* ptr);
cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t count,
                            cudaMemcpyKind kind, cudaStream_t stream);
