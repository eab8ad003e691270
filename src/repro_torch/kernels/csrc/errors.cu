// Error text for the cudaError_t codes the launchers return, and an empty
// kernel: its time in a CUDA graph is the launch floor of every kernel here.
#include <cuda_runtime.h>

extern "C" const char* repro_torch_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

__global__ void empty_kernel() {}

extern "C" int empty_launch(cudaStream_t stream) {
    empty_kernel<<<1, 32, 0, stream>>>();
    return (int)cudaGetLastError();
}
