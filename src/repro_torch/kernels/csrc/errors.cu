// Error text for the cudaError_t codes the launchers return.
#include <cuda_runtime.h>

extern "C" const char* repro_torch_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
