// Launch marks: each entry point that launches kernels takes two CUDA
// events, null unless tracing is on (hibag_tpu_torch/utils/trace.py), and
// records them on its stream right before its first kernel and right after
// its last, so that a launch record's device time holds the kernels alone
// and not the host's time to reach them.
#pragma once

#include <cuda_runtime.h>

inline cudaError_t launch_mark(void* event, cudaStream_t stream) {
  return event ? cudaEventRecord(static_cast<cudaEvent_t>(event), stream)
               : cudaSuccess;
}
