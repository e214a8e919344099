// marks: stage marks of the query path, for the device trace. One empty
// kernel a stage, launched with one thread on the caller's stream where the
// stage begins (repro_torch/obs.py::mark). Each kernel is named for the stage
// that begins at it, so a profiler's trace of a replayed search splits its
// device time by stage: a stage runs from its mark to the next mark on the
// same stream.
//
// Replaces no TPU kernel: it exists for tracing, since the whole search is
// one graph launch to the host, and host spans cannot see inside it. Bound:
// the launch alone
// (one block of one thread, no memory touched), about a microsecond of
// device time a mark; nothing launches unless tracing is on.
#include <cuda_runtime.h>

extern "C" {

__global__ void repro_torch_mark_route() {}
__global__ void repro_torch_mark_candidates() {}
__global__ void repro_torch_mark_verify() {}
__global__ void repro_torch_mark_rescore() {}
__global__ void repro_torch_mark_end() {}

// Launch the mark of stage `stage` (the index in obs.STAGES) on `stream`;
// returns the launch's cudaError_t.
int repro_torch_mark_launch(int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: repro_torch_mark_route<<<1, 1, 0, s>>>(); break;
    case 1: repro_torch_mark_candidates<<<1, 1, 0, s>>>(); break;
    case 2: repro_torch_mark_verify<<<1, 1, 0, s>>>(); break;
    case 3: repro_torch_mark_rescore<<<1, 1, 0, s>>>(); break;
    case 4: repro_torch_mark_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Load every mark on the current device without running one (under lazy
// module loading a kernel loads at its first use, which must not fall
// inside a graph capture); returns the first cudaError_t that is not 0.
int repro_torch_marks_load() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(repro_torch_mark_route),
      reinterpret_cast<const void*>(repro_torch_mark_candidates),
      reinterpret_cast<const void*>(repro_torch_mark_verify),
      reinterpret_cast<const void*>(repro_torch_mark_rescore),
      reinterpret_cast<const void*>(repro_torch_mark_end),
  };
  cudaFuncAttributes attr;
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
