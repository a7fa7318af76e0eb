// Span markers: empty one-thread kernels whose names say which stage of a
// step or a frame the device ops after them belong to.
//
// `utils/profiling.py` `span(name)` launches `bge_span_<name>` (its dots
// as underscores) on the current stream where a stage begins and
// `bge_span_end` where it ends.  Launched while a CUDA graph captures,
// they become nodes of the graph and run on every replay, so a
// `torch.profiler` trace of replays shows them in place, on the card's
// clock, between the stage's kernels: the device ops between a
// `bge_span_<x>` and the next marker are stage x's.  A marker reads and
// writes nothing, so no result depends on it.
//
// The order of kMarkers is the order of `DEVICE_SPANS` in
// `utils/profiling.py`, then `bge_span_end` (a CPU test parses both).

#include <cuda_runtime.h>

extern "C" __global__ void bge_span_physics_characters() {}
extern "C" __global__ void bge_span_physics_broadphase() {}
extern "C" __global__ void bge_span_physics_narrowphase() {}
extern "C" __global__ void bge_span_physics_solver() {}
extern "C" __global__ void bge_span_physics_integrate() {}
extern "C" __global__ void bge_span_physics_triggers() {}
extern "C" __global__ void bge_span_ecs_transforms() {}
extern "C" __global__ void bge_span_manyworld_flatten() {}
extern "C" __global__ void bge_span_manyworld_unflatten() {}
extern "C" __global__ void bge_span_render_raster() {}
extern "C" __global__ void bge_span_render_shade() {}
extern "C" __global__ void bge_span_physics_joints() {}
extern "C" __global__ void bge_span_physics_motors() {}
extern "C" __global__ void bge_span_end() {}

namespace {

typedef void (*Marker)();

const Marker kMarkers[] = {
    bge_span_physics_characters,
    bge_span_physics_broadphase,
    bge_span_physics_narrowphase,
    bge_span_physics_solver,
    bge_span_physics_integrate,
    bge_span_physics_triggers,
    bge_span_ecs_transforms,
    bge_span_manyworld_flatten,
    bge_span_manyworld_unflatten,
    bge_span_render_raster,
    bge_span_render_shade,
    bge_span_physics_joints,
    bge_span_physics_motors,
    bge_span_end,
};

const int kCount = sizeof(kMarkers) / sizeof(kMarkers[0]);

}  // namespace

// The number of markers, `bge_span_end` included.
extern "C" int bge_span_count() { return kCount; }

// Launches marker `which` (an index into kMarkers) on `stream`, one block
// of one thread; returns cudaGetLastError() as an int (0 = launched).
extern "C" int bge_span_launch(int which, void* stream) {
  if (which < 0 || which >= kCount) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kMarkers[which]), dim3(1), dim3(1),
      nullptr, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bge_span_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
