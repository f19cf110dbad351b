// Phase markers of the training step: one empty kernel a boundary,
// <<<1, 1>>> on the caller's stream. A marker launched while the step is
// captured becomes a node of its CUDA graph, so in a profiler trace of a
// replay every kernel after a marker, up to the next, belongs to that
// marker's phase (tactile_gan_torch/utils/profiling.py PHASES; tg_mark_end
// closes the step). A layer's markers bracket a model's layer inside the
// step's phases, forward and backward (profiling.py layer_mark). The
// kernels do nothing and read no memory.
#include <cuda_runtime.h>
#include <string.h>

// The markers in the step's order, named tg_mark_<X>.
#define TG_MARKS(X)                                                        \
  X(prep) X(g_fwd) X(d_fwd) X(gp) X(d_bwd) X(d_adam) X(g_dfwd) X(g_loss)   \
  X(g_bwd) X(g_adam) X(end)

// The layers that models mark (the name each model passes to layer_mark),
// four markers a layer: tg_mark_<layer>_in, _out, _bwd_out and _bwd_in.
#define TG_LAYERS(X) X(spade)
#define TG_LAYER(X, l) X(l##_in) X(l##_out) X(l##_bwd_out) X(l##_bwd_in)

#define TG_DEFINE(n) \
  extern "C" __global__ void tg_mark_##n() {}
#define TG_DEFINE_LAYER(l) TG_LAYER(TG_DEFINE, l)
TG_MARKS(TG_DEFINE)
TG_LAYERS(TG_DEFINE_LAYER)

namespace {

struct Mark {
  const char* name;
  void (*kernel)();
};

#define TG_ENTRY(n) {"tg_mark_" #n, tg_mark_##n},
#define TG_ENTRY_LAYER(l) TG_LAYER(TG_ENTRY, l)
const Mark kMarks[] = {TG_MARKS(TG_ENTRY) TG_LAYERS(TG_ENTRY_LAYER)};

}  // namespace

// Launches the marker named `name` on `stream`; returns the launch's
// cudaError_t, or cudaErrorInvalidDeviceFunction for an unknown name.
extern "C" int tg_mark_launch(const char* name, void* stream) {
  for (const Mark& m : kMarks) {
    if (strcmp(m.name, name) == 0) {
      return (int)cudaLaunchKernel(reinterpret_cast<const void*>(m.kernel),
                                   dim3(1), dim3(1), nullptr, 0,
                                   static_cast<cudaStream_t>(stream));
    }
  }
  return (int)cudaErrorInvalidDeviceFunction;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
