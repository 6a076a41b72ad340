// graph_loop: a whole search as one CUDA graph, its loop a WHILE node.
//
// The counterpart of the JAX package's compiled search: `jax.jit` of the
// search with its traversal a `lax.while_loop` (bang_tpu/models/
// traversal.py:248), whose condition `(it < max_iters) & active.any()` the
// device evaluates between iterations, so the host waits only for the
// result. Here the three parts of a search are graphs that PyTorch captured
// (models/compiled.py): the prologue (tables, entries, initial state), the
// step (one traversal iteration written into the state's own buffers, then
// the next `go` flag) and the epilogue (re-rank or worklist head). This
// file joins them:
//
//   prologue -> set(go) -> WHILE(handle) { step -> set(go) } -> epilogue
//
// `set` is a one-thread kernel that copies the device flag `go` (one byte,
// written by the captured step) into the conditional handle; the WHILE node
// runs its body again while the handle is non-zero. The captured graphs
// enter as child graph nodes (cudaGraphAddChildGraphNode clones them), so
// they keep their own device addresses: the static buffers PyTorch's
// private memory pool holds for them.
//
// A conditional body may hold kernel, memcpy, memset, empty, child graph
// and conditional nodes only (CUDA 12.4 and later), all on one device: a
// captured step made of PyTorch ops and the port's kernels, on one stream,
// is such a graph; anything else fails at build time with the CUDA error.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* go) {
  cudaGraphSetConditional(handle, *go ? 1u : 0u);
}

cudaError_t add_setter(cudaGraphNode_t* node, cudaGraph_t graph,
                       const cudaGraphNode_t* deps, size_t n_deps,
                       cudaGraphConditionalHandle* handle, const bool** go) {
  void* args[] = {handle, go};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_condition);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

}  // namespace

#define TRY(expr)                        \
  do {                                   \
    cudaError_t e_ = (expr);             \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

// Build and instantiate prologue -> WHILE{body} -> epilogue. prologue,
// body, epilogue: cudaGraph_t handles (PyTorch's raw_cuda_graph(); the
// prologue and epilogue may be null); go: device pointer to the bool flag
// the prologue and the body write last. Writes the executable graph and the
// graph it was made from (for graph_loop_destroy).
extern "C" int graph_loop_build(void* prologue, void* body, void* epilogue,
                                const void* go, void** exec_out,
                                void** graph_out) {
  cudaGraph_t g = nullptr;
  TRY(cudaGraphCreate(&g, 0));
  *graph_out = g;
  const bool* flag = static_cast<const bool*>(go);
  cudaGraphNode_t last = nullptr;
  if (prologue != nullptr) {
    TRY(cudaGraphAddChildGraphNode(&last, g, nullptr, 0,
                                   static_cast<cudaGraph_t>(prologue)));
  }
  cudaGraphConditionalHandle handle;
  TRY(cudaGraphConditionalHandleCreate(&handle, g, 0, 0));
  cudaGraphNode_t set0;
  TRY(add_setter(&set0, g, &last, last ? 1 : 0, &handle, &flag));

  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  TRY(cudaGraphAddNode(&loop, g, &set0, 1, &cp));
  cudaGraph_t loop_body = cp.conditional.phGraph_out[0];
  cudaGraphNode_t step, set1;
  TRY(cudaGraphAddChildGraphNode(&step, loop_body, nullptr, 0,
                                 static_cast<cudaGraph_t>(body)));
  TRY(add_setter(&set1, loop_body, &step, 1, &handle, &flag));

  if (epilogue != nullptr) {
    cudaGraphNode_t epi;
    TRY(cudaGraphAddChildGraphNode(&epi, g, &loop, 1,
                                   static_cast<cudaGraph_t>(epilogue)));
  }
  cudaGraphExec_t exec = nullptr;
  TRY(cudaGraphInstantiate(&exec, g, 0));
  *exec_out = exec;
  return cudaSuccess;
}

// One launch of the whole search on `stream`.
extern "C" int graph_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

// Free what graph_loop_build made (either may be null).
extern "C" int graph_loop_destroy(void* exec, void* graph) {
  if (exec != nullptr) TRY(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
  if (graph != nullptr) TRY(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
  return cudaSuccess;
}

extern "C" const char* graph_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
