// Conditional graph nodes: the device-side loops of a compiled call.
//
// Replaces: tpu_pathopt/qp/structured.py:275 and
// tpu_pathopt/solver/path_solver.py:387 and :511, the jax.lax.while_loop
// around the QP rounds, and the jax.lax.cond around each adaptive-rho
// refactor (structured.py:259, path_solver.py:370 and :495). No Pallas
// kernel: XLA lowers these loops to control flow on the device, so a
// jitted call is one program the host launches once and does not wait on.
//
// A compiled call of the port is one CUDA graph captured by PyTorch
// (torchutil.Segments). Each QP solve's rounds are the body of a WHILE
// node, each refactor the body of an IF node nested in it. The host adds
// such a node to the graph a stream is capturing into
// (pathopt_cond_handle, pathopt_cond_node) and captures the body on
// another stream straight into the node's body graph (pathopt_capture_to,
// pathopt_capture_end). Needs a CUDA 12.4 runtime and driver (WHILE
// nodes); pathopt_graph_versions reports both.
//
// What bounds it on the H100: the one kernel here, set_condition, reads
// one byte and sets one handle, so its cost is that of launching a graph
// node, two a QP round beside the round's K2 or K3.
//
// What the design does about it: nothing goes to the host. The round
// computes its loop test and refactor gate on the device, set_condition
// turns each into the node's condition where the body ends (WHILE) or
// right before the node (IF), and the graph runs every round without the
// host in between.
//
// Every function returns its cudaError_t (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// The graph `stream` is capturing into and the capture's current
// dependencies; cudaErrorIllegalState where the stream is not capturing.
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorIllegalState;
}

}  // namespace

extern "C" {

// The CUDA runtime this library was built against and the CUDA driver's.
int pathopt_graph_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDriverGetVersion(driver));
}

// A conditional handle of the graph `stream` is capturing into. With
// `assign_default` every launch of the graph sets it to `default_value`
// (a WHILE node's first test); otherwise a set_condition launch sets it
// before its node runs (an IF node).
int pathopt_cond_handle(void* stream, unsigned int default_value,
                        int assign_default, unsigned long long* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &graph,
                                 &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(
      &h, graph, default_value,
      assign_default ? cudaGraphCondAssignDefault : 0);
  *handle = h;
  return static_cast<int>(err);
}

// Adds a conditional node on `handle` (WHILE where `is_while`, else IF)
// after the capture's current dependencies, makes it the capture's only
// dependency, and returns its body graph, empty, for pathopt_capture_to.
int pathopt_cond_node(void* stream, unsigned long long handle, int is_while,
                      void** body) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  *body = params.conditional.phGraph_out[0];
  return static_cast<int>(err);
}

// Capture the work `stream` is given from now on into `graph` (a node's
// body), until pathopt_capture_end.
int pathopt_capture_to(void* stream, void* graph) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed));
}

int pathopt_capture_end(void* stream) {
  cudaGraph_t graph;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph));
}

// Launch set_condition: the node on `handle` runs (again) iff *flag.
int pathopt_set_condition(unsigned long long handle, const bool* flag,
                          void* stream) {
  set_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(handle, flag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
