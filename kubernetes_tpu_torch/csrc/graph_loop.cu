// The assignment round loop on the device: a CUDA graph whose one
// conditional WHILE node replays a captured round body until the round's
// exit test says stop.
//
// Replaces the reference's jax.lax.while_loop around the round body
// (kubernetes_tpu/ops/assign.py, _lean_rounds and _batch_impl): there the
// loop condition is evaluated on the device and the host reads the result
// once. The body graph (every kernel of one round, captured by PyTorch's
// stream capture) is cloned as a child-graph node into the WHILE node's
// body; after it, a one-thread kernel bumps the device round counter and
// sets the condition:
//   continue  <=>  cont != 0  &&  rounds < max_rounds
// where cont is the int32 the round body wrote (a round that admitted
// somebody and left somebody unplaced). The same kernel, without the bump,
// runs once upstream of the WHILE node and sets the condition for the
// first pass, so a loop that should not run does not.
//
// Bound: launch latency, not bytes or operations -- one extra 1x1 kernel
// per round. No host sync: the host enqueues the graph and returns.
//
// Needs the CUDA 12.4+ runtime (conditional nodes with child graphs in
// their bodies). Every entry point returns a cudaError_t code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void exit_test(cudaGraphConditionalHandle handle, int* rounds,
                          const int* cont, int max_rounds, int bump) {
  const int r = *rounds + bump;
  *rounds = r;
  cudaGraphSetConditional(handle, (*cont != 0 && r < max_rounds) ? 1u : 0u);
}

cudaError_t add_exit_test(cudaGraphNode_t* node, cudaGraph_t graph,
                          const cudaGraphNode_t* deps, size_t n_deps,
                          cudaGraphConditionalHandle handle, int* rounds,
                          const int* cont, int max_rounds, int bump) {
  void* args[] = {&handle, &rounds, &cont, &max_rounds, &bump};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(exit_test);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
}

}  // namespace

// Build and instantiate the loop graph around ``body`` (a cudaGraph_t the
// caller keeps alive and owns; it is cloned, not taken). ``rounds`` and
// ``cont`` are device int32 scalars the body reads or writes at fixed
// addresses. The cudaGraphExec_t is written to *exec_out (a host pointer).
extern "C" int ktt_loop_build(void* body, void* rounds, void* cont,
                              int max_rounds, void* exec_out) {
  cudaGraph_t parent = nullptr;
  cudaError_t err = cudaGraphCreate(&parent, 0);
  if (err != cudaSuccess) return err;
  int* r = static_cast<int*>(rounds);
  const int* c = static_cast<const int*>(cont);
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t init, cond, child, test;
  cudaGraphNodeParams cp = {};
  cudaGraph_t loop_body = nullptr;
  cudaGraphExec_t exec = nullptr;
  err = cudaGraphConditionalHandleCreate(&handle, parent, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) goto done;
  err = add_exit_test(&init, parent, nullptr, 0, handle, r, c, max_rounds, 0);
  if (err != cudaSuccess) goto done;
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&cond, parent, &init, nullptr, 1, &cp);
#else
  err = cudaGraphAddNode(&cond, parent, &init, 1, &cp);
#endif
  if (err != cudaSuccess) goto done;
  loop_body = cp.conditional.phGraph_out[0];
  err = cudaGraphAddChildGraphNode(&child, loop_body, nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) goto done;
  err = add_exit_test(&test, loop_body, &child, 1, handle, r, c, max_rounds,
                      1);
  if (err != cudaSuccess) goto done;
  err = cudaGraphInstantiate(&exec, parent, 0);
  if (err != cudaSuccess) goto done;
  *static_cast<cudaGraphExec_t*>(exec_out) = exec;
done:
  cudaGraphDestroy(parent);
  return err;
}

// Enqueue one run of the loop on ``stream``; returns without waiting.
extern "C" int ktt_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

// Free an executable made by ktt_loop_build.
extern "C" int ktt_loop_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}
