// B6-loop: the device loop (replaces the on-device lax.while_loop of
// fantoch_tpu/engine/core.py build_runner :1591 over _lane_step, its cut
// at `until` in segment_lane_fn :1740, and the lax.scan of W segments a
// call in window_batch_fn :1860).
//
// The loop body is a CUDA graph captured by PyTorch (kernels/
// step_loop.py): G engine steps over resident state and ctx buffers (K1,
// the handler kernel, K6 and K2 each step, each cut at the control
// block's step limit), ending by writing the final state back into the
// resident buffers. This file builds the outer graph around it:
//
//   K14 (pre-loop) -> while(cond) { body (a child graph node) -> K14 }
//
// K14 (loop_ctl.cu) sets the while node's condition with
// cudaGraphSetConditional: any lane active under the limit, after moving
// the limit up the window's ladder when no lane is active but one is
// alive. One launch of the instantiated graph is one window: the host
// dispatches once and the early exit is decided on the device, as under
// the reference's vmapped while_loop. A finished batch is a fixed point:
// the pre-loop K14 finds no lane alive and no body runs.
//
// Bound on this card: the body's kernels (each its own bound); the loop
// itself adds one K14 launch a body and no host work.
#include <cuda_runtime.h>

extern "C" void* fantoch_loop_ctl_kernel();
extern "C" unsigned fantoch_loop_ctl_threads(int L);

namespace {

struct StepLoop {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

// a K14 node of `graph` after `deps` (in_body 0 before the loop, 1 at
// the end of a body)
cudaError_t add_ctl(cudaGraphNode_t* node, cudaGraph_t graph,
                    const cudaGraphNode_t* deps, size_t ndeps,
                    void* const* p, int L, int flags, int in_body,
                    cudaGraphConditionalHandle handle) {
  const void *done = p[0], *now = p[1], *err = p[2], *steps = p[3],
             *extra = p[4], *horizon = p[5], *ladder = p[6];
  void *ctl = p[7], *iters = p[8];
  void* args[] = {&done, &now,   &err, &steps, &extra,   &horizon, &ladder,
                  &ctl,  &iters, &L,   &flags, &in_body, &handle};
  cudaKernelNodeParams kp = {};
  kp.func = fantoch_loop_ctl_kernel();
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(fantoch_loop_ctl_threads(L));
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &kp);
}

// The outer graph of `loop` around `body`; `*stage` names the step that
// failed.
cudaError_t build_outer(StepLoop* loop, void* body, void* const* p, int L,
                        int flags, int* stage) {
  cudaError_t e;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t pre, cond, child, post;
  cudaGraphNodeParams cp = {};
  *stage = 1;
  if ((e = cudaGraphCreate(&loop->graph, 0))) return e;
  *stage = 2;
  if ((e = cudaGraphConditionalHandleCreate(&handle, loop->graph, 0, 0)))
    return e;
  *stage = 3;
  if ((e = add_ctl(&pre, loop->graph, nullptr, 0, p, L, flags, 0, handle)))
    return e;
  *stage = 4;
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  if ((e = cudaGraphAddNode(&cond, loop->graph, &pre, 1, &cp))) return e;
  *stage = 5;
  cudaGraph_t inner = cp.conditional.phGraph_out[0];
  if ((e = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0,
                                      (cudaGraph_t)body)))
    return e;
  *stage = 6;
  if ((e = add_ctl(&post, inner, &child, 1, p, L, flags, 1, handle)))
    return e;
  *stage = 7;
  return cudaGraphInstantiate(&loop->exec, loop->graph, 0);
}

}  // namespace

// Builds and instantiates the outer graph around `body` (a cudaGraph_t,
// cloned into the while node's body) and stores its handle in *out.
// `ptrs`: K14's nine pointers (the resident done_time, now, err and
// steps, ctx extra_time and fault_horizon, the ladder, the control
// block, the body counter). Returns 0, or the cudaError_t plus 1000
// times the failing stage.
extern "C" int fantoch_step_loop_build(void* body, const void* ptrs, int L,
                                       int flags, void* out) {
  StepLoop* loop = new StepLoop{};
  int stage = 0;
  cudaError_t e = build_outer(loop, body, (void* const*)ptrs, L, flags,
                              &stage);
  if (e != cudaSuccess) {
    if (loop->graph) cudaGraphDestroy(loop->graph);
    delete loop;
    return 1000 * stage + (int)e;
  }
  *(StepLoop**)out = loop;
  return 0;
}

// One window: launches the instantiated graph on `stream`.
extern "C" int fantoch_step_loop_launch(void* loop, void* stream) {
  return (int)cudaGraphLaunch(((StepLoop*)loop)->exec, (cudaStream_t)stream);
}

extern "C" int fantoch_step_loop_destroy(void* loop) {
  StepLoop* l = (StepLoop*)loop;
  cudaError_t e = cudaGraphExecDestroy(l->exec);
  cudaError_t f = cudaGraphDestroy(l->graph);
  delete l;
  return (int)(e ? e : f);
}
