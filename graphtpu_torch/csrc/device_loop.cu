// The host functions that assemble, instantiate and launch a loop of step
// functions as one CUDA graph (ops/device_loop.py): each step is captured by
// torch into a graph of its own, and the captures are nested under
// conditional WHILE and IF nodes shaped like the JAX package's nested
// lax.while_loops, then a device-to-device copy of the result. The loop
// drivers of CDLP auto (ops/active.py), WCC auto and adaptive
// (algorithms/wcc.py), SSSP auto and delta (algorithms/sssp.py), BFS auto
// and device (algorithms/bfs.py) and the fixed-point loops
// (ops/fixed_point.py) build their graphs here; each loop's route kernel
// sets the conditions from the device by cudaGraphSetConditional. No
// kernel: these run on the host only.
#include "common.cuh"

// The graph's assembly: each returns a cudaError_t as an int. Nodes are
// chained: each depends on `after` (null: none) in the same graph.

GT_EXPORT int gt_graph_new(void** graph) {
  return (int)cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

// A child-graph node running a copy of `child`.
GT_EXPORT int gt_graph_add_child(void* graph, void* after, void* child, void** node) {
  cudaGraphNode_t dep = (cudaGraphNode_t)after;
  return (int)cudaGraphAddChildGraphNode(reinterpret_cast<cudaGraphNode_t*>(node),
                                         (cudaGraph_t)graph, dep ? &dep : nullptr, dep ? 1 : 0,
                                         (cudaGraph_t)child);
}

// A WHILE (is_while) or IF node with a new conditional handle of `graph`;
// its body graph, owned by the node, comes back in *body.
GT_EXPORT int gt_graph_add_conditional(void* graph, void* after, int is_while,
                                       unsigned long long* handle, void** body, void** node) {
  cudaGraphConditionalHandle h;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, (cudaGraph_t)graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t dep = (cudaGraphNode_t)after;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(reinterpret_cast<cudaGraphNode_t*>(node), (cudaGraph_t)graph,
                       dep ? &dep : nullptr, nullptr, dep ? 1 : 0, &p);
#else
  e = cudaGraphAddNode(reinterpret_cast<cudaGraphNode_t*>(node), (cudaGraph_t)graph,
                       dep ? &dep : nullptr, dep ? 1 : 0, &p);
#endif
  if (e != cudaSuccess) return (int)e;
  *handle = (unsigned long long)h;
  *body = (void*)p.conditional.phGraph_out[0];
  return 0;
}

// A device-to-device copy node of `bytes` bytes.
GT_EXPORT int gt_graph_add_copy(void* graph, void* after, void* dst, const void* src,
                                long long bytes, void** node) {
  cudaGraphNode_t dep = (cudaGraphNode_t)after;
  return (int)cudaGraphAddMemcpyNode1D(reinterpret_cast<cudaGraphNode_t*>(node),
                                       (cudaGraph_t)graph, dep ? &dep : nullptr, dep ? 1 : 0, dst,
                                       src, (size_t)bytes, cudaMemcpyDeviceToDevice);
}

GT_EXPORT int gt_graph_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec), (cudaGraph_t)graph,
                                   0);
}

// Points a copy node of the instantiated graph at another destination.
GT_EXPORT int gt_graph_set_copy(void* exec, void* node, void* dst, const void* src,
                                long long bytes) {
  return (int)cudaGraphExecMemcpyNodeSetParams1D((cudaGraphExec_t)exec, (cudaGraphNode_t)node,
                                                 dst, src, (size_t)bytes,
                                                 cudaMemcpyDeviceToDevice);
}

GT_EXPORT int gt_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Frees an instantiated graph and the graph it came from (either may be null).
GT_EXPORT int gt_graph_free(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    const cudaError_t f = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = f;
  }
  return (int)e;
}
