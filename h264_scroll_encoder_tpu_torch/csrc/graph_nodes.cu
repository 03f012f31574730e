// The nodes of a captured CUDA graph, by kind, for utils/graphs: a step's
// graph is counted once, after its capture and before it is instantiated.
#include <cuda_runtime.h>

#include <vector>

namespace {

// Adds the graph's nodes to kinds[0] kernels, [1] copies, [2] fills,
// [3] anything else; a child graph's nodes count as its own.
cudaError_t count_nodes(cudaGraph_t graph, long long* kinds) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return err;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_nodes(child, kinds);
      if (err != cudaSuccess) return err;
      continue;
    }
    kinds[type == cudaGraphNodeTypeKernel   ? 0
          : type == cudaGraphNodeTypeMemcpy ? 1
          : type == cudaGraphNodeTypeMemset ? 2
                                            : 3] += 1;
  }
  return cudaSuccess;
}

}  // namespace

// graph: a cudaGraph_t (torch.cuda.CUDAGraph(keep_graph=True)'s
// raw_cuda_graph()); kinds: 4 counts out.  Returns a cudaError_t.
extern "C" int h264t_graph_nodes(void* graph, long long* kinds) {
  for (int i = 0; i < 4; ++i) kinds[i] = 0;
  return count_nodes(static_cast<cudaGraph_t>(graph), kinds);
}
