// Thread-block clusters, shared by the kernels that spread one session over
// the blocks of a cluster (emit_device.cuh: K1 and K2/K4 past one block's
// shared memory; grid_device.cuh: K5 and K6 in row bands): the cluster
// barriers, and the host side that sizes, plans and launches such a grid.
// Everything here sits in an anonymous namespace: each translation unit
// that includes it gets its own instances.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

// The most blocks a cluster holds: 16 needs the non-portable size.
constexpr int kMaxCluster = 16;

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// The split cluster barrier: a block arrives once it reads no other block's
// shared memory any more and waits before it exits, so that no block's
// shared memory goes while another reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Opts the kernel in to `bytes` of dynamic shared memory.  A refusal is
// returned and cleared, so that the next launch's cudaGetLastError()
// reports that launch's own error.
cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Bytes of shared memory a block of `kernel` may use besides its static
// arrays, on the current device; 0 where the runtime cannot say.
size_t dynamic_smem_limit(const void* kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return (size_t)optin > attr.sharedSizeBytes ? (size_t)optin - attr.sharedSizeBytes : 0;
}

// Resident blocks per SM of `kernel` with `threads` threads and `smem`
// bytes of dynamic shared memory on the current device (after the opt-in
// the launch would make); -1 where the runtime cannot say.
int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  int blocks = 0;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return blocks;
}

cudaLaunchConfig_t cluster_config(int batch, int c, int threads, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * (unsigned)c);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Lets `kernel` launch clusters of 16 blocks, past the portable 8.
cudaError_t allow_cluster16(const void* kernel) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Clusters of c blocks of `kernel` (`threads` threads and `smem` bytes of
// dynamic shared memory a block) that the current device holds at once; 0
// where a block cannot have that memory, -1 where the runtime cannot say.
int active_clusters(const void* kernel, int c, int threads, size_t smem) {
  if (set_smem(kernel, smem) != cudaSuccess) return 0;
  if (c > 8 && allow_cluster16(kernel) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, c, threads, smem, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return clusters;
}

// Launches `kernel` over `batch` sessions on clusters of c blocks of
// `threads` threads, in one launch (cudaLaunchKernelEx with the cluster
// dimension); returns its error.  Clusters of 16 need the non-portable
// size: set at a launch outside a CUDA graph capture (a graphed step's
// eager warm-up call) or by a plan query, never during a capture, where a
// launch without it fails.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int batch, int c, int threads, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err == cudaSuccess && c > 8) {
    cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
    err = cudaStreamIsCapturing(stream, &capture);
    if (err != cudaSuccess) {
      cudaGetLastError();
    } else if (capture == cudaStreamCaptureStatusNone) {
      err = allow_cluster16((const void*)kernel);
    }
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(batch, c, threads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

// Whether c is a cluster size the launchers take (1: one block a session).
bool valid_cluster(int c) { return c == 1 || c == 2 || c == 4 || c == 8 || c == 16; }

}  // namespace
