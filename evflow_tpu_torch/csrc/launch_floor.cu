// An empty kernel, launched at another kernel's grid: its device time is the
// launch floor that chip_smoke.py prints beside each kernel's time and bound
// (no kernel at that grid can take less). It replaces no TPU kernel and no
// path of the port launches it. `cluster` > 1 launches thread-block clusters
// of that many CTAs, as cluster_stats.cu does.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, empty_kernel);
  return (int)cudaGetLastError();
}
