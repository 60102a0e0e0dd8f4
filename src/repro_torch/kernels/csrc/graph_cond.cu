// Conditional nodes of CUDA graphs: the port's lax.cond, for Hopper (sm_90a).
// Plain C entry points, bound from Python with ctypes (kernels/graph_cond.py);
// each returns a cudaError_t.
//
// The JAX package's chunked loop runs K training steps in one lax.scan, and
// inside it SLU skips a residual block with a lax.cond on the device
// (src/repro/models/resnet.py, src/repro/core/slu.py).  Here the captured
// train step holds each gated block as an IF conditional node whose body
// (the block's forward, or its backward) runs only when the keep flag is
// set, and the flag is set on the device:
//
//   slu_decide       flag[i] = (force || u[i] < p[i]) ? 1 : 0, the fp32
//                    comparison of jax.random.bernoulli (uniform < p) on a
//                    uniform drawn on the host ahead of time; with a
//                    conditional handle it also sets the handle from
//                    flag[0] (cudaGraphSetConditional, on the device).  The
//                    backward's node is set by slu_decide(0, saved flag).
//
// and the host helpers build the node while a stream is being captured:
//
//   graph_cond_handle  a handle in the graph being captured on `stream`
//                      (reset to 0 at every launch of the graph);
//   graph_if_open      an IF node on that handle after the stream's current
//                      dependencies, the stream's dependencies moved onto
//                      the node, and `body_stream` capturing into the
//                      node's body graph (relaxed mode);
//   graph_if_close     ends the body's capture.
//
// Work launched on `body_stream` between open and close lands in the body.
// No TPU kernel is replaced: slu_decide is the port's own.  It reads and
// writes a few bytes; its bound is a launch (a few microseconds), and it
// exists so that no step of the chunk reads a keep probability back to the
// host.  Needs CUDA 12.4 or later, in the toolkit and in the driver
// (conditional nodes, cudaStreamBeginCaptureToGraph, and memcpy and memset
// nodes inside a conditional body).

#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12040
#error "graph_cond.cu needs CUDA 12.4 or later (conditional graph nodes)"
#endif

// CUDA 13 gave the edge-data forms the plain names
#if CUDART_VERSION >= 13000
#define GC_CAPTURE_INFO cudaStreamGetCaptureInfo
#define GC_ADD_NODE cudaGraphAddNode
#define GC_UPDATE_DEPS cudaStreamUpdateCaptureDependencies
#else
#define GC_CAPTURE_INFO cudaStreamGetCaptureInfo_v3
#define GC_ADD_NODE cudaGraphAddNode_v2
#define GC_UPDATE_DEPS cudaStreamUpdateCaptureDependencies_v2
#endif

namespace {

constexpr int kThreads = 256;

__global__ void slu_decide_kernel(const float* __restrict__ u,
                                  const float* __restrict__ p, int force,
                                  float* __restrict__ flag, long long n,
                                  cudaGraphConditionalHandle handle) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    bool keep = force || u[i] < p[i];    // a NaN p keeps nothing, as numpy
    flag[i] = keep ? 1.0f : 0.0f;
    if (i == 0 && handle) cudaGraphSetConditional(handle, keep ? 1u : 0u);
  }
}

}  // namespace

extern "C" {

int graph_cond_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e != cudaSuccess) return e;
  return cudaDriverGetVersion(driver);
}

int slu_decide(const void* u, const void* p, int force, void* flag,
               long long n, unsigned long long handle, void* stream) {
  if (n <= 0) return cudaSuccess;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  slu_decide_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)p, force, (float*)flag, n,
      (cudaGraphConditionalHandle)handle);
  return cudaGetLastError();
}

int graph_cond_handle(void* stream, unsigned long long* handle_out) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  const cudaGraphEdgeData* edges = nullptr;
  size_t n = 0;
  cudaError_t e = GC_CAPTURE_INFO((cudaStream_t)stream, &status, &id, &graph,
                                  &deps, &edges, &n);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, graph, 0,
                                       cudaGraphCondAssignDefault);
  *handle_out = (unsigned long long)h;
  return e;
}

int graph_if_open(void* stream, void* body_stream,
                  unsigned long long handle) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  const cudaGraphEdgeData* edges = nullptr;
  size_t n = 0;
  cudaError_t e = GC_CAPTURE_INFO((cudaStream_t)stream, &status, &id, &graph,
                                  &deps, &edges, &n);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = GC_ADD_NODE(&node, graph, deps, edges, n, &params);
  if (e != cudaSuccess) return e;
  e = GC_UPDATE_DEPS((cudaStream_t)stream, &node, nullptr, 1,
                     cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                       params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
}

int graph_if_close(void* body_stream) {
  cudaGraph_t body = nullptr;
  return cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

}  // extern "C"
