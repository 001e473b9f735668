// Conditional IF and WHILE nodes for CUDA graphs captured from PyTorch.
//
// The port's fused loop keeps its stops on the device, as the JAX package's
// lax.while_loop does (utils/cuda_graph.py): the LM iteration is captured
// under an IF node and the CG's iterations under a WHILE node, whose
// conditions the device sets from bool tensors at every replay. PyTorch's
// own binding of conditional nodes is not in every release, so the port
// binds the CUDA runtime's (CUDA 12.4 or later) through this plain C
// interface.
//
// ctt_graph_begin_conditional(parent, body, pred, loop, &handle): parent is
// a stream being captured. Appends to its graph a one-thread kernel that
// sets a conditional handle from *pred and, after it, an IF node (loop = 0)
// or a WHILE node (loop = 1) on that handle; then starts capturing `body`
// into the node's body graph. Work enqueued on `body` until
// ctt_graph_end_conditional(body) runs only when *pred was true at that
// point of the replay; a WHILE body runs again as long as the condition
// that the body itself last set with ctt_graph_set_condition(body, handle,
// pred2) is true. The parent's capture goes on after the node.
//
// ctt_graph_stream_create(): a non-blocking stream of its own for the bodies
// (PyTorch's stream pool hands out its streams round-robin, so one of them
// could be the stream the parent is captured on).
//
// A handle's default value is 0 and every replay sets it before the node,
// so a body never runs on a stale condition.
//
// ctt_graph_stamp(stream, log, cursor, capacity, code): a one-thread kernel
// on `stream` (captured like any kernel) that takes the next row of `log`,
// (capacity, 2) int64, by an atomic add on *cursor and writes (code,
// %globaltimer) there; a row past `capacity` is not written, and the cursor
// then counts the stamps that found no room. The kernel runs after the work
// enqueued before it on its stream, so its time is when that work ended.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void stamp_kernel(long long* log, unsigned long long* cursor, long long capacity,
                             long long code) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    unsigned long long row = atomicAdd(cursor, 1ull);
    if (row < static_cast<unsigned long long>(capacity)) {
        log[2 * row] = code;
        log[2 * row + 1] = static_cast<long long>(now);
    }
}

}  // namespace

extern "C" int ctt_graph_stamp(void* stream, void* log, void* cursor, long long capacity,
                               long long code) {
    stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(log), static_cast<unsigned long long*>(cursor), capacity, code);
    return cudaGetLastError();
}

extern "C" int ctt_graph_set_condition(void* stream, unsigned long long handle,
                                       const void* pred) {
    set_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(pred));
    return cudaGetLastError();
}

extern "C" int ctt_graph_begin_conditional(void* parent_stream, void* body_stream,
                                           const void* pred, int loop,
                                           unsigned long long* handle_out) {
    cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
    cudaStream_t body = static_cast<cudaStream_t>(body_stream);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t num_deps = 0;
    cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &num_deps);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;

    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    *handle_out = handle;
    err = static_cast<cudaError_t>(ctt_graph_set_condition(parent_stream, handle, pred));
    if (err != cudaSuccess) return err;

    // The node goes after the kernel: the capture's current dependencies.
    err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &num_deps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
    return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                         nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int ctt_graph_end_conditional(void* body_stream) {
    cudaGraph_t graph;
    return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph);
}

extern "C" int ctt_graph_stream_create(void** stream) {
    cudaStream_t s;
    cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    *stream = s;
    return err;
}
