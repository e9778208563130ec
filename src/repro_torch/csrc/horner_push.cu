// One Horner step of the SLING single-source push for Hopper (sm_90a):
//
//     out[v, b] = seed_l[v, b] + sum_{e in I(v)} w_e * prune_tau(x[src_e, b])
//
// Replaces the TPU kernel src/repro/kernels/horner_push/horner_push.py
// (_step_kernel / horner_step), which lands messages on destination
// blocks with a one-hot MXU matmul and builds the seed with a masked
// one-hot sum over the packed row.
//
// What bounds it on the H100: the step reads the frontier x (n, B)
// through the in-edge gather and writes out (n, B); the work per edge
// is one compare and one FMA, so the bytes bound it -- a few MB per
// step, about a microsecond -- and in practice the latency of the
// longest dependent chain and of the launch itself (l_max + 1 launches
// per batch). The design:
//   * pull, not push: edges are in CSR over destinations (in_ptr /
//     in_idx; the graph's edge_dst is sorted), so each output (v, b) is
//     summed by threads of one block in a fixed order -- no atomics, the
//     same result on every run -- and the prune is applied as each
//     x[u, b] is read;
//   * light nodes (in-degree <= the layout's split): one thread per
//     output (v, b), walking I(v) in edge order; thread t -> (v = t / B,
//     b = t % B), so the B lanes of one node read one contiguous row of
//     x (32 bytes at B = 8) and write one row of out;
//   * heavy nodes (the hubs of a power-law graph, in-degree in the
//     hundreds): one block per node, so a hub does not serialise one
//     thread for the whole step. Thread (slot, b) strides I(v) by the
//     slot count; the partial sums meet in shared memory and are added
//     slot by slot in a fixed order;
//   * the seed needs no one-hot: each packed row is sorted by key =
//     l*n + k, so a binary search for l*n + v finds the run of equal
//     keys, and summing its contrib (vals * d_k, prepared once per batch
//     by the Horner loop) adds duplicate keys as the one-hot sum does.
// horner_steps_launch runs the l_max + 1 steps of a push, ping-ponging
// two (n, B) buffers.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float seed_at(const int* __restrict__ keys,
                                         const float* __restrict__ contrib,
                                         int width, int b, int key) {
  const int* row = keys + (long long)b * width;
  const float* cr = contrib + (long long)b * width;
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < key) lo = mid + 1; else hi = mid;
  }
  float s = 0.f;
  for (int j = lo; j < width && row[j] == key; ++j) s += cr[j];
  return s;
}

__device__ __forceinline__ float pull_range(const float* __restrict__ x,
                                            const int* __restrict__ in_idx,
                                            const float* __restrict__ w,
                                            int e0, int e1, int stride,
                                            int batch, int b, float tau) {
  float acc = 0.f;
  for (int e = e0; e < e1; e += stride) {
    const float xu = x[(long long)in_idx[e] * batch + b];
    if (xu > tau) acc += w[e] * xu;
  }
  return acc;
}

// blocks [0, n_heavy): one heavy node each; the rest: light outputs.
__global__ void __launch_bounds__(kThreads)
horner_step_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const int* __restrict__ in_ptr,
                   const int* __restrict__ in_idx,
                   const float* __restrict__ w,
                   const int* __restrict__ heavy, int n_heavy,
                   const int* __restrict__ light, int n_light,
                   const int* __restrict__ keys,
                   const float* __restrict__ contrib, int n, int batch,
                   int width, int level, float tau) {
  if ((int)blockIdx.x < n_heavy) {
    const int v = heavy[blockIdx.x];
    const int e0 = in_ptr[v], e1 = in_ptr[v + 1];
    const int key = level * n + v;  // < 2^31 - 1: the build checks it
    if (batch > kThreads) {  // one slot: each thread owns whole columns
      for (int b = threadIdx.x; b < batch; b += kThreads)
        out[(long long)v * batch + b] =
            pull_range(x, in_idx, w, e0, e1, 1, batch, b, tau) +
            seed_at(keys, contrib, width, b, key);
      return;
    }
    __shared__ float part[kThreads];
    const int slots = kThreads / batch;
    const int slot = threadIdx.x / batch, b = threadIdx.x % batch;
    part[threadIdx.x] =
        slot < slots ? pull_range(x, in_idx, w, e0 + slot, e1, slots,
                                  batch, b, tau)
                     : 0.f;
    __syncthreads();
    if ((int)threadIdx.x < batch) {
      float acc = 0.f;
      for (int s = 0; s < slots; ++s) acc += part[s * batch + threadIdx.x];
      out[(long long)v * batch + threadIdx.x] =
          acc + seed_at(keys, contrib, width, threadIdx.x, key);
    }
    return;
  }
  const long long t =
      (long long)(blockIdx.x - n_heavy) * kThreads + threadIdx.x;
  if (t >= (long long)n_light * batch) return;
  const int v = light[t / batch];
  const int b = (int)(t % batch);
  out[(long long)v * batch + b] =
      pull_range(x, in_idx, w, in_ptr[v], in_ptr[v + 1], 1, batch, b,
                 tau) +
      seed_at(keys, contrib, width, b, level * n + v);
}

}  // namespace

// The l_max + 1 Horner steps of one push, levels l_max .. 0, one kernel
// launch per step, ping-ponging a and b: x = a, out = b, then swap. a
// holds the starting frontier (zeros for a push); the result ends in b
// when l_max + 1 is odd, else in a. in_ptr (n+1), in_idx/w (m); heavy and
// light: the node ids of the two classes (together every node once);
// keys/contrib: (batch, width), each row sorted by key. Launching the
// steps from here costs one host call per push instead of one per step.
// Returns the first CUDA error code of the launches (0 if none).
extern "C" int horner_steps_launch(float* a, float* b, const int* in_ptr,
                                   const int* in_idx, const float* w,
                                   const int* heavy, int n_heavy,
                                   const int* light, int n_light,
                                   const int* keys, const float* contrib,
                                   int n, int batch, int width, int l_max,
                                   float tau, cudaStream_t stream) {
  const long long light_blocks =
      ((long long)n_light * batch + kThreads - 1) / kThreads;
  const long long blocks = n_heavy + light_blocks;
  if (blocks <= 0 || batch <= 0) return 0;
  for (int level = l_max; level >= 0; --level) {
    horner_step_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        a, b, in_ptr, in_idx, w, heavy, n_heavy, light, n_light, keys,
        contrib, n, batch, width, level, tau);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* t = a;
    a = b;
    b = t;
  }
  return 0;
}
