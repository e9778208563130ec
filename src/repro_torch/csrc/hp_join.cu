// Batched single-pair SimRank join (SLING Alg 3) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hp_join/hp_join.py
// (_kernel / hp_join), which builds the (K, K) equality mask of two
// packed rows in VMEM and contracts it against the value outer product:
//
//     s[b] = sum_ij [ku[b,i] == kv[b,j] != PAD] * vu[b,i] * vv[b,j]
//
// Values are pre-multiplied by sqrt(d_k) (ops.fold_sqrt_d), so no d
// gather happens here.
//
// What bounds it on the H100: memory. Each pair reads two rows of K
// int32 keys and K float32 values; the arithmetic is one multiply-add
// per matched key. The (K, K) mask would spend K^2 compares per pair,
// so one warp per pair instead takes entries i = lane, lane+32, ... of
// row u (coalesced loads), binary-searches row v (sorted ascending,
// PAD = INT_MAX at the end) for the run of keys equal to ku[i], adds
// vu[i] * sum(vv[run]), and the warp reduces with shuffles in a fixed
// order. The sum over the run covers duplicate keys exactly as the
// all-pairs mask does. Rows are read through the pair ids us/vs, so the
// batch's rows are never copied out first.
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 0x7fffffff;

__global__ void hp_join_kernel(const int* __restrict__ keys,
                               const float* __restrict__ vals,
                               const int* __restrict__ us,
                               const int* __restrict__ vs,
                               int batch, int width,
                               float* __restrict__ out) {
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= batch) return;  // uniform across the warp
  const int* ku = keys + (long long)us[pair] * width;
  const float* xu = vals + (long long)us[pair] * width;
  const int* kv = keys + (long long)vs[pair] * width;
  const float* xv = vals + (long long)vs[pair] * width;
  float acc = 0.f;
  for (int i = lane; i < width; i += 32) {
    const int k = ku[i];
    if (k == kPad) break;  // PAD only trails a sorted row
    int lo = 0, hi = width;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (kv[mid] < k) lo = mid + 1; else hi = mid;
    }
    float run = 0.f;
    for (int j = lo; j < width && kv[j] == k; ++j) run += xv[j];
    acc += xu[i] * run;
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[pair] = acc;
}

}  // namespace

// keys/vals: (rows, width) packed table; us/vs: (batch,) row ids;
// out: (batch,). Returns the CUDA error code of the launch.
extern "C" int hp_join_launch(const int* keys, const float* vals,
                              const int* us, const int* vs, int batch,
                              int width, float* out, cudaStream_t stream) {
  if (batch <= 0) return 0;
  const int threads = 256;  // 8 pairs per block
  const int blocks = (int)(((long long)batch * 32 + threads - 1) / threads);
  hp_join_kernel<<<blocks, threads, 0, stream>>>(keys, vals, us, vs, batch,
                                                 width, out);
  return (int)cudaGetLastError();
}
