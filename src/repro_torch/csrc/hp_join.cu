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
// What bounds it on the H100: the bytes are two rows of K int32 keys
// and K float32 values a pair, about 13 KB at K = 832 -- 3.4 MB for a
// batch of 256, a microsecond at the HBM rate -- and the arithmetic is
// one multiply-add per matched key. The (K, K) mask would spend K^2
// compares a pair. What a pair waits for is the chain of dependent
// loads of a search. So one block of kThreads threads takes one pair:
//   * the block copies row v's keys and values into shared memory with
//     16-byte loads (scalar ones where K is not a multiple of 4), so a
//     search step is a shared-memory load, not a round trip to L2;
//   * thread t takes entries i = t, t + kThreads, ... of row u (one
//     coalesced load per entry) and stops at the first PAD, which only
//     trails a sorted row; it binary-searches row v (sorted ascending,
//     PAD = INT_MAX at the end) for the run of keys equal to ku[i],
//     starting from where its previous search ended, since its entries
//     ascend; it adds vu[i] * sum(vv[run]), the run summed in order.
//     The sum over the run covers duplicate keys exactly as the
//     all-pairs mask does;
//   * the block reduces in a fixed order: a shuffle tree in each warp,
//     then the warps' partials in warp order, so two launches give the
//     same bits.
// Rows are read through the pair ids us/vs, so the batch's rows are
// never copied out first. A row too wide for shared memory (above the
// card's opt-in limit, some 29,000 entries) is searched in place.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPad = 0x7fffffff;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
hp_join_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
               const int* __restrict__ us, const int* __restrict__ vs,
               int width, int staged, float* __restrict__ out) {
  // staged: 0 search row v in place, 1 copy it with 4-byte loads,
  // 2 with 16-byte loads
  extern __shared__ int4 smem[];
  __shared__ float warp_sum[kWarps];
  const int pair = blockIdx.x, tid = threadIdx.x;
  const long long ru = (long long)__ldg(us + pair) * width;
  const long long rv = (long long)__ldg(vs + pair) * width;
  const int* kv = keys + rv;
  const float* xv = vals + rv;
  if (staged) {
    int* sk = reinterpret_cast<int*>(smem);
    float* sv = reinterpret_cast<float*>(sk + ((width + 3) & ~3));
    if (staged == 2) {  // rows start 16-byte aligned
      const int4* k4 = reinterpret_cast<const int4*>(kv);
      const float4* x4 = reinterpret_cast<const float4*>(xv);
      for (int i = tid; i < width / 4; i += kThreads) {
        reinterpret_cast<int4*>(sk)[i] = __ldg(k4 + i);
        reinterpret_cast<float4*>(sv)[i] = __ldg(x4 + i);
      }
    } else {
      for (int i = tid; i < width; i += kThreads) {
        sk[i] = __ldg(kv + i);
        sv[i] = __ldg(xv + i);
      }
    }
    __syncthreads();
    kv = sk;
    xv = sv;
  }
  float acc = 0.f;
  int from = 0;  // this thread's keys ascend: each search starts here
  for (int i = tid; i < width; i += kThreads) {
    const int k = __ldg(keys + ru + i);
    if (k == kPad) break;
    int lo = from, hi = width;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (kv[mid] < k) lo = mid + 1; else hi = mid;
    }
    from = lo;
    float run = 0.f;
    for (int j = lo; j < width && kv[j] == k; ++j) run += xv[j];
    acc += __ldg(vals + ru + i) * run;
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    out[pair] = s;
  }
}

// the shared memory a block may take on this card (opt-in limit)
int smem_limit(int* bytes) {
  static int limits[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (limits[dev] == 0) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(hp_join_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit - (int)(kWarps * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    limits[dev] = limit - (int)(kWarps * sizeof(float));
  }
  *bytes = limits[dev];
  return 0;
}

}  // namespace

// keys/vals: (rows, width) packed table, rows sorted ascending with PAD
// last; us/vs: (batch,) row ids; out: (batch,). One block a pair.
// Returns the CUDA error code of the launch.
extern "C" int hp_join_launch(const int* keys, const float* vals,
                              const int* us, const int* vs, int batch,
                              int width, float* out, cudaStream_t stream) {
  if (batch <= 0) return 0;
  int limit = 0;
  const int err = smem_limit(&limit);
  if (err != 0) return err;
  const long long bytes = 8LL * ((width + 3) & ~3);
  const bool vec = width % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(vals) % 16 == 0;
  const int staged = bytes > limit ? 0 : vec ? 2 : 1;
  hp_join_kernel<<<batch, kThreads, staged ? (size_t)bytes : 0, stream>>>(
      keys, vals, us, vs, width, staged, out);
  return (int)cudaGetLastError();
}
