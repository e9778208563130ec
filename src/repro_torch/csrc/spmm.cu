// The SLING pull operator Â applied to a node-major (n, F) float32 slab,
// for Hopper (sm_90a):
//
//     out[v, f] = sum_{e in row v} w_e * x[idx_e, f]
//
// over a CSR of the operator's outputs (ptr / idx / w). Over the in-CSR
// this is the Alg-2 pull (w_e = sqrt(c)/|I(v)|); over the out-CSR with
// each edge carrying its destination's weight it is the transposed push
// of the incremental-maintenance mass scans.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell/spmv_ell.py
// (_kernel / spmm_block), which groups edges into destination blocks and
// lands each chunk of gathered messages with a one-hot MXU matmul.
//
// What bounds it on the H100: each output row reads its in-edges' rows
// of x (F * 4 bytes each, 1 KiB at F = 256) and writes one row of out;
// the work per gathered float is one FMA, so the bytes bound it: the
// slab read once (it fits the 50 MB L2 at F = 256 on a 36,692-node
// graph) plus the slab written once plus idx and w. The design:
//   * rows of a node-major slab are contiguous, so a group of lanes owns
//     one output row and each gathered row is read coalesced; each lane
//     keeps kCols column accumulators in registers, so one edge starts
//     kCols independent loads;
//   * light rows (in-degree <= the layout's split, HEAVY_DEGREE in
//     kernels/spmv_ell/ops.py): a group of G lanes
//     (G = min(32, F rounded up to a power of two)) per row, walking the
//     row's edges in order;
//   * heavy rows (the hubs of a power-law graph): one block per row, so
//     a hub does not serialise one group over hundreds of edges. Slot s
//     of kSlots sums the edges e0 + s, e0 + s + kSlots, ... in order;
//     the slot sums meet in shared memory and are added slot by slot;
//   * no atomics: for a given (row, column) the order of the sum depends
//     only on the row's edge order and on whether the row is heavy (its
//     degree) -- not on F, G or which columns share the launch. So a
//     column propagated alone gives bit for bit what it gives inside any
//     block of columns, which is what lets an incremental row repair
//     reproduce a fresh build's entries exactly.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = kThreads / 32;  // heavy rows: edge slots per block
constexpr int kCols = 8;               // column accumulators per lane

// blocks [0, n_heavy): one heavy row each; the rest: light rows, `group`
// lanes per row.
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const float* __restrict__ x, float* __restrict__ out,
            const int* __restrict__ ptr, const int* __restrict__ idx,
            const float* __restrict__ w, const int* __restrict__ heavy,
            int n_heavy, const int* __restrict__ light, int n_light,
            int F, int group) {
  if ((int)blockIdx.x < n_heavy) {
    __shared__ float part[kSlots][32 * kCols];
    const int v = heavy[blockIdx.x];
    const int e0 = ptr[v], e1 = ptr[v + 1];
    const int slot = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int f0 = 0; f0 < F; f0 += 32 * kCols) {
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
      for (int e = e0 + slot; e < e1; e += kSlots) {
        const float we = w[e];
        const float* xr = x + (long long)idx[e] * F;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int f = f0 + c * 32 + lane;
          if (f < F) acc[c] += we * xr[f];
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[slot][c * 32 + lane] = acc[c];
      __syncthreads();
      const int f = f0 + threadIdx.x;  // kThreads == 32 * kCols columns
      if (f < F) {
        float s = 0.f;
        for (int k = 0; k < kSlots; ++k) s += part[k][threadIdx.x];
        out[(long long)v * F + f] = s;
      }
      __syncthreads();
    }
    return;
  }
  const long long t =
      (long long)(blockIdx.x - n_heavy) * kThreads + threadIdx.x;
  const long long r = t / group;
  if (r >= n_light) return;
  const int lane = (int)(t % group);
  const int v = light[r];
  const int e0 = ptr[v], e1 = ptr[v + 1];
  for (int f0 = 0; f0 < F; f0 += group * kCols) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int e = e0; e < e1; ++e) {
      const float we = w[e];
      const float* xr = x + (long long)idx[e] * F;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int f = f0 + c * group + lane;
        if (f < F) acc[c] += we * xr[f];
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int f = f0 + c * group + lane;
      if (f < F) out[(long long)v * F + f] = acc[c];
    }
  }
}

}  // namespace

// out (n, F) = Â x for x (n, F), both node-major float32. ptr (n+1),
// idx / w (m): the CSR of the operator's outputs; heavy and light: the
// row ids of the two classes (together every row once). Every row of
// out is written. Returns the CUDA error code of the launch (0 if none).
extern "C" int spmm_launch(const float* x, float* out, const int* ptr,
                           const int* idx, const float* w, const int* heavy,
                           int n_heavy, const int* light, int n_light, int F,
                           cudaStream_t stream) {
  if (F <= 0 || n_heavy + n_light <= 0) return 0;
  int group = 1;
  while (group < F && group < 32) group *= 2;
  const long long light_blocks =
      ((long long)n_light * group + kThreads - 1) / kThreads;
  const long long blocks = n_heavy + light_blocks;
  spmm_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, out, ptr, idx, w, heavy, n_heavy, light, n_light, F, group);
  return (int)cudaGetLastError();
}
