// One xDeepFM Compressed Interaction Network (CIN) layer for Hopper
// (sm_90a), float32:
//
//     out[b, i, d] = sum_{a, j} W[i, a, j] * xk[b, a, d] * x0[b, j, d]
//
// x0 (B, m, D), xk (B, h, D), out (B, h', D), all float32 and
// contiguous in that public layout. The weights come in as
// wt = W.permute(1, 2, 0), (h, m, h') contiguous, so that the slice of
// one `a` is an (m, h') row-major tile.
//
// Replaces the TPU kernel src/repro/kernels/cin/cin.py:37 (_kernel /
// cin_layer), which for each (batch block, d) grid cell forms the
// (BB, h*m) outer-product tile in VMEM and hits the MXU with the
// (h*m, h') weight.
//
// What bounds it on the H100: operations. The layer is a GEMM whose
// A operand is made on the fly: rows r = (b, d) (M = B*D), depth
// k = (a, j) (K = h*m, 7,800 at full width), columns i (N = h'). It
// does 2*B*D*h*m*h' float32 operations (FMA counted as two) against
// 67 TFLOP/s outside the tensor cores, no TF32; the bytes (x0, xk and
// W read once, out written once) are ~12 MB at B = 512, far below.
// The design:
//   * a block owns kBM = 128 rows x kBN = 64 output maps; each of its
//     256 threads keeps an 8 x 4 tile of float32 accumulators;
//   * the depth is walked one `a` at a time: the block forms
//     z[j][r] = xk[r, a] * x0[r, j] (m x kBM) in shared memory and loads
//     wt[a, :, i-tile] (m x kBN) beside it, then each thread does
//     m rank-1 updates of its tile with FMA. The (B, h, m, D) outer
//     product never reaches device memory, which is the point of the
//     TPU kernel too;
//   * rows r = b*D + d run along the public layout's innermost D, so
//     consecutive threads read runs of D consecutive floats of x0/xk;
//     the wt tile is read coalesced along h';
//   * every edge is masked: no B % 64 requirement (retrieval's candidate
//     count and the tests' batch sizes are arbitrary), ragged h' too;
//   * offsets are 64-bit: at the retrieval cell xk holds 2e9 floats.
// Shared memory is m * (kBM + kBN) * 4 bytes (30 KB at m = 39); above
// 48 KB the launch opts in, up to the 227 KB a block may use (m <= 302).
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;                // rows (b, d) per block
constexpr int kBN = 64;                 // output maps per block
constexpr int kTM = 8;                  // rows per thread
constexpr int kTN = 4;                  // maps per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kMaxSmem = 232448;        // per-block opt-in limit

__global__ void __launch_bounds__(kThreads)
cin_kernel(const float* __restrict__ x0, const float* __restrict__ xk,
           const float* __restrict__ wt, float* __restrict__ out,
           long long B, int m, int h, int hp, int D) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                     // [m][kBM]
  float* ws = smem + m * kBM;           // [m][kBN]
  const long long M = B * D;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int t = threadIdx.x;

  // the row this thread forms z for
  const int zr = t % kBM;
  const long long r = row0 + zr;
  const bool live = r < M;
  const long long b = live ? r / D : 0;
  const int d = live ? (int)(r - b * D) : 0;
  const float* x0_row = x0 + b * m * D + d;   // x0[b, j, d] = x0_row[j*D]
  const float* xk_row = xk + b * h * D + d;   // xk[b, a, d] = xk_row[a*D]

  const int ty = t / (kBN / kTN), tx = t % (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[i][n] = 0.f;

  for (int a = 0; a < h; ++a) {
    const float xv = live ? __ldg(xk_row + (long long)a * D) : 0.f;
    for (int j = t / kBM; j < m; j += kThreads / kBM)
      zs[j * kBM + zr] = live ? xv * __ldg(x0_row + (long long)j * D) : 0.f;
    const float* wa = wt + (long long)a * m * hp + col0;
    for (int e = t; e < m * kBN; e += kThreads) {
      const int j = e / kBN, i = e % kBN;
      ws[e] = col0 + i < hp ? __ldg(wa + (long long)j * hp + i) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float4 z0 = *reinterpret_cast<const float4*>(zs + j * kBM + ty * kTM);
      const float4 z1 = *reinterpret_cast<const float4*>(zs + j * kBM + ty * kTM + 4);
      const float4 w0 = *reinterpret_cast<const float4*>(ws + j * kBN + tx * kTN);
      const float zf[kTM] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
      const float wf[kTN] = {w0.x, w0.y, w0.z, w0.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int n = 0; n < kTN; ++n) acc[i][n] = fmaf(zf[i], wf[n], acc[i][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long ro = row0 + ty * kTM + i;
    if (ro >= M) break;
    const long long bo = ro / D;
    const int dd = (int)(ro - bo * D);
    float* orow = out + bo * hp * D + dd;      // out[b, c, d] = orow[c*D]
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      const int c = col0 + tx * kTN + n;
      if (c < hp) orow[(long long)c * D] = acc[i][n];
    }
  }
}

}  // namespace

extern "C" int cin_launch(const float* x0, const float* xk, const float* wt,
                          float* out, long long B, int m, int h, int hp,
                          int D, cudaStream_t stream) {
  const long long M = B * D;
  if (M == 0 || hp == 0) return 0;
  if (m <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * (kBM + kBN) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (hp + kBN - 1) / kBN);
  cin_kernel<<<grid, kThreads, smem, stream>>>(x0, xk, wt, out, B, m, h, hp, D);
  return (int)cudaGetLastError();
}
