// One xDeepFM Compressed Interaction Network (CIN) layer for Hopper
// (sm_90a), float32 in and out, on the tensor cores:
//
//     out[b, i, d] = sum_{a, j} W[i, a, j] * xk[b, a, d] * x0[b, j, d]
//
// x0 (B, m, D), xk (B, h, D), out (B, h', D), float32 and contiguous in
// that public layout. W (h', h, m) is split first (cin_split, launched
// by the wrapper before the layer; kernels/cin/cin.py:split_weights is
// its plain version) into w2 (2, h', Kp): w2[0] = W_hi, w2[1] = W_lo,
// both exactly TF32, W = W_hi + W_lo to float32 rounding, K = h*m
// padded with zeros to Kp, a multiple of 4.
//
// Replaces the TPU kernel src/repro/kernels/cin/cin.py:37 (_kernel /
// cin_layer), which for each (batch block, d) grid cell forms the
// (BB, h*m) outer-product tile in VMEM and hits the MXU with the
// (h*m, h') weight.
//
// The layer's gradient runs here too. The reference trains through
// jax.grad of the einsum form (src/repro/models/recsys.py:95); its
// Pallas kernel has no backward. For g = dL/dout (B, h', D):
//   * dxk = the layer on (x0, g, W permuted (1, 0, 2)), cin_launch;
//   * dx0 = the layer on (xk, g, W permuted (2, 0, 1)), cin_launch: xk
//     in the x0 slot is 200 wide at layers 2-3, past the slab's m <= 123,
//     so that launch reads x0 from device memory (Mode kStream);
//   * dW = cin_wgrad_launch: the GEMM dW[i, k] = sum_r g[r, i] * z[r, k]
//     over the B*D data rows r, z formed on the fly as the layer forms
//     it, on the same consumers (Mode kWgrad), depth-split into chunks
//     that a second pass adds in chunk order (no atomics).
// Each is bound by operations, 3 * 2*B*D*h*m*h' at the TF32 rate.
//
// What bounds it on the H100: operations on the tensor cores. The
// layer is a GEMM whose A operand is made on the fly: rows r = b*D + d
// (M = B*D), depth k = a*m + j (K = h*m, walked flat, so m = 39 needs
// no padding), columns i (N = h'); A[r, k] = xk[r, a] * x0[r, j], and
// W in its public layout is already the (N, K) K-major B operand. The
// (B, h, m, D) outer product never reaches device memory.
//
// Precision (3xTF32). One TF32 pass keeps 10 mantissa bits: over
// K = 7,800 terms that errs by ~3e-4 of max |out|
// (tests/test_torch_cin_precision.py emulates it), above the port's
// bound of 2e-5 (TOL_CIN). So both operands are split, a = a_hi + a_lo
// with each part rounded to TF32 (to nearest, ties away, as cvt.rna),
// and each k8 step runs three products, always in the order a_lo*b_hi,
// a_hi*b_lo, a_hi*b_hi; the dropped a_lo*b_lo is ~2^-22 of a term. The
// tensor cores' float32 sums lose low bits as a chain of wgmma grows:
// one accumulator over all of K = 7,800 missed the bound on the card.
// So each k-tile's 12 products go into a fresh set of registers
// (scale-d = 0 on the first), which one float32 add per register then
// promotes into the unit's running sums. The bound is 3 * 2*M*K*N
// operations at 494.7 TFLOP/s.
//
// Design (warp-specialised, 384 threads a block, one block an SM):
//   * a block owns a 128-row x 200-map tile (kBM x kBN). Warpgroups 0
//     and 1 consume: warpgroup g runs wgmma.m64n200k8 on rows
//     64g..64g+63 with 100 float32 registers for the k-tile's products
//     and 100 for the running sums (setmaxnreg 224). Warpgroup 2
//     produces (setmaxnreg 56);
//   * the depth is walked in k-tiles of kBK = 32 (128 bytes of a row,
//     one 128-byte swizzle atom) through a ring of two stages. A stage
//     holds A_hi, A_lo (128 x 32) and W_hi, W_lo (200 x 32), all
//     K-major with the 128-byte swizzle that the wgmma descriptors name.
//     Per stage three mbarriers: W's two TMA boxes (thread 0 of the
//     producer counts their bytes; TMA zero-fills past h' and Kp), A
//     formed (128 producer arrivals), and the stage released (256
//     consumer arrivals after their wgmma.wait_group);
//   * producer thread pt owns row pt of the tile: it keeps the row's
//     x0 (m floats) in shared memory for the whole depth and walks
//     k = a*m + j with xk[r, a] and xk[r, a + 1] in registers, so that
//     at m >= 32 every z = xk * x0 of a k-tile is an independent read;
//     it splits z with integer rounding and stores both parts. Issued
//     from the consumers' own warps, this work would wait behind their
//     wgmma issue and serialise with the tensor cores;
//   * depth split: a work unit is (row tile, column tile, depth chunk).
//     The wrapper picks s chunks from the shapes alone
//     (cin.py:depth_split) so that a small batch still fills the card
//     (B = 512: 40 tiles x 3 chunks = 120 units on 132 SMs); each chunk
//     writes its partial sums to a scratch (s, B, h', D) and a second
//     pass adds them in chunk order. No atomics: two calls on the same
//     inputs return the same bits. Because s depends on the shapes, a
//     row's bits may depend on the batch it came in, within the bound;
//   * the grid is persistent: min(units, SMs) blocks walk the units, so
//     at 10^7 rows (retrieval, s = 1) the producer fills the next unit's
//     first stages while the consumers store the last one's sums;
//   * every edge is masked (rows past B*D, maps past h', depth past K);
//     offsets are 64-bit: at the retrieval cell xk holds 2e9 floats; a
//     barrier wait that never ends traps instead of hanging the card.
// Shared memory: a stage is 2 * 16 KB (A) + 2 * 25 KB (W) = 82 KB; two
// stages, the barriers and the x0 slab (m * 512 bytes, 19.5 KB at
// m = 39) make 185 KB at m = 39, plus 1 KB to align the swizzle atoms;
// three stages would not fit the 227 KB a block may use. The slab
// fits for m <= 123; a wider x0 is read from device memory (kStream),
// and dW's producer keeps nothing beyond the stages (166 KB).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // rows per block (two warpgroups)
constexpr int kBN = 200;                 // maps per block: wgmma n = 200
constexpr int kBK = 32;                  // depth per stage: 128 bytes
constexpr int kStages = 2;
constexpr int kThreads = 384;            // 2 consumer + 1 producer warpgroup
constexpr int kAcc = kBN / 2;            // accumulators a thread
constexpr int kABytes = kBM * kBK * 4;   // 16,384: one part of A
constexpr int kWBytes = kBN * kBK * 4;   // 25,600: one part of W
constexpr int kStage = 2 * kABytes + 2 * kWBytes;      // 83,968
constexpr int kBarBytes = 64;            // 3 mbarriers a stage, 8 bytes each
constexpr int kMaxSmem = 232448;         // per-block opt-in limit
constexpr long long kSpin = 1LL << 26;   // a wait this long is a fault

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits cvt.rna.tf32.f32 gives for a finite x, in two integer
// operations at the full issue rate
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1FFFu;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that never
// ends is a fault of the kernel: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (i > kSpin) __trap();
  }
}

// One (32 k x 200 maps x 1 part) box of w2 (Kp, hp, 2) into shared
// memory with the 128-byte swizzle, zero past h' and Kp; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_w(uint32_t dst, const CUtensorMap* map,
                                           int k, int n, int part,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n),
         "r"(part), "r"(bar)
      : "memory");
}

// K-major operand in shared memory with the 128-byte swizzle: 8-row
// atoms of 1,024 bytes (SBO), rows of 128 bytes; LBO is unused.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of the 16-byte chunk c (4 consecutive k) of row r in a
// K-major tile of 128-byte rows under the 128-byte swizzle (the layout
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((r >> 3) * 1024 + (r & 7) * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n200k8(float (&d)[kAcc], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99"
      "}, %100, %101, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// What a launch of cin_kernel computes: the layer with x0's slab in
// shared memory (m <= 123), the layer with x0 read from device memory
// (any m), or the weight gradient dW.
enum Mode { kSlab = 0, kStream = 1, kWgrad = 2 };

struct Params {
  const float* x0;
  const float* xk;
  const float* g;         // kWgrad: the output's gradient (B, hp, D)
  float* dst;             // the result (s = 1) or the (s, ...) scratch
  long long M;            // GEMM rows: B * D (layer), h * m (kWgrad)
  long long R;            // kWgrad: B * D, the depth
  long long units;        // row tiles * column tiles * s
  long long chunk_elems;  // one chunk's partial sums: B*hp*D or hp*h*m
  int m, h, hp, D, s, n_ct, tiles;
};

struct Unit {
  long long row0;
  int col0, chunk, t0, t1;   // k-tiles [t0, t1) of depth chunk `chunk`
};

__device__ __forceinline__ Unit unit_of(const Params& p, long long u) {
  Unit w;
  w.chunk = (int)(u % p.s);
  const long long tile = u / p.s;
  w.col0 = (int)(tile % p.n_ct) * kBN;
  w.row0 = tile / p.n_ct * kBM;
  w.t0 = (int)((long long)w.chunk * p.tiles / p.s);
  w.t1 = (int)((long long)(w.chunk + 1) * p.tiles / p.s);
  return w;
}

// Chunk c (4 consecutive k) of row `row` of an operand's two parts,
// hi at `base` and lo at base + part_bytes, from four z in float32:
// z_hi = tf32(z), z_lo = tf32(z - z_hi) (the difference is exact)
__device__ __forceinline__ void store_split4(uint8_t* base, int part_bytes,
                                             int row, int c,
                                             const float (&z)[4]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_bits(z[i]);
    lo[i] = tf32_bits(z[i] - __uint_as_float(hi[i]));
  }
  const uint32_t off = swz(row, c);
  *reinterpret_cast<uint4*>(base + off) =
      make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(base + part_bytes + off) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Chunk c of row pt of A_hi and A_lo in stage memory sg
__device__ __forceinline__ void store_z4(uint8_t* sg, int pt, int c,
                                         const float (&z)[4]) {
  store_split4(sg, kABytes, pt, c, z);
}

// Warpgroup 2 produces: for each k-tile it waits until both consumers
// have released the stage, starts the two TMA boxes of W (thread 0),
// and forms its row's 32 z of A_hi and A_lo (thread pt owns row pt of
// the tile, so its x0 slab column and its walk over k are its own).
// Without the slab (kSlab false: x0 too wide for shared memory beside
// the two stages) each x0[r, j] is read from device memory where z
// needs it; the row's x0 is reused h times a unit, so L1 and L2 serve
// most of those reads.
template <bool kSlab>
__device__ __forceinline__ void produce(const CUtensorMap* wmap,
                                        const Params& p, uint8_t* smem,
                                        uint32_t s_base, uint32_t bars,
                                        float* x0s, int pt) {
  int st = 0;
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u);
    const long long r = w.row0 + pt;
    const bool live = r < p.M;
    const long long b = live ? r / p.D : 0;
    const int d = live ? (int)(r - b * p.D) : 0;
    const float* x0_row = p.x0 + b * p.m * p.D + d;   // x0[b, j, d]
    const float* xk_row = p.xk + b * p.h * p.D + d;   // xk[b, a, d]
    // xk[r, a], 0 past h (then z = 0 past K) and for rows past M
    auto xk_at = [&](int aa) {
      return live && aa < p.h ? __ldg(xk_row + (long long)aa * p.D) : 0.f;
    };
    // x0[r, jj], 0 for rows past M
    auto x0_at = [&](int jj) {
      if constexpr (kSlab) return x0s[jj * kBM + pt];
      else return live ? __ldg(x0_row + (long long)jj * p.D) : 0.f;
    };
    if constexpr (kSlab)
      for (int jj = 0; jj < p.m; ++jj)
        x0s[jj * kBM + pt] = live ? __ldg(x0_row + (long long)jj * p.D) : 0.f;
    // the walk over k = a*m + j; xv = xk[r, a], xn = xk[r, a + 1] ahead
    const int k0 = w.t0 * kBK;
    int a = k0 / p.m, j = k0 - a * p.m;
    float xv = xk_at(a), xn = xk_at(a + 1);
    for (int kt = w.t0; kt < w.t1; ++kt) {
      mbar_wait(bars + 32 + 8 * st, phase ^ 1);   // the stage is free
      const uint32_t sa = s_base + st * kStage;
      if (pt == 0) {
        mbar_arrive_tx(bars + 8 * st, 2 * kWBytes);
        tma_load_w(sa + 2 * kABytes, wmap, kt * kBK, w.col0, 0, bars + 8 * st);
        tma_load_w(sa + 2 * kABytes + kWBytes, wmap, kt * kBK, w.col0, 1,
                   bars + 8 * st);
      }
      uint8_t* sg = smem + st * kStage;
      if (p.m >= kBK) {
        // a run of 32 k meets at most one new `a`: the first m - j use
        // xv, the rest xn, so every x0s read is independent
        const int split = p.m - j;
#pragma unroll
        for (int c = 0; c < kBK / 4; ++c) {
          float z[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kk = 4 * c + i;
            const bool nx = kk >= split;
            z[i] = (nx ? xn : xv) * x0_at(j + kk - (nx ? p.m : 0));
          }
          store_z4(sg, pt, c, z);
        }
        j += kBK;
        if (j >= p.m) {
          j -= p.m;
          ++a;
          xv = xn;
          xn = xk_at(a + 1);
        }
      } else {
        for (int c = 0; c < kBK / 4; ++c) {
          float z[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            z[i] = xv * x0_at(j);
            if (++j == p.m) {
              j = 0;
              ++a;
              xv = xn;
              xn = xk_at(a + 1);
            }
          }
          store_z4(sg, pt, c, z);
        }
      }
      // this thread's z stores, visible to the tensor cores' reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bars + 16 + 8 * st);
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
  }
}

// Warpgroup 2 produces the weight gradient's operands. The GEMM is
// dW[i, k] = sum_r g[r, i] * z[r, k] with z[r, k] = xk[r, a] * x0[r, j],
// k = a*m + j: rows k, columns i, depth r (the B*D data rows). For each
// depth tile of 32 r, thread pt forms A[k, r] for its row k = row0 + pt
// (a and j fixed for the unit) and B[i, r] = g[r, i] for the columns
// i = col0 + pt and col0 + pt + 128, splits both into their TF32 parts
// and stores them K-major along r, in the layout that TMA writes for
// the layer's W. Every value is 0 past K, h' or B*D. The consumers wait
// on the stage's W barrier (thread 0 arrives on it after its stores)
// and on the A barrier, which all 128 threads reach after theirs.
__device__ __forceinline__ void produce_wgrad(const Params& p, uint8_t* smem,
                                              uint32_t bars, int pt) {
  int st = 0;
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u);
    const long long k = w.row0 + pt;
    const bool klive = k < p.M;
    const int a = klive ? (int)(k / p.m) : 0;
    const int j = klive ? (int)(k - (long long)a * p.m) : 0;
    const int n0 = w.col0 + pt, n1 = w.col0 + pt + 128;
    const bool has1 = pt + 128 < kBN;
    for (int kt = w.t0; kt < w.t1; ++kt) {
      mbar_wait(bars + 32 + 8 * st, phase ^ 1);   // the stage is free
      uint8_t* sg = smem + st * kStage;
      const long long r0 = (long long)kt * kBK;
      long long b = r0 / p.D;          // data row r = b*D + d, walked
      long long d = r0 - b * p.D;
#pragma unroll 1
      for (int c = 0; c < kBK / 4; ++c) {
        float z[4], g0[4], g1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = r0 + 4 * c + e < p.R;
          z[e] = live && klive
                     ? __ldg(p.xk + (b * p.h + a) * p.D + d) *
                           __ldg(p.x0 + (b * p.m + j) * p.D + d)
                     : 0.f;
          g0[e] = live && n0 < p.hp ? __ldg(p.g + (b * p.hp + n0) * p.D + d)
                                    : 0.f;
          g1[e] = live && has1 && n1 < p.hp
                      ? __ldg(p.g + (b * p.hp + n1) * p.D + d)
                      : 0.f;
          if (++d == p.D) {
            d = 0;
            ++b;
          }
        }
        store_z4(sg, pt, c, z);
        store_split4(sg + 2 * kABytes, kWBytes, pt, c, g0);
        if (has1) store_split4(sg + 2 * kABytes, kWBytes, pt + 128, c, g1);
      }
      // this thread's stores, visible to the tensor cores' reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (pt == 0) mbar_arrive(bars + 8 * st);
      mbar_arrive(bars + 16 + 8 * st);
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
  }
}

// Warpgroups 0 and 1 consume: warpgroup g runs the 12 wgmma of each
// k-tile on rows 64g..64g+63, promotes the tile's sums into acc, and
// writes acc at the end of the unit: out[b, c, d] for row r = b*D + d
// of a layer, dW[c, r] (row r = k) of the weight gradient.
template <bool kToWgrad>
__device__ __forceinline__ void consume(const Params& p, uint32_t s_base,
                                        uint32_t bars, int wg, int t) {
  int st = 0;
  uint32_t phase = 0;
  float acc[kAcc];    // the running float32 sums of the unit
  float tacc[kAcc];   // one k-tile's products, promoted into acc
#pragma unroll
  for (int i = 0; i < kAcc; ++i) tacc[i] = 0.f;
  const int lane = t & 31, w = (t >> 5) & 3;
  for (long long u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit un = unit_of(p, u);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int kt = un.t0; kt < un.t1; ++kt) {
      mbar_wait(bars + 8 * st, phase);        // W's boxes have landed
      mbar_wait(bars + 16 + 8 * st, phase);   // A is formed
      const uint32_t sa = s_base + st * kStage;
      const uint64_t a_hi = desc_sw128(sa + wg * (kABytes / 2));
      const uint64_t a_lo = desc_sw128(sa + kABytes + wg * (kABytes / 2));
      const uint64_t w_hi = desc_sw128(sa + 2 * kABytes);
      const uint64_t w_lo = desc_sw128(sa + 2 * kABytes + kWBytes);
      fence_acc(tacc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // one k8 step is 32 bytes along a 128-byte swizzled row; the
      // first product of the tile overwrites tacc (scale-d = 0)
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        wgmma_m64n200k8(tacc, a_lo + 2 * kk, w_hi + 2 * kk, kk == 0 ? 0 : 1);
        wgmma_m64n200k8(tacc, a_hi + 2 * kk, w_lo + 2 * kk, 1);
        wgmma_m64n200k8(tacc, a_hi + 2 * kk, w_hi + 2 * kk, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(tacc);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(tacc);
      mbar_arrive(bars + 32 + 8 * st);        // the stage is read
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += tacc[i];
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
    // thread (warp w, lane) holds rows 16w + lane/4 (+8) and maps
    // 8jn + 2(lane%4) (+1) of its warpgroup's 64 x 200 tile
    float* dst = p.dst + un.chunk * p.chunk_elems;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long r = un.row0 + wg * 64 + w * 16 + (lane >> 2) + 8 * hr;
      if (r < p.M) {
        const long long b = kToWgrad ? 0 : r / p.D;
        // column c of this row lies at orow[c * stride]
        float* orow = kToWgrad ? dst + r : dst + b * p.hp * p.D + (r - b * p.D);
        const long long stride = kToWgrad ? p.M : p.D;
#pragma unroll
        for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = un.col0 + 8 * jn + 2 * (lane & 3) + e;
            if (c < p.hp) orow[(long long)c * stride] = acc[4 * jn + 2 * hr + e];
          }
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
cin_kernel(const __grid_constant__ CUtensorMap wmap, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms and TMA boxes sit on 1,024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_addr(smem);
  // mbarriers after the stages: full_w[st] at +8st (TMA bytes), full_z[st]
  // at +16+8st (128 producer threads), empty[st] at +32+8st (256
  // consumer threads)
  const uint32_t bars = s_base + kStages * kStage;
  float* x0s = reinterpret_cast<float*>(smem + kStages * kStage + kBarBytes);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 16 + 8 * st, 128);
      mbar_init(bars + 32 + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if constexpr (kMode == kWgrad)
      produce_wgrad(p, smem, bars, t - 256);
    else
      produce<kMode == kSlab>(&wmap, p, smem, s_base, bars, x0s, t - 256);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume<kMode == kWgrad>(p, s_base, bars, t >> 7, t);
  }
}

// w2[0] = W_hi, w2[1] = W_lo of W viewed as (hp, K), zero-padded to
// (hp, Kp); the same bit arithmetic as cin.py:split_weights
__global__ void cin_split(const float* __restrict__ W, float* __restrict__ w2,
                          int K, int Kp, long long n) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / Kp;
    const int k = (int)(e - i * Kp);
    uint32_t hi = 0, lo = 0;
    if (k < K) {
      const float w = W[i * K + k];
      hi = (__float_as_uint(w) + 0x1000u) & ~0x1FFFu;
      lo = (__float_as_uint(w - __uint_as_float(hi)) + 0x1000u) & ~0x1FFFu;
    }
    w2[e] = __uint_as_float(hi);
    w2[n + e] = __uint_as_float(lo);
  }
}

// out = sum over chunks c = 0..s-1 of part[c], always in that order
__global__ void cin_sum_chunks(const float* __restrict__ part,
                               float* __restrict__ out, long long n, int s) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float v = part[e];
    for (int c = 1; c < s; ++c) v += part[c * n + e];
    out[e] = v;
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no link to libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Launches cin_kernel<kMode> on min(units, SMs) blocks with `smem`
// bytes of shared memory, then, for s > 1, the chunk sum into `out`.
template <int kMode>
int run(const CUtensorMap& wmap, Params p, size_t smem, float* out,
        float* scratch, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cin_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  p.dst = p.s > 1 ? scratch : out;
  p.n_ct = (p.hp + kBN - 1) / kBN;
  p.units = (p.M + kBM - 1) / kBM * p.n_ct * p.s;
  const long long grid = p.units < sms ? p.units : sms;
  cin_kernel<kMode><<<(unsigned)grid, kThreads, smem, stream>>>(wmap, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (p.s > 1) {
    const long long n = p.chunk_elems;
    long long blocks = (n + 255) / 256;
    if (blocks > 16LL * sms) blocks = 16LL * sms;
    cin_sum_chunks<<<(unsigned)blocks, 256, 0, stream>>>(scratch, out, n,
                                                         p.s);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int cin_split_launch(const float* W, float* w2, int hp, int K,
                                cudaStream_t stream) {
  const int Kp = (K + 3) / 4 * 4;
  const long long n = (long long)hp * Kp;
  if (n == 0) return 0;
  long long blocks = (n + 255) / 256;
  if (blocks > 2048) blocks = 2048;
  cin_split<<<(unsigned)blocks, 256, 0, stream>>>(W, w2, K, Kp, n);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t, or 100000 + the CUresult of a failed tensor-map
// encoding.
// The layer. x0's slab stays in shared memory while it fits beside the
// two stages (m <= 123); a wider x0 (the input gradient of
// a 200-map layer puts its 200-wide xk in the x0 slot) is read from
// device memory instead. Returns a cudaError_t, or 100000 + the
// CUresult of a failed tensor-map encoding.
extern "C" int cin_launch(const float* x0, const float* xk, const float* w2,
                          float* out, float* scratch, long long B, int m,
                          int h, int hp, int D, int s, cudaStream_t stream) {
  const long long M = B * D;
  if (M == 0 || hp == 0) return 0;
  const int K = h * m;
  const int Kp = (K + 3) / 4 * 4;
  const int tiles = (K + kBK - 1) / kBK;
  if (m <= 0 || h <= 0 || D <= 0 || s <= 0 || s > tiles ||
      (s > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t base = kStages * kStage + kBarBytes + 1024;
  const size_t slab = base + (size_t)m * kBM * 4;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)hp, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp * 4, (cuuint64_t)hp * Kp * 4};
  const cuuint32_t box[3] = {kBK, kBN, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult cr = encode(
      &wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(w2), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return 100000 + (int)cr;
  Params p = {};
  p.x0 = x0;
  p.xk = xk;
  p.M = M;
  p.m = m;
  p.h = h;
  p.hp = hp;
  p.D = D;
  p.s = s;
  p.tiles = tiles;
  p.chunk_elems = B * hp * D;
  if (slab <= kMaxSmem) return run<kSlab>(wmap, p, slab, out, scratch, stream);
  return run<kStream>(wmap, p, base, out, scratch, stream);
}

// The weight gradient of a layer: dW[i, a, j] = sum_{b, d} g[b, i, d] *
// xk[b, a, d] * x0[b, j, d] into dw (h', h, m), for x0 (B, m, D), xk
// (B, h, D) and g (B, h', D), float32 and contiguous. The depth B*D is
// cut into s chunks (s <= its 32-row tiles) whose partial sums the
// scratch (s, h', h*m) holds for the chunk sum. Returns a cudaError_t.
extern "C" int cin_wgrad_launch(const float* x0, const float* xk,
                                const float* g, float* dw, float* scratch,
                                long long B, int m, int h, int hp, int D,
                                int s, cudaStream_t stream) {
  const long long K = (long long)h * m;
  if (K == 0 || hp == 0) return 0;
  const long long R = B * D;
  const long long tiles = (R + kBK - 1) / kBK;
  if (m <= 0 || h <= 0 || D <= 0 || s <= 0 || (R > 0 && s > tiles) ||
      tiles > 0x7fffffffLL || (s > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaMemsetAsync(dw, 0, K * hp * 4, stream);
  CUtensorMap unused = {};
  Params p = {};
  p.x0 = x0;
  p.xk = xk;
  p.g = g;
  p.M = K;
  p.R = R;
  p.m = m;
  p.h = h;
  p.hp = hp;
  p.D = D;
  p.s = s;
  p.tiles = (int)tiles;
  p.chunk_elems = K * hp;
  return run<kWgrad>(unused, p, kStages * kStage + kBarBytes + 1024, dw,
                     scratch, stream);
}
