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
//   * dx0 = cin_grad_x0_launch (cin_x0grad_kernel), the
//     contraction regrouped as a GEMM over g and a dot with xk in the
//     epilogue:
//         T[r, c]    = sum_i g[r, i] * Wt[c, i],  c = j*h8 + a,
//         dx0[r, j]  = sum_a xk[r, a] * T[r, j*h8 + a],
//     rows r = b*D + d, depth i (K = h'), columns c; Wt (m*h8, h') is W
//     permuted with h rounded up to h8, a multiple of 8, and rows a >= h
//     zero (cin_split_wx0; cin.py:split_weights_x0), g2 (B*D, h') is g
//     by rows (cin_split_g; cin.py:split_grad_rows), both in their two
//     TF32 parts and brought by TMA. The depth is h' (200), not h*h'
//     (40,000), and no column is padding;
//   * dW = cin_wgrad_launch (Mode kWgrad): the GEMM dW[i, k] = sum_r
//     g[r, i] * z[r, k] over the B*D data rows r, rows k = a*m + j,
//     depth-split into chunks that a second pass adds in chunk order
//     (no atomics). Its B operand is g transposed to (h', B*D) and split
//     by a pre-pass (cin_split_gt; cin.py:split_grad_t), so it arrives by
//     TMA like the layer's W; its A operand z = xk * x0 is formed from
//     x0 and xk depth tiles staged in shared memory by coalesced copies.
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
//   * a block owns a 128-row x 200-column tile (kBM x kBN). Warpgroups
//     0 and 1 consume: warpgroup g runs wgmma.m64n200k8 on rows
//     64g..64g+63 with 100 float32 registers for the k-tile's products
//     and 100 for the running sums (setmaxnreg 224). Warpgroup 2
//     produces (setmaxnreg 56);
//   * the depth is walked in k-tiles of kBK = 32 (128 bytes of a row,
//     one 128-byte swizzle atom) through a ring of two stages. A stage
//     holds A_hi, A_lo (128 x 32) and B_hi, B_lo (200 x 32), all
//     K-major with the 128-byte swizzle that the wgmma descriptors name.
//     Per stage three mbarriers: B's two TMA boxes (thread 0 of the
//     producer counts their bytes; TMA zero-fills past the tensor), A
//     formed (128 producer arrivals), and the stage released (256
//     consumer arrivals after their wgmma.wait_group);
//   * the layer's producer thread pt owns row pt of the tile: it keeps
//     the row's x0 (m floats) in shared memory for the whole depth and
//     walks k = a*m + j with xk[r, a] and xk[r, a + 1] in registers, so
//     that at m >= 32 every z = xk * x0 of a k-tile is an independent
//     read; it splits z with integer rounding and stores both parts.
//     Issued from the consumers' own warps, this work would wait behind
//     their wgmma issue and serialise with the tensor cores;
//   * dx0's A operand is split once by its pre-pass, since all units of
//     a row tile read the same g: split in the producer for every unit,
//     it bound the kernel (the producer warps are bound by their own
//     instruction latency, with no other warp to hide it behind). So
//     one producer thread brings A and B by TMA, and the stage's one
//     barrier counts all four boxes (82 KB).
//     A unit is (row tile, j-group): a column tile holds J = 200 / h8
//     whole j (J = 1 at h = 200, 5 at h = 39); past h8 = 200 a unit
//     walks the ceil(h8 / 200) column tiles of its one j in order. The
//     depth is h' in k-tiles of 32, and the last one issues only its
//     live k8 steps (200 = 6 x 32 + 1 x 8). Units are ordered row tile
//     first, so the units in flight share their g and xk rows in L2.
//     The epilogue multiplies each sum by xk[r, a] (read through L1/L2),
//     adds a thread's products in column order, then over the 4 threads
//     of a quad by two shuffles, and writes dx0[b, j, d]. No depth
//     split: B = 512 already gives 40 x 39 units;
//   * dW's producer stages, for each depth tile of 32 data rows, x0's
//     rows j and xk's rows a that the 128 rows k = a*m + j of its tile
//     meet (at most 128 + 2), coalesced along r by cp.async into a ring
//     of kTileBufs = 3 buffers filled 2 depth tiles ahead, and forms
//     z[k, r] = xk[r, a] * x0[r, j] from there
//     (16-byte reads, conflict-free at a 144-byte row stride); thread 0
//     brings the depth tile of gt by TMA. Every row tile of a depth
//     chunk reads the same gt tiles at about the same time, so L2
//     serves all but the first. The producer's own work a depth tile
//     (its copies, z, the split) is what bounds dW, not the MMAs;
//   * layer and dW depth split: a work unit is (row tile, column tile,
//     depth chunk). The wrapper picks s chunks from the shapes alone
//     (cin.py:depth_split) so that a small batch still fills the card
//     (B = 512: 40 tiles x 3 chunks = 120 units on 132 SMs); each chunk
//     writes its partial sums to a scratch (s, ...) and a second pass
//     adds them in chunk order. No atomics: two calls on the same
//     inputs return the same bits. Because s depends on the shapes, a
//     row's bits may depend on the batch it came in, within the bound;
//   * the grid is persistent: min(units, SMs) blocks walk the units, so
//     at 10^7 rows (retrieval, s = 1) the producer fills the next unit's
//     first stages while the consumers store the last one's sums;
//   * every edge is masked (rows past M, columns past N, depth past K);
//     offsets are 64-bit: at the retrieval cell xk holds 2e9 floats; a
//     barrier wait that never ends traps instead of hanging the card.
// Shared memory: a stage is 2 * 16 KB (A) + 2 * 25 KB (B) = 82 KB, two
// stages and the barriers 164 KB, plus 1 KB to align the swizzle atoms;
// three stages would not fit the 227 KB a block may use. Beside them:
// the layer's x0 slab (m * 512 bytes, 19.5 KB at m = 39), which fits
// for m <= 123 (a wider x0 is read from device memory, kStream); dW's
// depth-tile buffers (3 * (m + 5) rows * 144 bytes = 18.6 KB at m = 39,
// at most 3 * 130 rows, 55 KB). dx0 needs nothing beside the stages
// (165 KB).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // rows per block (two warpgroups)
constexpr int kBN = 200;                 // columns per block: wgmma n = 200
constexpr int kBK = 32;                  // depth per stage: 128 bytes
constexpr int kStages = 2;
constexpr int kThreads = 384;            // 2 consumer + 1 producer warpgroup
constexpr int kAcc = kBN / 2;            // accumulators a thread
constexpr int kABytes = kBM * kBK * 4;   // 16,384: one part of A
constexpr int kWBytes = kBN * kBK * 4;   // 25,600: one part of B
constexpr int kStage = 2 * kABytes + 2 * kWBytes;      // 83,968
constexpr int kBarBytes = 64;            // 3 mbarriers a stage, 8 bytes each
constexpr int kTRow = kBK + 4;           // dW's depth tile: floats a row
constexpr int kTileBufs = 3;             // dW's depth-tile ring
constexpr int kEpi = 13;                 // dx0's epilogue: groups a batch
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

// One box (32 k x 200 or 128 rows x 1 part) of a split operand
// (Kp, N, 2) into shared memory with the 128-byte swizzle, zero past
// the tensor; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map,
                                           int k, int n, int part,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n),
         "r"(part), "r"(bar)
      : "memory");
}

// Both parts of B's k-tile kt, columns col0.., into stage sa, counted on
// the stage's B barrier (the producer's thread 0 issues it)
__device__ __forceinline__ void tma_load_b(uint32_t sa, const CUtensorMap* map,
                                           int kt, int col0, uint32_t bar) {
  mbar_arrive_tx(bar, 2 * kWBytes);
  tma_load_box(sa + 2 * kABytes, map, kt * kBK, col0, 0, bar);
  tma_load_box(sa + 2 * kABytes + kWBytes, map, kt * kBK, col0, 1, bar);
}

// 4 bytes from device memory into shared memory, asynchronously; zeros
// where !live (nothing is read then)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(live ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the producer warpgroup's own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
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
// (any m), or the weight gradient dW; cin_x0grad_kernel runs the input
// gradient dx0.
enum Mode { kSlab = 0, kStream = 1, kWgrad = 2 };

struct Params {
  const float* x0;
  const float* xk;
  float* dst;             // the result (s = 1) or the (s, ...) scratch
  long long M;            // GEMM rows: B * D (layer, dx0), h * m (kWgrad)
  long long R;            // kWgrad: B * D, the depth
  long long units;        // row tiles * column tiles * s
  long long chunk_elems;  // one chunk's partial sums: B*hp*D or hp*h*m
  int m, h, hp, D, s, n_ct, tiles;
  int col_step;           // columns from one column tile to the next
  int h8, J, n_sub;       // dx0: h rounded up to 8; j a unit holds;
                          // column tiles a unit walks
  int stage_rows;         // kWgrad: rows of one staged depth tile
};

struct Unit {
  long long row0;
  int col0, chunk, t0, t1;   // k-tiles [t0, t1) of depth chunk `chunk`
};

// Unit u: row tiles outermost, then column tiles, then depth chunks
__device__ __forceinline__ Unit unit_of(const Params& p, long long u) {
  Unit w;
  w.chunk = (int)(u % p.s);
  const long long tile = u / p.s;
  w.col0 = (int)(tile % p.n_ct) * p.col_step;
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

// Warpgroup 2 produces the layer: for each k-tile it waits until both
// consumers have released the stage, starts the two TMA boxes of W
// (thread 0), and forms its row's 32 z of A_hi and A_lo (thread pt owns
// row pt of the tile, so its x0 slab column and its walk over k are its
// own). Without the slab (kSlab false: x0 too wide for shared memory
// beside the two stages) each x0[r, j] is read from device memory where
// z needs it; the row's x0 is reused h times a unit, so L1 and L2 serve
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
      if (pt == 0)
        tma_load_b(s_base + st * kStage, wmap, kt, w.col0, bars + 8 * st);
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

// Thread 0 of warpgroup 2 produces dx0's operands: for each k-tile it
// waits until both consumers have released the stage and brings A (the
// k-tile of g2's two parts for the tile's 128 rows) and B (Wt's two
// parts for the column tile) by TMA, all four boxes counted on the
// stage's B barrier. g2 is g split once by cin_split_g, so the 39 units
// of a row tile (h = 200) do not each split it again.
__device__ __forceinline__ void produce_x0grad(const CUtensorMap* amap,
                                               const CUtensorMap* bmap,
                                               const Params& p,
                                               uint32_t s_base,
                                               uint32_t bars) {
  const int steps = p.n_sub * p.tiles;
  int st = 0;
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u);
    for (int step = 0; step < steps; ++step) {
      const int sub = step / p.tiles, kt = step - sub * p.tiles;
      mbar_wait(bars + 32 + 8 * st, phase ^ 1);   // the stage is free
      const uint32_t sa = s_base + st * kStage, bar = bars + 8 * st;
      mbar_arrive_tx(bar, 2 * kABytes + 2 * kWBytes);
      tma_load_box(sa, amap, kt * kBK, (int)w.row0, 0, bar);
      tma_load_box(sa + kABytes, amap, kt * kBK, (int)w.row0, 1, bar);
      tma_load_box(sa + 2 * kABytes, bmap, kt * kBK, w.col0 + sub * kBN, 0,
                   bar);
      tma_load_box(sa + 2 * kABytes + kWBytes, bmap, kt * kBK,
                   w.col0 + sub * kBN, 1, bar);
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
// depth tile of 32 r the 128 producer threads copy, by cp.async into
// one of kTileBufs buffers, the x0 rows j (all m, or the 128 that the
// tile's rows meet where m > 128) and xk rows a (those of the tile's
// rows) of the depth tile kTileBufs - 1 ahead in the block's walk, lane l
// taking data row r0 + l, so a warp reads along r. After a barrier,
// thread pt forms z for its row k from its x0 and xk rows in 16-byte
// reads, splits it and stores it K-major along r, and thread 0 brings
// the tile of gt (both parts) by TMA. A second barrier keeps a buffer
// until every thread has read it. Every value is 0 past K, h' or B*D.
__device__ __forceinline__ void produce_wgrad(const CUtensorMap* gmap,
                                              const Params& p, uint8_t* smem,
                                              uint32_t s_base, uint32_t bars,
                                              float* ts, int pt) {
  const bool wide = p.m > kBM;        // x0 rows staged by the tile's rows
  const int nj = wide ? kBM : p.m;
  const int lane = pt & 31, wp = pt >> 5;
  // the copy cursor: depth tile ckt of unit cu (its row tile's first a,
  // first j and staged rows), into buffer cb
  long long cu = blockIdx.x;
  Unit cw = {};
  long long ca0 = 0;
  int cj0 = 0, crows = 0, ckt = 0, cb = 0;
  auto start_unit = [&]() {
    cw = unit_of(p, cu);
    ca0 = cw.row0 / p.m;
    cj0 = (int)(cw.row0 - ca0 * p.m);
    const long long last = (cw.row0 + kBM < p.M ? cw.row0 + kBM : p.M) - 1;
    crows = nj + (int)(last / p.m - ca0 + 1);
    ckt = cw.t0;
  };
  if (cu < p.units) start_unit();
  auto fetch_next = [&]() {
    if (cu < p.units) {
      const int r = ckt * kBK + lane;
      const bool live = r < p.R;
      const int b = live ? r / p.D : 0;
      const int d = live ? r - b * p.D : 0;
      const float* bx = p.x0 + (long long)b * p.m * p.D + d;
      const float* bk = p.xk + ((long long)b * p.h + ca0) * p.D + d;
      const uint32_t dst = smem_addr(ts + cb * p.stage_rows * kTRow + lane);
      for (int s = wp; s < crows; s += 4) {
        int jj = s;
        if (wide) {
          jj = cj0 + s;
          if (jj >= p.m) jj -= p.m;
        }
        const float* src = s < nj ? bx + (long long)jj * p.D
                                  : bk + (long long)(s - nj) * p.D;
        cp_async4(dst + 4 * s * kTRow, live ? src : p.x0, live);
      }
      cp_async_commit();
      if (++ckt == cw.t1) {
        cu += gridDim.x;
        if (cu < p.units) start_unit();
      }
    } else {
      cp_async_commit();
    }
    if (++cb == kTileBufs) cb = 0;
  };
  for (int i = 0; i < kTileBufs - 1; ++i) fetch_next();
  int st = 0, nb = 0;
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(p, u);
    const long long k = w.row0 + pt;
    const bool klive = k < p.M;
    const long long a0 = w.row0 / p.m;
    const long long a = klive ? k / p.m : a0;
    const int j = klive ? (int)(k - a * p.m) : 0;
    const int xrow = wide ? pt : j;                  // staged x0 row
    const int krow = nj + (int)(a - a0);             // staged xk row
    for (int kt = w.t0; kt < w.t1; ++kt) {
      fetch_next();
      mbar_wait(bars + 32 + 8 * st, phase ^ 1);   // the stage is free
      if (pt == 0)
        tma_load_b(s_base + st * kStage, gmap, kt, w.col0, bars + 8 * st);
      cp_async_wait<kTileBufs - 1>();
      producer_sync();                 // every copy of this tile landed
      uint8_t* sg = smem + st * kStage;
      const float* tile = ts + nb * p.stage_rows * kTRow;
      const float4* xs = reinterpret_cast<const float4*>(tile + xrow * kTRow);
      const float4* ks = reinterpret_cast<const float4*>(tile + krow * kTRow);
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) {
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        if (klive) {
          const float4 xv = xs[c], kv = ks[c];
          z[0] = kv.x * xv.x;
          z[1] = kv.y * xv.y;
          z[2] = kv.z * xv.z;
          z[3] = kv.w * xv.w;
        }
        store_z4(sg, pt, c, z);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bars + 16 + 8 * st);
      producer_sync();                 // the buffer is read: refill it
      if (++nb == kTileBufs) nb = 0;
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
  }
  cp_async_wait<0>();
}

// One k-tile's products of warpgroup wg on the stage at sa into tacc,
// kK8 k8 steps of three TF32 products each; the first product of the
// tile overwrites tacc (scale-d = 0)
template <int kK8>
__device__ __forceinline__ void mma_tile(float (&tacc)[kAcc], uint32_t sa,
                                         int wg) {
  const uint64_t a_hi = desc_sw128(sa + wg * (kABytes / 2));
  const uint64_t a_lo = desc_sw128(sa + kABytes + wg * (kABytes / 2));
  const uint64_t w_hi = desc_sw128(sa + 2 * kABytes);
  const uint64_t w_lo = desc_sw128(sa + 2 * kABytes + kWBytes);
  fence_acc(tacc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  // one k8 step is 32 bytes along a 128-byte swizzled row
#pragma unroll
  for (int kk = 0; kk < kK8; ++kk) {
    wgmma_m64n200k8(tacc, a_lo + 2 * kk, w_hi + 2 * kk, kk == 0 ? 0 : 1);
    wgmma_m64n200k8(tacc, a_hi + 2 * kk, w_lo + 2 * kk, 1);
    wgmma_m64n200k8(tacc, a_hi + 2 * kk, w_hi + 2 * kk, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(tacc);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(tacc);
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
      mbar_wait(bars + 8 * st, phase);        // B's boxes have landed
      mbar_wait(bars + 16 + 8 * st, phase);   // A is formed
      mma_tile<kBK / 8>(tacc, s_base + st * kStage, wg);
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

// Warpgroups 0 and 1 consume dx0's GEMM. Per unit (row tile, j-group)
// and column tile: the k-tiles of h' into acc as in consume (the last
// one's live k8 steps only), then the epilogue. Thread (warp w, lane)
// holds rows 16w + lane/4 (+8) and columns 8jn + 2q (+1), q = lane % 4;
// a group of 8 columns lies in one j (h8 is a multiple of 8), at
// a = its offset in j's h8 columns. The thread adds
// acc * xk[r, a] over its columns of one j in column order (across the
// column tiles of a j wider than one tile), then the quad adds its four
// sums, ((q0 + q1) + (q2 + q3)) by two shuffles, and lane q = 0 writes
// dx0[b, j, d]. The j a thread holds change together across the
// warpgroup, so the shuffles are uniform.
__device__ __forceinline__ void consume_x0grad(const Params& p,
                                               uint32_t s_base, uint32_t bars,
                                               int wg, int t) {
  int st = 0;
  uint32_t phase = 0;
  float acc[kAcc];
  float tacc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) tacc[i] = 0.f;
  const int lane = t & 31, w = (t >> 5) & 3, q = lane & 3;
  for (long long u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit un = unit_of(p, u);
    const int j0 = un.col0 / p.h8;
    const int jend = j0 + p.J < p.m ? j0 + p.J : p.m;
    // set after each column tile's k-tiles, so not live across them
    const float* xrow[2];     // xk[b, 0, d] of the thread's two rows
    long long orow[2];        // dx0[b, 0, d]
    bool live[2];
    float run[2] = {0.f, 0.f};
    int jcur = -1;
    auto flush = [&]() {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float v = run[hr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0 && live[hr]) p.dst[orow[hr] + (long long)jcur * p.D] = v;
        run[hr] = 0.f;
      }
    };
    for (int sub = 0; sub < p.n_sub; ++sub) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < p.tiles; ++kt) {
        mbar_wait(bars + 8 * st, phase);        // A's and B's boxes landed
        const uint32_t sa = s_base + st * kStage;
        const int live_k8 = (p.hp - kt * kBK + 7) / 8;
        if (live_k8 >= 4) mma_tile<4>(tacc, sa, wg);
        else if (live_k8 == 3) mma_tile<3>(tacc, sa, wg);
        else if (live_k8 == 2) mma_tile<2>(tacc, sa, wg);
        else mma_tile<1>(tacc, sa, wg);
        mbar_arrive(bars + 32 + 8 * st);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += tacc[i];
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long r = un.row0 + wg * 64 + w * 16 + (lane >> 2) + 8 * hr;
        live[hr] = r < p.M;
        const long long b = live[hr] ? r / p.D : 0;
        const long long d = live[hr] ? r - b * p.D : 0;
        xrow[hr] = p.xk + b * p.h * p.D + d;
        orow[hr] = b * p.m * p.D + d;
      }
      // the tile's 25 groups of 8 columns in batches of kEpi: a batch's
      // xk factors are all loaded before any is used, so their L2 reads
      // overlap (addresses kept inside xk, the factor 0 where masked)
      const int col0 = un.col0 + sub * kBN;
#pragma unroll
      for (int jb = 0; jb < kBN / 8; jb += kEpi) {
        float xv[kEpi][4];
        int jj[kEpi];
#pragma unroll
        for (int gi = 0; gi < kEpi && jb + gi < kBN / 8; ++gi) {
          const int c8 = col0 + 8 * (jb + gi);
          jj[gi] = c8 / p.h8;
          const int aa = c8 - jj[gi] * p.h8 + 2 * q;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int hr = f >> 1, ae = aa + (f & 1);
            const bool ok = live[hr] && jj[gi] < jend && ae < p.h;
            const float v = __ldg(xrow[hr] + (long long)(ok ? ae : 0) * p.D);
            xv[gi][f] = ok ? v : 0.f;
          }
        }
#pragma unroll
        for (int gi = 0; gi < kEpi && jb + gi < kBN / 8; ++gi) {
          if (jj[gi] < jend) {
            if (jj[gi] != jcur) {
              if (jcur >= 0) flush();
              jcur = jj[gi];
            }
            const int jn = jb + gi;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              run[hr] = fmaf(acc[4 * jn + 2 * hr + 1], xv[gi][2 * hr + 1],
                             fmaf(acc[4 * jn + 2 * hr], xv[gi][2 * hr],
                                  run[hr]));
          }
        }
      }
    }
    if (jcur >= 0) flush();
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
  // consumer threads); the mode's own buffer after them
  const uint32_t bars = s_base + kStages * kStage;
  float* extra = reinterpret_cast<float*>(smem + kStages * kStage + kBarBytes);
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
    // the consumers' setmaxnreg.inc draws on what these warps release:
    // (168 - 56) * 128 = (224 - 168) * 256 registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if constexpr (kMode == kWgrad)
      produce_wgrad(&wmap, p, smem, s_base, bars, extra, t - 256);
    else
      produce<kMode == kSlab>(&wmap, p, smem, s_base, bars, extra, t - 256);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume<kMode == kWgrad>(p, s_base, bars, t >> 7, t);
  }
}

// dx0: A and B both by TMA, so one producer thread
__global__ void __launch_bounds__(kThreads, 1)
cin_x0grad_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bars = s_base + kStages * kStage;   // full[st], empty[st]
  const int t = threadIdx.x;
  if (t == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 32 + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (t == 256) produce_x0grad(&amap, &bmap, p, s_base, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume_x0grad(p, s_base, bars, t >> 7, t);
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
      hi = tf32_bits(w);
      lo = tf32_bits(w - __uint_as_float(hi));
    }
    w2[e] = __uint_as_float(hi);
    w2[n + e] = __uint_as_float(lo);
  }
}

// dx0's B operand: wt[part][c][i] for c = j*h8 + a of the (m*h8, Kp)
// parts of W[i, a, j], zero for a >= h and i >= hp; the same bits as
// cin.py:split_weights_x0
__global__ void cin_split_wx0(const float* __restrict__ W,
                              float* __restrict__ wt, int hp, int h, int m,
                              int h8, int Kp, long long n) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long c = e / Kp;
    const int i = (int)(e - c * Kp);
    const int j = (int)(c / h8), a = (int)(c - (long long)j * h8);
    uint32_t hi = 0, lo = 0;
    if (a < h && i < hp) {
      const float w = W[((long long)i * h + a) * m + j];
      hi = tf32_bits(w);
      lo = tf32_bits(w - __uint_as_float(hi));
    }
    wt[e] = __uint_as_float(hi);
    wt[n + e] = __uint_as_float(lo);
  }
}

// dW's B operand: gt[part][i][r] of the (hp, Rp) parts of g[b, i, d],
// r = b*D + d, zero for r >= B*D; the same bits as cin.py:split_grad_t.
// Block row y is one i; consecutive threads write consecutive r.
__global__ void cin_split_gt(const float* __restrict__ g,
                             float* __restrict__ gt, int hp, int D,
                             long long R, long long Rp) {
  const long long n = (long long)hp * Rp;
  const int i = blockIdx.y;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < Rp;
       r += (long long)gridDim.x * blockDim.x) {
    uint32_t hi = 0, lo = 0;
    if (r < R) {
      const long long b = r / D;
      const float v = g[(b * hp + i) * D + (r - b * D)];
      hi = tf32_bits(v);
      lo = tf32_bits(v - __uint_as_float(hi));
    }
    const long long e = (long long)i * Rp + r;
    gt[e] = __uint_as_float(hi);
    gt[n + e] = __uint_as_float(lo);
  }
}

// dx0's A operand: g2[part][r][i] of the (B*D, Kp) parts of g[b, i, d],
// r = b*D + d, zero for i >= hp; the same bits as cin.py:split_grad_rows.
// A 32 x 32 tile a block through shared memory: read along r (a warp a
// run of rows), written along i.
__global__ void cin_split_g(const float* __restrict__ g,
                            float* __restrict__ g2, int hp, int D,
                            long long R, int Kp) {
  __shared__ float tile[32][33];
  const long long r0 = blockIdx.x * 32LL;
  const int i0 = blockIdx.y * 32, tx = threadIdx.x, ty = threadIdx.y;
  const long long r = r0 + tx;
  const bool live = r < R;
  const long long b = live ? r / D : 0;
  const float* src = g + b * hp * D + (live ? r - b * D : 0);
  for (int k = ty; k < 32; k += 8) {
    const int i = i0 + k;
    tile[k][tx] = live && i < hp ? src[(long long)i * D] : 0.f;
  }
  __syncthreads();
  const long long n = R * Kp;
  for (int k = ty; k < 32; k += 8) {
    const long long rr = r0 + k;
    const int i = i0 + tx;
    if (rr < R && i < Kp) {
      const float v = tile[tx][k];
      const uint32_t hi = tf32_bits(v);
      g2[rr * Kp + i] = __uint_as_float(hi);
      g2[n + rr * Kp + i] = __uint_as_float(tf32_bits(v - __uint_as_float(hi)));
    }
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

// The tensor map of a split operand (2, N, Kp), K-major, in boxes of
// 32 k x `rows` rows x 1 part with the 128-byte swizzle, zero past N
// and Kp. Returns 0, or 100000 + the CUresult of a failed encoding.
int box_map(CUtensorMap* map, const float* src, long long Kp, long long N,
            int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)N, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp * 4, (cuuint64_t)N * Kp * 4};
  const cuuint32_t box[3] = {kBK, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult cr = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(src), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return cr == CUDA_SUCCESS ? 0 : 100000 + (int)cr;
}

// Sets `kernel`'s shared memory to `smem` bytes and writes its
// persistent grid, min(units, SMs), to *grid. Returns a cudaError_t.
template <typename K>
int persistent_grid(K kernel, size_t smem, long long units, long long* grid,
                    int* sms_out = nullptr) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *grid = units < sms ? units : sms;
  if (sms_out != nullptr) *sms_out = sms;
  return 0;
}

// Launches cin_kernel<kMode> on its persistent grid with `smem` bytes
// of shared memory, then, for s > 1, the chunk sum into `out`. p.n_ct
// must be set.
template <int kMode>
int run(const CUtensorMap& wmap, Params p, size_t smem, float* out,
        float* scratch, cudaStream_t stream) {
  p.dst = p.s > 1 ? scratch : out;
  p.units = (p.M + kBM - 1) / kBM * p.n_ct * p.s;
  long long grid = 0;
  int sms = 0;
  int err = persistent_grid(cin_kernel<kMode>, smem, p.units, &grid, &sms);
  if (err != 0) return err;
  cin_kernel<kMode><<<(unsigned)grid, kThreads, smem, stream>>>(wmap, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
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

int grid_for(long long n) {
  long long blocks = (n + 255) / 256;
  return (int)(blocks > 2048 ? 2048 : blocks);
}

}  // namespace

extern "C" int cin_split_launch(const float* W, float* w2, int hp, int K,
                                cudaStream_t stream) {
  const int Kp = (K + 3) / 4 * 4;
  const long long n = (long long)hp * Kp;
  if (n == 0) return 0;
  cin_split<<<grid_for(n), 256, 0, stream>>>(W, w2, K, Kp, n);
  return (int)cudaGetLastError();
}

// dx0's B operand from W (hp, h, m): wt (2, m*h8, Kp), h8 = h rounded up
// to 8, Kp = hp rounded up to 4. Returns a cudaError_t.
extern "C" int cin_split_wx0_launch(const float* W, float* wt, int hp, int h,
                                    int m, cudaStream_t stream) {
  const int h8 = (h + 7) / 8 * 8, Kp = (hp + 3) / 4 * 4;
  const long long n = (long long)m * h8 * Kp;
  if (n == 0) return 0;
  cin_split_wx0<<<grid_for(n), 256, 0, stream>>>(W, wt, hp, h, m, h8, Kp, n);
  return (int)cudaGetLastError();
}

// dW's B operand from g (B, hp, D): gt (2, hp, Rp), Rp = B*D rounded up
// to 4. Returns a cudaError_t.
extern "C" int cin_split_gt_launch(const float* g, float* gt, long long B,
                                   int hp, int D, cudaStream_t stream) {
  const long long R = B * D, Rp = (R + 3) / 4 * 4;
  if (hp == 0 || Rp == 0) return 0;
  if (hp > 65535) return (int)cudaErrorInvalidValue;
  long long bx = (Rp + 255) / 256;
  if (bx > 4096) bx = 4096;
  cin_split_gt<<<dim3((unsigned)bx, (unsigned)hp), 256, 0, stream>>>(
      g, gt, hp, D, R, Rp);
  return (int)cudaGetLastError();
}

// dx0's A operand from g (B, hp, D): g2 (2, B*D, Kp), Kp = hp rounded up
// to 4. Returns a cudaError_t.
extern "C" int cin_split_g_launch(const float* g, float* g2, long long B,
                                  int hp, int D, cudaStream_t stream) {
  const long long R = B * D;
  const int Kp = (hp + 3) / 4 * 4;
  if (R == 0 || Kp == 0) return 0;
  const long long bx = (R + 31) / 32;
  if (bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cin_split_g<<<dim3((unsigned)bx, (unsigned)((Kp + 31) / 32)), dim3(32, 8),
                0, stream>>>(g, g2, hp, D, R, Kp);
  return (int)cudaGetLastError();
}

// The layer. x0's slab stays in shared memory while it fits beside the
// two stages (m <= 123); a wider x0 is read from device memory instead.
// Returns a cudaError_t, or 100000 + the CUresult of a failed
// tensor-map encoding.
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
  CUtensorMap wmap;
  const int err = box_map(&wmap, w2, Kp, hp, kBN);
  if (err != 0) return err;
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
  p.n_ct = (hp + kBN - 1) / kBN;
  p.col_step = kBN;
  p.chunk_elems = B * hp * D;
  if (slab <= kMaxSmem) return run<kSlab>(wmap, p, slab, out, scratch, stream);
  return run<kStream>(wmap, p, base, out, scratch, stream);
}

// The input gradient dx0[b, j, d] = sum_{i, a} W[i, a, j] * g[b, i, d] *
// xk[b, a, d] into dx0 (B, m, D), for xk (B, h, D), g2, the split of g
// that cin_split_g_launch writes, and wt, the split of W that
// cin_split_wx0_launch writes, float32 and contiguous. A column tile
// holds J whole j of h8 = h rounded up to 8 columns each
// (J * h8 <= 200), or one j spans n_sub column tiles (J = 1,
// n_sub * 200 >= h8): cin.py:x0grad_tiling. Returns a cudaError_t, or
// 100000 + the CUresult of a failed tensor-map encoding.
extern "C" int cin_grad_x0_launch(const float* xk, const float* g2,
                                  const float* wt, float* dx0, long long B,
                                  int m, int h, int hp, int D, int J,
                                  int n_sub, cudaStream_t stream) {
  const long long M = B * D;
  if (M == 0 || m == 0) return 0;
  const int h8 = (h + 7) / 8 * 8;
  if (m < 0 || h < 0 || hp < 0 || D <= 0 || J <= 0 || n_sub <= 0 ||
      (n_sub == 1 && J * h8 > kBN) || (n_sub > 1 && J > 1) ||
      n_sub * kBN < h8 || M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (h == 0 || hp == 0)
    return (int)cudaMemsetAsync(dx0, 0, M * m * 4, stream);
  const int Kp = (hp + 3) / 4 * 4;
  CUtensorMap amap, bmap;
  int err = box_map(&amap, g2, Kp, M, kBM);
  if (err == 0) err = box_map(&bmap, wt, Kp, (long long)m * h8, kBN);
  if (err != 0) return err;
  Params p = {};
  p.xk = xk;
  p.dst = dx0;
  p.M = M;
  p.m = m;
  p.h = h;
  p.hp = hp;
  p.D = D;
  p.s = 1;
  p.tiles = (hp + kBK - 1) / kBK;
  p.h8 = h8;
  p.J = J;
  p.n_sub = n_sub;
  p.n_ct = (m + J - 1) / J;
  p.col_step = J * h8;
  p.units = (M + kBM - 1) / kBM * p.n_ct;
  const size_t smem = kStages * kStage + kBarBytes + 1024;
  long long grid = 0;
  err = persistent_grid(cin_x0grad_kernel, smem, p.units, &grid);
  if (err != 0) return err;
  cin_x0grad_kernel<<<(unsigned)grid, kThreads, smem, stream>>>(amap, bmap,
                                                                 p);
  return (int)cudaGetLastError();
}

// The weight gradient of a layer: dW[i, a, j] = sum_{b, d} g[b, i, d] *
// xk[b, a, d] * x0[b, j, d] into dw (h', h, m), for x0 (B, m, D), xk
// (B, h, D) and gt, the split transposed g that cin_split_gt_launch
// writes, float32 and contiguous. The depth B*D is cut into s chunks
// (s <= its 32-row tiles) whose partial sums the scratch (s, h', h*m)
// holds for the chunk sum. Returns a cudaError_t, or 100000 + the
// CUresult of a failed tensor-map encoding.
extern "C" int cin_wgrad_launch(const float* x0, const float* xk,
                                const float* gt, float* dw, float* scratch,
                                long long B, int m, int h, int hp, int D,
                                int s, cudaStream_t stream) {
  const long long K = (long long)h * m;
  if (K == 0 || hp == 0) return 0;
  const long long R = B * D;
  const long long tiles = (R + kBK - 1) / kBK;
  if (m <= 0 || h <= 0 || D <= 0 || s <= 0 || (R > 0 && s > tiles) ||
      R > 0x7fffffffLL - kBK || (s > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaMemsetAsync(dw, 0, K * hp * 4, stream);
  CUtensorMap gmap;
  const int err = box_map(&gmap, gt, (R + 3) / 4 * 4, hp, kBN);
  if (err != 0) return err;
  const int nj = m > kBM ? kBM : m;
  const int na = (kBM - 1) / m + 2 < h ? (kBM - 1) / m + 2 : h;
  Params p = {};
  p.x0 = x0;
  p.xk = xk;
  p.M = K;
  p.R = R;
  p.m = m;
  p.h = h;
  p.hp = hp;
  p.D = D;
  p.s = s;
  p.tiles = (int)tiles;
  p.n_ct = (hp + kBN - 1) / kBN;
  p.col_step = kBN;
  p.stage_rows = nj + na;
  p.chunk_elems = K * hp;
  // the ring: at most 130 rows a tile, 55 KB for the three buffers
  const size_t smem = kStages * kStage + kBarBytes + 1024 +
                      (size_t)kTileBufs * p.stage_rows * kTRow * 4;
  return run<kWgrad>(gmap, p, smem, dw, scratch, stream);
}
