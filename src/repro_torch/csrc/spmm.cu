// The SLING pull operator Â applied to a node-major (n, F) float32 slab,
// for Hopper (sm_90a):
//
//     out[v, f] = sum_{e in row v} w_e * p(x[idx_e, f])
//
// over a CSR of the operator's outputs (ptr / idx / w), with p the
// identity, or with a threshold tau the prune p(x) = x if x > tau else
// 0. Over the in-CSR this is the Alg-2 pull (w_e = sqrt(c)/|I(v)|); over
// the out-CSR with each edge carrying its destination's weight it is
// the transposed push of the incremental-maintenance mass scans.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell/spmv_ell.py
// (_kernel / spmm_block), which groups edges into destination blocks and
// lands each chunk of gathered messages with a one-hot MXU matmul.
//
// The live mask. A segment is 32 columns of one row (128 bytes, one
// warp's coalesced load). With tau, `live` (n, ceil(F/1024)) int32 has
// bit s of row r's word set when segment s of row r of x may hold an
// entry > tau; a clear bit promises that it holds none, so the kernel
// never reads it. The epilogue writes the same mask for out into
// `live_out` (a bit set iff some entry of the segment is > tau), which
// the caller's next step passes back as `live`.
//
// What bounds it on the H100: one FMA per gathered float, so bytes. A
// pruned SLING frontier is sparse (0.5-45% of segments live on the
// Enron build and mass scans), so what the inputs need is: the live
// segments of x, read once (x is 37.6 MB at F = 256, n = 36,692, under
// the 50 MB L2, so an edge's repeated gathers of a segment can hit L2);
// the output, written whole (37.6 MB: the floor of every step); the CSR
// (8m + 4(n+1) bytes); and the mask words. The design:
//   * 16-byte gathers: where F % 4 == 0 and both slabs are 16-byte
//     aligned, a lane owns 4 consecutive columns as a float4 read with
//     ld.global.nc (x is read-only during the call), twice a tile, so a
//     warp covers 256 columns (8 segments) and one instruction moves a
//     sector's worth per 2 lanes; otherwise a scalar path with the same
//     structure takes lane-strided columns (F = 1, 3, 257 ...);
//   * masked gathers: per edge the row's mask word travels with idx and
//     w; a lane loads only if its segment's bit is set, so a dead
//     segment costs no memory sector, and an edge with no live segment in
//     the tile is dropped from the walk before any load (a ballot over
//     the edge batch: its FMAs would add w * 0);
//   * edge metadata once: a group of G lanes loads idx, w and the mask
//     word of G edges, one each, coalesced, and broadcasts them with
//     __shfl_sync;
//   * edges in flight: the gathers of kFlight = 2 live edges are issued
//     before their FMAs, which are then applied in edge order;
//   * row classes: light rows (in-degree <= the layout's split,
//     HEAVY_DEGREE in kernels/spmv_ell/ops.py) at F > 128 go kRows = 2 to
//     a warp, whose row ids, edge ranges, edge metadata and mask words
//     are loaded for both rows at once: with little live, a row's time is
//     a chain of dependent loads (light -> ptr -> idx -> mask word), and
//     two rows share each wait. At F <= 128 a group of G lanes (G = next
//     power of two >= F/8) takes a row. Heavy rows (the hubs of a
//     power-law graph) get a block, with slot s of kSlots summing the
//     edges e0 + s, e0 + s + kSlots, ... in order; the slot sums meet in
//     shared memory and are added slot by slot;
//   * epilogue: out is stored 16 bytes a lane with st.global.cs
//     (evict-first: the output is 37.6 MB, of which the next step reads
//     only the live segments, so it should not push the CSR, the masks
//     and the live rows of x out of L2), and live_out's bits are an OR
//     over the lanes of the group (shuffles), one word per row.
// kFlight, kRows and the evict-first stores were chosen by timing
// variants on the Enron build block on an H100: 4 in flight or 4-8 rows
// a warp cost registers, and with them occupancy, for more than they
// hid, and plain stores were slower in the chained block. An L2
// persistence window over x was not tried.
//
// Bits: no atomics, and the order of each output's sum depends only on
// its row (edge order for a light row, slot order for a heavy one), not
// on F, G, the mask or which columns share the launch. Every sum starts
// at +0.0, so skipping a dead segment drops only terms acc + w * 0 that
// leave acc as it is: the masked sum equals the dense sum bit for bit. A
// column propagated alone gives what it gives inside any block of
// columns, which is what lets an incremental row repair reproduce a
// fresh build's entries exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = kThreads / 32;  // heavy rows: edge slots per block
constexpr int kPer = 8;                // columns a lane owns in a tile
constexpr int kFlight = 2;             // gathers issued before their FMAs
constexpr int kRows = 2;               // light rows a warp walks together
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* x;
  float* out;
  const int* ptr;
  const int* idx;
  const float* w;
  const int* heavy;
  const int* light;
  const unsigned* live;      // (n, words) or null: every segment live
  unsigned* live_out;        // (n, words) or null
  int n_heavy, n_light, F, words, prune;
  float tau;
};

// Column (within a tile of kPer * G columns) of element k of lane gl:
// with kVec two float4s, at 4 gl and 4 G + 4 gl; else lane-strided.
template <bool kVec>
__device__ __forceinline__ int col_of(int k, int gl, int G) {
  return kVec ? (k >> 2) * 4 * G + 4 * gl + (k & 3) : k * G + gl;
}

// The bit of column c in its row's mask word.
__device__ __forceinline__ unsigned seg_bit(int c) {
  return 1u << ((c >> 5) & 31);
}

// Whether live_out's word ends with this tile: the next tile starts
// another word, or there is none.
__device__ __forceinline__ bool word_ends(int tile0, int width, int F) {
  const int next = tile0 + width;
  return next >= F || (next >> 10) != (tile0 >> 10);
}

// The bits of the segments of the tile [tile0, tile0 + width) of F
// columns within their mask word.
__device__ __forceinline__ unsigned tile_mask(int tile0, int width, int F) {
  const unsigned s0 = (tile0 >> 5) & 31;
  const unsigned s1 = ((min(tile0 + width, F) - 1) >> 5) & 31;
  return ((2u << s1) - 1u) & ~((1u << s0) - 1u);
}

// The mask word of input row src for the tile's word (every segment
// live without a mask).
__device__ __forceinline__ unsigned mask_word(const Args& a, int src,
                                              int word) {
  return a.live ? __ldg(a.live + (long long)src * a.words + word) : kFull;
}

// One batch of at most G edges of a walk, in edge order, for the G lanes
// of one group (lanes gbase .. gbase + G - 1 of the warp; gl is this
// lane's place in it): lane j holds edge j's input row `src`, weight
// `we` and mask word `mk` (mk = 0: no edge). acc[k] += we *
// p(x[src, tile0 + col_of(k)]) for every edge with a live segment in the
// tile, kFlight edges' gathers issued before their FMAs.
template <bool kVec>
__device__ __forceinline__ void walk_batch(const Args& a, int src, float we,
                                           unsigned mk, int tile0, int G,
                                           int gl, int gbase, unsigned gmask,
                                           float (&acc)[kPer]) {
  constexpr int kW = kVec ? 4 : 1;        // floats a load
  constexpr int kUnits = kPer / kW;
  const unsigned tbits = tile_mask(tile0, kPer * G, a.F);
  unsigned todo = __ballot_sync(gmask, (mk & tbits) != 0u) >> gbase;
  if (G < 32) todo &= (1u << G) - 1u;
  while (todo) {
    int jv[kFlight];
#pragma unroll
    for (int u = 0; u < kFlight; ++u) {
      jv[u] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1u;
    }
    float wv[kFlight], v[kFlight][kPer];
#pragma unroll
    for (int u = 0; u < kFlight; ++u) {
      const int j = jv[u] < 0 ? 0 : jv[u];
      const int s = __shfl_sync(gmask, src, j, G);
      wv[u] = __shfl_sync(gmask, we, j, G);
      const unsigned m = jv[u] < 0 ? 0u : __shfl_sync(gmask, mk, j, G);
      const float* xr = a.x + (long long)s * a.F + tile0;
#pragma unroll
      for (int q = 0; q < kUnits; ++q) {
        const int c = col_of<kVec>(q * kW, gl, G);
        const bool ok = tile0 + c < a.F && (m & seg_bit(tile0 + c)) != 0u;
        if constexpr (kVec) {
          float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) t = __ldg(reinterpret_cast<const float4*>(xr + c));
          v[u][4 * q] = t.x;
          v[u][4 * q + 1] = t.y;
          v[u][4 * q + 2] = t.z;
          v[u][4 * q + 3] = t.w;
        } else {
          v[u][q] = ok ? __ldg(xr + c) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kFlight; ++u) {
      if (jv[u] < 0) break;               // uniform over the group
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        float xv = v[u][k];
        if (a.prune && !(xv > a.tau)) xv = 0.f;
        acc[k] = fmaf(wv[u], xv, acc[k]);
      }
    }
  }
}

// acc[k] += w_e * p(x[idx_e, tile0 + col_of(k)]) over the edges e0,
// e0 + stride, ... < e1 in order, in batches of G edges.
template <bool kVec>
__device__ __forceinline__ void gather(const Args& a, int e0, int e1,
                                       int stride, int tile0, int G, int gl,
                                       int gbase, float (&acc)[kPer]) {
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << gbase;
  const int cnt = e1 > e0 ? (e1 - e0 + stride - 1) / stride : 0;
  for (int b = 0; b < cnt; b += G) {
    int src = 0;
    float we = 0.f;
    unsigned mk = 0u;
    if (b + gl < cnt) {
      const int e = e0 + (b + gl) * stride;
      src = __ldg(a.idx + e);
      we = __ldg(a.w + e);
      mk = mask_word(a, src, tile0 >> 10);
    }
    walk_batch<kVec>(a, src, we, mk, tile0, G, gl, gbase, gmask, acc);
  }
}

// Store a light row's tile of out (16 bytes a lane with kVec), fold its
// live bits into word_bits (an OR over the group) and store the word of
// live_out when it ends.
template <bool kVec>
__device__ __forceinline__ void store_tile(const Args& a, int v, int tile0,
                                           int G, int gl, unsigned gmask,
                                           const float (&acc)[kPer],
                                           unsigned& word_bits) {
  float* orow = a.out + (long long)v * a.F + tile0;
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < kPer; k += kVec ? 4 : 1) {
    const int c = col_of<kVec>(k, gl, G);
    if (tile0 + c >= a.F) continue;
    if constexpr (kVec) {
      __stcs(reinterpret_cast<float4*>(orow + c),
             make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]));
      if (acc[k] > a.tau || acc[k + 1] > a.tau || acc[k + 2] > a.tau ||
          acc[k + 3] > a.tau)
        bits |= seg_bit(tile0 + c);
    } else {
      __stcs(orow + c, acc[k]);
      if (acc[k] > a.tau) bits |= seg_bit(tile0 + c);
    }
  }
  if (a.live_out) {
    for (int o = G >> 1; o > 0; o >>= 1)
      bits |= __shfl_xor_sync(gmask, bits, o, G);
    word_bits |= bits;
    if (word_ends(tile0, kPer * G, a.F)) {
      if (gl == 0)
        a.live_out[(long long)v * a.words + (tile0 >> 10)] = word_bits;
      word_bits = 0u;
    }
  }
}

// A heavy row: slot s (a warp) walks the edges e0 + s, e0 + s + kSlots,
// ...; the slot sums are added slot by slot in shared memory.
template <bool kVec>
__device__ void heavy_row(const Args& a, int v) {
  __shared__ float part[kSlots][kPer * 32];
  __shared__ unsigned wbits[kSlots];
  const int slot = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e0 = __ldg(a.ptr + v), e1 = __ldg(a.ptr + v + 1);
  unsigned word_bits = 0u;                   // thread 0's
  for (int tile0 = 0; tile0 < a.F; tile0 += kPer * 32) {
    float acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
    gather<kVec>(a, e0 + slot, e1, kSlots, tile0, 32, lane, 0, acc);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      part[slot][col_of<kVec>(k, lane, 32)] = acc[k];
    __syncthreads();
    const int c = tile0 + threadIdx.x;      // kThreads == kPer * 32
    float y = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) y += part[s][threadIdx.x];
    unsigned bits = 0u;
    if (c < a.F) {
      __stcs(a.out + (long long)v * a.F + c, y);
      if (y > a.tau) bits = seg_bit(c);
    }
    if (a.live_out) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bits |= __shfl_xor_sync(kFull, bits, o);
      if (lane == 0) wbits[slot] = bits;
    }
    __syncthreads();
    if (a.live_out && threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) word_bits |= wbits[s];
      if (word_ends(tile0, kPer * 32, a.F)) {
        a.live_out[(long long)v * a.words + (tile0 >> 10)] = word_bits;
        word_bits = 0u;
      }
    }
  }
}

// kRows light rows r0 .. r0 + kRows - 1 for a whole warp (G = 32): the
// row ids and edge ranges, then idx and w of each row's first 32 edges,
// then their mask words, are loaded for all the rows at once, so the
// warp waits on each of those dependent loads once per kRows rows.
template <bool kVec>
__device__ void light_rows(const Args& a, long long r0, int lane) {
  int v = 0, e0 = 0, e1 = 0;                 // lane k < kRows: row k's
  if (lane < kRows && r0 + lane < a.n_light) {
    v = __ldg(a.light + r0 + lane);
    e0 = __ldg(a.ptr + v);
    e1 = __ldg(a.ptr + v + 1);
  }
  int src[kRows];
  float we[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int rk0 = __shfl_sync(kFull, e0, k);
    const int cnt = __shfl_sync(kFull, e1, k) - rk0;
    src[k] = 0;
    we[k] = 0.f;
    if (lane < cnt) {
      src[k] = __ldg(a.idx + rk0 + lane);
      we[k] = __ldg(a.w + rk0 + lane);
    }
  }
  unsigned word_bits[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) word_bits[k] = 0u;
  for (int tile0 = 0; tile0 < a.F; tile0 += kPer * 32) {
    unsigned mk[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int cnt = __shfl_sync(kFull, e1 - e0, k);
      mk[k] = lane < cnt ? mask_word(a, src[k], tile0 >> 10) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r0 + k >= a.n_light) break;
      const int rk0 = __shfl_sync(kFull, e0, k);
      const int rk1 = __shfl_sync(kFull, e1, k);
      float acc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
      walk_batch<kVec>(a, src[k], we[k], mk[k], tile0, 32, lane, 0, kFull,
                       acc);
      if (rk1 - rk0 > 32)                    // past the first 32 edges
        gather<kVec>(a, rk0 + 32, rk1, 1, tile0, 32, lane, 0, acc);
      store_tile<kVec>(a, __shfl_sync(kFull, v, k), tile0, 32, lane, kFull,
                       acc, word_bits[k]);
    }
  }
}

// blocks [0, n_heavy): one heavy row each; the rest: light rows, kRows a
// warp at G = 32, else a group of G lanes per row.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) spmm_kernel(Args a, int G) {
  if ((int)blockIdx.x < a.n_heavy) {
    heavy_row<kVec>(a, __ldg(a.heavy + blockIdx.x));
    return;
  }
  const long long t =
      (long long)(blockIdx.x - a.n_heavy) * kThreads + threadIdx.x;
  if (G == 32) {
    const long long r0 = t / 32 * kRows;
    if (r0 < a.n_light) light_rows<kVec>(a, r0, threadIdx.x & 31);
    return;
  }
  const long long r = t / G;
  if (r >= a.n_light) return;                // whole groups leave together
  const int gl = threadIdx.x & (G - 1);
  const int gbase = (threadIdx.x & 31) & ~(G - 1);
  const unsigned gmask = ((1u << G) - 1u) << gbase;
  const int v = __ldg(a.light + r);
  const int e0 = __ldg(a.ptr + v), e1 = __ldg(a.ptr + v + 1);
  unsigned word_bits = 0u;
  for (int tile0 = 0; tile0 < a.F; tile0 += kPer * G) {
    float acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
    gather<kVec>(a, e0, e1, 1, tile0, G, gl, gbase, acc);
    store_tile<kVec>(a, v, tile0, G, gl, gmask, acc, word_bits);
  }
}

}  // namespace

// out (n, F) = Â p(x) for x (n, F), both node-major float32, p the
// prune at tau when `prune` is set, else the identity. ptr (n+1),
// idx / w (m): the CSR of the operator's outputs; heavy and light: the
// row ids of the two classes (together every row once). live / live_out
// (n, ceil(F/1024)) int32 or null (both need prune; see the note above).
// Every row of out (and of live_out) is written. Returns the CUDA error
// code of the launch (0 if none).
extern "C" int spmm_launch(const float* x, float* out, const int* ptr,
                           const int* idx, const float* w, const int* heavy,
                           int n_heavy, const int* light, int n_light, int F,
                           int prune, float tau, const int* live,
                           int* live_out, cudaStream_t stream) {
  if (F <= 0 || n_heavy + n_light <= 0) return 0;
  Args a{x, out, ptr, idx, w, heavy, light,
         reinterpret_cast<const unsigned*>(live),
         reinterpret_cast<unsigned*>(live_out),
         n_heavy, n_light, F, (F + 1023) / 1024, prune, tau};
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int need = (F + kPer - 1) / kPer;
  int G = 1;
  while (G < need && G < 32) G *= 2;
  const long long light_threads =
      G == 32 ? (n_light + kRows - 1) / kRows * 32LL : (long long)n_light * G;
  const long long light_blocks = (light_threads + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(n_heavy + light_blocks);
  if (vec)
    spmm_kernel<true><<<blocks, kThreads, 0, stream>>>(a, G);
  else
    spmm_kernel<false><<<blocks, kThreads, 0, stream>>>(a, G);
  return (int)cudaGetLastError();
}
