// The SLING single-source push for Hopper (sm_90a): one persistent
// cooperative launch from a batch of row ids to the (B, n) scores,
//
//     acc = 0;  for l = l_max .. 0:
//       acc[v, b] = seed_l[v, b]
//                   + sum_{e in I(v)} w_e * prune_tau(acc[src_e, b])
//     seed_l[v, b] = sum over the entries j of row us[b] with key l*n + v
//                    of vals[us[b], j] * d[v]   (duplicate keys add up)
//
// Replaces the TPU kernel src/repro/kernels/horner_push/horner_push.py
// (_step_kernel / horner_step), which lands messages on destination
// blocks with a one-hot MXU matmul and builds the seed with a masked
// one-hot sum over the packed row; its Horner loop
// (src/repro/kernels/horner_push/ops.py) runs one step per level over
// rows that the host gathered and prepared first.
//
// What bounds it on the H100. Bytes: the push reads the B packed rows,
// d, the CSR once and writes the (B, n) result -- about 2.6 MB at the
// Enron regime and B = 8, under a microsecond at the HBM rate. Each
// level that runs re-reads the (n, B) frontier from L2 through the
// in-edges, so the data a level streams is a few MB of L2 traffic. And
// latency: a level cannot start before the last output of the level
// above is written, so each level pays one grid barrier plus the
// longest chain of dependent loads in it. The design:
//   * one launch a push: the levels run inside one cooperative launch
//     whose grid is every block of 1,024 threads the card holds at once
//     (capped at a level's work); a block is four groups of 256 threads,
//     each working on its own unit of a level (below) with a grid
//     stride, and cooperative_groups' grid barrier separates the
//     levels;
//   * no preparation on the host: the kernel reads the packed table
//     through the row ids, as hp_join does. A prologue finds where each
//     level's run starts in each row -- the rows are sorted by key =
//     l*n + k with PAD last, so run boundaries are where an entry's
//     level differs from its left neighbour's: one coalesced pass over
//     the B rows, with no chain of dependent loads -- and the highest
//     level of each row. It also zeroes the seed staging buffers. After
//     one barrier every block takes the highest level that holds a seed
//     from those B values: above it a push from a zero frontier is
//     exactly zero, so the levels run from there. contrib = vals * d_k
//     is formed where a seed is read and never stored;
//   * the first level that runs reads neither frontier (its input is
//     zero): it writes the seed alone, found by a search of the level's
//     run. Below it, the seeds of level l are staged densely during
//     level l + 1 (the thread at the head of each run of equal keys
//     sums the run in order), so an output's seed is one load; the
//     output clears what it read, which leaves the buffer zero for its
//     reuse two levels on;
//   * level 0 writes straight into the (B, n) result, so nothing is
//     transposed after the launch;
//   * dependent chains, which are what a level waits for: a thread
//     walks 4 columns of a node with 16-byte frontier loads where B is
//     a multiple of 4 (else 1 column), so the B lanes of a node share
//     one walk of its in-edges and read one contiguous row. It issues
//     its seed's staging load first, then loads the indices and
//     weights of kUnroll edges, then their frontier rows, then adds
//     them in edge order; the last batch is cut short by a predicate,
//     so a node of in-degree up to kUnroll waits for one index load
//     and one frontier load in all;
//   * a level waits for its slowest thread, so a node gets threads by
//     its in-degree: the layout orders the nodes in tiers (PUSH_TIERS)
//     -- low nodes (up to kUnroll in-edges, most of them) take a thread
//     a column group, mid nodes (up to 32) kMidLanes threads and wide
//     nodes (up to 128) kWideLanes, whose slots stride I(v) so that each
//     waits for one batch and meet in a fixed shuffle tree, and big
//     nodes a group each, whose slots' partials meet in a fixed order
//     (a shuffle tree in each warp, then the warps in order). Sized so,
//     a level of a serving batch (B = 8) fits the grid once;
//   * the staging of the next level's seeds runs on the grid's last
//     threads, which a level leaves idle at serving batch sizes.
// Every output is summed in a fixed order with no atomics on scores, so
// two launches on the same inputs give the same bits. The frontiers,
// the staging buffers and the prologue's tables are written by other
// blocks during the launch, so they are never read through the
// non-coherent read-only path: no const __restrict__ and no __ldg on
// them, only ld.global.cg (L2) loads. The CSR, the table, d and the row
// ids do not change during the launch and are read with __ldg.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 256;     // threads of one unit of work
constexpr int kGroups = 4;      // units a block: 1,024 threads
constexpr int kUnroll = 8;      // edges whose loads are in flight at once
constexpr int kMidLanes = 16;   // threads of one mid node
constexpr int kWideLanes = 32;  // threads of one wide node
constexpr int kMaxDevices = 64;
constexpr int kPad = 0x7fffffff;

struct Push {
  const int* in_ptr;         // (n + 1,)
  const int* in_idx;         // (m,)
  const float* w;            // (m,)
  const int* order;          // node ids by tier: low, mid, wide, big
  const int* keys;           // (rows, width) packed table, rows sorted
  const float* vals;         // (rows, width)
  const float* d;            // (n,)
  const void* us;            // (B,) row ids, int32 or int64
  float* frontier;           // (2, n, B): level l writes buffer l & 1
  float* stage;              // (2, n, B): level l's seeds in buffer l & 1
  int* runs;                 // (B, l_max + 2): level l's run starts
  int* last;                 // (B,): a row's highest level, -1 if empty
  float* out;                // (B, n) result, written by level 0
  int ids64;                 // us holds int64
  int n, batch, width, l_max, work;
  // the tiers as this batch runs them: a tier whose lanes cannot hold
  // two slots of q column groups runs with its neighbour in `order`
  int low_items;             // low nodes * q: a thread a column group
  int mid0, n_mid, mid_slots, mid_units;      // kMidLanes a node
  int wide0, n_wide, wide_slots, wide_units;  // kWideLanes a node
  int big0, big_units;                        // a group a node
  int q, q_shift;            // B / C column groups a node; log2(q) or -1
  float tau;
};

// t / q without a division where q is a power of two
__device__ __forceinline__ int div_q(const Push& p, int t) {
  return p.q_shift >= 0 ? t >> p.q_shift : t / p.q;
}

__device__ __forceinline__ long long row_of(const Push& p, int b) {
  return p.ids64 ? __ldg(static_cast<const long long*>(p.us) + b)
                 : (long long)__ldg(static_cast<const int*>(p.us) + b);
}

// an int written by other blocks during the launch, through L2 only
__device__ __forceinline__ int load_l2(const int* ptr) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(ptr));
  return v;
}

// C consecutive floats at ptr through L2 only (ld.global.cg; 16-byte
// aligned when C = 4); volatile, so the compiler neither merges nor
// moves them across the grid barrier
template <int C>
__device__ __forceinline__ void load_l2(const float* ptr, float (&v)[C]) {
  if constexpr (C == 4)
    asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "l"(ptr));
  else
    asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v[0]) : "l"(ptr));
}

// How a kernel reads what it shares: the persistent push reads the
// frontiers, the staging buffers and the run tables through L2 only,
// since other blocks write them during the launch (ViaL2); the slab step
// writes nothing that it reads, so it takes the read-only path
// (ReadOnly). The pull and the seed search below take one of the two, so
// both kernels sum in the same order and agree bit for bit.
struct ViaL2 {
  static __device__ __forceinline__ int get(const int* ptr) {
    return load_l2(ptr);
  }
  template <int C>
  static __device__ __forceinline__ void get(const float* ptr,
                                             float (&v)[C]) {
    load_l2<C>(ptr, v);
  }
};

struct ReadOnly {
  static __device__ __forceinline__ int get(const int* ptr) {
    return __ldg(ptr);
  }
  template <int C>
  static __device__ __forceinline__ void get(const float* ptr,
                                             float (&v)[C]) {
    if constexpr (C == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(ptr));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
      v[0] = __ldg(ptr);
    }
  }
};

template <int C>
__device__ __forceinline__ void store(float* ptr, const float (&v)[C]) {
  if constexpr (C == 4)
    *reinterpret_cast<float4*>(ptr) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *ptr = v[0];
}

// the level of a key: PAD (and anything past l_max) is l_max + 1
__device__ __forceinline__ int level_of(const Push& p, int key) {
  return key == kPad ? p.l_max + 1 : min(key / p.n, p.l_max + 1);
}

// prologue: runs[b, l] = the first j of row b whose level is >= l, for
// l = 0 .. l_max + 1 (so level l's entries are runs[b, l] ..
// runs[b, l + 1] - 1 and PAD lies in none), and last[b] = the level of
// row b's last entry (-1 for an all-PAD row). Entry j writes the
// boundaries between its left neighbour's level and its own; the last
// entry also closes the row. Each value has exactly one writer.
__device__ void find_runs(const Push& p, int gid, int threads) {
  const int L2 = p.l_max + 2;
  if (p.width == 0) {
    for (int k = gid; k < p.batch * L2; k += threads) p.runs[k] = 0;
    for (int b = gid; b < p.batch; b += threads) p.last[b] = -1;
    return;
  }
  for (int k = gid; k < p.batch * p.width; k += threads) {
    const int b = k / p.width, j = k - b * p.width;
    const int* row = p.keys + row_of(p, b) * p.width;
    const int lv = level_of(p, __ldg(row + j));
    const int prev = j == 0 ? -1 : level_of(p, __ldg(row + j - 1));
    int* runs = p.runs + b * L2;
    for (int l = prev + 1; l <= lv; ++l) runs[l] = j;
    if (j == p.width - 1)
      for (int l = lv + 1; l < L2; ++l) runs[l] = p.width;
    if (lv <= p.l_max && (j == p.width - 1 ||
                          level_of(p, __ldg(row + j + 1)) > p.l_max))
      p.last[b] = lv;
    if (j == 0 && lv > p.l_max) p.last[b] = -1;
  }
}

// the seed of one output from a level's run of a sorted packed row: run
// holds the run's first and end index (read through Ld), and the seed is
// the sum of vals[j] * *dv over the entries j whose key is `key`, in the
// row's order (0 if there is none)
template <class Ld>
__device__ __forceinline__ float run_seed(const int* run, const int* row,
                                          const float* vals, int key,
                                          const float* dv) {
  int lo = Ld::get(run), hi = Ld::get(run + 1);
  if (lo >= hi) return 0.f;
  const int end = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < key) lo = mid + 1; else hi = mid;
  }
  if (lo >= end || __ldg(row + lo) != key) return 0.f;
  const float d = __ldg(dv);
  float s = 0.f;
  for (int j = lo; j < end && __ldg(row + j) == key; ++j)
    s += __ldg(vals + j) * d;
  return s;
}

// the seed of output (v, b) at `level`: the entries of row us[b] whose
// key is level*n + v (used at the first level only)
__device__ __forceinline__ float seed_at(const Push& p, int b, int level,
                                         int v) {
  const long long base = row_of(p, b) * p.width;
  // level*n + v < 2^31 - 1: the build checks it
  return run_seed<ViaL2>(p.runs + b * (p.l_max + 2) + level, p.keys + base,
                         p.vals + base, level * p.n + v, p.d + v);
}

// stage level `level`'s seeds densely: the thread at the first entry j
// of each run of equal keys in row b's level run sums the run's
// vals * d_v in order (as seed_at does) into stage[v, b]; no two runs
// share (v, b)
__device__ void stage_seeds(const Push& p, int level, float* stage,
                            int gid, int threads) {
  const int L2 = p.l_max + 2;
  for (int k = gid; k < p.batch * p.width; k += threads) {
    const int b = k / p.width, j = k - b * p.width;
    const int lo = load_l2(p.runs + b * L2 + level);
    const int hi = load_l2(p.runs + b * L2 + level + 1);
    if (j < lo || j >= hi) continue;
    const long long base = row_of(p, b) * p.width;
    const int* row = p.keys + base;
    const int key = __ldg(row + j);
    if (j > lo && __ldg(row + j - 1) == key) continue;
    const int v = key - level * p.n;
    const float dv = __ldg(p.d + v);
    float s = 0.f;
    for (int i = j; i < hi && __ldg(row + i) == key; ++i)
      s += __ldg(p.vals + base + i) * dv;
    stage[(long long)v * p.batch + b] = s;
  }
}

// the level's seed of outputs (v, c0 .. c0+C): searched at the first
// level, else taken from the staging buffer (through L2: other blocks
// wrote it). Called before the output's in-edges are walked, so that
// the staging load is in flight with theirs.
template <int C>
__device__ __forceinline__ void seed_of(const Push& p, const float* stage,
                                        int v, int c0, int level, bool first,
                                        float (&s)[C]) {
  if (first) {
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = seed_at(p, c0 + c, level, v);
  } else {
    load_l2<C>(stage + (long long)v * p.batch + c0, s);
  }
}

// out[v, c0 .. c0+C) = acc + s, the seed from seed_of, which is cleared
// in the staging buffer where it was not zero. Level 0 writes the
// (B, n) result, the others the node-major frontier `out`.
template <int C>
__device__ __forceinline__ void finish(const Push& p, float* out,
                                       float* stage, int v, int c0,
                                       int level, bool first,
                                       const float (&s)[C],
                                       float (&acc)[C]) {
  const long long o = (long long)v * p.batch + c0;
  if (!first) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) any |= s[c] != 0.f;
    if (any) {
      const float zero[C] = {};
      store<C>(stage + o, zero);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] += s[c];
  if (level == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      p.out[(long long)(c0 + c) * p.n + v] = acc[c];
  } else {
    store<C>(out + o, acc);
  }
}

// acc[c] += sum over e = e0, e0 + stride, ... < e1 of
// w_e * prune_tau(x[src_e, c0 + c]) over the CSR's in_idx / w and the
// node-major (rows, B) frontier x (read through Ld), in that order. Edges
// go in batches of kUnroll, the last one cut short by a predicate: a
// batch loads its indices and weights, then its frontier rows, then
// adds, so a node of in-degree up to kUnroll waits for one index load and
// one frontier load, not for one chain per edge.
template <class Ld, int C>
__device__ __forceinline__ void pull_edges(const int* in_idx, const float* w,
                                           const float* x, int B, float tau,
                                           int e0, int e1, int stride,
                                           int c0, float (&acc)[C]) {
  for (int e = e0; e < e1; e += kUnroll * stride) {
    int src[kUnroll];
    float wv[kUnroll], xv[kUnroll][C];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int ek = e + k * stride;
      src[k] = ek < e1 ? __ldg(in_idx + ek) : -1;
      wv[k] = ek < e1 ? __ldg(w + ek) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (src[k] >= 0) {
        Ld::template get<C>(x + (long long)src[k] * B + c0, xv[k]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) xv[k][c] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (src[k] >= 0 && xv[k][c] > tau)
          acc[c] = fmaf(wv[k], xv[k][c], acc[c]);
  }
}

template <int C>
__device__ __forceinline__ void pull_range(const Push& p, const float* x,
                                           int e0, int e1, int stride,
                                           int c0, float (&acc)[C]) {
  pull_edges<ViaL2, C>(p.in_idx, p.w, x, p.batch, p.tau, e0, e1, stride, c0,
                       acc);
}

// a group's own barrier: named barrier 1 + g over its kGroup threads
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroup) : "memory");
}

// one big node v with one group of kGroup threads: thread gt is
// (slot, column group qi) of the node's slots x q; the slots' partials
// meet in a fixed order (a shuffle tree in each warp where q divides
// 32, then the warps in order); `first`: the input is zero
template <int C>
__device__ void big_node(const Push& p, const float* x, float* out,
                         float* stage, int v, int level, bool first,
                         float* part, int g, int gt) {
  const int q = p.q;
  const int e0 = __ldg(p.in_ptr + v), e1 = __ldg(p.in_ptr + v + 1);
  if (q > kGroup) {  // one slot: each thread owns whole column groups
    for (int qi = gt; qi < q; qi += kGroup) {
      float acc[C] = {}, sd[C];
      seed_of<C>(p, stage, v, qi * C, level, first, sd);
      if (!first) pull_range<C>(p, x, e0, e1, 1, qi * C, acc);
      finish<C>(p, out, stage, v, qi * C, level, first, sd, acc);
    }
    return;
  }
  const int slots = kGroup / q;
  const int slot = div_q(p, gt), qi = gt - slot * q;
  const bool shuffle = (32 % q) == 0;  // a warp holds 32 / q whole slots
  float sd[C];
  if (gt < q) seed_of<C>(p, stage, v, gt * C, level, first, sd);
  if (!first) {
    float s[C] = {};
    if (slot < slots) pull_range<C>(p, x, e0 + slot, e1, slots, qi * C, s);
    if (shuffle) {
      // lanes of one column group sit q apart: fold the warp's slots in
      // a fixed tree, then write one partial per (warp, column group)
      for (int off = 16; off >= q; off >>= 1)
#pragma unroll
        for (int c = 0; c < C; ++c)
          s[c] += __shfl_down_sync(0xffffffffu, s[c], off);
      if ((gt & 31) < q)
#pragma unroll
        for (int c = 0; c < C; ++c) part[((gt >> 5) * q + qi) * C + c] = s[c];
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) part[gt * C + c] = s[c];
    }
  }
  group_sync(g);
  if (gt < q) {
    float acc[C] = {};
    if (!first) {
      const int parts = shuffle ? kGroup / 32 : slots;
      for (int s = 0; s < parts; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += part[(s * q + gt) * C + c];
    }
    finish<C>(p, out, stage, v, gt * C, level, first, sd, acc);
  }
  group_sync(g);  // part is reused by the group's next node
}

// one node's share of a level for thread r of its kLanes, the node
// being entry i of the tier's `count` ids from order[first_id]: slot r / q
// of `slots` walks every slots-th in-edge of column group r % q, so a
// node of in-degree up to kUnroll * slots waits for one batch of loads;
// the slots meet in a fixed shuffle tree (lanes of one column group sit
// q apart), and slot 0 writes the output. Every lane of the warp takes
// part in the shuffles, inside the tier or not.
template <int C, int kLanes>
__device__ __forceinline__ void lanes_node(const Push& p, int t, int first_id,
                                           int count, int slots, int level,
                                           bool first, const float* x,
                                           float* out, float* stage) {
  const int i = t / kLanes, r = t - i * kLanes;
  const int slot = div_q(p, r), qi = r - slot * p.q;
  const bool mine = i < count, lead = mine && slot == 0;
  const int v = mine ? __ldg(p.order + first_id + i) : 0;
  float acc[C] = {}, sd[C];
  if (lead) seed_of<C>(p, stage, v, qi * C, level, first, sd);
  if (mine && !first)
    pull_range<C>(p, x, __ldg(p.in_ptr + v) + slot, __ldg(p.in_ptr + v + 1),
                  slots, qi * C, acc);
  for (int off = kLanes / 2; off >= p.q; off >>= 1)
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off, kLanes);
  if (lead) finish<C>(p, out, stage, v, qi * C, level, first, sd, acc);
}

// one unit of a level: a big node, kGroup / kWideLanes wide nodes,
// kGroup / kMidLanes mid nodes, or kGroup low items (a low node's column
// group each)
template <int C>
__device__ __forceinline__ void run_unit(const Push& p, int u, int level,
                                         bool first, const float* x,
                                         float* out, float* stage,
                                         float* part, int g, int gt) {
  if (u < p.big_units) {
    big_node<C>(p, x, out, stage, __ldg(p.order + p.big0 + u), level, first,
                part, g, gt);
    return;
  }
  u -= p.big_units;
  if (u < p.wide_units) {
    lanes_node<C, kWideLanes>(p, u * kGroup + gt, p.wide0, p.n_wide,
                              p.wide_slots, level, first, x, out, stage);
    return;
  }
  u -= p.wide_units;
  if (u < p.mid_units) {
    lanes_node<C, kMidLanes>(p, u * kGroup + gt, p.mid0, p.n_mid,
                             p.mid_slots, level, first, x, out, stage);
    return;
  }
  const int t = (u - p.mid_units) * kGroup + gt;
  if (t >= p.low_items) return;
  const int i = div_q(p, t);
  const int v = __ldg(p.order + i), c0 = (t - i * p.q) * C;
  float acc[C] = {}, sd[C];
  seed_of<C>(p, stage, v, c0, level, first, sd);
  if (!first)
    pull_range<C>(p, x, __ldg(p.in_ptr + v), __ldg(p.in_ptr + v + 1), 1,
                  c0, acc);
  finish<C>(p, out, stage, v, c0, level, first, sd, acc);
}

// kGroups groups of kGroup threads a block, each group working on its
// own unit of a level: a block of kGroups groups arrives at the grid
// barrier once, where kGroups blocks would arrive kGroups times
template <int C>
__global__ void __launch_bounds__(kGroup * kGroups, 1)
horner_push_kernel(Push p) {
  __shared__ float part[kGroups][kGroup * C];
  __shared__ int top;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, g = tid / kGroup, gt = tid % kGroup;
  const int gid = blockIdx.x * blockDim.x + tid;
  const int threads = gridDim.x * blockDim.x;
  const long long nb = (long long)p.n * p.batch;
  // prologue: the level runs, and both staging buffers zeroed
  find_runs(p, gid, threads);
  if constexpr (C == 4) {
    float4* s4 = reinterpret_cast<float4*>(p.stage);
    for (long long k = gid; k < nb / 2; k += threads)
      s4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (long long k = gid; k < 2 * nb; k += threads) p.stage[k] = 0.f;
  }
  if (tid == 0) top = -1;
  grid.sync();
  // the highest level that holds a seed in any row (-1: none)
  int mine = -1;
  for (int b = tid; b < p.batch; b += blockDim.x)
    mine = max(mine, load_l2(p.last + b));
  if (mine >= 0) atomicMax(&top, mine);
  __syncthreads();
  const int start = max(top, 0);
  const int units = gridDim.x * kGroups, u0 = blockIdx.x * kGroups + g;
  for (int level = start; level >= 0; --level) {
    float* out = p.frontier + (level & 1) * nb;
    const float* x = p.frontier + ((level + 1) & 1) * nb;
    // level l's seeds are staged during level l + 1 into buffer l % 2;
    // each output takes and clears its own, so a buffer is zero again
    // by the time level l - 1 stages into it
    // staged by the grid's last threads, which a level leaves idle
    // unless its work fills the whole grid
    if (level > 0)
      stage_seeds(p, level - 1, p.stage + ((level - 1) & 1) * nb,
                  threads - 1 - gid, threads);
    float* stage = p.stage + (level & 1) * nb;
    for (int u = u0; u < p.work; u += units)
      run_unit<C>(p, u, level, level == start, x, out, stage, part[g], g,
                  gt);
    if (level > 0) grid.sync();
  }
}

struct Card {
  int sms = 0, coop = 0, per_sm[2] = {0, 0};  // per_sm: C = 1, 4
};

const void* kernel_of(int cols) {
  return cols == 4 ? (const void*)horner_push_kernel<4>
                   : (const void*)horner_push_kernel<1>;
}

// the card's SM count and how many blocks of each instance one SM holds
int card_of(Card* out) {
  static Card cards[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Card& c = cards[dev];
  if (c.sms == 0) {
    Card fresh;
    if ((err = cudaDeviceGetAttribute(&fresh.coop,
                                      cudaDevAttrCooperativeLaunch, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&fresh.sms,
                                      cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return (int)err;
    for (int i = 0; i < 2; ++i) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fresh.per_sm[i], kernel_of(i ? 4 : 1), kGroup * kGroups, 0);
      if (err != cudaSuccess) return (int)err;
    }
    c = fresh;
  }
  *out = c;
  return 0;
}

// slots a node of a tier of kLanes threads gets: kLanes / q where that
// is at least two slots of q column groups, else 0 (the tier then runs
// with its neighbour)
int slots_of(int lanes, int q) {
  return q <= lanes / 2 && lanes % q == 0 ? lanes / q : 0;
}

long long units_of(long long threads) {
  return (threads + kGroup - 1) / kGroup;
}

// the tiers of `order` (counts: low, mid, wide, big) as a batch of q
// column groups a node runs them; returns the units of a level
long long plan_tiers(const int (&counts)[4], int q, Push* p) {
  const int mid_slots = slots_of(kMidLanes, q);
  const int wide_slots = slots_of(kWideLanes, q);
  const int n_mid = mid_slots ? counts[1] : 0;
  const int n_wide = wide_slots ? counts[2] : 0;
  const long long low = counts[0] + (mid_slots ? 0 : counts[1]);
  const int big0 = counts[0] + counts[1] + n_wide;
  const int n_big = counts[3] + (wide_slots ? 0 : counts[2]);
  p->low_items = (int)(low * q);
  p->mid0 = counts[0];
  p->n_mid = n_mid;
  p->mid_slots = mid_slots;
  p->mid_units = (int)units_of((long long)n_mid * kMidLanes);
  p->wide0 = counts[0] + counts[1];
  p->n_wide = n_wide;
  p->wide_slots = wide_slots;
  p->wide_units = (int)units_of((long long)n_wide * kWideLanes);
  p->big0 = big0;
  p->big_units = n_big;
  return (long long)n_big + p->wide_units + p->mid_units +
         units_of(low * q);
}

}  // namespace

// The grid of a push of `batch` columns walked `cols` (1 or 4) at a time
// by a thread over nodes in tiers of n_low, n_mid, n_wide and n_big:
// every block the card holds at once, capped at a level's units of
// work. Returns the block count, or minus a CUDA error code.
extern "C" long long horner_push_grid(int n_low, int n_mid, int n_wide,
                                      int n_big, int batch, int cols) {
  if ((cols != 1 && cols != 4) || batch % cols != 0)
    return -(long long)cudaErrorInvalidValue;
  Card c;
  const int err = card_of(&c);
  if (err != 0) return -err;
  Push p{};
  const int counts[4] = {n_low, n_mid, n_wide, n_big};
  long long grid = (long long)c.per_sm[cols == 4] * c.sms;
  const long long blocks =
      (plan_tiers(counts, batch / cols, &p) + kGroups - 1) / kGroups;
  if (grid > blocks) grid = blocks;
  return grid < 1 ? 1 : grid;
}

// One push, in one cooperative launch: keys/vals (rows, width) is the
// packed table, each row sorted by key with PAD last; us (batch,) the
// row ids (int64 when ids64, else int32), each in [0, rows); d (n,).
// in_ptr (n+1), in_idx/w (m); order: every node id once, by tier of
// in-degree -- n_low low nodes (up to kUnroll in-edges), n_mid mid
// (up to 32), n_wide wide (up to 128), then n_big big ones. work:
// 4 * n * batch floats, then batch * (l_max + 3) ints of scratch, which
// may hold anything (16-byte aligned); out: the (batch, n) result.
// Returns the CUDA error code of the launch (0 if none); a card without
// cooperative launch gives cudaErrorNotSupported.
extern "C" int horner_push_launch(const int* keys, const float* vals,
                                  const float* d, const void* us, int ids64,
                                  int batch, int width, const int* in_ptr,
                                  const int* in_idx, const float* w,
                                  const int* order, int n_low, int n_mid,
                                  int n_wide, int n_big, int n, int l_max,
                                  float tau, float* work, float* out,
                                  cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  Card c;
  const int err = card_of(&c);
  if (err != 0) return err;
  if (!c.coop) return (int)cudaErrorNotSupported;
  const long long nb = (long long)n * batch;
  const int cols =
      batch % 4 == 0 && reinterpret_cast<std::uintptr_t>(work) % 16 == 0 ? 4
                                                                         : 1;
  const int q = batch / cols;
  // the kernel indexes items, units, entries and levels in 32 bits
  if ((long long)n * q + (long long)n * kWideLanes > 0x7fffffffLL ||
      (long long)batch * width > 0x7fffffffLL ||
      (long long)(l_max + 1) * n > 0x7fffffffLL ||
      (long long)n_low + n_mid + n_wide + n_big != n)
    return (int)cudaErrorInvalidValue;
  int q_shift = -1;
  for (int s = 0; s < 31; ++s)
    if (q == 1 << s) q_shift = s;
  const long long grid =
      horner_push_grid(n_low, n_mid, n_wide, n_big, batch, cols);
  if (grid < 0) return (int)-grid;
  int* runs = reinterpret_cast<int*>(work + 4 * nb);
  Push p{};
  p.in_ptr = in_ptr;
  p.in_idx = in_idx;
  p.w = w;
  p.order = order;
  p.keys = keys;
  p.vals = vals;
  p.d = d;
  p.us = us;
  p.frontier = work;
  p.stage = work + 2 * nb;
  p.runs = runs;
  p.last = runs + (long long)batch * (l_max + 2);
  p.out = out;
  p.ids64 = ids64;
  p.n = n;
  p.batch = batch;
  p.width = width;
  p.l_max = l_max;
  const int counts[4] = {n_low, n_mid, n_wide, n_big};
  p.work = (int)plan_tiers(counts, q, &p);
  p.q = q;
  p.q_shift = q_shift;
  p.tau = tau;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(kernel_of(cols),
                                          dim3((unsigned)grid),
                                          dim3(kGroup * kGroups), args, 0,
                                          stream);
}

// ---------------------------------------------------------------------------
// The slab step: one Horner level on one node slab, for the node-sharded
// push (core/shard_query.py). The TPU kernel horner_step is itself one
// level on one slab, and the reference's sharded push calls it once per
// level with the frontier all-gathered outside it; a collective cannot run
// inside the cooperative launch above, so the sharded push launches this
// entry once per level per shard instead. For the n_loc rows v of the
// slab [slab_start, slab_start + n_loc):
//
//   out[v, b] = sum_{e in I(v)} w_e * prune_tau(x[src_e, b]) + seed[v, b]
//   seed[v, b] = sum over the entries j of row b whose key is
//                level * n + slab_start + v of vals[b, j] * d_v,
//   d_v = d[slab_start + v - d_offset]
//
// x is the gathered node-major (rows, B) frontier, src_e a global row of
// it, or null at the first level of a push (a zero frontier: no pull).
// Rows past n (the padding of the last slab) get no seed. The slab's rows
// come in tiers of in-degree (the layout's push_order / push_tiers): a low
// row (up to kUnroll in-edges) takes a thread a column group; a mid or wide
// row (up to 128) a warp, and a big row a block of kSlabBlock threads,
// whose slots stride I(v) and whose partials meet in slot order through
// shared memory. The pull is summed in a fixed order and the seed added
// after it, with no atomics, so two launches give the same bits. Nothing
// that the launch reads is written during it, so x, the rows and the CSR
// go through the read-only path.
namespace {

constexpr int kSlabBlock = 256;
constexpr int kWarp = 32;

struct Slab {
  const int* in_ptr;   // (n_loc + 1,)
  const int* in_idx;   // (m_loc,) global rows of x
  const float* w;      // (m_loc,)
  const int* order;    // the slab's rows by tier: low, mid, wide, big
  const float* x;      // (rows, batch) gathered frontier, or null
  const int* keys;     // (batch, width), each row sorted, PAD last
  const float* vals;   // (batch, width)
  const int* runs;     // (batch, l_max + 2): level l's entries of row b
                       // are runs[b, l] .. runs[b, l + 1] - 1
  const float* d;      // read at slab_start + v - d_offset
  float* out;          // (n_loc, batch)
  int n, n_loc, slab_start, d_offset, batch, width, l_max, level;
  int n_low, n_team, n_big;  // low rows; mid and wide rows; big rows
  int team_blocks;           // blocks of the mid and wide rows
  int q;                     // column groups of C a row
  float tau;
};

template <int C>
__device__ __forceinline__ void slab_pull(const Slab& p, int e0, int e1,
                                          int stride, int c0,
                                          float (&acc)[C]) {
  pull_edges<ReadOnly, C>(p.in_idx, p.w, p.x, p.batch, p.tau, e0, e1, stride,
                          c0, acc);
}

// the seed of output (v, b): the entries of row b whose key is
// level * n + slab_start + v
__device__ __forceinline__ float slab_seed(const Slab& p, int b, int v) {
  const long long base = (long long)b * p.width;
  return run_seed<ReadOnly>(p.runs + b * (p.l_max + 2) + p.level,
                            p.keys + base, p.vals + base,
                            p.level * p.n + p.slab_start + v,
                            p.d + (p.slab_start + v - p.d_offset));
}

// out[v, c0 .. c0 + C) = acc + the seed (none past n)
template <int C>
__device__ __forceinline__ void slab_finish(const Slab& p, int v, int c0,
                                            float (&acc)[C]) {
  if (p.slab_start + v < p.n) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += slab_seed(p, c0 + c, v);
  }
  store<C>(p.out + (long long)v * p.batch + c0, acc);
}

template <int T>
__device__ __forceinline__ void team_sync() {
  if constexpr (T == kWarp) __syncwarp(); else __syncthreads();
}

// row v with a team of T threads (a warp, or a whole block), thread r of
// it: slot r / q of T / q walks every (T / q)-th in-edge of column group
// r % q, the slots' partials meet in slot order in `part` (T * C floats);
// past T / 2 column groups each thread takes whole column groups alone
template <int C, int T>
__device__ __forceinline__ void slab_team(const Slab& p, int v, int r,
                                          float* part) {
  const int q = p.q;
  const int e0 = __ldg(p.in_ptr + v), e1 = __ldg(p.in_ptr + v + 1);
  if (q > T / 2) {
    for (int qi = r; qi < q; qi += T) {
      float acc[C] = {};
      if (p.x) slab_pull<C>(p, e0, e1, 1, qi * C, acc);
      slab_finish<C>(p, v, qi * C, acc);
    }
    return;
  }
  const int slots = T / q;
  const int slot = r / q, qi = r - slot * q;
  float s[C] = {};
  if (slot < slots && p.x) slab_pull<C>(p, e0 + slot, e1, slots, qi * C, s);
#pragma unroll
  for (int c = 0; c < C; ++c) part[r * C + c] = s[c];
  team_sync<T>();
  if (r < q) {
    float acc[C] = {};
    for (int k = 0; k < slots; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += part[(k * q + r) * C + c];
    slab_finish<C>(p, v, r * C, acc);
  }
}

// blocks: one a big row, then the mid and wide rows kSlabBlock / kWarp a
// block (a warp each), then the low rows' column groups a thread each
template <int C>
__global__ void __launch_bounds__(kSlabBlock)
slab_step_kernel(Slab p) {
  __shared__ float part[kSlabBlock * C];
  const int r = threadIdx.x;
  int u = blockIdx.x;
  if (u < p.n_big) {
    slab_team<C, kSlabBlock>(p, __ldg(p.order + p.n_low + p.n_team + u), r,
                             part);
    return;
  }
  u -= p.n_big;
  if (u < p.team_blocks) {
    const int i = u * (kSlabBlock / kWarp) + r / kWarp;
    if (i < p.n_team)
      slab_team<C, kWarp>(p, __ldg(p.order + p.n_low + i), r % kWarp,
                          part + (r / kWarp) * kWarp * C);
    return;
  }
  u -= p.team_blocks;
  const long long t = (long long)u * kSlabBlock + r;
  if (t >= (long long)p.n_low * p.q) return;
  const int i = (int)(t / p.q), qi = (int)(t - (long long)i * p.q);
  const int v = __ldg(p.order + i);
  float acc[C] = {};
  if (p.x)
    slab_pull<C>(p, __ldg(p.in_ptr + v), __ldg(p.in_ptr + v + 1), 1, qi * C,
                 acc);
  slab_finish<C>(p, v, qi * C, acc);
}

}  // namespace

// One level on one slab (see above): x (rows, batch) node-major or null;
// the slab's CSR in_ptr (n_loc + 1), in_idx / w (its in-edges, global rows
// of x), order (its rows by tier: n_low, n_mid, n_wide, n_big); keys / vals
// (batch, width) the query rows, each sorted by key with PAD last; runs
// (batch, l_max + 2) their level run starts; d read at
// slab_start + v - d_offset; out (n_loc, batch). Returns the CUDA error code
// of the launch (0 if none).
extern "C" int horner_slab_step_launch(
    const float* x, const int* in_ptr, const int* in_idx, const float* w,
    const int* order, int n_low, int n_mid, int n_wide, int n_big,
    const int* keys, const float* vals, const int* runs, const float* d,
    int batch, int width, int n, int n_loc, int slab_start, int d_offset,
    int l_max, int level, float tau, float* out, cudaStream_t stream) {
  if (batch <= 0 || n_loc <= 0) return 0;
  if ((long long)n_low + n_mid + n_wide + n_big != n_loc ||
      (long long)(l_max + 1) * n > 0x7fffffffLL || level < 0 ||
      level > l_max || (long long)slab_start + n_loc > 0x7fffffffLL ||
      (long long)batch * width > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(x) |
        reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  const int cols = batch % 4 == 0 && aligned ? 4 : 1;
  Slab p{};
  p.in_ptr = in_ptr;
  p.in_idx = in_idx;
  p.w = w;
  p.order = order;
  p.x = x;
  p.keys = keys;
  p.vals = vals;
  p.runs = runs;
  p.d = d;
  p.out = out;
  p.n = n;
  p.n_loc = n_loc;
  p.slab_start = slab_start;
  p.d_offset = d_offset;
  p.batch = batch;
  p.width = width;
  p.l_max = l_max;
  p.level = level;
  p.n_low = n_low;
  p.n_team = n_mid + n_wide;
  p.n_big = n_big;
  p.team_blocks = (p.n_team + kSlabBlock / kWarp - 1) / (kSlabBlock / kWarp);
  p.q = batch / cols;
  p.tau = tau;
  const long long low_blocks =
      ((long long)n_low * p.q + kSlabBlock - 1) / kSlabBlock;
  const long long grid = (long long)n_big + p.team_blocks + low_blocks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (cols == 4)
    slab_step_kernel<4><<<(unsigned)grid, kSlabBlock, 0, stream>>>(p);
  else
    slab_step_kernel<1><<<(unsigned)grid, kSlabBlock, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
