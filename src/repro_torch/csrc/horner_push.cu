// The SLING Horner push for Hopper (sm_90a): one persistent cooperative
// launch over node slabs, from a batch of query ids to the scores,
//
//     for l = hi .. lo:
//       acc[r, b] = seed_l[r, b]
//                   + sum_{e in I(r)} w_e * prune_tau(acc[src_e, b])
//     seed_l[r, b] = sum over the entries j of query b's packed row whose
//                    key is l*n + r of vals[j] * d[r]   (duplicate keys
//                    add up; none for a row r >= n)
//
// over the rows r of the node dimension, cut into up to kMaxSlabs slabs
// that lie on this device: slab s owns rows [start, start + n_loc), the
// CSR of their in-edges (sources are global rows), their tiers of
// in-degree, d (read at r - d_offset) and the result of level 0. A
// single-source push is one slab of all n rows from the top level to 0
// (horner_push_rows); a node-sharded push is every slab a device holds
// (horner_push_slabs: the S slabs of a ShardedIndex or of a pod group on
// one card in one launch, or one level at a time on each card of a mesh
// with the exchange between launches).
//
// Replaces the TPU kernel src/repro/kernels/horner_push/horner_push.py:69
// (_step_kernel / horner_step), which lands messages on destination
// blocks with a one-hot MXU matmul and builds the seed with a masked
// one-hot sum over the packed row. Its Horner loop
// (src/repro/kernels/horner_push/ops.py) runs one step per level over
// rows that the host gathered and prepared first; in its sharded role
// (src/repro/core/single_source.py horner_push with slab_start /
// d_offset / gather) the reference calls it once per level per shard,
// with the frontier all-gathered over the mesh outside the kernel.
//
// What bounds it on the H100. Bytes: the push reads the B packed rows,
// d, every slab's CSR once and writes the result -- about 2.6 MB at the
// Enron regime and B = 8, under a microsecond at the HBM rate. Each
// level that runs re-reads the frontier from L2 through the in-edges, a
// few MB of L2 traffic a level. And latency: a level cannot start
// before the last output of the level above is written, so each level
// pays one grid barrier plus the longest chain of dependent loads in
// it; a launch pays its own latency once, however many levels and
// slabs it covers. The design:
//   * one launch for every level and every slab of a device: the levels
//     run inside one cooperative launch whose grid is every block of
//     1,024 threads the card holds at once (capped at a level's work); a
//     block is four groups of 256 threads, each working on its own unit
//     of a level (below) with a grid stride, and cooperative_groups'
//     grid barrier separates the levels;
//   * the all-gather on one device is no copy: every slab writes its
//     rows of a level straight into the device's node-major (rows, B)
//     frontier at global row start + v, the same buffer that every
//     slab's in-edges read at the next level, so after the barrier the
//     gathered frontier is already in place. On a mesh of several
//     devices the caller copies each device's rows into the others'
//     buffers between launches of one level each;
//   * no preparation on the host: the kernel reads each query's packed
//     row through its id from the segment of the row source that holds
//     the id (the shards' own tables, one whole table, or rows fetched
//     for the call), as hp_join does. A prologue finds where each
//     level's run starts in each row -- rows are sorted by key = l*n + k
//     with PAD last, so run boundaries are where an entry's level
//     differs from its left neighbour's: one coalesced pass over the B
//     rows, with no chain of dependent loads -- and the highest level of
//     each row. After one barrier every block takes the highest level
//     that holds a seed from those B values: above it a push from a zero
//     frontier is exactly zero, so the levels run from there (or from
//     hi, when the caller launches a range of levels below it);
//   * the first level of a launch searches its seeds in the level's run;
//     at the push's first level it reads no frontier (its input is
//     zero). Below it, the seeds of level l are staged densely during
//     level l + 1 (the thread at the head of each run of equal keys sums
//     the run in order), so an output's seed is one load; the output
//     clears what it read, which leaves the buffer zero for its reuse
//     two levels on. The search and the staging sum the same entries in
//     the same order, so a range of levels launched one at a time gives
//     the bits of one launch over all of them;
//   * level 0 writes straight into each slab's result ((n_loc, B)
//     node-major, or (B, n) for a single-source push), so nothing is
//     transposed after the launch;
//   * dependent chains, which are what a level waits for: a thread
//     walks 4 columns of a row with 16-byte frontier loads where B is
//     a multiple of 4 (else 1 column), so the B lanes of a row share
//     one walk of its in-edges and read one contiguous frontier row. It
//     issues its seed's staging load first, then loads the indices and
//     weights of kUnroll edges, then their frontier rows, then adds
//     them in edge order; the last batch is cut short by a predicate,
//     so a row of in-degree up to kUnroll waits for one index load and
//     one frontier load in all;
//   * a level waits for its slowest thread, so a row gets threads by its
//     in-degree: each slab's layout orders its rows in tiers
//     (PUSH_TIERS) -- low rows (up to kUnroll in-edges, most of them)
//     take a thread a column group, mid rows (up to 32) kMidLanes
//     threads and wide rows (up to 128) kWideLanes, whose slots stride
//     I(v) so that each waits for one batch and meet in a fixed shuffle
//     tree, and big rows a group each, whose slots' partials meet in a
//     fixed order (a shuffle tree in each warp, then the warps in
//     order). The units of every slab's tiers are laid end to end tier
//     by tier (every slab's big rows first, so that the longest walks
//     start in the first round of the grid stride), and a unit finds its
//     slab by a prefix over at most kMaxSlabs slabs. Sized so, a level
//     of a serving batch (B = 8) fits the grid once;
//   * the staging of the next level's seeds runs on the grid's last
//     threads, which a level leaves idle at serving batch sizes.
// Every output is summed in a fixed order set by its tier's slots, never
// by the grid size, with the seed added after and no atomics on scores,
// so two launches on the same inputs give the same bits. The frontiers,
// the staging buffers and the prologue's tables are written by other
// blocks during the launch, so they are never read through the
// non-coherent read-only path (__ldg could return a line cached before
// another block's store): only ld.global.cg (L2) loads. The CSR, the
// tables, d and the ids do not change during the launch and are read
// with __ldg. With bf16 (the pod path's exchange format) every value
// stored into the frontier is rounded through bfloat16; level 0's result
// stays float32.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 256;     // threads of one unit of work
constexpr int kGroups = 4;      // units a block: 1,024 threads
constexpr int kUnroll = 8;      // edges whose loads are in flight at once
constexpr int kMidLanes = 16;   // threads of one mid row
constexpr int kWideLanes = 32;  // threads of one wide row
constexpr int kMaxDevices = 64;
constexpr int kMaxSlabs = 16;     // slabs a launch (passed by value)
constexpr int kMaxSegments = 16;  // segments of the row source
constexpr int kPad = 0x7fffffff;
constexpr long long kInt = 0x7fffffffLL;

struct Slab {
  const int* in_ptr;   // (n_loc + 1,)
  const int* in_idx;   // (m_loc,) global rows of the frontier
  const float* w;      // (m_loc,)
  const int* order;    // the slab's rows by tier: low, mid, wide, big
  const float* d;      // read at global row - d_offset
  float* out;          // level 0's result: (n_loc, B), or (B, n_loc)
  int start, n_loc, d_offset;
  // the tiers as this batch runs them: a tier whose lanes cannot hold
  // two slots of q column groups runs with its neighbour in `order`
  int low_items;       // low rows * q: a thread a column group
  int mid0, n_mid, wide0, n_wide, big0;
  // where this slab's units end in each tier's run of units (a prefix
  // over the slabs)
  int big_end, wide_end, mid_end, low_end;
};

struct Segment {       // packed rows of the ids [base, base + rows)
  const int* keys;     // (rows, width), each row sorted, PAD last
  const float* vals;   // (rows, width)
  long long base, rows;
};

struct Push {
  Slab slab[kMaxSlabs];
  Segment seg[kMaxSegments];
  const void* us;      // (B,) query ids, int32 or int64
  float* frontier;     // (2, rows, B): level l writes buffer l & 1
  float* stage;        // (2, rows, B): level l's seeds in buffer l & 1
  int* runs;           // (B, l_max + 2): level l's run starts
  int* last;           // (B,): a row's highest level, -1 if empty
  long long nb;        // rows * B
  int n_slabs, n_segs, ids64, out_bn, bf16;
  int n, batch, width, l_max, hi, lo;
  int big_units, wide_units, mid_units, work;  // units of a level
  int mid_slots, wide_slots;
  int q, q_shift;      // B / C column groups a row; log2(q) or -1
  float tau;
};

// t / q without a division where q is a power of two
__device__ __forceinline__ int div_q(const Push& p, int t) {
  return p.q_shift >= 0 ? t >> p.q_shift : t / p.q;
}

// query b's packed row: its keys and (in *vals) its values, from the
// segment that holds its id; null where no segment does (an empty row)
__device__ __forceinline__ const int* row_of(const Push& p, int b,
                                             const float** vals) {
  const long long u =
      p.ids64 ? __ldg(static_cast<const long long*>(p.us) + b)
              : (long long)__ldg(static_cast<const int*>(p.us) + b);
  for (int s = 0; s < p.n_segs; ++s) {
    const Segment& sg = p.seg[s];
    if (u >= sg.base && u < sg.base + sg.rows) {
      const long long off = (u - sg.base) * p.width;
      *vals = sg.vals + off;
      return sg.keys + off;
    }
  }
  *vals = nullptr;
  return nullptr;
}

// the slab of this launch that owns global row r, or -1
__device__ __forceinline__ int slab_of(const Push& p, int r) {
  for (int s = 0; s < p.n_slabs; ++s)
    if (r >= p.slab[s].start && r < p.slab[s].start + p.slab[s].n_loc)
      return s;
  return -1;
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
// row b's last entry (-1 for an all-PAD row or an id no segment holds).
// Entry j writes the boundaries between its left neighbour's level and
// its own; the last entry also closes the row. Each value has exactly
// one writer.
__device__ void find_runs(const Push& p, int gid, int threads) {
  const int L2 = p.l_max + 2;
  if (p.width == 0) {
    for (int k = gid; k < p.batch * L2; k += threads) p.runs[k] = 0;
    for (int b = gid; b < p.batch; b += threads) p.last[b] = -1;
    return;
  }
  for (int k = gid; k < p.batch * p.width; k += threads) {
    const int b = k / p.width, j = k - b * p.width;
    int* runs = p.runs + b * L2;
    const float* vals;
    const int* row = row_of(p, b, &vals);
    if (row == nullptr) {
      if (j == 0) {
        for (int l = 0; l < L2; ++l) runs[l] = 0;
        p.last[b] = -1;
      }
      continue;
    }
    const int lv = level_of(p, __ldg(row + j));
    const int prev = j == 0 ? -1 : level_of(p, __ldg(row + j - 1));
    for (int l = prev + 1; l <= lv; ++l) runs[l] = j;
    if (j == p.width - 1)
      for (int l = lv + 1; l < L2; ++l) runs[l] = p.width;
    if (lv <= p.l_max && (j == p.width - 1 ||
                          level_of(p, __ldg(row + j + 1)) > p.l_max))
      p.last[b] = lv;
    if (j == 0 && lv > p.l_max) p.last[b] = -1;
  }
}

// the sum of vals[j] * d over the entries from j on whose key is `key`,
// in the row's order: the one sum behind both the search and the staging
// of a seed, so that they agree bit for bit
__device__ __forceinline__ float key_sum(const int* row, const float* vals,
                                         int j, int end, int key, float d) {
  float s = 0.f;
  for (; j < end && __ldg(row + j) == key; ++j)
    s = fmaf(__ldg(vals + j), d, s);
  return s;
}

// the seed of output (r, b) at `level`, r a row of slab sd, searched in
// row b's level run (the first level of a launch); none past n, where
// the key level*n + r would be node (r - n)'s at the next level
__device__ __forceinline__ float seed_at(const Push& p, const Slab& sd,
                                         int b, int level, int r) {
  if (r >= p.n) return 0.f;
  const float* vals;
  const int* row = row_of(p, b, &vals);
  if (row == nullptr) return 0.f;
  const int* run = p.runs + b * (p.l_max + 2) + level;
  int lo = load_l2(run), hi = load_l2(run + 1);
  const int end = hi, key = level * p.n + r;  // < 2^31: the launch checks
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < key) lo = mid + 1; else hi = mid;
  }
  if (lo >= end || __ldg(row + lo) != key) return 0.f;
  return key_sum(row, vals, lo, end, key, __ldg(sd.d + (r - sd.d_offset)));
}

// stage level `level`'s seeds densely: the thread at the first entry j
// of each run of equal keys in row b's level run sums the run (as
// seed_at does) into stage[r, b]; no two runs share (r, b). A key whose
// row no slab of this launch owns (another device's) is left alone.
__device__ void stage_seeds(const Push& p, int level, float* stage,
                            int gid, int threads) {
  const int L2 = p.l_max + 2;
  for (int k = gid; k < p.batch * p.width; k += threads) {
    const int b = k / p.width, j = k - b * p.width;
    const int lo = load_l2(p.runs + b * L2 + level);
    const int hi = load_l2(p.runs + b * L2 + level + 1);
    if (j < lo || j >= hi) continue;
    const float* vals;
    const int* row = row_of(p, b, &vals);   // held: its run is not empty
    const int key = __ldg(row + j);
    if (j > lo && __ldg(row + j - 1) == key) continue;
    const int r = key - level * p.n;
    const int s = slab_of(p, r);
    if (s < 0) continue;
    const Slab& sd = p.slab[s];
    stage[(long long)r * p.batch + b] =
        key_sum(row, vals, j, hi, key, __ldg(sd.d + (r - sd.d_offset)));
  }
}

// the level's seed of outputs (r, c0 .. c0+C): searched at the first
// level of the launch, else taken from the staging buffer (through L2:
// other blocks wrote it). Called before the output's in-edges are
// walked, so that the staging load is in flight with theirs.
template <int C>
__device__ __forceinline__ void seed_of(const Push& p, const Slab& sd,
                                        const float* stage, int r, int c0,
                                        int level, bool search,
                                        float (&s)[C]) {
  if (search) {
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = seed_at(p, sd, c0 + c, level, r);
  } else {
    load_l2<C>(stage + (long long)r * p.batch + c0, s);
  }
}

// row v of slab sd, columns c0 .. c0+C: acc + s, the seed from seed_of,
// which is cleared in the staging buffer where it was not zero. Level 0
// writes the slab's result, the others the frontier `out` at the global
// row (rounded through bfloat16 under bf16).
template <int C>
__device__ __forceinline__ void finish(const Push& p, const Slab& sd,
                                       float* out, float* stage, int v,
                                       int c0, int level, bool search,
                                       const float (&s)[C],
                                       float (&acc)[C]) {
  const long long o = (long long)(sd.start + v) * p.batch + c0;
  if (!search) {
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
    if (p.out_bn) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        sd.out[(long long)(c0 + c) * sd.n_loc + v] = acc[c];
    } else {
      store<C>(sd.out + (long long)v * p.batch + c0, acc);
    }
    return;
  }
  if (p.bf16) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] = __bfloat162float(__float2bfloat16_rn(acc[c]));
  }
  store<C>(out + o, acc);
}

// acc[c] += sum over e = e0, e0 + stride, ... < e1 of
// w_e * prune_tau(x[src_e, c0 + c]) over a slab's in_idx / w and the
// node-major (rows, B) frontier x (through L2), in that order. Edges go
// in batches of kUnroll, the last one cut short by a predicate: a batch
// loads its indices and weights, then its frontier rows, then adds, so a
// row of in-degree up to kUnroll waits for one index load and one
// frontier load, not for one chain per edge.
template <int C>
__device__ __forceinline__ void pull_range(const Push& p, const Slab& sd,
                                           const float* x, int e0, int e1,
                                           int stride, int c0,
                                           float (&acc)[C]) {
  for (int e = e0; e < e1; e += kUnroll * stride) {
    int src[kUnroll];
    float wv[kUnroll], xv[kUnroll][C];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int ek = e + k * stride;
      src[k] = ek < e1 ? __ldg(sd.in_idx + ek) : -1;
      wv[k] = ek < e1 ? __ldg(sd.w + ek) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (src[k] >= 0) {
        load_l2<C>(x + (long long)src[k] * p.batch + c0, xv[k]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) xv[k][c] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (src[k] >= 0 && xv[k][c] > p.tau)
          acc[c] = fmaf(wv[k], xv[k][c], acc[c]);
  }
}

// a group's own barrier: named barrier 1 + g over its kGroup threads
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroup) : "memory");
}

// one big row v of slab sd with one group of kGroup threads: thread gt
// is (slot, column group qi) of the row's slots x q; the slots' partials
// meet in a fixed order (a shuffle tree in each warp where q divides 32,
// then the warps in order); `pull`: the input frontier is not zero
template <int C>
__device__ void big_node(const Push& p, const Slab& sd, const float* x,
                         float* out, float* stage, int v, int level,
                         bool pull, bool search, float* part, int g,
                         int gt) {
  const int q = p.q, r = sd.start + v;
  const int e0 = __ldg(sd.in_ptr + v), e1 = __ldg(sd.in_ptr + v + 1);
  if (q > kGroup) {  // one slot: each thread owns whole column groups
    for (int qi = gt; qi < q; qi += kGroup) {
      float acc[C] = {}, sd_[C];
      seed_of<C>(p, sd, stage, r, qi * C, level, search, sd_);
      if (pull) pull_range<C>(p, sd, x, e0, e1, 1, qi * C, acc);
      finish<C>(p, sd, out, stage, v, qi * C, level, search, sd_, acc);
    }
    return;
  }
  const int slots = kGroup / q;
  const int slot = div_q(p, gt), qi = gt - slot * q;
  const bool shuffle = (32 % q) == 0;  // a warp holds 32 / q whole slots
  float sd_[C];
  if (gt < q) seed_of<C>(p, sd, stage, r, gt * C, level, search, sd_);
  if (pull) {
    float s[C] = {};
    if (slot < slots) pull_range<C>(p, sd, x, e0 + slot, e1, slots, qi * C, s);
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
    if (pull) {
      const int parts = shuffle ? kGroup / 32 : slots;
      for (int s = 0; s < parts; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += part[(s * q + gt) * C + c];
    }
    finish<C>(p, sd, out, stage, v, gt * C, level, search, sd_, acc);
  }
  group_sync(g);  // part is reused by the group's next row
}

// one row's share of a level for thread r of its kLanes, the row being
// entry i of the tier's `count` ids from sd.order[first_id]: slot r / q
// of `slots` walks every slots-th in-edge of column group r % q, so a
// row of in-degree up to kUnroll * slots waits for one batch of loads;
// the slots meet in a fixed shuffle tree (lanes of one column group sit
// q apart), and slot 0 writes the output. Every lane of the warp takes
// part in the shuffles, inside the tier or not.
template <int C, int kLanes>
__device__ __forceinline__ void lanes_node(const Push& p, const Slab& sd,
                                           int t, int first_id, int count,
                                           int slots, int level, bool pull,
                                           bool search, const float* x,
                                           float* out, float* stage) {
  const int i = t / kLanes, r = t - i * kLanes;
  const int slot = div_q(p, r), qi = r - slot * p.q;
  const bool mine = i < count, lead = mine && slot == 0;
  const int v = mine ? __ldg(sd.order + first_id + i) : 0;
  float acc[C] = {}, s[C];
  if (lead) seed_of<C>(p, sd, stage, sd.start + v, qi * C, level, search, s);
  if (mine && pull)
    pull_range<C>(p, sd, x, __ldg(sd.in_ptr + v) + slot,
                  __ldg(sd.in_ptr + v + 1), slots, qi * C, acc);
  for (int off = kLanes / 2; off >= p.q; off >>= 1)
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off, kLanes);
  if (lead) finish<C>(p, sd, out, stage, v, qi * C, level, search, s, acc);
}

// unit u's slab in a tier's run of units, and u's index among that
// slab's units of the tier (end: the member holding the prefix)
#define SLAB_OF_UNIT(END)                                  \
  int k = 0;                                               \
  while (u >= p.slab[k].END) ++k;                          \
  const Slab& sd = p.slab[k];                              \
  const int i = u - (k ? p.slab[k - 1].END : 0);

// one unit of a level: a big row, kGroup / kWideLanes wide rows,
// kGroup / kMidLanes mid rows, or kGroup low items (a low row's column
// group each), of the slab the unit falls in
template <int C>
__device__ __forceinline__ void run_unit(const Push& p, int u, int level,
                                         bool pull, bool search,
                                         const float* x, float* out,
                                         float* stage, float* part, int g,
                                         int gt) {
  if (u < p.big_units) {
    SLAB_OF_UNIT(big_end)
    big_node<C>(p, sd, x, out, stage, __ldg(sd.order + sd.big0 + i), level,
                pull, search, part, g, gt);
    return;
  }
  u -= p.big_units;
  if (u < p.wide_units) {
    SLAB_OF_UNIT(wide_end)
    lanes_node<C, kWideLanes>(p, sd, i * kGroup + gt, sd.wide0, sd.n_wide,
                              p.wide_slots, level, pull, search, x, out,
                              stage);
    return;
  }
  u -= p.wide_units;
  if (u < p.mid_units) {
    SLAB_OF_UNIT(mid_end)
    lanes_node<C, kMidLanes>(p, sd, i * kGroup + gt, sd.mid0, sd.n_mid,
                             p.mid_slots, level, pull, search, x, out,
                             stage);
    return;
  }
  u -= p.mid_units;
  SLAB_OF_UNIT(low_end)
  const int t = i * kGroup + gt;
  if (t >= sd.low_items) return;
  const int j = div_q(p, t);
  const int v = __ldg(sd.order + j), c0 = (t - j * p.q) * C;
  float acc[C] = {}, s[C];
  seed_of<C>(p, sd, stage, sd.start + v, c0, level, search, s);
  if (pull)
    pull_range<C>(p, sd, x, __ldg(sd.in_ptr + v), __ldg(sd.in_ptr + v + 1),
                  1, c0, acc);
  finish<C>(p, sd, out, stage, v, c0, level, search, s, acc);
}

#undef SLAB_OF_UNIT

// kGroups groups of kGroup threads a block, each group working on its
// own unit of a level: a block of kGroups groups arrives at the grid
// barrier once, where kGroups blocks would arrive kGroups times. The
// slab table is a __grid_constant__ parameter: a unit indexes it where
// it lies, with no copy to local memory.
template <int C>
__global__ void __launch_bounds__(kGroup * kGroups, 1)
horner_push_kernel(const __grid_constant__ Push p) {
  __shared__ float part[kGroups][kGroup * C];
  __shared__ int top;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, g = tid / kGroup, gt = tid % kGroup;
  const int gid = blockIdx.x * blockDim.x + tid;
  const int threads = gridDim.x * blockDim.x;
  // prologue: the level runs and, where the launch stages seeds (more
  // than one level), both staging buffers zeroed
  find_runs(p, gid, threads);
  if (p.hi > p.lo) {
    if constexpr (C == 4) {
      float4* s4 = reinterpret_cast<float4*>(p.stage);
      for (long long k = gid; k < p.nb / 2; k += threads)
        s4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (long long k = gid; k < 2 * p.nb; k += threads) p.stage[k] = 0.f;
    }
  }
  if (tid == 0) top = -1;
  grid.sync();
  // the highest level that holds a seed in any row (-1: none)
  int mine = -1;
  for (int b = tid; b < p.batch; b += blockDim.x)
    mine = max(mine, load_l2(p.last + b));
  if (mine >= 0) atomicMax(&top, mine);
  __syncthreads();
  const int start = max(top, 0);         // the push's first level
  const int first = min(p.hi, start);    // this launch's first level
  const int units = gridDim.x * kGroups, u0 = blockIdx.x * kGroups + g;
  for (int level = first; level >= p.lo; --level) {
    float* out = p.frontier + (level & 1) * p.nb;
    const float* x = p.frontier + ((level + 1) & 1) * p.nb;
    // level l's seeds are staged during level l + 1 into buffer l % 2;
    // each output takes and clears its own, so a buffer is zero again
    // by the time level l - 1 stages into it. Staged by the grid's last
    // threads, which a level leaves idle unless its work fills the grid
    if (level > p.lo)
      stage_seeds(p, level - 1, p.stage + ((level - 1) & 1) * p.nb,
                  threads - 1 - gid, threads);
    float* stage = p.stage + (level & 1) * p.nb;
    for (int u = u0; u < p.work; u += units)
      run_unit<C>(p, u, level, level < start, level == first, x, out, stage,
                  part[g], g, gt);
    if (level > p.lo) grid.sync();
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

// slots a row of a tier of kLanes threads gets: kLanes / q where that
// is at least two slots of q column groups, else 0 (the tier then runs
// with its neighbour)
int slots_of(int lanes, int q) {
  return q <= lanes / 2 && lanes % q == 0 ? lanes / q : 0;
}

long long units_of(long long threads) {
  return (threads + kGroup - 1) / kGroup;
}

struct Units {
  long long big, wide, mid, low;
};

// the tiers of a slab's `order` (counts: low, mid, wide, big) as a batch
// of q column groups a row runs them; returns the slab's units of each
Units plan_tiers(const int* counts, int q, Slab* s) {
  const int mid_slots = slots_of(kMidLanes, q);
  const int wide_slots = slots_of(kWideLanes, q);
  const int n_mid = mid_slots ? counts[1] : 0;
  const int n_wide = wide_slots ? counts[2] : 0;
  const long long low = counts[0] + (mid_slots ? 0 : counts[1]);
  s->low_items = (int)(low * q);
  s->mid0 = counts[0];
  s->n_mid = n_mid;
  s->wide0 = counts[0] + counts[1];
  s->n_wide = n_wide;
  s->big0 = counts[0] + counts[1] + n_wide;
  return {(long long)counts[3] + (wide_slots ? 0 : counts[2]),
          units_of((long long)n_wide * kWideLanes),
          units_of((long long)n_mid * kMidLanes), units_of(low * q)};
}

// every slab's tiers (4 counts a slab) laid end to end tier by tier;
// returns the units of a level (at most 2^31 - 1 for the kernel)
long long plan(Push* p, int n_slabs, const int* tiers, int q) {
  Units per[kMaxSlabs];
  Units sum{0, 0, 0, 0};
  for (int s = 0; s < n_slabs; ++s) {
    per[s] = plan_tiers(tiers + 4 * s, q, &p->slab[s]);
    sum.big += per[s].big;
    sum.wide += per[s].wide;
    sum.mid += per[s].mid;
    sum.low += per[s].low;
  }
  const long long work = sum.big + sum.wide + sum.mid + sum.low;
  if (work > kInt) return work;
  Units end{0, 0, 0, 0};
  for (int s = 0; s < n_slabs; ++s) {
    p->slab[s].big_end = (int)(end.big += per[s].big);
    p->slab[s].wide_end = (int)(end.wide += per[s].wide);
    p->slab[s].mid_end = (int)(end.mid += per[s].mid);
    p->slab[s].low_end = (int)(end.low += per[s].low);
  }
  p->big_units = (int)sum.big;
  p->wide_units = (int)sum.wide;
  p->mid_units = (int)sum.mid;
  p->work = (int)work;
  p->mid_slots = slots_of(kMidLanes, q);
  p->wide_slots = slots_of(kWideLanes, q);
  return work;
}

// every block the card holds at once, capped at a level's units of work
long long grid_of(const Card& c, long long work, int cols) {
  long long grid = (long long)c.per_sm[cols == 4] * c.sms;
  const long long blocks = (work + kGroups - 1) / kGroups;
  if (grid > blocks) grid = blocks;
  return grid < 1 ? 1 : grid;
}

}  // namespace

// The grid of a launch over n_slabs slabs whose rows come in tiers
// (tiers: 4 counts a slab -- low, mid, wide, big) for a batch of `batch`
// columns walked `cols` (1 or 4) at a time by a thread: every block the
// card holds at once, capped at a level's units of work. Returns the
// block count, or minus a CUDA error code.
extern "C" long long horner_push_grid(int n_slabs, const int* tiers,
                                      int batch, int cols) {
  if ((cols != 1 && cols != 4) || batch <= 0 || batch % cols != 0 ||
      n_slabs < 1 || n_slabs > kMaxSlabs)
    return -(long long)cudaErrorInvalidValue;
  Card c;
  const int err = card_of(&c);
  if (err != 0) return -err;
  Push p{};
  const long long work = plan(&p, n_slabs, tiers, batch / cols);
  if (work > kInt) return -(long long)cudaErrorInvalidValue;
  return grid_of(c, work, cols);
}

// One cooperative launch over the levels [min(hi, top) .. lo] of a push
// (top: the highest level that holds a seed, found by the kernel) on the
// n_slabs slabs that lie on this device.
//   slab_ptrs: 6 a slab -- in_ptr (n_loc + 1), in_idx / w (its in-edges;
//     in_idx global rows of the frontier), order (its rows by tier), d
//     (read at global row - d_offset), out (level 0's result: (n_loc,
//     batch) node-major, or (batch, n_loc) when out_bn);
//   slab_ints: 7 a slab -- start, n_loc, d_offset, then the tier counts
//     n_low, n_mid, n_wide, n_big (of order: up to kUnroll, 32, 128
//     in-edges, then more), which add up to n_loc; the slabs' rows lie
//     in [0, rows);
//   segs: 4 a segment -- keys, vals ((seg rows, width), each row sorted
//     by key with PAD last), base, seg rows: the packed rows of the ids
//     [base, base + seg rows);
//   us (batch,): the query ids (int64 when ids64, else int32); an id no
//     segment holds is an empty row;
//   work: 4 * rows * batch floats (the two node-major frontiers, then
//     the two staging buffers), then batch * (l_max + 3) ints, 16-byte
//     aligned. The frontier of level hi + 1 must hold the push's rows
//     when hi is below the push's top level (from earlier launches, and
//     on a mesh the exchange); everything else may hold anything.
// Level l's outputs go to frontier buffer l & 1 at their global rows
// (rounded through bfloat16 when bf16), level 0's to the slabs' out.
// Returns the CUDA error code of the launch (0 if none); a card without
// cooperative launch gives cudaErrorNotSupported.
extern "C" int horner_push_slabs_launch(
    int n_slabs, const long long* slab_ptrs, const int* slab_ints,
    int n_segs, const long long* segs, int width, const void* us, int ids64,
    int batch, int n, long long rows, int l_max, int hi, int lo, int out_bn,
    int bf16, float tau, float* work, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (n_slabs < 1 || n_slabs > kMaxSlabs || n_segs < 0 ||
      n_segs > kMaxSegments || n <= 0 || width < 0 || l_max < 0 || lo < 0 ||
      hi < lo || hi > l_max || rows <= 0 || rows > kInt ||
      (long long)batch * width > kInt || (long long)(l_max + 1) * n > kInt)
    return (int)cudaErrorInvalidValue;
  Card c;
  const int err = card_of(&c);
  if (err != 0) return err;
  if (!c.coop) return (int)cudaErrorNotSupported;
  bool aligned = reinterpret_cast<std::uintptr_t>(work) % 16 == 0;
  for (int s = 0; s < n_slabs && !out_bn; ++s)
    aligned = aligned && slab_ptrs[6 * s + 5] % 16 == 0;
  const int cols = batch % 4 == 0 && aligned ? 4 : 1;
  const int q = batch / cols;
  Push p{};
  int tiers[4 * kMaxSlabs];
  for (int s = 0; s < n_slabs; ++s) {
    const long long* ptr = slab_ptrs + 6 * s;
    const int* in = slab_ints + 7 * s;
    Slab& sd = p.slab[s];
    sd.in_ptr = reinterpret_cast<const int*>(ptr[0]);
    sd.in_idx = reinterpret_cast<const int*>(ptr[1]);
    sd.w = reinterpret_cast<const float*>(ptr[2]);
    sd.order = reinterpret_cast<const int*>(ptr[3]);
    sd.d = reinterpret_cast<const float*>(ptr[4]);
    sd.out = reinterpret_cast<float*>(ptr[5]);
    sd.start = in[0];
    sd.n_loc = in[1];
    sd.d_offset = in[2];
    long long count = 0;
    for (int t = 0; t < 4; ++t) count += tiers[4 * s + t] = in[3 + t];
    // the kernel indexes a slab's items, units and rows in 32 bits
    if (sd.start < 0 || sd.n_loc < 0 || count != sd.n_loc ||
        (long long)sd.start + sd.n_loc > rows ||
        (long long)sd.n_loc * q + (long long)sd.n_loc * kWideLanes > kInt)
      return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_segs; ++s) {
    const long long* sg = segs + 4 * s;
    p.seg[s].keys = reinterpret_cast<const int*>(sg[0]);
    p.seg[s].vals = reinterpret_cast<const float*>(sg[1]);
    p.seg[s].base = sg[2];
    p.seg[s].rows = sg[3];
  }
  const long long units = plan(&p, n_slabs, tiers, q);
  if (units > kInt) return (int)cudaErrorInvalidValue;
  int q_shift = -1;
  for (int s = 0; s < 31; ++s)
    if (q == 1 << s) q_shift = s;
  const long long nb = rows * batch;
  int* runs = reinterpret_cast<int*>(work + 4 * nb);
  p.us = us;
  p.frontier = work;
  p.stage = work + 2 * nb;
  p.runs = runs;
  p.last = runs + (long long)batch * (l_max + 2);
  p.nb = nb;
  p.n_slabs = n_slabs;
  p.n_segs = n_segs;
  p.ids64 = ids64;
  p.out_bn = out_bn;
  p.bf16 = bf16;
  p.n = n;
  p.batch = batch;
  p.width = width;
  p.l_max = l_max;
  p.hi = hi;
  p.lo = lo;
  p.q = q;
  p.q_shift = q_shift;
  p.tau = tau;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(
      kernel_of(cols), dim3((unsigned)grid_of(c, units, cols)),
      dim3(kGroup * kGroups), args, 0, stream);
}

// One single-source push, levels l_max .. 0 in one launch: the one slab
// of all n rows (in_ptr / in_idx / w / order over the whole graph, d
// (n,)), the packed table keys / vals (rows, width) as the one segment,
// and the (batch, n) result `out`; work as above with rows = n. See
// horner_push_slabs_launch.
extern "C" int horner_push_launch(const int* keys, const float* vals,
                                  long long rows, const float* d,
                                  const void* us, int ids64, int batch,
                                  int width, const int* in_ptr,
                                  const int* in_idx, const float* w,
                                  const int* order, int n_low, int n_mid,
                                  int n_wide, int n_big, int n, int l_max,
                                  float tau, float* work, float* out,
                                  cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const long long ptrs[6] = {
      (long long)in_ptr, (long long)in_idx, (long long)w,
      (long long)order, (long long)d, (long long)out};
  const int ints[7] = {0, n, 0, n_low, n_mid, n_wide, n_big};
  const long long seg[4] = {(long long)keys, (long long)vals, 0, rows};
  return horner_push_slabs_launch(1, ptrs, ints, rows > 0 ? 1 : 0, seg,
                                  width, us, ids64, batch, n, n, l_max,
                                  l_max, 0, 1, 0, tau, work, stream);
}
