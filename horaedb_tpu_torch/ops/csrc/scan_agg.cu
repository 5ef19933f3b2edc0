// Fused scan / filter / time-bucket / group-by / aggregate for Hopper.
//
// Replaces the JAX package's jitted device programs
//   horaedb_tpu/ops/scan_agg.py  scan_agg_body / _fused_scan_agg        (B1a)
//   horaedb_tpu/ops/scan_agg.py  _packed_body / cached_scan_agg_packed   (B1b)
//   horaedb_tpu/ops/scan_agg.py  cached_scan_agg_body                   (B1c)
//   horaedb_tpu/ops/scan_agg.py  _cohort_body / cached_scan_agg_cohort   (B1e)
//   horaedb_tpu/ops/scan_agg.py  _single_segment_agg, _scatter_segment_agg,
//                                _mxu_counts / _mxu_segment_agg          (B2a-c)
//   horaedb_tpu/ops/hash_agg.py  hash_segment_agg                        (B2d)
//   horaedb_tpu/ops/encoding.py  unpack_bits, decode_series/ts/value,
//                                decode_layouts                          (B3)
//   horaedb_tpu/parallel/dist_agg.py  _combine (psum/pmin/pmax)          (B7a)
//
// Three entry points share the reduction cores below:
//   scan_agg_direct  rows of a host-built padded batch (group code, bucket
//                    id, mask, values[F, N]);
//   scan_agg_cached  rows of the resident scan cache: the prologue decodes
//                    each row's series code, timestamp and values from the
//                    resident layout (raw, bf16, delta, dict, dict codes) in
//                    registers, applies the session allow list, the time
//                    range and the numeric filters, then buckets and groups.
//                    SELECTIVE reads row i from the index tail of ``dyn``.
//                    The column decoders live in layouts.cuh, shared with
//                    the raw-read kernels (scan_topk.cu).
//   scan_agg_cohort  B full-scan cached queries in one launch (B1e): member
//                    b reads row b of the stacked sessions and dyns and
//                    writes row b of the packed outputs. A block decodes a
//                    tile of rows once into shared memory (series code,
//                    timestamp, every value field), then runs each
//                    member's allow list, time range, filters and
//                    reduction over the tile: the columns are read and
//                    decoded once for the cohort. Each warp walks its own
//                    part of the tile for every member and commits the
//                    run partial at its end. Arms: single and shared keep
//                    every member's partials in shared memory beside the
//                    tile when they fit there together, else the launch
//                    takes scatter (the wrapper decides).
//
// Two reduction cores, chosen at compile time (scan_agg<ARM, SEGMENTED>):
//
// The run-partial core serves the full scans of the single, shared and
// scatter arms (scan_agg_direct, scan_agg_cached) and the cohort. Bound:
// the bytes of the resident columns (one pass over codes, timestamps and
// the touched value columns); for a cohort the same bytes once plus B
// sessions, dyns and outputs, while its work grows with B. Each warp walks
// a contiguous run of 8 steps of 32 rows (BLOCK * 8 rows a block; the
// cache is sorted by series and time, so neighbouring rows mostly share a
// segment), reduces a step whose valid rows share one segment with
// shuffles into the carried run partial of its segment (lane f owns field
// f), committed when the segment changes; any other step commits lane by
// lane, each min and max a read then a CAS.
//
// The segmented core serves the SELECTIVE launches of every arm (B1b
// selective, B1d) and the hash arm in every form (B2d). What bounds a
// selective launch of a few thousand gathered rows is latency: each step
// is a chain of dependent loads (the index, the series code, the allow
// list, the timestamp, the group map). So:
//   - the grid: the wrapper's ``block_rows`` (ops/scan_agg.py
//     ``segmented_geometry``): the fewest 32-row steps a warp whose blocks
//     the card holds at once (scan_agg_blocks_per_sm, the occupancy at the
//     launch's shared memory), one step a warp for a few thousand rows;
//     every step of the launch runs at once;
//   - a step loads all of its rows' values into registers (FCAP fields a
//     pass) before any shuffle; for a gather before its keep chain, whose
//     allow list, group map and timestamp load together (keep_eager);
//   - a segmented warp reduction: a valid lane heads a run when its
//     segment differs from the previous valid lane's; a 5-round shuffle
//     scan leaves each run's count, sums, mins and maxs in its last lane;
//     a step of more than 16 runs (unsorted rows) skips it and commits
//     lane by lane, as the run-partial core does; the first
//     run merges into the carried partial, the middle runs commit from
//     their last lanes at once, the last becomes the carried partial. On
//     TSBS rows (runs of 6) a step commits about 6 partials, not 32 rows;
//   - commits and flushes take one atomic each for min and max, with no
//     read back (red_min / red_max), and a block flushes one (slot, field)
//     a thread.
// Its bound is the gathered rows' bytes, which a launch of this size never
// nears: what is left is one step's load chain and the launch.
//
// Reduction arms (template ARM):
//   single   n_seg == 1: partials meet in shared memory, one global atomic
//            per block and field;
//   shared   small n_seg: each block keeps count/sum/min/max of every
//            segment in shared memory and merges them with global atomics;
//   scatter  large n_seg: run partials go straight to global atomics;
//   hash     a large n_seg of which few segments are live (B2d): each block
//            keeps an open-addressing table in shared memory, a key (the
//            segment id, EMPTY when free) and count/sum/min/max partials
//            per slot. A run partial hashes its segment with the Fibonacci
//            multiply-shift, claims or finds its slot with atomicCAS on
//            the key over at most ``hash_rounds`` linear probes and
//            accumulates there with shared-memory atomics; one that finds
//            no slot goes to global atomics in the output (the
//            reference's exact scatter fallback) and, when the launch
//            carries an overflow counter, counts its rows there. A claim
//            appends its slot to a list in shared memory, and at block end
//            the claimed slots alone merge into their segments. The table
//            is a block's own, fitted to it by the wrapper
//            (``fitted_hash_slots``: a power of two of at least twice the
//            rows the block takes, at most what fits shared memory), so a
//            small launch clears and flushes a small table and blocks share
//            an SM; it is not one global table as in the reference: which
//            rows overflow differs, the outputs do not. Bound: the same
//            bytes as scatter; what it saves is global atomics on a wide
//            output.
// Counts are int32 atomicAdd, sums f32 atomicAdd. Min and max are exact
// and follow the reference's scatter arm: NaN propagates, and -0.0 < +0.0.
//
// mesh_combine (B7a) is the aggregation monoid over the S partials of a
// sharded aggregate, one launch per combine: counts int32 add, sums f32
// add in shard order, mins fmin_t and maxs fmax_t (the order every arm
// keeps, so a sharded answer is bit-equal to the single-device one where
// the reference's pmin/pmax drop NaN and order +-0 by shard). It serves
// the cached path's packed buffers (planes at offsets of one buffer) and
// the direct path's four arrays alike. Bound: S planes read and one
// written, over HBM bandwidth (sparse-16x12h: 4 x 268 MB read, 268 MB
// written), and nothing else: so the design is a bandwidth-shaped
// elementwise pass.
//   - One 1-D grid over the planes laid end to end: the host puts each
//     plane's first block in CombineArgs (COMBINE_CHUNK elements a block),
//     so the counts plane, 1/F of the others, takes only its own blocks.
//     A block finds its plane once and runs a loop templated on the
//     plane's operation: no branch per element.
//   - 16-byte loads and stores, read-once hints: a thread loads the
//     float4 of COMBINE_GROUP shards for COMBINE_UNROLL vectors before it
//     combines any (__ldcs), in shard order, and stores with __stcs.
//   - What was hard: alignment. A packed plane after the counts starts
//     off 16 bytes when n_seg % 4 != 0, and the rows of a torch.stack of
//     such buffers each at another offset. A plane whose pointers share
//     their offset in 16 bytes peels a scalar head up to the boundary and
//     a scalar tail (block 0 of the plane); a plane whose pointers do not
//     runs the same operation on scalars. Both inside this kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "layouts.cuh"

#define BLOCK 256
#define FULL_MASK 0xffffffffu

enum { ARM_SINGLE = 0, ARM_SHARED = 1, ARM_SCATTER = 2, ARM_HASH = 3 };

// a free slot of the hash arm's table; segment ids are below it
#define EMPTY_KEY 0x7fffffff

struct Out {
  int* counts;   // [n_seg]
  float* sums;   // [n_agg, n_seg]
  float* mins;   // [n_agg, n_seg] (unused unless minmax)
  float* maxs;
  int n_seg;
  int n_agg;
  int minmax;
  int hash_slots;   // ARM_HASH: slots of a block's table, a power of two
  int hash_rounds;  // ARM_HASH: linear probes before a row overflows
  int block_rows;   // segmented launches: rows one block takes (a multiple of BLOCK)
  unsigned long long* overflow;  // ARM_HASH: rows that found no slot, or NULL
};

struct DirectArgs {
  const int* group_codes;
  const int* bucket_ids;
  const uint8_t* mask;
  const float* values;    // [n_fields, n_rows]
  const float* literals;  // [n_filters]
  long long n_rows;
  int n_buckets;
  int device;
  Filters filt;
  Out out;
};

struct CachedArgs {
  Column series;
  Column ts;
  Column fields[MAX_FIELDS];
  const int* session;  // [group map (s1) | allow list (s1)]
  const int* dyn;      // [literals bits | lo, hi, t0, width | row idx]
  long long n_rows;    // rows to scan: padded rows, or the index length
  int s1;
  int n_buckets;
  int device;
  int pad_;
  Filters filt;
  Out out;
};

// clip(floor((ts - t0) / width), 0, nb - 1); the subtraction wraps in
// int32 like the reference's, so it runs in uint32
__device__ __forceinline__ int bucket_of(int ts, int t0, int width, int nb) {
  int d = (int)((uint32_t)ts - (uint32_t)t0);
  int q = d / width;
  if ((d % width != 0) && ((d < 0) != (width < 0))) q -= 1;
  return q < 0 ? 0 : (q > nb - 1 ? nb - 1 : q);
}

// ---- exact min / max ---------------------------------------------------------

__device__ __forceinline__ float fmin_t(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;  // equal: -0.0 wins
}

__device__ __forceinline__ float fmax_t(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;  // equal: +0.0 wins
}

template <bool MIN>
__device__ __forceinline__ void atomic_extreme(float* addr, float v) {
  int* ia = (int*)addr;
  int old = *((volatile int*)ia);
  while (true) {
    float cur = __int_as_float(old);
    float nv = MIN ? fmin_t(cur, v) : fmax_t(cur, v);
    if (__float_as_int(nv) == old) return;
    int prev = atomicCAS(ia, old, __float_as_int(nv));
    if (prev == old) return;
    old = prev;
  }
}

// min / max of a float in memory with one atomic on its bits and no read
// back (the segmented core): fmin_t's / fmax_t's order, -0.0 < +0.0, where
// a non-negative value's bits order as signed ints and a negative one's
// reversed as unsigned ints. A NaN goes in as the bits every later value
// loses to (0xffffffff for min, 0x7fffffff for max), so NaN propagates;
// which NaN differs from fmin_t's, the value does not.
__device__ __forceinline__ void red_min(float* addr, float v) {
  if (isnan(v)) {
    atomicMax((unsigned*)addr, 0xffffffffu);
  } else if (signbit(v)) {
    atomicMax((unsigned*)addr, __float_as_uint(v));
  } else {
    atomicMin((int*)addr, __float_as_int(v));
  }
}

__device__ __forceinline__ void red_max(float* addr, float v) {
  if (isnan(v)) {
    atomicMax((int*)addr, 0x7fffffff);
  } else if (signbit(v)) {
    atomicMin((unsigned*)addr, __float_as_uint(v));
  } else {
    atomicMax((int*)addr, __float_as_int(v));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin_t(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax_t(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// ---- row sources -----------------------------------------------------------

// A row source gives, for launch row r, the row i to read (``index``),
// whether i passes and its segment (``keep``), and its values; ``row`` is
// the two together. ``kGathered``: the rows are a selective gather, whose
// rows mostly pass, so the segmented core loads their values before it
// knows.
struct DirectSource {
  static constexpr bool kGathered = false;
  const DirectArgs& a;
  __device__ DirectSource(const DirectArgs& args) : a(args) {}
  __device__ __forceinline__ long long index(long long r) const { return r; }
  __device__ __forceinline__ bool keep(long long r, int& seg) const {
    if (!a.mask[r]) return false;
    for (int k = 0; k < a.filt.n; ++k) {
      float v = a.values[(long long)a.filt.field[k] * a.n_rows + r];
      if (!compare(v, a.filt.op[k], a.literals[k])) return false;
    }
    seg = a.group_codes[r] * a.n_buckets + a.bucket_ids[r];
    return seg >= 0 && seg < a.out.n_seg;  // out-of-range ids drop, as in a scatter
  }
  // true when row r passes; sets its segment and the row to read values at
  __device__ __forceinline__ bool row(long long r, int& seg, long long& i) const {
    i = r;
    return keep(r, seg);
  }
  __device__ __forceinline__ float value(int f, long long i) const {
    return a.values[(long long)f * a.n_rows + i];
  }
};

// the resident columns of ``a``, read at row i
struct ResidentCols {
  const CachedArgs& a;
  __device__ __forceinline__ int code(long long i) const { return load_int(a.series, i); }
  __device__ __forceinline__ int ts(long long i) const { return load_int(a.ts, i); }
  __device__ __forceinline__ float value(int f, long long i) const {
    return load_value(a.fields[f], i);
  }
};

// one query's session (group map | allow list) and dyn row over the
// columns ``cols`` gives: the allow list, the time range, the numeric
// filters, then the row's group x bucket segment. A series code below 0
// marks a row past the last one.
template <class Cols>
struct QueryRows {
  const CachedArgs& a;
  const int* session;
  const int* dyn;
  Cols cols;
  int lo, hi, t0, width;
  __device__ QueryRows(const CachedArgs& args, const int* session_, const int* dyn_,
                       const Cols& cols_)
      : a(args), session(session_), dyn(dyn_), cols(cols_) {
    const int nf = a.filt.n;
    lo = dyn[nf];
    hi = dyn[nf + 1];
    t0 = dyn[nf + 2];
    width = dyn[nf + 3];
  }
  __device__ __forceinline__ bool keep(long long i, int& seg) const {
    const int code = cols.code(i);
    if (code < 0 || session[a.s1 + code] == 0) return false;
    const int ts = cols.ts(i);
    if (!(ts >= lo && ts < hi)) return false;
    for (int k = 0; k < a.filt.n; ++k) {
      if (!compare(cols.value(a.filt.field[k], i), a.filt.op[k], __int_as_float(dyn[k])))
        return false;
    }
    seg = session[code] * a.n_buckets + bucket_of(ts, t0, width, a.n_buckets);
    return seg >= 0 && seg < a.out.n_seg;
  }
  // keep() for rows that mostly pass (a gather): the allow list, the group
  // map and the timestamp load together once the code is known, one
  // dependent load where keep() takes three
  __device__ __forceinline__ bool keep_eager(long long i, int& seg) const {
    const int code = cols.code(i);
    if (code < 0) return false;
    const int allowed = session[a.s1 + code];
    const int group = session[code];
    const int ts = cols.ts(i);
    if (allowed == 0 || !(ts >= lo && ts < hi)) return false;
    for (int k = 0; k < a.filt.n; ++k) {
      if (!compare(cols.value(a.filt.field[k], i), a.filt.op[k], __int_as_float(dyn[k])))
        return false;
    }
    seg = group * a.n_buckets + bucket_of(ts, t0, width, a.n_buckets);
    return seg >= 0 && seg < a.out.n_seg;
  }
  __device__ __forceinline__ float value(int f, long long i) const { return cols.value(f, i); }
};

// one query over the resident columns; SELECTIVE reads the rows its dyn
// row lists after the four scalars
template <bool SELECTIVE>
struct CachedSource : QueryRows<ResidentCols> {
  static constexpr bool kGathered = SELECTIVE;
  __device__ CachedSource(const CachedArgs& args, const int* session_, const int* dyn_)
      : QueryRows<ResidentCols>(args, session_, dyn_, ResidentCols{args}) {}
  __device__ __forceinline__ long long index(long long r) const {
    return SELECTIVE ? (long long)dyn[a.filt.n + 4 + r] : r;
  }
  __device__ __forceinline__ bool row(long long r, int& seg, long long& i) const {
    i = index(r);
    return keep(i, seg);
  }
};

// ---- reduction cores -------------------------------------------------------

// fields a lane of the segmented core holds in registers at once; wider
// rows take their fields FCAP at a time, one pass over the rows each
#define FCAP 10

// count/sum/min/max partials of n_seg segments (in global or shared
// memory), accumulated with atomics
struct Target {
  int* counts;
  float* sums;
  float* mins;
  float* maxs;
  int n_seg;

  // run-partial core: one run partial, from the whole warp: lane 0 the
  // count, lane f field f
  __device__ __forceinline__ void commit(int seg, int cnt, float s, float mn, float mx,
                                         int lane, int n_agg, bool minmax) const {
    if (seg < 0 || cnt == 0) return;
    if (lane == 0) atomicAdd(&counts[seg], cnt);
    if (lane < n_agg) {
      long long o = (long long)lane * n_seg + seg;
      atomicAdd(&sums[o], s);
      if (minmax) {
        atomic_extreme<true>(&mins[o], mn);
        atomic_extreme<false>(&maxs[o], mx);
      }
    }
  }

  // run-partial core: one row, from one lane
  template <class Src>
  __device__ __forceinline__ void add_row(const Src& src, int seg, long long i, int n_agg,
                                          bool minmax) const {
    atomicAdd(&counts[seg], 1);
    for (int f = 0; f < n_agg; ++f) {
      const float v = src.value(f, i);
      const long long o = (long long)f * n_seg + seg;
      atomicAdd(&sums[o], v);
      if (minmax) {
        atomic_extreme<true>(&mins[o], v);
        atomic_extreme<false>(&maxs[o], v);
      }
    }
  }

  // segmented core: the carried run partial, from the whole warp: lane 0
  // the count (when ``with_count``), lane f field f0 + f of nf
  __device__ __forceinline__ void commit_fields(int seg, int cnt, float s, float mn, float mx,
                                                int lane, int f0, int nf, bool with_count,
                                                bool minmax) const {
    if (seg < 0 || cnt == 0) return;
    if (with_count && lane == 0) atomicAdd(&counts[seg], cnt);
    if (lane < nf) {
      const long long o = (long long)(f0 + lane) * n_seg + seg;
      atomicAdd(&sums[o], s);
      if (minmax) {
        red_min(&mins[o], mn);
        red_max(&maxs[o], mx);
      }
    }
  }

  // segmented core: one run's partial, from the lane that holds it
  __device__ __forceinline__ void add_run(int seg, int cnt, const float* s, const float* mn,
                                          const float* mx, int f0, int nf, bool with_count,
                                          bool minmax) const {
    if (with_count) atomicAdd(&counts[seg], cnt);
#pragma unroll
    for (int f = 0; f < FCAP; ++f) {
      if (f < nf) {
        const long long o = (long long)(f0 + f) * n_seg + seg;
        atomicAdd(&sums[o], s[f]);
        if (minmax) {
          red_min(&mins[o], mn[f]);
          red_max(&maxs[o], mx[f]);
        }
      }
    }
  }
};

// The hash arm's target: a block's slot table (keys, and partials of
// ``H`` slots in ``slots``) in front of the output ``out``. Each slot a
// segment claims is appended to ``claimed`` (``*n_claimed`` long), so the
// block's flush visits the claimed slots only.
struct HashTarget {
  int* keys;
  int* claimed;
  int* n_claimed;
  Target slots;
  Target out;
  int H;
  int rounds;
  unsigned shift;  // 32 - log2(H)
  unsigned long long* overflow;

  // the slot holding ``seg``, claimed if need be, or -1 after ``rounds``
  // probes; a key, once set, never changes, so every row of a segment
  // finds the same slot or none
  __device__ __forceinline__ int find(int seg) const {
    const unsigned h0 = ((unsigned)seg * 2654435769u) >> shift;
    for (int r = 0; r < rounds; ++r) {
      const int slot = (int)((h0 + (unsigned)r) & (unsigned)(H - 1));
      const int k = ((volatile int*)keys)[slot];
      if (k == seg) return slot;
      if (k == EMPTY_KEY) {
        const int prev = atomicCAS(&keys[slot], EMPTY_KEY, seg);
        if (prev == EMPTY_KEY) claimed[atomicAdd(n_claimed, 1)] = slot;
        if (prev == EMPTY_KEY || prev == seg) return slot;
      }
    }
    return -1;
  }

  __device__ __forceinline__ void commit_fields(int seg, int cnt, float s, float mn, float mx,
                                                int lane, int f0, int nf, bool with_count,
                                                bool minmax) const {
    if (seg < 0 || cnt == 0) return;
    int slot = lane == 0 ? find(seg) : 0;
    slot = __shfl_sync(FULL_MASK, slot, 0);
    if (slot >= 0) {
      slots.commit_fields(slot, cnt, s, mn, mx, lane, f0, nf, with_count, minmax);
    } else {
      out.commit_fields(seg, cnt, s, mn, mx, lane, f0, nf, with_count, minmax);
      if (with_count && lane == 0 && overflow) atomicAdd(overflow, (unsigned long long)cnt);
    }
  }

  __device__ __forceinline__ void add_run(int seg, int cnt, const float* s, const float* mn,
                                          const float* mx, int f0, int nf, bool with_count,
                                          bool minmax) const {
    const int slot = find(seg);
    if (slot >= 0) {
      slots.add_run(slot, cnt, s, mn, mx, f0, nf, with_count, minmax);
    } else {
      out.add_run(seg, cnt, s, mn, mx, f0, nf, with_count, minmax);
      if (with_count && overflow) atomicAdd(overflow, (unsigned long long)cnt);
    }
  }
};

// The run-partial core (full scans of the single, shared and scatter
// arms; the cohort): one warp reduces rows [begin, end) into ``t`` and
// commits its last run. A step whose valid rows share one segment reduces
// with shuffles into the carried run partial; any other step commits its
// rows lane by lane.
template <int ARM, class Src, class Sink>
__device__ void reduce_range(const Src& src, long long begin, long long end, const Out& out,
                             const Sink& t) {
  const int lane = threadIdx.x & 31;
  const int n_agg = out.n_agg;
  const bool minmax = out.minmax != 0;

  int run_seg = -1, run_cnt = 0;
  float run_sum = 0.f, run_min = INFINITY, run_max = -INFINITY;

  for (long long base = begin; base < end; base += 32) {
    const long long r = base + lane;
    int seg = 0;
    long long i = 0;
    const bool valid = r < end && src.row(r, seg, i);
    const unsigned vmask = __ballot_sync(FULL_MASK, valid);
    if (vmask == 0) continue;
    const int lead = __ffs(vmask) - 1;
    const int seg0 = __shfl_sync(FULL_MASK, seg, lead);
    const bool uniform = (ARM == ARM_SINGLE) || __all_sync(FULL_MASK, !valid || seg == seg0);
    if (uniform) {
      if (seg0 != run_seg) {
        t.commit(run_seg, run_cnt, run_sum, run_min, run_max, lane, n_agg, minmax);
        run_seg = seg0;
        run_cnt = 0;
        run_sum = 0.f;
        run_min = INFINITY;
        run_max = -INFINITY;
      }
      run_cnt += __popc(vmask);
      for (int f = 0; f < n_agg; ++f) {
        const float v = valid ? src.value(f, i) : 0.f;
        const float s = warp_sum(v);
        float mn = 0.f, mx = 0.f;
        if (minmax) {
          mn = warp_min(valid ? v : INFINITY);
          mx = warp_max(valid ? v : -INFINITY);
        }
        if (lane == f) {
          run_sum += s;
          if (minmax) {
            run_min = fmin_t(run_min, mn);
            run_max = fmax_t(run_max, mx);
          }
        }
      }
    } else if (valid) {
      t.add_row(src, seg, i, n_agg, minmax);
    }
  }
  t.commit(run_seg, run_cnt, run_sum, run_min, run_max, lane, n_agg, minmax);
}

// The segmented core (SELECTIVE launches, and the hash arm in every form):
// one warp reduces fields [f0, f0 + nf) of rows [begin, end) into ``t``
// (a Target or a HashTarget), and their counts when ``with_count``.
//
// A step loads every value of its 32 rows into registers first (before
// the keep chain for a gather, whose rows mostly pass; after it
// otherwise). A valid lane heads a run when its segment differs from the
// previous valid lane's; invalid lanes hold the identity (0, +inf, -inf)
// and head nothing. A step of more than 16 runs commits each valid row
// from its lane. Otherwise a segmented inclusive scan (5 shuffle rounds)
// leaves each run's count, sums, mins and maxs in its last valid lane (a
// step of one-row runs skips it). The first run merges into the carried run
// partial (lane f holds field f0 + f) when it continues its segment; the
// middle runs commit from their last lanes, all at once; the last run
// becomes the carried partial, committed when its segment ends.
// the segmented core's carried run partial: its segment (-1: none) and
// count, and in lane f the sum, min and max of field f0 + f
struct Carried {
  int seg = -1, cnt = 0;
  float sum = 0.f, mn = INFINITY, mx = -INFINITY;

  __device__ __forceinline__ void restart(int seg_) {
    seg = seg_;
    cnt = 0;
    sum = 0.f;
    mn = INFINITY;
    mx = -INFINITY;
  }

  // fold in the run partial that lane ``e`` holds (count ``c`` there)
  __device__ __forceinline__ void absorb(const float (&s)[FCAP], const float (&smin)[FCAP],
                                         const float (&smax)[FCAP], int c, int e, int lane,
                                         int nf) {
    cnt += __shfl_sync(FULL_MASK, c, e);
#pragma unroll
    for (int f = 0; f < FCAP; ++f) {
      if (f < nf) {
        const float x = __shfl_sync(FULL_MASK, s[f], e);
        const float xn = __shfl_sync(FULL_MASK, smin[f], e);
        const float xx = __shfl_sync(FULL_MASK, smax[f], e);
        if (lane == f) {
          sum += x;
          mn = fmin_t(mn, xn);
          mx = fmax_t(mx, xx);
        }
      }
    }
  }

  template <class Sink>
  __device__ __forceinline__ void commit(const Sink& t, int lane, int f0, int nf,
                                         bool with_count, bool minmax) const {
    t.commit_fields(seg, cnt, sum, mn, mx, lane, f0, nf, with_count, minmax);
  }
};

template <class Src, class Sink>
__device__ void reduce_runs(const Src& src, long long begin, long long end, const Out& out,
                            const Sink& t, int f0) {
  const int lane = threadIdx.x & 31;
  const unsigned upto = FULL_MASK >> (31 - lane);  // lanes 0..lane
  const int nf = min(out.n_agg - f0, FCAP);
  const bool with_count = f0 == 0;
  const bool minmax = out.minmax != 0;
  Carried run;

  for (long long base = begin; base < end; base += 32) {
    const long long r = base + lane;
    float s[FCAP], mn[FCAP], mx[FCAP];
    int seg = 0;
    bool valid = false;
    if (r < end) {
      const long long i = src.index(r);
      if constexpr (Src::kGathered) {
#pragma unroll
        for (int f = 0; f < FCAP; ++f) s[f] = f < nf ? src.value(f0 + f, i) : 0.f;
        valid = src.keep_eager(i, seg);
      } else {
        valid = src.keep(i, seg);
#pragma unroll
        for (int f = 0; f < FCAP; ++f) s[f] = (valid && f < nf) ? src.value(f0 + f, i) : 0.f;
      }
    }
#pragma unroll
    for (int f = 0; f < FCAP; ++f) {
      if (!valid) s[f] = 0.f;
      mn[f] = valid ? s[f] : INFINITY;
      mx[f] = valid ? s[f] : -INFINITY;
    }
    const unsigned vmask = __ballot_sync(FULL_MASK, valid);
    if (vmask == 0) continue;
    // heads: valid lanes whose segment differs from the previous valid lane's
    const unsigned before = vmask & (upto >> 1);
    const int prev_seg = __shfl_sync(FULL_MASK, seg, before ? 31 - __clz(before) : lane);
    const unsigned heads = __ballot_sync(FULL_MASK, valid && (before == 0 || prev_seg != seg));
    if (__popc(heads) > 16) {
      // most runs are one row (unsorted segments): each valid lane commits
      // its row; the carried run partial waits for its segment's end
      if (valid) t.add_run(seg, 1, s, mn, mx, f0, nf, with_count, minmax);
      continue;
    }
    // this lane's run starts at the highest head at or below it
    const unsigned hb = heads & upto;
    const int start = hb ? 31 - __clz(hb) : 0;
    const int cnt = __popc(vmask & upto & ~((1u << start) - 1u));
    // ends: valid lanes whose next valid lane heads a run, or that have none
    const unsigned after = vmask & ~upto;
    const bool is_end = valid && (after == 0 || ((heads >> (__ffs(after) - 1)) & 1u));
    const unsigned ends = __ballot_sync(FULL_MASK, is_end);
    if (heads != vmask) {  // some run holds two rows or more
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const bool take = lane - d >= start;
#pragma unroll
        for (int f = 0; f < FCAP; ++f) {
          if (f < nf) {
            const float os = __shfl_up_sync(FULL_MASK, s[f], d);
            if (take) s[f] = os + s[f];
            if (minmax) {
              const float omn = __shfl_up_sync(FULL_MASK, mn[f], d);
              const float omx = __shfl_up_sync(FULL_MASK, mx[f], d);
              if (take) {
                mn[f] = fmin_t(omn, mn[f]);
                mx[f] = fmax_t(omx, mx[f]);
              }
            }
          }
        }
      }
    }
    const int first = __ffs(vmask) - 1, last = 31 - __clz(vmask);
    const int first_end = __ffs(ends) - 1;
    const int seg_first = __shfl_sync(FULL_MASK, seg, first);
    if (seg_first != run.seg) {
      run.commit(t, lane, f0, nf, with_count, minmax);
      run.restart(seg_first);
    }
    run.absorb(s, mn, mx, cnt, first_end, lane, nf);
    if (first_end != last) {
      run.commit(t, lane, f0, nf, with_count, minmax);
      if (is_end && lane != first_end && lane != last)
        t.add_run(seg, cnt, s, mn, mx, f0, nf, with_count, minmax);
      run.restart(__shfl_sync(FULL_MASK, seg, last));
      run.absorb(s, mn, mx, cnt, last, lane, nf);
    }
  }
  run.commit(t, lane, f0, nf, with_count, minmax);
}

// each warp of the grid takes a contiguous run of rows, a multiple of 32;
// the segmented core passes over them once per FCAP fields (once when the
// launch aggregates none)
template <int ARM, bool SEGMENTED, class Src, class Sink>
__device__ void reduce_rows(const Src& src, long long n_rows, const Out& out, const Sink& t) {
  const long long warp = ((long long)blockIdx.x * BLOCK + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * BLOCK) >> 5;
  long long chunk = (n_rows + n_warps - 1) / n_warps;
  chunk = (chunk + 31) & ~31LL;
  const long long begin = warp * chunk;
  const long long end = min(begin + chunk, n_rows);
  if constexpr (SEGMENTED) {
    for (int f0 = 0; f0 == 0 || f0 < out.n_agg; f0 += FCAP) reduce_runs(src, begin, end, out, t, f0);
  } else {
    reduce_range<ARM>(src, begin, end, out, t);
  }
}

// block-private partials of every segment in shared memory at ``base``
__device__ __forceinline__ Target smem_target(float* base, const Out& out) {
  const long long fs = (long long)out.n_agg * out.n_seg;
  Target t;
  t.counts = (int*)base;
  t.sums = base + out.n_seg;
  t.mins = t.sums + fs;
  t.maxs = t.mins + fs;
  t.n_seg = out.n_seg;
  return t;
}

__device__ __forceinline__ void init_partials(const Target& t, const Out& out) {
  const long long fs = (long long)out.n_agg * out.n_seg;
  for (long long k = threadIdx.x; k < out.n_seg; k += BLOCK) t.counts[k] = 0;
  for (long long k = threadIdx.x; k < fs; k += BLOCK) {
    t.sums[k] = 0.f;
    if (out.minmax) {
      t.mins[k] = INFINITY;
      t.maxs[k] = -INFINITY;
    }
  }
}

// run-partial core: merge a block's partials of every segment into the
// output with global atomics, one segment a thread
__device__ __forceinline__ void flush_partials(const Target& t, const Out& out) {
  for (int s = threadIdx.x; s < t.n_seg; s += BLOCK) {
    const int c = t.counts[s];
    if (c == 0) continue;
    atomicAdd(&out.counts[s], c);
    for (int f = 0; f < out.n_agg; ++f) {
      const long long p = (long long)f * t.n_seg + s;
      const long long o = (long long)f * out.n_seg + s;
      atomicAdd(&out.sums[o], t.sums[p]);
      if (out.minmax) {
        atomic_extreme<true>(&out.mins[o], t.mins[p]);
        atomic_extreme<false>(&out.maxs[o], t.maxs[p]);
      }
    }
  }
}

// segmented core: merge ``n`` of a block's partials into the output, one
// (slot, plane) a thread (the count, or one field's sum, min and max), with
// atomics that read nothing back; slot j is list[j] (j without a list),
// its segment keys[slot] (the slot without keys)
__device__ __forceinline__ void flush_runs(const Target& t, const Out& out, int n,
                                           const int* list, const int* keys) {
  const long long items = (long long)n * (1 + out.n_agg);
  for (long long k = threadIdx.x; k < items; k += BLOCK) {
    const int j = (int)(k % n);
    const int f = (int)(k / n) - 1;  // -1: the count
    const int s = list ? list[j] : j;
    const int c = t.counts[s];
    if (c == 0) continue;
    const int seg = keys ? keys[s] : s;
    if (f < 0) {
      atomicAdd(&out.counts[seg], c);
      continue;
    }
    const long long p = (long long)f * t.n_seg + s;
    const long long o = (long long)f * out.n_seg + seg;
    atomicAdd(&out.sums[o], t.sums[p]);
    if (out.minmax) {
      red_min(&out.mins[o], t.mins[p]);
      red_max(&out.maxs[o], t.maxs[p]);
    }
  }
}

// SEGMENTED: the segmented core (and its flush), else the run-partial core
template <int ARM, bool SEGMENTED, class Src>
__device__ void scan_agg(const Src& src, long long n_rows, const Out& out) {
  extern __shared__ float smem[];
  const Target global{out.counts, out.sums, out.mins, out.maxs, out.n_seg};
  if constexpr (ARM == ARM_SCATTER) {
    reduce_rows<ARM, SEGMENTED>(src, n_rows, out, global);
  } else if constexpr (ARM == ARM_HASH) {
    static_assert(SEGMENTED, "the hash arm runs the segmented core");
    // the block's table: the claim count (4 words), hash_slots keys, the
    // claim list, then the slots' partials
    const int H = out.hash_slots;
    int* n_claimed = (int*)smem;
    int* keys = n_claimed + 4;
    int* claimed = keys + H;
    Out slot_out = out;
    slot_out.n_seg = H;
    const Target slots = smem_target(smem + 4 + 2 * H, slot_out);
    if (threadIdx.x == 0) *n_claimed = 0;
    for (int k = threadIdx.x; k < H; k += BLOCK) keys[k] = EMPTY_KEY;
    init_partials(slots, slot_out);
    __syncthreads();
    const HashTarget t{keys, claimed, n_claimed, slots, global, H, out.hash_rounds,
                       (unsigned)__clz(H) + 1u, out.overflow};
    reduce_rows<ARM, true>(src, n_rows, out, t);
    __syncthreads();
    flush_runs(slots, out, *n_claimed, claimed, keys);
  } else {
    // single / shared: block-private partials of every segment in shared memory
    const Target t = smem_target(smem, out);
    init_partials(t, out);
    __syncthreads();
    reduce_rows<ARM, SEGMENTED>(src, n_rows, out, t);
    __syncthreads();
    if constexpr (SEGMENTED) {
      flush_runs(t, out, out.n_seg, nullptr, nullptr);
    } else {
      flush_partials(t, out);
    }
  }
}

template <int ARM>
__global__ void __launch_bounds__(BLOCK) scan_agg_direct(const __grid_constant__ DirectArgs a) {
  DirectSource src(a);
  scan_agg<ARM, ARM == ARM_HASH>(src, a.n_rows, a.out);
}

template <int ARM, bool SELECTIVE>
__global__ void __launch_bounds__(BLOCK) scan_agg_cached(const __grid_constant__ CachedArgs a) {
  CachedSource<SELECTIVE> src(a, a.session, a.dyn);
  scan_agg<ARM, SELECTIVE || ARM == ARM_HASH>(src, a.n_rows, a.out);
}

// B full-scan cached queries: c holds the columns and statics (its
// session, dyn and out are unused); member b reads sessions + b * sess_w
// and dyns + b * dyn_w, and writes the packed row at c.out + b * out_w
// floats. ``tile`` rows a tile (a multiple of BLOCK), ``n_fields`` value
// fields decoded per row.
struct CohortArgs {
  CachedArgs c;
  const int* sessions;
  const int* dyns;
  long long out_w;
  int members;
  int sess_w;
  int dyn_w;
  int n_fields;
  int tile;
  int pad_;
};

// a tile decoded into shared memory, read at tile row r
struct TileCols {
  const int* codes;  // -1: past the last row
  const int* tss;
  const float* vals;  // [n_fields][tile]
  int tile;
  __device__ __forceinline__ int code(long long r) const { return codes[r]; }
  __device__ __forceinline__ int ts(long long r) const { return tss[r]; }
  __device__ __forceinline__ float value(int f, long long r) const { return vals[f * tile + r]; }
};

// one member's query over the decoded tile
struct TileSource : QueryRows<TileCols> {
  __device__ TileSource(const CachedArgs& args, const int* session_, const int* dyn_,
                        const TileCols& cols_)
      : QueryRows<TileCols>(args, session_, dyn_, cols_) {}
  __device__ __forceinline__ bool row(long long r, int& seg, long long& i) const {
    i = r;
    return keep(r, seg);
  }
};

__device__ __forceinline__ Out member_out(const CohortArgs& a, int m) {
  Out out = a.c.out;
  const long long off = (long long)m * a.out_w;  // floats
  out.counts = (int*)((float*)out.counts + off);
  out.sums += off;
  out.mins += off;
  out.maxs += off;
  return out;
}

template <int ARM>
__global__ void __launch_bounds__(BLOCK) scan_agg_cohort(const __grid_constant__ CohortArgs a) {
  extern __shared__ float smem[];
  const CachedArgs& c = a.c;
  const int T = a.tile, M = a.members;
  int* codes = (int*)smem;
  int* tss = codes + T;
  float* vals = (float*)(tss + T);
  // single / shared: every member's partials after the tile, out_w floats each
  float* parts = vals + (long long)a.n_fields * T;
  if (ARM != ARM_SCATTER) {
    for (int m = 0; m < M; ++m) init_partials(smem_target(parts + m * a.out_w, c.out), c.out);
  }
  const int per_warp = T / (BLOCK / 32);
  const long long begin = (long long)(threadIdx.x >> 5) * per_warp;
  const long long n_tiles = (c.n_rows + T - 1) / T;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // every member is done with the last tile (and the init)
    const long long base = tile * T;
#pragma unroll 4
    for (int r = threadIdx.x; r < T; r += BLOCK) {
      const long long i = base + r;
      if (i < c.n_rows) {
        codes[r] = load_int(c.series, i);
        tss[r] = load_int(c.ts, i);
        for (int f = 0; f < a.n_fields; ++f) vals[f * T + r] = load_value(c.fields[f], i);
      } else {
        codes[r] = -1;
      }
    }
    __syncthreads();
    for (int m = 0; m < M; ++m) {
      const TileSource src(c, a.sessions + (long long)m * a.sess_w,
                           a.dyns + (long long)m * a.dyn_w, TileCols{codes, tss, vals, T});
      const Out out = member_out(a, m);
      const Target t = ARM == ARM_SCATTER
                           ? Target{out.counts, out.sums, out.mins, out.maxs, out.n_seg}
                           : smem_target(parts + m * a.out_w, out);
      reduce_range<ARM>(src, begin, begin + per_warp, out, t);
    }
  }
  if (ARM != ARM_SCATTER) {
    __syncthreads();
    for (int m = 0; m < M; ++m) {
      const Out out = member_out(a, m);
      flush_partials(smem_target(parts + m * a.out_w, out), out);
    }
  }
}

// ---- mesh_combine: the monoid over the shards' partials (B7a) ---------------

#define MAX_SHARDS 64
#define COMBINE_GROUP 4   // shards whose vectors a thread loads before combining
#define COMBINE_UNROLL 2  // vectors a thread takes, loaded together
#define COMBINE_CHUNK (BLOCK * COMBINE_UNROLL * 4)  // elements of a plane a block

struct CombineArgs {
  const float* src[4][MAX_SHARDS];  // plane p of shard d (counts: int32 bits)
  float* dst[4];                    // plane p of the result
  long long len[4];                 // elements of plane p; 0 when absent
  long long first_block[5];         // plane p's first block (the launch sets it); [4]: grid
  int shards;
  int device;
};

enum { OP_ADD_I32 = 0, OP_ADD_F32 = 1, OP_MIN = 2, OP_MAX = 3 };

// the plane's operation on one element (counts: int32 bits in a float)
template <int OP>
__device__ __forceinline__ float combine_op(float acc, float v) {
  if (OP == OP_ADD_I32) return __int_as_float(__float_as_int(acc) + __float_as_int(v));
  if (OP == OP_ADD_F32) return acc + v;
  if (OP == OP_MIN) return fmin_t(acc, v);
  return fmax_t(acc, v);
}

template <int OP>
__device__ __forceinline__ float4 combine_op4(float4 acc, float4 v) {
  return make_float4(combine_op<OP>(acc.x, v.x), combine_op<OP>(acc.y, v.y),
                     combine_op<OP>(acc.z, v.z), combine_op<OP>(acc.w, v.w));
}

// element i of every shard, combined in shard order and stored
template <int OP>
__device__ __forceinline__ void combine_one(const float* const* src, float* dst, int S,
                                            long long i) {
  float acc = __ldcs(src[0] + i);
  for (int d = 1; d < S; ++d) acc = combine_op<OP>(acc, __ldcs(src[d] + i));
  __stcs(dst + i, acc);
}

// block ``blk`` of plane p: COMBINE_UNROLL * BLOCK float4 vectors of its
// 16-byte body, and for block 0 the scalar head and tail; or, where the
// plane's pointers do not share their offset in 16 bytes, COMBINE_CHUNK
// scalar elements
template <int OP>
__device__ __forceinline__ void combine_plane(const CombineArgs& a, int p, long long blk) {
  const int S = a.shards;
  const float* const* src = a.src[p];
  float* dst = a.dst[p];
  const long long n = a.len[p];
  const unsigned off = (unsigned)((uintptr_t)dst & 15u);
  bool shared = true;
  for (int d = 0; d < S; ++d) shared &= (unsigned)((uintptr_t)src[d] & 15u) == off;
  if (!shared) {
    const long long end = (blk + 1) * COMBINE_CHUNK < n ? (blk + 1) * COMBINE_CHUNK : n;
    for (long long i = blk * COMBINE_CHUNK + threadIdx.x; i < end; i += BLOCK)
      combine_one<OP>(src, dst, S, i);
    return;
  }
  long long head = ((16u - off) & 15u) / 4;
  if (head > n) head = n;
  const long long nv = (n - head) / 4;  // float4 vectors of the body
  long long v[COMBINE_UNROLL];
#pragma unroll
  for (int j = 0; j < COMBINE_UNROLL; ++j)
    v[j] = blk * (BLOCK * COMBINE_UNROLL) + j * BLOCK + threadIdx.x;
  float4 acc[COMBINE_UNROLL];
  for (int d0 = 0; d0 < S; d0 += COMBINE_GROUP) {
    float4 x[COMBINE_UNROLL][COMBINE_GROUP];
#pragma unroll
    for (int j = 0; j < COMBINE_UNROLL; ++j)
#pragma unroll
      for (int g = 0; g < COMBINE_GROUP; ++g)
        if (v[j] < nv && d0 + g < S)
          x[j][g] = __ldcs(reinterpret_cast<const float4*>(src[d0 + g] + head) + v[j]);
#pragma unroll
    for (int j = 0; j < COMBINE_UNROLL; ++j)
#pragma unroll
      for (int g = 0; g < COMBINE_GROUP; ++g)
        if (v[j] < nv && d0 + g < S)
          acc[j] = d0 + g == 0 ? x[j][g] : combine_op4<OP>(acc[j], x[j][g]);
  }
#pragma unroll
  for (int j = 0; j < COMBINE_UNROLL; ++j)
    if (v[j] < nv) __stcs(reinterpret_cast<float4*>(dst + head) + v[j], acc[j]);
  if (blk == 0) {
    const long long t = threadIdx.x;
    if (t < head) combine_one<OP>(src, dst, S, t);
    if (head + 4 * nv + t < n) combine_one<OP>(src, dst, S, head + 4 * nv + t);
  }
}

__global__ void __launch_bounds__(BLOCK) mesh_combine(const __grid_constant__ CombineArgs a) {
  const long long b = blockIdx.x;
  int p = 0;
  while (p < 3 && b >= a.first_block[p + 1]) ++p;
  const long long blk = b - a.first_block[p];
  switch (p) {
    case 0: combine_plane<OP_ADD_I32>(a, 0, blk); break;
    case 1: combine_plane<OP_ADD_F32>(a, 1, blk); break;
    case 2: combine_plane<OP_MIN>(a, 2, blk); break;
    default: combine_plane<OP_MAX>(a, 3, blk);
  }
}

// ---- host launch (plain C interface, loaded with ctypes) --------------------

static size_t smem_bytes(int arm, const Out& out) {
  if (arm == ARM_SCATTER) return 0;
  const size_t planes = out.minmax ? 3 : 1;
  const size_t per = 1 + planes * (size_t)out.n_agg;
  // the hash table: claim count (4 words), then per slot a key, a claim
  // list entry and the partials
  if (arm == ARM_HASH) return (4 + (size_t)out.hash_slots * (2 + per)) * sizeof(float);
  return ((size_t)out.n_seg * per) * sizeof(float);
}

// the hash arm's table: a power of two of at least 2 slots, probed at
// least once and at most once per slot
static bool hash_ok(const Out& out) {
  const int h = out.hash_slots;
  return h >= 2 && (h & (h - 1)) == 0 && out.hash_rounds >= 1 && out.hash_rounds <= h;
}

// a segmented launch's rows a block: whole steps of every warp
static bool rows_ok(const Out& out) {
  return out.block_rows >= BLOCK && out.block_rows % BLOCK == 0;
}

// ``smem`` < 0: the arm's partials (smem_bytes); a cohort passes its own
template <class K>
static cudaError_t launch(K kernel, int arm, int device, long long n_rows, const Out& out,
                          cudaStream_t stream, const void* args, long long smem_ = -1,
                          long long rows_per_block = BLOCK * 8) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_ < 0 ? smem_bytes(arm, out) : (size_t)smem_;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // the run-partial core: enough rows per warp that the carried run
  // partial pays off; the segmented core: the wrapper's block_rows; the
  // cohort: one tile a block at least
  long long want = (n_rows + rows_per_block - 1) / rows_per_block;
  long long cap = (long long)sms * per_sm;
  int grid = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  void* params[] = {(void*)args};
  err = cudaLaunchKernel((const void*)kernel, dim3(grid), dim3(BLOCK), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// blocks of a segmented launch's kernel one SM holds at the shared memory
// ``out`` asks for (``form``: 0 direct, 1 cached, 2 cached SELECTIVE), into
// ``per_sm``: the wrapper sizes ``block_rows`` and the hash table by it
template <class K>
static cudaError_t resident(K kernel, int arm, int device, const Out& out, int* per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(arm, out);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, BLOCK, smem);
}

extern "C" {

// struct sizes, so the ctypes mirror can check its layout at load
int scan_agg_abi(long long* sizes) {
  sizes[0] = sizeof(Column);
  sizes[1] = sizeof(Out);
  sizes[2] = sizeof(Filters);
  sizes[3] = sizeof(DirectArgs);
  sizes[4] = sizeof(CachedArgs);
  sizes[5] = MAX_FIELDS;
  sizes[6] = MAX_FILTERS;
  sizes[7] = sizeof(CohortArgs);
  sizes[8] = sizeof(CombineArgs);
  sizes[9] = MAX_SHARDS;
  return 0;
}

// one launch: the planes end to end on a 1-D grid, COMBINE_CHUNK elements a
// block (first_block is set here from len)
int scan_agg_combine_launch(const CombineArgs* in, void* stream) {
  if (in->shards < 1 || in->shards > MAX_SHARDS) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(in->device);
  if (err != cudaSuccess) return err;
  CombineArgs a = *in;
  long long blocks = 0;
  for (int p = 0; p < 4; ++p) {
    if (a.len[p] < 0) return cudaErrorInvalidValue;
    a.first_block[p] = blocks;
    blocks += (a.len[p] + COMBINE_CHUNK - 1) / COMBINE_CHUNK;
  }
  a.first_block[4] = blocks;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  void* params[] = {(void*)&a};
  err = cudaLaunchKernel((const void*)mesh_combine, dim3((unsigned)blocks), dim3(BLOCK), params,
                         0, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int scan_agg_blocks_per_sm(const Out* out, int arm, int form, int device, int* per_sm) {
  if (form == 0 && arm == ARM_HASH)
    return resident(scan_agg_direct<ARM_HASH>, arm, device, *out, per_sm);
  if (form == 1 && arm == ARM_HASH)
    return resident(scan_agg_cached<ARM_HASH, false>, arm, device, *out, per_sm);
  if (form == 2) {
    switch (arm) {
      case ARM_SINGLE:
        return resident(scan_agg_cached<ARM_SINGLE, true>, arm, device, *out, per_sm);
      case ARM_SHARED:
        return resident(scan_agg_cached<ARM_SHARED, true>, arm, device, *out, per_sm);
      case ARM_SCATTER:
        return resident(scan_agg_cached<ARM_SCATTER, true>, arm, device, *out, per_sm);
      case ARM_HASH:
        return resident(scan_agg_cached<ARM_HASH, true>, arm, device, *out, per_sm);
    }
  }
  return cudaErrorInvalidValue;
}

int scan_agg_direct_launch(const DirectArgs* a, int arm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (arm) {
    case ARM_SINGLE:
      return launch(scan_agg_direct<ARM_SINGLE>, arm, a->device, a->n_rows, a->out, s, a);
    case ARM_SHARED:
      return launch(scan_agg_direct<ARM_SHARED>, arm, a->device, a->n_rows, a->out, s, a);
    case ARM_SCATTER:
      return launch(scan_agg_direct<ARM_SCATTER>, arm, a->device, a->n_rows, a->out, s, a);
    case ARM_HASH:
      if (!hash_ok(a->out) || !rows_ok(a->out)) return cudaErrorInvalidValue;
      return launch(scan_agg_direct<ARM_HASH>, arm, a->device, a->n_rows, a->out, s, a, -1,
                    a->out.block_rows);
  }
  return cudaErrorInvalidValue;
}

int scan_agg_cached_launch(const CachedArgs* a, int arm, int selective, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (arm == ARM_HASH && !hash_ok(a->out)) return cudaErrorInvalidValue;
  if ((selective || arm == ARM_HASH) && !rows_ok(a->out)) return cudaErrorInvalidValue;
  const long long rows = a->out.block_rows;
  if (selective) {
    switch (arm) {
      case ARM_SINGLE:
        return launch(scan_agg_cached<ARM_SINGLE, true>, arm, a->device, a->n_rows, a->out, s,
                      a, -1, rows);
      case ARM_SHARED:
        return launch(scan_agg_cached<ARM_SHARED, true>, arm, a->device, a->n_rows, a->out, s,
                      a, -1, rows);
      case ARM_SCATTER:
        return launch(scan_agg_cached<ARM_SCATTER, true>, arm, a->device, a->n_rows, a->out, s,
                      a, -1, rows);
      case ARM_HASH:
        return launch(scan_agg_cached<ARM_HASH, true>, arm, a->device, a->n_rows, a->out, s, a,
                      -1, rows);
    }
  } else {
    switch (arm) {
      case ARM_SINGLE:
        return launch(scan_agg_cached<ARM_SINGLE, false>, arm, a->device, a->n_rows, a->out, s, a);
      case ARM_SHARED:
        return launch(scan_agg_cached<ARM_SHARED, false>, arm, a->device, a->n_rows, a->out, s, a);
      case ARM_SCATTER:
        return launch(scan_agg_cached<ARM_SCATTER, false>, arm, a->device, a->n_rows, a->out, s, a);
      case ARM_HASH:
        return launch(scan_agg_cached<ARM_HASH, false>, arm, a->device, a->n_rows, a->out, s, a,
                      -1, rows);
    }
  }
  return cudaErrorInvalidValue;
}

int scan_agg_cohort_launch(const CohortArgs* a, int arm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->members < 1 || a->tile < BLOCK || a->tile % BLOCK) return cudaErrorInvalidValue;
  const CachedArgs& c = a->c;
  // the tile, then (single / shared) every member's partials
  long long smem = (long long)a->tile * (2 + a->n_fields) * 4;
  if (arm != ARM_SCATTER) smem += (long long)a->members * a->out_w * 4;
  switch (arm) {
    case ARM_SINGLE:
      return launch(scan_agg_cohort<ARM_SINGLE>, arm, c.device, c.n_rows, c.out, s, a, smem,
                    a->tile);
    case ARM_SHARED:
      return launch(scan_agg_cohort<ARM_SHARED>, arm, c.device, c.n_rows, c.out, s, a, smem,
                    a->tile);
    case ARM_SCATTER:
      return launch(scan_agg_cohort<ARM_SCATTER>, arm, c.device, c.n_rows, c.out, s, a, smem,
                    a->tile);
  }
  return cudaErrorInvalidValue;
}

const char* scan_agg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
