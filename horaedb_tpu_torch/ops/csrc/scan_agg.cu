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
// Three entry points share one reduction core (reduce_runs):
//   scan_agg_direct  rows of a host-built padded batch (group code, bucket
//                    id, mask, values[F, N]);
//   scan_agg_cached  rows of the resident scan cache: each row's series
//                    code, timestamp and values decode from the resident
//                    layout (raw, bf16, delta, dict, dict codes) in
//                    registers, then the session allow list, the time
//                    range and the numeric filters, the bucket and the
//                    group. A full scan reads the first ``n_rows`` rows
//                    (the caller passes the entry's real rows, a prefix of
//                    the padded layout); SELECTIVE reads row i from the
//                    index tail of ``dyn``. The column decoders live in
//                    layouts.cuh, shared with the raw-read kernels.
//   scan_agg_cohort  B full-scan cached queries in one launch (B1e): member
//                    b reads row b of the stacked sessions and dyns and
//                    writes row b of the packed outputs (below).
//
// The core (every launch; one warp, one contiguous range of rows, 32 rows
// a step). What bounds a full scan is the bytes of the resident columns
// (one pass over codes, timestamps and the touched value columns over the
// real rows). Walking the padded rows and reducing every step with 5-round
// shuffles per field (15 with min/max) were most of the time of the core
// this one replaced, its read-then-CAS commits little (PERF.md, the step
// 0 of the run-partial core's redesign). So:
//   - a step loads every value of its rows, FCAP fields together, before
//     anything waits on them (a full scan: after the allow list, group map
//     and timestamp, which load together once the code is known, and
//     beside the filter fields);
//   - a step whose valid rows all fall in one segment (the common step:
//     the cache is sorted by series and time, and a TSBS segment is 360 or
//     8,640 rows) folds each lane's row into that lane's own registers, no
//     shuffle; the lanes' partials reduce over the warp only when the
//     segment changes, a step mixes segments or the range ends;
//   - a step that mixes segments runs a segmented warp scan: a valid lane
//     heads a run when its segment differs from the previous valid lane's;
//     a 5-round shuffle scan leaves each run's count, sums, mins and maxs
//     in its last lane; the first run merges into the carried partial, the
//     middle runs commit from their last lanes at once, the last becomes
//     the carried partial; a step of more than 16 runs (unsorted rows)
//     commits lane by lane, a min or max only where it changes the value
//     read first (few segments' rows would queue on the same words). On
//     selective TSBS rows (runs of 6) a step commits about 6 partials, not
//     32 rows;
//   - commits and flushes take one atomic each for min and max, with no
//     read back (red_min / red_max), and a block flushes one (slot, field)
//     a thread.
// Kernels are compiled with and without min/max (MINMAX), so a launch
// without them holds no min/max registers; registers decide these
// kernels' speed (a full scan is resident at 4-8 blocks a SM), so a launch
// of at most one field takes kernels with a field capacity FC of 1. The
// lane-private path is compiled only into full scans and the cohort
// (LANES): in a SELECTIVE or hash launch its registers (116-126 against
// 80) cut the blocks resident and slowed each launch by 40-80% on the
// card, while its steps rarely hold one segment. Full scans take BLOCK * 8
// rows a block at least (a contiguous range a warp, long enough that the
// lane-private partials pay off); a SELECTIVE launch of a few thousand
// gathered rows is bound by latency instead (each step a chain of
// dependent loads: index, code, allow list, timestamp, group map), so its
// grid is the wrapper's ``block_rows`` (ops/scan_agg.py
// ``segmented_geometry``): the fewest 32-row steps a warp whose blocks the
// card holds at once (scan_agg_blocks_per_sm), and a gather's values load
// before its keep chain.
//
// The cohort (B1e). Bound: the real rows' resident columns read once, plus
// B sessions, dyns and outputs, while its work grows with B (at the
// flood's B = 32 the operations bound it). The real rows cut into chunks
// of tile / 8 rows; each warp walks a contiguous run of chunks, so a
// block walks a contiguous run of tiles. A warp decodes its chunk once
// into its part of the tile in shared memory (series code, timestamp,
// every value field), taking the chunk's least and greatest timestamp and
// series code; a member whose [lo, hi) misses that range skips the chunk
// without touching a row, as does one whose allow list excludes the
// chunk's one series. Where the chunk holds one series and the query one
// bucket (the flood's shape: a series is 8,640 rows, a chunk 512), every
// row a member keeps falls in one segment, so ``reduce_segment`` folds the
// lanes' rows, count included, with no per-step ballot or segment test;
// other chunks run the core. Each member's carried run partial waits in
// the warp's records in shared memory (``carry``:
// a segment and count a pass, the sums, mins and maxs of every field;
// 5 words a member at one field with min/max), so a member commits when
// its segment changes and at the warp's end, not at every chunk: commits
// fall from B x tiles x warps to about B x the segments a warp's rows
// touch. Arms: single and shared keep every member's partials in shared
// memory beside the tile when they fit there together, else the launch
// takes scatter; the records take room only where it is left (the
// wrapper decides both; without room a member commits at each chunk end).
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
//            output. A hash launch takes the segmented geometry too.
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

// min / max of a float in memory with one atomic on its bits and no read
// back: fmin_t's / fmax_t's order, -0.0 < +0.0, where
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

// whether ``now`` (a min or max taken with what was read) differs from
// ``was``, the value read: by bits, so a NaN that is there stays unchanged
__device__ __forceinline__ bool changes(float now, float was) {
  return __float_as_int(now) != __float_as_int(was);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
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
// whether i passes, in two parts: ``pre`` (the row's mask or allow list,
// its time range and its segment) and ``filters`` (the numeric filters),
// so a full scan issues a row's value loads between them, beside the
// filter fields' loads; and the row's values. ``kGathered``: the rows are
// a selective gather, whose rows mostly pass, so the core loads their
// values before it knows.
struct DirectSource {
  static constexpr bool kGathered = false;
  const DirectArgs& a;
  __device__ DirectSource(const DirectArgs& args) : a(args) {}
  __device__ __forceinline__ long long index(long long r) const { return r; }
  __device__ __forceinline__ bool pre(long long r, int& seg) const {
    if (!a.mask[r]) return false;
    seg = a.group_codes[r] * a.n_buckets + a.bucket_ids[r];
    return seg >= 0 && seg < a.out.n_seg;  // out-of-range ids drop, as in a scatter
  }
  __device__ __forceinline__ bool filters(long long r) const {
    for (int k = 0; k < a.filt.n; ++k) {
      float v = a.values[(long long)a.filt.field[k] * a.n_rows + r];
      if (!compare(v, a.filt.op[k], a.literals[k])) return false;
    }
    return true;
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
  // once the code is known, the allow list, the group map and the
  // timestamp load together: one dependent load after the code
  __device__ __forceinline__ bool pre(long long i, int& seg) const {
    const int code = cols.code(i);
    if (code < 0) return false;
    const int allowed = session[a.s1 + code];
    const int group = session[code];
    const int ts = cols.ts(i);
    if (allowed == 0 || !(ts >= lo && ts < hi)) return false;
    // one bucket: every row's bucket is 0, with no division
    seg = group * a.n_buckets + (a.n_buckets == 1 ? 0 : bucket_of(ts, t0, width, a.n_buckets));
    return seg >= 0 && seg < a.out.n_seg;
  }
  __device__ __forceinline__ bool filters(long long i) const {
    for (int k = 0; k < a.filt.n; ++k) {
      if (!compare(cols.value(a.filt.field[k], i), a.filt.op[k], __int_as_float(dyn[k])))
        return false;
    }
    return true;
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
};

// ---- the reduction core ----------------------------------------------------

// fields a lane holds in registers at once; wider rows take their fields
// FCAP at a time, one pass over the rows each
#define FCAP 10

// count/sum/min/max partials of n_seg segments (in global or shared
// memory), accumulated with atomics that read nothing back
struct Target {
  int* counts;
  float* sums;
  float* mins;
  float* maxs;
  int n_seg;

  // the carried run partial, from the whole warp: lane 0 the count (when
  // ``with_count``), lane f field f0 + f of nf
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

  // one run's partial, from the lane that holds it (its FC fields' arrays);
  // ``changed``: a min or max goes in only where it changes the value read
  // there first (any value read is safe: a min only falls, a max only rises)
  template <int FC>
  __device__ __forceinline__ void add_run(int seg, int cnt, const float* s, const float* mn,
                                          const float* mx, int f0, int nf, bool with_count,
                                          bool minmax, bool changed = false) const {
    if (with_count) atomicAdd(&counts[seg], cnt);
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      if (f < nf) {
        const long long o = (long long)(f0 + f) * n_seg + seg;
        atomicAdd(&sums[o], s[f]);
        if (minmax) {
          if (!changed || changes(fmin_t(mins[o], mn[f]), mins[o])) red_min(&mins[o], mn[f]);
          if (!changed || changes(fmax_t(maxs[o], mx[f]), maxs[o])) red_max(&maxs[o], mx[f]);
        }
      }
    }
  }
};

// A Target that also counts its commits into ``*n`` (when not NULL): the
// cohort's launch statistics.
struct CountedTarget {
  Target t;
  unsigned long long* n;

  __device__ __forceinline__ void commit_fields(int seg, int cnt, float s, float mn, float mx,
                                                int lane, int f0, int nf, bool with_count,
                                                bool minmax) const {
    if (n && lane == 0 && seg >= 0 && cnt != 0) atomicAdd(n, 1ull);
    t.commit_fields(seg, cnt, s, mn, mx, lane, f0, nf, with_count, minmax);
  }

  template <int FC>
  __device__ __forceinline__ void add_run(int seg, int cnt, const float* s, const float* mn,
                                          const float* mx, int f0, int nf, bool with_count,
                                          bool minmax, bool changed = false) const {
    if (n) atomicAdd(n, 1ull);
    t.add_run<FC>(seg, cnt, s, mn, mx, f0, nf, with_count, minmax, changed);
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

  template <int FC>
  __device__ __forceinline__ void add_run(int seg, int cnt, const float* s, const float* mn,
                                          const float* mx, int f0, int nf, bool with_count,
                                          bool minmax, bool changed = false) const {
    const int slot = find(seg);
    if (slot >= 0) {
      // shared-memory atomics: the read first costs more than it saves
      slots.add_run<FC>(slot, cnt, s, mn, mx, f0, nf, with_count, minmax);
    } else {
      out.add_run<FC>(seg, cnt, s, mn, mx, f0, nf, with_count, minmax, changed);
      if (with_count && overflow) atomicAdd(overflow, (unsigned long long)cnt);
    }
  }
};

// words of one cohort member's carried run partials in shared memory: a
// segment and a count a pass of FCAP fields, then the sums, mins and maxs
// of every field (mins and maxs with minmax)
__host__ __device__ __forceinline__ int cohort_passes(int n_agg) {
  return n_agg > FCAP ? (n_agg + FCAP - 1) / FCAP : 1;
}

__host__ __device__ __forceinline__ int cohort_record_words(int n_agg, bool minmax) {
  return 2 * cohort_passes(n_agg) + (minmax ? 3 : 1) * n_agg;
}

// the carried run partial: its segment (-1: none) and count (the same in
// every lane), and in lane f the sum, min and max of field f0 + f
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
  template <bool MINMAX, int FC>
  __device__ __forceinline__ void absorb(const float (&s)[FC], const float (&smin)[FC],
                                         const float (&smax)[FC], int c, int e, int lane,
                                         int nf) {
    cnt += __shfl_sync(FULL_MASK, c, e);
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      if (f < nf) {
        const float x = __shfl_sync(FULL_MASK, s[f], e);
        if (lane == f) sum += x;
        if (MINMAX) {
          const float xn = __shfl_sync(FULL_MASK, smin[f], e);
          const float xx = __shfl_sync(FULL_MASK, smax[f], e);
          if (lane == f) {
            mn = fmin_t(mn, xn);
            mx = fmax_t(mx, xx);
          }
        }
      }
    }
  }

  template <class Sink>
  __device__ __forceinline__ void commit(const Sink& t, int lane, int f0, int nf,
                                         bool with_count, bool minmax) const {
    t.commit_fields(seg, cnt, sum, mn, mx, lane, f0, nf, with_count, minmax);
  }

  // the cohort's record of pass p (``cohort_record_words``; passes of FCAP
  // fields): lane 0 keeps the segment and count, lane f the partials of
  // field p * FCAP + f
  __device__ __forceinline__ void load(const int* rec, int p, int n_agg, int lane, int nf,
                                       bool minmax) {
    seg = rec[2 * p];
    cnt = rec[2 * p + 1];
    sum = 0.f;
    mn = INFINITY;
    mx = -INFINITY;
    if (seg >= 0 && lane < nf) {
      const int* fields = rec + 2 * cohort_passes(n_agg) + p * FCAP + lane;
      sum = __int_as_float(fields[0]);
      if (minmax) {
        mn = __int_as_float(fields[n_agg]);
        mx = __int_as_float(fields[2 * n_agg]);
      }
    }
  }

  __device__ __forceinline__ void save(int* rec, int p, int n_agg, int lane, int nf,
                                       bool minmax) const {
    if (lane == 0) {
      rec[2 * p] = seg;
      rec[2 * p + 1] = cnt;
    }
    if (lane < nf) {
      int* fields = rec + 2 * cohort_passes(n_agg) + p * FCAP + lane;
      fields[0] = __float_as_int(sum);
      if (minmax) {
        fields[n_agg] = __float_as_int(mn);
        fields[2 * n_agg] = __float_as_int(mx);
      }
    }
  }
};

// Lane-private partials of the carried segment: in a step whose valid rows
// all fall in it, each lane folds its own row into its own registers, with
// no shuffle; ``flush`` reduces them over the warp into the carried run
// partial (lane f takes field f) only when the segment changes, a step
// mixes segments, or the range ends.
template <bool MINMAX, int FC>
struct LaneAcc {
  float s[FC], mn[FC], mx[FC];
  bool any;  // the same in every lane

  __device__ __forceinline__ void clear() {
    any = false;
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      s[f] = 0.f;
      mn[f] = INFINITY;
      mx[f] = -INFINITY;
    }
  }

  // this lane's row (the identity where it is not valid)
  __device__ __forceinline__ void fold(const float (&v)[FC], const float (&vmn)[FC],
                                       const float (&vmx)[FC]) {
    any = true;
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      s[f] += v[f];
      if (MINMAX) {
        mn[f] = fmin_t(mn[f], vmn[f]);
        mx[f] = fmax_t(mx[f], vmx[f]);
      }
    }
  }

  __device__ __forceinline__ void flush(Carried& run, int lane, int nf) {
    if (!any) return;
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      if (f < nf) {
        const float x = warp_sum(s[f]);
        if (lane == f) run.sum += x;
        if (MINMAX) {
          const float xn = warp_min(mn[f]);
          const float xx = warp_max(mx[f]);
          if (lane == f) {
            run.mn = fmin_t(run.mn, xn);
            run.mx = fmax_t(run.mx, xx);
          }
        }
      }
    }
    clear();
  }
};

// The reduction core (every launch): one warp reduces fields [f0, f0 + nf)
// of rows [begin, end) into ``t`` (a Target, CountedTarget or HashTarget),
// and their counts when f0 == 0, continuing the carried run partial ``run``
// (the caller commits it, or keeps it for its next range).
//
// A step loads every value of its 32 rows into registers first, FCAP
// fields together: for a gather before its keep chain (whose rows mostly
// pass); otherwise between ``pre`` and ``filters``, beside the filter
// fields' loads. Then, by the step's valid rows:
//   - all in one segment (the common step of sorted rows): each lane folds
//     its row into its lane-private partials (LaneAcc), no shuffle; a
//     segment other than the carried one first commits the carried
//     partial and restarts it;
//   - in several: the lane-private partials reduce into the carried
//     partial, then a valid lane heads a run when its segment differs from
//     the previous valid lane's; invalid lanes hold the identity (0, +inf,
//     -inf) and head nothing. A step of more than 16 runs commits each
//     valid row from its lane. Otherwise a segmented inclusive scan (5
//     shuffle rounds) leaves each run's count, sums, mins and maxs in its
//     last valid lane (a step of one-row runs skips it). The first run
//     merges into the carried partial when it continues its segment; the
//     middle runs commit from their last lanes, all at once; the last run
//     becomes the carried partial.
template <bool MINMAX, int FC, bool LANES, class Src, class Sink>
__device__ void reduce_runs(const Src& src, long long begin, long long end, const Out& out,
                            const Sink& t, int f0, Carried& run) {
  const int lane = threadIdx.x & 31;
  const unsigned upto = FULL_MASK >> (31 - lane);  // lanes 0..lane
  const int nf = min(out.n_agg - f0, FC);
  const bool with_count = f0 == 0;
  LaneAcc<MINMAX, FC> acc;
  acc.clear();

  for (long long base = begin; base < end; base += 32) {
    const long long r = base + lane;
    float s[FC], mn[FC], mx[FC];
    int seg = 0;
    bool valid = false;
    if (r < end) {
      const long long i = src.index(r);
      if constexpr (Src::kGathered) {
#pragma unroll
        for (int f = 0; f < FC; ++f) s[f] = f < nf ? src.value(f0 + f, i) : 0.f;
        valid = src.pre(i, seg) && src.filters(i);
      } else {
        const bool cand = src.pre(i, seg);
#pragma unroll
        for (int f = 0; f < FC; ++f) s[f] = (cand && f < nf) ? src.value(f0 + f, i) : 0.f;
        valid = cand && src.filters(i);
      }
    }
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      if (!valid) s[f] = 0.f;
      mn[f] = valid ? s[f] : INFINITY;
      mx[f] = valid ? s[f] : -INFINITY;
    }
    const unsigned vmask = __ballot_sync(FULL_MASK, valid);
    if (vmask == 0) continue;
    const int first = __ffs(vmask) - 1;
    const int seg_first = __shfl_sync(FULL_MASK, seg, first);
    if constexpr (LANES) {
      if (__all_sync(FULL_MASK, !valid || seg == seg_first)) {
        // one segment: lane-private partials
        if (seg_first != run.seg) {
          acc.flush(run, lane, nf);
          run.commit(t, lane, f0, nf, with_count, MINMAX);
          run.restart(seg_first);
        }
        run.cnt += __popc(vmask);
        acc.fold(s, mn, mx);
        continue;
      }
      acc.flush(run, lane, nf);
    }
    // heads: valid lanes whose segment differs from the previous valid lane's
    const unsigned before = vmask & (upto >> 1);
    const int prev_seg = __shfl_sync(FULL_MASK, seg, before ? 31 - __clz(before) : lane);
    const unsigned heads = __ballot_sync(FULL_MASK, valid && (before == 0 || prev_seg != seg));
    if (__popc(heads) > 16) {
      // most runs are one row (unsorted segments): each valid lane commits
      // its row, its min and max only where they change what is there (few
      // segments' rows otherwise queue on the same words); the carried run
      // partial waits for its segment's end
      if (valid) t.template add_run<FC>(seg, 1, s, mn, mx, f0, nf, with_count, MINMAX, true);
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
        for (int f = 0; f < FC; ++f) {
          if (f < nf) {
            const float os = __shfl_up_sync(FULL_MASK, s[f], d);
            if (take) s[f] = os + s[f];
            if (MINMAX) {
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
    const int last = 31 - __clz(vmask);
    const int first_end = __ffs(ends) - 1;
    if (seg_first != run.seg) {
      run.commit(t, lane, f0, nf, with_count, MINMAX);
      run.restart(seg_first);
    }
    run.absorb<MINMAX, FC>(s, mn, mx, cnt, first_end, lane, nf);
    if (first_end != last) {
      run.commit(t, lane, f0, nf, with_count, MINMAX);
      if (is_end && lane != first_end && lane != last)
        t.template add_run<FC>(seg, cnt, s, mn, mx, f0, nf, with_count, MINMAX);
      run.restart(__shfl_sync(FULL_MASK, seg, last));
      run.absorb<MINMAX, FC>(s, mn, mx, cnt, last, lane, nf);
    }
  }
  if constexpr (LANES) acc.flush(run, lane, nf);
}

// each warp of the grid takes a contiguous run of rows, a multiple of 32,
// and passes over them once per FC fields (once when the launch
// aggregates none), committing its carried run partial at the end
template <bool MINMAX, int FC, bool LANES, class Src, class Sink>
__device__ void reduce_rows(const Src& src, long long n_rows, const Out& out, const Sink& t) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * BLOCK + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * BLOCK) >> 5;
  long long chunk = (n_rows + n_warps - 1) / n_warps;
  chunk = (chunk + 31) & ~31LL;
  const long long begin = warp * chunk;
  const long long end = min(begin + chunk, n_rows);
  for (int f0 = 0; f0 == 0 || f0 < out.n_agg; f0 += FC) {
    Carried run;
    reduce_runs<MINMAX, FC, LANES>(src, begin, end, out, t, f0, run);
    run.commit(t, lane, f0, min(out.n_agg - f0, FC), f0 == 0, MINMAX);
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

// merge ``n`` of a block's partials into the output, one (slot, plane) a
// thread (the count, or one field's sum, min and max), with atomics that
// read nothing back; slot j is list[j] (j without a list), its segment
// keys[slot] (the slot without keys)
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

// LANES: the core's lane-private path (full scans of the single, shared
// and scatter arms); SELECTIVE and hash launches compile it out
template <int ARM, bool MINMAX, int FC, bool LANES, class Src>
__device__ void scan_agg(const Src& src, long long n_rows, const Out& out) {
  extern __shared__ float smem[];
  const Target global{out.counts, out.sums, out.mins, out.maxs, out.n_seg};
  if constexpr (ARM == ARM_SCATTER) {
    reduce_rows<MINMAX, FC, LANES>(src, n_rows, out, global);
  } else if constexpr (ARM == ARM_HASH) {
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
    reduce_rows<MINMAX, FC, LANES>(src, n_rows, out, t);
    __syncthreads();
    flush_runs(slots, out, *n_claimed, claimed, keys);
  } else {
    // single / shared: block-private partials of every segment in shared memory
    const Target t = smem_target(smem, out);
    init_partials(t, out);
    __syncthreads();
    reduce_rows<MINMAX, FC, LANES>(src, n_rows, out, t);
    __syncthreads();
    flush_runs(t, out, out.n_seg, nullptr, nullptr);
  }
}

// FC: the fields a lane holds at once, FCAP, or 1 for a launch of at most
// one field (fewer registers, more warps resident)
template <int ARM, bool MINMAX, int FC>
__global__ void __launch_bounds__(BLOCK) scan_agg_direct(const __grid_constant__ DirectArgs a) {
  DirectSource src(a);
  scan_agg<ARM, MINMAX, FC, ARM != ARM_HASH>(src, a.n_rows, a.out);
}

template <int ARM, bool SELECTIVE, bool MINMAX, int FC>
__global__ void __launch_bounds__(BLOCK) scan_agg_cached(const __grid_constant__ CachedArgs a) {
  CachedSource<SELECTIVE> src(a, a.session, a.dyn);
  scan_agg<ARM, MINMAX, FC, !SELECTIVE && ARM != ARM_HASH>(src, a.n_rows, a.out);
}

// B full-scan cached queries: c holds the columns and statics (its
// session, dyn and out are unused; c.n_rows the rows to scan); member b
// reads sessions + b * sess_w and dyns + b * dyn_w, and writes the packed
// row at c.out + b * out_w floats. ``tile`` rows a block's tile (a
// multiple of BLOCK), ``n_fields`` value fields decoded per row. The
// fields after ``pad_`` are this kernel's own: a launcher that stops at
// ``pad_`` (an older one) still launches it.
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
  // [chunks decoded, member-chunks run, member-chunks skipped, commits]
  // added to, or NULL
  unsigned long long* stats;
  int carry;  // 1: each warp keeps every member's carried run partials in shared memory
  int pad2_;
};

// a warp's chunk decoded into shared memory, read at chunk row r
struct TileCols {
  const int* codes;  // -1: past the last row
  const int* tss;
  const float* vals;  // field f at vals[f * tile + r]
  int tile;
  __device__ __forceinline__ int code(long long r) const { return codes[r]; }
  __device__ __forceinline__ int ts(long long r) const { return tss[r]; }
  __device__ __forceinline__ float value(int f, long long r) const { return vals[f * tile + r]; }
};

// one member's query over the decoded chunk
struct TileSource : QueryRows<TileCols> {
  static constexpr bool kGathered = false;
  __device__ TileSource(const CachedArgs& args, const int* session_, const int* dyn_,
                        const TileCols& cols_)
      : QueryRows<TileCols>(args, session_, dyn_, cols_) {}
  __device__ __forceinline__ long long index(long long r) const { return r; }
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

// A member's pass over a chunk whose rows all belong to one allowed series
// ``seg`` names (one bucket): only the time range and the filters decide
// a row, so each lane folds its rows, count included, into its own
// registers with no per-step ballot, and the warp reduces them once.
template <bool MINMAX, int FC>
__device__ void reduce_segment(const TileSource& src, int rows, int seg, const Out& out,
                               const CountedTarget& t, int f0, Carried& run) {
  const int lane = threadIdx.x & 31;
  const int nf = min(out.n_agg - f0, FC);
  if (seg != run.seg) {
    run.commit(t, lane, f0, nf, f0 == 0, MINMAX);
    run.restart(seg);
  }
  LaneAcc<MINMAX, FC> acc;
  acc.clear();
  int cnt = 0;
  for (int r = lane; r < rows; r += 32) {
    const int ts = src.cols.ts(r);
    const bool in_range = ts >= src.lo && ts < src.hi;
    float v[FC], vmn[FC], vmx[FC];
#pragma unroll
    for (int f = 0; f < FC; ++f) v[f] = (in_range && f < nf) ? src.value(f0 + f, r) : 0.f;
    const bool valid = in_range && src.filters(r);
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      if (!valid) v[f] = 0.f;
      vmn[f] = valid ? v[f] : INFINITY;
      vmx[f] = valid ? v[f] : -INFINITY;
    }
    cnt += valid;
    acc.fold(v, vmn, vmx);
  }
  acc.any = true;  // in every lane, whatever rows it took
  run.cnt += warp_sum_int(cnt);
  acc.flush(run, lane, nf);
}

// The cohort: the real rows cut into chunks of tile / 8 rows; each warp
// of the grid walks a contiguous run of them (so a block walks a
// contiguous run of tiles). A warp decodes its chunk into its own part of
// the tile and takes the chunk's least and greatest timestamp; each member
// whose [lo, hi) misses that range skips the chunk, the others run the
// reduction core over it. With ``carry`` a member's carried run partial
// (per pass of FCAP fields) waits in the warp's records in shared memory
// from chunk to chunk, and commits when its segment changes and once at
// the warp's end; without, at the end of each chunk.
template <int ARM, bool MINMAX, int FC>
__global__ void __launch_bounds__(BLOCK) scan_agg_cohort(const __grid_constant__ CohortArgs a) {
  extern __shared__ float smem[];
  constexpr int W = BLOCK / 32;
  const CachedArgs& c = a.c;
  const int T = a.tile, M = a.members;
  const int per_warp = T / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_agg = c.out.n_agg;
  const int passes = cohort_passes(n_agg);
  const int rec_w = cohort_record_words(n_agg, MINMAX);
  int* codes = (int*)smem + warp * per_warp;
  int* tss = (int*)smem + T + warp * per_warp;
  float* vals = smem + 2 * T + warp * per_warp;
  // single / shared: every member's partials after the tile, out_w floats
  // each; then (carry) each warp's records, rec_w words a member
  float* parts = smem + (long long)(2 + a.n_fields) * T;
  int* recs = (int*)(parts + (ARM != ARM_SCATTER ? (long long)M * a.out_w : 0)) +
              (long long)warp * M * rec_w;
  if (ARM != ARM_SCATTER) {
    for (int m = 0; m < M; ++m) init_partials(smem_target(parts + m * a.out_w, c.out), c.out);
  }
  if (a.carry) {
    for (int k = lane; k < M * passes; k += 32) {
      int* rec = recs + (k / passes) * rec_w + 2 * (k % passes);
      rec[0] = -1;
      rec[1] = 0;
    }
  }
  __syncthreads();
  unsigned long long* commits = a.stats ? a.stats + 3 : nullptr;
  const TileCols cols{codes, tss, vals, T};
  const long long n_chunks = (c.n_rows + per_warp - 1) / per_warp;
  const long long n_warps = (long long)gridDim.x * W;
  const long long per = (n_chunks + n_warps - 1) / n_warps;
  const long long k0 = ((long long)blockIdx.x * W + warp) * per;
  const long long k1 = min(k0 + per, n_chunks);
  unsigned long long run_chunks = 0, skipped = 0;
  for (long long k = k0; k < k1; ++k) {
    const long long base = k * per_warp;
    const int rows = (int)min((long long)per_warp, c.n_rows - base);
    int tmin = 0x7fffffff, tmax = (int)0x80000000;
    int cmin = 0x7fffffff, cmax = (int)0x80000000;
    __syncwarp();  // every lane is done with the last chunk
#pragma unroll 4
    for (int r = lane; r < per_warp; r += 32) {
      if (r < rows) {
        const long long i = base + r;
        const int ts = load_int(c.ts, i);
        const int code = load_int(c.series, i);
        codes[r] = code;
        tss[r] = ts;
        tmin = min(tmin, ts);
        tmax = max(tmax, ts);
        cmin = min(cmin, code);
        cmax = max(cmax, code);
        for (int f = 0; f < a.n_fields; ++f) vals[f * T + r] = load_value(c.fields[f], i);
      } else {
        codes[r] = -1;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tmin = min(tmin, __shfl_xor_sync(FULL_MASK, tmin, o));
      tmax = max(tmax, __shfl_xor_sync(FULL_MASK, tmax, o));
      cmin = min(cmin, __shfl_xor_sync(FULL_MASK, cmin, o));
      cmax = max(cmax, __shfl_xor_sync(FULL_MASK, cmax, o));
    }
    // one series in the chunk, and one bucket: a member's rows there share
    // one segment, or are not allowed at all
    const bool one_series = cmin == cmax && cmin >= 0 && c.n_buckets == 1;
    __syncwarp();
    for (int m = 0; m < M; ++m) {
      const int* dyn = a.dyns + (long long)m * a.dyn_w;
      if (tmax < dyn[c.filt.n] || tmin >= dyn[c.filt.n + 1]) {  // no row in [lo, hi)
        ++skipped;
        continue;
      }
      const int* session = a.sessions + (long long)m * a.sess_w;
      int seg = -1;
      if (one_series) {
        seg = session[c.s1 + cmin] ? session[cmin] : -1;
        if (seg < 0 || seg >= c.out.n_seg) {  // not allowed, or its segment drops
          ++skipped;
          continue;
        }
      }
      ++run_chunks;
      const TileSource src(c, session, dyn, cols);
      const Out out = member_out(a, m);
      const CountedTarget t{ARM == ARM_SCATTER
                                ? Target{out.counts, out.sums, out.mins, out.maxs, out.n_seg}
                                : smem_target(parts + m * a.out_w, out),
                            commits};
      for (int p = 0; p < passes; ++p) {
        const int nf = min(n_agg - p * FCAP, FCAP);
        Carried run;
        if (a.carry) run.load(recs + m * rec_w, p, n_agg, lane, nf, MINMAX);
        if (one_series) {
          reduce_segment<MINMAX, FC>(src, rows, seg, out, t, p * FCAP, run);
        } else {
          reduce_runs<MINMAX, FC, true>(src, 0, rows, out, t, p * FCAP, run);
        }
        if (a.carry) {
          run.save(recs + m * rec_w, p, n_agg, lane, nf, MINMAX);
        } else {
          run.commit(t, lane, p * FCAP, nf, p == 0, MINMAX);
        }
      }
    }
  }
  if (a.carry) {
    __syncwarp();
    for (int m = 0; m < M; ++m) {
      const Out out = member_out(a, m);
      const CountedTarget t{ARM == ARM_SCATTER
                                ? Target{out.counts, out.sums, out.mins, out.maxs, out.n_seg}
                                : smem_target(parts + m * a.out_w, out),
                            commits};
      for (int p = 0; p < passes; ++p) {
        const int nf = min(n_agg - p * FCAP, FCAP);
        Carried run;
        run.load(recs + m * rec_w, p, n_agg, lane, nf, MINMAX);
        run.commit(t, lane, p * FCAP, nf, p == 0, MINMAX);
      }
    }
  }
  if (a.stats && lane == 0) {
    if (k1 > k0) atomicAdd(&a.stats[0], (unsigned long long)(k1 - k0));
    atomicAdd(&a.stats[1], run_chunks);
    atomicAdd(&a.stats[2], skipped);
  }
  if (ARM != ARM_SCATTER) {
    __syncthreads();
    for (int m = 0; m < M; ++m) {
      const Out out = member_out(a, m);
      flush_runs(smem_target(parts + m * a.out_w, out), out, out.n_seg, nullptr, nullptr);
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

// ---- kernels by arm, form, minmax and field capacity ------------------------
//
// A full scan, direct launch or cohort of at most one field takes the
// kernels with FC = 1; SELECTIVE and hash launches always FCAP (their
// launches are small, their builds many).

template <bool SELECTIVE, bool MINMAX, int FC>
static const void* cached_kernel_of(int arm) {
  switch (arm) {
    case ARM_SINGLE: return (const void*)scan_agg_cached<ARM_SINGLE, SELECTIVE, MINMAX, FC>;
    case ARM_SHARED: return (const void*)scan_agg_cached<ARM_SHARED, SELECTIVE, MINMAX, FC>;
    case ARM_SCATTER: return (const void*)scan_agg_cached<ARM_SCATTER, SELECTIVE, MINMAX, FC>;
  }
  return nullptr;
}

static const void* cached_kernel(int arm, bool selective, const Out& out) {
  const bool mm = out.minmax != 0;
  if (arm == ARM_HASH) {
    if (selective) return mm ? (const void*)scan_agg_cached<ARM_HASH, true, true, FCAP>
                             : (const void*)scan_agg_cached<ARM_HASH, true, false, FCAP>;
    return mm ? (const void*)scan_agg_cached<ARM_HASH, false, true, FCAP>
              : (const void*)scan_agg_cached<ARM_HASH, false, false, FCAP>;
  }
  if (selective)
    return mm ? cached_kernel_of<true, true, FCAP>(arm) : cached_kernel_of<true, false, FCAP>(arm);
  if (out.n_agg <= 1)
    return mm ? cached_kernel_of<false, true, 1>(arm) : cached_kernel_of<false, false, 1>(arm);
  return mm ? cached_kernel_of<false, true, FCAP>(arm) : cached_kernel_of<false, false, FCAP>(arm);
}

template <bool MINMAX, int FC>
static const void* direct_kernel_of(int arm) {
  switch (arm) {
    case ARM_SINGLE: return (const void*)scan_agg_direct<ARM_SINGLE, MINMAX, FC>;
    case ARM_SHARED: return (const void*)scan_agg_direct<ARM_SHARED, MINMAX, FC>;
    case ARM_SCATTER: return (const void*)scan_agg_direct<ARM_SCATTER, MINMAX, FC>;
  }
  return nullptr;
}

static const void* direct_kernel(int arm, const Out& out) {
  const bool mm = out.minmax != 0;
  if (arm == ARM_HASH) return mm ? (const void*)scan_agg_direct<ARM_HASH, true, FCAP>
                                 : (const void*)scan_agg_direct<ARM_HASH, false, FCAP>;
  if (out.n_agg <= 1) return mm ? direct_kernel_of<true, 1>(arm) : direct_kernel_of<false, 1>(arm);
  return mm ? direct_kernel_of<true, FCAP>(arm) : direct_kernel_of<false, FCAP>(arm);
}

template <bool MINMAX, int FC>
static const void* cohort_kernel_of(int arm) {
  switch (arm) {
    case ARM_SINGLE: return (const void*)scan_agg_cohort<ARM_SINGLE, MINMAX, FC>;
    case ARM_SHARED: return (const void*)scan_agg_cohort<ARM_SHARED, MINMAX, FC>;
    case ARM_SCATTER: return (const void*)scan_agg_cohort<ARM_SCATTER, MINMAX, FC>;
  }
  return nullptr;
}

static const void* cohort_kernel(int arm, const Out& out) {
  const bool mm = out.minmax != 0;
  if (out.n_agg <= 1) return mm ? cohort_kernel_of<true, 1>(arm) : cohort_kernel_of<false, 1>(arm);
  return mm ? cohort_kernel_of<true, FCAP>(arm) : cohort_kernel_of<false, FCAP>(arm);
}

// ``smem`` < 0: the arm's partials (smem_bytes); a cohort passes its own
static cudaError_t launch(const void* kernel, int arm, int device, long long n_rows,
                          const Out& out, cudaStream_t stream, const void* args,
                          long long smem_ = -1, long long rows_per_block = BLOCK * 8) {
  if (kernel == nullptr || n_rows < 0) return cudaErrorInvalidValue;
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
  // a full scan: enough rows per warp that the carried run partial pays
  // off; a segmented launch: the wrapper's block_rows; the cohort: one
  // tile a block at least
  long long want = (n_rows + rows_per_block - 1) / rows_per_block;
  long long cap = (long long)sms * per_sm;
  int grid = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  void* params[] = {(void*)args};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(BLOCK), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// blocks of a segmented launch's kernel one SM holds at the shared memory
// ``out`` asks for (``form``: 0 direct, 1 cached, 2 cached SELECTIVE), into
// ``per_sm``: the wrapper sizes ``block_rows`` and the hash table by it
static cudaError_t resident(const void* kernel, int arm, int device, const Out& out,
                            int* per_sm) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(arm, out);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, BLOCK, smem);
}

// a cohort launch's shared memory: the tile, then (single / shared) every
// member's partials, then (carry) each warp's records (``cohort_smem`` in
// ops/scan_agg.py, whose rule decides ``carry``)
static long long cohort_smem(const CohortArgs& a, int arm) {
  long long smem = (long long)a.tile * (2 + a.n_fields) * 4;
  if (arm != ARM_SCATTER) smem += (long long)a.members * a.out_w * 4;
  if (a.carry)
    smem += (long long)(BLOCK / 32) * a.members *
            cohort_record_words(a.c.out.n_agg, a.c.out.minmax != 0) * 4;
  return smem;
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
    return resident(direct_kernel(arm, *out), arm, device, *out, per_sm);
  if (form == 1 && arm == ARM_HASH)
    return resident(cached_kernel(arm, false, *out), arm, device, *out, per_sm);
  if (form == 2) return resident(cached_kernel(arm, true, *out), arm, device, *out, per_sm);
  return cudaErrorInvalidValue;
}

int scan_agg_direct_launch(const DirectArgs* a, int arm, void* stream) {
  if (arm == ARM_HASH && (!hash_ok(a->out) || !rows_ok(a->out))) return cudaErrorInvalidValue;
  const long long rows = arm == ARM_HASH ? a->out.block_rows : BLOCK * 8;
  return launch(direct_kernel(arm, a->out), arm, a->device, a->n_rows, a->out,
                (cudaStream_t)stream, a, -1, rows);
}

int scan_agg_cached_launch(const CachedArgs* a, int arm, int selective, void* stream) {
  if (arm == ARM_HASH && !hash_ok(a->out)) return cudaErrorInvalidValue;
  const bool segmented = selective || arm == ARM_HASH;
  if (segmented && !rows_ok(a->out)) return cudaErrorInvalidValue;
  const long long rows = segmented ? a->out.block_rows : BLOCK * 8;
  return launch(cached_kernel(arm, selective != 0, a->out), arm, a->device,
                a->n_rows, a->out, (cudaStream_t)stream, a, -1, rows);
}

int scan_agg_cohort_launch(const CohortArgs* a, int arm, void* stream) {
  if (a->members < 1 || a->tile < BLOCK || a->tile % BLOCK) return cudaErrorInvalidValue;
  const CachedArgs& c = a->c;
  return launch(cohort_kernel(arm, c.out), arm, c.device, c.n_rows, c.out,
                (cudaStream_t)stream, a, cohort_smem(*a, arm), a->tile);
}

const char* scan_agg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
