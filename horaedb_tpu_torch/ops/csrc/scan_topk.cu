// Raw reads over the resident scan cache: fused filter + top-k, and the
// bounded selection, for Hopper.
//
// Replaces the JAX package's jitted device programs (B4, B4c)
//   horaedb_tpu/ops/scan_topk.py  raw_topk_body    via raw_topk_packed
//   horaedb_tpu/ops/scan_topk.py  raw_select_body  via raw_select_packed
//   horaedb_tpu/ops/scan_topk.py  raw_topk_cohort  (raw_topk_body over B queries)
//
// Both read the scan cache's columns where they live, in any layout
// (layouts.cuh), and return only row ids; the host gathers those rows.
//
// The mask is the reference's _raw_mask: allow[series code] (the padded
// last entry is 0), lo <= ts < hi, and every numeric filter on the f32
// value. The key is its _sort_key: the timestamp, or the order-preserving
// f32 -> int32 bit transform of the key field; negated for ASC; NaN pinned
// to INT32_MIN + 1 after the negation; INT32_MIN for masked-out rows. No
// masked-in row has the key INT32_MIN, so the key buffer carries the mask.
//
// Top-k. The reference bisects 32 times for the threshold, each step a
// count over every key. Here:
//   raw_init     one block zeroes the state and the histogram;
//   raw_keys     one pass decodes, masks and writes the int32 key buffer,
//                counts the masked-in rows and histograms the top 8-bit
//                digit of the key (sign bit flipped: unsigned order);
//   topk_pick    one block picks the digit that holds the k-th largest key
//                and carries the remaining rank on the device;
//   topk_hist    three more passes histogram the next digit over the keys
//                whose higher digits match the prefix so far; after the
//                last pick the k-th key is exact, and the pick computes the
//                threshold the bisection returns (see topk_pick);
//   raw_flags    one pass over the keys writes ballot bit words of the
//                rows strictly above the threshold and of the ties, with
//                per-tile counts;
//   raw_scan     one block scans the tile counts (exclusive prefix sums);
//   raw_write    each tile writes its set bits' row ids at its offset:
//                strict rows first, in row order, then ties in row order;
//                tiles whose offset is past the last slot return at once;
//   raw_fill     slots past the rows written get -1 (or n_rows where the
//                reference's searchsorted runs past its stream); where the
//                caller asks (key_out), every slot's key too, INT32_MIN for
//                a slot that holds no row (the reference's keys output,
//                which the sharded top-k merges on).
// No host round trip between launches: one copy of the k slots comes back.
//
// What bounds top-k: the bytes of the resident columns (one decode pass)
// and of the key buffer (written once, read four times); the picks and the
// scan are single-block steps of a few microseconds each.
//
// Selection (B4 select; B7b select is it once a shard) visits only the rows
// that can pass. The cache is sorted by (series, ts), so the allowed
// series' rows inside the time range are a few row WINDOWS, which the
// executor knows before the launch (its candidate estimate walks them).
// The launcher cuts them into a tile table (raw_select_tiles: tiles of at
// most TILE rows, each inside one window, in row order) and copies it to
// the card. Then one launch, raw_select, one block a tile:
//   - the block takes its tile from a ticket counter (tiles start in order);
//   - it decodes and masks the tile's rows into ballot words in shared
//     memory, issuing each row's loads (series code, timestamp, the first
//     filter fields) before the allow list answers: inside the windows
//     nearly every row is allowed and in range, so a row costs two
//     dependent loads, not four;
//   - a decoupled look-back over the tiles' status words (aggregate, then
//     inclusive prefix) gives its offset; the last tile writes the count;
//   - it writes its rows' ids in row order, never past ``slots``; a memset
//     before the launch left -1 in every slot and the look-back state.
// The whole mask still runs inside the windows (allow list, time range,
// every filter), so any cover of the passing rows gives the same answer;
// a pad row or a row outside the windows is never read, and an empty table
// still writes count 0. What bounds it: the window rows' column bytes (a
// few hundred kB at high-cpu-16, against 2^26 padded rows before); at that
// size the launch and one chain of dependent loads set its time. The
// first redesign kept raw_flags, raw_scan, raw_write and raw_fill over the
// table: on the card the three after raw_flags and the host cost of four
// launches then made most of the time, so they were fused. What was hard:
// row ids stay physical and in row order across windows that start inside
// a 128-row delta block and end inside a tile (a tile is a row range, not
// a multiple of TILE), and the look-back cannot deadlock: a block spins
// only on tiles whose tickets came before its own, which are running.
//
// Cohort top-k (B4c): B queries of one shape (the same k, key and filter
// fields; their own allow lists, time ranges and literals) in one launch
// sequence, at most MAX_COHORT members a sequence. The key of a row does
// not depend on the member, only whether it passes does, so:
//   cohort_init   one block per member zeroes its state and histogram;
//   cohort_keys   one pass decodes each row once, writes ONE key buffer
//                 (not B) and, per member, a ballot bit word of the rows
//                 that pass, the passing count and the top-digit histogram;
//   cohort_hist   three passes read each key once and histogram the next
//                 digit for every member whose bits and prefix match;
//   cohort_pick   topk_pick, one block per member;
//   cohort_flags  one pass reads each key once and writes every member's
//                 strict and tie bit words and per-tile counts;
//   cohort_scan, cohort_write, cohort_fill
//                 raw_scan, raw_write and raw_fill with the member on the
//                 grid (block = chunk * B + member where blocks share rows).
// Member b's slots are those raw_topk gives for its session and dyn row:
// the same keys, mask, histograms and threshold rule.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "layouts.cuh"

#define BLOCK 256
#define TILE 4096             // rows per tile, 16 per thread
#define WORDS (TILE / 32)     // ballot words per tile
#define SCAN_THREADS 1024
#define FULL_MASK 0xffffffffu
#define KEY_MASKED (-2147483647 - 1)

// state words at the head of the scratch buffer
enum {
  ST_TOTAL = 0,   // masked-in rows
  ST_RANK = 1,    // rank of the k-th key inside the digits still to pick
  ST_PREFIX = 2,  // the k-th key's digits picked so far (flipped bits)
  ST_ACTIVE = 3,  // total >= k: the k-th key exists
  ST_THR = 4,     // the threshold
  ST_STRICT = 5,  // rows strictly above the threshold
  ST_TIE = 6,     // masked-in rows at the threshold
  ST_LIMIT = 7,   // min(k, total): slots that hold a row
  ST_WORDS = 16,
};
enum { MODE_STRICT = 0, MODE_TIE = 1 };

struct RawArgs {
  Column series;
  Column ts;
  Column fields[MAX_FIELDS];
  const int* session;  // allow list [S + 1]
  const int* dyn;      // [literal bits (n_f) | lo, hi, key_lo, key_hi]
  int* keys;           // [n_rows] (top-k only)
  int* scratch;        // top-k [state | hist 256 | counts 2 x tiles | bits 2 x tiles x
                       // WORDS]; selection [status 2 x n_tiles | ticket], out after it
  int* out;            // top-k [k]; selection [1 + k]
  int* key_out;        // top-k: the slots' keys [k], or null
  const int* tiles;    // selection: [n_tiles][2] rows [row0, row1) of each tile
  long long n_tiles;   // selection: tiles of the table
  long long n_rows;
  long long k;         // top-k slots, or the selection's slots
  int descending;
  int key_is_ts;
  int key_field;
  int device;
  Filters filt;
};

// a cohort member's scratch adds the bit words of the rows it passes
struct Scratch {
  int* st;
  int* hist;
  int* cnt[2];
  unsigned* bits[2];
  unsigned* mask;
};

__device__ __forceinline__ long long n_tiles_of(long long n) { return (n + TILE - 1) / TILE; }

__device__ __forceinline__ Scratch scratch_at(int* base, long long n_rows) {
  const long long nt = n_tiles_of(n_rows);
  Scratch s;
  s.st = base;
  s.hist = base + ST_WORDS;
  s.cnt[0] = s.hist + 256;
  s.cnt[1] = s.cnt[0] + nt;
  s.bits[0] = (unsigned*)(s.cnt[1] + nt);
  s.bits[1] = s.bits[0] + nt * WORDS;
  s.mask = s.bits[1] + nt * WORDS;
  return s;
}

__device__ __forceinline__ Scratch scratch_of(const RawArgs& a) {
  return scratch_at(a.scratch, a.n_rows);
}

// ---- mask and key -------------------------------------------------------------

__device__ __forceinline__ bool row_mask(const RawArgs& a, long long i, int lo, int hi, int& ts) {
  const int code = load_int(a.series, i);
  if (a.session[code] == 0) return false;
  ts = load_int(a.ts, i);
  if (!(ts >= lo && ts < hi)) return false;
  for (int f = 0; f < a.filt.n; ++f) {
    const float v = load_value(a.fields[a.filt.field[f]], i);
    if (!compare(v, a.filt.op[f], __int_as_float(a.dyn[f]))) return false;
  }
  return true;
}

// The selection's row_mask with a row's loads issued together: the series
// code, the timestamp and the first EAGER_FILTERS filter fields, then the
// allow list.
#define EAGER_FILTERS 2

__device__ __forceinline__ bool row_mask_eager(const RawArgs& a, long long i, int lo, int hi) {
  const int nf = a.filt.n;
  const int code = load_int(a.series, i);
  const int ts = load_int(a.ts, i);
  float v[EAGER_FILTERS];
#pragma unroll
  for (int f = 0; f < EAGER_FILTERS; ++f)
    v[f] = f < nf ? load_value(a.fields[a.filt.field[f]], i) : 0.0f;
  bool ok = (a.session[code] != 0) & (ts >= lo) & (ts < hi);
#pragma unroll
  for (int f = 0; f < EAGER_FILTERS; ++f)
    if (f < nf) ok &= compare(v[f], a.filt.op[f], __int_as_float(a.dyn[f]));
  for (int f = EAGER_FILTERS; ok && f < nf; ++f)
    ok = compare(load_value(a.fields[a.filt.field[f]], i), a.filt.op[f],
                 __int_as_float(a.dyn[f]));
  return ok;
}

// int32 negation that wraps, as the reference's does
__device__ __forceinline__ int neg(int x) { return (int)(0u - (uint32_t)x); }

// monotone f32 -> int32: -inf < ... < -0 < +0 < ... < +inf < NaN
__device__ __forceinline__ int f32_sort_key(float v) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t u2 = (u >> 31) ? ~u : (u | 0x80000000u);
  return (int)(u2 ^ 0x80000000u);
}

__device__ __forceinline__ int sort_key(const RawArgs& a, long long i, int ts) {
  if (a.key_is_ts) return a.descending ? ts : neg(ts);
  const float v = load_value(a.fields[a.key_field], i);
  int key = f32_sort_key(v);
  if (!a.descending) key = neg(key);
  // NaN ranks below every real value in both directions
  return isnan(v) ? KEY_MASKED + 1 : key;
}

__device__ __forceinline__ uint32_t flipped(int key) { return (uint32_t)key ^ 0x80000000u; }

// ---- block helpers ------------------------------------------------------------

// exclusive prefix sum over the block; ``total`` gets the block's sum
template <int NT>
__device__ __forceinline__ int block_scan(int v, int& total) {
  __shared__ int ws[NT / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < NT / 32 ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NT / 32) ws[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (w ? ws[w - 1] : 0);
  total = ws[NT / 32 - 1];
  __syncthreads();  // ws is reused by the next call
  return excl;
}

// add one row's digit (256 = no row) to the block's shared histogram,
// one atomic per distinct digit of the warp
__device__ __forceinline__ void hist_add(int* hist, int d) {
  const unsigned peers = __match_any_sync(FULL_MASK, d);
  if (d < 256 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
}

__device__ __forceinline__ void hist_flush(int* shared_hist, int* global_hist) {
  __syncthreads();
  for (int t = threadIdx.x; t < 256; t += BLOCK) {
    if (shared_hist[t]) atomicAdd(&global_hist[t], shared_hist[t]);
  }
}

// ---- top-k: keys and the radix select --------------------------------------

// One block: zeroes the state words and the histogram.
__global__ void __launch_bounds__(BLOCK) raw_init(const __grid_constant__ RawArgs a) {
  for (int t = threadIdx.x; t < ST_WORDS + 256; t += BLOCK) a.scratch[t] = 0;
}

__global__ void __launch_bounds__(BLOCK) raw_keys(const __grid_constant__ RawArgs a) {
  __shared__ int hist[256];
  const Scratch s = scratch_of(a);
  const int nf = a.filt.n;
  const int lo = a.dyn[nf], hi = a.dyn[nf + 1];
  for (int t = threadIdx.x; t < 256; t += BLOCK) hist[t] = 0;
  __syncthreads();
  int count = 0;
  const long long nt = n_tiles_of(a.n_rows);
  for (long long tile = blockIdx.x; tile < nt; tile += gridDim.x) {
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const long long i = tile * TILE + j * BLOCK + threadIdx.x;
      int key = KEY_MASKED;
      if (i < a.n_rows) {
        int ts = 0;
        if (row_mask(a, i, lo, hi, ts)) key = sort_key(a, i, ts);
        a.keys[i] = key;
      }
      const bool in = key != KEY_MASKED;
      count += in;
      hist_add(hist, in ? (int)(flipped(key) >> 24) : 256);
    }
  }
  hist_flush(hist, s.hist);
  int total;
  block_scan<BLOCK>(count, total);
  if (threadIdx.x == 0 && total) atomicAdd(&s.st[ST_TOTAL], total);
}

__global__ void __launch_bounds__(BLOCK) topk_hist(const __grid_constant__ RawArgs a, int shift) {
  __shared__ int hist[256];
  const Scratch s = scratch_of(a);
  if (!s.st[ST_ACTIVE]) return;  // fewer than k rows: no k-th key to find
  const uint32_t want = (uint32_t)s.st[ST_PREFIX] >> (shift + 8);
  for (int t = threadIdx.x; t < 256; t += BLOCK) hist[t] = 0;
  __syncthreads();
  const long long nt = n_tiles_of(a.n_rows);
  for (long long tile = blockIdx.x; tile < nt; tile += gridDim.x) {
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const long long i = tile * TILE + j * BLOCK + threadIdx.x;
      int d = 256;
      if (i < a.n_rows) {
        const int key = a.keys[i];
        const uint32_t u = flipped(key);
        if (key != KEY_MASKED && (u >> (shift + 8)) == want) d = (int)((u >> shift) & 255u);
      }
      hist_add(hist, d);
    }
  }
  hist_flush(hist, s.hist);
}

// One block. Picks the digit at ``shift`` that holds the k-th largest key
// and clears the histogram for the next pass. After the last digit it sets
// the threshold the reference's bisection (_kth_threshold) returns for the
// seeds [key_lo, key_hi]: with c(t) = count(key > t), the bisection keeps
// c(hi) < k and ends at min(key_hi, max(key_lo + 1, t*)), t* the least t
// with c(t) < k (the k-th largest key when total >= k, else INT32_MIN), or
// at key_hi when key_hi <= key_lo + 1 and it never runs.
__device__ __forceinline__ void pick_digit(const Scratch& s, long long k, const int* dyn, int nf,
                                           int shift) {
  __shared__ int h[256];
  const int t = threadIdx.x;
  h[t] = s.hist[t];
  s.hist[t] = 0;
  __syncthreads();
  if (t != 0) return;
  int* st = s.st;
  if (shift == 24) {
    st[ST_ACTIVE] = (long long)st[ST_TOTAL] >= k;
    st[ST_RANK] = (int)(k < st[ST_TOTAL] ? k : st[ST_TOTAL]);
    st[ST_PREFIX] = 0;
  }
  if (st[ST_ACTIVE]) {
    const int r = st[ST_RANK];
    int cum = 0, d = 255;
    for (; d > 0; --d) {
      if (cum + h[d] >= r) break;
      cum += h[d];
    }
    st[ST_RANK] = r - cum;
    st[ST_PREFIX] = (int)((uint32_t)st[ST_PREFIX] | ((uint32_t)d << shift));
  }
  if (shift == 0) {
    const long long key_lo = dyn[nf + 2], key_hi = dyn[nf + 3];
    long long thr;
    if (key_hi <= key_lo + 1) {
      thr = key_hi;
    } else {
      thr = st[ST_ACTIVE] ? (long long)(int)flipped(st[ST_PREFIX]) : (long long)KEY_MASKED;
      if (thr < key_lo + 1) thr = key_lo + 1;
      if (thr > key_hi) thr = key_hi;
    }
    st[ST_THR] = (int)thr;
    st[ST_LIMIT] = (int)(k < st[ST_TOTAL] ? k : st[ST_TOTAL]);
  }
}

__global__ void __launch_bounds__(BLOCK) topk_pick(const __grid_constant__ RawArgs a, int shift) {
  pick_digit(scratch_of(a), a.k, a.dyn, a.filt.n, shift);
}

// ---- ordered compaction -------------------------------------------------------

// Ballot bit words and per-tile counts of the rows strictly above the
// threshold (stream 0) and the ties (stream 1), from the key buffer.
__global__ void __launch_bounds__(BLOCK) raw_flags(const __grid_constant__ RawArgs a) {
  __shared__ int wsum[2][BLOCK / 32];
  const Scratch s = scratch_of(a);
  const int thr = s.st[ST_THR];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long nt = n_tiles_of(a.n_rows);
  for (long long tile = blockIdx.x; tile < nt; tile += gridDim.x) {
    int c0 = 0, c1 = 0;
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const long long i = tile * TILE + j * BLOCK + threadIdx.x;
      bool f0 = false, f1 = false;
      if (i < a.n_rows) {
        const int key = a.keys[i];
        f0 = key > thr;
        f1 = key != KEY_MASKED && key == thr;
      }
      const unsigned b0 = __ballot_sync(FULL_MASK, f0);
      const unsigned b1 = __ballot_sync(FULL_MASK, f1);
      if (lane == 0) {
        const long long word = tile * WORDS + j * (BLOCK / 32) + w;
        s.bits[0][word] = b0;
        s.bits[1][word] = b1;
        c0 += __popc(b0);
        c1 += __popc(b1);
      }
    }
    if (lane == 0) {
      wsum[0][w] = c0;
      wsum[1][w] = c1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int t0 = 0, t1 = 0;
      for (int k = 0; k < BLOCK / 32; ++k) {
        t0 += wsum[0][k];
        t1 += wsum[1][k];
      }
      s.cnt[0][tile] = t0;
      s.cnt[1][tile] = t1;
    }
    __syncthreads();
  }
}

// One block: exclusive prefix sums of the tile counts of both streams, in
// place; the totals go to the state.
__device__ __forceinline__ void scan_tiles(const Scratch& s, long long nt) {
  for (int q = 0; q < 2; ++q) {
    int* cnt = s.cnt[q];
    int carry = 0;
    for (long long base = 0; base < nt; base += SCAN_THREADS) {
      const long long t = base + threadIdx.x;
      const int v = t < nt ? cnt[t] : 0;
      int total;
      const int excl = block_scan<SCAN_THREADS>(v, total);
      if (t < nt) cnt[t] = carry + excl;
      carry += total;
    }
    if (threadIdx.x == 0) s.st[q == 0 ? ST_STRICT : ST_TIE] = carry;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS) raw_scan(const __grid_constant__ RawArgs a) {
  scan_tiles(scratch_of(a), n_tiles_of(a.n_rows));
}

// Each tile writes the row ids of its set bits, in row order, to slots
// [first + offset, ...) below ``limit``: strict rows from slot 0 and below
// k; ties from slot n_strict and below min(k, total). One thread per bit
// word.
// blocks ``blk`` of ``nblk`` share the tiles
__device__ __forceinline__ void write_slots(const Scratch& s, long long n_rows, long long k,
                                            int* out, int mode, long long blk, long long nblk) {
  const int q = mode == MODE_TIE ? 1 : 0;
  long long first, limit;
  if (mode == MODE_STRICT) {
    first = 0;
    limit = k;
  } else {
    first = s.st[ST_STRICT];
    limit = s.st[ST_LIMIT];
  }
  const long long nt = n_tiles_of(n_rows);
  for (long long tile = blk; tile < nt; tile += nblk) {
    const long long start = first + s.cnt[q][tile];
    if (start >= limit) continue;  // the whole tile lands past the last slot
    unsigned bits = s.bits[q][tile * WORDS + threadIdx.x];
    int total;
    long long pos = start + block_scan<WORDS>(__popc(bits), total);
    const long long row0 = tile * TILE + (long long)threadIdx.x * 32;
    while (bits && pos < limit) {
      const int b = __ffs(bits) - 1;
      out[pos++] = (int)(row0 + b);
      bits &= bits - 1;
    }
  }
}

__global__ void __launch_bounds__(WORDS) raw_write(const __grid_constant__ RawArgs a, int mode) {
  write_slots(scratch_of(a), a.n_rows, a.k, a.out, mode, blockIdx.x, gridDim.x);
}

// Slots no tile wrote: -1 from min(k, total) on; below it only where the
// reference's tie stream runs out (its searchsorted returns n_rows there;
// never with seeds that bracket the keys).
__device__ __forceinline__ void fill_slots(const Scratch& s, long long n_rows, long long k,
                                           int* out, long long blk, long long nblk,
                                           const int* keys = nullptr, int* key_out = nullptr) {
  const long long stride = nblk * BLOCK;
  const long long n_strict = s.st[ST_STRICT], n_tie = s.st[ST_TIE], limit = s.st[ST_LIMIT];
  for (long long j = blk * BLOCK + threadIdx.x; j < k; j += stride) {
    const bool written = j < n_strict || (j < limit && j - n_strict < n_tie);
    const int row = written ? out[j] : (j < limit ? (int)n_rows : -1);
    if (!written) out[j] = row;
    if (key_out) key_out[j] = row >= 0 && row < n_rows ? keys[row] : KEY_MASKED;
  }
}

__global__ void __launch_bounds__(BLOCK) raw_fill(const __grid_constant__ RawArgs a) {
  fill_slots(scratch_of(a), a.n_rows, a.k, a.out, blockIdx.x, gridDim.x, a.keys, a.key_out);
}

// ---- the bounded selection (B4 select): one launch over the tile table -------

// A tile's status word in the look-back: LB_NONE until the tile has its
// count; then the count (the aggregate), or LB_INCL | the rows of every
// tile up to and with it (the inclusive prefix). One 64-bit word, so the
// flag and the value are read together.
#define LB_NONE (-1LL)
#define LB_INCL (1LL << 62)

__device__ __forceinline__ long long lb_load(const long long* p) {
  return *(const volatile long long*)p;
}

__device__ __forceinline__ void lb_store(long long* p, long long v) {
  atomicExch((unsigned long long*)p, (unsigned long long)v);
}

// One block a tile of the table (at least one block: an empty table's
// writes the count 0). a.scratch: the status words and the ticket, all -1
// (LB_NONE) from the launcher's memset, which also left -1 in every slot.
__global__ void __launch_bounds__(BLOCK) raw_select(const __grid_constant__ RawArgs a) {
  __shared__ unsigned words[WORDS];
  __shared__ int wsum[BLOCK / 32];
  __shared__ long long tile_s, excl_s;
  long long* status = (long long*)a.scratch;
  int* ticket = a.scratch + 2 * a.n_tiles;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = (long long)atomicAdd(ticket, 1) + 1;  // -1 before the first
  __syncthreads();
  const long long tile = tile_s;
  if (tile >= a.n_tiles) {
    if (threadIdx.x == 0) a.out[0] = 0;
    return;
  }
  const int nf = a.filt.n;
  const int lo = a.dyn[nf], hi = a.dyn[nf + 1];
  const long long r0 = a.tiles[2 * tile], r1 = a.tiles[2 * tile + 1];
  // row r0 + j * BLOCK + t is bit t & 31 of word j * (BLOCK / 32) + t / 32;
  // a row past r1 reads row r0 and is dropped
  unsigned pass = 0;
#pragma unroll
  for (int j = 0; j < TILE / BLOCK; ++j) {
    const long long i = r0 + j * BLOCK + threadIdx.x;
    const bool in = i < r1;
    if (row_mask_eager(a, in ? i : r0, lo, hi) && in) pass |= 1u << j;
  }
  int c = 0;
#pragma unroll
  for (int j = 0; j < TILE / BLOCK; ++j) {
    const unsigned b = __ballot_sync(FULL_MASK, (pass >> j) & 1u);
    if (lane == 0) words[j * (BLOCK / 32) + w] = b;
    c += __popc(b);
  }
  if (lane == 0) wsum[w] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long count = 0;
    for (int k = 0; k < BLOCK / 32; ++k) count += wsum[k];
    long long excl = 0;
    if (tile > 0) {
      lb_store(&status[tile], count);
      for (long long p = tile - 1;; --p) {
        long long st;
        do {
          st = lb_load(&status[p]);
        } while (st == LB_NONE);
        excl += st & 0xffffffffLL;
        if (st & LB_INCL) break;
      }
    }
    lb_store(&status[tile], LB_INCL | (excl + count));
    if (tile == a.n_tiles - 1) a.out[0] = (int)(excl + count);
    excl_s = excl;
  }
  __syncthreads();
  // thread t < WORDS writes word t's rows at its offset, below 1 + slots
  const unsigned bits = threadIdx.x < WORDS ? words[threadIdx.x] : 0u;
  int total;
  long long pos = 1 + excl_s + block_scan<BLOCK>(__popc(bits), total);
  const long long row0 = r0 + (long long)threadIdx.x * 32;
  for (unsigned b = bits; b && pos < 1 + a.k; b &= b - 1) a.out[pos++] = (int)(row0 + __ffs(b) - 1);
}

// ---- cohort top-k (B4c) ---------------------------------------------------------

#define MAX_COHORT 32

// r: the columns, statics, the shared key buffer (r.keys) and the bases of
// the scratch and the slots (r.session and r.dyn unused); member b reads
// sessions + b * sess_w and dyns + b * dyn_w, keeps its scratch at
// r.scratch + b * member_words and writes its k slots at r.out + b * k.
struct CohortRawArgs {
  RawArgs r;
  const int* sessions;
  const int* dyns;
  long long member_words;
  int members;
  int sess_w;
  int dyn_w;
  int pad_;
};

__device__ __forceinline__ Scratch member_scratch(const CohortRawArgs& a, int m) {
  return scratch_at(a.r.scratch + (long long)m * a.member_words, a.r.n_rows);
}

__global__ void __launch_bounds__(BLOCK) cohort_init(const __grid_constant__ CohortRawArgs a) {
  int* base = a.r.scratch + (long long)blockIdx.x * a.member_words;
  for (int t = threadIdx.x; t < ST_WORDS + 256; t += BLOCK) base[t] = 0;
}

__global__ void __launch_bounds__(BLOCK) cohort_keys(const __grid_constant__ CohortRawArgs a) {
  __shared__ int hist[MAX_COHORT][256];
  __shared__ int count[MAX_COHORT];
  __shared__ int lo_s[MAX_COHORT], hi_s[MAX_COHORT];
  const RawArgs& r = a.r;
  const int M = a.members, nf = r.filt.n;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < M * 256; t += BLOCK) hist[t >> 8][t & 255] = 0;
  for (int m = threadIdx.x; m < M; m += BLOCK) {
    count[m] = 0;
    lo_s[m] = a.dyns[(long long)m * a.dyn_w + nf];
    hi_s[m] = a.dyns[(long long)m * a.dyn_w + nf + 1];
  }
  __syncthreads();
  const long long nt = n_tiles_of(r.n_rows);
  for (long long tile = blockIdx.x; tile < nt; tile += gridDim.x) {
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const long long i = tile * TILE + j * BLOCK + threadIdx.x;
      int key = KEY_MASKED;
      unsigned pass = 0;  // bit m: member m keeps the row
      if (i < r.n_rows) {
        const int code = load_int(r.series, i);
        unsigned allow = 0;
        for (int m = 0; m < M; ++m)
          if (a.sessions[(long long)m * a.sess_w + code] != 0) allow |= 1u << m;
        if (allow) {
          const int ts = load_int(r.ts, i);
          key = sort_key(r, i, ts);
          float fv[MAX_FILTERS];
#pragma unroll
          for (int f = 0; f < MAX_FILTERS; ++f)
            if (f < nf) fv[f] = load_value(r.fields[r.filt.field[f]], i);
          if (key != KEY_MASKED) {
            for (int m = 0; m < M; ++m) {
              if (!((allow >> m) & 1u) || ts < lo_s[m] || ts >= hi_s[m]) continue;
              const int* lit = a.dyns + (long long)m * a.dyn_w;
              bool ok = true;
#pragma unroll
              for (int f = 0; f < MAX_FILTERS; ++f)
                if (f < nf && ok) ok = compare(fv[f], r.filt.op[f], __int_as_float(lit[f]));
              if (ok) pass |= 1u << m;
            }
          }
        }
        r.keys[i] = key;
      }
      const long long word = tile * WORDS + j * (BLOCK / 32) + w;
      const int digit = (int)(flipped(key) >> 24);
      for (int m = 0; m < M; ++m) {
        const bool in = (pass >> m) & 1u;
        const unsigned b = __ballot_sync(FULL_MASK, in);
        if (lane == 0) {
          member_scratch(a, m).mask[word] = b;
          if (b) atomicAdd(&count[m], __popc(b));
        }
        if (b) hist_add(hist[m], in ? digit : 256);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < M * 256; t += BLOCK) {
    const int m = t >> 8;
    if (hist[m][t & 255]) atomicAdd(&member_scratch(a, m).hist[t & 255], hist[m][t & 255]);
  }
  for (int m = threadIdx.x; m < M; m += BLOCK)
    if (count[m]) atomicAdd(&member_scratch(a, m).st[ST_TOTAL], count[m]);
}

__global__ void __launch_bounds__(BLOCK) cohort_hist(const __grid_constant__ CohortRawArgs a,
                                                     int shift) {
  __shared__ int hist[MAX_COHORT][256];
  __shared__ unsigned want[MAX_COHORT];
  __shared__ int active[MAX_COHORT];
  const RawArgs& r = a.r;
  const int M = a.members;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < M * 256; t += BLOCK) hist[t >> 8][t & 255] = 0;
  for (int m = threadIdx.x; m < M; m += BLOCK) {
    const Scratch s = member_scratch(a, m);
    active[m] = s.st[ST_ACTIVE];  // fewer than k rows: no k-th key to find
    want[m] = (uint32_t)s.st[ST_PREFIX] >> (shift + 8);
  }
  __syncthreads();
  const long long nt = n_tiles_of(r.n_rows);
  for (long long tile = blockIdx.x; tile < nt; tile += gridDim.x) {
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const long long i = tile * TILE + j * BLOCK + threadIdx.x;
      const uint32_t u = flipped(i < r.n_rows ? r.keys[i] : KEY_MASKED);
      const long long word = tile * WORDS + j * (BLOCK / 32) + w;
      for (int m = 0; m < M; ++m) {
        if (!active[m]) continue;
        const unsigned bits = member_scratch(a, m).mask[word];  // the same word in every lane
        if (bits == 0) continue;
        const bool in = ((bits >> lane) & 1u) && (u >> (shift + 8)) == want[m];
        hist_add(hist[m], in ? (int)((u >> shift) & 255u) : 256);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < M * 256; t += BLOCK) {
    const int m = t >> 8;
    if (hist[m][t & 255]) atomicAdd(&member_scratch(a, m).hist[t & 255], hist[m][t & 255]);
  }
}

__global__ void __launch_bounds__(BLOCK) cohort_pick(const __grid_constant__ CohortRawArgs a,
                                                     int shift) {
  const int m = blockIdx.x;
  pick_digit(member_scratch(a, m), a.r.k, a.dyns + (long long)m * a.dyn_w, a.r.filt.n, shift);
}

__global__ void __launch_bounds__(BLOCK) cohort_flags(const __grid_constant__ CohortRawArgs a) {
  __shared__ int thr_s[MAX_COHORT];
  __shared__ int c0[MAX_COHORT], c1[MAX_COHORT];
  const RawArgs& r = a.r;
  const int M = a.members;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int m = threadIdx.x; m < M; m += BLOCK) thr_s[m] = member_scratch(a, m).st[ST_THR];
  const long long nt = n_tiles_of(r.n_rows);
  for (long long tile = blockIdx.x; tile < nt; tile += gridDim.x) {
    for (int m = threadIdx.x; m < M; m += BLOCK) c0[m] = c1[m] = 0;
    __syncthreads();
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const long long i = tile * TILE + j * BLOCK + threadIdx.x;
      const int key = i < r.n_rows ? r.keys[i] : KEY_MASKED;
      const long long word = tile * WORDS + j * (BLOCK / 32) + w;
      for (int m = 0; m < M; ++m) {
        const Scratch s = member_scratch(a, m);
        const unsigned bits = s.mask[word];  // the same word in every lane
        unsigned b0 = 0, b1 = 0;
        if (bits) {
          const bool in = (bits >> lane) & 1u;
          b0 = __ballot_sync(FULL_MASK, in && key > thr_s[m]);
          b1 = __ballot_sync(FULL_MASK, in && key == thr_s[m]);
        }
        if (lane == 0) {
          s.bits[0][word] = b0;
          s.bits[1][word] = b1;
          if (b0) atomicAdd(&c0[m], __popc(b0));
          if (b1) atomicAdd(&c1[m], __popc(b1));
        }
      }
    }
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += BLOCK) {
      const Scratch s = member_scratch(a, m);
      s.cnt[0][tile] = c0[m];
      s.cnt[1][tile] = c1[m];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SCAN_THREADS) cohort_scan(const __grid_constant__ CohortRawArgs a) {
  scan_tiles(member_scratch(a, blockIdx.x), n_tiles_of(a.r.n_rows));
}

__global__ void __launch_bounds__(WORDS) cohort_write(const __grid_constant__ CohortRawArgs a,
                                                      int mode) {
  const int m = (int)(blockIdx.x % (unsigned)a.members);
  write_slots(member_scratch(a, m), a.r.n_rows, a.r.k, a.r.out + (long long)m * a.r.k, mode,
              blockIdx.x / (unsigned)a.members, gridDim.x / (unsigned)a.members);
}

__global__ void __launch_bounds__(BLOCK) cohort_fill(const __grid_constant__ CohortRawArgs a) {
  const int m = (int)(blockIdx.x % (unsigned)a.members);
  fill_slots(member_scratch(a, m), a.r.n_rows, a.r.k, a.r.out + (long long)m * a.r.k,
             blockIdx.x / (unsigned)a.members, gridDim.x / (unsigned)a.members);
}

// ---- host launch (plain C interface, loaded with ctypes) --------------------

static long long host_tiles(long long n) { return (n + TILE - 1) / TILE; }

static cudaError_t grid_for(int device, long long work, int per_sm, int* grid) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long cap = (long long)sms * per_sm;
  *grid = (int)(work < 1 ? 1 : (work < cap ? work : cap));
  return cudaSuccess;
}

#define TRY(x)                             \
  do {                                     \
    cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
#define LAUNCHED()                                   \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

extern "C" {

// struct sizes and layout constants, so the ctypes mirror can check itself
int scan_topk_abi(long long* sizes) {
  sizes[0] = sizeof(RawArgs);
  sizes[1] = MAX_FIELDS;
  sizes[2] = MAX_FILTERS;
  sizes[3] = TILE;
  sizes[4] = ST_WORDS + 256;
  sizes[5] = sizeof(CohortRawArgs);
  sizes[6] = MAX_COHORT;
  return 0;
}

int raw_topk_launch(const RawArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TRY(cudaSetDevice(a->device));
  const long long nt = host_tiles(a->n_rows);
  int grid, wgrid, fgrid;
  TRY(grid_for(a->device, nt, 8, &grid));
  TRY(grid_for(a->device, nt, 16, &wgrid));
  TRY(grid_for(a->device, (a->k + BLOCK - 1) / BLOCK, 8, &fgrid));
  raw_init<<<1, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  raw_keys<<<grid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (shift != 24) {
      topk_hist<<<grid, BLOCK, 0, s>>>(*a, shift);
      LAUNCHED();
    }
    topk_pick<<<1, 256, 0, s>>>(*a, shift);
    LAUNCHED();
  }
  raw_flags<<<grid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  raw_scan<<<1, SCAN_THREADS, 0, s>>>(*a);
  LAUNCHED();
  raw_write<<<wgrid, WORDS, 0, s>>>(*a, MODE_STRICT);
  LAUNCHED();
  raw_write<<<wgrid, WORDS, 0, s>>>(*a, MODE_TIE);
  LAUNCHED();
  raw_fill<<<fgrid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  return 0;
}

// The selection's tile table of ``n_windows`` row windows (int64 [start,
// end) pairs in host memory): checks that they are sorted, disjoint and
// inside [0, n_rows), then writes each window's tiles of at most TILE rows,
// in row order, to ``tiles`` (host, 2 ints a tile) unless it is null.
// Returns the tile count, or -1 for windows it refuses. Its spec is
// ops/scan_topk.py select_tiles.
long long raw_select_tiles(const long long* windows, long long n_windows, long long n_rows,
                           int* tiles) {
  long long n = 0, prev = 0;
  for (long long w = 0; w < n_windows; ++w) {
    const long long start = windows[2 * w], end = windows[2 * w + 1];
    if (start < prev || end < start || end > n_rows) return -1;
    prev = end;
    for (long long r = start; r < end; r += TILE, ++n) {
      if (tiles) {
        tiles[2 * n] = (int)r;
        tiles[2 * n + 1] = (int)(r + TILE < end ? r + TILE : end);
      }
    }
  }
  return n;
}

// The selection over the tile table of ``windows``. The wrapper's buffer:
// [status 2 x n_tiles | ticket | out[0] | slots k | table 2 x n_tiles]
// (a->scratch, a->out, a->tiles). One memset puts -1 in the status words,
// the ticket, the count and the slots; the table is built here and copied
// to the card (from pageable memory: staged before the call returns); one
// launch of raw_select.
int raw_select_launch(const RawArgs* a, const long long* windows, long long n_windows,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nt = a->n_tiles;
  if (nt < 0 || a->out != a->scratch + 2 * nt + 1 || a->tiles != a->out + 1 + a->k)
    return (int)cudaErrorInvalidValue;
  TRY(cudaSetDevice(a->device));
  TRY(cudaMemsetAsync(a->scratch, 0xff, sizeof(int) * (2 * nt + 2 + a->k), s));
  if (nt > 0) {
    int* host = (int*)malloc(sizeof(int) * 2 * nt);
    if (host == nullptr) return (int)cudaErrorMemoryAllocation;
    cudaError_t err = cudaErrorInvalidValue;
    if (raw_select_tiles(windows, n_windows, a->n_rows, host) == nt)
      err = cudaMemcpyAsync((void*)a->tiles, host, sizeof(int) * 2 * nt, cudaMemcpyHostToDevice,
                            s);
    free(host);
    if (err != cudaSuccess) return (int)err;
  }
  raw_select<<<nt > 0 ? nt : 1, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  return 0;
}

// one launch sequence for a cohort of at most MAX_COHORT members
int raw_topk_cohort_launch(const CohortRawArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = a->members;
  if (M < 1 || M > MAX_COHORT) return (int)cudaErrorInvalidValue;
  TRY(cudaSetDevice(a->r.device));
  const long long nt = host_tiles(a->r.n_rows);
  int grid, wgrid, fgrid;
  TRY(grid_for(a->r.device, nt, 8, &grid));
  TRY(grid_for(a->r.device, nt, 16, &wgrid));
  TRY(grid_for(a->r.device, (a->r.k + BLOCK - 1) / BLOCK, 8, &fgrid));
  // the member-on-grid kernels: each member's share, all resident together
  const int wg = wgrid / M > 0 ? wgrid / M : 1, fg = fgrid / M > 0 ? fgrid / M : 1;
  cohort_init<<<M, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  cohort_keys<<<grid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (shift != 24) {
      cohort_hist<<<grid, BLOCK, 0, s>>>(*a, shift);
      LAUNCHED();
    }
    cohort_pick<<<M, 256, 0, s>>>(*a, shift);
    LAUNCHED();
  }
  cohort_flags<<<grid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  cohort_scan<<<M, SCAN_THREADS, 0, s>>>(*a);
  LAUNCHED();
  cohort_write<<<wg * M, WORDS, 0, s>>>(*a, MODE_STRICT);
  LAUNCHED();
  cohort_write<<<wg * M, WORDS, 0, s>>>(*a, MODE_TIE);
  LAUNCHED();
  cohort_fill<<<fg * M, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  return 0;
}

const char* scan_topk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
