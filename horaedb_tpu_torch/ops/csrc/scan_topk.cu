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
// Top-k (B4; B7b top-k is it once a shard). The reference bisects 32 times
// for the threshold, each step a count over every key. Here the launch
// visits only the executor's row windows (the tile table the selection
// walks too) and never writes or reads a key of a padded or out-of-window
// row:
//   topk_keys    one pass over the window tiles, in row order by ticket:
//                decode, mask and key each row; drop the rows ranked below
//                a running bound on (key, row), which a tile with more than
//                k rows left raises to its own k-th; keep the tile's keys,
//                its largest key and the first digit's histogram of what is
//                left; the last block picks the first 8-bit digit of the
//                k-th key (sign bit flipped: unsigned order);
//   topk_refine  three passes histogram the next digit over the kept keys
//                whose higher digits match, skipping tiles whose largest
//                key lies below the prefix; the last block of each picks
//                (after the last, the threshold the bisection returns);
//   topk_write   cooperative: each tile counts its rows above the threshold
//                and at it and publishes prefixes by a decoupled look-back;
//                a grid barrier; each tile writes its strict rows, then its
//                ties, in row order at their slots (with their keys where
//                the caller asks, which the sharded top-k merges on), and
//                the slots past them get n_rows (where the reference's
//                searchsorted runs past its tie stream) or -1.
// A memset of the state and one copy of the tile table come first; no host
// round trip between launches, one copy of the k slots comes back. The
// kernel's answer is the reference's bit for bit: the rows it drops can
// hold no slot (see topk_keys), and within what it keeps the threshold,
// the strict count and the ties are exact.
//
// What bounds top-k: one decode of the window rows' columns; the refines
// and the write read only the tiles with rows left. The first redesign
// decoded every padded row (2^26 at the cpu table) into a key buffer that
// four more passes re-read, and ran 14 launches, six of one block: those
// re-reads were 63-64% of its time, and at 8,640 window rows the launches
// alone kept 0.067 ms.
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
// fields; their own allow lists, time ranges, literals and row windows) in
// one launch sequence, at most MAX_COHORT members a sequence. It is B4's
// top-k batched over the members: the key of a row does not depend on the
// member, only whether the row passes does. The launcher cuts the union of
// the members' windows into one tile table (raw_cohort_tiles: tiles of at
// most TILE rows inside one union window, in row order, each with the mask
// of the members whose windows meet it, one bit a member) and lists each
// member's tiles (its "items", member by member, in row order); one copy
// brings both to the card. Then:
//   cohort_topk_keys    tiles by ticket in row order: decode each row once,
//                       key it once, and judge it for each member of the
//                       tile's mask (allow list, time range, literals); per
//                       member with rows in the tile, drop the rows below
//                       its running (key, row) bound, raise the bound to the
//                       tile's own k-th where more than k stay (topk_keys'
//                       rule), and keep the item's ballot words, largest key
//                       and first-digit histogram; the tile's keys once;
//                       the last block picks every member's first digit;
//   cohort_topk_refine  three passes, the member on the grid's y: the next
//                       digit over the member's kept rows, only its items
//                       whose largest kept key reaches the prefix;
//   cohort_topk_write   cooperative: each item counts its strict rows and
//                       ties; a grid barrier; a block a member scans its
//                       items' counts into offsets; a grid barrier; each
//                       item writes its rows at their slots, and the slots
//                       past them get n_rows or -1.
// A memset of the members' state and histograms comes first. At most 7
// launches for up to 32 members (the memset, the copy, the keys, three
// refines, the write), and no refine where no member has k window rows.
// The scratch is sized by the tiles of the windows: one key a tile row, and
// a member's ballot words only on its own tiles. Member b's slots are those
// raw_topk gives for its session, dyn row and windows, bit for bit: the same
// keys, mask, pruning rule, digits and slot rule. What bounds it: one decode
// of the union's rows; the member loop costs a compare a member whose series
// a row belongs to. The first design ran 14 kernels over every padded row
// (2^26 at the cpu table), each a full pass, with one key a row and three
// bit words a row and member. A decoupled look-back over the items, one
// ticket each, took the write 6.5 ms on an H100 at 2^26 rows (524,288
// items, one a member and tile); the member scans take it one pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include "layouts.cuh"

#define BLOCK 256
#define TILE 4096             // rows per tile, 16 per thread
#define WORDS (TILE / 32)     // ballot words per tile
#define FULL_MASK 0xffffffffu
#define KEY_MASKED (-2147483647 - 1)

// state words at the head of the scratch buffer
enum {
  ST_TOTAL = 0,   // masked-in rows
  ST_RANK = 1,    // rank of the k-th key inside the digits still to pick
  ST_PREFIX = 2,  // the k-th key's digits picked so far (flipped bits)
  ST_ACTIVE = 3,  // total >= k: the k-th key exists
  ST_THR = 4,     // the threshold
  ST_LIMIT = 7,   // min(k, total): slots that hold a row
};

struct RawArgs {
  Column series;
  Column ts;
  Column fields[MAX_FIELDS];
  const int* session;  // allow list [S + 1]
  const int* dyn;      // [literal bits (n_f) | lo, hi, key_lo, key_hi]
  int* keys;           // top-k and cohort: [n_tiles][TILE]
  int* scratch;        // each kind's own layout (see its launcher)
  int* out;            // top-k [k]; cohort [members][k]; selection [1 + k]
  int* key_out;        // top-k: the slots' keys [k], or null
  const int* tiles;    // the tile table: [n_tiles][2] rows [row0, row1) of each
                       // tile; the cohort's [n_tiles][4] and its item lists
  long long n_tiles;   // tiles of the table
  long long n_rows;
  long long k;         // top-k slots, or the selection's slots
  int descending;
  int key_is_ts;
  int key_field;
  int device;
  Filters filt;
};

// ---- mask and key -------------------------------------------------------------

// The selection's mask of a row (the reference's _raw_mask) with the row's
// loads issued together: the series code, the timestamp and the first
// EAGER_FILTERS filter fields, then the allow list.
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

__device__ __forceinline__ uint32_t flipped(int key) { return (uint32_t)key ^ 0x80000000u; }

// ---- block helpers ------------------------------------------------------------

// exclusive prefix sum over the block (int or unsigned long long);
// ``total`` gets the block's sum
template <int NT, typename T>
__device__ __forceinline__ T block_scan(T v, T& total) {
  __shared__ T ws[NT / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    T s = lane < NT / 32 ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NT / 32) ws[lane] = s;
  }
  __syncthreads();
  const T excl = x - v + (w ? ws[w - 1] : 0);
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

// ---- top-k (B4): the window rows, pruned, then the ordered write -------------

// The scratch of one top-k launch (int32 words), its state and histograms
// zeroed by the launcher's memset:
//   [state 32 | histograms 4 x 256 | tile counts 2 x n_tiles | block counts
//    2 x n_tiles | tile maxima n_tiles | tile table 2 x n_tiles]
// and the keys, n_tiles x TILE, a buffer of their own.
enum {
  TK_DONE = 8,      // blocks done, one counter a pass (keys, then three refines)
  TK_BARRIER = 13,  // the write's grid barrier
  TK_BOUND = 14,    // the pruning bound: a 64-bit composite (key, row)
  TK_ROWS = 16,     // 64-bit: the rows topk_keys decoded (the wrapper's stats)
  TK_TILES = 18,    // 64-bit: the tiles topk_keys walked
  TK_HEAD = 32,
  TK_STATUS = TK_HEAD + 4 * 256,
};

struct TopkScratch {
  int* st;
  int* hist;                 // [4][256], one a digit
  unsigned long long* count;   // [n_tiles]: a tile's strict rows and ties
  unsigned long long* bcount;  // [blocks of the write]: a block's
  int* tmax;                 // [n_tiles]: the tile's largest kept key
  const int* tiles;          // [n_tiles][2]
  int* keys;                 // [n_tiles][TILE]
};

__device__ __forceinline__ TopkScratch topk_scratch(const RawArgs& a) {
  TopkScratch s;
  s.st = a.scratch;
  s.hist = a.scratch + TK_HEAD;
  s.count = (unsigned long long*)(a.scratch + TK_STATUS);
  s.bcount = (unsigned long long*)(a.scratch + TK_STATUS + 2 * a.n_tiles);
  s.tmax = a.scratch + TK_STATUS + 4 * a.n_tiles;
  s.tiles = a.tiles;
  s.keys = a.keys;
  return s;
}

// a row's (key, row) rank as one integer: larger is earlier in the answer
// (key descending, then row ascending)
__device__ __forceinline__ unsigned long long composite(int key, long long row) {
  return ((unsigned long long)flipped(key) << 32) | (unsigned long long)(0xffffffffu - (uint32_t)row);
}

// load_int / load_value of N rows with the layout dispatched once: each
// case is straight-line code, so the N rows' loads issue together.
template <int N>
__device__ __forceinline__ void load_ints(const Column& c, const long long (&i)[N], int (&out)[N]) {
  const uint32_t* w = (const uint32_t*)c.data;
  switch (c.kind) {
    case LAY_RAW:
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = ((const int*)c.data)[i[j]];
      break;
    case LAY_DELTA:
#pragma unroll
      for (int j = 0; j < N; ++j)
        out[j] = (int)((uint32_t)((const int*)c.aux)[i[j] >> 7] + unpack(w, c.width, i[j]));
      break;
    default:  // LAY_TSDICT
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = ((const int*)c.aux)[unpack(w, c.width, i[j])];
  }
}

template <int N>
__device__ __forceinline__ void load_values(const Column& c, const long long (&i)[N],
                                            float (&out)[N]) {
  const uint32_t* w = (const uint32_t*)c.data;
  switch (c.kind) {
    case LAY_RAW:
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = ((const float*)c.data)[i[j]];
      break;
    case LAY_BF16:
#pragma unroll
      for (int j = 0; j < N; ++j)
        out[j] = __uint_as_float(((uint32_t)((const uint16_t*)c.data)[i[j]]) << 16);
      break;
    case LAY_DICT:
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = ((const float*)c.aux)[unpack(w, c.width, i[j])];
      break;
    default:  // LAY_CODES
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = (float)unpack(w, c.width, i[j]);
  }
}

// The keys of N rows, KEY_MASKED where the mask drops a row: the series
// codes, timestamps, key field and first filter field of all N are loaded
// before the allow list answers, the other filters only for rows still in.
template <int N>
__device__ __forceinline__ void keys_of(const RawArgs& a, const long long (&i)[N], int lo, int hi,
                                        int (&key)[N]) {
  const int nf = a.filt.n;
  int code[N], ts[N];
  float kv[N], f0[N];
  load_ints<N>(a.series, i, code);
  load_ints<N>(a.ts, i, ts);
  if (!a.key_is_ts) load_values<N>(a.fields[a.key_field], i, kv);
  if (nf > 0) load_values<N>(a.fields[a.filt.field[0]], i, f0);
  bool ok[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    ok[j] = (a.session[code[j]] != 0) & (ts[j] >= lo) & (ts[j] < hi);
    if (nf > 0) ok[j] &= compare(f0[j], a.filt.op[0], __int_as_float(a.dyn[0]));
  }
  for (int f = 1; f < nf; ++f) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (ok[j])
        ok[j] = compare(load_value(a.fields[a.filt.field[f]], i[j]), a.filt.op[f],
                        __int_as_float(a.dyn[f]));
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int k;
    if (a.key_is_ts) {
      k = a.descending ? ts[j] : neg(ts[j]);
    } else {
      k = f32_sort_key(kv[j]);
      if (!a.descending) k = neg(k);
      if (isnan(kv[j])) k = KEY_MASKED + 1;  // NaN below every real value
    }
    key[j] = ok[j] ? k : KEY_MASKED;
  }
}

// rows a thread keys at once (TILE / BLOCK a tile, in batches), and the
// keys pass's blocks a SM. The pass waits on its loads, so residency sets
// its speed. On an H100 at the cpu table's top-k shapes: 4 blocks (at most
// 64 registers) took 23-24% less than the compiler's own choice; 6 and 8
// spilled and took 33-160% more; batches of 4 kept the tile's keys in
// registers (8 put them on the stack) for 7-15% less; one of 16 took 21%
// more.
#define KEY_BATCH 4
#define KEYS_BLOCKS_PER_SM 4

// One warp: the digit of the 256-bin histogram h (descending) that holds
// the ``rank``-th largest; returns it, and the rank left inside it in *left.
__device__ __forceinline__ int warp_pick(const int* h, int rank, int* left) {
  const int lane = threadIdx.x & 31;
  int c[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = h[255 - 8 * lane - j];
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned hit = __ballot_sync(FULL_MASK, incl >= rank);
  const int src = hit ? __ffs(hit) - 1 : 31;
  int d = 0, r = 0;
  if (lane == src) {
    int cum = incl - sum;
    int j = 0;
    for (; j < 7; ++j) {
      if (cum + c[j] >= rank) break;
      cum += c[j];
    }
    d = 255 - 8 * lane - j;
    r = rank - cum;
  }
  d = __shfl_sync(FULL_MASK, d, src);
  *left = __shfl_sync(FULL_MASK, r, src);
  return d;
}

// The block's k-th largest key among the rows j of ``key`` for which
// ``in(j)`` holds (the block holds more than k): four 8-bit digits over a
// shared histogram.
template <typename In>
__device__ int block_kth_if(const int (&key)[TILE / BLOCK], int k, In in) {
  __shared__ int h[256];
  __shared__ int pick_s[2];
  uint32_t prefix = 0;
  int rank = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int t = threadIdx.x; t < 256; t += BLOCK) h[t] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const uint32_t u = flipped(key[j]);
      const bool hit = in(j) && (shift == 24 || (u >> (shift + 8)) == (prefix >> (shift + 8)));
      hist_add(h, hit ? (int)((u >> shift) & 255u) : 256);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      int left;
      const int d = warp_pick(h, rank, &left);
      if (threadIdx.x == 0) {
        pick_s[0] = d;
        pick_s[1] = left;
      }
    }
    __syncthreads();
    prefix |= (uint32_t)pick_s[0] << shift;
    rank = pick_s[1];
    __syncthreads();
  }
  return (int)flipped((int)prefix);
}

// the k-th largest among the keys that are not KEY_MASKED
__device__ int block_kth(const int (&key)[TILE / BLOCK], int k) {
  return block_kth_if(key, k, [&](int j) { return key[j] != KEY_MASKED; });
}

// Called by one whole warp after the pass that filled ``hist``: picks the
// digit at ``shift`` holding the k-th largest kept key (the first pass also
// sets whether the k-th key exists); once the key is whole, or when fewer
// than k rows pass, sets the threshold the reference's bisection
// (_kth_threshold) returns for the seeds [key_lo, key_hi] and the slots
// that hold a row. With c(t) = count(key > t), the bisection keeps c(hi) < k
// and ends at min(key_hi, max(key_lo + 1, t*)), t* the least t with c(t) < k
// (the k-th largest key when total >= k, else INT32_MIN), or at key_hi when
// key_hi <= key_lo + 1 and it never runs. Each warp of a block has its own
// copy of the histogram, so the warps of one block can pick for several
// cohort members at once.
__device__ void topk_pick(int* st, const int* hist, long long k, const int* dyn, int nf, int shift) {
  __shared__ int hs[BLOCK / 32][256];
  const int lane = threadIdx.x & 31;
  int* h = hs[threadIdx.x >> 5];
  for (int t = lane; t < 256; t += 32) h[t] = __ldcg(&hist[t]);
  __syncwarp();
  const long long total = __ldcg(&st[ST_TOTAL]);
  const bool first = shift == 24;
  const bool active = first ? total >= k : __ldcg(&st[ST_ACTIVE]) != 0;
  int left = first ? (int)(k < total ? k : total) : __ldcg(&st[ST_RANK]);
  uint32_t prefix = first ? 0u : (uint32_t)__ldcg(&st[ST_PREFIX]);
  if (active) prefix |= (uint32_t)warp_pick(h, left, &left) << shift;
  if (lane != 0) return;
  st[ST_ACTIVE] = active;
  st[ST_RANK] = left;
  st[ST_PREFIX] = (int)prefix;
  if (shift == 0 || !active) {
    const long long key_lo = dyn[nf + 2], key_hi = dyn[nf + 3];
    long long thr;
    if (key_hi <= key_lo + 1) {
      thr = key_hi;
    } else {
      thr = active ? (long long)(int)flipped((int)prefix) : (long long)KEY_MASKED;
      if (thr < key_lo + 1) thr = key_lo + 1;
      if (thr > key_hi) thr = key_hi;
    }
    st[ST_THR] = (int)thr;
    st[ST_LIMIT] = (int)(k < total ? k : total);
  }
}

// the last block to finish a pass (the pass's counter); the others return false
__device__ __forceinline__ bool last_block(int* done) {
  __shared__ bool last_s;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last_s) __threadfence();
  return last_s;
}

// Pass 1. Each block takes every gridDim-th tile of the window table (in
// row order, so the bound rises early): it keys the tile's rows, drops those
// below the bound, and where more than k rows stay, raises the bound to
// its own k-th (key, last row) and drops its rows below that key. A tile
// with rows left writes its keys and its largest; the rows left feed the
// first digit's histogram. The last block picks the first digit.
//
// Why a dropped row cannot matter: the bound B is some tile's (t, its last
// row) where k rows of that tile rank at or above (t, last row), so a row
// below B has k rows ranked above it and is not among the top k by (key,
// row). Those top k rows hold every row the answer writes, whenever the
// bisection's threshold is the k-th key or the key_lo + 1 clamp; the cap
// at (key_hi, row 0) keeps every row above key_hi, which the key_hi clamp
// writes instead. So the threshold, the strict count and the ties the
// answer needs all come out of the rows left.
__global__ void __launch_bounds__(BLOCK, KEYS_BLOCKS_PER_SM) topk_keys(const __grid_constant__ RawArgs a) {
  __shared__ int hist[256];
  const TopkScratch s = topk_scratch(a);
  const int nf = a.filt.n;
  const int lo = a.dyn[nf], hi = a.dyn[nf + 1];
  const unsigned long long cap = composite(a.dyn[nf + 3], 0);
  unsigned long long* bound = (unsigned long long*)(s.st + TK_BOUND);
  for (int t = threadIdx.x; t < 256; t += BLOCK) hist[t] = 0;
  int passing = 0, decoded = 0, walked = 0;
  for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const long long r0 = s.tiles[2 * tile], r1 = s.tiles[2 * tile + 1];
    ++walked;
    int key[TILE / BLOCK];
#pragma unroll
    for (int h = 0; h < TILE / BLOCK; h += KEY_BATCH) {
      long long i[KEY_BATCH];
      int k[KEY_BATCH];
#pragma unroll
      for (int j = 0; j < KEY_BATCH; ++j) {
        const long long r = r0 + (h + j) * BLOCK + threadIdx.x;
        i[j] = r < r1 ? r : r0;  // a row past the tile reads row r0 and is dropped
        decoded += r < r1;
      }
      keys_of<KEY_BATCH>(a, i, lo, hi, k);
#pragma unroll
      for (int j = 0; j < KEY_BATCH; ++j) {
        key[h + j] = r0 + (h + j) * BLOCK + threadIdx.x < r1 ? k[j] : KEY_MASKED;
        passing += key[h + j] != KEY_MASKED;
      }
    }
    unsigned long long b = *(volatile unsigned long long*)bound;
    if (b > cap) b = cap;
    int kept = 0;
#pragma unroll
    for (int j = 0; j < TILE / BLOCK; ++j) {
      if (key[j] != KEY_MASKED && composite(key[j], r0 + j * BLOCK + threadIdx.x) < b)
        key[j] = KEY_MASKED;
      kept += key[j] != KEY_MASKED;
    }
    int total;
    block_scan<BLOCK>(kept, total);
    if (total > a.k) {
      const int t = block_kth(key, (int)a.k);
      if (threadIdx.x == 0) atomicMax(bound, composite(t, r1 - 1));
      // below the tile's own k-th key, and not above key_hi (the cap)
      const long long below = min((long long)t, (long long)a.dyn[nf + 3] + 1);
#pragma unroll
      for (int j = 0; j < TILE / BLOCK; ++j)
        if (key[j] != KEY_MASKED && key[j] < below) key[j] = KEY_MASKED;
    }
    int top = KEY_MASKED;
#pragma unroll
    for (int j = 0; j < TILE / BLOCK; ++j) top = max(top, key[j]);
    for (int o = 16; o > 0; o >>= 1) top = max(top, __shfl_xor_sync(FULL_MASK, top, o));
    __shared__ int wtop[BLOCK / 32];
    if ((threadIdx.x & 31) == 0) wtop[threadIdx.x >> 5] = top;
    __syncthreads();
    top = KEY_MASKED;
    for (int w = 0; w < BLOCK / 32; ++w) top = max(top, wtop[w]);
    if (threadIdx.x == 0) s.tmax[tile] = top;
    if (top != KEY_MASKED) {
      int* dst = s.keys + tile * TILE;
#pragma unroll
      for (int j = 0; j < TILE / BLOCK; ++j) {
        dst[j * BLOCK + threadIdx.x] = key[j];
        hist_add(hist, key[j] != KEY_MASKED ? (int)(flipped(key[j]) >> 24) : 256);
      }
    }
  }
  hist_flush(hist, s.hist);
  int total;
  block_scan<BLOCK>(passing, total);
  if (threadIdx.x == 0 && total) atomicAdd(&s.st[ST_TOTAL], total);
  block_scan<BLOCK>(decoded, total);
  if (threadIdx.x == 0) {
    atomicAdd((unsigned long long*)(s.st + TK_ROWS), (unsigned long long)total);
    atomicAdd((unsigned long long*)(s.st + TK_TILES), (unsigned long long)walked);
  }
  if (last_block(&s.st[TK_DONE]) && threadIdx.x < 32) topk_pick(s.st, s.hist, a.k, a.dyn, nf, 24);
}

// Passes 2-4: the next digit's histogram over the kept keys whose higher
// digits match the prefix so far; tiles whose largest kept key lies below
// the prefix are skipped unread. The last block picks the digit (after the
// last one, the threshold).
__global__ void __launch_bounds__(BLOCK) topk_refine(const __grid_constant__ RawArgs a, int shift) {
  __shared__ int hist[256];
  const TopkScratch s = topk_scratch(a);
  if (!s.st[ST_ACTIVE]) return;  // fewer than k rows: the threshold is set
  const uint32_t want = (uint32_t)s.st[ST_PREFIX] >> (shift + 8);
  for (int t = threadIdx.x; t < 256; t += BLOCK) hist[t] = 0;
  __syncthreads();
  for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int top = s.tmax[tile];
    if (top == KEY_MASKED || (flipped(top) >> (shift + 8)) < want) continue;
    const int* src = s.keys + tile * TILE;
#pragma unroll
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const int key = src[j * BLOCK + threadIdx.x];
      const uint32_t u = flipped(key);
      const bool in = key != KEY_MASKED && (u >> (shift + 8)) == want;
      hist_add(hist, in ? (int)((u >> shift) & 255u) : 256);
    }
  }
  const int level = (24 - shift) / 8;
  hist_flush(hist, s.hist + 256 * level);
  if (last_block(&s.st[TK_DONE + level]) && threadIdx.x < 32)
    topk_pick(s.st, s.hist + 256 * level, a.k, a.dyn, a.filt.n, shift);
}

// every block of the launch arrives before any leaves (the launch is
// cooperative, so all are resident)
__device__ __forceinline__ void grid_barrier(int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1);
    while (*(volatile int*)count < (int)gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// a tile's (or a block's) strict rows (bits 31-61) and ties (bits 0-30)
__device__ __forceinline__ unsigned long long pack_counts(long long strict, long long tie) {
  return ((unsigned long long)strict << 31) | (unsigned long long)tie;
}

__device__ __forceinline__ long long strict_of(unsigned long long c) { return (long long)(c >> 31); }
__device__ __forceinline__ long long tie_of(unsigned long long c) {
  return (long long)(c & 0x7fffffffull);
}

// Thread w < WORDS of the block: the ballot word w of the tile's rows
// strictly above the threshold (q 0) or at it (q 1), in row order.
__device__ __forceinline__ void tile_flags(const TopkScratch& s, long long tile, int thr,
                                           unsigned* words0, unsigned* words1) {
  const int* src = s.keys + tile * TILE;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < TILE / BLOCK; ++j) {
    const int key = src[j * BLOCK + threadIdx.x];
    const unsigned b0 = __ballot_sync(FULL_MASK, key > thr);
    const unsigned b1 = __ballot_sync(FULL_MASK, key != KEY_MASKED && key == thr);
    if (lane == 0) {
      words0[j * (BLOCK / 32) + w] = b0;
      words1[j * (BLOCK / 32) + w] = b1;
    }
  }
}

// The sum over the block of each thread's v (every thread gets it).
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v) {
  __shared__ unsigned long long part[BLOCK / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
#pragma unroll
  for (int w = 0; w < BLOCK / 32; ++w) v += part[w];
  return v;
}

// Pass 5 (cooperative). Each block owns a contiguous run of tiles. Stage 1:
// it counts each tile's rows above the threshold and at it (a tile whose
// largest kept key is below the threshold counts 0 unread) and the run's
// sum. A grid barrier. Stage 2: the runs before it give the block its first
// slots; it walks its tiles in order and writes each one's strict rows in
// row order from slot (strict rows before it), below k, and its ties from
// slot (every strict row + ties before it), below min(k, total), with their
// keys where asked. The slots no tile writes get n_rows below min(k,
// total) (where the reference's searchsorted runs past its tie stream) and
// -1 after.
__global__ void __launch_bounds__(BLOCK) topk_write(const __grid_constant__ RawArgs a) {
  __shared__ unsigned words0[WORDS], words1[WORDS];
  const TopkScratch s = topk_scratch(a);
  const int thr = s.st[ST_THR];
  const long long limit = s.st[ST_LIMIT];
  const long long per = (a.n_tiles + gridDim.x - 1) / gridDim.x;
  const long long t0 = min((long long)blockIdx.x * per, a.n_tiles);
  const long long t1 = min(t0 + per, a.n_tiles);
  unsigned long long run = 0;
  for (long long tile = t0; tile < t1; ++tile) {
    const int top = s.tmax[tile];
    unsigned long long c = 0;
    if (top != KEY_MASKED && top >= thr) {
      tile_flags(s, tile, thr, words0, words1);
      __syncthreads();
      const unsigned b0 = threadIdx.x < WORDS ? words0[threadIdx.x] : 0u;
      const unsigned b1 = threadIdx.x < WORDS ? words1[threadIdx.x] : 0u;
      c = block_sum(pack_counts(__popc(b0), __popc(b1)));
    }
    if (threadIdx.x == 0) s.count[tile] = c;
    run += c;
  }
  if (threadIdx.x == 0) s.bcount[blockIdx.x] = run;
  grid_barrier(&s.st[TK_BARRIER]);
  // the runs before this block's, and all of them
  unsigned long long before = 0, all = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += BLOCK) {
    const unsigned long long c = *(volatile unsigned long long*)&s.bcount[b];
    all += c;
    if (b < blockIdx.x) before += c;
  }
  before = block_sum(before);
  all = block_sum(all);
  const long long n_strict = strict_of(all), n_tie = tie_of(all);
  long long e0 = strict_of(before), e1 = tie_of(before);
  const int* src = s.keys;
  for (long long tile = t0; tile < t1; ++tile) {
    const unsigned long long c = s.count[tile];
    const bool any0 = strict_of(c) != 0 && e0 < a.k;
    const bool any1 = tie_of(c) != 0 && n_strict + e1 < limit;
    if (any0 || any1) {  // block-uniform
      tile_flags(s, tile, thr, words0, words1);
      __syncthreads();
      const long long r0 = s.tiles[2 * tile];
      for (int q = 0; q < 2; ++q) {
        if (q == 0 ? !any0 : !any1) continue;
        const unsigned bits = threadIdx.x < WORDS ? (q == 0 ? words0 : words1)[threadIdx.x] : 0u;
        int total;
        long long pos = (q == 0 ? e0 : n_strict + e1) + block_scan<BLOCK>(__popc(bits), total);
        const long long end = q == 0 ? a.k : limit;
        for (unsigned b = bits; b && pos < end; b &= b - 1, ++pos) {
          const int off = (int)threadIdx.x * 32 + __ffs(b) - 1;
          a.out[pos] = (int)(r0 + off);
          if (a.key_out) a.key_out[pos] = src[tile * TILE + off];
        }
      }
      __syncthreads();
    }
    e0 += strict_of(c);
    e1 += tie_of(c);
  }
  // slots past the rows written
  const long long written = n_strict >= a.k ? a.k
      : n_strict + (n_tie < limit - n_strict ? n_tie : limit - n_strict);
  for (long long j = written + (long long)blockIdx.x * BLOCK + threadIdx.x; j < a.k;
       j += (long long)gridDim.x * BLOCK) {
    a.out[j] = j < limit ? (int)a.n_rows : -1;
    if (a.key_out) a.key_out[j] = KEY_MASKED;
  }
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

// ---- cohort top-k (B4c): B4's top-k over the union of the members' windows --

#define MAX_COHORT 32
// the keys pass's blocks a SM: its member loop keeps each row's member bits
// beside its key, so it takes more registers than topk_keys
#define COHORT_KEYS_BLOCKS_PER_SM 2

// r: the columns, the statics, the keys (r.keys, [n_tiles][TILE]), the
// scratch (r.scratch), the slots (r.out, [members][k]) and the table
// (r.tiles, r.n_tiles); r.session and r.dyn unused. Member m reads
// sessions + m * sess_w and dyns + m * dyn_w.
struct CohortRawArgs {
  RawArgs r;
  const int* sessions;
  const int* dyns;
  long long n_items;  // items: the members' tiles, summed over the members
  int members;
  int sess_w;
  int dyn_w;
  int pad_;
};

// The scratch of one launch sequence (int32 words):
//   [head CH_HEAD | a member's state and histograms TK_STATUS, each member]
//   (zeroed by the launcher's memset)
//   [item offsets 2 x items | item counts 2 x items | item maxima items |
//    item ballot words items x WORDS | the table, 16-byte aligned: tiles
//    4 x n_tiles, tile_p items, member_off members + 1, member_tiles items]
// An item is one member's tile. Items are numbered member by member, each
// member's in row order: member m's are [member_off[m], member_off[m + 1]),
// member_tiles[p] the tile of item p. A tile {row0, row1, mask, item_off}
// lists its members' items, in bit order, at tile_p[item_off ...].
enum {
  CH_KEYS_TICKET = 0,
  CH_KEYS_DONE = 1,
  CH_BARRIER = 2,  // the write's two grid barriers, a word each
  CH_HEAD = 16,
  CM_ALL = 16,     // a member's state word: its strict rows and ties (64-bit pack_counts)
};

__host__ __device__ __forceinline__ long long cohort_items_at(int members) {
  return CH_HEAD + (long long)members * TK_STATUS;
}

__host__ __device__ __forceinline__ long long cohort_table_at(int members, long long items) {
  return (cohort_items_at(members) + (5 + WORDS) * items + 3) & ~3LL;  // after the items' words
}

struct CohortScratch {
  int* head;
  int* member;                 // [members][TK_STATUS]: B4's state and histograms
  unsigned long long* excl;    // [items]: its member's strict rows and ties before it
  unsigned long long* count;   // [items]: the item's strict rows and ties
  int* tmax;                   // [items]: the item's largest kept key
  unsigned* bits;              // [items][WORDS]: the item's kept rows
  const int4* tiles;           // [n_tiles]
  const int* tile_p;           // [items]
  const int* member_off;       // [members + 1]
  const int* member_tiles;     // [items]
};

__device__ __forceinline__ CohortScratch cohort_scratch(const CohortRawArgs& a) {
  CohortScratch s;
  const long long items = a.n_items;
  s.head = a.r.scratch;
  s.member = a.r.scratch + CH_HEAD;
  s.excl = (unsigned long long*)(a.r.scratch + cohort_items_at(a.members));
  s.count = s.excl + items;
  s.tmax = (int*)(s.count + items);
  s.bits = (unsigned*)(s.tmax + items);
  s.tiles = (const int4*)a.r.tiles;
  s.tile_p = a.r.tiles + 4 * a.r.n_tiles;
  s.member_off = s.tile_p + items;
  s.member_tiles = s.member_off + a.members + 1;
  return s;
}

// The largest v over the block (every thread gets it).
__device__ __forceinline__ int block_max(int v) {
  __shared__ int part[BLOCK / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL_MASK, v, o));
  __syncthreads();  // part may still be read by the last call
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int w = 1; w < BLOCK / 32; ++w) v = max(v, part[w]);
  return v;
}

// N rows of a tile: each one's key (the members' key wherever a member
// passes it; KEY_MASKED where none does) and its members (bit m: member m
// of the tile's ``tmask`` passes it). A row's candidates are the members
// whose allow list holds its series; a thread's rows mostly share one
// series, so it keeps its last series' allow bits (``code_s``, ``allow_s``).
template <int N>
__device__ __forceinline__ void cohort_rows(const CohortRawArgs& a, const long long (&i)[N],
                                            const bool (&real)[N], unsigned tmask, int& code_s,
                                            unsigned& allow_s, int (&key)[N], unsigned (&pass)[N]) {
  const RawArgs& r = a.r;
  const int nf = r.filt.n;
  int code[N], ts[N];
  float kv[N];
  load_ints<N>(r.series, i, code);
  load_ints<N>(r.ts, i, ts);
  if (!r.key_is_ts) load_values<N>(r.fields[r.key_field], i, kv);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int k;
    if (r.key_is_ts) {
      k = r.descending ? ts[j] : neg(ts[j]);
    } else {
      k = f32_sort_key(kv[j]);
      if (!r.descending) k = neg(k);
      if (isnan(kv[j])) k = KEY_MASKED + 1;  // NaN below every real value
    }
    if (code[j] != code_s) {
      code_s = code[j];
      allow_s = 0;
      for (unsigned b = tmask; b; b &= b - 1) {
        const int m = __ffs(b) - 1;
        if (a.sessions[(long long)m * a.sess_w + code_s] != 0) allow_s |= 1u << m;
      }
    }
    unsigned p = 0;
    for (unsigned b = real[j] ? allow_s : 0u; b; b &= b - 1) {
      const int m = __ffs(b) - 1;
      const int* dyn = a.dyns + (long long)m * a.dyn_w;
      bool ok = ts[j] >= dyn[nf] && ts[j] < dyn[nf + 1];
      for (int f = 0; ok && f < nf; ++f)
        ok = compare(load_value(r.fields[r.filt.field[f]], i[j]), r.filt.op[f],
                     __int_as_float(dyn[f]));
      if (ok) p |= 1u << m;
    }
    key[j] = p ? k : KEY_MASKED;
    pass[j] = p;
  }
}

// Pass 1. Blocks take the table's tiles by ticket, in row order. Each tile's
// rows are decoded and keyed once and judged for every member of its mask.
// Then, member by member where any row passes, topk_keys' rule: drop the
// rows below the member's bound (capped at (key_hi, row 0)); where more than
// k stay, raise the bound to the tile's own k-th (key, last row) and drop
// the rows below that key; the item keeps its largest key, its rows' ballot
// words and their first digits in the member's histogram. A tile where some
// member keeps a row writes its keys once. The last block picks every
// member's first digit (or its threshold, with fewer than k rows).
__global__ void __launch_bounds__(BLOCK, COHORT_KEYS_BLOCKS_PER_SM)
    cohort_topk_keys(const __grid_constant__ CohortRawArgs a) {
  __shared__ int hist[MAX_COHORT][256];
  __shared__ int passing[MAX_COHORT];
  __shared__ long long tile_s;
  __shared__ unsigned any_s;
  const RawArgs& r = a.r;
  const CohortScratch s = cohort_scratch(a);
  const int M = a.members, nf = r.filt.n;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < M * 256; t += BLOCK) hist[t >> 8][t & 255] = 0;
  for (int m = threadIdx.x; m < M; m += BLOCK) passing[m] = 0;
  for (;;) {
    __syncthreads();  // the last tile's shared words are read
    if (threadIdx.x == 0) {
      tile_s = atomicAdd(&s.head[CH_KEYS_TICKET], 1);
      any_s = 0;
    }
    __syncthreads();
    const long long tile = tile_s;
    if (tile >= r.n_tiles) break;
    const int4 tt = s.tiles[tile];
    const long long r0 = tt.x, r1 = tt.y;
    const unsigned tmask = (unsigned)tt.z;
    int key[TILE / BLOCK];
    unsigned pass[TILE / BLOCK];
    int code_s = -1;
    unsigned allow_s = 0;
#pragma unroll
    for (int h = 0; h < TILE / BLOCK; h += KEY_BATCH) {
      long long i[KEY_BATCH];
      bool real[KEY_BATCH];
      int k[KEY_BATCH];
      unsigned p[KEY_BATCH];
#pragma unroll
      for (int j = 0; j < KEY_BATCH; ++j) {
        const long long row = r0 + (h + j) * BLOCK + threadIdx.x;
        real[j] = row < r1;
        i[j] = real[j] ? row : r0;  // a row past the tile reads row r0 and passes nothing
      }
      cohort_rows<KEY_BATCH>(a, i, real, tmask, code_s, allow_s, k, p);
#pragma unroll
      for (int j = 0; j < KEY_BATCH; ++j) {
        key[h + j] = k[j];
        pass[h + j] = p[j];
      }
    }
    unsigned any = 0;
#pragma unroll
    for (int j = 0; j < TILE / BLOCK; ++j) any |= pass[j];
    any = __reduce_or_sync(FULL_MASK, any);
    if (lane == 0 && any) atomicOr(&any_s, any);
    __syncthreads();
    const unsigned any_b = any_s;
    bool wrote = false;  // block-uniform
    for (unsigned rest = tmask; rest; rest &= rest - 1) {
      const int m = __ffs(rest) - 1;
      const long long p = s.tile_p[tt.w + __popc(tmask & ((1u << m) - 1))];
      if (!((any_b >> m) & 1u)) {
        if (threadIdx.x == 0) s.tmax[p] = KEY_MASKED;
        continue;
      }
      int* st = s.member + (long long)m * TK_STATUS;
      const int key_hi = a.dyns[(long long)m * a.dyn_w + nf + 3];
      unsigned long long* bound = (unsigned long long*)(st + TK_BOUND);
      unsigned long long b = *(volatile unsigned long long*)bound;
      const unsigned long long cap = composite(key_hi, 0);
      if (b > cap) b = cap;
      unsigned keep = 0;
      int in = 0;
#pragma unroll
      for (int j = 0; j < TILE / BLOCK; ++j) {
        if ((pass[j] >> m) & 1u) {
          ++in;
          if (composite(key[j], r0 + j * BLOCK + threadIdx.x) >= b) keep |= 1u << j;
        }
      }
      int total;  // passing rows << 16 | kept rows (a tile holds at most 4096)
      block_scan<BLOCK>((in << 16) | __popc(keep), total);
      if (threadIdx.x == 0) passing[m] += total >> 16;
      if ((total & 0xffff) > r.k) {
        const int t = block_kth_if(key, (int)r.k, [&](int j) { return ((keep >> j) & 1u) != 0; });
        if (threadIdx.x == 0) atomicMax(bound, composite(t, r1 - 1));
        // below the tile's own k-th key, and not above key_hi (the cap)
        const long long below = min((long long)t, (long long)key_hi + 1);
#pragma unroll
        for (int j = 0; j < TILE / BLOCK; ++j)
          if (key[j] < below) keep &= ~(1u << j);
      }
      int top = KEY_MASKED;
#pragma unroll
      for (int j = 0; j < TILE / BLOCK; ++j)
        if ((keep >> j) & 1u) top = max(top, key[j]);
      top = block_max(top);
      if (threadIdx.x == 0) s.tmax[p] = top;
      if (top != KEY_MASKED) {
        wrote = true;
        unsigned* words = s.bits + p * WORDS;
#pragma unroll
        for (int j = 0; j < TILE / BLOCK; ++j) {
          const bool kept = (keep >> j) & 1u;
          const unsigned wb = __ballot_sync(FULL_MASK, kept);
          if (lane == 0) words[j * (BLOCK / 32) + w] = wb;
          hist_add(hist[m], kept ? (int)(flipped(key[j]) >> 24) : 256);
        }
      }
    }
    if (wrote) {
      int* dst = r.keys + tile * TILE;
#pragma unroll
      for (int j = 0; j < TILE / BLOCK; ++j) dst[j * BLOCK + threadIdx.x] = key[j];
    }
  }
  for (int t = threadIdx.x; t < M * 256; t += BLOCK) {
    const int m = t >> 8, d = t & 255;
    if (hist[m][d]) atomicAdd(&s.member[(long long)m * TK_STATUS + TK_HEAD + d], hist[m][d]);
  }
  for (int m = threadIdx.x; m < M; m += BLOCK)
    if (passing[m]) atomicAdd(&s.member[(long long)m * TK_STATUS + ST_TOTAL], passing[m]);
  if (last_block(&s.head[CH_KEYS_DONE])) {  // a warp a member
    for (int m = threadIdx.x >> 5; m < M; m += BLOCK / 32) {
      int* st = s.member + (long long)m * TK_STATUS;
      topk_pick(st, st + TK_HEAD, r.k, a.dyns + (long long)m * a.dyn_w, nf, 24);
    }
  }
}

// Passes 2-4, member blockIdx.y: the next digit's histogram over the
// member's kept rows whose higher digits match its prefix, on its items
// only; an item whose largest kept key lies below the prefix is skipped
// unread. The member's last block picks the digit (after the last, the
// threshold).
__global__ void __launch_bounds__(BLOCK) cohort_topk_refine(const __grid_constant__ CohortRawArgs a,
                                                          int shift) {
  __shared__ int hist[256];
  const CohortScratch s = cohort_scratch(a);
  const int m = blockIdx.y;
  int* st = s.member + (long long)m * TK_STATUS;
  if (!st[ST_ACTIVE]) return;  // fewer than k rows: the threshold is set
  const uint32_t want = (uint32_t)st[ST_PREFIX] >> (shift + 8);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < 256; t += BLOCK) hist[t] = 0;
  __syncthreads();
  for (long long p = s.member_off[m] + blockIdx.x; p < s.member_off[m + 1]; p += gridDim.x) {
    const int top = s.tmax[p];
    if (top == KEY_MASKED || (flipped(top) >> (shift + 8)) < want) continue;
    const int* src = a.r.keys + (long long)s.member_tiles[p] * TILE;
    const unsigned* words = s.bits + p * WORDS;
#pragma unroll
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const uint32_t u = flipped(src[j * BLOCK + threadIdx.x]);
      const bool in = ((words[j * (BLOCK / 32) + w] >> lane) & 1u) && (u >> (shift + 8)) == want;
      hist_add(hist, in ? (int)((u >> shift) & 255u) : 256);
    }
  }
  const int level = (24 - shift) / 8;
  hist_flush(hist, st + TK_HEAD + 256 * level);
  if (last_block(&st[TK_DONE + level]) && threadIdx.x < 32)
    topk_pick(st, st + TK_HEAD + 256 * level, a.r.k, a.dyns + (long long)m * a.dyn_w,
              a.r.filt.n, shift);
}

// Thread w < WORDS of the block: the ballot word w of the item's kept rows
// strictly above the threshold (words0) and at it (words1), in row order.
__device__ __forceinline__ void cohort_flags(const int* src, const unsigned* bits, int thr,
                                             unsigned* words0, unsigned* words1) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < TILE / BLOCK; ++j) {
    const int key = src[j * BLOCK + threadIdx.x];
    const bool in = (bits[j * (BLOCK / 32) + w] >> lane) & 1u;
    const unsigned b0 = __ballot_sync(FULL_MASK, in && key > thr);
    const unsigned b1 = __ballot_sync(FULL_MASK, in && key == thr);
    if (lane == 0) {
      words0[j * (BLOCK / 32) + w] = b0;
      words1[j * (BLOCK / 32) + w] = b1;
    }
  }
}

// Pass 5 (cooperative), in three stages with a grid barrier between them.
// 1: each item counts its kept rows above its member's threshold and at it
// (none, unread, where its largest key lies below). 2: a block a member
// turns its items' counts into offsets, in row order, and keeps the
// member's totals. 3: each item writes its strict rows from slot (strict
// rows before it), below k, and its ties from slot (all the member's strict
// rows + ties before it), below min(k, total), in row order; then every
// member's slots past its rows get n_rows below min(k, total) and -1 after
// (topk_write's rule). Each stage walks the members in turn, item p on
// block p mod gridDim.x; the members' item offsets, thresholds, limits and
// totals sit in shared memory, so a member that holds none of a block's
// items costs it no load from device memory.
// The first of a member's items [begin, ...) that falls to this block when
// every item p goes to block p mod gridDim.x: the blocks share each member's
// items evenly, however few it has.
__device__ __forceinline__ long long first_item(long long begin) {
  const long long g = gridDim.x;
  return begin + ((blockIdx.x - begin) % g + g) % g;
}

__global__ void __launch_bounds__(BLOCK) cohort_topk_write(const __grid_constant__ CohortRawArgs a) {
  __shared__ unsigned words0[WORDS], words1[WORDS];
  __shared__ int off[MAX_COHORT + 1], thr[MAX_COHORT];
  __shared__ long long limit[MAX_COHORT];
  __shared__ unsigned long long all[MAX_COHORT];
  const CohortScratch s = cohort_scratch(a);
  const RawArgs& r = a.r;
  const int M = a.members;
  for (int m = threadIdx.x; m <= M; m += BLOCK) off[m] = s.member_off[m];
  for (int m = threadIdx.x; m < M; m += BLOCK) {
    thr[m] = s.member[(long long)m * TK_STATUS + ST_THR];
    limit[m] = s.member[(long long)m * TK_STATUS + ST_LIMIT];
  }
  __syncthreads();
  for (int m = 0; m < M; ++m) {
    for (long long p = first_item(off[m]); p < off[m + 1]; p += gridDim.x) {
      const int top = s.tmax[p];
      unsigned long long c = 0;
      if (top != KEY_MASKED && top >= thr[m]) {  // block-uniform
        cohort_flags(r.keys + (long long)s.member_tiles[p] * TILE, s.bits + p * WORDS, thr[m],
                     words0, words1);
        __syncthreads();
        const unsigned b0 = threadIdx.x < WORDS ? words0[threadIdx.x] : 0u;
        const unsigned b1 = threadIdx.x < WORDS ? words1[threadIdx.x] : 0u;
        c = block_sum(pack_counts(__popc(b0), __popc(b1)));
      }
      if (threadIdx.x == 0) s.count[p] = c;
    }
  }
  grid_barrier(&s.head[CH_BARRIER]);
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    unsigned long long carry = 0;
    for (long long base = off[m]; base < off[m + 1]; base += BLOCK) {
      const long long p = base + threadIdx.x;
      const unsigned long long c = p < off[m + 1] ? __ldcg(&s.count[p]) : 0ull;
      unsigned long long total;
      const unsigned long long excl = block_scan<BLOCK>(c, total);
      if (p < off[m + 1]) s.excl[p] = carry + excl;
      carry += total;
    }
    if (threadIdx.x == 0)
      *(unsigned long long*)(s.member + (long long)m * TK_STATUS + CM_ALL) = carry;
  }
  grid_barrier(&s.head[CH_BARRIER + 1]);
  for (int m = threadIdx.x; m < M; m += BLOCK)
    all[m] = __ldcg((const unsigned long long*)(s.member + (long long)m * TK_STATUS + CM_ALL));
  __syncthreads();
  for (int m = 0; m < M; ++m) {
    const long long n_strict = strict_of(all[m]);
    int* out = r.out + (long long)m * r.k;
    for (long long p = first_item(off[m]); p < off[m + 1]; p += gridDim.x) {
      const unsigned long long c = __ldcg(&s.count[p]), excl = __ldcg(&s.excl[p]);
      const long long e0 = strict_of(excl), e1 = tie_of(excl);
      const bool any0 = strict_of(c) != 0 && e0 < r.k;
      const bool any1 = tie_of(c) != 0 && n_strict + e1 < limit[m];
      if (!(any0 || any1)) continue;  // block-uniform
      const long long tile = s.member_tiles[p];
      cohort_flags(r.keys + tile * TILE, s.bits + p * WORDS, thr[m], words0, words1);
      __syncthreads();
      const long long r0 = s.tiles[tile].x;
      for (int q = 0; q < 2; ++q) {
        if (q == 0 ? !any0 : !any1) continue;
        const unsigned bits = threadIdx.x < WORDS ? (q == 0 ? words0 : words1)[threadIdx.x] : 0u;
        int total;
        long long pos = (q == 0 ? e0 : n_strict + e1) + block_scan<BLOCK>((int)__popc(bits), total);
        const long long end = q == 0 ? r.k : limit[m];
        for (unsigned b = bits; b && pos < end; b &= b - 1, ++pos)
          out[pos] = (int)(r0 + (int)threadIdx.x * 32 + __ffs(b) - 1);
      }
      __syncthreads();
    }
  }
  for (long long j = (long long)blockIdx.x * BLOCK + threadIdx.x; j < M * r.k;
       j += (long long)gridDim.x * BLOCK) {
    const int m = (int)(j / r.k);
    const long long slot = j - m * r.k;
    const long long n_strict = strict_of(all[m]), n_tie = tie_of(all[m]);
    const long long written = n_strict >= r.k ? r.k
        : n_strict + (n_tie < limit[m] - n_strict ? n_tie : limit[m] - n_strict);
    if (slot >= written) r.out[j] = slot < limit[m] ? (int)r.n_rows : -1;
  }
}

// ---- host launch (plain C interface, loaded with ctypes) --------------------

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
  sizes[4] = CH_HEAD;
  sizes[5] = sizeof(CohortRawArgs);
  sizes[6] = MAX_COHORT;
  sizes[7] = TK_STATUS;
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

// The tile table of ``windows`` (``nt`` tiles) built on the host and
// copied to ``dst`` on the card (from pageable memory: staged before the
// call returns).
static int copy_tiles(const long long* windows, long long n_windows, long long n_rows,
                      long long nt, const int* dst, cudaStream_t s) {
  if (nt <= 0) return 0;
  int* host = (int*)malloc(sizeof(int) * 2 * nt);
  if (host == nullptr) return (int)cudaErrorMemoryAllocation;
  cudaError_t err = cudaErrorInvalidValue;
  if (raw_select_tiles(windows, n_windows, n_rows, host) == nt)
    err = cudaMemcpyAsync((void*)dst, host, sizeof(int) * 2 * nt, cudaMemcpyHostToDevice, s);
  free(host);
  return (int)err;
}

// The top-k over the tile table of ``windows``. The wrapper's scratch
// (a->scratch): [state and histograms TK_STATUS | tile counts 2 x n_tiles
// | block counts 2 x n_tiles | tile maxima n_tiles | table 2 x n_tiles]
// (a->tiles at the table), keys n_tiles x TILE (a->keys). One memset
// zeroes the state and the histograms; the table is copied; then topk_keys, three
// topk_refine (none when fewer than k rows lie in the windows: no k-th key
// to find), and topk_write, cooperative. *kernels gets the kernels
// launched.
int raw_topk_launch(const RawArgs* a, const long long* windows, long long n_windows,
                    int* kernels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nt = a->n_tiles;
  if (nt < 0 || a->k < 1 || a->tiles != a->scratch + TK_STATUS + 5 * nt)
    return (int)cudaErrorInvalidValue;
  long long rows = 0;
  for (long long w = 0; w < n_windows; ++w) rows += windows[2 * w + 1] - windows[2 * w];
  TRY(cudaSetDevice(a->device));
  TRY(cudaMemsetAsync(a->scratch, 0, sizeof(int) * TK_STATUS, s));
  const int err = copy_tiles(windows, n_windows, a->n_rows, nt, a->tiles, s);
  if (err) return err;
  int grid, per_sm = 0, sms = 0;
  TRY(grid_for(a->device, nt, 8, &grid));
  topk_keys<<<grid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  *kernels = 1;
  if (rows >= a->k) {
    for (int shift = 16; shift >= 0; shift -= 8) {
      topk_refine<<<grid, BLOCK, 0, s>>>(*a, shift);
      LAUNCHED();
      ++*kernels;
    }
  }
  TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a->device));
  TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_write, BLOCK, 0));
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const unsigned wgrid = (unsigned)(nt < 1 ? 1 : (nt < resident ? nt : resident));
  RawArgs args = *a;
  void* params[] = {&args};
  TRY(cudaLaunchCooperativeKernel((const void*)topk_write, dim3(wgrid), dim3(BLOCK), params, 0,
                                  s));
  ++*kernels;
  return 0;
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
  const int err = copy_tiles(windows, n_windows, a->n_rows, nt, a->tiles, s);
  if (err) return err;
  raw_select<<<nt > 0 ? nt : 1, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  return 0;
}

struct Span {
  long long start, end;
};

static int by_start(const void* x, const void* y) {
  const long long a = ((const Span*)x)->start, b = ((const Span*)y)->start;
  return a < b ? -1 : a > b;
}

// The cohort's tile table (its spec: ops/scan_topk.py cohort_tiles). Member
// m's windows are the int64 [start, end) pairs windows[2 * w ...] for w in
// [win_off[m], win_off[m + 1]), in host memory: sorted, disjoint, inside [0,
// n_rows). The union of every member's windows (merged where they overlap
// or touch) is cut into tiles of at most TILE rows, each inside one union
// window, in row order; a tile's mask has bit m where a window of member m
// meets it. Unless ``tiles`` is null, writes the tiles (row0, row1, mask,
// item_off: 4 ints a tile), tile_p (a tile's items, one a member of its
// mask in bit order, as each item's index), member_off (members + 1) and
// member_tiles (each item's tile; member by member, in row order). Returns
// the tile count and sets *n_items; -1 for windows it refuses, -2 where
// host memory runs out.
long long raw_cohort_tiles(const long long* windows, const long long* win_off, int members,
                           long long n_rows, int* tiles, int* tile_p, int* member_off,
                           int* member_tiles, long long* n_items) {
  if (members < 1 || members > MAX_COHORT || win_off[0] != 0) return -1;
  const long long n_windows = win_off[members];
  for (int m = 0; m < members; ++m) {
    long long prev = 0;
    for (long long w = win_off[m]; w < win_off[m + 1]; ++w) {
      const long long start = windows[2 * w], end = windows[2 * w + 1];
      if (start < prev || end < start || end > n_rows) return -1;
      prev = end;
    }
  }
  Span* u = (Span*)malloc(sizeof(Span) * (n_windows > 0 ? n_windows : 1));
  if (u == nullptr) return -2;
  long long n_u = 0;
  for (long long w = 0; w < n_windows; ++w)
    if (windows[2 * w + 1] > windows[2 * w]) u[n_u++] = {windows[2 * w], windows[2 * w + 1]};
  qsort(u, n_u, sizeof(Span), by_start);
  long long merged = 0;
  for (long long w = 0; w < n_u; ++w) {
    if (merged > 0 && u[w].start <= u[merged - 1].end) {
      if (u[w].end > u[merged - 1].end) u[merged - 1].end = u[w].end;
    } else {
      u[merged++] = u[w];
    }
  }
  long long nt = 0;
  for (long long w = 0; w < merged; ++w) nt += (u[w].end - u[w].start + TILE - 1) / TILE;
  Span* t = (Span*)malloc(sizeof(Span) * (nt > 0 ? nt : 1));
  unsigned* mask = (unsigned*)calloc(nt > 0 ? nt : 1, sizeof(unsigned));
  if (t == nullptr || mask == nullptr) {
    free(u);
    free(t);
    free(mask);
    return -2;
  }
  long long i = 0;
  for (long long w = 0; w < merged; ++w)
    for (long long r = u[w].start; r < u[w].end; r += TILE, ++i)
      t[i] = {r, r + TILE < u[w].end ? r + TILE : u[w].end};
  free(u);
  long long items = 0;
  for (int m = 0; m < members; ++m) {
    for (long long w = win_off[m]; w < win_off[m + 1]; ++w) {
      const long long start = windows[2 * w], end = windows[2 * w + 1];
      if (end <= start) continue;
      long long lo = 0, hi = nt;  // the first tile ending past start
      while (lo < hi) {
        const long long mid = (lo + hi) / 2;
        if (t[mid].end > start) hi = mid; else lo = mid + 1;
      }
      for (long long j = lo; j < nt && t[j].start < end; ++j) {
        items += !((mask[j] >> m) & 1u);
        mask[j] |= 1u << m;
      }
    }
  }
  *n_items = items;
  if (tiles != nullptr) {
    member_off[0] = 0;
    for (int m = 0; m < members; ++m) {
      long long c = 0;
      for (long long j = 0; j < nt; ++j) c += (mask[j] >> m) & 1u;
      member_off[m + 1] = (int)(member_off[m] + c);
    }
    int cursor[MAX_COHORT];
    for (int m = 0; m < members; ++m) cursor[m] = member_off[m];
    int at = 0;
    for (long long j = 0; j < nt; ++j) {
      tiles[4 * j] = (int)t[j].start;
      tiles[4 * j + 1] = (int)t[j].end;
      tiles[4 * j + 2] = (int)mask[j];
      tiles[4 * j + 3] = at;
      for (int m = 0; m < members; ++m) {
        if (!((mask[j] >> m) & 1u)) continue;
        member_tiles[cursor[m]] = (int)j;
        tile_p[at++] = cursor[m]++;
      }
    }
  }
  free(t);
  free(mask);
  return nt;
}

// One launch sequence of the cohort top-k for at most MAX_COHORT members,
// member m over its windows (raw_cohort_tiles' arguments). The wrapper's
// scratch (a->r.scratch) is laid out as CohortScratch says, a->r.tiles at
// its table; the keys (a->r.keys) n_tiles x TILE. One memset zeroes the
// head, the members' state and histograms and the look-back status; the
// table is built here and copied to the card (from pageable memory: staged
// before the call returns); then cohort_topk_keys, three cohort_topk_refine
// (none when no member has k window rows: no k-th key to find) and
// cohort_topk_write, cooperative. *kernels gets the kernels launched.
int raw_topk_cohort_launch(const CohortRawArgs* a, const long long* windows,
                           const long long* win_off, int* kernels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = a->members;
  const long long nt = a->r.n_tiles, items = a->n_items;
  if (M < 1 || M > MAX_COHORT || nt < 0 || items < 0 || a->r.k < 1 ||
      a->r.tiles != a->r.scratch + cohort_table_at(M, items))
    return (int)cudaErrorInvalidValue;
  long long most_rows = 0;
  for (int m = 0; m < M; ++m) {
    long long rows = 0;
    for (long long w = win_off[m]; w < win_off[m + 1]; ++w) rows += windows[2 * w + 1] - windows[2 * w];
    most_rows = rows > most_rows ? rows : most_rows;
  }
  TRY(cudaSetDevice(a->r.device));
  TRY(cudaMemsetAsync(a->r.scratch, 0, sizeof(int) * cohort_items_at(M), s));
  const long long words = 4 * nt + 2 * items + M + 1;
  int* host = (int*)malloc(sizeof(int) * words);
  if (host == nullptr) return (int)cudaErrorMemoryAllocation;
  int* member_off = host + 4 * nt + items;
  long long got = -1;
  cudaError_t err = cudaErrorInvalidValue;
  if (raw_cohort_tiles(windows, win_off, M, a->r.n_rows, host, host + 4 * nt, member_off,
                       member_off + M + 1, &got) == nt && got == items)
    err = cudaMemcpyAsync((void*)a->r.tiles, host, sizeof(int) * words, cudaMemcpyHostToDevice, s);
  long long most_items = 0;
  for (int m = 0; m < M && err == cudaSuccess; ++m) {
    const long long c = member_off[m + 1] - member_off[m];
    most_items = c > most_items ? c : most_items;
  }
  free(host);
  if (err != cudaSuccess) return (int)err;
  int grid, sms = 0, per_sm = 0;
  TRY(grid_for(a->r.device, nt, COHORT_KEYS_BLOCKS_PER_SM, &grid));
  cohort_topk_keys<<<grid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  *kernels = 1;
  TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a->r.device));
  if (most_rows >= a->r.k) {
    // each member's share of eight blocks an SM, over its own items
    const long long share = (long long)sms * 8 / M > 0 ? (long long)sms * 8 / M : 1;
    const unsigned gx = (unsigned)(most_items < 1 ? 1 : (most_items < share ? most_items : share));
    for (int shift = 16; shift >= 0; shift -= 8) {
      cohort_topk_refine<<<dim3(gx, M), BLOCK, 0, s>>>(*a, shift);
      LAUNCHED();
      ++*kernels;
    }
  }
  TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cohort_topk_write, BLOCK, 0));
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const unsigned wgrid = (unsigned)(items < 1 ? 1 : (items < resident ? items : resident));
  CohortRawArgs args = *a;
  void* params[] = {&args};
  TRY(cudaLaunchCooperativeKernel((const void*)cohort_topk_write, dim3(wgrid), dim3(BLOCK), params,
                                  0, s));
  ++*kernels;
  return 0;
}

const char* scan_topk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
