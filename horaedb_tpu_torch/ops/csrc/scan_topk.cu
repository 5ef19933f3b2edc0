// Raw reads over the resident scan cache: fused filter + top-k, and the
// bounded selection, for Hopper.
//
// Replaces the JAX package's jitted device programs (B4)
//   horaedb_tpu/ops/scan_topk.py  raw_topk_body    via raw_topk_packed
//   horaedb_tpu/ops/scan_topk.py  raw_select_body  via raw_select_packed
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
//                reference's searchsorted runs past its stream).
// No host round trip between launches: one copy of the k slots comes back.
//
// Selection: raw_flags decodes and masks (the ballot words are the mask),
// raw_scan writes the count, raw_write the masked-in row ids in row order,
// never past ``slots``; raw_fill pads with -1.
//
// What bounds it: the bytes of the resident columns (one decode pass) and
// of the key buffer (written once, read four times); the picks and the
// scan are single-block steps of a few microseconds each.

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
enum { MODE_STRICT = 0, MODE_TIE = 1, MODE_SELECT = 2 };

struct RawArgs {
  Column series;
  Column ts;
  Column fields[MAX_FIELDS];
  const int* session;  // allow list [S + 1]
  const int* dyn;      // [literal bits (n_f) | lo, hi, key_lo, key_hi]
  int* keys;           // [n_rows] (top-k only)
  int* scratch;        // [state | hist 256 | counts 2 x tiles | bits 2 x tiles x WORDS]
  int* out;            // top-k [k]; selection [1 + k]
  long long n_rows;
  long long k;         // top-k slots, or the selection's slots
  int descending;
  int key_is_ts;
  int key_field;
  int device;
  Filters filt;
};

struct Scratch {
  int* st;
  int* hist;
  int* cnt[2];
  unsigned* bits[2];
};

__device__ __forceinline__ long long n_tiles_of(long long n) { return (n + TILE - 1) / TILE; }

__device__ __forceinline__ Scratch scratch_of(const RawArgs& a) {
  const long long nt = n_tiles_of(a.n_rows);
  Scratch s;
  s.st = a.scratch;
  s.hist = a.scratch + ST_WORDS;
  s.cnt[0] = s.hist + 256;
  s.cnt[1] = s.cnt[0] + nt;
  s.bits[0] = (unsigned*)(s.cnt[1] + nt);
  s.bits[1] = s.bits[0] + nt * WORDS;
  return s;
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
__global__ void __launch_bounds__(BLOCK) topk_pick(const __grid_constant__ RawArgs a, int shift) {
  __shared__ int h[256];
  const Scratch s = scratch_of(a);
  const int t = threadIdx.x;
  h[t] = s.hist[t];
  s.hist[t] = 0;
  __syncthreads();
  if (t != 0) return;
  int* st = s.st;
  if (shift == 24) {
    st[ST_ACTIVE] = (long long)st[ST_TOTAL] >= a.k;
    st[ST_RANK] = (int)(a.k < st[ST_TOTAL] ? a.k : st[ST_TOTAL]);
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
    const int nf = a.filt.n;
    const long long key_lo = a.dyn[nf + 2], key_hi = a.dyn[nf + 3];
    long long thr;
    if (key_hi <= key_lo + 1) {
      thr = key_hi;
    } else {
      thr = st[ST_ACTIVE] ? (long long)(int)flipped(st[ST_PREFIX]) : (long long)KEY_MASKED;
      if (thr < key_lo + 1) thr = key_lo + 1;
      if (thr > key_hi) thr = key_hi;
    }
    st[ST_THR] = (int)thr;
    st[ST_LIMIT] = (int)(a.k < st[ST_TOTAL] ? a.k : st[ST_TOTAL]);
  }
}

// ---- ordered compaction -------------------------------------------------------

// Ballot bit words and per-tile counts: top-k, the rows strictly above the
// threshold (stream 0) and the ties (stream 1) from the key buffer;
// selection, the masked-in rows (stream 0) from the columns.
template <bool TOPK>
__global__ void __launch_bounds__(BLOCK) raw_flags(const __grid_constant__ RawArgs a) {
  __shared__ int wsum[2][BLOCK / 32];
  const Scratch s = scratch_of(a);
  const int nf = a.filt.n;
  const int lo = a.dyn[nf], hi = a.dyn[nf + 1];
  const int thr = TOPK ? s.st[ST_THR] : 0;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long nt = n_tiles_of(a.n_rows);
  for (long long tile = blockIdx.x; tile < nt; tile += gridDim.x) {
    int c0 = 0, c1 = 0;
    for (int j = 0; j < TILE / BLOCK; ++j) {
      const long long i = tile * TILE + j * BLOCK + threadIdx.x;
      bool f0 = false, f1 = false;
      if (i < a.n_rows) {
        if (TOPK) {
          const int key = a.keys[i];
          f0 = key > thr;
          f1 = key != KEY_MASKED && key == thr;
        } else {
          int ts = 0;
          f0 = row_mask(a, i, lo, hi, ts);
        }
      }
      const unsigned b0 = __ballot_sync(FULL_MASK, f0);
      const unsigned b1 = __ballot_sync(FULL_MASK, f1);
      if (lane == 0) {
        const long long word = tile * WORDS + j * (BLOCK / 32) + w;
        s.bits[0][word] = b0;
        if (TOPK) s.bits[1][word] = b1;
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
      if (TOPK) s.cnt[1][tile] = t1;
    }
    __syncthreads();
  }
}

// One block: exclusive prefix sums of the tile counts of ``streams``
// streams, in place; the totals go to the state (top-k) or to out[0], the
// selection's count.
__global__ void __launch_bounds__(SCAN_THREADS) raw_scan(const __grid_constant__ RawArgs a,
                                                         int streams) {
  const Scratch s = scratch_of(a);
  const long long nt = n_tiles_of(a.n_rows);
  for (int q = 0; q < streams; ++q) {
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
    if (threadIdx.x == 0) {
      if (streams == 2) {
        s.st[q == 0 ? ST_STRICT : ST_TIE] = carry;
      } else {
        s.st[ST_TOTAL] = carry;
        a.out[0] = carry;
      }
    }
  }
}

// Each tile writes the row ids of its set bits, in row order, to slots
// [first + offset, ...) below ``limit``: strict rows from slot 0 and below
// k; ties from slot n_strict and below min(k, total); selected rows from
// out[1] and below 1 + slots. One thread per bit word.
__global__ void __launch_bounds__(WORDS) raw_write(const __grid_constant__ RawArgs a, int mode) {
  const Scratch s = scratch_of(a);
  const int q = mode == MODE_TIE ? 1 : 0;
  long long first, limit;
  if (mode == MODE_STRICT) {
    first = 0;
    limit = a.k;
  } else if (mode == MODE_TIE) {
    first = s.st[ST_STRICT];
    limit = s.st[ST_LIMIT];
  } else {
    first = 1;
    limit = 1 + a.k;
  }
  const long long nt = n_tiles_of(a.n_rows);
  for (long long tile = blockIdx.x; tile < nt; tile += gridDim.x) {
    const long long start = first + s.cnt[q][tile];
    if (start >= limit) continue;  // the whole tile lands past the last slot
    unsigned bits = s.bits[q][tile * WORDS + threadIdx.x];
    int total;
    long long pos = start + block_scan<WORDS>(__popc(bits), total);
    const long long row0 = tile * TILE + (long long)threadIdx.x * 32;
    while (bits && pos < limit) {
      const int b = __ffs(bits) - 1;
      a.out[pos++] = (int)(row0 + b);
      bits &= bits - 1;
    }
  }
}

// Slots no tile wrote. Top-k: -1 from min(k, total) on; below it only
// where the reference's tie stream runs out (its searchsorted returns
// n_rows there; never with seeds that bracket the keys). Selection: -1
// from min(count, slots) on.
__global__ void __launch_bounds__(BLOCK) raw_fill(const __grid_constant__ RawArgs a, int mode) {
  const Scratch s = scratch_of(a);
  const long long stride = (long long)gridDim.x * BLOCK;
  if (mode == MODE_SELECT) {
    const long long count = s.st[ST_TOTAL];
    const long long from = count < a.k ? count : a.k;
    for (long long j = from + blockIdx.x * BLOCK + threadIdx.x; j < a.k; j += stride)
      a.out[1 + j] = -1;
    return;
  }
  const long long n_strict = s.st[ST_STRICT], n_tie = s.st[ST_TIE], limit = s.st[ST_LIMIT];
  for (long long j = blockIdx.x * BLOCK + threadIdx.x; j < a.k; j += stride) {
    const bool written = j < n_strict || (j < limit && j - n_strict < n_tie);
    if (!written) a.out[j] = j < limit ? (int)a.n_rows : -1;
  }
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
  raw_flags<true><<<grid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  raw_scan<<<1, SCAN_THREADS, 0, s>>>(*a, 2);
  LAUNCHED();
  raw_write<<<wgrid, WORDS, 0, s>>>(*a, MODE_STRICT);
  LAUNCHED();
  raw_write<<<wgrid, WORDS, 0, s>>>(*a, MODE_TIE);
  LAUNCHED();
  raw_fill<<<fgrid, BLOCK, 0, s>>>(*a, MODE_STRICT);
  LAUNCHED();
  return 0;
}

int raw_select_launch(const RawArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TRY(cudaSetDevice(a->device));
  const long long nt = host_tiles(a->n_rows);
  int grid, wgrid, fgrid;
  TRY(grid_for(a->device, nt, 8, &grid));
  TRY(grid_for(a->device, nt, 16, &wgrid));
  TRY(grid_for(a->device, (a->k + BLOCK - 1) / BLOCK, 8, &fgrid));
  raw_flags<false><<<grid, BLOCK, 0, s>>>(*a);
  LAUNCHED();
  raw_scan<<<1, SCAN_THREADS, 0, s>>>(*a, 1);
  LAUNCHED();
  raw_write<<<wgrid, WORDS, 0, s>>>(*a, MODE_SELECT);
  LAUNCHED();
  raw_fill<<<fgrid, BLOCK, 0, s>>>(*a, MODE_SELECT);
  LAUNCHED();
  return 0;
}

const char* scan_topk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
