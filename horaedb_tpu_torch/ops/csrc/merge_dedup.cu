// Merge-dedup sort for Hopper: a stable LSD radix sort of multi-word keys
// with the dedup mask as its epilogue.
//
// Replaces the JAX package's jitted device programs (B5)
//   horaedb_tpu/ops/merge_dedup.py  _ranked_kernel          (rk:  2 key words, unstable)
//   horaedb_tpu/ops/merge_dedup.py  fused32_sort_dedup /
//                                   _fused32_kernel         (f32: 3 key words, stable)
//   horaedb_tpu/ops/merge_dedup.py  _fused64_kernel         (f64: 4 key words, stable)
//   horaedb_tpu/ops/merge_dedup.py  _general_kernel         (gen: 7 key words + negated
//                                                            index, stable)
// each of which is ``lax.sort`` of uint32 key words carrying the row index,
// then a shift-compare of the (masked) sorted keys.
//
// The sort: 8-bit digits, least significant first, one pass per digit;
// each thread of a pass owns one of the 256 digits. One kernel (init_hist) reads the key words once and counts
// every digit of every pass; plan_passes marks the passes whose digit is
// the same in every row (the identity, skipped with no host round trip)
// and turns each pass's counts into its digits' global bases. Then each
// executed pass is ONE kernel, sort_pass, that sweeps the data once
// (Onesweep, Adinets & Merrill 2022):
//   - a block takes the next tile of TILE rows from the pass's atomic
//     counter, so tiles are claimed in input order;
//   - it ranks each row among the earlier rows of its digit in INPUT order
//     (stability is the whole correctness of the f32, f64 and gen kinds):
//     each warp owns a contiguous run of the tile, ranks 32 rows at a time
//     with __match_any_sync and the popcount of the lower-lane peers, and
//     the warps' counts are prefixed in warp order;
//   - it publishes the tile's count of each digit in a status word, stages
//     the pass's key word in shared memory in digit order and issues the
//     next array's loads, then looks back over the earlier tiles' words for
//     each digit's exclusive prefix (decoupled look-back) and publishes its
//     inclusive prefix;
//   - it writes every carried array (the key words and the row index) out
//     in runs of one digit, so the stores coalesce, each array's loads in
//     flight while the one before is written.
// A block waits only on tiles claimed before its own, whose blocks are
// running and publish their counts before they wait on anything: all the
// blocks need not be resident. Status words carry the pass in their tag,
// so one region serves every pass of a call; the call zeroes it once.
// The first executed pass reads the input words directly, with the row
// index made on the fly (reversed for gen); nothing is copied before it.
// A word whose passes are over stops being carried when five or more
// passes follow (f32's packed rest word); the epilogue gathers it.
//
// Pads: for rk/f32/f64 the rows from n_valid on carry all-ones keys, so a
// stable sort puts them after every real row, in input order. The kernel
// sorts only the n_valid real rows and writes the pads' outputs directly;
// that also keeps the pads' all-ones digits from defeating the skip of the
// constant high digits (rk's composite fills at most 63 bits). gen tells
// its pads by is_pad (word 0) and sorts every row; its negated-index last
// key is replaced by starting from the reversed input, which a stable sort
// turns into the same order. The wrapper stages exactly the real rows, so
// on the main path there are no pads; padded words are still accepted.
//
// What bounds it: bytes. Each executed pass reads and writes every carried
// word and the index once; init_hist reads the key words once, the
// epilogue reads the sorted words and writes perm and keep. The floor for
// the whole function (key words read once, perm and keep written once) is
// far below what any multi-pass sort moves. 11-bit digits (9 passes for
// f32, 4 for rk's chunk) took 2.2-3x as long on an NVIDIA H100 80GB HBM3
// at 700 W (2048 look-back words a tile, 2-row digit runs, less
// occupancy), so the digit is 8 bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_WORDS 7
#define DIGIT_BITS 8
#define RADIX (1 << DIGIT_BITS)
#define DIGITS_PER_WORD ((32 + DIGIT_BITS - 1) / DIGIT_BITS)
#define MAX_PASSES (DIGITS_PER_WORD * MAX_WORDS)
#define BLOCK 256
#define WARPS (BLOCK / 32)
#define ITEMS 20
#define TILE (BLOCK * ITEMS)
#define HIST_BLOCK 1024
#define HIST_ROWS 8  // consecutive rows a thread of init_hist counts at a time
#define FULL 0xffffffffu
#define NO_DIGIT ((uint32_t)RADIX)
#define FROM_INPUT 2  // the pass's source: the input words (no pass ran before it)
#define DROP_AFTER 5  // executed passes after a word's last that drop it (see dropped)
#define FIXED_LAUNCHES 4  // a call's launches besides its passes (see merge_dedup_launch)
#define FLAG_AGGREGATE 1ull
#define FLAG_INCLUSIVE 2ull

static_assert(RADIX == BLOCK, "a thread of a pass owns one digit");
static_assert(TILE < 65536, "a warp's digit counts and a tile's slots fit 16 bits");

struct SortArgs {
  const uint32_t* in[MAX_WORDS];    // key words, most significant first, n rows each
  uint32_t* buf[2][MAX_WORDS + 1];  // ping-pong: the key words, then the row index
  uint32_t* ghist;                  // [MAX_PASSES][RADIX] digit counts of every pass (zeroed)
  uint32_t* bases;                  // [MAX_PASSES][RADIX] each digit's first sorted slot
  unsigned long long* status;       // [n_tiles][RADIX] look-back words (zeroed)
  uint32_t* tile_ctr;               // [MAX_PASSES] tiles claimed in each pass (zeroed)
  uint32_t* ran;                    // bit p set where pass p runs (zeroed)
  int32_t* perm;                    // [n]
  uint8_t* keep;                    // [n]
  uint8_t* passes;                  // [MAX_PASSES] 1 where the pass ran
  long long n;                      // rows of the words
  long long n_sort;                 // rows sorted: n_valid, or n for gen
  long long n_valid;
  long long n_tiles;
  uint32_t mask[MAX_WORDS];         // bits of each word the dedup compare sees
  int n_words;
  int reversed;                     // the sort sequence is the input reversed (gen)
  int perm_mode;                    // 0: perm = idx; 1: perm = n_valid - 1 - idx
  int pad_mode;                     // 0: pads are idx >= n_valid; 1: pads have word 0 != 0
  int dedup;
  int device;
};

__device__ __forceinline__ int pass_word(const SortArgs& a, int p) {
  return a.n_words - 1 - p / DIGITS_PER_WORD;
}

__device__ __forceinline__ int pass_shift(int p) { return (p % DIGITS_PER_WORD) * DIGIT_BITS; }

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Input row of the i-th row of the sort sequence.
__device__ __forceinline__ long long input_row(const SortArgs& a, long long i) {
  return a.reversed ? a.n - 1 - i : i;
}

// Array ``arr`` (a key word, or the row index at n_words) of the sort
// sequence at row i, in buffer ``src`` or, before any pass ran, the input.
__device__ __forceinline__ uint32_t load_row(const SortArgs& a, int src, int arr, long long i) {
  if (src != FROM_INPUT) return a.buf[src][arr][i];
  const long long r = input_row(a, i);
  return arr == a.n_words ? (uint32_t)r : a.in[arr][r];
}

// The buffer pass p reads (FROM_INPUT when no pass ran before it); with
// p = the pass count, the buffer the last pass wrote. ``ran``: *a.ran.
__device__ __forceinline__ int source_of(uint32_t ran, int p) {
  const int before = __popc(ran & ((1u << p) - 1u));
  return before == 0 ? FROM_INPUT : (before - 1) & 1;
}

// A key word whose passes are over is dropped, not carried, once
// DROP_AFTER or more executed passes follow its last one: the epilogue
// gathers it from the input by the sorted row index (a sector a row),
// which costs less than reading and writing it in every later pass.
// The most significant word is sorted by the last pass and never dropped.
__device__ __forceinline__ bool dropped(const SortArgs& a, uint32_t ran, int w) {
  const int last = (a.n_words - w) * DIGITS_PER_WORD - 1;  // its last pass
  return w > 0 && __popc(ran >> last >> 1) >= DROP_AFTER;
}

__device__ __forceinline__ void publish(unsigned long long* s, int p, unsigned long long flag,
                                        uint32_t v) {
  const unsigned long long w = ((unsigned long long)(p + 1) << 34) | (flag << 32) | v;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(s), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* s) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(s) : "memory");
  return w;
}

// Exclusive scan of one value per thread over the block (BLOCK threads).
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int k = 0; k < warp; ++k) before += tmp[k];
  __syncthreads();  // tmp is free for the next call
  return before + x - v;
}

// Counts the digits of every pass: reads each key word of the sort
// sequence once, a word at a time, into one word's histograms in shared
// memory, then adds them to ghist. Each thread takes HIST_ROWS
// consecutive rows and adds each run of one digit once: the input is
// runs of (tsid, ts)-sorted rows, so its high digits repeat. A warp whose
// rows all share a digit adds it once.
__global__ void __launch_bounds__(HIST_BLOCK) init_hist(const __grid_constant__ SortArgs a) {
  __shared__ uint32_t h[DIGITS_PER_WORD * RADIX];
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * HIST_BLOCK * HIST_ROWS;
  const long long first = ((long long)blockIdx.x * HIST_BLOCK + (threadIdx.x & ~31)) * HIST_ROWS;
  for (int w = 0; w < a.n_words; ++w) {
    for (int i = threadIdx.x; i < DIGITS_PER_WORD * RADIX; i += HIST_BLOCK) h[i] = 0;
    __syncthreads();
    const uint32_t* key = a.in[w];
    for (long long warp0 = first; warp0 < a.n_sort; warp0 += stride) {
      const long long i0 = warp0 + lane * HIST_ROWS;
      const long long left = a.n_sort - i0;
      const int m = left <= 0 ? 0 : (left < HIST_ROWS ? (int)left : HIST_ROWS);
      uint32_t v[HIST_ROWS];
#pragma unroll
      for (int r = 0; r < HIST_ROWS; ++r) v[r] = r < m ? key[input_row(a, i0 + r)] : 0u;
#pragma unroll
      for (int k = 0; k < DIGITS_PER_WORD; ++k) {
        uint32_t cur = (v[0] >> (k * DIGIT_BITS)) & (RADIX - 1), cnt = m > 0;
        bool split = false;
#pragma unroll
        for (int r = 1; r < HIST_ROWS; ++r) {
          const uint32_t d = (v[r] >> (k * DIGIT_BITS)) & (RADIX - 1);
          if (r >= m) continue;
          if (d == cur) {
            ++cnt;
          } else {
            atomicAdd(&h[k * RADIX + cur], cnt);
            cur = d;
            cnt = 1;
            split = true;
          }
        }
        const uint32_t cur0 = __shfl_sync(FULL, cur, 0);
        if (__all_sync(FULL, !split && (cnt == 0 || cur == cur0))) {
          const uint32_t total = __reduce_add_sync(FULL, cnt);
          if (lane == 0 && total) atomicAdd(&h[k * RADIX + cur0], total);
        } else if (cnt) {
          atomicAdd(&h[k * RADIX + cur], cnt);
        }
      }
    }
    __syncthreads();
    uint32_t* g = a.ghist + (a.n_words - 1 - w) * DIGITS_PER_WORD * RADIX;
    for (int i = threadIdx.x; i < DIGITS_PER_WORD * RADIX; i += HIST_BLOCK)
      if (h[i]) atomicAdd(&g[i], h[i]);
    __syncthreads();
  }
}

// One block a pass: marks the pass skipped when its digit is the same in
// every row, and scans its digit counts into each digit's first sorted slot.
__global__ void __launch_bounds__(BLOCK) plan_passes(const __grid_constant__ SortArgs a) {
  __shared__ uint32_t scan_tmp[WARPS];
  __shared__ int any_full;
  const int p = blockIdx.x, tid = threadIdx.x;
  if (p == 0)
    for (int q = DIGITS_PER_WORD * a.n_words + tid; q < MAX_PASSES; q += BLOCK) a.passes[q] = 0;
  if (tid == 0) any_full = 0;
  const uint32_t c = a.ghist[p * RADIX + tid];
  __syncthreads();
  if (c == (uint32_t)a.n_sort) any_full = 1;
  a.bases[p * RADIX + tid] = block_exclusive_scan(c, scan_tmp);  // syncs: any_full is set
  if (tid == 0) {
    if (!any_full) atomicOr(a.ran, 1u << p);
    a.passes[p] = (uint8_t)!any_full;
  }
}

// Shared memory of sort_pass: the warps' digit counts (later the staged
// values of one array), each digit's first staged slot and its output
// offset, and each staged slot's digit.
#define HIST_BYTES (WARPS * RADIX * 2)
#define STAGE_BYTES (HIST_BYTES > TILE * 4 ? HIST_BYTES : TILE * 4)
#define PASS_SMEM (STAGE_BYTES + 2 * RADIX * 4 + TILE)
#define PASS_BLOCKS_PER_SM 3  // registers capped so that three blocks share an SM

static_assert(PASS_SMEM <= 48 * 1024, "sort_pass needs no opt-in to more shared memory");

// The carried array that the pass writes after ``arr`` (-1 before the
// first): the key words not dropped and the row index, in order, the
// pass's own key word left out (it is written first, from registers); -1
// after the last.
__device__ __forceinline__ int next_array(const SortArgs& a, uint32_t ran, int arr, int word) {
  for (++arr; arr < a.n_words; ++arr)
    if (arr != word && (arr < word || !dropped(a, ran, arr))) return arr;
  return arr == a.n_words ? arr : -1;
}

__global__ void __launch_bounds__(BLOCK, PASS_BLOCKS_PER_SM)
    sort_pass(const __grid_constant__ SortArgs a, int p) {
  const uint32_t ran = *a.ran;
  if (!(ran >> p & 1u)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* warp_hist = (uint16_t*)smem;  // [WARPS][RADIX]: counts, then prefixes
  uint32_t* sval = (uint32_t*)smem;       // [TILE], once the ranks are final
  uint32_t* start = (uint32_t*)(smem + STAGE_BYTES);  // [RADIX]
  uint32_t* dest0 = start + RADIX;                    // [RADIX]
  uint8_t* sdig = (uint8_t*)(dest0 + RADIX);          // [TILE]
  __shared__ uint32_t scan_tmp[WARPS];
  __shared__ long long tile_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_s = atomicAdd(&a.tile_ctr[p], 1u);
  for (int i = tid; i < WARPS * RADIX / 2; i += BLOCK) ((uint32_t*)warp_hist)[i] = 0;
  const int src = source_of(ran, p);
  const int dst = src == FROM_INPUT ? 0 : src ^ 1;
  const int word = pass_word(a, p), shift = pass_shift(p);
  __syncthreads();
  const long long t = tile_s, t0 = t * TILE;
  const long long left = a.n_sort - t0;
  const int rows = left < TILE ? (int)left : TILE;

  // 1. each row's digit and its rank among the earlier rows of its digit
  //    in its warp's run; the pass's key word stays in registers
  const int run0 = warp * (ITEMS * 32);
  uint32_t kv[ITEMS], dp[ITEMS];  // dp: digit << 16 | rank, then staged slot
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = run0 + j * 32 + lane;
    kv[j] = r < rows ? load_row(a, src, word, t0 + r) : 0u;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool valid = run0 + j * 32 + lane < rows;
    const uint32_t d = valid ? (kv[j] >> shift) & (RADIX - 1) : NO_DIGIT;
    const uint32_t peers = __match_any_sync(FULL, d);
    uint32_t rank = 0;
    if (valid) rank = warp_hist[warp * RADIX + d] + __popc(peers & lanemask_lt());
    __syncwarp();
    if (valid && (__ffs(peers) - 1) == lane)
      warp_hist[warp * RADIX + d] += (uint16_t)__popc(peers);
    __syncwarp();
    dp[j] = d << 16 | rank;
  }
  __syncthreads();

  // 2. the thread's digit (tid): its counts prefixed over the warps (warp
  //    order is input order); the tile's count published for the later tiles
  uint32_t cnt = 0;
  unsigned long long* st = a.status + t * RADIX + tid;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const uint32_t c = warp_hist[k * RADIX + tid];
    warp_hist[k * RADIX + tid] = (uint16_t)cnt;
    cnt += c;
  }
  publish(st, p, t == 0 ? FLAG_INCLUSIVE : FLAG_AGGREGATE, cnt);

  // 3. the digits' first staged slots: a scan of the counts over the digits
  const uint32_t first = block_exclusive_scan(cnt, scan_tmp);
  start[tid] = first;
  __syncthreads();

  // 4. each row's staged slot: digits in order, rows of a digit in input
  //    order
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const uint32_t d = dp[j] >> 16;
    if (d < RADIX) {
      dp[j] = start[d] + warp_hist[warp * RADIX + d] + (dp[j] & 0xffffu);
      sdig[dp[j]] = (uint8_t)d;
    } else {
      dp[j] = FULL;
    }
  }
  __syncthreads();  // warp_hist is free: sval takes its place

  // 5. the pass's key word staged from registers and the next array's
  //    loads issued, both ahead of the look-back's waits
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (dp[j] != FULL) sval[dp[j]] = kv[j];
  int arr = next_array(a, ran, -1, word);
  uint32_t v[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    v[j] = dp[j] != FULL ? load_row(a, src, arr, t0 + run0 + j * 32 + lane) : 0u;

  // 6. decoupled look-back: the thread's digit's rows in the earlier
  //    tiles, then the tile's inclusive prefix published
  uint32_t excl = 0;
  const unsigned long long want = (unsigned long long)(p + 1);
  for (long long j = t - 1; j >= 0;) {
    const unsigned long long w = peek(a.status + j * RADIX + tid);
    const unsigned long long flag = (w >> 32) & 3ull;
    if ((w >> 34) != want || flag == 0) continue;  // not yet published in this pass
    excl += (uint32_t)w;
    j = flag == FLAG_INCLUSIVE ? -1 : j - 1;
  }
  if (t > 0) publish(st, p, FLAG_INCLUSIVE, excl + cnt);
  dest0[tid] = a.bases[p * RADIX + tid] + excl - first;
  __syncthreads();

  // 7. every carried array out in runs of one digit, the key word first;
  //    each array's loads are in flight while the one before is written
  uint32_t* out = a.buf[dst][word];
  while (true) {
    for (int s = tid; s < rows; s += BLOCK) out[dest0[sdig[s]] + (uint32_t)s] = sval[s];
    if (arr < 0) break;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (dp[j] != FULL) sval[dp[j]] = v[j];
    __syncthreads();
    out = a.buf[dst][arr];
    arr = next_array(a, ran, arr, word);
    if (arr >= 0) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        v[j] = dp[j] != FULL ? load_row(a, src, arr, t0 + run0 + j * 32 + lane) : 0u;
    }
  }
}

// perm from the sorted row index; keep = first row of each run of equal
// masked keys (every row without dedup), and never a pad.
__global__ void __launch_bounds__(BLOCK) epilogue(const __grid_constant__ SortArgs a) {
  const uint32_t ran = *a.ran;
  const int fin = source_of(ran, DIGITS_PER_WORD * a.n_words);
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < a.n; i += stride) {
    int32_t perm;
    uint8_t keep;
    if (i < a.n_sort) {
      const uint32_t idx = load_row(a, fin, a.n_words, i);
      perm = a.perm_mode ? (int32_t)(a.n_valid - 1 - (long long)idx) : (int32_t)idx;
      bool k = true;
      if (a.dedup && i > 0) {
        const uint32_t before = load_row(a, fin, a.n_words, i - 1);
        bool same = true;
        for (int w = 0; w < a.n_words; ++w) {
          if (!a.mask[w]) continue;
          // a dropped word from the input, by the sorted row index (the
          // input row: gen's index was made reversed)
          const bool gather = dropped(a, ran, w);
          const uint32_t x = gather ? a.in[w][idx] : load_row(a, fin, w, i);
          const uint32_t y = gather ? a.in[w][before] : load_row(a, fin, w, i - 1);
          same &= ((x ^ y) & a.mask[w]) == 0u;
        }
        k = !same;
      }
      k &= a.pad_mode ? load_row(a, fin, 0, i) == 0u : (long long)idx < a.n_valid;
      keep = (uint8_t)k;
    } else {  // a pad of rk/f32/f64: sorted index i
      perm = a.perm_mode ? (int32_t)(a.n_valid - 1 - i) : (int32_t)i;
      keep = 0;
    }
    a.perm[i] = perm;
    a.keep[i] = keep;
  }
}

#define LAUNCH_CHECK()                         \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

extern "C" {

// struct size and limits, so the ctypes mirror can check its layout at load
int merge_dedup_abi(long long* sizes) {
  sizes[0] = sizeof(SortArgs);
  sizes[1] = MAX_WORDS;
  sizes[2] = MAX_PASSES;
  sizes[3] = TILE;
  sizes[4] = DROP_AFTER;
  sizes[5] = FIXED_LAUNCHES;
  return 0;
}

// The zeroed scratch (ghist, tile_ctr, ran, status) must be one region
// from ghist on, in that order: one memset clears it. Kernels a call launches:
// the memset, init_hist, plan_passes and the epilogue (FIXED_LAUNCHES), and
// one sort_pass a pass (a skipped pass returns at once).
int merge_dedup_launch(const SortArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  if (a->n_words < 1 || a->n_words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a->device);
  if (err != cudaSuccess) return (int)err;
  const size_t zeroed = (const char*)(a->status + a->n_tiles * RADIX) - (const char*)a->ghist;
  err = cudaMemsetAsync(a->ghist, 0, zeroed, s);
  if (err != cudaSuccess) return (int)err;
  const long long want_hist = (a->n_sort + HIST_BLOCK * HIST_ROWS - 1) / (HIST_BLOCK * HIST_ROWS);
  const long long cap_hist = (long long)sms * 2;
  init_hist<<<(int)(want_hist < 1 ? 1 : (want_hist < cap_hist ? want_hist : cap_hist)),
              HIST_BLOCK, 0, s>>>(*a);
  LAUNCH_CHECK();
  const int n_passes = DIGITS_PER_WORD * a->n_words;
  plan_passes<<<n_passes, BLOCK, 0, s>>>(*a);
  LAUNCH_CHECK();
  if (a->n_tiles > 0) {
    for (int p = 0; p < n_passes; ++p) {
      sort_pass<<<(unsigned)a->n_tiles, BLOCK, PASS_SMEM, s>>>(*a, p);
      LAUNCH_CHECK();
    }
  }
  const long long cap = (long long)sms * 8;
  const long long want = (a->n + BLOCK - 1) / BLOCK;
  epilogue<<<(int)(want < cap ? want : cap), BLOCK, 0, s>>>(*a);
  LAUNCH_CHECK();
  return 0;
}

const char* merge_dedup_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
