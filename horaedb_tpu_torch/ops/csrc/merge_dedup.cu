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
// The sort: 8-bit digits, least significant first, one pass per digit
// (four per key word). Each pass is three kernels over tiles of TILE rows:
//   tile_hist     digit histogram of each tile;
//   digit_scan    one block per digit: exclusive scan of that digit's
//                 counts over the tiles, and the digit's total;
//   tile_scatter  ranks every row among the earlier rows of its digit in
//                 INPUT order (stability is the whole correctness of the
//                 f32, f64 and gen kinds): each warp owns a contiguous run
//                 of the tile, ranks 32 rows at a time with
//                 __match_any_sync and the popcount of the lower-lane
//                 peers, and carries its per-digit counts; the warps'
//                 counts are then prefixed in warp order. Rows are staged
//                 in shared memory in digit order and written out in runs
//                 of one digit, so the stores coalesce.
// A pass whose digit is the same in every row is the identity and is
// skipped: one kernel (init_hist) counts every digit of every pass while it
// copies the keys into the first ping-pong buffer, and plan_passes marks
// the constant digits and works out which buffer each executed pass reads.
// Skipping needs no host round trip: every pass kernel reads its plan.
//
// Pads: for rk/f32/f64 the rows from n_valid on carry all-ones keys, so a
// stable sort puts them after every real row, in input order. The kernel
// sorts only the n_valid real rows and writes the pads' outputs directly;
// that also keeps the pads' all-ones digits from defeating the skip of the
// constant high digits (rk's composite fills at most 63 bits). gen tells
// its pads by is_pad (word 0) and sorts every row; its negated-index last
// key is replaced by starting from the reversed input, which a stable sort
// turns into the same order.
//
// What bounds it: bytes. Each executed pass reads the sorted word once for
// the histogram and reads and writes every carried word and the index
// once; the floor for the whole function (key words read once, perm and
// keep written once) is far below what any multi-pass sort moves.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_WORDS 7
#define MAX_PASSES (4 * MAX_WORDS)
#define RADIX 256
#define BLOCK 256
#define WARPS (BLOCK / 32)
#define ITEMS 16
#define TILE (BLOCK * ITEMS)
#define SCAN_BLOCK 1024
#define FULL 0xffffffffu
#define NO_DIGIT 0x100u

static_assert(BLOCK == RADIX, "one thread per digit");

struct SortArgs {
  const uint32_t* in[MAX_WORDS];   // key words, most significant first, n rows each
  uint32_t* buf[2][MAX_WORDS + 1];  // ping-pong: the key words, then the row index
  uint32_t* counts;                 // [RADIX][n_tiles] per-tile digit counts, then offsets
  uint32_t* totals;                 // [RADIX] rows of each digit in the pass
  uint32_t* ghist;                  // [MAX_PASSES][RADIX] digit counts of every pass
  int32_t* plan;                    // [MAX_PASSES] skip, [MAX_PASSES] source buffer, final
  int32_t* perm;                    // [n]
  uint8_t* keep;                    // [n]
  uint8_t* passes;                  // [MAX_PASSES] 1 where the pass ran
  long long n;                      // rows (the padded bucket)
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
  return a.n_words - 1 - (p >> 2);
}

__device__ __forceinline__ int pass_shift(int p) { return (p & 3) * 8; }

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
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

// Copies the sort sequence into buf[0] (keys and row index) and counts the
// digits of every pass.
__global__ void __launch_bounds__(BLOCK) init_hist(const __grid_constant__ SortArgs a) {
  __shared__ uint32_t h[MAX_PASSES * RADIX];
  const int n_hist = 4 * a.n_words * RADIX;
  for (int i = threadIdx.x; i < n_hist; i += BLOCK) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long base = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32;
       base < a.n_sort; base += stride) {
    const long long i = base + lane;
    const bool valid = i < a.n_sort;
    const long long r = a.reversed ? a.n - 1 - i : i;
    if (valid) a.buf[0][a.n_words][i] = (uint32_t)r;
    for (int w = 0; w < a.n_words; ++w) {
      const uint32_t v = valid ? a.in[w][r] : 0u;
      if (valid) a.buf[0][w][i] = v;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t d = valid ? (v >> (8 * k)) & 0xffu : NO_DIGIT;
        const uint32_t peers = __match_any_sync(FULL, d);
        if (valid && (__ffs(peers) - 1) == lane)
          atomicAdd(&h[((a.n_words - 1 - w) * 4 + k) * RADIX + d], (uint32_t)__popc(peers));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_hist; i += BLOCK)
    if (h[i]) atomicAdd(&a.ghist[i], h[i]);
}

// Marks the passes whose digit is the same in every row, and the buffer
// each executed pass reads (the passes ping-pong between buf[0] and buf[1]).
__global__ void plan_passes(const __grid_constant__ SortArgs a) {
  const int n_passes = 4 * a.n_words;
  for (int p = threadIdx.x; p < n_passes; p += blockDim.x) {
    int skip = 0;
    for (int d = 0; d < RADIX; ++d) skip |= a.ghist[p * RADIX + d] == (uint32_t)a.n_sort;
    a.plan[p] = skip;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int cur = 0;
    for (int p = 0; p < MAX_PASSES; ++p) {
      const int ran = p < n_passes && !a.plan[p];
      a.plan[MAX_PASSES + p] = cur;
      a.passes[p] = (uint8_t)ran;
      cur ^= ran;
    }
    a.plan[2 * MAX_PASSES] = cur;
  }
}

__global__ void __launch_bounds__(BLOCK) tile_hist(const __grid_constant__ SortArgs a, int p) {
  if (a.plan[p]) return;
  __shared__ uint32_t h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t* key = a.buf[a.plan[MAX_PASSES + p]][pass_word(a, p)];
  const int shift = pass_shift(p), lane = threadIdx.x & 31;
  const long long t0 = (long long)blockIdx.x * TILE;
#pragma unroll 4
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = t0 + j * BLOCK + threadIdx.x;
    const bool valid = i < a.n_sort;
    const uint32_t d = valid ? (key[i] >> shift) & 0xffu : NO_DIGIT;
    const uint32_t peers = __match_any_sync(FULL, d);
    if (valid && (__ffs(peers) - 1) == lane) atomicAdd(&h[d], (uint32_t)__popc(peers));
  }
  __syncthreads();
  a.counts[(long long)threadIdx.x * a.n_tiles + blockIdx.x] = h[threadIdx.x];
}

__global__ void __launch_bounds__(SCAN_BLOCK) digit_scan(const __grid_constant__ SortArgs a, int p) {
  if (a.plan[p]) return;
  __shared__ uint32_t warp_sum[SCAN_BLOCK / 32];
  uint32_t* c = a.counts + (long long)blockIdx.x * a.n_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t carry = 0;
  for (long long b = 0; b < a.n_tiles; b += SCAN_BLOCK) {
    const long long i = b + threadIdx.x;
    const uint32_t v = i < a.n_tiles ? c[i] : 0u;
    uint32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      uint32_t s = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, s, o);
        if (lane >= o) s += y;
      }
      warp_sum[lane] = s;  // inclusive over the warps
    }
    __syncthreads();
    const uint32_t before = warp == 0 ? 0u : warp_sum[warp - 1];
    if (i < a.n_tiles) c[i] = carry + before + x - v;
    carry += warp_sum[SCAN_BLOCK / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) a.totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(BLOCK) tile_scatter(const __grid_constant__ SortArgs a, int p) {
  if (a.plan[p]) return;
  __shared__ uint32_t warp_hist[WARPS][RADIX];  // a warp's digit counts, then its prefix
  __shared__ uint32_t start[RADIX];             // the tile's first staged slot of each digit
  __shared__ uint32_t dest0[RADIX];             // output slot of the tile's first row of each digit
  __shared__ uint32_t scan_tmp[WARPS];
  __shared__ uint32_t sval[TILE];
  __shared__ uint8_t sdig[TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int src = a.plan[MAX_PASSES + p];
  const int shift = pass_shift(p);
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long left = a.n_sort - t0;
  const int rows = left < TILE ? (int)left : TILE;

#pragma unroll
  for (int k = 0; k < WARPS; ++k) warp_hist[k][tid] = 0;
  const uint32_t digit_base = block_exclusive_scan(a.totals[tid], scan_tmp);
  dest0[tid] = digit_base + a.counts[(long long)tid * a.n_tiles + blockIdx.x];
  __syncthreads();

  // 1. rank each row among the earlier rows of its digit in its warp's run
  const uint32_t* key = a.buf[src][pass_word(a, p)] + t0;
  const int run0 = warp * (ITEMS * 32);
  uint32_t dig[ITEMS], pos[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = run0 + j * 32 + lane;
    const bool valid = r < rows;
    const uint32_t d = valid ? (key[r] >> shift) & 0xffu : NO_DIGIT;
    const uint32_t peers = __match_any_sync(FULL, d);
    uint32_t rank = 0;
    if (valid) rank = warp_hist[warp][d] + __popc(peers & lanemask_lt());
    __syncwarp();
    if (valid && (__ffs(peers) - 1) == lane) warp_hist[warp][d] += __popc(peers);
    __syncwarp();
    dig[j] = d;
    pos[j] = rank;
  }
  __syncthreads();

  // 2. prefix each digit's counts over the warps (warp order is input
  //    order), then over the digits: each row's staged slot
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const uint32_t c = warp_hist[k][tid];
    warp_hist[k][tid] = run;
    run += c;
  }
  start[tid] = block_exclusive_scan(run, scan_tmp);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (dig[j] < RADIX) {
      pos[j] += start[dig[j]] + warp_hist[warp][dig[j]];
      sdig[pos[j]] = (uint8_t)dig[j];
    }
  }

  // 3. every carried array through shared memory, out in runs of one digit
  for (int arr = 0; arr <= a.n_words; ++arr) {
    const uint32_t* in = a.buf[src][arr] + t0;
    uint32_t* out = a.buf[src ^ 1][arr];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (dig[j] < RADIX) sval[pos[j]] = in[run0 + j * 32 + lane];
    __syncthreads();
    for (int s = tid; s < rows; s += BLOCK) {
      const uint32_t d = sdig[s];
      out[dest0[d] + (uint32_t)s - start[d]] = sval[s];
    }
    __syncthreads();
  }
}

// perm from the sorted row index; keep = first row of each run of equal
// masked keys (every row without dedup), and never a pad.
__global__ void __launch_bounds__(BLOCK) epilogue(const __grid_constant__ SortArgs a) {
  const int fin = a.plan[2 * MAX_PASSES];
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < a.n; i += stride) {
    int32_t perm;
    uint8_t keep;
    if (i < a.n_sort) {
      const uint32_t idx = a.buf[fin][a.n_words][i];
      perm = a.perm_mode ? (int32_t)(a.n_valid - 1 - (long long)idx) : (int32_t)idx;
      bool k = true;
      if (a.dedup && i > 0) {
        bool same = true;
        for (int w = 0; w < a.n_words; ++w)
          same &= ((a.buf[fin][w][i] ^ a.buf[fin][w][i - 1]) & a.mask[w]) == 0u;
        k = !same;
      }
      k &= a.pad_mode ? a.buf[fin][0][i] == 0u : (long long)idx < a.n_valid;
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
  return 0;
}

int merge_dedup_launch(const SortArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  if (a->n_words < 1 || a->n_words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a->device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(a->ghist, 0, sizeof(uint32_t) * MAX_PASSES * RADIX, s);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)sms * 8;
  long long want = (a->n_sort + BLOCK - 1) / BLOCK;
  init_hist<<<(int)(want < 1 ? 1 : (want < cap ? want : cap)), BLOCK, 0, s>>>(*a);
  LAUNCH_CHECK();
  plan_passes<<<1, 32, 0, s>>>(*a);
  LAUNCH_CHECK();
  if (a->n_tiles > 0) {
    for (int p = 0; p < 4 * a->n_words; ++p) {
      tile_hist<<<(unsigned)a->n_tiles, BLOCK, 0, s>>>(*a, p);
      LAUNCH_CHECK();
      digit_scan<<<RADIX, SCAN_BLOCK, 0, s>>>(*a, p);
      LAUNCH_CHECK();
      tile_scatter<<<(unsigned)a->n_tiles, BLOCK, 0, s>>>(*a, p);
      LAUNCH_CHECK();
    }
  }
  want = (a->n + BLOCK - 1) / BLOCK;
  epilogue<<<(int)(want < cap ? want : cap), BLOCK, 0, s>>>(*a);
  LAUNCH_CHECK();
  return 0;
}

const char* merge_dedup_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
