// Live-window ring fold and gather for Hopper.
//
// Replaces the JAX package's jitted device programs (B6)
//   horaedb_tpu/ops/livewindow.py:45  _fold_body    reset the reused ring slots, then
//                                                   scatter count/sum/min/max at
//                                                   (slot, grp) and the counter
//                                                   increment at (pair_slot, pair_grp)
//   horaedb_tpu/ops/livewindow.py:64  _gather_body  ring rows by slot, all five planes
//
// Layout: one buffer per state, [5][depth][cap] 32-bit words. Plane 0 holds
// the counts (int32); planes 1-4 the sums, mins, maxs and counter
// increments (f32). The reference returns new arrays; here the fold updates
// the buffer IN PLACE, and the gather writes one contiguous [5][n][g] output
// so a read is one device-to-host copy.
//
// Fold = ONE launch a commit for every state of a table (ring_fold): a
// descriptor a state gives its ring, its packed words, its reset slots,
// rows and counter pairs. The launch
//   1. resets the reused slots of every state (when any state names one):
//      each cell goes back to (0, 0, +inf, -inf, 0);
//   2. waits at a grid-wide barrier, so no row lands in a slot before the
//      slot is reset;
//   3. scatters the rows, then the counter pairs: every state's rows are cut
//      into runs of a shared length (a multiple of 32), one warp a run. Each
//      lane loads one row per 32-row step; a step whose valid rows all land
//      on one cell is reduced with shuffles and carried in registers while
//      the next steps stay on that cell (one commit per run); the rows of a
//      mixed step commit lane by lane. Commits are atomicAdd for count, sum
//      and inc; min and max go through a CAS loop on the float bits (NaN
//      propagates, -0.0 is the min and +0.0 the max of {-0.0, +0.0}, as the
//      reference's scatter gives them). A commit per row would serialise a
//      hot cell on its atomics and round its f32 sum once per row: at 2^20
//      rows on one cell that drifts past SUM_RTOL of the sum of |x|; one
//      commit per run keeps it inside.
// The barrier is two counter words of the launch's own input (zeroed by the
// host's copy, and again by the last block to leave it), so launches never
// share it; the launch is cooperative when
// it resets, so every block is resident and the barrier cannot hang. The
// other way to order the reset, a split that needs no order (a block that
// resets a slot scatters the rows landing in it), would put a head-advance
// commit's rows, which all land in the new slot, on one block a state, or
// make each block re-read its state's rows; a commit of 4000 rows a state
// fills about 80 blocks, so one barrier costs less.
// Indices follow the reference's scatter: an index in [-extent, -1] wraps
// once (Python style); any other index outside [0, extent) drops the row.
// slot == depth is how the state layer masks rows that must not fold.
// The gather clamps instead, as the reference's gather does: an index
// below zero wraps once, then every index is clamped into [0, depth - 1].
//
// What bounds the fold: bytes, and at a commit's size launch latency. A
// commit of a few thousand rows a state moves a few hundred kilobytes (12 B
// a row in, 4 planes read and written per touched cell), microseconds at
// 3.35 TB/s. Before, each state folded on its own: a reset launch and a
// scatter launch of 16 blocks (one 32-row step a warp), ten launches a
// head-advance commit of five states, each mostly the fixed cost of a
// launch; now one launch carries the work of every state.
//
// Gather = a copy of 5 * n rows of g contiguous words (ring row (p, s) to
// output row (p, r)), bound by bytes: a refresh's 60 slots x 4000 groups
// read and write 9.6 MB, 2.9 us at 3.35 TB/s, so at this size the launch
// and the ramp of the first loads count too. The design spends its
// instructions on bytes and none on index arithmetic: a block copies one
// chunk of one output row (no division a word), reads and clamps its slot
// once, moves 16 bytes a thread a load and a store (int4) when the ring's
// cap, g and both bases allow it (a 4-byte path in the same kernel
// otherwise), keeps four such loads in flight a thread before it stores,
// reads the ring through the read-only path and streams the output past
// the caches (it is read once, by the copy to the host). A chunk is 8 KB
// on the 16-byte path, so the main path's 300 rows of 16 KB are 600 blocks
// of 128 threads, all resident at once on 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BLOCK 256
#define PLANES 5
#define FULL_MASK 0xffffffffu
// the scatter's grid: 2 blocks (16 warps) per SM at most, so 2^20 rows on one
// cell take about two thousand commits, not a million
#define SCATTER_BLOCKS_PER_SM 2

#define FOLD_MAX_STATES 32  // states of one ring_fold launch

// one state of a fold launch; the host fills rings to cap, the launcher the rest
struct FoldState {
  int32_t* rings;        // [PLANES][depth][cap]
  const int32_t* in;     // reset slots [n_reset], then slot, grp, val bits [n_rows] each,
                         // then pair_slot, pair_grp, pair_delta bits [n_pairs] each
  int n_reset;
  int n_rows;
  int n_pairs;
  int depth;
  int cap;
  int row_warp0;         // the first warp of the state's rows, and of its pairs
  int pair_warp0;
  int pad_;
  long long reset0;      // the state's first cell in the launch's reset cells
};

struct FoldArgs {
  FoldState s[FOLD_MAX_STATES];
  unsigned int* barrier; // two zeroed words of the launch's input
  long long n_reset_cells;
  int n_states;
  int row_chunk;         // rows (and pairs) a warp, a multiple of 32
  int pair_chunk;
  int row_warps;
  int pair_warps;
  int device;
};

struct GatherArgs {
  const int32_t* rings;  // [PLANES][depth][cap]
  const int32_t* idx;    // [n] ring slots
  int32_t* out;          // [PLANES][n][g]
  long long n;
  int depth;
  int cap;
  int g;                 // leading group columns to gather (g <= cap)
  int device;
  int vec;               // the launcher's: 1 for the 16-byte path
  int chunks;            // the launcher's: blocks an output row
};

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

// the reference's scatter index rule: wrap [-extent, -1] once, drop the rest
__device__ __forceinline__ bool scatter_index(int& i, int extent) {
  if (i < 0) i += extent;
  return i >= 0 && i < extent;
}

// the last state whose first item (at ``off``) is at or below ``x``
template <typename F>
__device__ __forceinline__ int state_at(const FoldArgs& a, long long x, F off) {
  int k = 0;
  while (k + 1 < a.n_states && off(a.s[k + 1]) <= x) ++k;
  return k;
}

__device__ __forceinline__ void reset_cells(const FoldArgs& a) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n_reset_cells;
       i += (long long)gridDim.x * blockDim.x) {
    const FoldState& st = a.s[state_at(a, i, [](const FoldState& t) { return t.reset0; })];
    const long long c = i - st.reset0;
    const int s = st.in[c / st.cap];
    if (s < 0 || s >= st.depth) continue;
    const long long plane = (long long)st.depth * st.cap;
    const long long o = (long long)s * st.cap + c % st.cap;
    float* f = reinterpret_cast<float*>(st.rings);
    st.rings[o] = 0;
    f[plane + o] = 0.0f;
    f[2 * plane + o] = INFINITY;
    f[3 * plane + o] = -INFINITY;
    f[4 * plane + o] = 0.0f;
  }
}

// every block of the launch arrives before any leaves (all resident: the
// launch is cooperative); the fences make the resets visible to the
// commits. count[0] counts arrivals, count[1] departures; the last block to
// leave zeroes both, so the same input folds again (a replay) as it did.
__device__ __forceinline__ void grid_barrier(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&count[0], 1u);
    while (*(volatile unsigned int*)&count[0] < gridDim.x) __nanosleep(64);
    __threadfence();
    if (atomicAdd(&count[1], 1u) == gridDim.x - 1) {
      count[0] = 0;
      count[1] = 0;
    }
  }
  __syncthreads();
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

struct Planes {
  int32_t* counts;
  float* sums;
  float* mins;
  float* maxs;
  float* inc;
};

// one commit of a run (or a row): ROWS into count/sum/min/max, pairs into inc
template <bool ROWS>
__device__ __forceinline__ void commit(const Planes& p, long long cell, int cnt, float s,
                                       float mn, float mx) {
  if (cell < 0 || cnt == 0) return;
  if (ROWS) {
    atomicAdd(&p.counts[cell], cnt);
    atomicAdd(&p.sums[cell], s);
    atomic_extreme<true>(&p.mins[cell], mn);
    atomic_extreme<false>(&p.maxs[cell], mx);
  } else {
    atomicAdd(&p.inc[cell], s);
  }
}

// rows [begin, end) of one state, by one warp
template <bool ROWS>
__device__ void scatter_runs(const Planes& p, const int32_t* slot, const int32_t* grp,
                             const float* val, long long begin, long long end, int depth,
                             int cap) {
  const int lane = threadIdx.x & 31;

  long long run_cell = -1;  // lane 0 carries the run
  int run_cnt = 0;
  float run_sum = 0.f, run_min = INFINITY, run_max = -INFINITY;

  for (long long base = begin; base < end; base += 32) {
    const long long r = base + lane;
    long long cell = -1;
    float v = 0.f;
    if (r < end) {
      int s = slot[r], g = grp[r];
      if (scatter_index(s, depth) && scatter_index(g, cap)) {
        cell = (long long)s * cap + g;
        v = val[r];
      }
    }
    const bool valid = cell >= 0;
    const unsigned vmask = __ballot_sync(FULL_MASK, valid);
    if (vmask == 0) continue;
    const long long cell0 = __shfl_sync(FULL_MASK, cell, __ffs(vmask) - 1);
    if (__all_sync(FULL_MASK, !valid || cell == cell0)) {
      const float s = warp_sum(valid ? v : 0.f);
      const float mn = ROWS ? warp_min(valid ? v : INFINITY) : 0.f;
      const float mx = ROWS ? warp_max(valid ? v : -INFINITY) : 0.f;
      if (lane == 0) {
        if (cell0 != run_cell) {
          commit<ROWS>(p, run_cell, run_cnt, run_sum, run_min, run_max);
          run_cell = cell0;
          run_cnt = 0;
          run_sum = 0.f;
          run_min = INFINITY;
          run_max = -INFINITY;
        }
        run_cnt += __popc(vmask);
        run_sum += s;
        run_min = fmin_t(run_min, mn);
        run_max = fmax_t(run_max, mx);
      }
    } else if (valid) {
      commit<ROWS>(p, cell, 1, v, v, v);
    }
  }
  if (lane == 0) commit<ROWS>(p, run_cell, run_cnt, run_sum, run_min, run_max);
}

__device__ __forceinline__ Planes planes_of(const FoldState& st) {
  const long long plane = (long long)st.depth * st.cap;
  float* f = reinterpret_cast<float*>(st.rings);
  return Planes{st.rings, f + plane, f + 2 * plane, f + 3 * plane, f + 4 * plane};
}

__global__ void __launch_bounds__(BLOCK) ring_fold(const __grid_constant__ FoldArgs a) {
  if (a.n_reset_cells > 0) {
    reset_cells(a);
    grid_barrier(a.barrier);
  }
  const int warp = (int)(((long long)blockIdx.x * BLOCK + threadIdx.x) >> 5);
  if (warp < a.row_warps) {
    const FoldState& st = a.s[state_at(a, warp, [](const FoldState& t) { return (long long)t.row_warp0; })];
    const int32_t* slot = st.in + st.n_reset;
    const int32_t* grp = slot + st.n_rows;
    const float* val = reinterpret_cast<const float*>(grp + st.n_rows);
    const long long begin = (long long)(warp - st.row_warp0) * a.row_chunk;
    scatter_runs<true>(planes_of(st), slot, grp, val, begin,
                       min(begin + a.row_chunk, (long long)st.n_rows), st.depth, st.cap);
  }
  if (warp < a.pair_warps) {
    const FoldState& st = a.s[state_at(a, warp, [](const FoldState& t) { return (long long)t.pair_warp0; })];
    const int32_t* pslot = st.in + st.n_reset + 3LL * st.n_rows;
    const int32_t* pgrp = pslot + st.n_pairs;
    const float* pdelta = reinterpret_cast<const float*>(pgrp + st.n_pairs);
    const long long begin = (long long)(warp - st.pair_warp0) * a.pair_chunk;
    scatter_runs<false>(planes_of(st), pslot, pgrp, pdelta, begin,
                        min(begin + a.pair_chunk, (long long)st.n_pairs), st.depth, st.cap);
  }
}

#define GATHER_BLOCK 128
#define GATHER_UNROLL 4  // loads in flight a thread
// words a block copies: GATHER_UNROLL loads of int4 (or int32) a thread
#define GATHER_CHUNK_VEC (GATHER_BLOCK * GATHER_UNROLL * 4)
#define GATHER_CHUNK_WORD (GATHER_BLOCK * GATHER_UNROLL)

// ``len`` elements from src to dst, GATHER_UNROLL loads a thread issued
// before the first store
template <typename W>
__device__ __forceinline__ void copy_chunk(const W* __restrict__ src, W* __restrict__ dst,
                                           int len) {
  const int t = threadIdx.x;
  W v[GATHER_UNROLL];
#pragma unroll
  for (int u = 0; u < GATHER_UNROLL; ++u) {
    const int i = t + u * GATHER_BLOCK;
    if (i < len) v[u] = __ldg(src + i);
  }
#pragma unroll
  for (int u = 0; u < GATHER_UNROLL; ++u) {
    const int i = t + u * GATHER_BLOCK;
    if (i < len) __stcs(dst + i, v[u]);
  }
}

// one chunk of one output row a block: blockIdx.x = row * chunks + chunk,
// row = p * n + r
__global__ void __launch_bounds__(GATHER_BLOCK) ring_gather_rows(const GatherArgs a) {
  const long long row = blockIdx.x / a.chunks;
  const int chunk = (int)(blockIdx.x - row * a.chunks);
  const long long p = row / a.n;
  const long long r = row - p * a.n;
  int s = __ldg(a.idx + r);
  if (s < 0) s += a.depth;
  s = s < 0 ? 0 : (s >= a.depth ? a.depth - 1 : s);
  const int32_t* src = a.rings + (p * a.depth + s) * a.cap;
  int32_t* dst = a.out + row * a.g;
  if (a.vec) {
    const int c0 = chunk * (GATHER_CHUNK_VEC / 4);  // in int4
    copy_chunk(reinterpret_cast<const int4*>(src) + c0, reinterpret_cast<int4*>(dst) + c0,
               min(a.g / 4 - c0, GATHER_CHUNK_VEC / 4));
  } else {
    const int c0 = chunk * GATHER_CHUNK_WORD;
    copy_chunk(src + c0, dst + c0, min(a.g - c0, GATHER_CHUNK_WORD));
  }
}

extern "C" {

// struct sizes, so the ctypes mirrors can check their layout at load
int livewindow_abi(long long* sizes) {
  sizes[0] = sizeof(FoldArgs);
  sizes[1] = sizeof(GatherArgs);
  sizes[2] = PLANES;
  sizes[3] = FOLD_MAX_STATES;
  return 0;
}

// rows a warp so that every state's runs fit ``warps`` warps: a multiple of 32
static int chunk_for(long long total, int n_states, long long warps) {
  const long long room = warps - n_states > 1 ? warps - n_states : 1;
  long long c = (total + room - 1) / room;
  c = (c + 31) & ~31LL;
  return (int)(c < 32 ? 32 : c);
}

// One ring_fold launch over a->n_states states (the host fills each state's
// rings, in, n_reset, n_rows, n_pairs, depth and cap, and the barrier); the
// launcher lays out the reset cells and the warps, cooperatively when a
// state resets.
int livewindow_fold_launch(const FoldArgs* in, void* stream) {
  FoldArgs a = *in;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.n_states < 1 || a.n_states > FOLD_MAX_STATES || a.barrier == nullptr)
    return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a.device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_fold, BLOCK, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm > SCATTER_BLOCKS_PER_SM) per_sm = SCATTER_BLOCKS_PER_SM;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap_blocks = (long long)(sms > 0 ? sms : 1) * per_sm;
  const long long cap_warps = cap_blocks * (BLOCK / 32);
  long long rows = 0, pairs = 0, cells = 0;
  for (int k = 0; k < a.n_states; ++k) {
    FoldState& st = a.s[k];
    if (st.depth <= 0 || st.cap <= 0 || st.n_reset < 0 || st.n_rows < 0 || st.n_pairs < 0)
      return (int)cudaErrorInvalidValue;
    st.reset0 = cells;
    cells += (long long)st.n_reset * st.cap;
    rows += st.n_rows;
    pairs += st.n_pairs;
  }
  a.row_chunk = chunk_for(rows, a.n_states, cap_warps);
  a.pair_chunk = chunk_for(pairs, a.n_states, cap_warps);
  long long rw = 0, pw = 0;
  for (int k = 0; k < a.n_states; ++k) {
    FoldState& st = a.s[k];
    st.row_warp0 = (int)rw;
    st.pair_warp0 = (int)pw;
    rw += (st.n_rows + a.row_chunk - 1) / a.row_chunk;
    pw += (st.n_pairs + a.pair_chunk - 1) / a.pair_chunk;
  }
  a.row_warps = (int)rw;
  a.pair_warps = (int)pw;
  a.n_reset_cells = cells;
  long long warps = rw > pw ? rw : pw;
  long long grid = (warps + BLOCK / 32 - 1) / (BLOCK / 32);
  const long long reset_blocks = (cells + BLOCK - 1) / BLOCK;
  if (grid < reset_blocks) grid = reset_blocks;
  if (grid > cap_blocks) grid = cap_blocks;
  if (grid < 1) grid = 1;
  if (cells > 0) {
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)ring_fold, dim3((unsigned)grid), dim3(BLOCK),
                                      params, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    ring_fold<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// One ring_gather_rows launch: the 16-byte path when cap, g and both bases
// are multiples of 16 bytes; each output row cut into chunks of one block.
int livewindow_gather_launch(const GatherArgs* in, void* stream) {
  GatherArgs a = *in;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.n <= 0 || a.depth <= 0 || a.g <= 0 || a.g > a.cap) return (int)cudaErrorInvalidValue;
  a.vec = a.cap % 4 == 0 && a.g % 4 == 0 && (uintptr_t)a.rings % 16 == 0 &&
          (uintptr_t)a.out % 16 == 0;
  const int chunk = a.vec ? GATHER_CHUNK_VEC : GATHER_CHUNK_WORD;
  a.chunks = (a.g + chunk - 1) / chunk;
  const long long blocks = (long long)PLANES * a.n * a.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ring_gather_rows<<<(unsigned)blocks, GATHER_BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* livewindow_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
