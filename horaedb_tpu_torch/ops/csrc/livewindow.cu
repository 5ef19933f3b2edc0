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
// Fold = two launches on the caller's stream, in this order:
//   ring_reset    only when the host's reset mask names a slot: every cell
//                 of those slots goes back to (0, 0, +inf, -inf, 0). One
//                 launch cannot order the reset before the scatter across
//                 blocks, so the reset is its own kernel, and stream order
//                 puts it first.
//   ring_scatter  the rows, then the counter pairs. Each lane loads one row
//                 per 32-row step; each warp walks a contiguous run of rows.
//                 A step whose valid rows all land on one cell is reduced
//                 with shuffles and carried in registers while the next
//                 steps stay on that cell (one commit per run); the rows of
//                 a mixed step commit lane by lane. Commits are atomicAdd
//                 for count, sum and inc; min and max go through a CAS loop
//                 on the float bits (NaN propagates, -0.0 is the min and
//                 +0.0 the max of {-0.0, +0.0}, as the reference's scatter
//                 gives them). A commit per row would serialise a hot cell
//                 on its atomics and round its f32 sum once per row: at
//                 2^20 rows on one cell that drifts past SUM_RTOL of the
//                 sum of |x|; one commit per run keeps it inside.
// Indices follow the reference's scatter: an index in [-extent, -1] wraps
// once (Python style); any other index outside [0, extent) drops the row.
// slot == depth is how the state layer masks rows that must not fold.
// The gather clamps instead, as the reference's gather does: an index
// below zero wraps once, then every index is clamped into [0, depth - 1].
//
// What bounds it: bytes, and at a commit's size launch latency. A commit of
// a few thousand rows moves a few hundred kilobytes (12 B a row in, 4 planes
// read and written per touched cell), microseconds at 3.35 TB/s; the two
// launches cost more than the work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BLOCK 256
#define PLANES 5
#define FULL_MASK 0xffffffffu
// the scatter's grid: 2 blocks (16 warps) per SM at most, so 2^20 rows on one
// cell take about two thousand commits, not a million
#define SCATTER_BLOCKS_PER_SM 2

struct FoldArgs {
  int32_t* rings;        // [PLANES][depth][cap]
  const int32_t* in;     // reset slots [n_reset], then slot, grp, val bits [n_rows] each,
                         // then pair_slot, pair_grp, pair_delta bits [n_pairs] each
  long long n_reset;
  long long n_rows;
  long long n_pairs;
  int depth;
  int cap;
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

__global__ void ring_reset(FoldArgs a) {
  const long long plane = (long long)a.depth * a.cap;
  const long long total = a.n_reset * a.cap;
  float* f = reinterpret_cast<float*>(a.rings);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    int s = a.in[i / a.cap];
    if (s < 0 || s >= a.depth) continue;
    const long long o = (long long)s * a.cap + i % a.cap;
    a.rings[o] = 0;
    f[plane + o] = 0.0f;
    f[2 * plane + o] = INFINITY;
    f[3 * plane + o] = -INFINITY;
    f[4 * plane + o] = 0.0f;
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

template <bool ROWS>
__device__ void scatter_runs(const Planes& p, const int32_t* slot, const int32_t* grp,
                             const float* val, long long n, int depth, int cap) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * BLOCK + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * BLOCK) >> 5;
  // a contiguous run of rows per warp, a multiple of 32
  long long chunk = (n + n_warps - 1) / n_warps;
  chunk = (chunk + 31) & ~31LL;
  const long long begin = warp * chunk;
  const long long end = min(begin + chunk, n);

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

__global__ void __launch_bounds__(BLOCK) ring_scatter(FoldArgs a) {
  const long long plane = (long long)a.depth * a.cap;
  float* f = reinterpret_cast<float*>(a.rings);
  const Planes p{a.rings, f + plane, f + 2 * plane, f + 3 * plane, f + 4 * plane};
  const int32_t* slot = a.in + a.n_reset;
  const int32_t* grp = slot + a.n_rows;
  const float* val = reinterpret_cast<const float*>(grp + a.n_rows);
  const int32_t* pslot = grp + 2 * a.n_rows;
  const int32_t* pgrp = pslot + a.n_pairs;
  const float* pdelta = reinterpret_cast<const float*>(pgrp + a.n_pairs);
  scatter_runs<true>(p, slot, grp, val, a.n_rows, a.depth, a.cap);
  scatter_runs<false>(p, pslot, pgrp, pdelta, a.n_pairs, a.depth, a.cap);
}

__global__ void ring_gather(GatherArgs a) {
  const long long per_plane = a.n * a.g;
  const long long total = PLANES * per_plane;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / per_plane;
    const long long r = (i / a.g) % a.n;
    const long long c = i % a.g;
    int s = a.idx[r];
    if (s < 0) s += a.depth;
    s = s < 0 ? 0 : (s >= a.depth ? a.depth - 1 : s);
    a.out[i] = a.rings[(p * a.depth + s) * a.cap + c];
  }
}

// blocks for ``work`` items, one per thread, at most per_sm blocks per SM
static int grid_for(long long work, int device, int per_sm, cudaError_t* err) {
  int sms = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long cap = (long long)(sms > 0 ? sms : 1) * per_sm;
  long long want = (work + BLOCK - 1) / BLOCK;
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

extern "C" {

// struct sizes, so the ctypes mirrors can check their layout at load
int livewindow_abi(long long* sizes) {
  sizes[0] = sizeof(FoldArgs);
  sizes[1] = sizeof(GatherArgs);
  sizes[2] = PLANES;
  return 0;
}

int livewindow_reset_launch(const FoldArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  if (a->n_reset <= 0 || a->depth <= 0 || a->cap <= 0) return (int)cudaErrorInvalidValue;
  int grid = grid_for(a->n_reset * a->cap, a->device, 16, &err);
  if (err != cudaSuccess) return (int)err;
  ring_reset<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int livewindow_scatter_launch(const FoldArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  if (a->depth <= 0 || a->cap <= 0 || a->n_rows < 0 || a->n_pairs < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = a->n_rows > a->n_pairs ? a->n_rows : a->n_pairs;
  int grid = grid_for(n, a->device, SCATTER_BLOCKS_PER_SM, &err);
  if (err != cudaSuccess) return (int)err;
  ring_scatter<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int livewindow_gather_launch(const GatherArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  if (a->n <= 0 || a->depth <= 0 || a->g <= 0 || a->g > a->cap) return (int)cudaErrorInvalidValue;
  int grid = grid_for(PLANES * a->n * a->g, a->device, 16, &err);
  if (err != cudaSuccess) return (int)err;
  ring_gather<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* livewindow_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
