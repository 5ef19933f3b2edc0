// Fused scan / filter / time-bucket / group-by / aggregate for Hopper.
//
// Replaces the JAX package's jitted device programs
//   horaedb_tpu/ops/scan_agg.py  scan_agg_body / _fused_scan_agg        (B1a)
//   horaedb_tpu/ops/scan_agg.py  _packed_body / cached_scan_agg_packed   (B1b)
//   horaedb_tpu/ops/scan_agg.py  cached_scan_agg_body                   (B1c)
//   horaedb_tpu/ops/scan_agg.py  _single_segment_agg, _scatter_segment_agg,
//                                _mxu_counts / _mxu_segment_agg          (B2a-c)
//   horaedb_tpu/ops/encoding.py  unpack_bits, decode_series/ts/value,
//                                decode_layouts                          (B3)
//
// Two entry points share one reduction core:
//   scan_agg_direct  rows of a host-built padded batch (group code, bucket
//                    id, mask, values[F, N]);
//   scan_agg_cached  rows of the resident scan cache: the prologue decodes
//                    each row's series code, timestamp and values from the
//                    resident layout (raw, bf16, delta, dict, dict codes) in
//                    registers, applies the session allow list, the time
//                    range and the numeric filters, then buckets and groups.
//                    SELECTIVE reads row i from the index tail of ``dyn``.
//
// What bounds it: the bytes of the resident columns (one pass over codes,
// timestamps and the touched value columns), or for small selective scans
// the launch itself. The design keeps every decoded value in registers and
// cuts atomics: each warp walks a contiguous run of rows (the cache is
// sorted by series and time, so neighbouring rows mostly share a segment),
// reduces each 32-row step with shuffles, carries the running partial of
// the current segment in registers (lane f owns field f) and commits it
// only when the segment changes. Rows of a step that do not share one
// segment commit lane by lane.
//
// Reduction arms (template ARM):
//   single   n_seg == 1: partials meet in shared memory, one global atomic
//            per block and field;
//   shared   small n_seg: each block keeps count/sum/min/max of every
//            segment in shared memory and merges them with global atomics;
//   scatter  large n_seg: run partials go straight to global atomics.
// Counts are int32 atomicAdd, sums f32 atomicAdd. Min and max are exact
// and follow the reference's scatter arm: NaN propagates, and -0.0 < +0.0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_FIELDS 32
#define MAX_FILTERS 16
#define BLOCK 256
#define FULL_MASK 0xffffffffu

enum { ARM_SINGLE = 0, ARM_SHARED = 1, ARM_SCATTER = 2 };
// column layouts
enum { LAY_RAW = 0, LAY_BF16 = 1, LAY_DICT = 2, LAY_CODES = 3, LAY_DELTA = 4, LAY_TSDICT = 5 };

struct Column {
  const void* data;  // raw values, bf16 bits, or the packed uint32 words
  const void* aux;   // dictionary (f32 or int32) or the delta block bases
  int kind;
  int width;         // bits per packed code
};

struct Out {
  int* counts;   // [n_seg]
  float* sums;   // [n_agg, n_seg]
  float* mins;   // [n_agg, n_seg] (unused unless minmax)
  float* maxs;
  int n_seg;
  int n_agg;
  int minmax;
  int pad_;
};

struct Filters {
  int n;
  int field[MAX_FILTERS];
  int op[MAX_FILTERS];
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

// ---- decode ----------------------------------------------------------------

__device__ __forceinline__ uint32_t unpack(const uint32_t* __restrict__ w, int width,
                                           long long i) {
  unsigned long long p = (unsigned long long)i * (unsigned)width;
  long long wi = (long long)(p >> 5);
  unsigned sh = (unsigned)(p & 31);
  uint32_t lo = w[wi] >> sh;
  // the stream carries a safety word, so w[wi + 1] is always readable;
  // a shift by 32 is undefined, hence the sh == 0 guard
  uint32_t hi = sh ? (w[wi + 1] << (32 - sh)) : 0u;
  return (lo | hi) & ((1u << width) - 1u);
}

__device__ __forceinline__ float load_value(const Column& c, long long i) {
  switch (c.kind) {
    case LAY_RAW:
      return ((const float*)c.data)[i];
    case LAY_BF16:
      return __uint_as_float(((uint32_t)((const uint16_t*)c.data)[i]) << 16);
    case LAY_DICT:
      return ((const float*)c.aux)[unpack((const uint32_t*)c.data, c.width, i)];
    default:  // LAY_CODES: filter-only dictionary field, compared in code space
      return (float)unpack((const uint32_t*)c.data, c.width, i);
  }
}

__device__ __forceinline__ int load_int(const Column& c, long long i) {
  switch (c.kind) {
    case LAY_RAW:
      return ((const int*)c.data)[i];
    case LAY_DELTA:
      return (int)((uint32_t)((const int*)c.aux)[i >> 7] +
                    unpack((const uint32_t*)c.data, c.width, i));
    default:  // LAY_TSDICT
      return ((const int*)c.aux)[unpack((const uint32_t*)c.data, c.width, i)];
  }
}

__device__ __forceinline__ bool compare(float v, int op, float lit) {
  switch (op) {
    case 0: return v == lit;
    case 1: return v != lit;
    case 2: return v < lit;
    case 3: return v <= lit;
    case 4: return v > lit;
    default: return v >= lit;
  }
}

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

struct DirectSource {
  const DirectArgs& a;
  __device__ DirectSource(const DirectArgs& args) : a(args) {}
  // true when row r passes; sets its segment and the row to read values at
  __device__ __forceinline__ bool row(long long r, int& seg, long long& i) const {
    i = r;
    if (!a.mask[r]) return false;
    for (int k = 0; k < a.filt.n; ++k) {
      float v = a.values[(long long)a.filt.field[k] * a.n_rows + r];
      if (!compare(v, a.filt.op[k], a.literals[k])) return false;
    }
    seg = a.group_codes[r] * a.n_buckets + a.bucket_ids[r];
    return seg >= 0 && seg < a.out.n_seg;  // out-of-range ids drop, as in a scatter
  }
  __device__ __forceinline__ float value(int f, long long i) const {
    return a.values[(long long)f * a.n_rows + i];
  }
};

template <bool SELECTIVE>
struct CachedSource {
  const CachedArgs& a;
  int lo, hi, t0, width;
  __device__ CachedSource(const CachedArgs& args) : a(args) {
    const int nf = a.filt.n;
    lo = a.dyn[nf];
    hi = a.dyn[nf + 1];
    t0 = a.dyn[nf + 2];
    width = a.dyn[nf + 3];
  }
  __device__ __forceinline__ bool row(long long r, int& seg, long long& i) const {
    const int nf = a.filt.n;
    i = SELECTIVE ? (long long)a.dyn[nf + 4 + r] : r;
    int code = load_int(a.series, i);
    if (a.session[a.s1 + code] == 0) return false;
    int ts = load_int(a.ts, i);
    if (!(ts >= lo && ts < hi)) return false;
    for (int k = 0; k < nf; ++k) {
      float v = load_value(a.fields[a.filt.field[k]], i);
      if (!compare(v, a.filt.op[k], __int_as_float(a.dyn[k]))) return false;
    }
    seg = a.session[code] * a.n_buckets + bucket_of(ts, t0, width, a.n_buckets);
    return seg >= 0 && seg < a.out.n_seg;
  }
  __device__ __forceinline__ float value(int f, long long i) const {
    return load_value(a.fields[f], i);
  }
};

// ---- reduction core --------------------------------------------------------

struct Target {
  int* counts;
  float* sums;
  float* mins;
  float* maxs;
  int n_seg;
};

// commit one run partial: lane 0 the count, lane f field f
__device__ __forceinline__ void commit(const Target& t, int seg, int cnt, float s, float mn,
                                       float mx, int lane, int n_agg, bool minmax) {
  if (seg < 0 || cnt == 0) return;
  if (lane == 0) atomicAdd(&t.counts[seg], cnt);
  if (lane < n_agg) {
    long long o = (long long)lane * t.n_seg + seg;
    atomicAdd(&t.sums[o], s);
    if (minmax) {
      atomic_extreme<true>(&t.mins[o], mn);
      atomic_extreme<false>(&t.maxs[o], mx);
    }
  }
}

template <int ARM, class Src>
__device__ void reduce_rows(const Src& src, long long n_rows, const Out& out, const Target& t) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * BLOCK + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * BLOCK) >> 5;
  // a contiguous run of rows per warp, a multiple of 32
  long long chunk = (n_rows + n_warps - 1) / n_warps;
  chunk = (chunk + 31) & ~31LL;
  const long long begin = warp * chunk;
  const long long end = min(begin + chunk, n_rows);
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
        commit(t, run_seg, run_cnt, run_sum, run_min, run_max, lane, n_agg, minmax);
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
      atomicAdd(&t.counts[seg], 1);
      for (int f = 0; f < n_agg; ++f) {
        const float v = src.value(f, i);
        const long long o = (long long)f * t.n_seg + seg;
        atomicAdd(&t.sums[o], v);
        if (minmax) {
          atomic_extreme<true>(&t.mins[o], v);
          atomic_extreme<false>(&t.maxs[o], v);
        }
      }
    }
  }
  commit(t, run_seg, run_cnt, run_sum, run_min, run_max, lane, n_agg, minmax);
}

template <int ARM, class Src>
__device__ void scan_agg(const Src& src, long long n_rows, const Out& out) {
  if (ARM == ARM_SCATTER) {
    Target t{out.counts, out.sums, out.mins, out.maxs, out.n_seg};
    reduce_rows<ARM>(src, n_rows, out, t);
    return;
  }
  // single / shared: block-private partials of every segment in shared memory
  extern __shared__ float smem[];
  const int n_seg = out.n_seg;
  const long long fs = (long long)out.n_agg * n_seg;
  Target t;
  t.counts = (int*)smem;
  t.sums = smem + n_seg;
  t.mins = t.sums + fs;
  t.maxs = t.mins + fs;
  t.n_seg = n_seg;
  for (long long k = threadIdx.x; k < n_seg; k += BLOCK) t.counts[k] = 0;
  for (long long k = threadIdx.x; k < fs; k += BLOCK) {
    t.sums[k] = 0.f;
    if (out.minmax) {
      t.mins[k] = INFINITY;
      t.maxs[k] = -INFINITY;
    }
  }
  __syncthreads();
  reduce_rows<ARM>(src, n_rows, out, t);
  __syncthreads();
  for (int s = threadIdx.x; s < n_seg; s += BLOCK) {
    const int c = t.counts[s];
    if (c == 0) continue;
    atomicAdd(&out.counts[s], c);
    for (int f = 0; f < out.n_agg; ++f) {
      const long long o = (long long)f * n_seg + s;
      atomicAdd(&out.sums[o], t.sums[o]);
      if (out.minmax) {
        atomic_extreme<true>(&out.mins[o], t.mins[o]);
        atomic_extreme<false>(&out.maxs[o], t.maxs[o]);
      }
    }
  }
}

template <int ARM>
__global__ void __launch_bounds__(BLOCK) scan_agg_direct(const __grid_constant__ DirectArgs a) {
  DirectSource src(a);
  scan_agg<ARM>(src, a.n_rows, a.out);
}

template <int ARM, bool SELECTIVE>
__global__ void __launch_bounds__(BLOCK) scan_agg_cached(const __grid_constant__ CachedArgs a) {
  CachedSource<SELECTIVE> src(a);
  scan_agg<ARM>(src, a.n_rows, a.out);
}

// ---- host launch (plain C interface, loaded with ctypes) --------------------

static size_t smem_bytes(int arm, const Out& out) {
  if (arm == ARM_SCATTER) return 0;
  const size_t planes = out.minmax ? 3 : 1;
  return ((size_t)out.n_seg * (1 + planes * (size_t)out.n_agg)) * sizeof(float);
}

template <class K>
static cudaError_t launch(K kernel, int arm, int device, long long n_rows, const Out& out,
                          cudaStream_t stream, const void* args) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(arm, out);
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
  // enough rows per warp that the carried run partial pays off
  long long want = (n_rows + BLOCK * 8 - 1) / (BLOCK * 8);
  long long cap = (long long)sms * per_sm;
  int grid = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  void* params[] = {(void*)args};
  err = cudaLaunchKernel((const void*)kernel, dim3(grid), dim3(BLOCK), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  return 0;
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
  }
  return cudaErrorInvalidValue;
}

int scan_agg_cached_launch(const CachedArgs* a, int arm, int selective, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (selective) {
    switch (arm) {
      case ARM_SINGLE:
        return launch(scan_agg_cached<ARM_SINGLE, true>, arm, a->device, a->n_rows, a->out, s, a);
      case ARM_SHARED:
        return launch(scan_agg_cached<ARM_SHARED, true>, arm, a->device, a->n_rows, a->out, s, a);
      case ARM_SCATTER:
        return launch(scan_agg_cached<ARM_SCATTER, true>, arm, a->device, a->n_rows, a->out, s, a);
    }
  } else {
    switch (arm) {
      case ARM_SINGLE:
        return launch(scan_agg_cached<ARM_SINGLE, false>, arm, a->device, a->n_rows, a->out, s, a);
      case ARM_SHARED:
        return launch(scan_agg_cached<ARM_SHARED, false>, arm, a->device, a->n_rows, a->out, s, a);
      case ARM_SCATTER:
        return launch(scan_agg_cached<ARM_SCATTER, false>, arm, a->device, a->n_rows, a->out, s, a);
    }
  }
  return cudaErrorInvalidValue;
}

const char* scan_agg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
