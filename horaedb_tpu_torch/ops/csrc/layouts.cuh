// Resident column layouts of the scan cache, decoded in registers.
//
// Shared by the kernels that read the scan cache's columns where they live:
//   scan_agg.cu   the fused scan-aggregate's prologue (B3);
//   scan_topk.cu  the raw-read top-k and bounded selection (B4).
//
// Replaces the JAX package's horaedb_tpu/ops/encoding.py unpack_bits,
// decode_series, decode_ts and decode_value (their plain PyTorch versions
// are in horaedb_tpu_torch/ops/encoding.py). Layouts:
//   LAY_RAW     dense f32 values or int32 series codes / timestamps;
//   LAY_BF16    dense bf16 values;
//   LAY_DICT    bit-packed codes into a sorted f32 dictionary;
//   LAY_CODES   a dictionary field kept in code space (compared as codes);
//   LAY_DELTA   bit-packed offsets from one int32 base per 128-row block;
//   LAY_TSDICT  bit-packed codes into a sorted int32 dictionary.

#pragma once

#include <stdint.h>

#define MAX_FIELDS 32
#define MAX_FILTERS 16

enum { LAY_RAW = 0, LAY_BF16 = 1, LAY_DICT = 2, LAY_CODES = 3, LAY_DELTA = 4, LAY_TSDICT = 5 };

struct Column {
  const void* data;  // raw values, bf16 bits, or the packed uint32 words
  const void* aux;   // dictionary (f32 or int32) or the delta block bases
  int kind;
  int width;         // bits per packed code
};

// numeric filters: value field and op code (= != < <= > >=) per filter;
// the literals travel in the launch's dyn buffer as f32 bits
struct Filters {
  int n;
  int field[MAX_FILTERS];
  int op[MAX_FILTERS];
};

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
