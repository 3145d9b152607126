// Device code shared by the fingerprint kernels (block_fp.cu and
// block_gather.cu): the dtype codes, the per-element squares, and the
// fingerprint of one block by one CTA of FP_THREADS threads.
//
// The reduction order is fixed (per-thread sequential over its strided
// vectors, an xor-shuffle tree inside each warp, then warp 0 folding the
// per-warp partials in lane order; no atomics), so both kernels give the
// same float sum of squares for the same block, bit for bit, in every run.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define FP_THREADS 256

enum FpDtype {
  FP_F32 = 0,
  FP_BF16 = 1,
  FP_F16 = 2,
  FP_I32 = 3,
  FP_U8 = 4,
  FP_I8 = 5,
  FP_I64 = 6,
  FP_F64 = 7,
  FP_I16 = 8,
};

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float f16_bits_to_float(uint32_t bits16) {
  unsigned short h = (unsigned short)bits16;
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(h));
  return f;
}

// Sum of squares of the elements held in one little-endian 32-bit word
// (dtypes of itemsize <= 4).
__device__ __forceinline__ float word_sumsq(uint32_t w, int dtype) {
  float s = 0.f;
  switch (dtype) {
    case FP_F32: {
      float x = __uint_as_float(w);
      s = x * x;
      break;
    }
    case FP_I32: {
      float x = (float)(int32_t)w;
      s = x * x;
      break;
    }
    case FP_BF16: {
      float a = bf16_bits_to_float(w & 0xFFFFu);
      float b = bf16_bits_to_float(w >> 16);
      s = a * a;
      s += b * b;
      break;
    }
    case FP_F16: {
      float a = f16_bits_to_float(w & 0xFFFFu);
      float b = f16_bits_to_float(w >> 16);
      s = a * a;
      s += b * b;
      break;
    }
    case FP_I16: {
      float a = (float)(int16_t)(w & 0xFFFFu);
      float b = (float)(int16_t)(w >> 16);
      s = a * a;
      s += b * b;
      break;
    }
    case FP_U8: {
      for (int j = 0; j < 4; ++j) {
        float a = (float)((w >> (8 * j)) & 0xFFu);
        s += a * a;
      }
      break;
    }
    case FP_I8: {
      for (int j = 0; j < 4; ++j) {
        float a = (float)(int8_t)((w >> (8 * j)) & 0xFFu);
        s += a * a;
      }
      break;
    }
    default:
      break;
  }
  return s;
}

// Sum of squares of an 8-byte element given as two words (lo, hi).
__device__ __forceinline__ float dword_sumsq(uint32_t lo, uint32_t hi,
                                             int dtype) {
  unsigned long long bits = ((unsigned long long)hi << 32) | lo;
  float x = 0.f;
  if (dtype == FP_I64) x = (float)(long long)bits;
  if (dtype == FP_F64) x = (float)__longlong_as_double((long long)bits);
  return x * x;
}

__device__ __forceinline__ float vec_sumsq(uint4 w, int dtype) {
  if (dtype == FP_I64 || dtype == FP_F64) {
    float s = dword_sumsq(w.x, w.y, dtype);
    s += dword_sumsq(w.z, w.w, dtype);
    return s;
  }
  float s = word_sumsq(w.x, dtype);
  s += word_sumsq(w.y, dtype);
  s += word_sumsq(w.z, dtype);
  s += word_sumsq(w.w, dtype);
  return s;
}

// Element e of itemsize `isz` at an itemsize-aligned address.
__device__ __forceinline__ float elem_sq(const unsigned char* p, int dtype) {
  switch (dtype) {
    case FP_F32: {
      float x = *reinterpret_cast<const float*>(p);
      return x * x;
    }
    case FP_I32: {
      float x = (float)*reinterpret_cast<const int32_t*>(p);
      return x * x;
    }
    case FP_BF16: {
      float x = bf16_bits_to_float(*reinterpret_cast<const uint16_t*>(p));
      return x * x;
    }
    case FP_F16: {
      float x = f16_bits_to_float(*reinterpret_cast<const uint16_t*>(p));
      return x * x;
    }
    case FP_I16: {
      float x = (float)*reinterpret_cast<const int16_t*>(p);
      return x * x;
    }
    case FP_U8: {
      float x = (float)*p;
      return x * x;
    }
    case FP_I8: {
      float x = (float)*reinterpret_cast<const int8_t*>(p);
      return x * x;
    }
    case FP_I64: {
      float x = (float)*reinterpret_cast<const long long*>(p);
      return x * x;
    }
    case FP_F64: {
      float x = (float)*reinterpret_cast<const double*>(p);
      return x * x;
    }
    default:
      return 0.f;
  }
}

// Fingerprint of one block: `valid` bytes at `base` (0 <= valid <=
// block_bytes), zero-padded to `block_bytes`.  Called by all FP_THREADS
// threads of a CTA; the results are valid in thread 0 only.
__device__ __forceinline__ void fp_block(const unsigned char* base,
                                         long long valid,
                                         long long block_bytes, int dtype,
                                         int itemsize, uint32_t* s1_out,
                                         uint32_t* s2_out, float* ss_out) {
  uint32_t s1 = 0u, s2 = 0u;
  float ss = 0.f;
  const bool vec = (block_bytes % 16 == 0) && (valid == block_bytes) &&
                   ((reinterpret_cast<uintptr_t>(base) & 15u) == 0);
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(base);
    const long long nv = block_bytes / 16;
    for (long long k = threadIdx.x; k < nv; k += FP_THREADS) {
      const uint4 w = __ldg(v + k);
      const uint32_t i1 = (uint32_t)(4 * k) + 1u;
      s1 += w.x + w.y + w.z + w.w;
      s2 += w.x * i1 + w.y * (i1 + 1u) + w.z * (i1 + 2u) + w.w * (i1 + 3u);
      ss += vec_sumsq(w, dtype);
    }
  } else {
    const long long nw = block_bytes / 4;
    for (long long k = threadIdx.x; k < nw; k += FP_THREADS) {
      uint32_t w = 0u;
      for (int j = 0; j < 4; ++j) {
        const long long p = 4 * k + j;
        if (p < valid) w |= (uint32_t)base[p] << (8 * j);
      }
      s1 += w;
      s2 += w * (uint32_t)(k + 1);
    }
    const long long ne = valid / itemsize;
    for (long long e = threadIdx.x; e < ne; e += FP_THREADS) {
      ss += elem_sq(base + e * itemsize, dtype);
    }
  }

  // Fixed-order block reduction: xor-shuffle tree inside each warp, then
  // warp 0 folds the per-warp partials in lane order.
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  __shared__ uint32_t w1[FP_THREADS / 32];
  __shared__ uint32_t w2[FP_THREADS / 32];
  __shared__ float wss[FP_THREADS / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    w1[warp] = s1;
    w2[warp] = s2;
    wss[warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    const bool have = lane < FP_THREADS / 32;
    s1 = have ? w1[lane] : 0u;
    s2 = have ? w2[lane] : 0u;
    ss = have ? wss[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (lane == 0) {
      *s1_out = s1;
      *s2_out = s2;
      *ss_out = ss;
    }
  }
}
