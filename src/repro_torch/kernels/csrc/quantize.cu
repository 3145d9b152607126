// Blockwise int8 quantize and dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize/kernel.py:
// `quantize_blocks` (body `_quant_kernel`) and `dequantize_blocks` (body
// `_dequant_kernel`).  Every leaf is cut into blocks of 256 elements (the
// last one zero-padded); per block
//
//   scale = amax / 127          (IEEE division; 1 where it is 0)
//   q     = clamp(rint(x / scale), -127, 127)   (round half to even)
//   x'    = float(q) * scale    (dequantize; bf16 by round to nearest even)
//
// The bytes must equal the JAX package's host codec
// (`repro/checkpoint/workers.py`, `quantize_int8`), which computes in numpy
// float32: so both divisions are correctly rounded (`__fdiv_rn`), never a
// multiply by a reciprocal (the TPU kernel's `amax * (1/127)` is one ulp
// off numpy's in some blocks), and the scale is replaced by 1 where it is
// 0, as numpy's `where(scales == 0, 1, scales)` does (a denormal amax whose
// quotient underflows takes scale 1 there).  A block holding NaN gets a NaN
// scale, as `np.max` gives (`fmaxf` alone would drop the NaN); Inf gives an
// Inf scale.  Build without fast math: `__fdiv_rn` and `rintf` do not
// depend on it, but denormals must not be flushed.
//
// What bounds it: bytes.  Quantize reads each element once (4 B for f32,
// 2 B for bf16) and writes 1 B of q plus 4 B of scale per 256 elements;
// dequantize reads those and writes the element.  About 5 float operations
// an element against 67 TFLOP/s is far below the bytes' time at 3.35 TB/s:
// a full-width Yi-9B block optimizer unit (27 f32 leaves, 2.076 GB in,
// 0.527 GB out) takes at least 0.777 ms either way.
//
// What the design does about it:
// - One launch per unit (multi-tensor): the leaf table travels by value in
//   the kernel's parameter space, so no allocation and no host-to-device
//   copy precede the launch.
// - One warp per 256-element block, eight blocks a CTA: lane l holds the
//   eight neighbouring elements 8l .. 8l + 7, read with 16-byte loads (two
//   for f32, one for bf16) and written back as one 8-byte store of q, so
//   a warp moves its whole block in one or two instructions a lane; the
//   block's amax is a five-step shuffle reduction, with no shared memory
//   and no second pass.  A block that runs past the leaf's end, or a leaf
//   whose start is not on 16 bytes, takes the scalar path (the tail reads
//   as zeros; dequantize stops at the element count).
// - The outputs are written where their consumer wants them: q and scales
//   straight into the record layout of the save (q of a leaf, then its
//   scales), and on restore the dequantized values straight into the
//   destination leaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define QUANT_MAX_LEAVES 48
#define QUANT_BLOCK 256
#define QUANT_WARPS 8

struct QuantLeaf {
  void* x;               // the leaf: f32 (dtype 0) or bf16 (dtype 1)
  int8_t* q;             // n_blocks * 256 int8
  float* s;              // n_blocks float32 scales
  long long n;           // elements of the leaf
  long long first_block; // the leaf's first block in the launch
  int dtype;
  int pad;
};

struct QuantTable {
  QuantLeaf leaves[QUANT_MAX_LEAVES];
  int n;
};

__device__ __forceinline__ int find_leaf(const QuantTable& tab, long long b) {
  int l = 0;
  while (l + 1 < tab.n && tab.leaves[l + 1].first_block <= b) ++l;
  return l;
}

__device__ __forceinline__ bool aligned(const void* p, unsigned a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

__device__ __forceinline__ float load_x(const QuantLeaf& L, long long i) {
  if (L.dtype == 0) return static_cast<const float*>(L.x)[i];
  const uint16_t bits = static_cast<const uint16_t*>(L.x)[i];
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// The eight elements i0 .. i0 + 7 of the leaf (zeros past its end).
__device__ __forceinline__ void load8(const QuantLeaf& L, long long i0,
                                      bool vec, float v[8]) {
  if (vec && L.dtype == 0) {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(L.x) + i0);
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if (vec) {
    const uint4 r = *reinterpret_cast<const uint4*>(
        static_cast<const uint16_t*>(L.x) + i0);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = i0 + k < L.n ? load_x(L, i0 + k) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(QUANT_WARPS * 32)
quantize_kernel(const QuantTable tab, long long total_blocks) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);
  if (b >= total_blocks) return;
  const QuantLeaf L = tab.leaves[find_leaf(tab, b)];
  const long long lb = b - L.first_block;
  const long long base = lb * QUANT_BLOCK;
  const long long i0 = base + 8 * lane;
  const bool vec = base + QUANT_BLOCK <= L.n && aligned(L.x, 16);
  float v[8];
  load8(L, i0, vec, v);
  float amax = 0.f;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float a = fabsf(v[k]);
    nan |= (a != a);
    amax = fmaxf(amax, a);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (__any_sync(0xffffffffu, nan)) amax = __int_as_float(0x7fc00000);
  float scale = __fdiv_rn(amax, 127.0f);
  if (scale == 0.f) scale = 1.f;
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float r = rintf(__fdiv_rn(v[k], scale));
    r = fminf(fmaxf(r, -127.f), 127.f);
    const uint32_t byte =
        static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r)));
    packed[k >> 2] |= byte << (8 * (k & 3));
  }
  int8_t* q = L.q + i0;                 // q holds whole blocks
  if (aligned(q, 8)) {
    *reinterpret_cast<uint2*>(q) = make_uint2(packed[0], packed[1]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      q[k] = static_cast<int8_t>((packed[k >> 2] >> (8 * (k & 3))) & 0xFF);
    }
  }
  if (lane == 0) L.s[lb] = scale;
}

__global__ void __launch_bounds__(QUANT_WARPS * 32)
dequantize_kernel(const QuantTable tab, long long total_blocks) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);
  if (b >= total_blocks) return;
  const QuantLeaf L = tab.leaves[find_leaf(tab, b)];
  const long long lb = b - L.first_block;
  const long long base = lb * QUANT_BLOCK;
  const long long i0 = base + 8 * lane;
  const float s = L.s[lb];
  const int8_t* q = L.q + i0;
  float y[8];
  if (aligned(q, 8)) {
    const uint2 r = *reinterpret_cast<const uint2*>(q);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t w = k < 4 ? r.x : r.y;
      const int8_t qk = static_cast<int8_t>((w >> (8 * (k & 3))) & 0xFF);
      y[k] = static_cast<float>(qk) * s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = static_cast<float>(q[k]) * s;
  }
  if (base + QUANT_BLOCK <= L.n && aligned(L.x, 16)) {
    if (L.dtype == 0) {
      float4* p = reinterpret_cast<float4*>(static_cast<float*>(L.x) + i0);
      p[0] = make_float4(y[0], y[1], y[2], y[3]);
      p[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(L.x) + i0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (i0 + k >= L.n) break;
    if (L.dtype == 0) {
      static_cast<float*>(L.x)[i0 + k] = y[k];
    } else {
      static_cast<__nv_bfloat16*>(L.x)[i0 + k] = __float2bfloat16_rn(y[k]);
    }
  }
}

static int launch(bool quant, const QuantLeaf* leaves, int n,
                  long long total_blocks, void* stream) {
  if (n <= 0 || n > QUANT_MAX_LEAVES || total_blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  QuantTable tab;
  for (int i = 0; i < n; ++i) tab.leaves[i] = leaves[i];
  tab.n = n;
  const long long grid = (total_blocks + QUANT_WARPS - 1) / QUANT_WARPS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (quant) {
    quantize_kernel<<<(unsigned)grid, QUANT_WARPS * 32, 0,
                      (cudaStream_t)stream>>>(tab, total_blocks);
  } else {
    dequantize_kernel<<<(unsigned)grid, QUANT_WARPS * 32, 0,
                        (cudaStream_t)stream>>>(tab, total_blocks);
  }
  return (int)cudaGetLastError();
}

// Quantizes `n` leaves (n <= QUANT_MAX_LEAVES) holding `total_blocks`
// 256-element blocks in all; leaf i's blocks are first_block ..
// first_block + ceil(n_i / 256) - 1.  Returns the launch's cudaError_t.
extern "C" int quantize_launch(const QuantLeaf* leaves, int n,
                               long long total_blocks, void* stream) {
  return launch(true, leaves, n, total_blocks, stream);
}

// Dequantizes into the leaves' `x` (the same table; q and s are read).
extern "C" int dequantize_launch(const QuantLeaf* leaves, int n,
                                 long long total_blocks, void* stream) {
  return launch(false, leaves, n, total_blocks, stream);
}
