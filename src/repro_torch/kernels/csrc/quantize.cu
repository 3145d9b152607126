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
// Inf scale.  The quotient is clamped before it is rounded, which gives
// the same integer for every input (the bounds are integers) and sends a
// NaN quotient to -127, as clamping after `rintf` did.  Build without fast
// math: `__fdiv_rn` does not depend on it, but denormals must not be
// flushed.
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
//   copy precede the launch.  The wrapper builds it from integer offsets
//   into the record buffer (ops.py), with each leaf's first stage.
// - Quantize is persistent: a grid of as many CTAs as fit on the SMs (3 a
//   SM with the ring below) walks the unit's stages, CTA c taking stages
//   c, c + grid, ...  A stage is a run of up to 16 KiB of whole blocks of
//   one leaf (16 f32 or 32 bf16 blocks) and never straddles two leaves, so
//   a CTA finds a stage's leaf by moving a cursor forward through the
//   table's first stages.  One producer thread copies each stage with one
//   1-D bulk copy (`cp.async.bulk`, completing on an mbarrier) into a ring
//   of four 16 KiB slots: up to 64 KiB in flight per CTA, whatever the
//   dtype (the warp-per-block kernel this one replaced kept 1 KiB per
//   warp in flight for f32 and 512 B for bf16, with no prefetch).  Eight
//   consumer warps each take a run of 2 (f32) or 4 (bf16) consecutive
//   blocks of the stage, two at a time, a half-warp per block: lane l of
//   a half holds the 16 neighbouring elements 16l .. 16l + 15, read from
//   shared memory with 16-byte loads, and releases the slot as soon as
//   they are read (a proxy fence, then one arrive a warp on the slot's
//   mbarrier).  The block's amax is a four-step shuffle reduction within
//   the half (NaN carried by a ballot), q leaves as one 16-byte store a
//   lane and the warp's scales as one 8- or 16-byte store.
// - A leaf whose start is not on 16 bytes, and a leaf's zero-padded tail
//   block (a stage of its own), take the direct path: the same consumer
//   code reading the elements one by one from global memory (zeros past
//   the end), no bulk copy.
// - Dequantize keeps the first design: one warp per 256-element block,
//   eight blocks a CTA, lane l handling the elements 8l .. 8l + 7 (an
//   8-byte load of q, one or two 16-byte stores of the leaf), the block's
//   leaf found by a linear scan of the table's first blocks.
// - The outputs are written where their consumer wants them: q and scales
//   straight into the record layout of the save (q of a leaf, then its
//   scales), and on restore the dequantized values straight into the
//   destination leaf.
//
// ptxas (sm_90a, -O3), registers per thread, no spills: quantize_kernel
// 72 (so 3 CTAs of 288 threads an SM, as the 64 KiB ring also allows),
// dequantize_kernel 31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define QUANT_MAX_LEAVES 48
#define QUANT_BLOCK 256
#define QUANT_WARPS 8             // dequantize: blocks (warps) a CTA
#define QUANT_STAGE_BYTES 16384   // quantize: bytes of leaf a stage
#define QUANT_SLOTS 4             // quantize: stages in flight a CTA
#define QUANT_CONSUMERS 8         // quantize: consumer warps a CTA

// One leaf of a launch; the wrapper packs the same 56 bytes (ops.py).
struct QuantLeaf {
  void* x;                // the leaf: f32 (dtype 0) or bf16 (dtype 1)
  int8_t* q;              // n_blocks * 256 int8
  float* s;               // n_blocks float32 scales
  long long n;            // elements of the leaf
  long long first_block;  // the leaf's first block in the launch
  long long first_stage;  // the leaf's first stage in the launch
  int dtype;
  int pad;
};

struct QuantTable {
  QuantLeaf leaves[QUANT_MAX_LEAVES];
  int n;
};

__device__ __forceinline__ bool aligned(const void* p, unsigned a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// ------------------------------------------------------------ quantize

template <int DT>
struct QuantType {
  static constexpr int ELEM = DT == 0 ? 4 : 2;
  static constexpr int BPS = QUANT_STAGE_BYTES / (QUANT_BLOCK * ELEM);
  static constexpr int PER_WARP = BPS / QUANT_CONSUMERS;  // blocks a warp
  static constexpr int PAIRS = PER_WARP / 2;               // a half each
  static constexpr int WORDS = 16 * ELEM / 4;   // 32-bit words of 16 elems
};

__device__ __forceinline__ int stage_blocks(int dtype) {
  return dtype == 0 ? QuantType<0>::BPS : QuantType<1>::BPS;
}

// Stage `ls` of leaf L: blocks b0 .. b0 + nb - 1.  The leaf's whole blocks
// come first, cut into runs of stage_blocks; the zero-padded tail block,
// if any, is the last stage, alone (`whole` false).
__device__ __forceinline__ void stage_span(const QuantLeaf& L, long long ls,
                                           long long& b0, int& nb,
                                           bool& whole) {
  const int bps = stage_blocks(L.dtype);
  const long long full = L.n / QUANT_BLOCK;
  const long long full_stages = (full + bps - 1) / bps;
  whole = ls < full_stages;
  b0 = whole ? ls * bps : full;
  nb = whole ? (int)min((long long)bps, full - b0) : 1;
}

// The leaf of stage st, moving `leaf` forward (a CTA's stages ascend).
__device__ __forceinline__ int leaf_of(const QuantTable& tab, int leaf,
                                       long long st) {
  while (leaf + 1 < tab.n && tab.leaves[leaf + 1].first_stage <= st) ++leaf;
  return leaf;
}

struct QuantSmem {
  uint8_t ring[QUANT_SLOTS][QUANT_STAGE_BYTES];
  uint64_t full[QUANT_SLOTS];
  uint64_t empty[QUANT_SLOTS];
};

// The 16 elements i0 .. i0 + 15 of the leaf, one by one from global
// memory, zeros past its end, packed as they lie in memory.
template <int DT>
__device__ __forceinline__ void load16_direct(
    const QuantLeaf& L, long long i0, uint32_t (&w)[QuantType<DT>::WORDS]) {
#pragma unroll
  for (int k = 0; k < QuantType<DT>::WORDS; ++k) w[k] = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (i0 + k >= L.n) break;
    if constexpr (DT == 0) {
      w[k] = static_cast<const uint32_t*>(L.x)[i0 + k];
    } else {
      const uint32_t b = static_cast<const uint16_t*>(L.x)[i0 + k];
      w[k >> 1] |= b << (16 * (k & 1));
    }
  }
}

template <int DT>
__device__ __forceinline__ void unpack16(
    const uint32_t (&w)[QuantType<DT>::WORDS], float (&v)[16]) {
#pragma unroll
  for (int k = 0; k < QuantType<DT>::WORDS; ++k) {
    if constexpr (DT == 0) {
      v[k] = __uint_as_float(w[k]);
    } else {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
}

// One block per half-warp: 16 elements a lane in v.  Returns the block's
// scale (in every lane of the half) and the lane's 16 q bytes in `out`.
__device__ __forceinline__ float quant16(const float (&v)[16], int half,
                                         uint4& out) {
  float amax = 0.f;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float a = fabsf(v[k]);
    nan |= (a != a);
    amax = fmaxf(amax, a);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if ((__ballot_sync(0xffffffffu, nan) >> (16 * half)) & 0xFFFFu) {
    amax = __int_as_float(0x7fc00000);
  }
  float scale = __fdiv_rn(amax, 127.0f);
  if (scale == 0.f) scale = 1.f;
  uint32_t p[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float t = fminf(fmaxf(__fdiv_rn(v[k], scale), -127.f), 127.f);
    p[k >> 2] |= (static_cast<uint32_t>(__float2int_rn(t)) & 0xFFu)
                 << (8 * (k & 3));
  }
  out = make_uint4(p[0], p[1], p[2], p[3]);
  return scale;
}

// A consumer warp's part of one stage: blocks j0 .. j0 + PER_WARP - 1 of
// the stage (those below nb).  `slot` is the stage in shared memory, or
// null for the direct path; the warp releases the slot on `empty` once its
// elements sit in registers.
template <int DT>
__device__ __forceinline__ void quant_stage(const QuantLeaf& L, long long b0,
                                            int nb, const uint8_t* slot,
                                            uint64_t* empty, int cw,
                                            int lane) {
  using T = QuantType<DT>;
  const int half = lane >> 4, hl = lane & 15;
  const int j0 = cw * T::PER_WARP;
  if (j0 >= nb) {
    if (slot != nullptr && lane == 0) mbar_arrive(empty);
    return;
  }
  uint32_t w[T::PAIRS][T::WORDS];
#pragma unroll
  for (int p = 0; p < T::PAIRS; ++p) {
    const int j = j0 + 2 * p + half;
    if (j >= nb) {
#pragma unroll
      for (int k = 0; k < T::WORDS; ++k) w[p][k] = 0u;
    } else if (slot != nullptr) {
      const uint4* src = reinterpret_cast<const uint4*>(
          slot + (j * QUANT_BLOCK + hl * 16) * T::ELEM);
#pragma unroll
      for (int k = 0; k < T::WORDS / 4; ++k) {
        const uint4 r = src[k];
        w[p][4 * k] = r.x; w[p][4 * k + 1] = r.y;
        w[p][4 * k + 2] = r.z; w[p][4 * k + 3] = r.w;
      }
    } else {
      load16_direct<DT>(L, (b0 + j) * QUANT_BLOCK + hl * 16, w[p]);
    }
  }
  if (slot != nullptr) {
    // The next bulk copy into this slot is an async-proxy write after
    // these generic-proxy reads: without the proxy fence the arrive can
    // release the slot before every lane's loads have read it (on an
    // H100, 16 of 100 launches at the Yi-9B optimizer unit gave a wrong
    // q block: scripts/quantize_probe.py --repeat 100).
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  }
  float sc[T::PER_WARP];
  int8_t* q = L.q + b0 * QUANT_BLOCK;
  const bool qvec = aligned(L.q, 16);
#pragma unroll
  for (int p = 0; p < T::PAIRS; ++p) {
    const int j = j0 + 2 * p + half;
    float v[16];
    unpack16<DT>(w[p], v);
    uint4 out;
    const float s = quant16(v, half, out);
    sc[2 * p] = __shfl_sync(0xffffffffu, s, 0);
    sc[2 * p + 1] = __shfl_sync(0xffffffffu, s, 16);
    if (j < nb) {
      int8_t* dst = q + j * QUANT_BLOCK + hl * 16;
      if (qvec) {
        *reinterpret_cast<uint4*>(dst) = out;
      } else {
        const uint32_t o[4] = {out.x, out.y, out.z, out.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          dst[k] = static_cast<int8_t>((o[k >> 2] >> (8 * (k & 3))) & 0xFF);
        }
      }
    }
  }
  if (lane != 0) return;
  float* s = L.s + b0 + j0;
  if (j0 + T::PER_WARP <= nb && aligned(s, T::PER_WARP == 2 ? 8 : 16)) {
    if constexpr (T::PER_WARP == 2) {
      *reinterpret_cast<float2*>(s) = make_float2(sc[0], sc[1]);
    } else {
#pragma unroll
      for (int k = 0; k < T::PER_WARP; k += 4) {
        *reinterpret_cast<float4*>(s + k) =
            make_float4(sc[k], sc[k + 1], sc[k + 2], sc[k + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < T::PER_WARP; ++k) {
      if (j0 + k < nb) s[k] = sc[k];
    }
  }
}

// A stage goes through the ring when it holds whole blocks of a leaf that
// starts on 16 bytes (so the copy's address and size are on 16 bytes).
__device__ __forceinline__ bool bulk_stage(const QuantLeaf& L, bool whole) {
  return whole && aligned(L.x, 16);
}

__global__ void __launch_bounds__((QUANT_CONSUMERS + 1) * 32)
quantize_kernel(const __grid_constant__ QuantTable tab,
                long long total_stages) {
  extern __shared__ __align__(128) uint8_t quant_raw[];
  QuantSmem& sm = *reinterpret_cast<QuantSmem*>(quant_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < QUANT_SLOTS; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], QUANT_CONSUMERS);  // lane 0 of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int leaf = 0, slot = 0;
  uint32_t round = 0;           // times the ring has wrapped
  if (warp == QUANT_CONSUMERS) {
    // ---- producer: one thread issues every bulk copy
    if (lane != 0) return;
    for (long long st = blockIdx.x; st < total_stages; st += gridDim.x) {
      leaf = leaf_of(tab, leaf, st);
      const QuantLeaf L = tab.leaves[leaf];
      long long b0;
      int nb;
      bool whole;
      stage_span(L, st - L.first_stage, b0, nb, whole);
      if (!bulk_stage(L, whole)) continue;
      if (round > 0) mbar_wait(&sm.empty[slot], (round - 1) & 1);
      const int elem = L.dtype == 0 ? 4 : 2;
      const uint32_t bytes = (uint32_t)nb * QUANT_BLOCK * elem;
      mbar_expect_tx(&sm.full[slot], bytes);
      bulk_load(sm.ring[slot],
                static_cast<const uint8_t*>(L.x) + b0 * QUANT_BLOCK * elem,
                bytes, &sm.full[slot]);
      if (++slot == QUANT_SLOTS) { slot = 0; ++round; }
    }
    return;
  }
  // ---- consumers: warps 0 .. QUANT_CONSUMERS - 1
  for (long long st = blockIdx.x; st < total_stages; st += gridDim.x) {
    leaf = leaf_of(tab, leaf, st);
    const QuantLeaf L = tab.leaves[leaf];
    long long b0;
    int nb;
    bool whole;
    stage_span(L, st - L.first_stage, b0, nb, whole);
    const uint8_t* src = nullptr;
    uint64_t* empty = nullptr;
    if (bulk_stage(L, whole)) {
      mbar_wait(&sm.full[slot], round & 1);
      src = sm.ring[slot];
      empty = &sm.empty[slot];
      if (++slot == QUANT_SLOTS) { slot = 0; ++round; }
    }
    if (L.dtype == 0) {
      quant_stage<0>(L, b0, nb, src, empty, warp, lane);
    } else {
      quant_stage<1>(L, b0, nb, src, empty, warp, lane);
    }
  }
}

// ---------------------------------------------------------- dequantize

__device__ __forceinline__ int find_leaf(const QuantTable& tab, long long b) {
  int l = 0;
  while (l + 1 < tab.n && tab.leaves[l + 1].first_block <= b) ++l;
  return l;
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

// ------------------------------------------------------------ launches

static bool table_of(const QuantLeaf* leaves, int n, QuantTable* tab) {
  if (n <= 0 || n > QUANT_MAX_LEAVES) return false;
  for (int i = 0; i < n; ++i) tab->leaves[i] = leaves[i];
  tab->n = n;
  return true;
}

// CTAs of the persistent quantize grid: as many as fit on the card's SMs
// (kept per device after the first launch there).
static cudaError_t quant_grid(long long total_stages, unsigned* grid) {
  static unsigned long long opted = 0;
  static int ctas[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (ctas[dev] == 0) {
    const int smem = (int)sizeof(QuantSmem);
    e = smem_opt_in(quantize_kernel, smem, &opted);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, quantize_kernel, (QUANT_CONSUMERS + 1) * 32, smem);
    }
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    ctas[dev] = sms * per_sm;
  }
  *grid = (unsigned)(total_stages < ctas[dev] ? total_stages : ctas[dev]);
  return cudaSuccess;
}

// Quantizes `n` leaves (n <= QUANT_MAX_LEAVES) holding `total_stages`
// stages in all; leaf i's stages are first_stage .. first_stage +
// n_stages(i) - 1 (ops.leaf_stages).  Returns the launch's cudaError_t.
extern "C" int quantize_launch(const QuantLeaf* leaves, int n,
                               long long total_stages, void* stream) {
  QuantTable tab;
  if (!table_of(leaves, n, &tab) || total_stages <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned grid = 0;
  const cudaError_t e = quant_grid(total_stages, &grid);
  if (e != cudaSuccess) return (int)e;
  quantize_kernel<<<grid, (QUANT_CONSUMERS + 1) * 32, sizeof(QuantSmem),
                    (cudaStream_t)stream>>>(tab, total_stages);
  return (int)cudaGetLastError();
}

// Dequantizes into the leaves' `x` (the same table; q and s are read);
// leaf i's blocks are first_block .. first_block + ceil(n_i / 256) - 1 of
// `total_blocks`.
extern "C" int dequantize_launch(const QuantLeaf* leaves, int n,
                                 long long total_blocks, void* stream) {
  QuantTable tab;
  if (!table_of(leaves, n, &tab) || total_blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long grid = (total_blocks + QUANT_WARPS - 1) / QUANT_WARPS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<(unsigned)grid, QUANT_WARPS * 32, 0,
                      (cudaStream_t)stream>>>(tab, total_blocks);
  return (int)cudaGetLastError();
}
