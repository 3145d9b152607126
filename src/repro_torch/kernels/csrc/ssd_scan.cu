// Mamba2 SSD chunk scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:83
// (`ssd_scan_bhcqp`, body `_ssd_kernel`) with its wrapper ops.py, and
// computes their function: per (batch b, head h), chunk by chunk, a float32
// (P x N) state carried from zero,
//
//   a     = -exp(a_log[h])
//   L     = cumsum(dt * a)                          (within the chunk)
//   y     = (C . state^T) * exp(L)
//           + ((C . B^T) * exp(min(L_i - L_j, 0)) * causal * dt_j) . x
//   state = exp(L_last) * state + (exp(L_last - L) * dt * x)^T . B
//
// in float32 from x, B, C cast to float32; y is written in x's dtype,
// the final state in float32.
//
// Layout: x (B,S,H,P), dt (B,S,H) float32, B and C (B,S,G,N), y (B,S,H,P),
// all read through their strides (last dimension contiguous), so the model
// passes views of its conv output without the JAX wrapper's chunk
// transpose, and head h reads group h / (H / G) without the model's
// per-head repeat of B and C.  A chunk holds Q <= 256 positions; positions
// at or past S (a ragged last chunk) load as x = B = C = 0 and dt = 0,
// which is the zero padding of the JAX model's ssd_chunked: they decay
// nothing and add nothing, and their rows of y are not written.
//
// L is a prefix sum taken by one thread in a fixed order (separately
// rounded product and sum, as dt * a then cumsum), once per (b, h, chunk):
// on the card torch.cumsum over the plain version's chunk axis is a
// serial float32 loop too, so both give the same L bit for bit; a parallel
// scan rounds otherwise.  Every launch sums in one fixed order (no
// atomics), so two launches give bitwise-equal outputs.
//
// What bounds it: bytes.  At the serve prefill shape (batch 8, 1024 tokens,
// 32 heads, P 64, N 128, Q 256, one group) the function moves 80.7 MB
// (0.0241 ms at 3.35 TB/s) and needs 12.1 GFLOP (0.0122 ms on the bf16
// tensor cores).  Two routes; the wrapper's ssd_scan takes route 2 for
// every dtype, and route 1 is named by a caller (ops.launch):
//
// 1. bf16 x, B, C: chunk-parallel, in three kernels of one C call, as
//    Mamba2's state-passing SSD.
//    a. ssd_chunk_state_kernel, one warpgroup per (chunk, head, batch):
//       dt and L of the chunk (L to the scratch), then the chunk's own
//       state s_c = (exp(L_last - L) dt x)^T . B as one wgmma chain
//       (m64n128k16, A in registers, the B tile MN-major); B and x stream
//       in 64-key blocks through a two-stage cp.async ring, the first two
//       in flight while thread 0 sums L;
//    b. ssd_state_pass_kernel: per (b, h) and 4 state elements a thread,
//       S <- S e^{L_last} + s_c in chunk order (separate float32
//       roundings, the plain version's), each entering state written as
//       its three bf16 pieces in the image of (c)'s shared memory, and the
//       final state;
//    c. ssd_chunk_out_kernel, one warpgroup per (64-row tile, chunk, head,
//       batch), the late (heavy) tiles first: y = (C . S^T) e^L by wgmma
//       on the pieces (copied in by cp.async), then for each causal 64-key
//       tile the scores C . B^T (bf16 x bf16, exact products) and m =
//       scores e^{min(Li - Lj, 0)} dt_j, y += m . x; key tiles stream
//       through a two-stage cp.async ring in the pieces' space.
//    The float32 operands (w x in a, the entering state in b/c, m in c)
//    enter the tensor cores as three bf16 pieces, v1 = bf16(v), v2 =
//    bf16(v - v1), v3 = bf16(v - v1 - v2), whose sum is v exactly (short of
//    bf16 underflow): three wgmmas into one float32 accumulator, so every
//    product is the float32 one and only the order of the sums differs.
//    Two pieces keep 16 of float32's 24 bits and flip about one bf16 y in
//    a thousand per layer; one (bf16 m) fails the two-ulp check.  So the
//    design's tensor-core work is ~3 x 12.9 + 8.6 = ~47 GFLOP at the serve
//    shape (0.048 ms at 989 TFLOP/s), its own floor above the function's.
//    C . B^T is recomputed per head (8.6 GFLOP at G = 1) rather than
//    shared across a group's heads through memory.  Tiles go to 128B-
//    swizzled shared memory by cp.async (ragged edges zero-filled), then
//    fence.proxy.async before the wgmmas read them.  Scratch from the
//    wrapper: the per-chunk states (B, H, NC, P, N) float32, their pieces
//    (B, H, NC, 48 KiB) and L (B, H, NC, Q) float32; the kernels allocate
//    nothing.  What is left on the table (PERF.md, section 6): kernel c's
//    exps (accurate expf, one per causal score) and its serial per-tile
//    chain (scores, m, m . x) in one warpgroup.
//    Route 1 is as accurate as route 2 (each rounds ~0.13% of bf16 y off
//    y computed in float64 and rounded once), but it sums in another
//    order: its y rounds otherwise than the plain version's on ~0.01% of
//    the elements, which the bf16 Mamba2 prefill carries to ~0.1 on the
//    last logits at 48 layers, past the 1e-3 to which chip_smoke.py holds
//    it against the plain scan's forward.  Hence route 2 by default.
// 2. float32 or bf16 x, B, C: the CUDA-core kernel (ssd_scan_kernel<T,
//    N>, N = 128, Mamba2's state dim, or 64, Zamba2's), one CTA of 256
//    threads per (batch, head) looping over the chunks with the state in
//    shared memory ([N][P], 32 KiB at N = 128); y in tiles of 64 query
//    rows against the causal 64-key tiles at or before them, float32 FMAs
//    throughout, each sum in the plain version's order, so its y equals
//    the plain version's bit for bit; the state update after every row
//    tile has read the old state, each thread owning a 4 x N/16 block of
//    the (P, N) state.  130 KiB of shared memory at N = 128 (82 KiB at
//    64), one CTA per SM.  Route 1 takes N = 128 only.  At N = 64 the
//    sums run in the same order, yet on the card 3 of the 42 M bf16 y at
//    Zamba2's serve shape are one ulp off the plain version's (none at
//    N = 128), within the two-ulp check; why is not measured (the plain
//    version's products run in cuBLAS, whose order at K = 64 is not
//    known here).
//
// ptxas (sm_90a, -O3), registers per thread, no spills in any;
// dynamic shared memory per CTA: ssd_chunk_state_kernel 161 (54 KiB, 3
// CTAs an SM), ssd_state_pass_kernel 40 (none), ssd_chunk_out_kernel 151
// (67 KiB, 3 CTAs an SM), ssd_scan_kernel 128 for float and for bf16
// inputs (130 KiB), 127 at N = 64 (82 KiB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define SSD_P 64
#define SSD_N 128
#define SSD_T 64
#define SSD_THREADS 256
#define SSD_MAX_CHUNK 256

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* bm;
  const void* cm;
  void* y;
  float* fin;
  long long xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg, yb, ys, yh;
  int s, h, g, chunk;
};

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  x[0] = __uint_as_float(u.x << 16); x[1] = __uint_as_float(u.x & 0xFFFF0000u);
  x[2] = __uint_as_float(u.y << 16); x[3] = __uint_as_float(u.y & 0xFFFF0000u);
  x[4] = __uint_as_float(u.z << 16); x[5] = __uint_as_float(u.z & 0xFFFF0000u);
  x[6] = __uint_as_float(u.w << 16); x[7] = __uint_as_float(u.w & 0xFFFF0000u);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void put8(float* dst, const float* x) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(x[0], x[1], x[2], x[3]);
  d[1] = make_float4(x[4], x[5], x[6], x[7]);
}

template <typename T, int N>
__global__ void __launch_bounds__(SSD_THREADS, 1)
ssd_scan_kernel(const SsdArgs a) {
  static_assert(N == 64 || N == 128, "state dim 64 or 128");
  constexpr int P = SSD_P, TT = SSD_T;
  constexpr int NT = N / 16;  // state columns per thread in the update
  extern __shared__ float4 ssd_smem4[];
  float* sT = reinterpret_cast<float*>(ssd_smem4);  // [N][P] state
  float* cT = sT + N * P;        // [N][TT] C rows; [TT][N] B in the update
  float* bT = cT + N * TT;       // [N][TT] B keys
  float* xt = bT + N * TT;       // [TT][P] x keys; weighted x in the update
  float* mT = xt + TT * P;       // [TT][TT] decayed scores, [key][row]
  float* lc = mT + TT * TT;      // [SSD_MAX_CHUNK] L
  float* dtc = lc + SSD_MAX_CHUNK;  // [SSD_MAX_CHUNK] dt

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ bm = static_cast<const T*>(a.bm);
  const T* __restrict__ cm = static_cast<const T*>(a.cm);
  T* __restrict__ y = static_cast<T*>(a.y);

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows rg*4 .. +3 (state update: p rg*4 .. +3)
  const int cg = tid & 15;  // cols cg*4 .. +3 (state update: n cg*NT ..)
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int gi = h / (a.h / a.g);
  const int q = a.chunk;
  const int ntiles = (q + TT - 1) / TT;
  const float a_h = -expf(a.a_log[h]);
  const T* xbase = x + b * a.xb + (long long)h * a.xh;
  const T* bbase = bm + b * a.bb + (long long)gi * a.bg;
  const T* cbase = cm + b * a.cb + (long long)gi * a.cg;
  const float* dbase = a.dt + b * a.db + (long long)h * a.dh;

  for (int c = tid; c < N * P; c += SSD_THREADS) sT[c] = 0.f;

  for (long long c0 = 0; c0 < a.s; c0 += q) {
    // dt of the chunk (0 past the chunk or past S), then L by one thread
    for (int l = tid; l < SSD_MAX_CHUNK; l += SSD_THREADS) {
      dtc[l] = (l < q && c0 + l < a.s) ? dbase[(c0 + l) * a.ds] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int l = 0; l < SSD_MAX_CHUNK; ++l) {
        acc = __fadd_rn(acc, __fmul_rn(dtc[l], a_h));
        lc[l] = acc;
      }
    }
    __syncthreads();
    const float total = lc[SSD_MAX_CHUNK - 1];

    // ---- y, one tile of 64 query rows at a time
    for (int rt = 0; rt < ntiles; ++rt) {
      const int r0 = rt * TT;
      for (int c = tid; c < TT * (N / 8); c += SSD_THREADS) {
        const int row = c % TT, nc = c / TT;
        float v[8];
        const long long pos = c0 + r0 + row;
        if (r0 + row < q && pos < a.s) {
          load8(cbase + pos * a.cs + nc * 8, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) cT[(nc * 8 + e) * TT + row] = v[e];
      }
      __syncthreads();

      float inter[4][4], intra[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) inter[i][j] = intra[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(cT + n * TT +
                                                           rg * 4);
        const float4 sv = *reinterpret_cast<const float4*>(sT + n * P +
                                                           cg * 4);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(ca[i], sa[j],
                                                         inter[i][j]);
      }
      float li[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        li[i] = lc[r0 + rg * 4 + i];
        const float e = expf(li[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) inter[i][j] *= e;
      }

      for (int kt = 0; kt <= rt; ++kt) {
        const int k0 = kt * TT;
        __syncthreads();  // the previous key tile's readers are done
        for (int c = tid; c < TT * (N / 8); c += SSD_THREADS) {
          const int key = c % TT, nc = c / TT;
          float v[8];
          const long long pos = c0 + k0 + key;
          if (k0 + key < q && pos < a.s) {
            load8(bbase + pos * a.bs + nc * 8, v);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) bT[(nc * 8 + e) * TT + key] = v[e];
        }
        for (int c = tid; c < TT * (P / 8); c += SSD_THREADS) {
          const int key = c / (P / 8), pc = c % (P / 8);
          float v[8];
          const long long pos = c0 + k0 + key;
          if (k0 + key < q && pos < a.s) {
            load8(xbase + pos * a.xs + pc * 8, v);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = 0.f;
          }
          put8(xt + key * P + pc * 8, v);
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(cT + n * TT +
                                                             rg * 4);
          const float4 bv = *reinterpret_cast<const float4*>(bT + n * TT +
                                                             cg * 4);
          const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
          const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(ca[i], ba[j],
                                                        sc[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + cg * 4 + j;
          const float lj = lc[kj], dj = dtc[kj];
          float m[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ri = r0 + rg * 4 + i;
            m[i] = kj <= ri ? sc[i][j] * expf(fminf(li[i] - lj, 0.f)) * dj
                            : 0.f;
          }
          store4(mT + (cg * 4 + j) * TT + rg * 4, m[0], m[1], m[2], m[3]);
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < TT; ++j) {
          const float4 mv = *reinterpret_cast<const float4*>(mT + j * TT +
                                                             rg * 4);
          const float4 xv = *reinterpret_cast<const float4*>(xt + j * P +
                                                             cg * 4);
          const float ma[4] = {mv.x, mv.y, mv.z, mv.w};
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int p = 0; p < 4; ++p) intra[i][p] = fmaf(ma[i], xa[p],
                                                           intra[i][p]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = r0 + rg * 4 + i;
        const long long pos = c0 + ri;
        if (ri >= q || pos >= a.s) continue;
        store4(y + b * a.yb + pos * a.ys + (long long)h * a.yh + cg * 4,
               inter[i][0] + intra[i][0], inter[i][1] + intra[i][1],
               inter[i][2] + intra[i][2], inter[i][3] + intra[i][3]);
      }
      __syncthreads();  // cT is reloaded by the next row tile
    }

    // ---- state update; every row tile has read the old state
    float upd[4][NT];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n) upd[p][n] = 0.f;
    float* bR = cT;  // [TT][N]
    for (int kt = 0; kt < ntiles; ++kt) {
      const int k0 = kt * TT;
      __syncthreads();
      for (int c = tid; c < TT * (N / 8); c += SSD_THREADS) {
        const int key = c / (N / 8), nc = c % (N / 8);
        float v[8];
        const long long pos = c0 + k0 + key;
        if (k0 + key < q && pos < a.s) {
          load8(bbase + pos * a.bs + nc * 8, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
        }
        put8(bR + key * N + nc * 8, v);
      }
      for (int c = tid; c < TT * (P / 8); c += SSD_THREADS) {
        const int key = c / (P / 8), pc = c % (P / 8);
        float v[8];
        const long long pos = c0 + k0 + key;
        if (k0 + key < q && pos < a.s) {
          load8(xbase + pos * a.xs + pc * 8, v);
          const float w = expf(total - lc[k0 + key]) * dtc[k0 + key];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] *= w;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
        }
        put8(xt + key * P + pc * 8, v);
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TT; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(xt + j * P +
                                                           rg * 4);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
        float ba[NT];
#pragma unroll
        for (int v = 0; v < NT / 4; ++v) {
          const float4 b4 = *reinterpret_cast<const float4*>(
              bR + j * N + cg * NT + v * 4);
          ba[v * 4] = b4.x; ba[v * 4 + 1] = b4.y;
          ba[v * 4 + 2] = b4.z; ba[v * 4 + 3] = b4.w;
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int n = 0; n < NT; ++n) upd[p][n] = fmaf(wa[p], ba[n],
                                                        upd[p][n]);
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* row = sT + (cg * NT + n) * P + rg * 4;
#pragma unroll
      for (int p = 0; p < 4; ++p) row[p] = row[p] * decay + upd[p][n];
    }
    __syncthreads();  // the next chunk reads the new state
  }

  // final state (P, N): this thread's 4 x NT block, a float4 per 4 n
  float* fin = a.fin + (b * a.h + h) * (long long)(P * N);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int v = 0; v < NT / 4; ++v) {
      const int n0 = cg * NT + v * 4;
      store4(fin + (rg * 4 + p) * N + n0, sT[n0 * P + rg * 4 + p],
             sT[(n0 + 1) * P + rg * 4 + p], sT[(n0 + 2) * P + rg * 4 + p],
             sT[(n0 + 3) * P + rg * 4 + p]);
    }
  }
}

static int smem_bytes(int n) {
  return (n * SSD_P + 2 * n * SSD_T + SSD_T * SSD_P + SSD_T * SSD_T +
          2 * SSD_MAX_CHUNK) * (int)sizeof(float);
}

template <typename T, int N>
static int launch_typed(const SsdArgs& a, int batch, cudaStream_t stream) {
  const int smem = smem_bytes(N);
  // The shared-memory opt-in is a per-device attribute: set it once for
  // each device this instantiation runs on.
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !(attr_set & (1ULL << dev))) {
    e = cudaFuncSetAttribute(ssd_scan_kernel<T, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    attr_set |= 1ULL << dev;
  }
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)a.h, (unsigned)batch);
  ssd_scan_kernel<T, N><<<grid, SSD_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- route 1: bf16
#define CB_THREADS 128      // one warpgroup
#define CB_TILE 64          // rows or keys of a tile
#define CB_PANEL 8192       // 64 rows x 128 B: one 128B-swizzled panel
#define CB_PASS_THREADS 256
#define CB_PIECES (3 * 2 * CB_PANEL)  // bytes of one state's three pieces

typedef __nv_bfloat16 bf16;

struct CbArgs {
  const bf16* x;
  const float* dt;
  const float* a_log;
  const bf16* bm;
  const bf16* cm;
  bf16* y;
  float* fin;
  float* states;  // (B, H, NC, P, N): s_c
  uint8_t* pieces;  // (B, H, NC, 48 KiB): the entering states' pieces
  float* lbuf;    // (B, H, NC, Q): L
  long long xb, xs, xh, db, ds, dh, bb, bs, bg, cb, cs, cg, yb, ys, yh;
  int s, h, g, chunk, nc;
};

// Shared memory of the chunk-state kernel (a): a two-stage ring of 64-key
// blocks, each the block's B rows as two panels of 64 state columns (keys x
// 128 B) and its x rows padded to 72 elements (read by the threads, not by
// wgmma); the chunk's dt, L and weights.
struct CsSmem {
  uint8_t b[2][2][CB_PANEL];  // [stage][n panel]
  bf16 x[2][CB_TILE][SSD_P + 8];
  float dt[SSD_MAX_CHUNK];
  float l[SSD_MAX_CHUNK];
  float w[SSD_MAX_CHUNK];
};

// Shared memory of the output kernel (c): one 64-row tile of C; the
// entering state's three pieces ([piece][n panel][p][128 B]), whose space
// the two-stage ring of key tiles (B and x) takes once the state's product
// is done; the chunk's L and dt.
struct CoStage {
  uint8_t b[2][CB_PANEL];
  uint8_t x[CB_PANEL];
};

struct CoSmem {
  uint8_t c[2][CB_PANEL];
  union {
    uint8_t st[3][2][CB_PANEL];
    CoStage ring[2];
  };
  float l[SSD_MAX_CHUNK];
  float dt[SSD_MAX_CHUNK];
};

__device__ __forceinline__ float lo_f(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float hi_f(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// Two float32 values as three packed bf16 pairs whose sums are the values
// exactly: p1 = bf16(v), p2 = bf16(v - p1), p3 = bf16(v - p1 - p2) (each
// difference is exact in float32).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& p1,
                                       uint32_t& p2, uint32_t& p3) {
  p1 = pack_bf16(v0, v1);
  const float r0 = v0 - lo_f(p1), r1 = v1 - hi_f(p1);
  p2 = pack_bf16(r0, r1);
  p3 = pack_bf16(r0 - lo_f(p2), r1 - hi_f(p2));
}

// Rows [r0, r0 + rows) of a (pos, 128) bf16 operand (B or C of group `gi`)
// into two 128B-swizzled panels of 64 columns by cp.async (not committed);
// rows at or past the chunk (q) or S are zeros.  Row i goes to panel row
// i - r0.
__device__ __forceinline__ void load_bc(uint8_t* dst, int panel_bytes,
                                        const bf16* base, long long stride,
                                        long long c0, int r0, int rows,
                                        int q, int s, int tid) {
  for (int i = tid; i < rows * 16; i += CB_THREADS) {
    const int row = i >> 4, ch = i & 15;
    const int l = r0 + row;
    const long long pos = c0 + l;
    const bool in = l < q && pos < s;
    cp_async16(dst + (ch >> 3) * panel_bytes + row * 128 +
                   (((ch & 7) ^ (row & 7)) << 4),
               in ? base + pos * stride + ch * 8 : base, in);
  }
}

// Key rows [k0, k0 + 64) of x (one panel of 64 columns) as load_bc does.
__device__ __forceinline__ void load_x(uint8_t* dst, const bf16* base,
                                       long long stride, long long c0,
                                       int k0, int q, int s, int tid) {
  for (int i = tid; i < CB_TILE * 8; i += CB_THREADS) {
    const int key = i >> 3, ch = i & 7;
    const long long pos = c0 + k0 + key;
    const bool in = k0 + key < q && pos < s;
    cp_async16(dst + key * 128 + ((ch ^ (key & 7)) << 4),
               in ? base + pos * stride + ch * 8 : base, in);
  }
}

// (a) The chunk's L (to the scratch) and its own state contribution
// s_c[p][n] = sum_keys (exp(L_last - L) dt x)[key][p] B[key][n], on the
// tensor cores with w x as three bf16 pieces in registers.  B and x stream
// in 64-key blocks through a two-stage cp.async ring (one group a block,
// empty past the chunk); the first two are in flight while thread 0 sums
// L.
__global__ void __launch_bounds__(CB_THREADS, 3)
ssd_chunk_state_kernel(const CbArgs a) {
  extern __shared__ uint8_t cb_raw[];
  const uint32_t base = smem_u32(cb_raw);
  CsSmem& sm = *reinterpret_cast<CsSmem*>(
      cb_raw + ((1024 - (base & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int gi = h / (a.h / a.g);
  const int q = a.chunk;
  const int nblk = (q + CB_TILE - 1) / CB_TILE;
  const long long c0 = (long long)c * q;
  const float a_h = -expf(a.a_log[h]);
  const float* dbase = a.dt + b * a.db + (long long)h * a.dh;
  const bf16* bbase = a.bm + b * a.bb + (long long)gi * a.bg;
  const bf16* xbase = a.x + b * a.xb + (long long)h * a.xh;
  const long long chunk_id = (b * a.h + h) * a.nc + c;
  // block k's B keys (MN-major operand: panel n / 64, row key) and x rows
  // into stage k % 2, then one commit
  auto load_block = [&](int k) {
    if (k < nblk) {
      const int k0 = k * CB_TILE, st = k & 1;
      load_bc(sm.b[st][0], CB_PANEL, bbase, a.bs, c0, k0, CB_TILE, q, a.s,
              tid);
      for (int i = tid; i < CB_TILE * 8; i += CB_THREADS) {
        const int key = i >> 3, ch = i & 7;
        const long long pos = c0 + k0 + key;
        const bool in = k0 + key < q && pos < a.s;
        cp_async16(&sm.x[st][key][ch * 8],
                   in ? xbase + pos * a.xs + ch * 8 : xbase, in);
      }
    }
    cp_async_commit();
  };

  load_block(0);
  load_block(1);
  for (int l = tid; l < SSD_MAX_CHUNK; l += CB_THREADS)
    sm.dt[l] = (l < q && c0 + l < a.s) ? dbase[(c0 + l) * a.ds] : 0.f;
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
#pragma unroll 8
    for (int l = 0; l < q; ++l) {
      acc = __fadd_rn(acc, __fmul_rn(sm.dt[l], a_h));
      sm.l[l] = acc;
    }
  }
  __syncthreads();
  const float total = sm.l[q - 1];
  float* lout = a.lbuf + chunk_id * q;
  for (int l = tid; l < nblk * CB_TILE; l += CB_THREADS) {
    if (l < q) lout[l] = sm.l[l];
    sm.w[l] = l < q ? expf(total - sm.l[l]) * sm.dt[l] : 0.f;
  }

  // Thread (warp w, lane): A rows p0 = 16 w + lane / 4 and p0 + 8; A
  // columns (keys) 2 (lane % 4) + {0, 1} and + 8 in each 16-key step.
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = warp * 16 + (lane >> 2), kq = (lane & 3) * 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t fr[3][4][4];
  for (int blk = 0; blk < nblk; ++blk) {
    const int st = blk & 1, k0 = blk * CB_TILE;
    cp_async_wait<1>();  // block blk (block blk + 1 may be in flight)
    fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kk * 16 + kq + (j >> 1) * 8;
        const int p = p0 + (j & 1) * 8;
        const float v0 = sm.w[k0 + key] *
                         __bfloat162float(sm.x[st][key][p]);
        const float v1 = sm.w[k0 + key + 1] *
                         __bfloat162float(sm.x[st][key + 1][p]);
        split3(v0, v1, fr[0][kk][j], fr[1][kk][j], fr[2][kk][j]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = gmma_desc(sm.b[st][0] + kk * 16 * 128, CB_PANEL,
                                    1024);
      wgmma_rs(acc, fr[0][kk], db);
      wgmma_rs(acc, fr[1][kk], db);
      wgmma_rs(acc, fr[2][kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fr);
    __syncthreads();  // stage st is free
    load_block(blk + 2);
  }
  cp_async_wait<0>();

  // accumulator element i: row p0 + 8 ((i / 2) % 2), column (i / 4) * 8 +
  // kq + i % 2
  float* dst = a.states + chunk_id * (SSD_P * SSD_N);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int p = p0 + ((i >> 1) & 1) * 8, n = (i >> 2) * 8 + kq;
    *reinterpret_cast<float2*>(dst + p * SSD_N + n) =
        make_float2(acc[i], acc[i + 1]);
  }
}

// (b) Per (b, h), four state elements a thread: in chunk order, the state
// entering chunk c goes to the scratch as three bf16 pieces, in the image
// of kernel (c)'s shared memory ([piece][n panel][p][128 B], 128B-
// swizzled; none for chunk 0, whose state is zero), and S <- S *
// exp(L_last of c) + s_c, as separate float32 roundings (the plain
// version's order); the final state to `fin`.  Four chunks' loads are
// issued before their stores, so they are in flight together.
__global__ void __launch_bounds__(CB_PASS_THREADS)
ssd_state_pass_kernel(const CbArgs a) {
  const int e = (blockIdx.x * CB_PASS_THREADS + threadIdx.x) * 4;
  const int p = e / SSD_N, n = e % SSD_N;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long bh = b * a.h + h;
  const float* own_at = a.states + bh * a.nc * (SSD_P * SSD_N) + e;
  uint8_t* pc_at = a.pieces + bh * a.nc * (long long)CB_PIECES +
                   (n >> 6) * CB_PANEL + p * 128 +
                   ((((n & 63) >> 3) ^ (p & 7)) << 4) + (n & 7) * 2;
  const float* lend = a.lbuf + bh * a.nc * a.chunk + a.chunk - 1;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += 4) {
    float4 own[4];
    float ll[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < a.nc) {
        own[j] = *reinterpret_cast<const float4*>(
            own_at + (long long)(c0 + j) * SSD_P * SSD_N);
        ll[j] = lend[(long long)(c0 + j) * a.chunk];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < a.nc) {
        if (c0 + j > 0) {
          uint8_t* dst = pc_at + (long long)(c0 + j) * CB_PIECES;
          uint2 p1, p2, p3;
          split3(st.x, st.y, p1.x, p2.x, p3.x);
          split3(st.z, st.w, p1.y, p2.y, p3.y);
          *reinterpret_cast<uint2*>(dst) = p1;
          *reinterpret_cast<uint2*>(dst + 2 * CB_PANEL) = p2;
          *reinterpret_cast<uint2*>(dst + 4 * CB_PANEL) = p3;
        }
        const float d = expf(ll[j]);
        st.x = __fadd_rn(__fmul_rn(st.x, d), own[j].x);
        st.y = __fadd_rn(__fmul_rn(st.y, d), own[j].y);
        st.z = __fadd_rn(__fmul_rn(st.z, d), own[j].z);
        st.w = __fadd_rn(__fmul_rn(st.w, d), own[j].w);
      }
    }
  }
  *reinterpret_cast<float4*>(a.fin + bh * (SSD_P * SSD_N) + e) = st;
}

// (c) y for one 64-row tile of one chunk: (C . S^T) e^L with the entering
// state S as three bf16 pieces in shared memory, then per causal key tile
// the scores C . B^T and y += m . x with m as three bf16 pieces in
// registers, in the accumulator's own layout.  Key tiles stream through a
// two-stage cp.async ring in the state's space: tile t + 1 lands while
// tile t is computed.
__global__ void __launch_bounds__(CB_THREADS, 3)
ssd_chunk_out_kernel(const CbArgs a) {
  extern __shared__ uint8_t cb_raw[];
  const uint32_t base = smem_u32(cb_raw);
  CoSmem& sm = *reinterpret_cast<CoSmem*>(
      cb_raw + ((1024 - (base & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int q = a.chunk;
  const int ntiles = (q + CB_TILE - 1) / CB_TILE;
  const int rt = ntiles - 1 - (int)(blockIdx.x % ntiles);  // heavy first
  const int c = blockIdx.x / ntiles, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int gi = h / (a.h / a.g);
  const long long c0 = (long long)c * q;
  const int r0 = rt * CB_TILE;
  const int kend = r0 + CB_TILE;  // keys this tile reads: [0, kend)
  const long long chunk_id = (b * a.h + h) * a.nc + c;
  const float* dbase = a.dt + b * a.db + (long long)h * a.dh;
  const float* lin = a.lbuf + chunk_id * q;
  const bf16* bbase = a.bm + b * a.bb + (long long)gi * a.bg;
  const bf16* xbase = a.x + b * a.xb + (long long)h * a.xh;

  load_bc(sm.c[0], CB_PANEL, a.cm + b * a.cb + (long long)gi * a.cg, a.cs, c0,
          r0, CB_TILE, q, a.s, tid);
  cp_async_commit();
  for (int l = tid; l < kend; l += CB_THREADS) {
    const bool in = l < q && c0 + l < a.s;
    sm.dt[l] = in ? dbase[(c0 + l) * a.ds] : 0.f;
    sm.l[l] = l < q ? lin[l] : 0.f;
  }
  if (c > 0) {  // the entering state's pieces, already in their image
    const uint8_t* sp = a.pieces + chunk_id * (long long)CB_PIECES;
    for (int i = tid; i < CB_PIECES / 16; i += CB_THREADS)
      cp_async16(&sm.st[0][0][0] + i * 16, sp + i * 16, true);
    cp_async_commit();
  }
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int rw = warp * 16 + (lane >> 2);  // rows rw, rw + 8 of the tile
  const int kq = (lane & 3) * 2;
  float acc[32];
  if (c > 0) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SSD_N / 16; ++kk) {
      const int pn = kk >> 2, off = (kk & 3) * 32;
      const uint64_t da = gmma_desc(sm.c[pn] + off, 16, 1024);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        wgmma_ss(acc, da, gmma_desc(sm.st[pc][pn] + off, 16, 1024),
                 kk > 0 || pc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  __syncthreads();  // every warp is done with the state: the ring takes it
  for (int t = 0; t < 2 && t <= rt; ++t) {
    load_bc(sm.ring[t].b[0], CB_PANEL, bbase, a.bs, c0, t * CB_TILE, CB_TILE,
            q, a.s, tid);
    load_x(sm.ring[t].x, xbase, a.xs, c0, t * CB_TILE, q, a.s, tid);
    cp_async_commit();
  }
  const float li0 = sm.l[r0 + rw], li1 = sm.l[r0 + rw + 8];
  if (c > 0) {
    const float e0 = expf(li0), e1 = expf(li1);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= (i >> 1) & 1 ? e1 : e0;
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }

  float sc[32];
  uint32_t fr[3][4][4];
  for (int kt = 0; kt <= rt; ++kt) {
    const int k0 = kt * CB_TILE;
    if (kt < rt) cp_async_wait<1>();  // tile kt + 1 may still be in flight
    else cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    CoStage& stg = sm.ring[kt & 1];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SSD_N / 16; ++kk) {
      const int pn = kk >> 2, off = (kk & 3) * 32;
      wgmma_ss(sc, gmma_desc(sm.c[pn] + off, 16, 1024),
               gmma_desc(stg.b[pn] + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // m = scores e^{min(Li - Lj, 0)} dt_j on and below the diagonal;
    // element i: row rw + 8 ((i / 2) % 2), key k0 + (i / 4) * 8 + kq + i % 2
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + rw + ((i >> 1) & 1) * 8;
      const int key = k0 + (i >> 2) * 8 + kq + (i & 1);
      const float li = (i >> 1) & 1 ? li1 : li0;
      sc[i] = key <= row
                  ? sc[i] * expf(fminf(li - sm.l[key], 0.f)) * sm.dt[key]
                  : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split3(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], fr[0][kk][j],
               fr[1][kk][j], fr[2][kk][j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = gmma_desc(stg.x + kk * 16 * 128, CB_PANEL, 1024);
      wgmma_rs(acc, fr[0][kk], dx);
      wgmma_rs(acc, fr[1][kk], dx);
      wgmma_rs(acc, fr[2][kk], dx);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fr);
    if (kt + 2 <= rt) {  // refill this stage with tile kt + 2
      __syncthreads();
      load_bc(stg.b[0], CB_PANEL, bbase, a.bs, c0, k0 + 2 * CB_TILE, CB_TILE,
              q, a.s, tid);
      load_x(stg.x, xbase, a.xs, c0, k0 + 2 * CB_TILE, q, a.s, tid);
      cp_async_commit();
    }
  }

  bf16* ybase = a.y + b * a.yb + (long long)h * a.yh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = r0 + rw + 8 * half;
    const long long pos = c0 + l;
    if (l >= q || pos >= a.s) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(ybase + pos * a.ys);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[(8 * j + kq) / 2] = pack_bf16(acc[4 * j + 2 * half],
                                        acc[4 * j + 2 * half + 1]);
  }
}

static int launch_bf16(const CbArgs& a, int batch, cudaStream_t stream) {
  static unsigned long long set_a = 0, set_c = 0;
  const int smem_a = (int)sizeof(CsSmem) + 1024;  // + the 1024-byte align
  const int smem_c = (int)sizeof(CoSmem) + 1024;
  cudaError_t e = smem_opt_in(ssd_chunk_state_kernel, smem_a, &set_a);
  if (e == cudaSuccess) e = smem_opt_in(ssd_chunk_out_kernel, smem_c, &set_c);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (a.chunk + CB_TILE - 1) / CB_TILE;
  if (batch > 65535 || a.h > 65535 ||
      (long long)a.nc * ntiles > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_state_kernel<<<dim3((unsigned)a.nc, (unsigned)a.h,
                                (unsigned)batch),
                           CB_THREADS, smem_a, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_state_pass_kernel<<<dim3(SSD_P * SSD_N / (4 * CB_PASS_THREADS),
                               (unsigned)a.h, (unsigned)batch),
                          CB_PASS_THREADS, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_out_kernel<<<dim3((unsigned)(a.nc * ntiles), (unsigned)a.h,
                              (unsigned)batch),
                         CB_THREADS, smem_c, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ entry point
// Launches one chunk scan by route: 0 float32 on the CUDA cores (one
// kernel; x, B, C and y float32, or bf16 where `is_bf16`; state dim 64 or
// 128), 1 bf16 on the
// tensor cores (three kernels; x, B, C and y bf16; `states` holds batch *
// heads * NC * 64 * 128 floats, `pieces` batch * heads * NC * 48 KiB and
// `lbuf` batch * heads * NC * chunk floats, NC = ceil(seq / chunk)).
// `strides` holds 15 element strides: (batch, seq, head) of x, dt, B, C
// (head = group for B and C) and y, in that order; x, B, C and y have a
// contiguous last dimension.  dt and a_log are float32 and `fin` a
// contiguous (batch, heads, 64, state_dim) float32 tensor.  Returns the
// cudaError_t of the launch(es).
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_log, const void* bm,
                               const void* cm, void* y, void* fin,
                               const long long* strides, int batch,
                               int seq, int heads, int groups, int head_dim,
                               int state_dim, int chunk, int route,
                               int is_bf16, void* states, void* pieces,
                               void* lbuf, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || groups <= 0 ||
      heads % groups != 0 || head_dim != SSD_P ||
      (state_dim != SSD_N && (route != 0 || state_dim != 64)) ||
      chunk <= 0 || chunk > SSD_MAX_CHUNK || route < 0 || route > 1 ||
      (route == 1 && (!is_bf16 ||
       states == nullptr || pieces == nullptr || lbuf == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == 0) {
    SsdArgs a;
    a.x = x; a.dt = static_cast<const float*>(dt);
    a.a_log = static_cast<const float*>(a_log);
    a.bm = bm; a.cm = cm; a.y = y; a.fin = static_cast<float*>(fin);
    a.xb = strides[0]; a.xs = strides[1]; a.xh = strides[2];
    a.db = strides[3]; a.ds = strides[4]; a.dh = strides[5];
    a.bb = strides[6]; a.bs = strides[7]; a.bg = strides[8];
    a.cb = strides[9]; a.cs = strides[10]; a.cg = strides[11];
    a.yb = strides[12]; a.ys = strides[13]; a.yh = strides[14];
    a.s = seq; a.h = heads; a.g = groups; a.chunk = chunk;
    if (state_dim == 64)
      return is_bf16 ? launch_typed<__nv_bfloat16, 64>(a, batch, s)
                     : launch_typed<float, 64>(a, batch, s);
    return is_bf16 ? launch_typed<__nv_bfloat16, SSD_N>(a, batch, s)
                   : launch_typed<float, SSD_N>(a, batch, s);
  }
  CbArgs a;
  a.x = static_cast<const bf16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.a_log = static_cast<const float*>(a_log);
  a.bm = static_cast<const bf16*>(bm);
  a.cm = static_cast<const bf16*>(cm);
  a.y = static_cast<bf16*>(y);
  a.fin = static_cast<float*>(fin);
  a.states = static_cast<float*>(states);
  a.pieces = static_cast<uint8_t*>(pieces);
  a.lbuf = static_cast<float*>(lbuf);
  a.xb = strides[0]; a.xs = strides[1]; a.xh = strides[2];
  a.db = strides[3]; a.ds = strides[4]; a.dh = strides[5];
  a.bb = strides[6]; a.bs = strides[7]; a.bg = strides[8];
  a.cb = strides[9]; a.cs = strides[10]; a.cg = strides[11];
  a.yb = strides[12]; a.ys = strides[13]; a.yh = strides[14];
  a.s = seq; a.h = heads; a.g = groups; a.chunk = chunk;
  a.nc = (seq + chunk - 1) / chunk;
  return launch_bf16(a, batch, s);
}
