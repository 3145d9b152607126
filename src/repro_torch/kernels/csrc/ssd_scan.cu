// Mamba2 SSD chunk scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
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
// all in float32 from x, B, C cast to float32; y is written in x's dtype,
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
// L is a prefix sum over up to 256 steps taken by one thread in a fixed
// order (separately rounded product and sum, as dt * a then cumsum), so two
// launches give bitwise-equal outputs.
//
// What bounds it: operations.  At the serve prefill shape (batch 8, 1024
// tokens, 32 heads, P 64, N 128, Q 256, one group) the four contractions
// are ~34 GFLOP against ~81 MB that must move.  This first version computes
// in float32 on the CUDA cores, so it sits far above the tensor-core bound;
// bf16 wgmma and a chunk-parallel two-pass design are for a later version.
//
// What the design does about it:
// - One CTA of 256 threads per (batch, head), looping over the chunks; the
//   state stays in shared memory (transposed, [N][P], 32 KiB) for the whole
//   sequence, so it never goes to device memory between chunks.
// - The (Q x Q) score matrix (256 KiB at Q = 256) does not fit shared
//   memory: y is built in tiles of 64 query rows, each against the causal
//   key tiles of 64 keys at or before it (tiles above the diagonal are
//   skipped).  C, B and the decayed scores sit transposed ([N][row],
//   [N][key], [key][row]) so each thread's 4 x 4 block of outputs reads one
//   float4 of rows and one of columns per step; x stays [key][P].
// - The state update (P x N) runs after every row tile of the chunk has
//   read the old state; each thread keeps a 4 x 8 block of the update in
//   registers while B ([key][N]) and the weighted x tiles stream through.
// Shared memory: 130 KiB, one CTA per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS, 1)
ssd_scan_kernel(const SsdArgs a) {
  constexpr int P = SSD_P, N = SSD_N, TT = SSD_T;
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
  const int cg = tid & 15;  // cols cg*4 .. +3 (state update: n cg*8 .. +7)
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
    float upd[4][8];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int n = 0; n < 8; ++n) upd[p][n] = 0.f;
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
        const float4 b0 = *reinterpret_cast<const float4*>(bR + j * N +
                                                           cg * 8);
        const float4 b1 = *reinterpret_cast<const float4*>(bR + j * N +
                                                           cg * 8 + 4);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
        const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int n = 0; n < 8; ++n) upd[p][n] = fmaf(wa[p], ba[n],
                                                       upd[p][n]);
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* row = sT + (cg * 8 + n) * P + rg * 4;
#pragma unroll
      for (int p = 0; p < 4; ++p) row[p] = row[p] * decay + upd[p][n];
    }
    __syncthreads();  // the next chunk reads the new state
  }

  // final state (P, N): this thread's 4 x 8 block, as two float4 per p
  float* fin = a.fin + (b * a.h + h) * (long long)(P * N);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) v[n] = sT[(cg * 8 + n) * P + rg * 4 + p];
    put8(fin + (rg * 4 + p) * N + cg * 8, v);
  }
}

static int smem_bytes() {
  return (SSD_N * SSD_P + 2 * SSD_N * SSD_T + SSD_T * SSD_P +
          SSD_T * SSD_T + 2 * SSD_MAX_CHUNK) * (int)sizeof(float);
}

template <typename T>
static int launch_typed(const SsdArgs& a, int batch, cudaStream_t stream) {
  const int smem = smem_bytes();
  // The shared-memory opt-in is a per-device attribute: set it once for
  // each device this instantiation runs on.
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !(attr_set & (1ULL << dev))) {
    e = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    attr_set |= 1ULL << dev;
  }
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)a.h, (unsigned)batch);
  ssd_scan_kernel<T><<<grid, SSD_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Launches one chunk scan.  `strides` holds 15 element strides: (batch,
// seq, head) of x, dt, B, C (head = group for B and C) and y, in that
// order; x, B, C and y have a contiguous last dimension.  `is_bf16` selects
// bf16 (1) or float32 (0) for x, B, C and y; dt and a_log are float32 and
// `fin` a contiguous (batch, heads, 64, 128) float32 tensor.  Returns the
// cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_log, const void* bm,
                               const void* cm, void* y, void* fin,
                               const long long* strides, int batch,
                               int seq, int heads, int groups, int head_dim,
                               int state_dim, int chunk, int is_bf16,
                               void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || groups <= 0 ||
      heads % groups != 0 || head_dim != SSD_P || state_dim != SSD_N ||
      chunk <= 0 || chunk > SSD_MAX_CHUNK) {
    return (int)cudaErrorInvalidValue;
  }
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
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_typed<__nv_bfloat16>(a, batch, s)
                 : launch_typed<float>(a, batch, s);
}
