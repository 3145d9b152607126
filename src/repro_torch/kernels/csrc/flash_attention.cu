// Flash attention forward (online softmax, grouped-query heads) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_bhsd`, body `_flash_kernel`) and computes its function:
//
//   q' = float(q) * scale                     (scale = float32(D ** -0.5))
//   s  = q' . float(k)                        (float32)
//   s  = NEG_INF where causal and q_pos < k_pos   (top-left: both from 0)
//   m  = running max, l = running sum of p = exp(s - m), both float32
//   acc = acc * exp(m_old - m) + p . float(v) (p stays float32)
//   out = acc / max(l, 1e-30)                 (cast to q's dtype)
//
// Query head h reads kv head h / (H / G).  Inputs use the public
// (B, S, heads, D) layout with any strides whose last dimension is
// contiguous, so prefill passes its projections and decode passes the
// cache prefix view cache[:, :pos + 1] without a transpose.  Keys past Sk
// (a ragged last tile) are masked here; Sk need not be a multiple of the
// tile.  Masked keys contribute exp(NEG_INF - m) = 0, so skipping a tile
// that lies wholly above the causal diagonal changes nothing.
//
// What bounds it: at the prefill shape (8 x 1024 tokens, 32 query / 4 kv
// heads, D 128, causal) operations, ~69 GFLOP against ~151 MB moved; at
// decode (one query per sequence over a 1088-key cache) bytes, the k/v
// cache.  This first version computes in float32 on the CUDA cores, so
// prefill sits far above the tensor-core bound (bf16 wgmma, TMA and a
// split-K decode are for a later version).
//
// What the design does about it:
// - One CTA per (batch, kv head, tile of 64 query rows), where the rows
//   enumerate (query position, query head of the group) pairs: every K/V
//   tile loaded into shared memory serves all H/G query heads of the group
//   (8 at Yi-9B), and a decode step still fills 8 rows of the tile.
// - Q (pre-scaled) and each K tile sit in shared memory transposed
//   ([d][row]) so that the score loop reads one float4 of rows and one of
//   keys per d; each of the 256 threads owns a 4 x 4 block of scores and
//   4 rows x D/16 columns of the output accumulator in registers.
// - Row statistics are reduced across the 16 threads of a row group with
//   warp shuffles; p goes through shared memory (transposed) to the p.v
//   product.
// - Causal tiles wholly above the diagonal are never loaded; the heavy
//   (late) query tiles are scheduled first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_ROWS 64
#define FA_KEYS 64
#define FA_THREADS 256
#define FA_NEG_INF (-1e30f)

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;  // elements
  int sq, sk, h, g, causal;
  float scale;
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

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_attention_kernel(const FaArgs a) {
  constexpr int DC = D / 8;   // 8-element chunks per row
  constexpr int NC = D / 64;  // float4 column groups per thread
  extern __shared__ float4 fa_smem4[];
  float* qT = reinterpret_cast<float*>(fa_smem4);  // [D][FA_ROWS]
  float* kT = qT + D * FA_ROWS;                     // [D][FA_KEYS]
  float* vt = kT + D * FA_KEYS;                     // [FA_KEYS][D]
  float* pT = vt + FA_KEYS * D;                     // [FA_KEYS][FA_ROWS]

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows rg*4 .. rg*4+3
  const int kg = tid & 15;  // keys kg*4 .. kg*4+3 / columns c*64 + kg*4
  const int r = a.h / a.g;
  const long long nrows = (long long)a.sq * r;
  const long long f0 = (long long)(gridDim.x - 1 - blockIdx.x) * FA_ROWS;
  const int gi = blockIdx.y;
  const long long b = blockIdx.z;

  for (int c = tid; c < FA_ROWS * DC; c += FA_THREADS) {
    const int row = c % FA_ROWS, dc = c / FA_ROWS;
    const long long f = f0 + row;
    float x[8];
    if (f < nrows) {
      const long long qi = f / r;
      const long long hh = (long long)gi * r + f % r;
      load8(q + b * a.qb + qi * a.qs + hh * a.qh + dc * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) qT[(dc * 8 + e) * FA_ROWS + row] = x[e];
  }

  const long long f_last =
      (f0 + FA_ROWS < nrows ? f0 + FA_ROWS : nrows) - 1;
  int kend = a.sk;
  if (a.causal && f_last / r + 1 < kend) kend = (int)(f_last / r + 1);
  const int ntiles = (kend + FA_KEYS - 1) / FA_KEYS;
  long long qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (f0 + rg * 4 + i) / r;

  float acc[4][NC * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * FA_KEYS;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < FA_KEYS * DC; c += FA_THREADS) {
      const int key = c % FA_KEYS, dc = c / FA_KEYS;
      float x[8];
      if (k0 + key < kend) {
        load8(k + b * a.kb + (long long)(k0 + key) * a.ks +
                  (long long)gi * a.kh + dc * 8, x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) kT[(dc * 8 + e) * FA_KEYS + key] = x[e];
    }
    for (int c = tid; c < FA_KEYS * DC; c += FA_THREADS) {
      const int key = c / DC, dc = c % DC;
      float x[8];
      if (k0 + key < kend) {
        load8(v + b * a.vb + (long long)(k0 + key) * a.vs +
                  (long long)gi * a.vh + dc * 8, x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(vt + key * D + dc * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + d * FA_ROWS +
                                                         rg * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kT + d * FA_KEYS +
                                                         kg * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + kg * 4 + j;
        if (key >= a.sk || (a.causal && key > qpos[i])) s[i][j] = FA_NEG_INF;
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pT + (kg * 4 + j) * FA_ROWS + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_KEYS; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pT + j * FA_ROWS +
                                                         rg * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cg = 0; cg < NC; ++cg) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            vt + j * D + cg * 64 + kg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][cg * 4 + 0] = fmaf(pv[i], v4.x, acc[i][cg * 4 + 0]);
          acc[i][cg * 4 + 1] = fmaf(pv[i], v4.y, acc[i][cg * 4 + 1]);
          acc[i][cg * 4 + 2] = fmaf(pv[i], v4.z, acc[i][cg * 4 + 2]);
          acc[i][cg * 4 + 3] = fmaf(pv[i], v4.w, acc[i][cg * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long f = f0 + rg * 4 + i;
    if (f >= nrows) continue;
    const long long qi = f / r;
    const long long hh = (long long)gi * r + f % r;
    T* dst = o + b * a.ob + qi * a.os + hh * a.oh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cg = 0; cg < NC; ++cg) {
      store4(dst + cg * 64 + kg * 4, acc[i][cg * 4 + 0] / den,
             acc[i][cg * 4 + 1] / den, acc[i][cg * 4 + 2] / den,
             acc[i][cg * 4 + 3] / den);
    }
  }
}

template <typename T, int D>
static int launch_typed(const FaArgs& a, int batch, cudaStream_t stream) {
  const int smem = (3 * D * FA_ROWS + FA_KEYS * FA_ROWS) * (int)sizeof(float);
  // The shared-memory opt-in is a per-device attribute: set it once for
  // each device this instantiation runs on.
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !(attr_set & (1ULL << dev))) {
    e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    attr_set |= 1ULL << dev;
  }
  const long long nrows = (long long)a.sq * (a.h / a.g);
  const long long tiles = (nrows + FA_ROWS - 1) / FA_ROWS;
  if (tiles > 0x7FFFFFFFLL || a.g > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)tiles, (unsigned)a.g, (unsigned)batch);
  flash_attention_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Launches one attention forward.  `strides` holds 12 element strides:
// (batch, seq, head) of q, k, v and out, in that order; the last dimension
// of each is contiguous.  `is_bf16` selects bf16 (1) or float32 (0) for all
// four tensors.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* strides, int batch,
                                      int sq, int sk, int heads,
                                      int kv_heads, int head_dim, int causal,
                                      int is_bf16, float scale,
                                      void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || (head_dim != 64 && head_dim != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  FaArgs a;
  a.q = q; a.k = k; a.v = v; a.o = out;
  a.qb = strides[0]; a.qs = strides[1]; a.qh = strides[2];
  a.kb = strides[3]; a.ks = strides[4]; a.kh = strides[5];
  a.vb = strides[6]; a.vs = strides[7]; a.vh = strides[8];
  a.ob = strides[9]; a.os = strides[10]; a.oh = strides[11];
  a.sq = sq; a.sk = sk; a.h = heads; a.g = kv_heads; a.causal = causal;
  a.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return head_dim == 128 ? launch_typed<__nv_bfloat16, 128>(a, batch, s)
                           : launch_typed<__nv_bfloat16, 64>(a, batch, s);
  }
  return head_dim == 128 ? launch_typed<float, 128>(a, batch, s)
                         : launch_typed<float, 64>(a, batch, s);
}
