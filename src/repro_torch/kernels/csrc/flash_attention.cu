// Flash attention forward (online softmax, grouped-query heads) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:71
// (`flash_attention_bhsd`, body `_flash_kernel`) and computes its function:
//
//   s  = float(q) . float(k) * scale          (float32; scale = f32(D**-0.5))
//   s  = NEG_INF where causal and q_pos < k_pos   (top-left: both from 0)
//   m  = running max, l = running sum of p = exp(s - m), both float32
//   acc = acc * exp(m_old - m) + p . float(v) (p kept to >= 16 bits)
//   out = acc / max(l, 1e-30)                 (cast to q's dtype)
//
// Query head h reads kv head h / (H / G).  Inputs use the public
// (B, S, heads, D) layout with any strides whose last dimension is
// contiguous (16-byte strides), so prefill passes its projections and
// decode passes the cache prefix view cache[:, :pos + 1] without a copy.
// The wrapper (flash_attention/ops.py) picks one of three routes from the
// dtype and Sq alone; each launches its kernels or returns the error:
//
// 1. bf16 prefill (Sq >= PREFILL_MIN_QUERIES of ops.py), bound by
//    operations (the serve prefill, 8 x 1024 tokens, 32 / 4 heads, D 128,
//    causal: 68.7 GFLOP against 151 MB).  bf16 tensor cores: one CTA per
//    (128 query positions of one query head, batch), heads fastest in the
//    grid and the heavy (late) query tiles first, two consumer warpgroups
//    of 64 rows and one producer warp.  The producer keeps the K and V
//    tiles (64 keys) of the head's kv group in flight in a 3-stage ring
//    fed by TMA (128B swizzle, 4-D tensor maps over the strided views,
//    ragged edges zero-filled), with mbarriers; the group's other heads
//    read the same K/V from L2.  S = Q.K^T is one wgmma chain with f32
//    accumulation; the scale is applied to S after the product; row
//    statistics reduce over the quad that holds a row.  P.V takes p as
//    two bf16 register operands, p_hi = bf16(p) and p_lo = bf16(p - p_hi),
//    on the same V tile (the transpose bit): 1.5x the operations of a
//    single-product kernel, but p keeps 16 significant bits.  Rounding p
//    to bf16 alone (as SDPA does) puts the serve-shape output ~76x past
//    its two-ulp limit on ~39% of the elements, TF32 8x on 9%; hi + lo
//    stays within 0.49 of it on 0.2% (an emulation on the CPU,
//    tests/test_torch_flash_attention.py).  Tile t - 1's P.V overlaps tile
//    t's softmax.  Causal tiles wholly above the diagonal are never loaded.
// 2. bf16 decode (fewer queries), bound by bytes (the k/v cache).
//    Split-K: a grid (splits, kv head x 8-row tiles, batch), each CTA
//    streams one contiguous slice of the keys through a 3-stage cp.async
//    ring and keeps scores and p in float32 on the CUDA cores (8 rows are
//    too few for a tensor-core tile); it writes its (m, l, acc) in float32
//    to the wrapper's scratch, and a second kernel merges the slices:
//    out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30).
//    The split length gives >= 2 CTAs per SM at the serve shape.
// 3. float32: CUDA cores throughout (TF32 cannot meet float32's 2e-5),
//    one CTA per (batch, kv head, 64 rows of (position, head of group)).
//    No serve path runs attention in float32.
//
// ptxas (CUDA 12.9, sm_90a, -O3), registers per thread, no spills in any:
// prefill (flash_attention_kernel_wgmma) 126 at D 64, 154 at D 128;
// decode partial (_split) 70 / 68, merge (_combine) 32 / 32; float32
// (flash_attention_kernel) 111 / 121.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define FA_ROWS 64
#define FA_KEYS 64
#define FA_THREADS 256
#define FA_NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void unpack8(const uint4 u, float* x) {
  x[0] = __uint_as_float(u.x << 16); x[1] = __uint_as_float(u.x & 0xFFFF0000u);
  x[2] = __uint_as_float(u.y << 16); x[3] = __uint_as_float(u.y & 0xFFFF0000u);
  x[4] = __uint_as_float(u.z << 16); x[5] = __uint_as_float(u.z & 0xFFFF0000u);
  x[6] = __uint_as_float(u.w << 16); x[7] = __uint_as_float(u.w & 0xFFFF0000u);
}

__device__ __forceinline__ void load8(const bf16* p, float* x) {
  unpack8(*reinterpret_cast<const uint4*>(p), x);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// ------------------------------------------------------- route 3: float32
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

template <int D>
static int launch_f32(const FaArgs& a, int batch, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const int smem = (3 * D * FA_ROWS + FA_KEYS * FA_ROWS) * (int)sizeof(float);
  cudaError_t e = smem_opt_in(flash_attention_kernel<float, D>, smem,
                              &attr_set);
  if (e != cudaSuccess) return (int)e;
  const long long nrows = (long long)a.sq * (a.h / a.g);
  const long long tiles = (nrows + FA_ROWS - 1) / FA_ROWS;
  if (tiles > 0x7FFFFFFFLL || a.g > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)tiles, (unsigned)a.g, (unsigned)batch);
  flash_attention_kernel<float, D><<<grid, FA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ route 1: bf16 prefill
#define PF_ROWS 128     // query positions per CTA: two warpgroups of 64
#define PF_KEYS 64      // keys per K/V tile
#define PF_STAGES 3     // K/V tiles in flight
#define PF_THREADS 288  // two consumer warpgroups + one producer warp
#define PF_PANEL 8192   // a Q panel: 64 rows x 64 bf16 (128 B)
#define PF_KV_PANEL (PF_KEYS * 128)  // a K or V panel: PF_KEYS rows

// One CTA's shared memory.  Every panel is a TMA box of 64 rows x 64
// columns under the 128B swizzle, on 1024 bytes (the swizzle atom: 8 rows
// of 128 B); a D = 128 row spans two panels.
template <int D>
struct PfSmem {
  uint8_t q[2][D / 64][PF_PANEL];
  uint8_t k[PF_STAGES][D / 64][PF_KV_PANEL];
  uint8_t v[PF_STAGES][D / 64][PF_KV_PANEL];
  uint64_t q_full;
  uint64_t k_full[PF_STAGES];
  uint64_t v_full[PF_STAGES];
  uint64_t empty[PF_STAGES];
};

struct PfArgs {
  void* o;
  long long ob, os, oh;  // elements
  int sq, sk, h, g, causal;
  float scale_log2;      // scale * log2(e): p = exp2(s * scale_log2 - m)
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issues S = Q . K^T for one warpgroup's 64 rows and one K tile: D / 16
// k-steps of 32 bytes along the swizzled rows; commits the group.
template <int D>
__device__ __forceinline__ void pf_qk(float (&s)[PF_KEYS / 2],
                                      const uint8_t (*q)[PF_PANEL],
                                      const uint8_t (*k)[PF_KV_PANEL]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, off = (kk % 4) * 32;
    wgmma_ss(s, gmma_desc(q[p] + off, 16, 1024),
             gmma_desc(k[p] + off, 16, 1024), kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Issues O += P_hi . V + P_lo . V on one V tile and commits the group.  V
// is (keys x D), D contiguous: the MN-major B operand (the transpose bit),
// its 64-column panels LBO apart, its 8-key groups SBO apart.
template <int D>
__device__ __forceinline__ void pf_pv(float (&o)[D / 2],
                                      const uint32_t (&ph)[PF_KEYS / 16][4],
                                      const uint32_t (&pl)[PF_KEYS / 16][4],
                                      const uint8_t (*v)[PF_KV_PANEL]) {
#pragma unroll
  for (int kk = 0; kk < PF_KEYS / 16; ++kk) {
    const uint64_t dv = gmma_desc(v[0] + kk * 16 * 128, PF_KV_PANEL, 1024);
    wgmma_rs(o, ph[kk], dv);
    wgmma_rs(o, pl[kk], dv);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The online softmax of one tile, in place (s -> p), for the thread's two
// rows (each lives on one quad).  Column c of the tile is masked where
// c > lim (lim: the row's last visible key, less the tile's first key and
// cq), with selects, not branches.  Max and m in raw score units; p =
// 2^(s * sl - m * sl).  l keeps this thread's share: the quad sums it at
// the end.
__device__ __forceinline__ void pf_softmax(float (&s)[PF_KEYS / 2],
                                           float& m0, float& m1, float& l0,
                                           float& l1, float& al0,
                                           float& al1, int lim0, int lim1,
                                           float sl) {
  float mx0 = FA_NEG_INF, mx1 = FA_NEG_INF;
#pragma unroll
  for (int i = 0; i < PF_KEYS / 2; ++i) {
    const int c = (i / 4) * 8 + (i % 2);
    if ((i / 2) % 2) {
      s[i] = c > lim1 ? FA_NEG_INF : s[i];
      mx1 = fmaxf(mx1, s[i]);
    } else {
      s[i] = c > lim0 ? FA_NEG_INF : s[i];
      mx0 = fmaxf(mx0, s[i]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  const float ns0 = n0 * sl, ns1 = n1 * sl;
  al0 = ex2(fmaf(m0, sl, -ns0));
  al1 = ex2(fmaf(m1, sl, -ns1));
  m0 = n0;
  m1 = n1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < PF_KEYS / 2; ++i) {
    const float p = ex2(fmaf(s[i], sl, (i / 2) % 2 ? -ns1 : -ns0));
    s[i] = p;
    if ((i / 2) % 2) sum1 += p; else sum0 += p;
  }
  l0 = l0 * al0 + sum0;
  l1 = l1 * al1 + sum1;
}

// O *= alpha per row; p as two bf16 A operands in the accumulator's own
// layout: hi = bf16(p), lo = bf16(p - hi).
template <int D>
__device__ __forceinline__ void pf_rescale_pack(
    float (&o)[D / 2], const float (&s)[PF_KEYS / 2], float al0, float al1,
    uint32_t (&ph)[PF_KEYS / 16][4], uint32_t (&pl)[PF_KEYS / 16][4]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= (i / 2) % 2 ? al1 : al0;
#pragma unroll
  for (int kk = 0; kk < PF_KEYS / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
      const uint32_t hi = pack_bf16(x0, x1);
      ph[kk][j] = hi;
      pl[kk][j] = pack_bf16(x0 - __uint_as_float(hi << 16),
                            x1 - __uint_as_float(hi & 0xFFFF0000u));
    }
  }
}

// Tiles of keys warpgroup `wg` of the CTA at query position s0 reads: none
// when its rows start past Sq; under the causal mask only keys below its
// last row + 1.
__device__ __forceinline__ int pf_tiles(const PfArgs& a, int s0, int wg) {
  const int r0 = s0 + wg * 64;
  if (r0 >= a.sq) return 0;
  int kend = a.sk;
  if (a.causal) kend = min(kend, min(a.sq, r0 + 64));
  return (kend + PF_KEYS - 1) / PF_KEYS;
}

template <int D>
__global__ void __launch_bounds__(PF_THREADS, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const PfArgs a) {
  constexpr int NP = D / 64;  // panels per row
  extern __shared__ uint8_t pf_raw[];
  // align to the 1024-byte swizzle atom
  const uint32_t base = smem_u32(pf_raw);
  PfSmem<D>& sm = *reinterpret_cast<PfSmem<D>*>(
      pf_raw + ((1024 - (base & 1023)) & 1023));

  const int s0 = (gridDim.y - 1 - blockIdx.y) * PF_ROWS;  // heavy first
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int gi = h / (a.h / a.g);
  const int nt0 = pf_tiles(a, s0, 0), nt1 = pf_tiles(a, s0, 1);
  const int ntiles = max(nt0, nt1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int i = 0; i < PF_STAGES; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.empty[i], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: one thread issues every TMA copy
    if (lane != 0) return;
    mbar_expect_tx(&sm.q_full, 2 * NP * PF_PANEL);
    for (int wg = 0; wg < 2; ++wg)
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sm.q[wg][p], &tm_q, &sm.q_full, p * 64, s0 + wg * 64, h,
                    b);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % PF_STAGES;
      if (t >= PF_STAGES) mbar_wait(&sm.empty[st], ((t / PF_STAGES) - 1) & 1);
      mbar_expect_tx(&sm.k_full[st], NP * PF_KV_PANEL);
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sm.k[st][p], &tm_k, &sm.k_full[st], p * 64, t * PF_KEYS,
                    gi, b);
      mbar_expect_tx(&sm.v_full[st], NP * PF_KV_PANEL);
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sm.v[st][p], &tm_v, &sm.v_full[st], p * 64, t * PF_KEYS,
                    gi, b);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows s0 + wg*64 .. + 63; this
  // thread holds rows r0 and r0 + 8 of the wgmma accumulator layout.  Tile
  // t - 1's P.V runs on the tensor cores while tile t's softmax runs on the
  // CUDA cores: S(t) and PV(t - 1) are issued together and the softmax
  // waits for S(t) alone.  No branch lies between a wgmma and its wait
  // (ptxas would serialize the wgmmas).
  const int wg = warp / 4;
  const int nt = wg == 0 ? nt0 : nt1;
  const int r0 = s0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;  // first column of each 8-column group
  // the last key each of the thread's rows sees, less cq
  const int kmax0 = (a.causal ? min(a.sk - 1, r0) : a.sk - 1) - cq;
  const int kmax1 = (a.causal ? min(a.sk - 1, r0 + 8) : a.sk - 1) - cq;
  const float sl = a.scale_log2;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f, al0, al1;
  float s[PF_KEYS / 2];
  uint32_t ph[PF_KEYS / 16][4], pl[PF_KEYS / 16][4];

  mbar_wait(&sm.q_full, 0);
  if (nt > 0) {
    mbar_wait(&sm.k_full[0], 0);
    wgmma_fence();
    pf_qk<D>(s, sm.q[wg], sm.k[0]);
    wgmma_wait<0>();
    fence_regs(s);
    pf_softmax(s, m0, m1, l0, l1, al0, al1, kmax0, kmax1, sl);
    pf_rescale_pack<D>(o, s, al0, al1, ph, pl);
  }
  for (int t = 1; t < nt; ++t) {
    const int st = t % PF_STAGES, sp = (t - 1) % PF_STAGES;
    mbar_wait(&sm.k_full[st], (t / PF_STAGES) & 1);
    mbar_wait(&sm.v_full[sp], ((t - 1) / PF_STAGES) & 1);
    wgmma_fence();
    pf_qk<D>(s, sm.q[wg], sm.k[st]);
    pf_pv<D>(o, ph, pl, sm.v[sp]);
    wgmma_wait<1>();
    fence_regs(s);
    pf_softmax(s, m0, m1, l0, l1, al0, al1, kmax0 - t * PF_KEYS,
               kmax1 - t * PF_KEYS, sl);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[sp]);
    pf_rescale_pack<D>(o, s, al0, al1, ph, pl);
  }
  if (nt > 0) {
    const int sp = (nt - 1) % PF_STAGES;
    mbar_wait(&sm.v_full[sp], ((nt - 1) / PF_STAGES) & 1);
    wgmma_fence();
    pf_pv<D>(o, ph, pl, sm.v[sp]);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[sp]);
  }
  for (int t = nt; t < ntiles; ++t) {  // tiles only the other group reads
    const int st = t % PF_STAGES;
    mbar_wait(&sm.k_full[st], (t / PF_STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* out = static_cast<bf16*>(a.o) + (long long)b * a.ob +
              (long long)h * a.oh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= a.sq) continue;
    const float den = half ? d1 : d0;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (long long)row * a.os);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dst[(8 * j + cq) / 2] = pack_bf16(o[4 * j + 2 * half] / den,
                                        o[4 * j + 2 * half + 1] / den);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D tensor map (D, S, heads, B) over a bf16 view with element strides
// (s, head, batch) and a contiguous last dimension; boxes of 64 x 64 rows
// under the 128B swizzle; rows past S read as zeros.  A dimension of size
// 1 gets a stride the encoder accepts (it is never stepped).
static int make_map(CUtensorMap* map, const void* base, int d, int s,
                    int heads, int batch, long long ss, long long hs,
                    long long bs, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  long long st[3] = {ss, hs, bs};
  long long prev = (long long)d;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = (prev + 7) / 8 * 8;
    prev = st[i] * (long long)dims[i + 1];
  }
  cuuint64_t strides[3] = {(cuuint64_t)st[0] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[2] * 2};
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, estride,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
static int launch_prefill(const FaArgs& a, int batch, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const int smem = (int)sizeof(PfSmem<D>) + 1024;
  cudaError_t e = smem_opt_in(flash_attention_kernel_wgmma<D>, smem,
                              &attr_set);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, a.q, D, a.sq, a.h, batch, a.qs, a.qh, a.qb, 64);
  if (!err)
    err = make_map(&tk, a.k, D, a.sk, a.g, batch, a.ks, a.kh, a.kb, PF_KEYS);
  if (!err)
    err = make_map(&tv, a.v, D, a.sk, a.g, batch, a.vs, a.vh, a.vb, PF_KEYS);
  if (err) return err;
  if (a.h > 65535 || batch > 65535) return (int)cudaErrorInvalidConfiguration;
  PfArgs p;
  p.o = a.o;
  p.ob = a.ob; p.os = a.os; p.oh = a.oh;
  p.sq = a.sq; p.sk = a.sk; p.h = a.h; p.g = a.g; p.causal = a.causal;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  const dim3 grid((unsigned)a.h, (unsigned)((a.sq + PF_ROWS - 1) / PF_ROWS),
                  (unsigned)batch);
  flash_attention_kernel_wgmma<D><<<grid, PF_THREADS, smem, stream>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- route 2: bf16 decode
#define DC_ROWS 8       // (position, head of group) rows per CTA
#define DC_KEYS 32      // keys per pipeline stage: one per lane
#define DC_STAGES 3
#define DC_THREADS 128  // 4 warps x 2 rows
#define DC_RPW (DC_ROWS / 4)  // rows per warp

struct DcArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* part_acc;  // [B][G * row_tiles][splits][DC_ROWS][D]
  float* part_ml;   // [B][G * row_tiles][splits][DC_ROWS][2]
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;  // elements
  int sq, sk, h, g, causal, split_len, splits, row_tiles;
  float scale;
};

// The partial pass: one CTA per (key slice, kv head x row tile, batch).
template <int D>
__global__ void __launch_bounds__(DC_THREADS)
flash_attention_kernel_split(const DcArgs a) {
  constexpr int KP = D + 8;       // padded K row: 16-byte reads conflict-free
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  constexpr int VC = D / 32;      // output columns per lane
  extern __shared__ float4 dc_smem4[];
  float* qsm = reinterpret_cast<float*>(dc_smem4);          // [ROWS][D]
  float* psm = qsm + DC_ROWS * D;                       // [4][KEYS][RPW]
  // [ST][KEYS][KP]
  bf16* ksm = reinterpret_cast<bf16*>(psm + 4 * DC_KEYS * DC_RPW);
  bf16* vsm = ksm + DC_STAGES * DC_KEYS * KP;                // [ST][KEYS][D]

  const int split = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int gi = y / a.row_tiles, f0 = (y % a.row_tiles) * DC_ROWS;
  const int r = a.h / a.g;
  const int nrows = a.sq * r;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const long long pbase =
      (((long long)b * gridDim.y + y) * a.splits + split) * DC_ROWS;

  const int k_lo = split * a.split_len;
  int k_hi = min(a.sk, k_lo + a.split_len);
  if (a.causal) k_hi = min(k_hi, (min(f0 + DC_ROWS, nrows) - 1) / r + 1);
  if (k_hi <= k_lo) {  // every key of the slice is masked for these rows
    for (int i = tid; i < DC_ROWS * D; i += DC_THREADS)
      a.part_acc[pbase * D + i] = 0.f;
    if (tid < DC_ROWS) {
      a.part_ml[(pbase + tid) * 2] = FA_NEG_INF;
      a.part_ml[(pbase + tid) * 2 + 1] = 0.f;
    }
    return;
  }
  const int nch = (k_hi - k_lo + DC_KEYS - 1) / DC_KEYS;
  const bf16* kg = a.k + b * a.kb + (long long)gi * a.kh;
  const bf16* vg = a.v + b * a.vb + (long long)gi * a.vh;

  auto issue = [&](int c) {
    if (c < nch) {
      const int st = c % DC_STAGES, key0 = k_lo + c * DC_KEYS;
      for (int e = tid; e < 2 * DC_KEYS * CPR; e += DC_THREADS) {
        const int which = e / (DC_KEYS * CPR), rem = e % (DC_KEYS * CPR);
        const int key = rem / CPR, dc = rem % CPR;
        const bool ok = key0 + key < k_hi;
        const long long kk = ok ? key0 + key : 0;
        if (which == 0)
          cp_async16(ksm + (st * DC_KEYS + key) * KP + dc * 8,
                     kg + kk * a.ks + dc * 8, ok);
        else
          cp_async16(vsm + (st * DC_KEYS + key) * D + dc * 8,
                     vg + kk * a.vs + dc * 8, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int c = 0; c < DC_STAGES - 1; ++c) issue(c);

  for (int i = tid; i < DC_ROWS * CPR; i += DC_THREADS) {
    const int row = i / CPR, dc = i % CPR, f = f0 + row;
    float x[8];
    if (f < nrows) {
      load8(a.q + b * a.qb + (long long)(f / r) * a.qs +
                (long long)(gi * r + f % r) * a.qh + dc * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    store4(qsm + row * D + dc * 8, x[0], x[1], x[2], x[3]);
    store4(qsm + row * D + dc * 8 + 4, x[4], x[5], x[6], x[7]);
  }

  int pos[DC_RPW];
  bool live[DC_RPW];
#pragma unroll
  for (int i = 0; i < DC_RPW; ++i) {
    const int f = f0 + w * DC_RPW + i;
    live[i] = f < nrows;
    pos[i] = f / r;
  }
  float m[DC_RPW], l[DC_RPW], acc[DC_RPW][VC];
#pragma unroll
  for (int i = 0; i < DC_RPW; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < VC; ++c) acc[i][c] = 0.f;
  }

  for (int c = 0; c < nch; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DC_STAGES - 2) : "memory");
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    issue(c + DC_STAGES - 1);
    const int st = c % DC_STAGES;
    const int key = k_lo + c * DC_KEYS + lane;

    // scores of this lane's key for the warp's rows
    float s[DC_RPW];
#pragma unroll
    for (int i = 0; i < DC_RPW; ++i) s[i] = 0.f;
    const bf16* krow = ksm + (st * DC_KEYS + lane) * KP;
#pragma unroll 4
    for (int dc = 0; dc < CPR; ++dc) {
      float kx[8];
      unpack8(*reinterpret_cast<const uint4*>(krow + dc * 8), kx);
#pragma unroll
      for (int i = 0; i < DC_RPW; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(
            qsm + (w * DC_RPW + i) * D + dc * 8);
        const float4 qb = *reinterpret_cast<const float4*>(
            qsm + (w * DC_RPW + i) * D + dc * 8 + 4);
        s[i] = fmaf(qa.x, kx[0], s[i]); s[i] = fmaf(qa.y, kx[1], s[i]);
        s[i] = fmaf(qa.z, kx[2], s[i]); s[i] = fmaf(qa.w, kx[3], s[i]);
        s[i] = fmaf(qb.x, kx[4], s[i]); s[i] = fmaf(qb.y, kx[5], s[i]);
        s[i] = fmaf(qb.z, kx[6], s[i]); s[i] = fmaf(qb.w, kx[7], s[i]);
      }
    }
    float p[DC_RPW];
#pragma unroll
    for (int i = 0; i < DC_RPW; ++i) {
      const bool ok = live[i] && key < k_hi && !(a.causal && key > pos[i]);
      float mx = ok ? s[i] : FA_NEG_INF;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      p[i] = ok ? expf(s[i] - mn) : 0.f;
      float sum = p[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - mn);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int cc = 0; cc < VC; ++cc) acc[i][cc] *= alpha;
    }
    float* pw = psm + w * DC_KEYS * DC_RPW;
#pragma unroll
    for (int i = 0; i < DC_RPW; ++i) pw[lane * DC_RPW + i] = p[i];
    __syncwarp();
    const bf16* vs = vsm + st * DC_KEYS * D + lane * VC;
#pragma unroll 8
    for (int j = 0; j < DC_KEYS; ++j) {
      float vx[VC];
      if constexpr (VC == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(vs + j * D);
        vx[0] = __uint_as_float(u.x << 16);
        vx[1] = __uint_as_float(u.x & 0xFFFF0000u);
        vx[2] = __uint_as_float(u.y << 16);
        vx[3] = __uint_as_float(u.y & 0xFFFF0000u);
      } else {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(vs + j * D);
        vx[0] = __uint_as_float(u << 16);
        vx[1] = __uint_as_float(u & 0xFFFF0000u);
      }
#pragma unroll
      for (int i = 0; i < DC_RPW; ++i) {
        const float pr = pw[j * DC_RPW + i];
#pragma unroll
        for (int cc = 0; cc < VC; ++cc)
          acc[i][cc] = fmaf(pr, vx[cc], acc[i][cc]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < DC_RPW; ++i) {
    const long long row = pbase + w * DC_RPW + i;
#pragma unroll
    for (int cc = 0; cc < VC; ++cc)
      a.part_acc[row * D + lane * VC + cc] = acc[i][cc];
    if (lane == 0) {
      a.part_ml[row * 2] = m[i];
      a.part_ml[row * 2 + 1] = l[i];
    }
  }
}

// The merge: one warp per row, lanes over the slices and then over D.
template <int D>
__global__ void __launch_bounds__(DC_ROWS * 32)
flash_attention_kernel_combine(const DcArgs a) {
  constexpr int VC = D / 32;
  const int y = blockIdx.x, b = blockIdx.y;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = y / a.row_tiles, f = (y % a.row_tiles) * DC_ROWS + w;
  const int r = a.h / a.g;
  if (f >= a.sq * r) return;
  const long long p0 = ((long long)b * gridDim.x + y) * a.splits;
  float mmax = FA_NEG_INF;
  for (int s = lane; s < a.splits; s += 32)
    mmax = fmaxf(mmax, a.part_ml[((p0 + s) * DC_ROWS + w) * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mmax = fmaxf(mmax, __shfl_xor_sync(0xffffffffu, mmax, off));
  float den = 0.f;
  for (int s = lane; s < a.splits; s += 32) {
    const float* ml = a.part_ml + ((p0 + s) * DC_ROWS + w) * 2;
    den += expf(ml[0] - mmax) * ml[1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, off);
  float acc[VC];
#pragma unroll
  for (int c = 0; c < VC; ++c) acc[c] = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const long long row = (p0 + s) * DC_ROWS + w;
    const float wt = expf(a.part_ml[row * 2] - mmax);
#pragma unroll
    for (int c = 0; c < VC; ++c)
      acc[c] = fmaf(wt, a.part_acc[row * D + lane * VC + c], acc[c]);
  }
  den = fmaxf(den, 1e-30f);
  bf16* dst = a.o + b * a.ob + (long long)(f / r) * a.os +
              (long long)(gi * r + f % r) * a.oh + lane * VC;
#pragma unroll
  for (int c = 0; c < VC; c += 2)
    *reinterpret_cast<uint32_t*>(dst + c) =
        pack_bf16(acc[c] / den, acc[c + 1] / den);
}

template <int D>
static int launch_decode(const FaArgs& fa, int batch, int split_len,
                         int splits, void* scratch, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const int smem =
      (DC_ROWS * D + 4 * DC_KEYS * DC_RPW) * (int)sizeof(float) +
      DC_STAGES * DC_KEYS * (2 * D + 8) * (int)sizeof(bf16);
  cudaError_t e = smem_opt_in(flash_attention_kernel_split<D>, smem,
                              &attr_set);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)fa.sq * (fa.h / fa.g);
  const long long tiles = (rows + DC_ROWS - 1) / DC_ROWS;
  if (split_len <= 0 || splits != (fa.sk + split_len - 1) / split_len ||
      tiles * fa.g > 65535 || batch > 65535)
    return (int)cudaErrorInvalidConfiguration;
  DcArgs a;
  a.q = static_cast<const bf16*>(fa.q);
  a.k = static_cast<const bf16*>(fa.k);
  a.v = static_cast<const bf16*>(fa.v);
  a.o = static_cast<bf16*>(fa.o);
  const long long nparts = batch * tiles * fa.g * splits * DC_ROWS;
  a.part_acc = static_cast<float*>(scratch);
  a.part_ml = a.part_acc + nparts * D;
  a.qb = fa.qb; a.qs = fa.qs; a.qh = fa.qh;
  a.kb = fa.kb; a.ks = fa.ks; a.kh = fa.kh;
  a.vb = fa.vb; a.vs = fa.vs; a.vh = fa.vh;
  a.ob = fa.ob; a.os = fa.os; a.oh = fa.oh;
  a.sq = fa.sq; a.sk = fa.sk; a.h = fa.h; a.g = fa.g; a.causal = fa.causal;
  a.split_len = split_len; a.splits = splits; a.row_tiles = (int)tiles;
  a.scale = fa.scale;
  const dim3 grid((unsigned)splits, (unsigned)(tiles * fa.g),
                  (unsigned)batch);
  flash_attention_kernel_split<D><<<grid, DC_THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid2((unsigned)(tiles * fa.g), (unsigned)batch);
  flash_attention_kernel_combine<D><<<grid2, DC_ROWS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ entry point
// Launches one attention forward by route: 0 float32, 1 bf16 prefill, 2
// bf16 decode (two kernels; `scratch` holds B * G * ceil(Sq * H / G / 16)
// * splits * 16 * (D + 2) floats, `split_len` keys per slice, `splits` =
// ceil(Sk / split_len)).  `strides` holds 12 element strides: (batch, seq,
// head) of q, k, v and out, in that order; the last dimension of each is
// contiguous.  Returns the cudaError_t of the launch(es).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* strides, int batch,
                                      int sq, int sk, int heads,
                                      int kv_heads, int head_dim, int causal,
                                      int route, float scale, int split_len,
                                      int splits, void* scratch,
                                      void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || (head_dim != 64 && head_dim != 128) ||
      route < 0 || route > 2) {
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
  const bool d128 = head_dim == 128;
  if (route == 1)
    return d128 ? launch_prefill<128>(a, batch, s)
                : launch_prefill<64>(a, batch, s);
  if (route == 2)
    return d128 ? launch_decode<128>(a, batch, split_len, splits, scratch, s)
                : launch_decode<64>(a, batch, split_len, splits, scratch, s);
  return d128 ? launch_f32<128>(a, batch, s) : launch_f32<64>(a, batch, s);
}
