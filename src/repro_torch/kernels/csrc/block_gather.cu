// Fused fingerprint-compare + dirty-block compaction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_gather/kernel.py
// (`gather_compact_blocks`, body `_gather_kernel`).  For every leaf of one
// checkpoint unit, over the leaf's raw bytes cut into `block_bytes` blocks
// (the last one zero-padded), it computes
//
//   fp[b]    the block_fp pair (wrapping uint32 sums, see fp_block.cuh)
//   ss[b]    the float32 sum of squares of the block's elements (advisory)
//   dirty[b] fp[b] != ref[b]   (every block, when the leaf has no ref)
//   idx      the first `capacity` dirty block indices, ascending, -1 fill
//   out      those blocks' bytes, densely, zero fill beyond
//   count    the TOTAL number of dirty blocks (may exceed `capacity`: the
//            overflow signal of the overlapped saver's capacity predictor)
//
// What bounds it: bytes.  It reads the unit once, writes the dirty blocks
// once, and writes and reads tables of a few bytes per block, so the least
// time is (unit bytes + dirty bytes + tables) / 3.35 TB/s.  Nothing here
// approaches the CUDA cores' integer or float rate.
//
// What the design does about it.  The TPU kernel carried the running count
// and the compacted outputs in VMEM across a sequential grid; CUDA blocks
// run in no order and carry nothing, so the work is three launches on one
// stream, each a simple parallel pass:
//   1. one CTA per block (FP_THREADS threads, 16-byte loads where the block
//      is aligned and whole): the fingerprint, by the same device code and
//      fixed-order reduction as block_fp.cu, then the compare -> a flag;
//   2. one CTA per leaf: an exclusive scan of the leaf's flags in chunks of
//      GB_SCAN_THREADS -> idx (ascending by construction) and count;
//   3. one CTA per output slot: copy block idx[slot] with 16-byte vector
//      loads and stores (byte path, zero-padded, for a ragged tail), or
//      zero-fill a slot past min(count, capacity).
// Each leaf is read in place (no padded copy).  The leaf table is passed by
// value in the kernels' parameter space.  No atomics anywhere: fp, ss, idx
// and count are the same in every run.
#include "fp_block.cuh"

#define GB_MAX_LEAVES 32
#define GB_SCAN_THREADS 1024
#define GB_COPY_THREADS 256

struct GatherLeaf {
  const unsigned char* ptr;
  long long nbytes;
  long long first_block;  // this leaf's first block in the launch
  long long n_blocks;
  const uint32_t* ref;    // n_blocks * 2 uint32, or null: all blocks dirty
  long long cap_offset;   // this leaf's first output slot in the launch
  long long capacity;     // output slots of this leaf (>= 1)
  int dtype;
  int itemsize;
};

struct GatherTable {
  GatherLeaf leaves[GB_MAX_LEAVES];
  int n;
};

__global__ void __launch_bounds__(FP_THREADS)
gather_fp_kernel(const GatherTable tab, long long block_bytes,
                 uint32_t* __restrict__ fp_out, float* __restrict__ ss_out,
                 unsigned char* __restrict__ flags) {
  const long long gb = blockIdx.x;
  int l = 0;
  for (int i = 1; i < tab.n; ++i) {
    if (tab.leaves[i].first_block <= gb) l = i;
  }
  const GatherLeaf leaf = tab.leaves[l];
  const long long b = gb - leaf.first_block;
  const long long off = b * block_bytes;
  long long valid = leaf.nbytes - off;
  if (valid > block_bytes) valid = block_bytes;
  if (valid < 0) valid = 0;
  uint32_t s1, s2;
  float ss;
  fp_block(leaf.ptr + off, valid, block_bytes, leaf.dtype, leaf.itemsize,
           &s1, &s2, &ss);
  if (threadIdx.x == 0) {
    fp_out[2 * gb] = s1;
    fp_out[2 * gb + 1] = s2;
    ss_out[gb] = ss;
    bool dirty = true;
    if (leaf.ref != nullptr) {
      dirty = (s1 != leaf.ref[2 * b]) || (s2 != leaf.ref[2 * b + 1]);
    }
    flags[gb] = dirty ? 1 : 0;
  }
}

__global__ void __launch_bounds__(GB_SCAN_THREADS)
gather_scan_kernel(const GatherTable tab,
                   const unsigned char* __restrict__ flags,
                   int* __restrict__ idx_out, int* __restrict__ count_out) {
  const GatherLeaf leaf = tab.leaves[blockIdx.x];
  __shared__ int warp_excl[GB_SCAN_THREADS / 32];
  __shared__ long long chunk_base;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) chunk_base = 0;
  __syncthreads();
  for (long long c0 = 0; c0 < leaf.n_blocks; c0 += GB_SCAN_THREADS) {
    const long long b = c0 + threadIdx.x;
    const int f = (b < leaf.n_blocks) ? flags[leaf.first_block + b] : 0;
    int x = f;  // inclusive scan inside the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_excl[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int w = (lane < GB_SCAN_THREADS / 32) ? warp_excl[lane] : 0;
      int wx = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wx, o);
        if (lane >= o) wx += y;
      }
      if (lane < GB_SCAN_THREADS / 32) warp_excl[lane] = wx - w;
    }
    __syncthreads();
    const long long pos = chunk_base + warp_excl[warp] + (x - f);
    if (f && pos < leaf.capacity) {
      idx_out[leaf.cap_offset + pos] = (int)b;
    }
    __syncthreads();
    if (threadIdx.x == GB_SCAN_THREADS - 1) chunk_base = pos + f;
    __syncthreads();
  }
  const long long total = chunk_base;
  if (threadIdx.x == 0) count_out[blockIdx.x] = (int)total;
  const long long kept = total < leaf.capacity ? total : leaf.capacity;
  for (long long p = kept + threadIdx.x; p < leaf.capacity;
       p += GB_SCAN_THREADS) {
    idx_out[leaf.cap_offset + p] = -1;
  }
}

__global__ void __launch_bounds__(GB_COPY_THREADS)
gather_copy_kernel(const GatherTable tab, long long block_bytes,
                   const int* __restrict__ idx,
                   unsigned char* __restrict__ out) {
  const long long slot = blockIdx.x;
  int l = 0;
  for (int i = 1; i < tab.n; ++i) {
    if (tab.leaves[i].cap_offset <= slot) l = i;
  }
  const GatherLeaf leaf = tab.leaves[l];
  const int b = idx[slot];
  unsigned char* dst = out + slot * block_bytes;
  long long valid = 0;
  const unsigned char* src = nullptr;
  if (b >= 0) {
    const long long off = (long long)b * block_bytes;
    src = leaf.ptr + off;
    valid = leaf.nbytes - off;
    if (valid > block_bytes) valid = block_bytes;
    if (valid < 0) valid = 0;
  }
  const bool vec_dst = (block_bytes % 16 == 0) &&
                       ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0);
  if (vec_dst && valid == block_bytes &&
      (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long k = threadIdx.x; k < block_bytes / 16;
         k += GB_COPY_THREADS) {
      d[k] = __ldg(s + k);
    }
  } else if (vec_dst && valid == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (long long k = threadIdx.x; k < block_bytes / 16;
         k += GB_COPY_THREADS) {
      d[k] = z;
    }
  } else {
    for (long long p = threadIdx.x; p < block_bytes; p += GB_COPY_THREADS) {
      dst[p] = p < valid ? src[p] : (unsigned char)0;
    }
  }
}

// Launches the three passes over `n` leaves (n <= GB_MAX_LEAVES) whose
// blocks are numbered 0..total_blocks-1 and output slots
// 0..total_slots-1 in table order.  fp_out: total_blocks * 2 uint32;
// ss_out: total_blocks float32; flags: total_blocks bytes of scratch;
// idx_out: total_slots int32; out: total_slots * block_bytes bytes;
// count_out: n int32.  Returns the cudaError_t of the launches.
extern "C" int block_gather_launch(const GatherLeaf* leaves, int n,
                                   long long block_bytes,
                                   long long total_blocks,
                                   long long total_slots, void* fp_out,
                                   void* ss_out, void* flags, void* idx_out,
                                   void* out, void* count_out,
                                   void* stream) {
  if (n <= 0 || n > GB_MAX_LEAVES || total_blocks <= 0 ||
      total_blocks > 0x7fffffffLL || total_slots <= 0 ||
      total_slots > 0x7fffffffLL || block_bytes <= 0 || block_bytes % 4) {
    return (int)cudaErrorInvalidValue;
  }
  GatherTable tab;
  for (int i = 0; i < n; ++i) {
    tab.leaves[i] = leaves[i];
    if (leaves[i].capacity <= 0 || leaves[i].n_blocks <= 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  tab.n = n;
  cudaStream_t s = (cudaStream_t)stream;
  gather_fp_kernel<<<(unsigned)total_blocks, FP_THREADS, 0, s>>>(
      tab, block_bytes, (uint32_t*)fp_out, (float*)ss_out,
      (unsigned char*)flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_scan_kernel<<<(unsigned)n, GB_SCAN_THREADS, 0, s>>>(
      tab, (const unsigned char*)flags, (int*)idx_out, (int*)count_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_copy_kernel<<<(unsigned)total_slots, GB_COPY_THREADS, 0, s>>>(
      tab, block_bytes, (const int*)idx_out, (unsigned char*)out);
  return (int)cudaGetLastError();
}
