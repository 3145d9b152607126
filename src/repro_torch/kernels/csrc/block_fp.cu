// Block fingerprint kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_fp/kernel.py
// (`fingerprint_blocks`, body `_fp_kernel`).  For every `block_bytes` block
// of every leaf of one checkpoint unit it computes, over the leaf's raw
// little-endian bytes zero-padded to whole blocks and viewed as uint32
// words w[0..]:
//
//   fp1 = sum(w[i])           mod 2^32
//   fp2 = sum((i + 1) * w[i]) mod 2^32
//   ss  = sum(float(x)^2)     over the block's elements (advisory)
//
// What bounds it: bytes.  Each input byte is read once and a block's
// result is 12 bytes, so the least time is (unit bytes) / 3.35 TB/s; for a
// full-width Yi-9B block's optimizer unit (2.08 GB) that is about 0.62 ms.
// The arithmetic (3 integer ops per word, 2 float ops per element) is far
// below the CUDA cores' rate.
//
// What the design does about it:
// - One launch per unit.  The leaf table (pointer, byte length, dtype code,
//   first global block) is passed by value in the kernel's parameter space,
//   so a launch needs no device allocation and no host-to-device copy.
// - One CTA per block (the per-block code is fp_block.cuh, shared with
//   block_gather.cu).  A 64 KiB block is 4096 16-byte vectors; 256 threads
//   each issue 16 coalesced 16-byte loads.  A block that is not 16-byte
//   aligned or not wholly inside the leaf (the ragged tail, e.g. an
//   odd-length bf16 leaf that ends mid-word) takes a byte path that reads
//   zeros past the leaf's end.
// - The uint32 sums wrap and are order-independent, so they are bit-exact
//   against the host oracle (block_fp/ref.py `fingerprint_bytes`).
// - The float sum of squares is reduced in a fixed order (per-thread
//   sequential, then a fixed shuffle/shared-memory tree, no atomics), so an
//   unchanged unit scores bitwise the same in every run.
#include "fp_block.cuh"

#define FP_MAX_LEAVES 64

struct FpLeaf {
  const unsigned char* ptr;
  long long nbytes;
  long long first_block;  // index of this leaf's first block in the launch
  int dtype;
  int itemsize;
};

struct FpTable {
  FpLeaf leaves[FP_MAX_LEAVES];
  int n;
};

__global__ void __launch_bounds__(FP_THREADS)
block_fp_kernel(const FpTable tab, long long block_bytes,
                uint32_t* __restrict__ fp_out, float* __restrict__ ss_out) {
  const long long gb = blockIdx.x;
  int l = 0;
  for (int i = 1; i < tab.n; ++i) {
    if (tab.leaves[i].first_block <= gb) l = i;
  }
  const FpLeaf leaf = tab.leaves[l];
  const long long off = (gb - leaf.first_block) * block_bytes;
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
  }
}

// Launches one fingerprint pass over `n` leaves (n <= FP_MAX_LEAVES) whose
// blocks are numbered 0..total_blocks-1 in table order.  fp_out holds
// total_blocks * 2 uint32, ss_out total_blocks float32.  Returns the
// cudaError_t of the launch.
extern "C" int block_fp_launch(const FpLeaf* leaves, int n,
                               long long block_bytes, long long total_blocks,
                               void* fp_out, void* ss_out, void* stream) {
  if (n <= 0 || n > FP_MAX_LEAVES || total_blocks <= 0 ||
      total_blocks > 0x7fffffffLL || block_bytes <= 0 || block_bytes % 4) {
    return (int)cudaErrorInvalidValue;
  }
  FpTable tab;
  for (int i = 0; i < n; ++i) tab.leaves[i] = leaves[i];
  tab.n = n;
  block_fp_kernel<<<(unsigned)total_blocks, FP_THREADS, 0,
                    (cudaStream_t)stream>>>(
      tab, block_bytes, (uint32_t*)fp_out, (float*)ss_out);
  return (int)cudaGetLastError();
}
