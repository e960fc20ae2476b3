// Kernels of the DMA probe lab (uninext_tpu_torch/tools/dma_probe.py): row
// gathers by address from a small table whose rows hold the four bilinear
// corners of an MSDA sample (D4 = 4 x 32 values).
//
//   C3 dma_gather_rowsum  for each tile t: out[R_OUT*t + r, :] =
//        sum_{k<K} buf[idx[K*t + k], :] for r < R_OUT (the row sum repeated
//        on R_OUT rows); replaces tools/pallas_dma_probe.py:101 probe_dma
//        (dma_kernel :84), which copied each of a tile's K rows by its own
//        async DMA with its own semaphore, the table in HBM (probe 1) or in
//        VMEM (probe 2);
//   C4 dma_block_gather   out[8i + r, :] = buf[8 * idx[i] + r, :] for r < 8;
//        replaces :129 probe_index_map (imap_kernel :125), whose BlockSpec
//        index map read the block index from scalar-prefetched memory.
//
// Outputs are fp32; tables fp32 or bf16. Indices are not checked: C3's must
// lie in [0, rows of buf), C4's in [0, rows of buf / 8), as on the TPU.
//
// What bounds them on the H100: C3 reads a 4.0 MB table that stays in L2
// while 131072 rows are gathered from it, so its bytes from HBM are the
// table, the indices and a 16.8 MB output (6.4 us at 3.35 TB/s); in
// practice the 4096 tiles' copy latency. C4 writes 537 MB of fp32 blocks,
// so HBM write bandwidth (0.16 ms).
//
// C3 is the card's counterpart of the TPU's K outstanding copies: one
// block per tile issues the tile's K row copies as 1-D bulk async copies
// (`cp.async.bulk`, the copy engine behind TMA) into shared memory, all
// completing on one mbarrier that expects K row sizes of bytes; the block
// waits on the barrier once and then sums each column. Probe 2 gives the
// copies an L2 evict_last policy: an SM's 228 KB cannot hold the table, so
// keeping it in L2 is the nearest counterpart of a table held in VMEM.
// C4 needs no staging: one warp per 8-row block, the block index read in
// the kernel, bf16 -> fp32 in registers and 16-byte streaming stores (the
// output is not read again) that fill whole sectors.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlockRows = 8;       // C4's block: the TPU's sublane tile
constexpr int kRowsumThreads = 128;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// C3: one block per tile. The K rows land in `rows` (K x D4 values, dynamic
// shared memory); lane k of warp 0 issues row k's copy (k, k + 32, ...).
template <typename T, bool kEvictLast>
__global__ void __launch_bounds__(kRowsumThreads)
dma_gather_rowsum_kernel(const T* __restrict__ buf, const int* __restrict__ idx,
                         float* __restrict__ out, int K, int D4, int rows_out) {
  extern __shared__ __align__(128) unsigned char rows_raw[];
  __shared__ __align__(8) uint64_t bar;
  const T* rows = reinterpret_cast<const T*>(rows_raw);
  const long long t = blockIdx.x;
  const uint32_t row_bytes = (uint32_t)D4 * sizeof(T);
  const uint32_t bar_a = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a) : "memory");
    // make the initialised barrier visible to the async proxy (the copies)
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      // the one arrival, with the bytes the copies will bring: the phase
      // completes when every copy has landed
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar_a), "r"(row_bytes * (uint32_t)K) : "memory");
    }
    __syncwarp();
    uint64_t policy = 0;
    if constexpr (kEvictLast)
      asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
    for (int k = threadIdx.x; k < K; k += 32) {
      const T* src = buf + (size_t)idx[t * K + k] * D4;
      const uint32_t dst = smem_addr(rows_raw + (size_t)k * row_bytes);
      if constexpr (kEvictLast) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
            " [%0], [%1], %2, [%3], %4;"
            ::"r"(dst), "l"(src), "r"(row_bytes), "r"(bar_a), "l"(policy) : "memory");
      } else {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            ::"r"(dst), "l"(src), "r"(row_bytes), "r"(bar_a) : "memory");
      }
    }
  }
  // the barrier's first phase (parity 0) completes once, when all K rows
  // are in shared memory; every thread waits for it
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar_a) : "memory");
  }
  for (int d = threadIdx.x; d < D4; d += kRowsumThreads) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += to_f32(rows[(size_t)k * D4 + d]);
    float* o = out + t * rows_out * D4 + d;
    for (int r = 0; r < rows_out; ++r) o[(size_t)r * D4] = acc;
  }
}

// C4: one warp per output block, grid-stride. A block is 8 x D4 values,
// contiguous in both buf and out; lane l writes the block's float4 l, l + 32,
// ..., so each store instruction covers 512 contiguous bytes, and loads the
// 4 values of T it needs (8 bytes in bf16, 16 in fp32). Stores are
// streaming (evict-first). Storing whole sectors matters: with 16-byte
// bf16 loads a lane holds two float4 32 bytes apart, each store then
// writes half of each 32-byte sector, and the kernel ran at half the rate.
template <typename T>
__global__ void dma_block_gather_kernel(const T* __restrict__ buf,
                                        const int* __restrict__ idx,
                                        float* __restrict__ out, long long n_blocks,
                                        int D4) {
  const int lane = threadIdx.x & 31;
  const int vecs = kBlockRows * D4 / 4;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long i = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
       i < n_blocks; i += warps) {
    const T* src = buf + (size_t)__ldg(idx + i) * kBlockRows * D4;
    float4* dst = reinterpret_cast<float4*>(out + (size_t)i * kBlockRows * D4);
    for (int j = lane; j < vecs; j += 32) {
      float4 f;
      if constexpr (sizeof(T) == 4) {
        f = __ldg(reinterpret_cast<const float4*>(src) + j);
      } else {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(src) + j);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
        f = make_float4(a.x, a.y, b.x, b.y);
      }
      __stcs(dst + j, f);
    }
  }
}

template <typename T>
int rowsum(const void* buf, const int* idx, float* out, int tiles, int K, int D4,
           int rows_out, bool evict_last, cudaStream_t st) {
  const size_t smem = (size_t)K * D4 * sizeof(T);
  if (evict_last)
    dma_gather_rowsum_kernel<T, true><<<tiles, kRowsumThreads, smem, st>>>(
        (const T*)buf, idx, out, K, D4, rows_out);
  else
    dma_gather_rowsum_kernel<T, false><<<tiles, kRowsumThreads, smem, st>>>(
        (const T*)buf, idx, out, K, D4, rows_out);
  return (int)cudaGetLastError();
}

template <typename T>
int block_gather(const void* buf, const int* idx, float* out, long long n_blocks,
                 int D4, cudaStream_t st) {
  long long grid = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (grid > 132 * 16) grid = 132 * 16;      // 16 blocks of 8 warps per SM
  dma_block_gather_kernel<T><<<(unsigned)grid, 32 * kWarpsPerBlock, 0, st>>>(
      (const T*)buf, idx, out, n_blocks, D4);
  return (int)cudaGetLastError();
}

}  // namespace

// C3. buf: (R, D4) of `dtype`, 16-byte aligned, D4 * element size a multiple
// of 16 and K * D4 * element size at most 48 KB; idx: (tiles * K,) int32;
// out: (tiles * rows_out, D4) fp32. evict_last != 0 gives the copies an L2
// evict_last policy.
extern "C" int dma_gather_rowsum(const void* buf, const int* idx, float* out,
                                 int tiles, int K, int D4, int rows_out,
                                 int evict_last, int dtype, void* stream) {
  const int esize = dtype == UNINEXT_BF16 ? 2 : 4;
  if (tiles <= 0 || K <= 0 || D4 <= 0 || rows_out <= 0 ||
      (D4 * esize) % 16 != 0 || (long long)K * D4 * esize > 48 * 1024 ||
      reinterpret_cast<uintptr_t>(buf) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32)
    return rowsum<float>(buf, idx, out, tiles, K, D4, rows_out, evict_last, st);
  if (dtype == UNINEXT_BF16)
    return rowsum<__nv_bfloat16>(buf, idx, out, tiles, K, D4, rows_out, evict_last, st);
  return (int)cudaErrorInvalidValue;
}

// C4. buf: (R, D4) of `dtype`, 16-byte aligned, D4 * element size a multiple
// of 16; idx: (n_blocks,) int32 block indices; out: (n_blocks * 8, D4) fp32,
// 16-byte aligned.
extern "C" int dma_block_gather(const void* buf, const int* idx, float* out,
                                long long n_blocks, int D4, int dtype, void* stream) {
  const int esize = dtype == UNINEXT_BF16 ? 2 : 4;
  if (n_blocks <= 0 || D4 <= 0 || (D4 * esize) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(buf) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32) return block_gather<float>(buf, idx, out, n_blocks, D4, st);
  if (dtype == UNINEXT_BF16)
    return block_gather<__nv_bfloat16>(buf, idx, out, n_blocks, D4, st);
  return (int)cudaErrorInvalidValue;
}
