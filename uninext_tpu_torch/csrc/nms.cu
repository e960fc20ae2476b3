// Kernel C: exact class-aware greedy NMS as a suppression bitmask (C1)
// plus a one-warp greedy sweep per image (C2).
//
// Replaces: uninext_tpu/ops/nms.py:25 batched_nms, which on the TPU
// iterates the whole keep vector to its fixpoint with one (N, N) masked
// matvec per step (a Jacobi iteration), because a sequential loop costs a
// dispatch per box there.
//
// C1 (nms_bitmask): one block of 64 threads per (image, 64-row block,
// 64-column block). Thread i of the block tests its row box against the 64
// column boxes held in shared memory and writes one 64-bit word: bit j is
// set when j comes later in score order, both are valid, the classes match
// and IoU > threshold. IoU is the fp32 expression of
// uninext_tpu/utils/box_ops.py:box_iou term for term; this file is built
// with -fmad=false so each operation rounds as it does on the CPU, and the
// comparison at the threshold decides the same way.
// C2 (nms_sweep): one warp per image walks the boxes in score order; the
// `removed` bitmask lives in registers (word w in lane w % 32). A kept box
// ORs its mask row into `removed`. The keep flag is written straight to the
// box's original position, so no scatter pass and no host sync follow.
// The result equals sequential greedy NMS exactly.
//
// What bounds it on the H100: nothing at N = 900 (C1 is 15 x 15 blocks of
// 64 x 64 IoUs; C2 is 900 dependent steps of one warp): launch latency and
// C2's dependent chain of mask-row loads dominate, a few microseconds each.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TB = 64;           // boxes per block side
constexpr int MAX_WPL = 4;       // mask words per lane in the sweep: N <= 64*32*4

__global__ void __launch_bounds__(TB) nms_bitmask_kernel(
    const float* __restrict__ boxes, const int64_t* __restrict__ cls,
    const uint8_t* __restrict__ valid, unsigned long long* __restrict__ mask,
    int N, int NW, float thr) {
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TB, col0 = blockIdx.x * TB;
  const int t = threadIdx.x;
  __shared__ float cb[TB][4];
  __shared__ int64_t cc[TB];
  __shared__ uint8_t cv[TB];
  const float* bb = boxes + (long long)b * N * 4;
  const int jc = col0 + t;
  if (jc < N) {
    for (int e = 0; e < 4; ++e) cb[t][e] = bb[jc * 4 + e];
    cc[t] = cls[(long long)b * N + jc];
    cv[t] = valid[(long long)b * N + jc];
  }
  __syncthreads();
  const int i = row0 + t;
  if (i >= N) return;
  const float x0 = bb[i * 4], y0 = bb[i * 4 + 1], x1 = bb[i * 4 + 2], y1 = bb[i * 4 + 3];
  const int64_t ci = cls[(long long)b * N + i];
  const bool vi = valid[(long long)b * N + i] != 0;
  const float area_i = (x1 - x0) * (y1 - y0);
  unsigned long long bits = 0ull;
  const int ncol = min(TB, N - col0);
  for (int jj = 0; jj < ncol; ++jj) {
    const int j = col0 + jj;
    if (j <= i || !vi || !cv[jj] || cc[jj] != ci) continue;
    const float area_j = (cb[jj][2] - cb[jj][0]) * (cb[jj][3] - cb[jj][1]);
    const float w = fmaxf(fminf(x1, cb[jj][2]) - fmaxf(x0, cb[jj][0]), 0.f);
    const float h = fmaxf(fminf(y1, cb[jj][3]) - fmaxf(y0, cb[jj][1]), 0.f);
    const float inter = w * h;
    const float uni = area_i + area_j - inter;
    const float iou = inter / fmaxf(uni, 1e-9f);
    if (iou > thr) bits |= 1ull << jj;
  }
  mask[((long long)b * N + i) * NW + blockIdx.x] = bits;
}

__global__ void __launch_bounds__(32) nms_sweep_kernel(
    const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
    const int64_t* __restrict__ order, bool* __restrict__ keep, int N, int NW) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  unsigned long long removed[MAX_WPL];
#pragma unroll
  for (int t = 0; t < MAX_WPL; ++t) removed[t] = 0ull;
  const unsigned long long* mb = mask + (long long)b * N * NW;
  for (int i = 0; i < N; ++i) {
    const int w = i >> 6, owner = w & 31, slot = w >> 5;
    unsigned long long mine = 0ull;
#pragma unroll
    for (int t = 0; t < MAX_WPL; ++t)
      if (t == slot) mine = removed[t];
    mine = __shfl_sync(0xffffffffu, mine, owner);
    const bool kept = valid[(long long)b * N + i] != 0 && !((mine >> (i & 63)) & 1ull);
    if (lane == 0) keep[(long long)b * N + order[(long long)b * N + i]] = kept;
    if (kept) {
      const unsigned long long* rowp = mb + (long long)i * NW;
#pragma unroll
      for (int t = 0; t < MAX_WPL; ++t) {
        const int ww = lane + 32 * t;
        if (ww < NW) removed[t] |= rowp[ww];
      }
    }
  }
}

}  // namespace

// boxes: (B, N, 4) fp32 xyxy, cls: (B, N) int64, valid: (B, N) bool, all in
// descending score order; mask: (B, N, ceil(N/64)) uint64 scratch.
extern "C" int nms_bitmask(const void* boxes, const void* cls, const void* valid,
                           void* mask, int B, int N, float thr, void* stream) {
  const int NW = (N + TB - 1) / TB;
  if (N < 1 || NW > 32 * MAX_WPL) return (int)cudaErrorInvalidValue;
  dim3 grid(NW, NW, B);
  nms_bitmask_kernel<<<grid, TB, 0, (cudaStream_t)stream>>>(
      (const float*)boxes, (const int64_t*)cls, (const uint8_t*)valid,
      (unsigned long long*)mask, N, NW, thr);
  return (int)cudaGetLastError();
}

// order: (B, N) int64, sorted position -> original index; keep: (B, N) bool
// in the original order, every entry written.
extern "C" int nms_sweep(const void* mask, const void* valid, const void* order,
                         void* keep, int B, int N, void* stream) {
  const int NW = (N + TB - 1) / TB;
  if (N < 1 || NW > 32 * MAX_WPL) return (int)cudaErrorInvalidValue;
  nms_sweep_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)mask, (const uint8_t*)valid,
      (const int64_t*)order, (bool*)keep, N, NW);
  return (int)cudaGetLastError();
}
