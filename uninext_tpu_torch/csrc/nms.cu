// Kernel C: exact class-aware greedy NMS, one block per image doing all of
// the work in shared memory: order, suppression words and sweep.
//
// Replaces: uninext_tpu/ops/nms.py:25 batched_nms, which on the TPU
// iterates the whole keep vector to its fixpoint with one (N, N) masked
// matvec per step (a Jacobi iteration), because a sequential loop costs a
// dispatch per box there.
//
// Class-aware greedy NMS is greedy NMS in each class on its own, visiting
// the class's boxes by score (descending; the lower index first among equal
// scores, as torch.argsort(-score, stable=True) and jnp.argsort order
// finite scores). So the kernel visits the boxes grouped by class, each
// class in that order, and the keep flags equal those of one pass over all
// boxes by score. One block of P2 threads per image (N <= 1024 rounded up to
// a power of two, at least 64), phases separated by barriers:
//  1. order: a bitonic sort of keys (class; score descending, as an ordered
//     integer with -0 taken as +0; original index), one key per thread,
//     exchanged by shuffles within a warp and through shared memory across
//     warps. The keys take 64 bits (22 for the class less the smallest
//     valid class) when the valid classes span less than 2^22 - 1, as every
//     caller's do, else 128. Invalid boxes take the class after all valid
//     ones and score -inf, so the valid ones fill positions p < V. Each
//     position gets its box, area and original index, and the end of its
//     class's run of positions.
//  2. suppression words: for p < q in one class's run, bit q of row p is set
//     when IoU > threshold, i.e. fl(inter / u) > thr with inter and the
//     clamped union u the fp32 terms of uninext_tpu/utils/box_ops.py:box_iou
//     (this file is built with -fmad=false, so each rounds as on the CPU).
//     Thread p walks the positions after it up to its run's end: the IoUs
//     computed are the same-class pairs only, a lane's loads are its
//     neighbours', and its steps, 32 columns at a time, do not depend on
//     each other and do not branch (a warp per row, or items of a row and
//     32 columns dealt evenly to the threads, took longer: PERF.md). For thr in [2^-90, 2^90] the comparison is
//     decided exactly without the division, whose slow path every zero
//     dividend takes: with thr_hi = fl(thr (1 + 2^-20)) and thr_lo likewise,
//     each product rounds by at most 2^-24 relative, so inter > fl(u thr_hi)
//     puts inter / u above the float after thr, hence fl(inter / u) > thr,
//     and inter < fl(u thr_lo) puts it below thr, hence not; a product that
//     overflows decides "not above", right there too. Only between the two
//     (and for NaN) does the kernel divide, as volatile PTX (written plainly,
//     the compiler computed the division on every step). Row p's words are
//     mask[w][p] for w >= p / 64. A bit inside the row's own 64-position
//     tile also goes, transposed, into `col`: bit k of col[q] says that
//     position k of q's tile suppresses q.
//  3. sweep by 64-position tiles, in one warp with no block barrier. For
//     tile t the lanes OR the earlier tiles' kept rows of word t (the boxes
//     of t they remove), then resolve t's 64 boxes: with cand the valid
//     boxes not removed, kept = cand & ~{q : col[q] & kept} is iterated from
//     kept = cand to its fixpoint, which is unique (q depends only on
//     earlier positions), so it is the greedy result; it takes the depth of
//     the tile's longest chain of suppressions plus one steps.
//  4. keep[b, i] is written for every original index i.
// The result equals sequential greedy NMS exactly.
//
// What bounds it on the H100: one SM per image, so the instructions it
// issues there and their latency. The sort is 55 compare-exchange steps
// (15 of them across warps, each behind a barrier); the IoUs are the
// same-class pairs (N^2 / 2C for C balanced classes, 0.1M at N = 900 and
// C = 4), ~25 instructions each; the sweep is 15 short serial steps of one
// warp. At chip_smoke.py's set (N = 900, 4 classes) they take 20%, 62% and
// 13% of the kernel's cycles (H100 SXM at 700 W, tools/kernel_times.py
// --phases). The work is far below any of the card's rates (the bound
// printed by chip_smoke.py counts the same-class pairs' arithmetic).
#include <stdint.h>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int TILE = 64;          // positions per suppression word and per sweep tile
constexpr int MAX_N = 1024;       // one thread per box
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of an image of N boxes: the suppression words
// (NW x Np; before them, the sort's two exchange buffers of P2 keys lie in
// the same bytes), then per position the box, transposed diagonal word,
// class id, area, original index, run end and run start; per tile the kept
// word; per warp the class range and a count.
struct Layout {
  int Np, NW, P2;
  size_t words, bytes;
  __host__ __device__ explicit Layout(int N)
      : Np((N + TILE - 1) / TILE * TILE), NW((N + TILE - 1) / TILE), P2(TILE) {
    while (P2 < N) P2 *= 2;
    const size_t m = (size_t)8 * NW * Np, s = (size_t)32 * P2;
    words = m > s ? m : s;
    bytes = words + (size_t)Np * (16 + 8 + 8 + 4 + 2 + 2 + 2) + 8 * (size_t)NW + 8 * 64 + 4 * 32;
  }
};

// A float as an unsigned integer whose order is the floats' descending
// order (-0 taken as +0).
__device__ __forceinline__ unsigned descending(float s) {
  const unsigned u = __float_as_uint(s + 0.f);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

// The rare exact test: fl(inter / u) > thr by the IEEE division, as
// volatile PTX so that it is not computed ahead of the branch that needs it.
__device__ __forceinline__ bool above_by_division(float inter, float u, float thr) {
  float q;
  asm volatile("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(inter), "f"(u));
  return q > thr;
}

// inter and the clamped union of boxes a and b, the fp32 terms of box_iou
__device__ __forceinline__ void iou_terms(const float4& a, float area_a, const float4& b,
                                          float area_b, float& inter, float& u) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
  inter = iw * ih;
  u = fmaxf(area_a + area_b - inter, 1e-9f);
}

__device__ __forceinline__ u64 shfl_key(u64 k, int j) { return __shfl_xor_sync(FULL, k, j); }
__device__ __forceinline__ ulonglong2 shfl_key(ulonglong2 k, int j) {
  return make_ulonglong2(__shfl_xor_sync(FULL, k.x, j), __shfl_xor_sync(FULL, k.y, j));
}
__device__ __forceinline__ bool less(u64 a, u64 b) { return a < b; }
__device__ __forceinline__ bool less(ulonglong2 a, ulonglong2 b) {
  return a.x < b.x || (a.x == b.x && a.y < b.y);
}

// Ascending bitonic sort of P2 keys (the real ones unique, the padding
// equal), thread t's key in `key`; the result is the key at position t. Steps within a warp exchange by
// shuffles, steps across warps through `buf` ([2][P2], alternating, so one
// barrier a step suffices). Called by every thread of the block.
template <typename K>
__device__ __forceinline__ K bitonic_sort(K key, K* buf, int P2) {
  const int t = threadIdx.x;
  int stage = 0;
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      K p;
      if (j >= 32) {
        K* b = buf + (stage++ & 1) * P2;
        b[t] = key;
        __syncthreads();
        p = b[t ^ j];
      } else {
        p = shfl_key(key, j);
      }
      if (less(p, key) == (((t & j) == 0) == ((t & k) == 0))) key = p;
    }
  }
  __syncthreads();
  return key;
}

__global__ void __launch_bounds__(MAX_N, 1) nms_fused_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const int64_t* __restrict__ classes, const bool* __restrict__ valid,
    bool* __restrict__ keep, int N, float thr) {
  const Layout lay(N);
  const int Np = lay.Np, NW = lay.NW, P2 = lay.P2;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* mask = reinterpret_cast<u64*>(smem);                 // [NW][Np]
  float4* box = reinterpret_cast<float4*>(smem + lay.words);
  u64* col = reinterpret_cast<u64*>(box + Np);
  u64* ckey = col + Np;
  float* area = reinterpret_cast<float*>(ckey + Np);
  int16_t* orig = reinterpret_cast<int16_t*>(area + Np);
  int16_t* run_end = orig + Np;
  int16_t* run_start = run_end + Np;                        // [runs]
  u64* kept = reinterpret_cast<u64*>(run_start + Np);       // [NW]
  long long* warp_range = reinterpret_cast<long long*>(kept + NW);  // [2][32]
  int* warp_count = reinterpret_cast<int*>(warp_range + 64);     // [32]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t base = (size_t)blockIdx.x * N;

  // 1. order
  bool vi = false;
  long long c = 0;
  unsigned sd = descending(-INFINITY);
  if (t < N) {
    vi = valid == nullptr || valid[base + t];
    c = classes[base + t];
    if (vi) sd = descending(scores[base + t]);
  }
  // the valid boxes' class range: a warp's by shuffles, then the warps'
  constexpr long long LMAX = 0x7fffffffffffffffll, LMIN = -LMAX - 1;
  long long cmin = vi ? c : LMAX, cmax = vi ? c : LMIN;
  for (int m = 16; m; m >>= 1) {
    cmin = min(cmin, __shfl_xor_sync(FULL, cmin, m));
    cmax = max(cmax, __shfl_xor_sync(FULL, cmax, m));
  }
  if (lane == 0) {
    warp_range[warp] = cmin;
    warp_range[32 + warp] = cmax;
  }
  const int V = __syncthreads_count(vi);
  cmin = lane < P2 / 32 ? warp_range[lane] : LMAX;
  cmax = lane < P2 / 32 ? warp_range[32 + lane] : LMIN;
  for (int m = 16; m; m >>= 1) {
    cmin = min(cmin, __shfl_xor_sync(FULL, cmin, m));
    cmax = max(cmax, __shfl_xor_sync(FULL, cmax, m));
  }
  // keys (class; score descending; index) in 64 bits when the classes span
  // less than 2^22 - 1 (invalid boxes take the class slot after them), else
  // in 128; padding sorts last
  int i;                              // the original index at position t
  u64 cid;                            // position t's class, as an id
  if (V == 0 || (u64)cmax - (u64)cmin < (1ull << 22) - 1) {
    const u64 slot = vi ? (u64)c - (u64)cmin : (1ull << 22) - 1;
    const u64 key = bitonic_sort<u64>(
        t < N ? slot << 42 | (u64)sd << 10 | (unsigned)t : ~0ull,
        reinterpret_cast<u64*>(smem), P2);
    i = (int)(key & 1023u);
    cid = key >> 42;
  } else {
    const ulonglong2 key = bitonic_sort<ulonglong2>(
        t < N ? make_ulonglong2(vi ? (u64)c ^ (1ull << 63) : ~0ull, (u64)sd << 32 | (unsigned)t)
              : make_ulonglong2(~0ull, ~0ull),
        reinterpret_cast<ulonglong2*>(smem), P2);
    i = (int)(key.y & 0xffffu);
    cid = key.x;
  }
  // the exchange buffers become mask words
  if (t < N) {
    const float* bx = boxes + (base + i) * 4;
    const float x0 = bx[0], y0 = bx[1], x1 = bx[2], y1 = bx[3];
    box[t] = make_float4(x0, y0, x1, y1);
    area[t] = (x1 - x0) * (y1 - y0);
    orig[t] = (int16_t)i;
    ckey[t] = cid;
  }
  if (t < Np) {
    for (int w = t / TILE; w < NW; ++w) mask[(size_t)w * Np + t] = 0ull;
    col[t] = 0ull;
  }
  __syncthreads();
  // runs of one class: a run starts where the class key changes; its index
  // is the count of starts up to here (a ballot per warp, then the counts of
  // the warps before)
  const bool starts = t < V && (t == 0 || ckey[t] != ckey[t - 1]);
  const unsigned ballot = __ballot_sync(FULL, starts);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  const int runs = __syncthreads_count(starts);
  int run = __popc(ballot & ((1u << lane) - 1u)) + (starts ? 1 : 0) - 1;
  for (int w = 0; w < warp; ++w) run += warp_count[w];
  if (starts) run_start[run] = (int16_t)t;
  __syncthreads();
  if (t < V) run_end[t] = (int16_t)(run + 1 < runs ? run_start[run + 1] : V);
  __syncthreads();

  // 2. suppression words along each valid position's run
  const bool fast = thr >= 0x1p-90f && thr <= 0x1p90f;   // else: always divide
  const float thr_hi = fast ? thr * (1.f + 0x1p-20f) : INFINITY;
  const float thr_lo = fast ? thr * (1.f - 0x1p-20f) : -INFINITY;
  if (t < V) {
    const float4 bi = box[t];
    const float ai = area[t];
    const int end = run_end[t];
    // 32 columns at a time, each chunk's loop free of branches: the bits of
    // the pairs above thr_hi and of those between the two bounds
    for (int c0 = (t + 1) & ~31; c0 < end; c0 += 32) {
      const int j0 = max(t + 1 - c0, 0), j1 = min(end - c0, 32);
      unsigned above = 0u, between = 0u;
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        float inter, u;
        iou_terms(bi, ai, box[c0 + j], area[c0 + j], inter, u);
        above |= (unsigned)(inter > u * thr_hi) << j;
        between |= (unsigned)(!(inter > u * thr_hi) && !(inter < u * thr_lo)) << j;
      }
      for (unsigned b = between; b; b &= b - 1) {   // rare: decide by dividing
        const int j = __ffs(b) - 1;
        float inter, u;
        iou_terms(bi, ai, box[c0 + j], area[c0 + j], inter, u);
        if (above_by_division(inter, u, thr)) above |= 1u << j;
      }
      if (above) {
        reinterpret_cast<unsigned*>(mask + (size_t)(c0 / TILE) * Np + t)[(c0 / 32) % 2] = above;
        if (c0 / TILE == t / TILE) {    // the diagonal word, transposed
          for (unsigned b = above; b; b &= b - 1)
            atomicOr(reinterpret_cast<unsigned*>(col + c0 + __ffs(b) - 1) + (t % TILE) / 32,
                     1u << (t % 32));
        }
      }
    }
  }
  __syncthreads();

  // 3. sweep by tiles, in warp 0 alone: a tile's removed word is the OR of
  // the earlier tiles' kept rows (lanes over rows, then a warp reduction)
  if (warp == 0) {
    for (int tile = 0; tile < NW; ++tile) {
      const int lo0 = tile * TILE;
      const u64* m = mask + (size_t)tile * Np;
      u64 acc = 0ull;
#pragma unroll 4
      for (int u = 0; u < tile; ++u) {
        const u64 kw = kept[u];
        acc |= m[u * TILE + lane] & (0ull - ((kw >> lane) & 1ull));
        acc |= m[u * TILE + 32 + lane] & (0ull - ((kw >> (32 + lane)) & 1ull));
      }
      const u64 rem = ((u64)__reduce_or_sync(FULL, (unsigned)(acc >> 32)) << 32) |
                      __reduce_or_sync(FULL, (unsigned)acc);
      u64 cand = ~rem;
      if (V < lo0 + TILE) cand &= V <= lo0 ? 0ull : (1ull << (V - lo0)) - 1ull;
      const u64 ca = col[lo0 + lane], cb = col[lo0 + 32 + lane];
      u64 kw = cand;
      for (;;) {
        const unsigned s0 = __ballot_sync(FULL, (ca & kw) != 0ull);
        const unsigned s1 = __ballot_sync(FULL, (cb & kw) != 0ull);
        const u64 nk = cand & ~(((u64)s1 << 32) | s0);
        if (nk == kw) break;
        kw = nk;
      }
      if (lane == 0) kept[tile] = kw;
      __syncwarp();
    }
  }
  __syncthreads();

  // 4. keep flags in the original order
  if (t < N) keep[base + orig[t]] = (kept[t / TILE] >> (t % TILE)) & 1ull;
}

}  // namespace

// boxes: (B, N, 4) fp32 xyxy, scores: (B, N) fp32 (finite), classes: (B, N)
// int64, valid: (B, N) bool or null (every box valid), all contiguous, in
// the original order; keep: (B, N) bool, every entry written. 1 <= N <= 1024.
extern "C" int nms_fused(const void* boxes, const void* scores, const void* classes,
                         const void* valid, void* keep, int B, int N, float thr,
                         void* stream) {
  if (B < 1 || N < 1 || N > MAX_N) return (int)cudaErrorInvalidValue;
  const Layout lay(N);
  cudaError_t err = cudaFuncSetAttribute(
      nms_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  nms_fused_kernel<<<B, lay.P2, lay.bytes, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)scores, (const int64_t*)classes,
      (const bool*)valid, (bool*)keep, N, thr);
  return (int)cudaGetLastError();
}
