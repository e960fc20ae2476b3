// Kernel B: multi-scale deformable attention, forward.
//
// Replaces: uninext_tpu/ops/msda.py:136 ms_deform_attn (_packed_forward,
// :181-215), which on the TPU packs the four bilinear corners of every
// sample into one gathered row of rolled, zero-padded per-level tables and
// folds them through a transposed view.
//
//   out[b,q,m,:] = sum_{l,p} att[b,q,m,l,p] * bilinear(value_l[b,:,m,:], loc[b,q,m,l,p])
//
// with grid_sample's align_corners=False / zero-padding rule: the sample at
// loc (x, y) in [0,1] sits at pixel (x*W_l - 0.5, y*H_l - 0.5); corners that
// fall outside the level contribute 0.
//
// Design: one warp per (b, query, head), lane = channel (D = 32 for the
// model; larger D loops over 32-channel chunks, smaller D idles lanes).
// Each bilinear corner is then one coalesced read of a D-element value row,
// which the GPU's caches serve well because all heads' value rows of a
// pixel are adjacent in (B, S, M, D). The warp loops over the L*P samples;
// location and weight are warp-uniform loads. Sums are fp32; the output
// takes the value dtype. Level shapes and starts are passed by value in a
// struct, so the launch needs no device-side table. The TPU's corner
// packing and transposed fold are not ported: the H100 gathers rows well.
//
// What bounds it on the H100: the random row gathers (4 corners x 16
// samples x 8 heads per query) from a value table that fits in L2 (10 MB
// in bf16 at 800x1216), i.e. L2 latency and transaction rate.
//
// Precision: `loc` and `att` stay fp32 into the kernel, as the reference's
// fp32 CUDA op kept them; the JAX module casts both to the value dtype
// (bf16 on the TPU, models/layers.py:131-132). The two agree in fp32.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int NT = 256;   // 8 warps per block

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

template <typename T>
__global__ void __launch_bounds__(NT) ms_deform_attn_fwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, T* __restrict__ out, Levels lv,
    long long n_warps, int S, int Lq, int M, int D, int L, int P) {
  const long long warp = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int m = (int)(warp % M);
  const long long b = warp / ((long long)M * Lq);
  const int LP = L * P;
  const float* locw = loc + warp * LP * 2;        // (B, Lq, M, L, P, 2)
  const float* attw = att + warp * LP;            // (B, Lq, M, L, P)
  const long long row = (long long)M * D;         // elements per value pixel
  const T* vbm = value + b * S * row + (long long)m * D;

  for (int c0 = 0; c0 < D; c0 += 32) {
    const int d = c0 + lane;
    const bool act = d < D;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int H = lv.h[l], W = lv.w[l];
      const T* vl = vbm + (long long)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int sp = l * P + p;
        const float x = locw[2 * sp] * W - 0.5f;
        const float y = locw[2 * sp + 1] * H - 0.5f;
        // outside (-1, W) x (-1, H) every corner is out of frame (also NaN)
        if (!(x > -1.f && x < (float)W && y > -1.f && y < (float)H)) continue;
        const float a = attw[sp];
        const float x0f = floorf(x), y0f = floorf(y);
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float fx = x - x0f, fy = y - y0f;
        float s = 0.f;
        if (act) {
          if (y0 >= 0) {
            if (x0 >= 0) s += (1.f - fx) * (1.f - fy) * to_f32(vl[((long long)y0 * W + x0) * row + d]);
            if (x0 + 1 < W) s += fx * (1.f - fy) * to_f32(vl[((long long)y0 * W + x0 + 1) * row + d]);
          }
          if (y0 + 1 < H) {
            if (x0 >= 0) s += (1.f - fx) * fy * to_f32(vl[((long long)(y0 + 1) * W + x0) * row + d]);
            if (x0 + 1 < W) s += fx * fy * to_f32(vl[((long long)(y0 + 1) * W + x0 + 1) * row + d]);
          }
        }
        acc += a * s;
      }
    }
    if (act) out[warp * D + d] = from_f32<T>(acc);   // (B, Lq, M*D)
  }
}

template <typename T>
int launch(const void* value, const void* loc, const void* att, void* out,
           const Levels& lv, int B, int S, int Lq, int M, int D, int L, int P,
           cudaStream_t stream) {
  const long long n_warps = (long long)B * Lq * M;
  const long long blocks = (n_warps * 32 + NT - 1) / NT;
  ms_deform_attn_fwd_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
      (const T*)value, (const float*)loc, (const float*)att, (T*)out, lv,
      n_warps, S, Lq, M, D, L, P);
  return (int)cudaGetLastError();
}

}  // namespace

// value: (B, S, M, D) of `dtype`; loc: (B, Lq, M, L, P, 2) fp32;
// att: (B, Lq, M, L, P) fp32; out: (B, Lq, M*D) of `dtype`; all contiguous.
// levels: HOST int32 array (L, 3) of (H_l, W_l, start_l), copied into the
// launch parameters.
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc,
                                  const void* att, void* out,
                                  const int* levels, int B, int S, int Lq,
                                  int M, int D, int L, int P, int dtype,
                                  void* stream) {
  if (L < 1 || L > MAX_LEVELS || B * (long long)Lq * M == 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[3 * l];
    lv.w[l] = levels[3 * l + 1];
    lv.start[l] = levels[3 * l + 2];
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32)
    return launch<float>(value, loc, att, out, lv, B, S, Lq, M, D, L, P, st);
  if (dtype == UNINEXT_BF16)
    return launch<__nv_bfloat16>(value, loc, att, out, lv, B, S, Lq, M, D, L, P, st);
  return (int)cudaErrorInvalidValue;
}
