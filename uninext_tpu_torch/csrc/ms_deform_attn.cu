// Kernel B: multi-scale deformable attention, forward, and kernel B-bwd,
// its backward.
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
//
// Backward (ms_deform_attn_bwd) replaces uninext_tpu/ops/msda.py:234
// _msda_packed_bwd, the hand-written VJP that on the TPU scatters corner-
// packed rows and undoes the pack with three rolls. Same mapping as the
// forward: one warp per (b, query, head), lane = channel. Per sample the
// warp reads dy once, and per in-frame corner c it
//   * adds w_c * att * dy into an fp32 dvalue buffer with atomicAdd (the
//     caller zeroes it and casts it to the value dtype afterwards);
//   * forms s_c = <value row of c, dy> by a warp reduction.
// Lane 0 then writes datt = sum_c w_c s_c and, with the derivatives of the
// bilinear weights, dloc = att * ((s1 - s0)(1 - fy) + (s3 - s2) fy) * W for
// x and att * ((s2 - s0)(1 - fx) + (s3 - s1) fx) * H for y. A sample counts
// where floor(x) is in [-1, W - 1] and floor(y) in [-1, H - 1], the JAX
// package's `in_range`; elsewhere its datt and dloc are 0, and out-of-frame
// corners contribute nothing (zero padding), as in _msda_packed_bwd and
// grid_sample. The atomics add in an order that changes from run to run, so
// dvalue varies in its last bits between runs.
//
// What bounds the backward: the same row gathers as the forward plus one
// fp32 atomic add per corner and channel into dvalue (L2 atomics).
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
__global__ void __launch_bounds__(NT) ms_deform_attn_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, const T* __restrict__ dout,
    float* __restrict__ dvalue, float* __restrict__ dloc,
    float* __restrict__ datt, Levels lv, long long n_warps, int S, int Lq,
    int M, int D, int L, int P) {
  const long long warp = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int m = (int)(warp % M);
  const long long b = warp / ((long long)M * Lq);
  const int LP = L * P;
  const float* locw = loc + warp * LP * 2;
  const float* attw = att + warp * LP;
  float* dlocw = dloc + warp * LP * 2;
  float* dattw = datt + warp * LP;
  const long long row = (long long)M * D;
  const T* vbm = value + b * S * row + (long long)m * D;
  float* dvbm = dvalue + b * S * row + (long long)m * D;
  const T* dyw = dout + warp * D;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const long long lstart = (long long)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int sp = l * P + p;
      const float x = locw[2 * sp] * W - 0.5f;
      const float y = locw[2 * sp + 1] * H - 0.5f;
      if (!(x >= -1.f && x < (float)W && y >= -1.f && y < (float)H)) {
        if (lane == 0) {
          dattw[sp] = 0.f;
          dlocw[2 * sp] = 0.f;
          dlocw[2 * sp + 1] = 0.f;
        }
        continue;
      }
      const float a = attw[sp];
      const float x0f = floorf(x), y0f = floorf(y);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float fx = x - x0f, fy = y - y0f;
      const float wc[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                           (1.f - fx) * fy, fx * fy};
      const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
      const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < D; c0 += 32) {
        const int d = c0 + lane;
        if (d >= D) continue;
        const float g = to_f32(dyw[d]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cx[c] < 0 || cx[c] >= W || cy[c] < 0 || cy[c] >= H) continue;
          const long long o = lstart + ((long long)cy[c] * W + cx[c]) * row + d;
          sc[c] += to_f32(vbm[o]) * g;
          atomicAdd(dvbm + o, wc[c] * a * g);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sc[c] += __shfl_xor_sync(0xffffffffu, sc[c], off);
      if (lane == 0) {
        dattw[sp] = wc[0] * sc[0] + wc[1] * sc[1] + wc[2] * sc[2] + wc[3] * sc[3];
        dlocw[2 * sp] = a * ((sc[1] - sc[0]) * (1.f - fy) + (sc[3] - sc[2]) * fy) * W;
        dlocw[2 * sp + 1] = a * ((sc[2] - sc[0]) * (1.f - fx) + (sc[3] - sc[1]) * fx) * H;
      }
    }
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

template <typename T>
int launch_bwd(const void* value, const void* loc, const void* att,
               const void* dout, float* dvalue, float* dloc, float* datt,
               const Levels& lv, int B, int S, int Lq, int M, int D, int L,
               int P, cudaStream_t stream) {
  const long long n_warps = (long long)B * Lq * M;
  const long long blocks = (n_warps * 32 + NT - 1) / NT;
  ms_deform_attn_bwd_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
      (const T*)value, (const float*)loc, (const float*)att, (const T*)dout,
      dvalue, dloc, datt, lv, n_warps, S, Lq, M, D, L, P);
  return (int)cudaGetLastError();
}

bool read_levels(Levels& lv, const int* levels, int L) {
  if (L < 1 || L > MAX_LEVELS) return false;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[3 * l];
    lv.w[l] = levels[3 * l + 1];
    lv.start[l] = levels[3 * l + 2];
  }
  return true;
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
  Levels lv;
  if (!read_levels(lv, levels, L) || B * (long long)Lq * M == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32)
    return launch<float>(value, loc, att, out, lv, B, S, Lq, M, D, L, P, st);
  if (dtype == UNINEXT_BF16)
    return launch<__nv_bfloat16>(value, loc, att, out, lv, B, S, Lq, M, D, L, P, st);
  return (int)cudaErrorInvalidValue;
}

// The backward. value, loc, att as ms_deform_attn_fwd; dout: (B, Lq, M*D)
// of `dtype`, contiguous. Outputs, fp32, contiguous: dvalue (B, S, M, D),
// ZEROED by the caller (atomics add into it); dloc (B, Lq, M, L, P, 2);
// datt (B, Lq, M, L, P).
extern "C" int ms_deform_attn_bwd(const void* value, const void* loc,
                                  const void* att, const void* dout,
                                  float* dvalue, float* dloc, float* datt,
                                  const int* levels, int B, int S, int Lq,
                                  int M, int D, int L, int P, int dtype,
                                  void* stream) {
  Levels lv;
  if (!read_levels(lv, levels, L) || B * (long long)Lq * M == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32)
    return launch_bwd<float>(value, loc, att, dout, dvalue, dloc, datt, lv, B,
                             S, Lq, M, D, L, P, st);
  if (dtype == UNINEXT_BF16)
    return launch_bwd<__nv_bfloat16>(value, loc, att, dout, dvalue, dloc, datt,
                                     lv, B, S, Lq, M, D, L, P, st);
  return (int)cudaErrorInvalidValue;
}
