// MSDA: multi-scale deformable attention, forward, and MSDA-bwd, its
// backward.
//
// Replaces: uninext_tpu/ops/msda.py:136 ms_deform_attn (_packed_forward,
// :181-215), which on the TPU packs the four bilinear corners of every
// sample into one gathered row of rolled, zero-padded per-level tables and
// folds them through a transposed view; and :234 _msda_packed_bwd, the
// hand-written VJP that scatters corner-packed rows and undoes the pack with
// three rolls.
//
//   out[b,q,m,:] = sum_{l,p} att[b,q,m,l,p] * bilinear(value_l[b,:,m,:], loc[b,q,m,l,p])
//
// with grid_sample's align_corners=False / zero-padding rule: the sample at
// loc (x, y) in [0,1] sits at pixel (x*W_l - 0.5, y*H_l - 0.5); corners that
// fall outside the level contribute 0. A sample counts where floor(x) is in
// [-1, W - 1] and floor(y) in [-1, H - 1] (the JAX package's `in_range`);
// elsewhere, and for NaN locations, it contributes nothing and its datt and
// dloc are 0.
//
// What bounds both on the H100: not HBM (the value table, 10 MB in bf16 at
// 800x1216, sits in the 50 MB L2) but the rows moved through L2: 64 corner
// rows of 64 bytes per (query, head) at D = 32 in bf16, 10.3M rows per
// encoder call (7.2M in frame on uniform locations), read by the forward and
// read and reduced (128 bytes of fp32 each) by the backward. The backward
// is paced by the volume of its reductions, not by chains on one address:
// with every sample on a level of 247 pixels it takes 1.1x the time it
// takes on one of 15200 (chip_smoke.py's diagnostic, H100 SXM at 700 W).
//
// Design: lane groups. A corner row of D channels is read by GL lanes with
// one 16-byte load each (8 bf16 or 4 fp32 channels; GL = D/8 or D/4 rounded
// up to a power of two, idle lanes past D), so a warp holds 32/GL groups and
// one warp-wide load fetches the rows of 32/GL corners. A task is one
// (b, query, head); a group takes K = 2 samples at a time and issues their
// 8 corner loads before it uses any (no branch between them: out-of-frame
// corners are predicated off and weigh 0). Each group reads its sample's
// location as one float2 and its weight as one float: with a warp per task
// the warp's groups read neighbouring samples, so these loads coalesce; with
// a group per task each group walks its task's samples in order, so the
// lines it reads stay in L1 for its next samples. Level shapes and starts are
// passed by value in a struct and selected without dynamic indexing. Each
// kernel has its own layout:
//   * forward: a lane group per task, a warp covering 32/GL consecutive
//     tasks (one query's 8 heads at D = 32 in bf16); each lane keeps fp32
//     sums of its channels over all the task's samples and the group writes
//     the output row with 16-byte stores.
//   * backward: a warp per task, its groups splitting the task's L*P samples
//     (at D = 32 in bf16, 8 groups of 4 lanes, 2 samples each), so that the
//     warp's datt and dloc stores fall on neighbouring samples.
// The other layout of each was slower at the encoder shape (PERF.md §6).
//
// Backward. Each lane reads dout once, twice laid out: its value-row
// channels, for the dot products, and the channels of its reductions. Per
// sample and in-frame corner c it adds a * w_c * dout into an fp32 dvalue
// buffer with Hopper's vector reductions (atomicAdd on float4, one
// instruction per 4 channels, a group's instruction covering GL*16
// contiguous bytes; the caller zeroes dvalue and casts it afterwards) and
// forms s_c = <value row of c, dout> as partial sums reduced inside the
// group (log2 GL shuffle steps). The group's first lane then writes datt =
// sum_c w_c s_c and, with the derivatives of the bilinear weights, dloc =
// att * ((s1 - s0)(1 - fy) + (s3 - s2) fy) * W for x and att * ((s2 - s0)
// (1 - fx) + (s3 - s1) fx) * H for y; the warp's groups write neighbouring
// samples, so these stores coalesce. The reductions add in an order that
// changes from run to run, so dvalue varies in its last bits between runs.
//
// Precision: `loc` and `att` stay fp32 into the kernel (the JAX module rounds
// them to the value dtype, and so does the port's module before the call);
// sums are fp32; the output takes the value dtype.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int NT = 256;   // 8 warps per block
constexpr int K = 2;      // samples per group whose corner rows load together

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

// channels in one 16-byte chunk of a value row
template <typename T>
__host__ __device__ constexpr int chunk() { return 16 / (int)sizeof(T); }

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 pairs, the lower half first
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]), bf16x2(f[4], f[5]),
                    bf16x2(f[6], f[7]));
}

// four channels of a row from 8 (bf16) or 16 (fp32) bytes
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// One sample on its level: the four corners (x0,y0), (x0+1,y0), (x0,y0+1),
// (x0+1,y0+1), their pixel index in the value table, whether each lies in
// the level, and the bilinear fractions.
struct Sample {
  float a, fx, fy, W, H;
  bool inr;
  bool in[4];
  int row[4];
};

__device__ __forceinline__ Sample locate(const Levels& lv, int l, float2 xy,
                                         float a, bool ok) {
  int H = lv.h[0], W = lv.w[0], st = lv.start[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (l == i) { H = lv.h[i]; W = lv.w[i]; st = lv.start[i]; }
  Sample s;
  float x = xy.x * W - 0.5f, y = xy.y * H - 0.5f;
  // in_range; false for NaN. Outside it every corner is out of frame.
  s.inr = ok && x >= -1.f && x < (float)W && y >= -1.f && y < (float)H;
  if (!s.inr) x = y = 0.f;
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = (int)x0f, y0 = (int)y0f;
  s.fx = x - x0f;
  s.fy = y - y0f;
  s.a = s.inr ? a : 0.f;
  s.W = (float)W;
  s.H = (float)H;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cx = x0 + (c & 1), cy = y0 + (c >> 1);
    s.in[c] = s.inr && cx >= 0 && cx < W && cy >= 0 && cy < H;
    s.row[c] = s.in[c] ? st + cy * W + cx : 0;
  }
  return s;
}

__device__ __forceinline__ void bilinear(const Sample& s, float (&w)[4]) {
  w[0] = (1.f - s.fx) * (1.f - s.fy);
  w[1] = s.fx * (1.f - s.fy);
  w[2] = (1.f - s.fx) * s.fy;
  w[3] = s.fx * s.fy;
}

// Where a lane works: its group, its place in the group (`sub`: channels
// sub*VEC ...), its task (clamped into range; `live` says whether it is
// real) and its group's index among the task's groups (`gi`).
template <int GL, int GPT>
struct Lanes {
  int sub, gi;
  long long task;
  bool live;
  __device__ __forceinline__ Lanes(long long n_tasks) {
    constexpr int TPW = 32 / GL / GPT;   // tasks per warp
    const int lane = threadIdx.x & 31, group = lane / GL;
    sub = lane % GL;
    gi = group % GPT;
    const long long warp = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
    task = warp * TPW + group / GPT;
    live = task < n_tasks;
    if (!live) task = n_tasks - 1;
  }
};

// GL lanes per row, GPT groups per task (the forward launches GPT = 1, a
// task per group; the backward GPT = 32/GL, a warp per task).
template <typename T, int GL, int GPT>
__global__ void __launch_bounds__(NT) ms_deform_attn_fwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, T* __restrict__ out, Levels lv,
    long long n_tasks, int S, int Lq, int M, int D, int L, int P) {
  constexpr int VEC = chunk<T>();
  const Lanes<GL, GPT> ln(n_tasks);
  const bool chan = ln.sub * VEC < D;
  const int m = (int)(ln.task % M);
  const long long b = ln.task / ((long long)Lq * M);
  const int LP = L * P;
  const long long rowlen = (long long)M * D;      // elements per value pixel
  const T* vb = value + (b * S * M + m) * D + ln.sub * VEC;
  const float* loct = loc + ln.task * LP * 2;     // (B, Lq, M, L, P, 2)
  const float* attt = att + ln.task * LP;         // (B, Lq, M, L, P)

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < LP; s0 += K * GPT) {
    uint4 raw[K][4];
    float wa[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = s0 + ln.gi + k * GPT;
      const bool ok = ln.live && s < LP;
      const float2 xy = ok ? __ldg(reinterpret_cast<const float2*>(loct) + s)
                           : make_float2(0.f, 0.f);
      const Sample sm = locate(lv, s / P, xy, ok ? __ldg(attt + s) : 0.f, ok);
      float w[4];
      bilinear(sm, w);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        raw[k][c] = make_uint4(0u, 0u, 0u, 0u);
        if (sm.in[c] && chan)
          raw[k][c] = __ldg(reinterpret_cast<const uint4*>(vb + sm.row[c] * rowlen));
        wa[k][c] = sm.a * w[c];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[VEC];
        unpack(raw[k][c], v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += wa[k][c] * v[i];
      }
  }
#pragma unroll
  for (int o = GL; o < GL * GPT; o <<= 1)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  if (ln.live && ln.gi == 0 && chan)                 // (B, Lq, M*D)
    *reinterpret_cast<uint4*>(out + ln.task * D + ln.sub * VEC) = pack(acc);
}

// GL, GPT as the forward.
template <typename T, int GL, int GPT>
__global__ void __launch_bounds__(NT) ms_deform_attn_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ att, const T* __restrict__ dout,
    float* __restrict__ dvalue, float* __restrict__ dloc,
    float* __restrict__ datt, Levels lv, long long n_tasks, int S, int Lq,
    int M, int D, int L, int P) {
  constexpr int VEC = chunk<T>();
  const Lanes<GL, GPT> ln(n_tasks);
  const bool chan = ln.sub * VEC < D;
  const int m = (int)(ln.task % M);
  const long long b = ln.task / ((long long)Lq * M);
  const int LP = L * P;
  const long long rowlen = (long long)M * D;
  const long long base = (b * S * M + m) * D;
  const T* vb = value + base + ln.sub * VEC;
  float* dvb = dvalue + base;
  const float* loct = loc + ln.task * LP * 2;
  const float* attt = att + ln.task * LP;

  // dout twice: g in the layout of the value rows (channels sub*VEC + i),
  // for the dot products; ga in the layout of the reductions, where piece j
  // of the lane holds channels (j*GL + sub)*4 + i, so that each reduction
  // instruction of a group covers GL*16 contiguous bytes of dvalue
  float g[VEC], ga[VEC];
  {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (ln.live && chan)
      r = __ldg(reinterpret_cast<const uint4*>(dout + ln.task * D + ln.sub * VEC));
    unpack(r, g);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (ln.live && (j * GL + ln.sub) * 4 < D)
        load4(dout + ln.task * D + (j * GL + ln.sub) * 4, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) ga[4 * j + i] = f[i];
    }
  }
  for (int s0 = 0; s0 < LP; s0 += K * GPT) {
    uint4 raw[K][4];
    Sample sm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = s0 + ln.gi + k * GPT;
      const bool ok = ln.live && s < LP;
      const float2 xy = ok ? __ldg(reinterpret_cast<const float2*>(loct) + s)
                           : make_float2(0.f, 0.f);
      sm[k] = locate(lv, s / P, xy, ok ? __ldg(attt + s) : 0.f, ok);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        raw[k][c] = make_uint4(0u, 0u, 0u, 0u);
        if (sm[k].in[c] && chan)
          raw[k][c] = __ldg(reinterpret_cast<const uint4*>(vb + sm[k].row[c] * rowlen));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = s0 + ln.gi + k * GPT;
      float w[4], sc[4];
      bilinear(sm[k], w);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[VEC];
        unpack(raw[k][c], v);
        sc[c] = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) sc[c] += v[i] * g[i];
#pragma unroll
        for (int o = 1; o < GL; o <<= 1)
          sc[c] += __shfl_xor_sync(0xffffffffu, sc[c], o);
        const float f = sm[k].a * w[c];
        float* dst = dvb + sm[k].row[c] * rowlen;
#pragma unroll
        for (int j = 0; j < VEC / 4; ++j)
          if (sm[k].in[c] && (j * GL + ln.sub) * 4 < D)
            atomicAdd(reinterpret_cast<float4*>(dst + (j * GL + ln.sub) * 4),
                      make_float4(f * ga[4 * j], f * ga[4 * j + 1], f * ga[4 * j + 2],
                                  f * ga[4 * j + 3]));
      }
      if (ln.live && s < LP && ln.sub == 0) {
        const Sample& q = sm[k];
        float dt = 0.f, dx = 0.f, dy = 0.f;
        if (q.inr) {
          dt = w[0] * sc[0] + w[1] * sc[1] + w[2] * sc[2] + w[3] * sc[3];
          dx = q.a * ((sc[1] - sc[0]) * (1.f - q.fy) + (sc[3] - sc[2]) * q.fy) * q.W;
          dy = q.a * ((sc[2] - sc[0]) * (1.f - q.fx) + (sc[3] - sc[1]) * q.fx) * q.H;
        }
        datt[ln.task * LP + s] = dt;
        reinterpret_cast<float2*>(dloc + ln.task * LP * 2)[s] = make_float2(dx, dy);
      }
    }
  }
}

// lanes per row: D / chunk rounded up to a power of two (0: unsupported D)
template <typename T>
int lanes_per_row(int D) {
  if (D <= 0 || D % chunk<T>()) return 0;
  int gl = 1;
  while (gl * chunk<T>() < D) gl *= 2;
  return gl <= 32 ? gl : 0;
}

// f(std::integral_constant<int, GL>{}) for the lanes per row that D needs
template <typename T, typename F>
int with_lanes_per_row(int D, F f) {
  switch (lanes_per_row<T>(D)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
  }
  return (int)cudaErrorInvalidValue;
}

unsigned blocks_for(long long n_tasks, int tasks_per_warp) {
  const long long warps = (n_tasks + tasks_per_warp - 1) / tasks_per_warp;
  return (unsigned)((warps * 32 + NT - 1) / NT);
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

template <typename T>
int launch_fwd(const void* value, const void* loc, const void* att, void* out,
               const Levels& lv, int B, int S, int Lq, int M, int D, int L,
               int P, cudaStream_t st) {
  const long long n = (long long)B * Lq * M;
  const T* v = (const T*)value;
  const float *lc = (const float*)loc, *at = (const float*)att;
  return with_lanes_per_row<T>(D, [&](auto gl) {
    constexpr int GL = decltype(gl)::value;
    ms_deform_attn_fwd_kernel<T, GL, 1><<<blocks_for(n, 32 / GL), NT, 0, st>>>(
        v, lc, at, (T*)out, lv, n, S, Lq, M, D, L, P);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int launch_bwd(const void* value, const void* loc, const void* att,
               const void* dout, float* dvalue, float* dloc, float* datt,
               const Levels& lv, int B, int S, int Lq, int M, int D, int L,
               int P, cudaStream_t st) {
  const long long n = (long long)B * Lq * M;
  const T *v = (const T*)value, *dy = (const T*)dout;
  const float *lc = (const float*)loc, *at = (const float*)att;
  return with_lanes_per_row<T>(D, [&](auto gl) {
    constexpr int GL = decltype(gl)::value;
    ms_deform_attn_bwd_kernel<T, GL, 32 / GL><<<blocks_for(n, 1), NT, 0, st>>>(
        v, lc, at, dy, dvalue, dloc, datt, lv, n, S, Lq, M, D, L, P);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// value: (B, S, M, D) of `dtype`; loc: (B, Lq, M, L, P, 2) fp32;
// att: (B, Lq, M, L, P) fp32; out: (B, Lq, M*D) of `dtype`; all contiguous,
// value and out 16-byte aligned. D: a multiple of 8 up to 256 (bf16) or of
// 4 up to 128 (fp32). levels: HOST int32 array (L, 3) of (H_l, W_l,
// start_l), copied into the launch parameters.
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc,
                                  const void* att, void* out,
                                  const int* levels, int B, int S, int Lq,
                                  int M, int D, int L, int P, int dtype,
                                  void* stream) {
  Levels lv{};
  if (!read_levels(lv, levels, L) || B * (long long)Lq * M == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32)
    return launch_fwd<float>(value, loc, att, out, lv, B, S, Lq, M, D, L, P, st);
  if (dtype == UNINEXT_BF16)
    return launch_fwd<__nv_bfloat16>(value, loc, att, out, lv, B, S, Lq, M, D,
                                     L, P, st);
  return (int)cudaErrorInvalidValue;
}

// The backward. value, loc, att, D as ms_deform_attn_fwd; dout:
// (B, Lq, M*D) of `dtype`, contiguous, 16-byte aligned. Outputs, fp32,
// contiguous: dvalue (B, S, M, D), 16-byte aligned and ZEROED by the caller
// (reductions add into it); dloc (B, Lq, M, L, P, 2); datt (B, Lq, M, L, P).
extern "C" int ms_deform_attn_bwd(const void* value, const void* loc,
                                  const void* att, const void* dout,
                                  float* dvalue, float* dloc, float* datt,
                                  const int* levels, int B, int S, int Lq,
                                  int M, int D, int L, int P, int dtype,
                                  void* stream) {
  Levels lv{};
  if (!read_levels(lv, levels, L) || B * (long long)Lq * M == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32)
    return launch_bwd<float>(value, loc, att, dout, dvalue, dloc, datt, lv, B, S,
                             Lq, M, D, L, P, st);
  if (dtype == UNINEXT_BF16)
    return launch_bwd<__nv_bfloat16>(value, loc, att, dout, dvalue, dloc, datt,
                                     lv, B, S, Lq, M, D, L, P, st);
  return (int)cudaErrorInvalidValue;
}
