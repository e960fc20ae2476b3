// Kernel A: ViTDet attention with the decomposed relative-position bias,
// computed flash-style (online softmax, nothing attention-sized in memory).
//
// Replaces: uninext_tpu/models/vit.py:131 flash_rel_pos_attention, which
// runs the stock Pallas TPU flash kernel after folding the bias into the
// q.k product by concatenating one-hot features (head_dim 80 padded to 256).
//
//   out[b,q,h,:] = sum_k softmax_k(scale * q.k + bh[q, k / W] + bw[q, k % W]) v[b,k,h,:]
//   bh[q,i] = q . Rh[y(q), i, :],   bw[q,j] = q . Rw[x(q), j, :]   (UNSCALED q)
//
// With a non-null `lse` it also writes each row's logsumexp
// lse[b,h,q] = max + log(sum) of the biased scores, fp32 (B, nh, S): the
// backward kernels (rel_pos_flash_attn_bwd.cu) recompute P = exp(s - lse)
// from it instead of storing any attention-sized tensor.
//
// Design: one block per (batch*window, head, 64-query tile), 256 threads as
// a 16 x 16 grid; each thread owns 4 query rows and 4 key columns of a
// 64 x 64 score tile and 4 rows x ceil(hd/16) output columns. The block
// first computes bh and bw for its rows into shared memory (64 x (H+W)
// fp32, 32 KB at the 50 x 76 grid), then streams 64-key tiles of k and v
// through shared memory, adds the bias by table lookup, and keeps an fp32
// running max, sum and accumulator per row; it normalises once at the end.
// No one-hot features and no head_dim padding: hd = 80 and the ragged last
// tiles are handled with bounds checks and -inf masking.
//
// What bounds it on the H100: this first version multiplies on the fp32
// CUDA cores (no tensor cores), reading both operands of every product from
// shared memory, so it is bound by shared-memory bandwidth and fp32 issue
// rate, far below the bf16 tensor-core roofline (ViT-H global block at
// 800x1216: 2 * 2 * 3800^2 * 80 * 16 = 74 GFLOP). The register tiling
// (4 x 4 scores, 4 x 5 outputs per thread) halves the shared-memory reads
// per multiply-add against one row per thread. Moving the two products to
// wgmma/mma.sync in bf16 is later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per streamed tile
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr int MAX_HD = 128;   // head_dim limit
constexpr int CPT = MAX_HD / 16;  // output columns per thread at MAX_HD

// WITH_LSE: write the per-row logsumexp (training); the serving build of the
// kernel has no trace of it.
template <typename T, bool WITH_LSE>
__global__ void __launch_bounds__(NT) rel_pos_flash_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ rh, const T* __restrict__ rw, T* __restrict__ out,
    float* __restrict__ lse, int H, int W, int nh, int hd, long long sb, long long ss, long long sh,
    float scale) {
  extern __shared__ float smem[];
  const int S = H * W;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key columns tx + 16 j; output columns tx + 16 c
  const int ty = tid >> 4;   // query rows ty * 4 + i
  const int ld = hd + 1;     // odd stride: conflict-free column reads

  float* qs = smem;                   // BQ x ld
  float* ks = qs + BQ * ld;           // BK x ld
  float* vs = ks + BK * ld;           // BK x hd
  float* ps = vs + BK * hd;           // BQ x (BK + 1)
  float* bhs = ps + BQ * (BK + 1);    // BQ x H
  float* bws = bhs + BQ * H;          // BQ x W

  const T* qb = q + b * sb + h * sh;
  const T* kb = k + b * sb + h * sh;
  const T* vb = v + b * sb + h * sh;

  for (int e = tid; e < BQ * hd; e += NT) {
    const int r = e / hd, d = e - r * hd;
    const int s = q0 + r;
    qs[r * ld + d] = s < S ? to_f32(qb[s * ss + d]) : 0.f;
  }
  __syncthreads();

  // decomposed rel-pos bias of this block's rows, from the unscaled q
  for (int e = tid; e < BQ * (H + W); e += NT) {
    const int r = e / (H + W), c = e - r * (H + W);
    const int s = min(q0 + r, S - 1);
    const int y = s / W, x = s - y * W;
    const T* tab = c < H ? rh + ((long long)y * H + c) * hd
                         : rw + ((long long)x * W + (c - H)) * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc += qs[r * ld + d] * to_f32(tab[d]);
    if (c < H) bhs[r * H + c] = acc; else bws[r * W + (c - H)] = acc;
  }

  float m_run[4], l_run[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();   // previous tile fully consumed (and bias tables written)
    for (int e = tid; e < BK * hd; e += NT) {
      const int r = e / hd, d = e - r * hd;
      const int s = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        kv = to_f32(kb[s * ss + d]);
        vv = to_f32(vb[s * ss + d]);
      }
      ks[r * ld + d] = kv;
      vs[r * hd + d] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool valid = col < S;
      const int ki = valid ? col / W : 0;
      const int kj = valid ? col - ki * W : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        sc[i][j] = valid ? sc[i][j] * scale + bhs[r * H + ki] + bws[r * W + kj]
                         : -INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);   // finite: every tile has a valid key
      const float corr = expf(m_run[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run[i] = l_run[i] * corr + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int kn = min(BK, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float vv = vs[kk * hd + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float inv = 1.f / l_run[i];
    if (WITH_LSE && tx == 0) lse[(b * nh + h) * S + s] = m_run[i] + logf(l_run[i]);
    T* o = out + ((b * S + s) * nh + h) * hd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) o[col] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, bool WITH_LSE>
int launch(const void* q, const void* k, const void* v, const void* rh,
           const void* rw, void* out, float* lse, int B, int H, int W, int nh, int hd,
           long long sb, long long ss, long long sh, float scale,
           cudaStream_t stream) {
  const int S = H * W;
  const size_t smem = sizeof(float) *
      (size_t)(BQ * (hd + 1) + BK * (hd + 1) + BK * hd + BQ * (BK + 1) + BQ * (H + W));
  cudaError_t err = cudaFuncSetAttribute(
      rel_pos_flash_attn_kernel<T, WITH_LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, nh, B);
  rel_pos_flash_attn_kernel<T, WITH_LSE><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)rh, (const T*)rw, (T*)out,
      lse, H, W, nh, hd, sb, ss, sh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H*W, nh, hd) with element strides (sb, ss, sh, 1), shared by
// the three; rh: (H, H, hd); rw: (W, W, hd); out: (B, H*W, nh*hd)
// contiguous. All of dtype `dtype` (UNINEXT_F32 or UNINEXT_BF16). `lse`:
// null, or (B, nh, H*W) fp32 for the per-row logsumexp.
extern "C" int rel_pos_flash_attn(const void* q, const void* k, const void* v,
                                  const void* rh, const void* rw, void* out,
                                  float* lse, int B, int H, int W, int nh, int hd,
                                  long long sb, long long ss, long long sh,
                                  float scale, int dtype, void* stream) {
  if (hd > MAX_HD || hd < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32)
    return lse ? launch<float, true>(q, k, v, rh, rw, out, lse, B, H, W, nh, hd, sb, ss, sh, scale, st)
               : launch<float, false>(q, k, v, rh, rw, out, lse, B, H, W, nh, hd, sb, ss, sh, scale, st);
  if (dtype == UNINEXT_BF16)
    return lse ? launch<__nv_bfloat16, true>(q, k, v, rh, rw, out, lse, B, H, W, nh, hd, sb, ss,
                                             sh, scale, st)
               : launch<__nv_bfloat16, false>(q, k, v, rh, rw, out, lse, B, H, W, nh, hd, sb, ss,
                                              sh, scale, st);
  return (int)cudaErrorInvalidValue;
}

// shared memory bytes the kernel asks for at these sizes (the wrapper checks
// it against the card's limit before launching)
extern "C" long long rel_pos_flash_attn_smem_bytes(int H, int W, int hd) {
  return (long long)sizeof(float) *
         (BQ * (hd + 1) + BK * (hd + 1) + BK * hd + BQ * (BK + 1) + BQ * (H + W));
}
