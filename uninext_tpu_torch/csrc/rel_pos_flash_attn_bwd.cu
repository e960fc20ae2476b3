// Kernel A-bwd: the backward of kernel A (rel_pos_flash_attn.cu), flash
// style, from the logsumexp the forward saved.
//
// Replaces: the two Pallas kernels the stock TPU flash attention runs under
// jax.grad of uninext_tpu/models/vit.py:131 flash_rel_pos_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py:941
// _flash_attention_bwd_dkv and :1287 _flash_attention_bwd_dq), which there
// differentiate through the one-hot features the bias is folded into.
//
// With s = scale * q.k + bh[q, row(k)] + bw[q, col(k)] and
// P = exp(s - lse[q]):
//   dP = dO . v^T,  Dq = rowsum(dO * O),  dS = P * (dP - Dq)
//   dq_s = scale * dS . K    dk = scale * dS^T . Q    dv = P^T . dO
//   dbh[q, i] = sum_{k: row(k) = i} dS[q, k],  dbw[q, j] = sum_{k: col(k) = j} dS[q, k]
// The chain rule through bh = q.Rh and bw = q.Rw (dq += dbh.Rh + dbw.Rw,
// dRh, dRw) stays in torch einsums outside (models/vit.py), as the JAX
// package forms bh and bw with XLA einsums outside its Pallas call. The
// caller also passes Dq and the bias rows bh (B, nh, S, H) and bw
// (B, nh, S, W) in fp32, so neither kernel recomputes them per tile.
//
// Design: two kernels, as the stock Pallas version has, so that no sum
// crosses blocks and the result does not depend on scheduling:
//   * dkv: one block per (batch, head, 64-key tile); it streams the query
//     tiles and keeps dk and dv for its keys in registers;
//   * dq:  one block per (batch, head, 64-query tile); it streams the key
//     tiles, keeps dq in registers and dbh/dbw of its rows in shared
//     memory, where the dS of a row are added with shared-memory atomics
//     (keys of one tile share grid rows and columns).
// fp32 atomics into device memory for dk/dv would need (S/64) adds per
// element from every query tile; the split avoids them.
//
// What bounds it on the H100: like the forward, it multiplies on the fp32
// CUDA cores from shared memory (4 products of 64 x 64 x hd per tile pair
// in dkv, 3 in dq: about 3.5x the forward's work), far below the bf16
// tensor-core roofline. Tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr int MAX_HD = 128;
constexpr int CPT = MAX_HD / 16;

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* dsum; const float* bh; const float* bw;
  float* dq; float* dk; float* dv; float* dbh; float* dbw;
  int H, W, nh, hd;
  long long sb, ss, sh;
  float scale;
};

// Rows [r0, r0 + n) of a (.., S, nh, hd) tensor with strides (sb, ss, sh, 1)
// into shared memory with row stride ld; rows past S read as zeros.
template <typename T>
__device__ void load_rows(float* dst, const T* src, int r0, int S, int hd, int ld,
                          long long ss) {
  for (int e = threadIdx.x; e < BQ * hd; e += NT) {
    const int r = e / hd, d = e - r * hd;
    const int s = r0 + r;
    dst[r * ld + d] = s < S ? to_f32(src[s * ss + d]) : 0.f;
  }
}

// Per-row tables of rows [r0, r0 + BQ): bias rows (BQ x (H + W)), lse, Dq.
__device__ void load_row_tables(float* bhs, float* bws, float* lses, float* dsums,
                                const float* bh, const float* bw, const float* lse,
                                const float* dsum, int r0, int S, int H, int W) {
  for (int e = threadIdx.x; e < BQ * (H + W); e += NT) {
    const int r = e / (H + W), c = e - r * (H + W);
    const int s = r0 + r;
    if (c < H) bhs[r * H + c] = s < S ? bh[(long long)s * H + c] : 0.f;
    else bws[r * W + (c - H)] = s < S ? bw[(long long)s * W + (c - H)] : 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int s = r0 + r;
    lses[r] = s < S ? lse[s] : 0.f;
    dsums[r] = s < S ? dsum[s] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) bwd_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, hd = a.hd, S = H * W;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tx = threadIdx.x & 15;   // query columns tx + 16 j; output columns tx + 16 c
  const int ty = threadIdx.x >> 4;   // key rows ty * 4 + i
  const int ld = hd + 1;

  float* ks = smem;                   // BK x ld
  float* vs = ks + BK * ld;           // BK x ld
  float* qs = vs + BK * ld;           // BQ x ld
  float* dos = qs + BQ * ld;          // BQ x ld
  float* pt = dos + BQ * ld;          // BK x (BQ + 1): P^T
  float* dst = pt + BK * (BQ + 1);    // BK x (BQ + 1): dS^T
  float* bhs = dst + BK * (BQ + 1);   // BQ x H
  float* bws = bhs + BQ * H;          // BQ x W
  float* lses = bws + BQ * W;         // BQ
  float* dsums = lses + BQ;           // BQ

  const long long off = b * a.sb + h * a.sh;
  const long long bh_row = (b * a.nh + h) * S;    // row index into (B, nh, S, .)
  const T* qb = (const T*)a.q + off;
  const T* dob = (const T*)a.dout + (b * S * a.nh + h) * hd;
  load_rows(ks, (const T*)a.k + off, k0, S, hd, ld, a.ss);
  load_rows(vs, (const T*)a.v + off, k0, S, hd, ld, a.ss);

  int ki[4], kj[4];
  bool kvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    kvalid[i] = key < S;
    ki[i] = kvalid[i] ? key / W : 0;
    kj[i] = kvalid[i] ? key - ki[i] * W : 0;
  }
  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();   // previous query tile consumed
    load_rows(qs, qb, q0, S, hd, ld, a.ss);
    load_rows(dos, dob, q0, S, hd, ld, (long long)a.nh * hd);
    load_row_tables(bhs, bws, lses, dsums, a.bh + bh_row * H, a.bw + bh_row * W,
                    a.lse + bh_row, a.dsum + bh_row, q0, S, H, W);
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty * 4 + i) * ld + d];
        vv[i] = vs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * ld + d];
        dov[j] = dos[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] += kv[i] * qv[j];
          dpt[i][j] += vv[i] * dov[j];
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const bool qvalid = q0 + r < S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = 0.f, ds = 0.f;
        if (qvalid && kvalid[i]) {
          p = expf(st[i][j] * a.scale + bhs[r * H + ki[i]] + bws[r * W + kj[i]] - lses[r]);
          ds = p * (dpt[i][j] - dsums[r]);
        }
        pt[(ty * 4 + i) * (BQ + 1) + r] = p;
        dst[(ty * 4 + i) * (BQ + 1) + r] = ds;
      }
    }
    __syncthreads();

    const int qn = min(BQ, S - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty * 4 + i) * (BQ + 1) + qq];
        dsv[i] = dst[(ty * 4 + i) * (BQ + 1) + qq];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float dov = dos[qq * ld + col], qv = qs[qq * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] += pv[i] * dov;
            dk[i][c] += dsv[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!kvalid[i]) continue;
    const long long o = ((b * S + k0 + ty * 4 + i) * a.nh + h) * hd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) {
        a.dk[o + col] = dk[i][c] * a.scale;
        a.dv[o + col] = dv[i][c];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, hd = a.hd, S = H * W;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tx = threadIdx.x & 15;   // key columns tx + 16 j; output columns tx + 16 c
  const int ty = threadIdx.x >> 4;   // query rows ty * 4 + i
  const int ld = hd + 1;

  float* qs = smem;                   // BQ x ld
  float* dos = qs + BQ * ld;          // BQ x ld
  float* ks = dos + BQ * ld;          // BK x ld
  float* vs = ks + BK * ld;           // BK x ld
  float* dss = vs + BK * ld;          // BQ x (BK + 1): dS
  float* bhs = dss + BQ * (BK + 1);   // BQ x H
  float* bws = bhs + BQ * H;          // BQ x W
  float* gbh = bws + BQ * W;          // BQ x H: dbh of this tile's rows
  float* gbw = gbh + BQ * H;          // BQ x W: dbw
  float* lses = gbw + BQ * W;         // BQ
  float* dsums = lses + BQ;           // BQ

  const long long off = b * a.sb + h * a.sh;
  const long long bh_row = (b * a.nh + h) * S;
  const T* kb = (const T*)a.k + off;
  const T* vb = (const T*)a.v + off;
  load_rows(qs, (const T*)a.q + off, q0, S, hd, ld, a.ss);
  load_rows(dos, (const T*)a.dout + (b * S * a.nh + h) * hd, q0, S, hd, ld,
            (long long)a.nh * hd);
  load_row_tables(bhs, bws, lses, dsums, a.bh + bh_row * H, a.bw + bh_row * W,
                  a.lse + bh_row, a.dsum + bh_row, q0, S, H, W);
  for (int e = threadIdx.x; e < BQ * (H + W); e += NT) gbh[e] = 0.f;   // gbh, gbw adjacent

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();   // previous key tile consumed (and the row tables written)
    load_rows(ks, kb, k0, S, hd, ld, a.ss);
    load_rows(vs, vb, k0, S, hd, ld, a.ss);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * ld + d];
        dov[i] = dos[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * ld + d];
        vv[j] = vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] += qv[i] * kv[j];
          dp[i][j] += dov[i] * vv[j];
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool kvalid = col < S;
      const int ki = kvalid ? col / W : 0;
      const int kj = kvalid ? col - ki * W : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float ds = 0.f;
        if (kvalid && q0 + r < S) {
          const float p = expf(sc[i][j] * a.scale + bhs[r * H + ki] + bws[r * W + kj] - lses[r]);
          ds = p * (dp[i][j] - dsums[r]);
          atomicAdd(&gbh[r * H + ki], ds);
          atomicAdd(&gbw[r * W + kj], ds);
        }
        dss[r * (BK + 1) + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    const int kn = min(BK, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float kv = ks[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += dsv[i] * kv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const long long o = ((b * S + s) * a.nh + h) * hd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) a.dq[o + col] = acc[i][c] * a.scale;
    }
  }
  __syncthreads();   // every atomic add into gbh / gbw done
  for (int e = threadIdx.x; e < BQ * (H + W); e += NT) {
    const int r = e / (H + W), c = e - r * (H + W);
    const int s = q0 + r;
    if (s >= S) continue;
    if (c < H) a.dbh[(bh_row + s) * H + c] = gbh[r * H + c];
    else a.dbw[(bh_row + s) * W + (c - H)] = gbw[r * W + (c - H)];
  }
}

size_t dkv_smem(int H, int W, int hd) {
  return sizeof(float) * (size_t)(4 * 64 * (hd + 1) + 2 * BK * (BQ + 1) + BQ * (H + W) + 2 * BQ);
}

size_t dq_smem(int H, int W, int hd) {
  return sizeof(float) * (size_t)(4 * 64 * (hd + 1) + BQ * (BK + 1) + 2 * BQ * (H + W) + 2 * BQ);
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int S = a.H * a.W;
  const size_t s1 = dkv_smem(a.H, a.W, a.hd), s2 = dq_smem(a.H, a.W, a.hd);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + 63) / 64, a.nh, B);
  bwd_dkv_kernel<T><<<grid, NT, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<T><<<grid, NT, s2, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H*W, nh, hd) with element strides (sb, ss, sh, 1), shared by
// the three; dout: (B, H*W, nh, hd) contiguous; all of dtype `dtype`.
// fp32: lse, dsum (B, nh, S); bh (B, nh, S, H); bw (B, nh, S, W).
// Outputs, fp32, contiguous: dq, dk, dv (B, S, nh, hd) (dq without the
// bias terms), dbh (B, nh, S, H), dbw (B, nh, S, W).
extern "C" int rel_pos_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* bh, const float* bw,
    float* dq, float* dk, float* dv, float* dbh, float* dbw,
    int B, int H, int W, int nh, int hd, long long sb, long long ss,
    long long sh, float scale, int dtype, void* stream) {
  if (hd > MAX_HD || hd < 1) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, dsum, bh, bw, dq, dk, dv, dbh, dbw,
         H, W, nh, hd, sb, ss, sh, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == UNINEXT_F32) return launch<float>(a, B, st);
  if (dtype == UNINEXT_BF16) return launch<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// the larger of the two kernels' shared memory at these sizes
extern "C" long long rel_pos_flash_attn_bwd_smem_bytes(int H, int W, int hd) {
  const size_t a = dkv_smem(H, W, hd), b = dq_smem(H, W, hd);
  return (long long)(a > b ? a : b);
}
