// Kernel A on the bf16 tensor cores: ViTDet attention with the decomposed
// relative-position bias, flash-style (online softmax, nothing
// attention-sized in memory). The bf16 route of kernel A; fp32 inputs take
// the CUDA-core kernel in rel_pos_flash_attn.cu.
//
// Replaces: uninext_tpu/models/vit.py:131 flash_rel_pos_attention, which
// runs the stock Pallas TPU flash kernel after folding the bias into the
// q.k product by concatenating one-hot features (head_dim 80 padded to 256).
// Here the bias tables are read per score instead:
//
//   out[b,q,h,:] = sum_k softmax_k(scale * q.k + bh[q, k / W] + bw[q, k % W]) v[b,k,h,:]
//
// with bh = q.Rh (B, nh, H, W, H) and bw = q.Rw (B, nh, H, W, W) in fp32
// from the caller (models/vit.py:rel_pos_bias; the JAX package, too, forms
// them with einsums outside its Pallas call), read through their strides.
// With a non-null `lse` it also writes each row's natural-log logsumexp of
// the biased scores, fp32 (B, nh, S), which the backward kernels
// (rel_pos_flash_attn_bwd.cu) read.
//
// Design:
//   * one block per (batch*window, head, 128-query tile). Up to hd 80 a
//     block is 4 warps of 32 rows, two m16 tiles per warp sharing every K
//     and V fragment; above, 8 warps of 16 rows (registers). A warp keeps
//     its Q fragments in registers for the whole key loop (hd 80 = 5
//     k-steps of 16);
//   * both products on the tensor cores, mma.sync m16n8k16 (bf16 in, fp32
//     accumulate; helpers in mma_bf16.cuh): S = Q.K^T with K fragments by
//     ldmatrix, O += P.V with V fragments by ldmatrix.trans;
//   * keys are walked in a padded space, grid rows of Wp = W rounded up to 8
//     (80 at W = 76), so that an 8-key n-tile lies in one grid row. K and V
//     stream through shared memory in tiles of 64 padded keys by 16-byte
//     cp.async, double-buffered (tile t+1 loads while tile t multiplies);
//     padding keys and the columns from hd up to the next multiple of 16 are
//     zero-filled by the copies. Rows are hd rounded up to 16 plus 8 bf16
//     (an odd number of 16-byte units), so the 8 row addresses of an
//     ldmatrix fall in 8 distinct bank groups;
//   * the block's rows of bh and bw are copied into shared memory once, by
//     4-byte cp.async in flight with tile 0, then scaled in place: bh to log2
//     units, bw by 1 / scale, with -1e30 at padding keys (67.5 KB at 128 rows
//     of the 50 x 76 grid). bw seeds the q.k accumulators (8-byte loads, rows
//     offset so that a half-warp's loads are conflict-free), so
//     acc = q.k + bw / scale; bh is one value per row and n-tile, folded
//     into the exponent: p = exp2(acc scale log2(e) + bh - max);
//   * online softmax in fp32 registers in base 2 (ex2.approx), row max and
//     sum over the 4 lanes that share a row; the outputs are rescaled only
//     when some row's max grew. P is rounded to bf16 in registers and fed
//     back as the A operand of P.V (the Pallas kernel, too, rounds p to v's
//     dtype before that product), with no trip through shared memory;
//     normalised once at the end, staged through the K/V buffers and
//     written with 16-byte stores. lse = (max + log2 sum) ln 2.
//
// What bounds it on the H100: the bf16 tensor-core roofline of the global
// block at 800x1216 is 74 GFLOP, 0.076 ms; mma.sync reaches a fraction of
// that peak (wgmma is the way to the rest). Below that, shared memory:
// every warp reads the whole K and V tile through ldmatrix (10 KB each per
// 64 keys at hd 80, shared by its two m-tiles) plus its bias entries, at
// 128 B per clock per SM. At hd = 80 the exponential and the fp32 softmax
// arithmetic per score cost about as much as the products, and with 8
// warps per SM (registers) little of the three overlaps.
//
// Resources (nvcc -Xptxas -v, sm_90a, printed by chip_smoke.py from the
// build log): at hd 80 (KS = 5, 4 warps): 255 registers, 12 bytes of spill
// stores and loads; shared memory 45056 B of K/V tiles + 69120 B of bias =
// 114176 B at the 50 x 76 grid (64000 B at 14 x 14): two blocks (8 warps)
// per SM. hd 64: 250 registers, no spills; hd 128 (8 warps): 203, none.
#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int BQ = 128;   // query rows per block
constexpr int BK = 64;        // padded keys per tile
constexpr int NJ = BK / 8;    // n-tiles of 8 keys per tile
constexpr float LN2 = 0.6931471805599453f;

// m-tiles of 16 rows per warp: two share every K and V fragment (half the
// shared-memory reads per product) up to hd 80; one above, for registers
__host__ __device__ constexpr int m_tiles(int ks_steps) { return ks_steps <= 5 ? 2 : 1; }
__host__ __device__ constexpr int threads(int ks_steps) {
  return BQ / (16 * m_tiles(ks_steps)) * 32;
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bh;   // element (b, h, y, x, i) at b*hs[0] + h*hs[1] + y*hs[2] + x*hs[3] + i
  const float* bw;   // element (b, h, y, x, j) at b*ws[0] + h*ws[1] + y*ws[2] + x*ws[3] + j
  __nv_bfloat16* out;
  float* lse;
  int H, W, nh, hd;
  int Wp;            // grid row width in the padded key space (W rounded up to 8)
  int HS;            // row stride of the bh table in shared memory
  long long sb, ss, sh;
  long long hs[4], ws[4];
  float scale;
};

size_t smem_bytes(int ks_steps, const Layout& L) {
  return 4 * (size_t)BK * (16 * ks_steps + 8) * sizeof(__nv_bfloat16) +
         ((size_t)BQ * L.HS + bw_row(BQ, L.Wp)) * sizeof(float);
}

// KS: k-steps of 16 over the head dim (hd <= 16 * KS)
template <int KS>
__global__ void __launch_bounds__(threads(KS), KS <= 5 ? 2 : 1)
    rel_pos_flash_attn_mma_kernel(Args a) {
  constexpr int MT = m_tiles(KS);
  constexpr int NT = threads(KS);
  constexpr int HDP = 16 * KS;   // head dim padded to the mma depth
  constexpr int LDS = HDP + 8;   // smem row stride (bf16): odd count of 16-byte units
  constexpr int CPR = HDP / 8;   // 16-byte chunks per padded row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BK][LDS]
  __nv_bfloat16* vs = ks + 2 * BK * LDS;                             // [2][BK][LDS]
  float* bhs = reinterpret_cast<float*>(vs + 2 * BK * LDS);          // [BQ][HS]
  float* bws = bhs + BQ * a.HS;                                      // rows at bw_row

  const int H = a.H, W = a.W, Wp = a.Wp, hd = a.hd, S = H * W;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const float inv_wp = 1.f / (float)Wp;
  const int ntiles = (H * Wp + BK - 1) / BK;

  const long long off = b * a.sb + h * a.sh;
  const __nv_bfloat16* kb = a.k + off;
  const __nv_bfloat16* vb = a.v + off;

  // K and V of padded keys [k0, k0 + BK) into buffer `buf`; padding keys
  // and the columns from hd up are zero-filled
  auto load_tile = [&](int buf, int k0) {
    __nv_bfloat16* kd = ks + buf * BK * LDS;
    __nv_bfloat16* vd = vs + buf * BK * LDS;
    for (int e = tid; e < BK * CPR; e += NT) {
      const int r = e / CPR, c = e - r * CPR;
      const int pk = k0 + r;
      const int y = (int)(((float)pk + 0.5f) * inv_wp), x = pk - y * Wp;
      const bool ok = y < H && x < W && 8 * c < hd;
      const long long src = ok ? (long long)(y * W + x) * a.ss + 8 * c : 0;
      cp_async_16(kd + r * LDS + 8 * c, kb + src, ok);
      cp_async_16(vd + r * LDS + 8 * c, vb + src, ok);
    }
    cp_async_commit();
  };
  // this block's rows of the bias, a warp per row, by 4-byte async copies
  // in flight together with K and V of tile 0: bh, then FAR for grid rows
  // past H; bw, then FAR for padding columns; 0 for query rows past S
  for (int r = warp; r < BQ; r += NT / 32) {
    const int s = q0 + r;
    float* hdst = bhs + r * a.HS;
    float* wdst = bws + bw_row(r, Wp);
    if (s < S) {
      const int y = s / W, x = s - (s / W) * W;
      const float* hrow = a.bh + b * a.hs[0] + h * a.hs[1] + y * a.hs[2] + x * a.hs[3];
      const float* wrow = a.bw + b * a.ws[0] + h * a.ws[1] + y * a.ws[2] + x * a.ws[3];
      for (int i = lane; i < H; i += 32) cp_async_4(hdst + i, hrow + i);
      for (int j = lane; j < W; j += 32) cp_async_4(wdst + j, wrow + j);
    } else {
      for (int i = lane; i < H; i += 32) hdst[i] = 0.f;
      for (int j = lane; j < W; j += 32) wdst[j] = 0.f;
    }
    for (int i = H + lane; i < a.HS; i += 32) hdst[i] = FAR;
    for (int j = W + lane; j < Wp; j += 32) wdst[j] = FAR;
  }
  cp_async_commit();
  load_tile(0, 0);

  // the Q fragments of this warp's rows (m-tile mt: rows wrow0 + 16 mt + g
  // and + 8 of the block), zero past S and hd
  const __nv_bfloat16* qb = a.q + off;
  const int wrow0 = warp * 16 * MT;
  uint32_t qa[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = q0 + wrow0 + 16 * mt + g + ((i & 1) ? 8 : 0);
        const int c = 16 * kk + 2 * tq + ((i & 2) ? 8 : 0);
        qa[mt][kk][i] = s < S && c < hd
            ? *reinterpret_cast<const uint32_t*>(qb + (long long)s * a.ss + c)
            : 0u;
      }

  // the bias copies have landed (tile 0's may still be in flight): bh to
  // log2 units, bw over `scale` (it seeds the q.k accumulators), in place.
  // The loop's first barrier orders this before any use.
  cp_async_wait<1>();
  __syncthreads();
  {
    const float inv_scale = 1.f / a.scale;
    const int nh_ = BQ * a.HS, nw_ = bw_row(BQ, Wp);
    for (int e = tid; e < nh_ + nw_; e += NT) bhs[e] *= e < nh_ ? LOG2E : inv_scale;
  }

  const float scale2 = a.scale * LOG2E;
  const bool active = q0 + wrow0 < S;   // a warp of padding rows only skips the math

  // per m-tile and half (rows g, g + 8): running max, this thread's part of
  // the running sum, output accumulators (n-tile n: columns 8n..8n+7)
  float m[MT][2], l[MT][2], o[MT][2 * KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = FAR;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][n][i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile((t + 1) & 1, (t + 1) * BK);
    else cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();       // this thread's copies of tile t have landed
    __syncthreads();          // ... and every thread's (and the bias tables)
    if (active) {
      const __nv_bfloat16* kt = ks + (t & 1) * BK * LDS;
      const __nv_bfloat16* vt = vs + (t & 1) * BK * LDS;

      // n-tile j of the tile lies in grid row yj[j], from column xj[j] (the
      // same for the whole warp)
      int yj[NJ], xj[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int pk = t * BK + 8 * j;
        yj[j] = (int)(((float)pk + 0.5f) * inv_wp);
        xj[j] = pk - yj[j] * Wp;
      }

      // S = Q K^T + bw / scale: the accumulators start from the bias rows
      // (this thread's columns 2 tq and 2 tq + 1 of each n-tile)
      float sc[MT][NJ][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* bwr = bws + bw_row(wrow0 + 16 * mt + g + 8 * hf, Wp) + 2 * tq;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float2 w2 = *reinterpret_cast<const float2*>(bwr + xj[j]);
            sc[mt][j][2 * hf] = w2.x;
            sc[mt][j][2 * hf + 1] = w2.y;
          }
        }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LDS + 16 * kk +
                              (((lane >> 3) & 1) << 3));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(sc[mt][2 * jp], qa[mt][kk], kf[0], kf[1]);
            mma_16816(sc[mt][2 * jp + 1], qa[mt][kk], kf[2], kf[3]);
          }
        }
      }

      // scores in log2 units: scale2 (q.k + bw / scale) + bh of the key's
      // grid row, exponentiated as exp2(scale2 acc + (bh - max)); online
      // softmax over the 4 lanes of each row
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        bool grew = false;
        float corr[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* bhr = bhs + (wrow0 + 16 * mt + g + 8 * hf) * a.HS;
          float hb[NJ];
          float mx = FAR;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            hb[j] = bhr[yj[j]];
            mx = fmaxf(mx, fmaf(fmaxf(sc[mt][j][2 * hf], sc[mt][j][2 * hf + 1]), scale2, hb[j]));
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // every tile holds a key (its first), so mx is a real score
          const float mn = fmaxf(m[mt][hf], mx);
          grew |= mn != m[mt][hf];
          corr[hf] = exp2_approx(m[mt][hf] - mn);
          m[mt][hf] = mn;
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float c = hb[j] - mn;
            sc[mt][j][2 * hf] = exp2_approx(fmaf(sc[mt][j][2 * hf], scale2, c));
            sc[mt][j][2 * hf + 1] = exp2_approx(fmaf(sc[mt][j][2 * hf + 1], scale2, c));
            rs += sc[mt][j][2 * hf] + sc[mt][j][2 * hf + 1];
          }
          l[mt][hf] = l[mt][hf] * corr[hf] + rs;
        }
        // rescale the outputs only when some row's max grew (corr is 1 else)
        if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
          for (int n = 0; n < 2 * KS; ++n) {
            o[mt][n][0] *= corr[0];
            o[mt][n][1] *= corr[0];
            o[mt][n][2] *= corr[1];
            o[mt][n][3] *= corr[1];
          }
        }
      }

      // O += P V, P rounded to bf16 in registers: n-tiles (2kk, 2kk + 1) of
      // the scores are the A fragment of keys 16kk..16kk+15
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16x2(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16x2(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16x2(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16x2(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDS +
                                    16 * np + ((lane >> 4) << 3));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(o[mt][2 * np], pa[mt], vf[0], vf[1]);
            mma_16816(o[mt][2 * np + 1], pa[mt], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();   // tile t consumed before the next iteration refills its buffer
  }

  // normalise, stage the bf16 rows in the K buffers, then 16-byte stores
  __nv_bfloat16* os = ks;   // [BQ][LDS]
  if (active) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float lt = l[mt][hf];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.f / lt;
        const int r = wrow0 + 16 * mt + g + 8 * hf;
#pragma unroll
        for (int n = 0; n < 2 * KS; ++n)
          *reinterpret_cast<uint32_t*>(os + r * LDS + 8 * n + 2 * tq) =
              pack_bf16x2(o[mt][n][2 * hf] * inv, o[mt][n][2 * hf + 1] * inv);
        if (a.lse != nullptr && tq == 0 && q0 + r < S)
          a.lse[(b * a.nh + h) * S + q0 + r] = (m[mt][hf] + log2f(lt)) * LN2;
      }
    }
  }
  __syncthreads();
  const int nrows = min(BQ, S - q0);
  const int cpr = hd / 8;
  for (int e = tid; e < nrows * cpr; e += NT) {
    const int r = e / cpr, c = e - r * cpr;
    *reinterpret_cast<uint4*>(a.out + ((b * S + q0 + r) * a.nh + h) * hd + 8 * c) =
        *reinterpret_cast<const uint4*>(os + r * LDS + 8 * c);
  }
}

template <int KS>
int launch(const Args& a, const Layout& L, int B, cudaStream_t stream) {
  const int S = a.H * a.W;
  const size_t smem = smem_bytes(KS, L);
  cudaError_t err = cudaFuncSetAttribute(rel_pos_flash_attn_mma_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, a.nh, B);
  rel_pos_flash_attn_mma_kernel<KS><<<grid, threads(KS), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, H*W, nh, hd) with element strides (sb, ss, sh, 1),
// shared by the three, 16-byte aligned rows (hd a multiple of 8, <= 128);
// bh (B, nh, H, W, H) and bw (B, nh, H, W, W) fp32 with element strides
// (hs[0..3], 1) and (ws[0..3], 1); out (B, H*W, nh*hd) bf16 contiguous;
// `lse`: null, or (B, nh, H*W) fp32.
extern "C" int rel_pos_flash_attn_mma(const void* q, const void* k, const void* v,
                                      const float* bh, const float* bw, void* out, float* lse,
                                      int B, int H, int W, int nh, int hd, long long sb,
                                      long long ss, long long sh, const long long* hs,
                                      const long long* ws, float scale, void* stream) {
  const Layout L = layout(H, W, BK);
  if (hd < 8 || hd > 128 || hd % 8 != 0 || (long long)L.ntiles * BK >= (1LL << 22))
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
               bh, bw, (__nv_bfloat16*)out, lse, H, W, nh, hd, L.Wp, L.HS,
               sb, ss, sh, {hs[0], hs[1], hs[2], hs[3]}, {ws[0], ws[1], ws[2], ws[3]}, scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return launch<1>(a, L, B, st);
    case 2: return launch<2>(a, L, B, st);
    case 3: return launch<3>(a, L, B, st);
    case 4: return launch<4>(a, L, B, st);
    case 5: return launch<5>(a, L, B, st);
    case 6: return launch<6>(a, L, B, st);
    case 7: return launch<7>(a, L, B, st);
    default: return launch<8>(a, L, B, st);
  }
}

// shared memory bytes the kernel asks for at these sizes (the wrapper checks
// it against the card's limit before launching)
extern "C" long long rel_pos_flash_attn_mma_smem_bytes(int H, int W, int hd) {
  return (long long)smem_bytes((hd + 15) / 16, layout(H, W, BK));
}
