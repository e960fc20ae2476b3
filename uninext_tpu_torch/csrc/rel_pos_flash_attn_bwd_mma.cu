// Kernel A-bwd on the bf16 tensor cores: the backward of kernel A's bf16
// route (rel_pos_flash_attn_mma.cu), flash style, from the natural-log
// logsumexp that the forward saved. fp32 inputs take the CUDA-core kernel
// in rel_pos_flash_attn_bwd.cu.
//
// Replaces: the two Pallas kernels the stock TPU flash attention runs under
// jax.grad of uninext_tpu/models/vit.py:131 flash_rel_pos_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py:941
// _flash_attention_bwd_dkv, kernel :796, and :1287 _flash_attention_bwd_dq,
// kernel :1146), which there differentiate through the one-hot features the
// bias is folded into.
//
// With s = scale * q.k + bh[q, row(k)] + bw[q, col(k)] and
// P = exp(s - lse[q]):
//   dV = P^T . dO,  dP = dO . V^T,  dS = P * (dP - Dq),  Dq = rowsum(dO * O)
//   dQ = scale * dS . K,  dK = scale * dS^T . Q
//   dbh[q, i] = sum over keys in grid row i of dS[q, k]
//   dbw[q, j] = sum over keys in grid column j of dS[q, k]
// The chain rule through bh = q.Rh and bw = q.Rw (dq += dbh.Rh + dbw.Rw,
// dRh, dRw) and Dq stay in torch outside (models/vit.py), as the JAX
// package forms bh and bw with XLA einsums outside its Pallas call.
//
// Design: two kernels, dkv then dq, as the Pallas version has: no sum
// crosses blocks, nothing is added atomically, and the result does not
// depend on scheduling. Every product is an mma.sync m16n8k16 (bf16 in,
// fp32 accumulate; helpers in mma_bf16.cuh), four per tile pair in dkv (S,
// dP, dV, dK) and three in dq (S, dP, dQ). P and dS are rounded to bf16
// before the products that read them, as the Pallas backward does
// (flash_attention.py:900, :918, :1258); dbh and dbw sum the fp32 dS.
//   * dkv, keys as M: one block of 4 warps per (batch*window, head, key
//     patch) where a patch is 8 grid rows x 8 grid columns of the padded
//     key space (grid rows of Wp = W rounded up to 8). Warp w holds the 16
//     keys of rows 2w and 2w + 1 as one m-tile, so lane (g, t) owns keys
//     (2w, g) and (2w + 1, g) of the patch: one grid column, two grid rows.
//     Its K and V fragments stay in registers for the whole block, and
//     S^T = K.Q^T, dP^T = V.dO^T come out in the C layout, which is the A
//     fragment of dV += P^T.dO and dK += dS^T.Q (dO and Q through
//     ldmatrix.trans): P^T and dS^T never pass through shared memory. The
//     query tiles (64 rows of Q and dO) stream through shared memory by
//     16-byte cp.async, double-buffered, with the bias terms the patch needs
//     staged beside them, transposed: bh[q, 8 patch rows] and bw[q, 8 patch
//     columns], 16 floats a query where the whole rows would be H + W, plus
//     lse and Dq. A score's bias is one of two bh rows (a warp-wide
//     broadcast) plus the lane's bw row. Each thread stages one patch row
//     and column for 4 query rows of every tile and tracks their grid
//     positions from tile to tile: a division and two 64-bit products per
//     staged float cost as much as the products of the tile.
//   * dq, queries as M (as kernel A): one block of 4 warps per
//     (batch*window, head, 64-query tile), 16 rows a warp, Q and dO
//     fragments in registers; K and V stream in tiles of 64 padded keys by
//     cp.async, double-buffered. bw (over scale) seeds the q.k accumulators
//     and bh - lse (log2 units) is one value per row and n-tile folded into
//     the exponent, as in the forward; padding keys carry a -1e30 bias.
//     dbh and dbw of the block's rows live in shared memory without
//     atomics. Keys are walked in order and an n-tile's 8 keys lie in one
//     grid row, so each grid row is one run of n-tiles: a thread sums its
//     dS of the run in registers, and at the run's end the 4 lanes of a row
//     add theirs by shuffles and the first stores dbh once. Lane t of a
//     row's quad only ever holds the columns j with j mod 8 in {2t, 2t + 1},
//     so each dbw entry has one owning thread, which adds to it with a
//     plain 8-byte read-modify-write.
//
// What bounds it on the H100: the bf16 tensor-core roofline of the global
// block at bs=2 (2 x 16 heads, S = 3800, hd 80) is 0.38 ms; the two
// kernels take about 8x that (PERF.md). Shared-memory bandwidth is
// not the limit: a warp's ldmatrix reads (40 KB per dkv query tile, 30 KB
// per dq key tile, for 16 keys or rows) come to about a quarter of the
// SM's 128 B per clock at that time. Latency is: the fragments and
// accumulators a warp holds (226-240 registers a thread at hd 80) leave 8
// warps per SM, two per scheduler, to hide the dependent ldmatrix, mma,
// exp2 and mma chains. More keys or rows per warp, or wgmma, would need
// registers or shared memory this design does not have.
//
// Resources (nvcc -Xptxas -v, sm_90a, printed by chip_smoke.py from the
// build log): at hd 80, dkv 240 registers and dq 226, no spills; hd 64: 213
// and 210; hd 128: 255 each, dkv with 52 bytes of spill stores. Shared
// memory: dkv 55296 B at hd 80 whatever the grid; dq 45056 B of K/V tiles +
// 2 x 34560 B of bias and its gradient = 114176 B at the 50 x 76 grid
// (64000 B at 14 x 14): two blocks (8 warps) per SM each.
#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int NT = 128;        // threads per block, both kernels (4 warps)
constexpr int BQ = 64;         // query rows: dkv's streamed tile, dq's block
constexpr int BK = 64;         // dq: padded keys per tile
constexpr int NJ = BK / 8;     // dq: n-tiles of 8 keys per tile
constexpr int PR = 8;          // dkv: grid rows per key patch (two per warp)
constexpr int PC = 8;          // dkv: grid columns per key patch
constexpr int LDT = BQ + 8;    // dkv: row stride (floats) of the staged bias
// dkv's per-buffer tables: bh^T [PR][LDT], bw^T [PC][LDT], lse [BQ], Dq [BQ]
constexpr int TAB = (PR + PC) * LDT + 2 * BQ;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // (B, nh, S), natural log
  const float* dsum;   // (B, nh, S): Dq = rowsum(dO * O)
  const float* bh;     // element (b, h, y, x, i) at b*hs[0] + h*hs[1] + y*hs[2] + x*hs[3] + i
  const float* bw;     // element (b, h, y, x, j) at b*ws[0] + h*ws[1] + y*ws[2] + x*ws[3] + j
  float* dq;           // (B, S, nh, hd) contiguous, without the bias terms
  __nv_bfloat16* dk;   // (B, S, nh, hd) contiguous
  __nv_bfloat16* dv;   // (B, S, nh, hd) contiguous
  float* dbh;          // with bh's strides
  float* dbw;          // with bw's strides
  int H, W, nh, hd;
  int Wp;              // grid row width in the padded key space (W rounded up to 8)
  int HS;              // dq: row stride of the bh tables in shared memory
  long long sb, ss, sh;      // q, k, v
  long long dsb, dss, dsh;   // dout
  long long hs[4], ws[4];
  float scale;
};

size_t dkv_smem(int ks_steps) {
  return 4 * (size_t)BQ * (16 * ks_steps + 8) * sizeof(__nv_bfloat16) +
         2 * (size_t)TAB * sizeof(float);
}

size_t dq_smem(int ks_steps, const Layout& L) {
  return 4 * (size_t)BK * (16 * ks_steps + 8) * sizeof(__nv_bfloat16) +
         2 * ((size_t)BQ * L.HS + bw_row(BQ, L.Wp)) * sizeof(float);
}

// KS: k-steps of 16 over the head dim (hd <= 16 * KS)
template <int KS>
__global__ void __launch_bounds__(NT, KS <= 5 ? 2 : 1) bwd_dkv_mma_kernel(Args a) {
  constexpr int LDS = 16 * KS + 8;   // smem row stride (bf16): odd count of 16-byte units
  constexpr int CPR = 2 * KS;        // 16-byte chunks per padded row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [2][BQ][LDS]
  __nv_bfloat16* os = qs + 2 * BQ * LDS;                             // dO [2][BQ][LDS]
  float* tabs = reinterpret_cast<float*>(os + 2 * BQ * LDS);         // [2][TAB]

  const int H = a.H, W = a.W, hd = a.hd, S = H * W;
  const int npx = a.Wp / PC;   // patches per patch row
  const int py0 = (blockIdx.x / npx) * PR, px0 = (blockIdx.x % npx) * PC;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const long long off = b * a.sb + h * a.sh;
  const long long doff = b * a.dsb + h * a.dsh;
  const long long roff = (b * a.nh + h) * S;
  const float* bhb = a.bh + b * a.hs[0] + h * a.hs[1];
  const float* bwb = a.bw + b * a.ws[0] + h * a.ws[1];
  const int nqt = (S + BQ - 1) / BQ;

  // the bias terms are staged by column: thread tid copies patch row and
  // column tc of query rows tr + 16 k (k < 4) of each tile from both
  // tables; (sy[k], sx[k]), the grid position of those rows, advance by BQ
  // queries a tile (no division per tile)
  constexpr int QK = BQ / 16;
  const int tc = tid & 7, tr = tid >> 3;
  const bool hok = py0 + tc < H, wok = px0 + tc < W;
  int sy[QK], sx[QK];
#pragma unroll
  for (int k = 0; k < QK; ++k) {
    sy[k] = (tr + 16 * k) / W;
    sx[k] = tr + 16 * k - sy[k] * W;
  }

  // query tile [q0, q0 + BQ) into buffer `buf` (tiles are loaded in
  // order): Q and dO rows (zero past S and from hd up), the patch's bias
  // terms transposed (zero outside the grid), lse (+1e30 past S, so that
  // P = 0 there) and Dq
  auto load_tile = [&](int buf, int q0) {
    __nv_bfloat16* qd = qs + buf * BQ * LDS;
    __nv_bfloat16* od = os + buf * BQ * LDS;
    for (int e = tid; e < BQ * CPR; e += NT) {
      const int r = e / CPR, c = e - r * CPR;
      const int s = q0 + r;
      const bool ok = s < S && 8 * c < hd;
      cp_async_16(qd + r * LDS + 8 * c, a.q + off + (ok ? s * a.ss + 8 * c : 0), ok);
      cp_async_16(od + r * LDS + 8 * c, a.dout + doff + (ok ? s * a.dss + 8 * c : 0), ok);
    }
    float* tb = tabs + buf * TAB;
#pragma unroll
    for (int k = 0; k < QK; ++k) {
      const int r = tr + 16 * k;
      const bool ok = q0 + r < S;
      float* hdst = tb + tc * LDT + r;          // bh^T row tc
      float* wdst = tb + (PR + tc) * LDT + r;   // bw^T row tc
      if (ok && hok) cp_async_4(hdst, bhb + sy[k] * a.hs[2] + sx[k] * a.hs[3] + py0 + tc);
      else *hdst = 0.f;
      if (ok && wok) cp_async_4(wdst, bwb + sy[k] * a.ws[2] + sx[k] * a.ws[3] + px0 + tc);
      else *wdst = 0.f;
      sx[k] += BQ;
      while (sx[k] >= W) {
        sx[k] -= W;
        ++sy[k];
      }
    }
    if (tid < 2 * BQ) {   // lse (threads 0..BQ-1), Dq (BQ..2BQ-1)
      const int r = tid & (BQ - 1), s = q0 + r;
      float* dst = tb + (PR + PC) * LDT + tid;
      if (s < S) cp_async_4(dst, (tid < BQ ? a.lse : a.dsum) + roff + s);
      else *dst = tid < BQ ? -FAR : 0.f;
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // this warp's keys: m-tile rows 0-7 are grid row ky[0], columns px0 + 0..7;
  // rows 8-15 grid row ky[1]. Lane (g, tq) holds column kx of both rows.
  const int ky[2] = {py0 + 2 * warp, py0 + 2 * warp + 1};
  const int kx = px0 + g;
  const bool kval[2] = {ky[0] < H && kx < W, ky[1] < H && kx < W};
  const long long krow[2] = {kval[0] ? (long long)(ky[0] * W + kx) : 0,
                             kval[1] ? (long long)(ky[1] * W + kx) : 0};
  uint32_t kf[KS][4], vf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hf = i & 1;
      const int c = 16 * kk + 2 * tq + ((i & 2) ? 8 : 0);
      const bool ok = kval[hf] && c < hd;
      const long long src = off + krow[hf] * a.ss + c;
      kf[kk][i] = ok ? *reinterpret_cast<const uint32_t*>(a.k + src) : 0u;
      vf[kk][i] = ok ? *reinterpret_cast<const uint32_t*>(a.v + src) : 0u;
    }

  float dk[2 * KS][4], dv[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const float scale2 = a.scale * LOG2E;
  const bool active = ky[0] < H;   // a warp of padding rows only skips the math

  for (int t = 0; t < nqt; ++t) {
    if (t + 1 < nqt) load_tile((t + 1) & 1, (t + 1) * BQ);
    else cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();       // this thread's copies of tile t have landed
    __syncthreads();          // ... and every thread's
    if (active) {
      const __nv_bfloat16* qt = qs + (t & 1) * BQ * LDS;
      const __nv_bfloat16* ot = os + (t & 1) * BQ * LDS;
      const float* tb = tabs + (t & 1) * TAB;
      const float* bh0 = tb + 2 * warp * LDT;   // bh[., ky[0]]; bh[., ky[1]] a row on
      const float* bwg = tb + (PR + g) * LDT;   // bw[., kx]
      const float* lses = tb + (PR + PC) * LDT;
      const float* dsums = lses + BQ;
      // two passes of 32 queries (4 n-tiles) a tile, for registers
#pragma unroll 1
      for (int p = 0; p < BQ / 32; ++p) {
        float st[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) st[n][i] = dp[n][i] = 0.f;
        // S^T = K Q^T, dP^T = V dO^T: Q and dO rows are B operands as loaded
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            const int ro = (32 * p + 16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                           16 * kk + (((lane >> 3) & 1) << 3);
            uint32_t bf[4];
            ldmatrix_x4(bf, qt + ro);
            mma_16816(st[2 * jp], kf[kk], bf[0], bf[1]);
            mma_16816(st[2 * jp + 1], kf[kk], bf[2], bf[3]);
            ldmatrix_x4(bf, ot + ro);
            mma_16816(dp[2 * jp], vf[kk], bf[0], bf[1]);
            mma_16816(dp[2 * jp + 1], vf[kk], bf[2], bf[3]);
          }
        }
        // P^T and dS^T in place: element (key g or g + 8, query c or c + 1)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 32 * p + 8 * n + 2 * tq;
          const float2 w2 = *reinterpret_cast<const float2*>(bwg + c);
          const float2 h0 = *reinterpret_cast<const float2*>(bh0 + c);
          const float2 h1 = *reinterpret_cast<const float2*>(bh0 + LDT + c);
          const float2 l2 = *reinterpret_cast<const float2*>(lses + c);
          const float2 d2 = *reinterpret_cast<const float2*>(dsums + c);
          const float u0 = w2.x - l2.x, u1 = w2.y - l2.y;
          const float p0 = exp2_approx(fmaf(st[n][0], scale2, (h0.x + u0) * LOG2E));
          const float p1 = exp2_approx(fmaf(st[n][1], scale2, (h0.y + u1) * LOG2E));
          const float p2 = exp2_approx(fmaf(st[n][2], scale2, (h1.x + u0) * LOG2E));
          const float p3 = exp2_approx(fmaf(st[n][3], scale2, (h1.y + u1) * LOG2E));
          st[n][0] = p0;
          st[n][1] = p1;
          st[n][2] = p2;
          st[n][3] = p3;
          dp[n][0] = p0 * (dp[n][0] - d2.x);
          dp[n][1] = p1 * (dp[n][1] - d2.y);
          dp[n][2] = p2 * (dp[n][2] - d2.x);
          dp[n][3] = p3 * (dp[n][3] - d2.y);
        }
        // dV += P^T dO, dK += dS^T Q over the pass's 32 queries (2 k-steps):
        // n-tiles (2kq, 2kq + 1) are the A fragment of k-step kq, rounded
        // to bf16; dO and Q rows are B operands through ldmatrix.trans
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const uint32_t pa[4] = {pack_bf16x2(st[2 * kq][0], st[2 * kq][1]),
                                  pack_bf16x2(st[2 * kq][2], st[2 * kq][3]),
                                  pack_bf16x2(st[2 * kq + 1][0], st[2 * kq + 1][1]),
                                  pack_bf16x2(st[2 * kq + 1][2], st[2 * kq + 1][3])};
          const uint32_t sa[4] = {pack_bf16x2(dp[2 * kq][0], dp[2 * kq][1]),
                                  pack_bf16x2(dp[2 * kq][2], dp[2 * kq][3]),
                                  pack_bf16x2(dp[2 * kq + 1][0], dp[2 * kq + 1][1]),
                                  pack_bf16x2(dp[2 * kq + 1][2], dp[2 * kq + 1][3])};
#pragma unroll
          for (int np = 0; np < KS; ++np) {
            const int ro = (32 * p + 16 * kq + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDS +
                           16 * np + ((lane >> 4) << 3);
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, ot + ro);
            mma_16816(dv[2 * np], pa, bf[0], bf[1]);
            mma_16816(dv[2 * np + 1], pa, bf[2], bf[3]);
            ldmatrix_x4_trans(bf, qt + ro);
            mma_16816(dk[2 * np], sa, bf[0], bf[1]);
            mma_16816(dk[2 * np + 1], sa, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();   // tile t consumed before the next iteration refills its buffer
  }

  // dK = scale dS^T Q and dV, rounded to bf16 once: lane (g, tq) holds
  // columns 8n + 2tq, + 1 of its two keys
  if (active) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!kval[hf]) continue;
      const long long o = ((b * S + krow[hf]) * a.nh + h) * hd;
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        if (8 * n >= hd) continue;
        const int c = 8 * n + 2 * tq;
        *reinterpret_cast<uint32_t*>(a.dk + o + c) =
            pack_bf16x2(dk[n][2 * hf] * a.scale, dk[n][2 * hf + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + o + c) = pack_bf16x2(dv[n][2 * hf], dv[n][2 * hf + 1]);
      }
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(NT, KS <= 5 ? 2 : 1) bwd_dq_mma_kernel(Args a) {
  constexpr int LDS = 16 * KS + 8;
  constexpr int CPR = 2 * KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BK][LDS]
  __nv_bfloat16* vs = ks + 2 * BK * LDS;                             // [2][BK][LDS]
  float* bhs = reinterpret_cast<float*>(vs + 2 * BK * LDS);          // [BQ][HS]
  float* bws = bhs + BQ * a.HS;                                      // rows at bw_row
  float* gbh = bws + bw_row(BQ, a.Wp);                               // dbh [BQ][HS]
  float* gbw = gbh + BQ * a.HS;                                      // dbw, rows at bw_row

  const int H = a.H, W = a.W, Wp = a.Wp, hd = a.hd, S = H * W;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const float inv_wp = 1.f / (float)Wp;
  const int ntiles = (H * Wp + BK - 1) / BK;
  const long long off = b * a.sb + h * a.sh;
  const long long roff = (b * a.nh + h) * S;
  const int ntab = BQ * a.HS + bw_row(BQ, Wp);   // floats of bh and bw tables

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
      const long long src = off + (ok ? (long long)(y * W + x) * a.ss + 8 * c : 0);
      cp_async_16(kd + r * LDS + 8 * c, a.k + src, ok);
      cp_async_16(vd + r * LDS + 8 * c, a.v + src, ok);
    }
    cp_async_commit();
  };
  // this block's rows of the bias, a warp per row, by 4-byte async copies
  // in flight together with K and V of tile 0: bh, then FAR for grid rows
  // past H; bw, then FAR for padding columns; 0 for query rows past S. The
  // gradient tables start at 0.
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
  for (int e = tid; e < ntab; e += NT) gbh[e] = 0.f;   // gbh, gbw adjacent
  cp_async_commit();
  load_tile(0, 0);

  // Q and dO fragments of this warp's rows (rows 16 warp + g and + 8 of the
  // block), zero past S and hd; Dq of the two rows
  const __nv_bfloat16* qb = a.q + off;
  const __nv_bfloat16* ob = a.dout + b * a.dsb + h * a.dsh;
  const int wrow0 = 16 * warp;
  uint32_t qa[KS][4], oa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = q0 + wrow0 + g + ((i & 1) ? 8 : 0);
      const int c = 16 * kk + 2 * tq + ((i & 2) ? 8 : 0);
      const bool ok = s < S && c < hd;
      qa[kk][i] = ok ? *reinterpret_cast<const uint32_t*>(qb + (long long)s * a.ss + c) : 0u;
      oa[kk][i] = ok ? *reinterpret_cast<const uint32_t*>(ob + (long long)s * a.dss + c) : 0u;
    }
  float dsum[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + wrow0 + g + 8 * hf;
    dsum[hf] = s < S ? a.dsum[roff + s] : 0.f;
  }

  // the bias copies have landed (tile 0's may still be in flight): bh - lse
  // to log2 units, bw over `scale` (it seeds the q.k accumulators), in
  // place. The loop's first barrier orders this before any use.
  cp_async_wait<1>();
  __syncthreads();
  {
    const float inv_scale = 1.f / a.scale;
    for (int r = warp; r < BQ; r += NT / 32) {
      const int s = q0 + r;
      const float l = s < S ? a.lse[roff + s] : 0.f;
      for (int i = lane; i < a.HS; i += 32) bhs[r * a.HS + i] = (bhs[r * a.HS + i] - l) * LOG2E;
      for (int j = lane; j < Wp; j += 32) bws[bw_row(r, Wp) + j] *= inv_scale;
    }
  }

  const float scale2 = a.scale * LOG2E;
  const bool active = q0 + wrow0 < S;   // a warp of padding rows only skips the math

  float dq[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  // dbh: keys are walked in order, so each grid row is one run of n-tiles.
  // This thread's part of the run's dS sum of its two rows is kept in
  // rsum; at the run's end the 4 lanes of a row add theirs and the first
  // stores dbh[row, run_y] (once: no read-modify-write).
  int run_y = 0;
  float rsum[2] = {0.f, 0.f};
  auto flush = [&]() {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = rsum[hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tq == 0) gbh[(wrow0 + g + 8 * hf) * a.HS + run_y] = v;
      rsum[hf] = 0.f;
    }
  };

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile((t + 1) & 1, (t + 1) * BK);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const __nv_bfloat16* kt = ks + (t & 1) * BK * LDS;
      const __nv_bfloat16* vt = vs + (t & 1) * BK * LDS;

      // n-tile j of the tile lies in grid row yj[j], from column xj[j]
      int yj[NJ], xj[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int pk = t * BK + 8 * j;
        yj[j] = (int)(((float)pk + 0.5f) * inv_wp);
        xj[j] = pk - yj[j] * Wp;
      }

      // S = Q K^T + bw / scale (accumulators seeded from the bias rows),
      // dP = dO V^T: K and V rows are B operands as loaded
      float sc[NJ][4], dp[NJ][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* bwr = bws + bw_row(wrow0 + g + 8 * hf, Wp) + 2 * tq;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 w2 = *reinterpret_cast<const float2*>(bwr + xj[j]);
          sc[j][2 * hf] = w2.x;
          sc[j][2 * hf + 1] = w2.y;
          dp[j][2 * hf] = dp[j][2 * hf + 1] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          const int ro = (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LDS + 16 * kk +
                         (((lane >> 3) & 1) << 3);
          uint32_t bf[4];
          ldmatrix_x4(bf, kt + ro);
          mma_16816(sc[2 * jp], qa[kk], bf[0], bf[1]);
          mma_16816(sc[2 * jp + 1], qa[kk], bf[2], bf[3]);
          ldmatrix_x4(bf, vt + ro);
          mma_16816(dp[2 * jp], oa[kk], bf[0], bf[1]);
          mma_16816(dp[2 * jp + 1], oa[kk], bf[2], bf[3]);
        }
      }

      // P = exp2(scale2 acc + bh - lse), dS = P (dP - Dq) in place of the
      // scores; dbh, dbw of the rows from the fp32 dS
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (yj[j] != run_y) {   // warp-uniform
          flush();
          run_y = yj[j];
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = wrow0 + g + 8 * hf;
          const float hb = bhs[r * a.HS + yj[j]];
          const float p0 = exp2_approx(fmaf(sc[j][2 * hf], scale2, hb));
          const float p1 = exp2_approx(fmaf(sc[j][2 * hf + 1], scale2, hb));
          const float d0 = p0 * (dp[j][2 * hf] - dsum[hf]);
          const float d1 = p1 * (dp[j][2 * hf + 1] - dsum[hf]);
          sc[j][2 * hf] = d0;
          sc[j][2 * hf + 1] = d1;
          rsum[hf] += d0 + d1;
          float2* w = reinterpret_cast<float2*>(gbw + bw_row(r, Wp) + 2 * tq + xj[j]);
          float2 cur = *w;
          cur.x += d0;
          cur.y += d1;
          *w = cur;
        }
      }

      // dQ += dS K, dS rounded to bf16: n-tiles (2kk, 2kk + 1) are the A
      // fragment of keys 16kk..16kk+15; K rows are B operands through
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        const uint32_t da[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, kt + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDS +
                                    16 * np + ((lane >> 4) << 3));
          mma_16816(dq[2 * np], da, bf[0], bf[1]);
          mma_16816(dq[2 * np + 1], da, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // tile t consumed before the next iteration refills its buffer
  }
  if (active) flush();
  __syncthreads();   // every row's dbh and dbw complete

  // dq = scale dS K (fp32; the caller adds the bias terms)
  if (active) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = q0 + wrow0 + g + 8 * hf;
      if (s >= S) continue;
      const long long o = ((b * S + s) * a.nh + h) * hd;
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        if (8 * n >= hd) continue;
        *reinterpret_cast<float2*>(a.dq + o + 8 * n + 2 * tq) =
            make_float2(dq[n][2 * hf] * a.scale, dq[n][2 * hf + 1] * a.scale);
      }
    }
  }
  // dbh, dbw of the block's rows, a warp per row, through their strides
  for (int r = warp; r < BQ; r += NT / 32) {
    const int s = q0 + r;
    if (s >= S) break;
    const int y = s / W, x = s - (s / W) * W;
    float* hdst = a.dbh + b * a.hs[0] + h * a.hs[1] + y * a.hs[2] + x * a.hs[3];
    float* wdst = a.dbw + b * a.ws[0] + h * a.ws[1] + y * a.ws[2] + x * a.ws[3];
    for (int i = lane; i < H; i += 32) hdst[i] = gbh[r * a.HS + i];
    for (int j = lane; j < W; j += 32) wdst[j] = gbw[bw_row(r, Wp) + j];
  }
}

template <int KS>
int launch(const Args& a, const Layout& L, int B, cudaStream_t stream) {
  const int S = a.H * a.W;
  const size_t s1 = dkv_smem(KS), s2 = dq_smem(KS, L);
  cudaError_t err = cudaFuncSetAttribute(bwd_dkv_mma_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_mma_kernel<KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((a.H + PR - 1) / PR * (a.Wp / PC), a.nh, B);
  bwd_dkv_mma_kernel<KS><<<g1, NT, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((S + BQ - 1) / BQ, a.nh, B);
  bwd_dq_mma_kernel<KS><<<g2, NT, s2, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, H*W, nh, hd) with element strides (sb, ss, sh, 1),
// shared by the three; dout: bf16 (B, H*W, nh, hd) with strides (dsb, dss,
// dsh, 1); all with 16-byte aligned rows (hd a multiple of 8, <= 128).
// lse (natural log), dsum: fp32 (B, nh, H*W). bh (B, nh, H, W, H) and bw
// (B, nh, H, W, W) fp32 with element strides (hs[0..3], 1) and
// (ws[0..3], 1). Outputs: dq fp32 and dk, dv bf16, (B, H*W, nh, hd)
// contiguous (dq without the bias terms); dbh and dbw fp32 with bh's and
// bw's strides.
extern "C" int rel_pos_flash_attn_bwd_mma(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* dsum, const float* bh, const float* bw, float* dq, void* dk, void* dv,
    float* dbh, float* dbw, int B, int H, int W, int nh, int hd, long long sb, long long ss,
    long long sh, long long dsb, long long dss, long long dsh, const long long* hs,
    const long long* ws, float scale, void* stream) {
  const Layout L = layout(H, W, BK);
  if (hd < 8 || hd > 128 || hd % 8 != 0 || (long long)L.ntiles * BK >= (1LL << 22))
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
               (const __nv_bfloat16*)dout, lse, dsum, bh, bw, dq, (__nv_bfloat16*)dk,
               (__nv_bfloat16*)dv, dbh, dbw, H, W, nh, hd, L.Wp, L.HS, sb, ss, sh, dsb, dss, dsh,
               {hs[0], hs[1], hs[2], hs[3]}, {ws[0], ws[1], ws[2], ws[3]}, scale};
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

// the larger of the two kernels' shared memory at these sizes (the wrapper
// checks it against the card's limit before launching)
extern "C" long long rel_pos_flash_attn_bwd_mma_smem_bytes(int H, int W, int hd) {
  const int ks = (hd + 15) / 16;
  const size_t a = dkv_smem(ks), b = dq_smem(ks, layout(H, W, BK));
  return (long long)(a > b ? a : b);
}
