// Flash attention forward for head dims 384 and 512 on strided (B, H, S, D)
// operands as a Hopper warpgroup kernel: both tile products are wgmma, and
// the scores are computed once a tile.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_kernel wherever
// the call is bf16 at head_dim 384 or 512 (the wrapper pads 257-383 to 384
// and 385-511 to 512) — through _flash_forward_qkv (:1660, K1, packed qkv
// with GQA and rope), _flash_forward (:481, K3, BHSD, cross-length),
// _flash_forward_bshd (:1261, K7, BSHD views) and the BSHD probe's forward
// (tools/bshd_probe.py:49, K10). f32 at any head dim above 256, and bf16
// above 512, stay on the column-group kernel flash_fwd_dstream.cu, whose C
// contract this file keeps: strided operands with a contiguous last
// dimension, GQA by head group, q_pos_offset and Sq != Skv with end-aligned
// causal masking, causal, window and non-causal masking, rope tables read at
// each row's position, the two scratches of the prepare pass, and, for a
// row that attends nothing, out exactly 0 and lse NEG_INF + log(1e-30).
//
// Bound on this card: at the head_dim 512 call (B 2, S 2048, 4 heads of 512,
// causal) ~3.4e10 FLOPs against ~0.04 GB moved, so the tensor cores bound it
// (about 0.035 ms at 989 TFLOP/s). flash_fwd_dstream.cu gives each 128-column
// group of out its own block, and each block recomputes the whole score
// tile: 2.5x the minimum work at D 512, on per-warp mma.sync with a block
// barrier for every 64-column chunk of D.
//
// Design. One block of two warpgroups (256 threads) per (64-row q tile,
// head, batch), the q tiles with the most keys first, kv tiles wholly
// outside the causal/window band never visited. Both warpgroups own the
// same 64 q rows; warpgroup w owns the columns [w·D/2, +D/2) of D. Per
// 32-key kv tile n:
//   S_w = q[:, half w]·K_n[:, half w]ᵀ   wgmma m64n32k16, A and B K-major in
//                                      shared memory: each warpgroup sums
//                                      its half of the contraction
//   S = S_0 + S_1                       the partials meet in shared memory
//                                      (f32, in fragment order) under a
//                                      named barrier of the 256 threads;
//                                      f32 addition is commutative, so both
//                                      warpgroups hold S bit for bit alike
//                                      and run the same online softmax
//   O_w = O_w·corr + P·V_n[:, half w]   A from registers (P's bf16
//                                      conversion), V MN-major; O_w is D/128
//                                      accumulators of 64 x 64, 128 f32
//                                      registers a thread at D 512
// So the block does the minimum work: q·kᵀ once, P·V once. The order is
// flash_fwd_sm90.cu's: step n issues S_n and then P·V_{n-1} as two commit
// groups, exchanges and softmaxes S_n while P·V_{n-1} multiplies, and both
// retire inside the step. Shared memory at D 512: q (64 KB), K and V
// double-buffered at 32 keys (128 KB), the two partials (16 KB) — 64-key
// tiles would leave K and V single-buffered. q arrives rotated and
// scale-folded, and k rotated, from the column-group family's prepare pass
// (flash_dstream.cuh), so the kernel carries no rope tables; the pass
// rounds as the plain version does. Simple first: no TMA, no warp
// specialisation.
#include "flash_dstream.cuh"
#include "sm90_common.cuh"

namespace dtt {

constexpr int FC90_BQ = 64, FC90_BKV = 32;  // rows of the q tile, keys of a kv tile

template <int D>
constexpr size_t fc90_smem_bytes() {
  // The q tile, two K and two V tiles, the two warpgroups' f32 partial
  // scores, and room to align the base to 1024 bytes.
  return sizeof(bf16) * (FC90_BQ + 4 * FC90_BKV) * D + sizeof(float) * 2 * FC90_BQ * FC90_BKV +
         1024;
}
static_assert(fc90_smem_bytes<512>() <= 232448, "a block's shared memory");

template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_fwd_cols_sm90_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, Bhsd sk, Bhsd sv, Bhsd so, int H, int group,
                           int Sq, int Skv, int off, int causal, int window) {
  // HALF: a warpgroup's columns; HB: its 64-column blocks of O; NS: score
  // registers a thread, NP: packed P registers.
  constexpr int BQ = FC90_BQ, BKV = FC90_BKV, HALF = D / 2, HB = HALF / 64;
  constexpr int NS = BKV / 2, NP = BKV / 4;
  static_assert(D == 384 || D == 512, "head_dim 384 or 512");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_at(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* sK = sQ + BQ * D;       // two tiles
  bf16* sV = sK + 2 * BKV * D;  // two tiles
  float2* sX = reinterpret_cast<float2*>(sV + 2 * BKV * D);  // the two partials

  const int num_q = (Sq + BQ - 1) / BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * BQ;  // the tiles with the most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const bf16* qb = qs + ((size_t)b * H + h) * Sq * D;  // contiguous, from the prepare pass
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  bf16* ob = out + b * so.b + h * so.h;
  float* lb = lse + ((size_t)b * H + h) * Sq;
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int wi = wt >> 5;  // the warp: rows [16wi, +16) of the tile, in either warpgroup
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + 16 * wi;  // the warp's first q row
  const int row[2] = {r_lo + g, r_lo + g + 8};
  const int c_lo = wg * HALF;  // the warpgroup's first column

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + BQ, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / BKV * BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
  if (n_tiles == 0) {  // every row of the tile attends nothing (Sq > Skv, causal)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= Sq) continue;
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
        store_pair<bf16>(ob + row[i] * so.s + c_lo + 8 * j + 2 * t, 0.f, 0.f);
      if (t == 0 && wg == 0) lb[row[i]] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  auto k_tile = [&](int n) { return sK + (n & 1) * BKV * D; };
  auto v_tile = [&](int n) { return sV + (n & 1) * BKV * D; };
  auto key0 = [&](int n) { return kv_begin + n * BKV; };
  auto load_k = [&](int n) { sw_issue<D, BKV>(k_tile(n), kb, sk.s, key0(n), Skv); };
  auto load_v = [&](int n) { sw_issue<D, BKV>(v_tile(n), vb, sv.s, key0(n), Skv); };
  float s[NS], o[HB][32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pf[NP];
#pragma unroll
  for (int blk = 0; blk < HB; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[blk][i] = 0.f;

  // S_w = q[:, half w]·K_n[:, half w]ᵀ, one commit group.
  auto issue_s = [&](int n) {
    const uint32_t aQ = smem_at(sQ), aK = smem_at(k_tile(n));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk)
      mma_ss<0, 0>(s, desc_k(aQ + 2 * sw<BQ>(0, c_lo + 16 * kk)),
                   desc_k(aK + 2 * sw<BKV>(0, c_lo + 16 * kk)), kk > 0);
    wg_commit();
  };
  // O_w += P·V_n[:, half w], one commit group: k-step kk takes keys
  // [16kk, +16) from fragments 4kk..4kk+3 of P.
  auto issue_pv = [&](int n) {
    const uint32_t aV = smem_at(v_tile(n));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int blk = 0; blk < HB; ++blk)
        mma_rs(o[blk], pf + 4 * kk, desc_mn(aV + 2 * sw<BKV>(16 * kk, c_lo + 64 * blk)));
    wg_commit();
  };
  // S = S_0 + S_1: fragment (j, i) of this thread — keys 8j + 2t, + 1 of
  // row g + 8i — goes to its warpgroup's partial at (2j + i)·128 + wt, where
  // the same thread of the other warpgroup reads it after the barrier. The
  // buffers are rewritten only after the next block barrier.
  auto exchange = [&]() {
    float2* mine = sX + wg * (BQ * BKV / 2);
    const float2* other = sX + (1 - wg) * (BQ * BKV / 2);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mine[(2 * j + i) * 128 + wt] = make_float2(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
    named_sync(1, SM90_THREADS);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 x = other[(2 * j + i) * 128 + wt];
        s[4 * j + 2 * i] += x.x;
        s[4 * j + 2 * i + 1] += x.y;
      }
  };
  // flash_fwd_sm90.cu's online softmax of S_n in place: P = exp(S − m) as
  // exp2 of log2e-scaled logits, m and l updated, corr the factor O takes.
  // Tiles wholly inside the causal/window band skip the per-element mask.
  auto softmax = [&](int n) {
    const int k0 = key0(n), p_lo = r_lo + off;  // p_lo: the warp's first row's position
    const bool full = k0 + BKV <= Skv &&
                      (!causal || (k0 + BKV - 1 <= p_lo &&
                                   (window <= 0 || k0 > p_lo + 15 - window)));
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full &&
            !attends_at(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), Sq, Skv, off, causal, window))
          s[4 * j + e] = NEG_INF;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[4 * j + e]);
      }
    float mb[2], rsum[2] = {0.f, 0.f};  // mb: m in log2 units
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(tmax[i]));
      const bool dead = m_new <= NEG_INF / 2;  // every key so far masked
      const float m_safe = dead ? 0.f : m_new;
      corr[i] = ex2((m[i] - m_safe) * kLog2e);
      mb[i] = m_safe * kLog2e;
      m[i] = m_safe + (dead ? NEG_INF : 0.f);
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], kLog2e, -mb[e >> 1]));
        rsum[e >> 1] += s[4 * j + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rsum[i]);
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < NP; ++j) pf[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  };

  sw_issue<D, BQ>(sQ, qb, D, q0, Sq);
  load_k(0);
  cp_async_commit();
  cp_async_wait<0>();
  proxy_fence();
  __syncthreads();
  if (n_tiles > 1) load_k(1);
  load_v(0);
  cp_async_commit();
  issue_s(0);
  wg_wait<0>();
  reg_fence(s);
  exchange();
  softmax(0);  // O is still zero: nothing to rescale
  pack_p();

  // Step n: S_n and P·V_{n-1} multiply while nothing else does; the
  // exchange and softmax of S_n run while P·V_{n-1} still multiplies.
  for (int n = 1; n < n_tiles; ++n) {
    // K_n and V_{n-1} have landed everywhere; both warpgroups are done with
    // step n - 1, so K_{n-1}'s and V_{n-2}'s buffers take K_{n+1} and V_n,
    // and the partials' buffers are free.
    cp_async_wait<0>();
    proxy_fence();
    __syncthreads();
    if (n + 1 < n_tiles) load_k(n + 1);
    load_v(n);
    cp_async_commit();
    issue_s(n);
    issue_pv(n - 1);
    wg_wait<1>();
    reg_fence(s);
    exchange();
    softmax(n);
    wg_wait<0>();
    reg_fence(pf);
#pragma unroll
    for (int blk = 0; blk < HB; ++blk) {
      reg_fence(o[blk]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[blk][i] *= corr[(i >> 1) & 1];
    }
    pack_p();
  }
  cp_async_wait<0>();  // V of the last tile
  proxy_fence();
  __syncthreads();
  issue_pv(n_tiles - 1);
  wg_wait<0>();
  reg_fence(pf);
#pragma unroll
  for (int blk = 0; blk < HB; ++blk) reg_fence(o[blk]);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int blk = 0; blk < HB; ++blk)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair<bf16>(ob + row[i] * so.s + c_lo + 64 * blk + 8 * j + 2 * t,
                         o[blk][4 * j + 2 * i] / denom, o[blk][4 * j + 2 * i + 1] / denom);
    if (t == 0 && wg == 0) lb[row[i]] = m[i] + logf(denom);
  }
}

template <int D>
int launch_fwd_cols90(const void* q, const void* k, const void* v, void* out, void* lse,
                      const void* cos, const void* sin, const long long* st, int B, int H,
                      int KV, int Sq, int Skv, int off, int causal, int window,
                      long long tstride, float scale, void* q_s, void* k_rot,
                      cudaStream_t stream) {
  const Bhsd sq{st[0], st[1], st[2]}, sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  Bhsd sk{st[3], st[4], st[5]};
  cudaError_t err = dstream_prep<bf16>(q, sq, q_s, cos, sin, B, H, Sq, D, off, tstride, 1,
                                       scale, stream);
  if (err != cudaSuccess) return (int)err;
  if (cos != nullptr) {
    if ((err = dstream_prep<bf16>(k, sk, k_rot, cos, sin, B, KV, Skv, D, 0, tstride, 0, 1.f,
                                  stream)) != cudaSuccess)
      return (int)err;
    k = k_rot;
    sk = contiguous(KV, Skv, D);
  }
  const size_t smem = fc90_smem_bytes<D>();
  if ((err = set_smem(flash_fwd_cols_sm90_kernel<D>, smem)) != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FC90_BQ - 1) / FC90_BQ, H, B);
  flash_fwd_cols_sm90_kernel<D><<<grid, SM90_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q_s), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), sk, sv, so, H, H / KV, Sq, Skv, off,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtt_flash_fwd_dstream's contract (flash_fwd_dstream.cu) for bf16 operands
// at head_dim 384 or 512: q_s, a contiguous (B, H, Sq, D) bf16 scratch that
// receives q rotated (tables) and scale-folded, and k_rot, with tables, a
// contiguous (B, KV, Skv, D) one that receives k rotated (null without
// tables). Any other call returns cudaErrorInvalidValue. Returns a
// cudaError_t.
extern "C" int dtt_flash_fwd_cols_sm90(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const void* cos, const void* sin,
                                       const long long* strides, int B, int H, int KV, int Sq,
                                       int Skv, int D, int is_bf16, int causal, int window,
                                       int q_pos_offset, long long tstride, float scale,
                                       void* q_s, void* k_rot, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dstream_args_ok(B, H, KV, Sq, Skv, D, cos, k_rot, q_pos_offset) || q_s == nullptr ||
      !is_bf16)
    return (int)cudaErrorInvalidValue;
  if (D == 384)
    return launch_fwd_cols90<384>(q, k, v, out, lse, cos, sin, strides, B, H, KV, Sq, Skv,
                                  q_pos_offset, causal, window, tstride, scale, q_s, k_rot, st);
  if (D == 512)
    return launch_fwd_cols90<512>(q, k, v, out, lse, cos, sin, strides, B, H, KV, Sq, Skv,
                                  q_pos_offset, causal, window, tstride, scale, q_s, k_rot, st);
  return (int)cudaErrorInvalidValue;
}
