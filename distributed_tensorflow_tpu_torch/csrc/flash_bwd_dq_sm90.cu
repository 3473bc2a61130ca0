// Flash attention backward, dq half of the two-pass pair, as a Hopper
// warpgroup kernel (K5): every tile product is a wgmma.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_dq_kernel
// (:1114, K5), launched by _flash_backward when no q segmentation of the
// fused backward exists, wherever the call is bf16 at head_dim 64, 128 or
// 256; f32 and head_dim 32 stay on flash_bwd_dq.cu, whose contract this
// file keeps: strided operands with a contiguous last dimension, GQA
// by head group, q_pos_offset and Sq != Skv with end-aligned causal
// masking, causal, window and non-causal masking, rope tables read at each
// row's position, delta as the dk/dv half (K6, flash_bwd_sm90.cu with dq
// compiled out) writes it, and exact zeros for rows that attend nothing.
// p is recomputed from the saved logsumexp (zeroed where the row attended
// nothing), dS = p∘(dO·vᵀ − delta) rounded to bf16, and dq = s·Σ dS·k over
// the kv tiles the row can see, rotated back by the inverse rope at the
// row's position when the wrapper passes tables.
//
// Bound on this card: three tile products (q·kᵀ, dO·vᵀ, dS·k), 1.5x the
// forward's FLOPs — ~1.24e12 at the long-context call (B 3, S 8192, 16 heads
// of 128, causal) against ~0.3 GB moved, so the tensor cores bound it
// (about 1.25 ms at 989 TFLOP/s). Only wgmma reaches that rate;
// flash_bwd_dq.cu's per-warp mma.sync reads every fragment from shared
// memory in each warp and sends each warp's dS through shared memory.
//
// Design: K5 has the forward's shape — a q tile stays put and the kv tiles
// stream past — so it is built on flash_fwd_sm90.cu's skeleton: one
// warpgroup (128 threads) per (64-row q tile, q head, batch), two blocks an
// SM, the q tiles with the most keys first, kv tiles wholly outside the
// causal/window band never visited. q (rotated by rope at its positions and
// scale-folded in place, as the plain version rounds it) and dO stay in
// shared memory in the 128-byte swizzle; K and V tiles of 64 keys are
// double-buffered by cp.async, one block barrier a step. Per kv tile:
//   S = (q·s)·Kᵀ, dP = dO·Vᵀ   wgmma m64n64k16, both K-major in shared
//                             memory, two commit groups
//   P = exp(S − lse)          exp2 on the special-function unit of
//                             log2e-scaled logits while dP multiplies; rows
//                             that attend nothing (or lie past Sq) take a
//                             −inf bias, so P is 0 there; the mask is
//                             skipped on tiles wholly inside the band
//   dS = P∘(dP − delta)       in registers, rounded to bf16 and packed: the
//                             A fragments of the next product, so dS never
//                             goes through shared memory
//   dQ += dS·K                A from registers, K read MN-major (the
//                             descriptor V takes in the forward's P·V)
// dq stays in f32 registers (D/64 accumulators of 64 x 64) and is written
// once, scaled and rotated back, with no atomics. Under rope k is rotated
// once per call by flash_fwd_rotate_k (sm90_common.cuh) into a (B, KV, Skv,
// D) scratch the caller allocates, bit for bit the plain rotation, so no
// block rotates a K tile. Every group retires inside its step (one left in
// flight across the loop's back edge makes ptxas serialise every wgmma,
// C7514). TMA, warp specialisation and overlapping dQ_n with the next
// tile's products are the next levers.
//
// Design at head_dim 256 (flash_bwd_dq_sm90_cols_kernel). A warpgroup's dq
// alone would be 64 x 256 f32, 128 registers a thread, beside S and dP (32
// each) and the packed dS. So a block of two warpgroups owns one 64-row q
// tile and splits the work the way flash_bwd_sm90_cols_kernel (K2 at 256)
// does: warpgroup 0 multiplies S = (q·s)·Kᵀ and takes P = exp(S − lse),
// warpgroup 1 multiplies dP = dO·Vᵀ and hands it over in f32 through shared
// memory; after a named barrier warpgroup 0 forms dS = P∘(dP − delta),
// rounded to bf16, into shared memory; after a second, each warpgroup adds
// its columns [64·wg, +64) ∪ [128 + 64·wg, +64) of dQ += dS·K (dS K-major,
// K MN-major, both from shared memory), 64 registers a thread, so that the
// split-half rope's pairs (i, i + 128) stay in one warpgroup for the
// rotate-back. S and dP are computed once a tile (the plain-design
// flash_bwd_dq.cu gives a tile to two blocks, each multiplying all 256
// columns of both: 5/3 of the minimum work, on mma.sync). q, dO, two K and
// two V tiles, dS and the f32 dP take 222,208 bytes of shared memory, so
// one block an SM; its kv tiles stream as above, one block barrier a step.
#include "sm90_common.cuh"

namespace dtt {

constexpr int DQ90_BQ = 64, DQ90_BKV = 64, DQ90_THREADS = 128;

template <int D>
constexpr size_t dq90_smem_bytes() {
  // The q and dO tiles, two K and two V tiles, and room to align the base to
  // 1024 bytes.
  return sizeof(bf16) * (2 * DQ90_BQ + 4 * DQ90_BKV) * D + 1024;
}

template <int D>
__global__ void __launch_bounds__(DQ90_THREADS, 2)
flash_bwd_dq_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ cos, const float* __restrict__ sin,
                         bf16* __restrict__ dq, Bhsd sq, Bhsd sk, Bhsd sv, Bhsd sg, Bhsd sdq,
                         int H, int group, int Sq, int Skv, int off, int causal, int window,
                         long long tstride, float scale) {
  constexpr int BQ = DQ90_BQ, BKV = DQ90_BKV, DB = D / 64;  // DB: 64-column blocks
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_at(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* sdO = sQ + BQ * D;
  bf16* sK = sdO + BQ * D;      // two tiles
  bf16* sV = sK + 2 * BKV * D;  // two tiles

  const int num_q = (Sq + BQ - 1) / BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * BQ;  // the tiles with the most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  // Rope tables are indexed by position: q row r sits at r + off.
  const float* cb = cos == nullptr ? nullptr : cos + b * tstride;
  const float* sb = sin == nullptr ? nullptr : sin + b * tstride;
  const int wi = threadIdx.x >> 5;  // the warp: rows [16wi, +16) of the tile
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + 16 * wi;  // the warp's first q row
  const int row[2] = {r_lo + g, r_lo + g + 8};
  // This lane's rows: −lse·log2e (−inf where the row attends nothing or
  // lies past Sq, so that P is 0 there) and delta.
  float nlb[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = ((size_t)b * H + h) * Sq + row[i];
    const float l = row[i] < Sq ? lse[r] : NEG_INF;
    nlb[i] = l > NEG_INF / 2 ? -l * kLog2e : -INFINITY;
    rd[i] = row[i] < Sq ? delta[r] : 0.f;
  }

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + BQ, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / BKV * BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  float dqa[DB][32];
#pragma unroll
  for (int blk = 0; blk < DB; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[blk][i] = 0.f;

  if (n_tiles > 0) {
    auto k_tile = [&](int n) { return sK + (n & 1) * BKV * D; };
    auto v_tile = [&](int n) { return sV + (n & 1) * BKV * D; };
    auto key0 = [&](int n) { return kv_begin + n * BKV; };
    // sw_issue for the K and V tiles with the address arithmetic hoisted out
    // of the kv loop, as in flash_fwd_sm90.cu: this thread copies the
    // 16-byte chunks at rows kr0 + RPR·it, columns kc and kc + D/2.
    constexpr int CPH = D / 16, RPR = DQ90_THREADS / CPH, ROUNDS = BKV / RPR;
    const int kr0 = (int)threadIdx.x / CPH, kc = ((int)threadIdx.x % CPH) * 8;
    const int so1 = sw<BKV>(kr0, kc), so2 = sw<BKV>(kr0, kc + D / 2);
    auto load_tile = [&](bf16* dst, const bf16* src, long long ld, int row0) {
      const bf16* p = src + (long long)(row0 + kr0) * ld + kc;
      const int left = Skv - row0 - kr0;
#pragma unroll
      for (int it = 0; it < ROUNDS; ++it) {
        bf16* d = dst + it * RPR * 64;
        if (it * RPR < left) {
          cp_async16(d + so1, p);
          cp_async16(d + so2, p + D / 2);
        } else {
          *reinterpret_cast<uint4*>(d + so1) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(d + so2) = make_uint4(0, 0, 0, 0);
        }
        p += RPR * ld;
      }
    };
    auto load_kv = [&](int n) {
      load_tile(k_tile(n), kb, sk.s, key0(n));
      load_tile(v_tile(n), vb, sv.s, key0(n));
    };

    sw_issue<D, BQ, DQ90_THREADS>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
    sw_issue<D, BQ, DQ90_THREADS>(sdO, dout + b * sg.b + h * sg.h, sg.s, q0, Sq);
    load_kv(0);
    cp_async_commit();
    const uint32_t aQ = smem_at(sQ), adO = smem_at(sdO);

    for (int n = 0; n < n_tiles; ++n) {
      const int k0 = key0(n);
      // Tile n has landed (with q and dO at n == 0); each thread rotates and
      // scale-folds the q chunks it copied itself.
      cp_async_wait<0>();
      if (n == 0) sw_finish<D, BQ, DQ90_THREADS>(sQ, q0, Sq, cb, sb, true, scale, off);
      proxy_fence();
      __syncthreads();  // tile n is in place everywhere; step n - 1 is done
      if (n + 1 < n_tiles) {
        load_kv(n + 1);  // into the buffers step n - 1 read
        cp_async_commit();
      }
      const uint32_t aK = smem_at(k_tile(n)), aV = smem_at(v_tile(n));

      // S and dP in two commit groups: P is computed while dP multiplies.
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(s, desc_k(aQ + 2 * sw<BQ>(0, 16 * kk)),
                     desc_k(aK + 2 * sw<BKV>(0, 16 * kk)), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(dp, desc_k(adO + 2 * sw<BQ>(0, 16 * kk)),
                     desc_k(aV + 2 * sw<BKV>(0, 16 * kk)), kk > 0);
      wg_commit();
      wg_wait<1>();
      reg_fence(s);

      // P = exp(S − lse) in place of S. Tiles wholly inside the
      // causal/window band for this warp's 16 rows skip the mask.
      const int p_lo = r_lo + off;  // the warp's first row's position
      const bool full = k0 + BKV <= Skv &&
                        (!causal || (k0 + BKV - 1 <= p_lo &&
                                     (window <= 0 || k0 > p_lo + 15 - window)));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * j + e], kLog2e, nlb[e >> 1]));
          s[4 * j + e] = full || attends_at(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), Sq, Skv,
                                            off, causal, window)
                             ? p
                             : 0.f;
        }
      wg_wait<0>();
      reg_fence(dp);
      // dS = P∘(dP − delta), rounded to bf16 (the TPU kernel's ds), packed
      // as the A fragments of dQ += dS·K: k-step kk takes keys [16kk, +16)
      // from fragments 4kk..4kk+3.
      uint32_t dsf[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float d = rd[j & 1];  // fragment j holds row g + 8(j % 2)
        dsf[j] = pack_bf16(s[2 * j] * (dp[2 * j] - d), s[2 * j + 1] * (dp[2 * j + 1] - d));
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int blk = 0; blk < DB; ++blk)
          mma_rs(dqa[blk], dsf + 4 * kk, desc_mn(aK + 2 * sw<BKV>(16 * kk, 64 * blk)));
      wg_commit();
      wg_wait<0>();
      reg_fence(dsf);
#pragma unroll
      for (int blk = 0; blk < DB; ++blk) reg_fence(dqa[blk]);
    }
  }

#pragma unroll
  for (int blk = 0; blk < DB; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[blk][i] *= scale;
  // dq rotates back by the inverse rope at its rows' positions; column i
  // sits in fragment i/8 (block i/64) and column i + D/2 in fragment i/8 +
  // D/16.
  auto frag = [&](int jg, int e) -> float& { return dqa[jg >> 3][4 * (jg & 7) + e]; };
  if (cb != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e >> 1];
      if (r >= Sq) continue;
      const size_t at = (size_t)(r + off) * (D / 2);
#pragma unroll
      for (int jg = 0; jg < D / 16; ++jg) {
        const int i = 8 * jg + 2 * t + (e & 1);
        const float c = cb[at + i], sn = sb[at + i];
        const float x1 = frag(jg, e), x2 = frag(jg + D / 16, e);
        frag(jg, e) = x1 * c + x2 * sn;
        frag(jg + D / 16, e) = x2 * c - x1 * sn;
      }
    }
  }
  // Rows that see no key (n_tiles == 0) get zeros.
  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
#pragma unroll
    for (int blk = 0; blk < DB; ++blk)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair<bf16>(dqb + row[i] * sdq.s + 64 * blk + 8 * j + 2 * t,
                         dqa[blk][4 * j + 2 * i], dqa[blk][4 * j + 2 * i + 1]);
  }
}

constexpr int DQ90C_D = 256;

constexpr size_t dq90_cols_smem_bytes() {
  // q, dO, two K and two V tiles, dS (bf16) and dP (f32), and room to align
  // the base to 1024 bytes.
  return sizeof(bf16) * ((2 * DQ90_BQ + 4 * DQ90_BKV) * DQ90C_D + DQ90_BQ * DQ90_BKV) +
         sizeof(float) * DQ90_BQ * DQ90_BKV + 1024;
}
static_assert(dq90_cols_smem_bytes() <= 232448, "a block's shared memory");

// Head_dim 256: a 64-row q tile a block, S in warpgroup 0, dP in warpgroup
// 1, dq split by columns over the two (see the top of the file).
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_bwd_dq_sm90_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const float* __restrict__ cos, const float* __restrict__ sin,
                              bf16* __restrict__ dq, Bhsd sq, Bhsd sk, Bhsd sv, Bhsd sg,
                              Bhsd sdq, int H, int group, int Sq, int Skv, int off, int causal,
                              int window, long long tstride, float scale) {
  constexpr int D = DQ90C_D, BQ = DQ90_BQ, BKV = DQ90_BKV, HALF = D / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_at(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* sdO = sQ + BQ * D;
  bf16* sK = sdO + BQ * D;      // two tiles
  bf16* sV = sK + 2 * BKV * D;  // two tiles
  bf16* sdS = sV + 2 * BKV * D;  // dS: q rows x kv columns
  float2* sdP = reinterpret_cast<float2*>(sdS + BQ * BKV);  // dP in fragment order

  const int num_q = (Sq + BQ - 1) / BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * BQ;  // the tiles with the most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  // Rope tables are indexed by position: q row r sits at r + off.
  const float* cb = cos == nullptr ? nullptr : cos + b * tstride;
  const float* sb = sin == nullptr ? nullptr : sin + b * tstride;
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int wi = wt >> 5;  // the warp: rows [16wi, +16) of the tile, in either warpgroup
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + 16 * wi;  // the warp's first q row
  const int row[2] = {r_lo + g, r_lo + g + 8};
  // The warpgroup's column blocks of dq: [64wg, +64) and [128 + 64wg, +64).
  const int col0[2] = {64 * wg, HALF + 64 * wg};
  // This lane's rows: −lse·log2e (−inf where the row attends nothing or
  // lies past Sq, so that P is 0 there) and delta.
  float nlb[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = ((size_t)b * H + h) * Sq + row[i];
    const float l = row[i] < Sq ? lse[r] : NEG_INF;
    nlb[i] = l > NEG_INF / 2 ? -l * kLog2e : -INFINITY;
    rd[i] = row[i] < Sq ? delta[r] : 0.f;
  }

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + BQ, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / BKV * BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  float dqa[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[c][i] = 0.f;

  if (n_tiles > 0) {
    auto k_tile = [&](int n) { return sK + (n & 1) * BKV * D; };
    auto v_tile = [&](int n) { return sV + (n & 1) * BKV * D; };
    auto key0 = [&](int n) { return kv_begin + n * BKV; };
    // The K and V loads with the address arithmetic hoisted out of the kv
    // loop, as in the kernel above, over the block's 256 threads.
    constexpr int CPH = D / 16, RPR = SM90_THREADS / CPH, ROUNDS = BKV / RPR;
    const int kr0 = (int)threadIdx.x / CPH, kc = ((int)threadIdx.x % CPH) * 8;
    const int so1 = sw<BKV>(kr0, kc), so2 = sw<BKV>(kr0, kc + HALF);
    auto load_tile = [&](bf16* dst, const bf16* src, long long ld, int row0) {
      const bf16* p = src + (long long)(row0 + kr0) * ld + kc;
      const int left = Skv - row0 - kr0;
#pragma unroll
      for (int it = 0; it < ROUNDS; ++it) {
        bf16* d = dst + it * RPR * 64;
        if (it * RPR < left) {
          cp_async16(d + so1, p);
          cp_async16(d + so2, p + HALF);
        } else {
          *reinterpret_cast<uint4*>(d + so1) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(d + so2) = make_uint4(0, 0, 0, 0);
        }
        p += RPR * ld;
      }
    };
    auto load_kv = [&](int n) {
      load_tile(k_tile(n), kb, sk.s, key0(n));
      load_tile(v_tile(n), vb, sv.s, key0(n));
    };

    sw_issue<D, BQ>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
    sw_issue<D, BQ>(sdO, dout + b * sg.b + h * sg.h, sg.s, q0, Sq);
    load_kv(0);
    cp_async_commit();
    const uint32_t aQ = smem_at(sQ), adO = smem_at(sdO), adS = smem_at(sdS);

    for (int n = 0; n < n_tiles; ++n) {
      const int k0 = key0(n);
      cp_async_wait<0>();
      if (n == 0) sw_finish<D, BQ>(sQ, q0, Sq, cb, sb, true, scale, off);
      proxy_fence();
      __syncthreads();  // tile n is in place everywhere; step n - 1 is done
      if (n + 1 < n_tiles) {
        load_kv(n + 1);  // into the buffers step n - 1 read
        cp_async_commit();
      }
      const uint32_t aK = smem_at(k_tile(n));

      // Warpgroup 0: S = (q·s)·Kᵀ; warpgroup 1: dP = dO·Vᵀ.
      const uint32_t aA = wg == 0 ? aQ : adO, aB = wg == 0 ? aK : smem_at(v_tile(n));
      float sc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(sc, desc_k(aA + 2 * sw<BQ>(0, 16 * kk)), desc_k(aB + 2 * sw<BKV>(0, 16 * kk)),
                     kk > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(sc);

      // Fragment j of this thread holds kv columns c, c + 1 (c = 8j + 2t) of
      // q rows 16wi + g and + 8; the float2 of (j, i) goes to dP at
      // (2j + i)·128 + wt, where the same thread of the other warpgroup reads it.
      if (wg == 0) {
        // P = exp(S − lse) in place. Tiles wholly inside the causal/window
        // band for this warp's 16 rows skip the mask.
        const int p_lo = r_lo + off;  // the warp's first row's position
        const bool full = k0 + BKV <= Skv &&
                          (!causal || (k0 + BKV - 1 <= p_lo &&
                                       (window <= 0 || k0 > p_lo + 15 - window)));
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(sc[4 * j + e], kLog2e, nlb[e >> 1]));
            sc[4 * j + e] = full || attends_at(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), Sq,
                                               Skv, off, causal, window)
                                ? p
                                : 0.f;
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sdP[(2 * j + i) * 128 + wt] = make_float2(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
      }
      named_sync(1, SM90_THREADS);  // dP is in place

      // dS = P∘(dP − delta), rounded to bf16 (the TPU kernel's ds), into
      // shared memory: the K-major A of dQ += dS·K.
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i;
            const float2 dp = sdP[(2 * j + i) * 128 + wt];
            *reinterpret_cast<uint32_t*>(sdS + sw<BQ>(16 * wi + g + 8 * i, 8 * j + 2 * t)) =
                pack_bf16(sc[e] * (dp.x - rd[i]), sc[e + 1] * (dp.y - rd[i]));
          }
      }
      proxy_fence();
      named_sync(1, SM90_THREADS);  // dS is in place

      // dQ += dS·K over this warpgroup's columns: k-step kk takes keys
      // [16kk, +16), dS K-major, K MN-major.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          mma_ss<0, 1>(dqa[c], desc_k(adS + 2 * sw<BQ>(0, 16 * kk)),
                       desc_mn(aK + 2 * sw<BKV>(16 * kk, col0[c])), 1);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < 2; ++c) reg_fence(dqa[c]);
    }
  }

#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[c][i] *= scale;
  // dq rotates back by the inverse rope at its rows' positions: column i <
  // 128 of block 0 pairs with column i + 128, the same element of block 1.
  if (cb != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e >> 1];
      if (r >= Sq) continue;
      const size_t at = (size_t)(r + off) * HALF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = col0[0] + 8 * j + 2 * t + (e & 1);
        const float c = cb[at + i], sn = sb[at + i];
        const float x1 = dqa[0][4 * j + e], x2 = dqa[1][4 * j + e];
        dqa[0][4 * j + e] = x1 * c + x2 * sn;
        dqa[1][4 * j + e] = x2 * c - x1 * sn;
      }
    }
  }
  // Rows that see no key (n_tiles == 0) get zeros.
  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair<bf16>(dqb + row[i] * sdq.s + col0[c] + 8 * j + 2 * t,
                         dqa[c][4 * j + 2 * i], dqa[c][4 * j + 2 * i + 1]);
  }
}

template <int D>
int launch_dq90(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, const void* cos, const void* sin, void* dq, void* k_rot,
                const long long* st, int B, int H, int KV, int Sq, int Skv, int off, int causal,
                int window, long long tstride, float scale, cudaStream_t stream) {
  auto at = [&](int i) { return Bhsd{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  Bhsd sk = at(1);
  cudaError_t err;
  if (cos != nullptr) {  // k rotated once, into the caller's contiguous scratch
    const long long n = (long long)B * KV * Skv * (D / 16);
    flash_fwd_rotate_k<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(cos),
        static_cast<const float*>(sin), static_cast<bf16*>(k_rot), sk, KV, Skv, tstride, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k = k_rot;
    sk = Bhsd{(long long)KV * Skv * D, (long long)Skv * D, D};
  }
  const dim3 grid((Sq + DQ90_BQ - 1) / DQ90_BQ, H, B);
  auto main_kernel = [&](auto kernel, int threads, size_t smem) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const float*>(cos),
        static_cast<const float*>(sin), static_cast<bf16*>(dq), at(0), sk, at(2), at(3), at(4),
        H, H / KV, Sq, Skv, off, causal, window, tstride, scale);
    return (int)cudaGetLastError();
  };
  // At 256 the column-split design, two warpgroups a block.
  if constexpr (D == DQ90C_D) {
    return main_kernel(flash_bwd_dq_sm90_cols_kernel, SM90_THREADS, dq90_cols_smem_bytes());
  } else {
    return main_kernel(flash_bwd_dq_sm90_kernel<D>, DQ90_THREADS, dq90_smem_bytes<D>());
  }
}

}  // namespace dtt

// dtt_flash_bwd_dq's contract (flash_bwd_dq.cu) for bf16 operands at
// head_dim 64, 128 or 256, plus `k_rot`: with rope tables, a contiguous (B, KV,
// Skv, D) bf16 scratch that receives k rotated once (flash_fwd_rotate_k) and
// is what the main kernel reads; unused (may be null) without them. Any
// other call returns cudaErrorInvalidValue. Returns a cudaError_t.
extern "C" int dtt_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* cos, const void* sin, void* dq,
                                     const long long* strides, int B, int H, int KV, int Sq,
                                     int Skv, int D, int is_bf16, int causal, int window,
                                     int q_pos_offset, long long tstride, float scale,
                                     void* k_rot, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV || !is_bf16)
    return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (q_pos_offset < 0 || q_pos_offset + Sq > Skv || k_rot == nullptr))
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_dq90<64>(q, k, v, dout, lse, delta, cos, sin, dq, k_rot, strides, B, H, KV,
                           Sq, Skv, q_pos_offset, causal, window, tstride, scale, st);
  if (D == 128)
    return launch_dq90<128>(q, k, v, dout, lse, delta, cos, sin, dq, k_rot, strides, B, H, KV,
                            Sq, Skv, q_pos_offset, causal, window, tstride, scale, st);
  if (D == 256)
    return launch_dq90<256>(q, k, v, dout, lse, delta, cos, sin, dq, k_rot, strides, B, H, KV,
                            Sq, Skv, q_pos_offset, causal, window, tstride, scale, st);
  return (int)cudaErrorInvalidValue;
}
