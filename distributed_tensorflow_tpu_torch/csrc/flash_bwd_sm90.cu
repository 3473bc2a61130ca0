// Flash attention backward on strided (B, H, S, D) operands as a Hopper
// warpgroup kernel: every tile product is a wgmma.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_fused_kernel
// wherever the call is bf16 at head_dim 64 or 128 — through
// _flash_backward_qkv (:1796, K2, packed qkv), _flash_backward_fused (:1004,
// K4, BHSD) and _flash_backward_fused_bshd (:1347, K8, BSHD views, one call
// per q segment) — and _flash_backward's _flash_bwd_dkv_kernel (:1140, K6),
// the two-pass pair's dk/dv half: the same kernel with the dQ product, its
// named-barrier hand-off and the f32 atomics compiled out (dq null), which
// leaves delta for the pair's dq kernel (K5, flash_bwd_dq.cu). f32 and
// head_dim 32 stay on flash_bwd.cu, whose contract this file shares: the
// same C arguments, strides, GQA head-group sums, q_pos_offset, causal/
// window/non-causal masking, Sq != Skv, rope tables read at each row's
// position, and exact zeros for rows that attend nothing.
//
// Bound on this card: five tile products, ~5.2e11 FLOPs at the flagship call
// (B 12, S 2048, 16 heads of 128, causal) against ~0.6 GB moved, so the
// tensor cores bound it: ~0.52 ms at 989 TFLOP/s. Only wgmma reaches that
// rate; flash_bwd.cu's per-warp mma.sync reads every operand fragment from
// shared memory again in each warp and ran at ~12% of it.
//
// Design. One block of two warpgroups (256 threads) owns a 128-row kv tile,
// 64 rows a warpgroup, and keeps that tile's dK and dV in f32 registers
// (wgmma accumulators) while it walks every q head of the GQA group and the
// 64-row q tiles the causal/window band lets see it; the grid is (Skv / 128,
// kv heads, batch), low tiles first. Per q tile, each warpgroup:
//   Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ      wgmma m64n64k16, A and B in shared memory,
//                               two commit groups
//   Pᵀ = exp(Sᵀ − lse)          in the Sᵀ accumulator while dPᵀ multiplies
//   dV += Pᵀ·dO                 A from registers: the bf16 conversion of the
//                               Pᵀ accumulator is the A fragment
//   dSᵀ = Pᵀ∘(dPᵀ − delta)      while dV multiplies, to shared memory
//   dK += dSᵀ·(q·s)             A (dSᵀ) and B from shared memory
//   dQ = s·dS·K                 at D 128 each warpgroup takes D/2 columns
//                               over all 128 kv rows (a named barrier of the
//                               256 threads hands the dSᵀ rows across); at D
//                               64 each takes its own 64 kv rows, all columns
// and dQ is added with float2 atomics into the zeroed f32 scratch the
// wrapper allocated — half of flash_bwd.cu's atomic traffic at D 128, as a
// 128-row kv tile reads each q tile once where two 64-row tiles read it
// twice. dK reads dSᵀ from shared memory rather than registers: with both
// products on register fragments the rope instance spilled. Tiles sit in
// shared memory in the 128-byte-swizzled layout the wgmma descriptors read
// (64-column blocks of 128-byte rows, chunk c of row r at chunk c ^ (r %
// 8)); q and dO (with lse/delta) are double-buffered by cp.async, one q
// tile ahead; rope and the q scale fold are applied in place on that
// layout, each thread on the chunks it loaded. The softmax takes exp2 on
// the special-function unit and skips the mask on tiles wholly inside the
// band. Two block barriers a step. The delta pre-pass and the dq
// rotate/cast pass are flash_bwd_passes.cuh's; the swizzle, the loaders,
// descriptors and products are sm90_common.cuh's. TMA, warp specialisation
// and a bulk-reduce dq are the next levers.
#include "flash_bwd_passes.cuh"
#include "sm90_common.cuh"

namespace dtt {

constexpr int SM90_BKV = 128, SM90_BQ = 64;

template <int D>
constexpr size_t sm90_smem_bytes() {
  // K, V, two buffers of [q | dO], dSᵀ, two buffers of [lse | delta], and
  // room to align the base to 1024 bytes.
  return sizeof(bf16) * (2 * SM90_BKV * D + 4 * SM90_BQ * D + SM90_BKV * SM90_BQ) +
         sizeof(float) * 4 * SM90_BQ + 1024;
}

// DQ false (K6): no dQ product, no atomics, and each warpgroup waits only
// for its own dSᵀ rows.
template <int D, bool ROPE, bool DQ>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_bwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ cos, const float* __restrict__ sin,
                      bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                      float* __restrict__ dq_acc, BwdStrides st, int H, int group, int Sq, int Skv,
                      int off, int causal, int window, long long tstride, float scale) {
  constexpr int BKV = SM90_BKV, BQ = SM90_BQ, DB = D / 64;  // DB: 64-column blocks
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* sV = sK + BKV * D;
  bf16* sQdO = sV + BKV * D;  // two buffers of [q tile | dO tile]
  bf16* sdS = sQdO + 4 * BQ * D;  // dSᵀ: kv rows x q columns
  float* sStats = reinterpret_cast<float*>(sdS + BKV * BQ);  // two buffers of [lse | delta]

  const int k0 = blockIdx.x * BKV;  // low tiles first: under causal masking they see most q
  const int kvh = blockIdx.y, b = blockIdx.z;
  const bf16* kb = k + b * st.k.b + kvh * st.k.h;
  const bf16* vb = v + b * st.v.b + kvh * st.v.h;
  // Rope tables are indexed by position: q row r sits at r + off, key row r at r.
  const float* cb = ROPE ? cos + b * tstride : nullptr;
  const float* sb = ROPE ? sin + b * tstride : nullptr;
  const int warp = threadIdx.x >> 5, wg = warp >> 2, wi = warp & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kv_lo = k0 + 64 * wg;  // this warpgroup's 64 kv rows
  const int kv_row[2] = {kv_lo + 16 * wi + g, kv_lo + 16 * wi + g + 8};

  // q rows whose positions (row + off) can see this kv tile.
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = min(Sq, max(0, k0 - off)) / BQ * BQ;
    if (window > 0) q_end = min(Sq, max(0, k0 + BKV - 1 + window - off));
  }
  // Steps walk (q head of the group, q tile).
  const int n_q = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_steps = group * n_q;
  auto head_row = [&](int h) { return ((size_t)b * H + h) * Sq; };

  float dk[DB][32], dv[DB][32];
#pragma unroll
  for (int blk = 0; blk < DB; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[blk][i] = dv[blk][i] = 0.f;

  if (n_steps > 0) {
    auto q_buf = [&](int n) { return sQdO + (n & 1) * 2 * BQ * D; };
    auto stats_buf = [&](int n) { return sStats + (n & 1) * 2 * BQ; };
    auto issue_q = [&](int n) {
      const int h = kvh * group + n / n_q, q0 = q_begin + (n % n_q) * BQ;
      sw_issue<D, BQ>(q_buf(n), q + b * st.q.b + h * st.q.h, st.q.s, q0, Sq);
      sw_issue<D, BQ>(q_buf(n) + BQ * D, dout + b * st.g.b + h * st.g.h, st.g.s, q0, Sq);
      float* sst = stats_buf(n);
      for (int i = threadIdx.x; i < 2 * BQ; i += SM90_THREADS) {
        const int qr = q0 + i % BQ;
        const float* from = (i < BQ ? lse : delta) + head_row(h) + qr;
        if (qr < Sq) cp_async4(sst + i, from);
        else sst[i] = 0.f;
      }
      cp_async_commit();
    };
    sw_issue<D, BKV>(sK, kb, st.k.s, k0, Skv);
    sw_issue<D, BKV>(sV, vb, st.v.s, k0, Skv);
    cp_async_commit();
    issue_q(0);

    // dQ: at D 128 warpgroup wg adds columns [64·wg, +64) over all 128 kv
    // rows; at D 64 all columns over its own 64 kv rows.
    constexpr int DQ_KSTEPS = D == 128 ? BKV / 16 : 64 / 16;
    [[maybe_unused]] const int dq_r0 = D == 128 ? 0 : 64 * wg, dq_c0 = D == 128 ? 64 * wg : 0;

    for (int n = 0; n < n_steps; ++n) {
      const int h = kvh * group + n / n_q, q0 = q_begin + (n % n_q) * BQ;
      bf16* sQ = q_buf(n);
      const bf16* sdO = sQ + BQ * D;
      const float* sLse = stats_buf(n);
      const float* sDelta = sLse + BQ;
      cp_async_wait<0>();
      if constexpr (ROPE) {
        if (n == 0) sw_finish<D, BKV>(sK, k0, Skv, cb, sb, false, 1.f, 0);
      }
      sw_finish<D, BQ>(sQ, q0, Sq, cb, sb, true, scale, off);
      proxy_fence();
      __syncthreads();  // step n's tiles are in place; step n - 1 is done everywhere
      if (n + 1 < n_steps) issue_q(n + 1);  // into the buffers step n - 1 read

      // Shared addresses of the tiles, the bases of this step's descriptors.
      const uint32_t aK = smem_at(sK), aV = smem_at(sV), aQ = smem_at(sQ), adO = smem_at(sdO),
                     adS = smem_at(sdS);

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warpgroup's 64 kv rows, in two
      // commit groups: Pᵀ is computed while dPᵀ multiplies.
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(s, desc_k(aK + 2 * sw<BKV>(64 * wg, 16 * kk)),
                     desc_k(aQ + 2 * sw<BQ>(0, 16 * kk)), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(dp, desc_k(aV + 2 * sw<BKV>(64 * wg, 16 * kk)),
                     desc_k(adO + 2 * sw<BQ>(0, 16 * kk)), kk > 0);
      wg_commit();
      wg_wait<1>();
      reg_fence(s);

      // Pᵀ = exp(Sᵀ − lse) in place of Sᵀ, as exp2 of log2e-scaled logits,
      // rounded to bf16 (the TPU kernel's p) into the A fragments of
      // dV += Pᵀ·dO; k-step kk of an RS product takes q columns [16kk, +16),
      // fragments 4kk..4kk+3, and dO is its MN-major B. Fragment j of this
      // thread holds q columns c, c + 1 (c = 8j + 2t) of kv rows g and g + 8.
      // Tiles wholly inside the causal/window band (every row there attends
      // something, so its lse is finite) skip the per-element mask.
      const int p0 = q0 + off;  // position of the tile's first q row
      const bool full = q0 + BQ <= Sq && kv_lo + 63 < Skv &&
                        (!causal || (kv_lo + 63 <= p0 &&
                                     (window <= 0 || kv_lo > p0 + BQ - 1 - window)));
      uint32_t pf[16];
      if (full) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(sLse + 8 * j + 2 * t);
          const float l0 = -l.x * kLog2e, l1 = -l.y * kLog2e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i;
            s[e] = ex2(fmaf(s[e], kLog2e, l0));
            s[e + 1] = ex2(fmaf(s[e + 1], kLog2e, l1));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int e = 4 * j + 2 * i + e2, c = 8 * j + 2 * t + e2;
              const bool live = attends_at(q0 + c, kv_row[i], Sq, Skv, off, causal, window) &&
                                sLse[c] > NEG_INF / 2;
              s[e] = live ? ex2(fmaf(s[e], kLog2e, -sLse[c] * kLog2e)) : 0.f;
            }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) pf[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int blk = 0; blk < DB; ++blk)
          mma_rs(dv[blk], pf + 4 * kk, desc_mn(adO + 2 * sw<BQ>(16 * kk, 64 * blk)));
      wg_commit();

      // dSᵀ = Pᵀ∘(dPᵀ − delta) while dV multiplies, rounded to bf16 (the TPU
      // kernel's ds), into shared memory: the K-major A of dK += dSᵀ·(q·s)
      // and, read MN-major, the A of dQ.
      wg_wait<1>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(sDelta + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i, kr = 64 * wg + 16 * wi + g + 8 * i;
          *reinterpret_cast<uint32_t*>(sdS + sw<BKV>(kr, 8 * j + 2 * t)) =
              pack_bf16(s[e] * (dp[e] - dl.x), s[e + 1] * (dp[e + 1] - dl.y));
        }
      }
      proxy_fence();
      // dK needs this warpgroup's dSᵀ rows; dQ at D 128 the other's too.
      if constexpr (DQ && D == 128) {
        named_sync(1, SM90_THREADS);
      } else {
        named_sync(2 + wg, 128);
      }

      // dK += dSᵀ·(q·s), then dQ = s·dS·K: dS (q x kv) is the MN-major read
      // of dSᵀ, K the MN-major B.
      [[maybe_unused]] float dq[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int blk = 0; blk < DB; ++blk)
          mma_ss<0, 1>(dk[blk], desc_k(adS + 2 * sw<BKV>(64 * wg, 16 * kk)),
                       desc_mn(aQ + 2 * sw<BQ>(16 * kk, 64 * blk)), 1);
      if constexpr (DQ) {
#pragma unroll
        for (int kk = 0; kk < DQ_KSTEPS; ++kk)
          mma_ss<1, 1>(dq, desc_mn(adS + 2 * sw<BKV>(dq_r0 + 16 * kk, 0)),
                       desc_mn(aK + 2 * sw<BKV>(dq_r0 + 16 * kk, dq_c0)), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      if constexpr (DQ) reg_fence(dq);
      reg_fence(pf);  // the dV product reads these until the wait
#pragma unroll
      for (int blk = 0; blk < DB; ++blk) {
        reg_fence(dk[blk]);
        reg_fence(dv[blk]);
      }
      if constexpr (DQ) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qr = q0 + 16 * wi + g + 8 * i;
          if (qr >= Sq) continue;
          float* dst = dq_acc + (head_row(h) + qr) * D + dq_c0 + 2 * t;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                      make_float2(scale * dq[4 * j + 2 * i], scale * dq[4 * j + 2 * i + 1]));
        }
      }
    }
  }

  // dk rotates back by the inverse rope at its kv rows; column i sits in
  // fragment i/8 (block i/64) and column i + D/2 in fragment i/8 + D/16.
  auto frag = [&](float (&a)[DB][32], int jg, int e) -> float& {
    return a[jg >> 3][4 * (jg & 7) + e];
  };
  if constexpr (ROPE) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = kv_row[e >> 1];
      if (r >= Skv) continue;
#pragma unroll
      for (int jg = 0; jg < D / 16; ++jg) {
        const int i = 8 * jg + 2 * t + (e & 1);
        const float c = cb[(size_t)r * (D / 2) + i], sn = sb[(size_t)r * (D / 2) + i];
        const float x1 = frag(dk, jg, e), x2 = frag(dk, jg + D / 16, e);
        frag(dk, jg, e) = x1 * c + x2 * sn;
        frag(dk, jg + D / 16, e) = x2 * c - x1 * sn;
      }
    }
  }
  // dk and dv of kv rows no query sees (n_steps == 0) are zeros.
  bf16* dkb = dk_out + b * st.dk.b + kvh * st.dk.h;
  bf16* dvb = dv_out + b * st.dv.b + kvh * st.dv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kv_row[i];
    if (r >= Skv) continue;
#pragma unroll
    for (int blk = 0; blk < DB; ++blk)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * blk + 8 * j + 2 * t;
        const int e = 4 * j + 2 * i;
        store_pair<bf16>(dkb + r * st.dk.s + col, dk[blk][e], dk[blk][e + 1]);
        store_pair<bf16>(dvb + r * st.dv.s + col, dv[blk][e], dv[blk][e + 1]);
      }
  }
}

template <int D, bool ROPE>
int launch_sm90(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* lse, const void* cos, const void* sin, void* dq, void* dk, void* dv,
                void* dq_acc, void* delta, const long long* s, int B, int H, int KV, int Sq,
                int Skv, int off, int causal, int window, long long tstride, float scale,
                cudaStream_t stream) {
  auto at = [&](int i) { return Bhsd{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; };
  const BwdStrides st{at(0), at(1), at(2), at(4), at(6), at(7)};
  const size_t smem = sm90_smem_bytes<D>();
  const dim3 grid((Skv + SM90_BKV - 1) / SM90_BKV, KV, B);
  auto main_kernel = [&](auto kernel) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, SM90_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const float*>(cos),
        static_cast<const float*>(sin), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        static_cast<float*>(dq_acc), st, H, H / KV, Sq, Skv, off, causal, window, tstride,
        scale);
    return cudaGetLastError();
  };
  auto launch_main = [&]() {
    return dq == nullptr ? main_kernel(flash_bwd_sm90_kernel<D, ROPE, false>)
                         : main_kernel(flash_bwd_sm90_kernel<D, ROPE, true>);
  };
  return run_bwd<bf16, ROPE>(launch_main, out, dout, cos, sin, dq, dq_acc, delta, s, B, H, Sq,
                             D, off, tstride, stream);
}

}  // namespace dtt

// dtt_flash_bwd's contract (flash_bwd.cu) for bf16 operands at head_dim 64
// or 128: with dq null only dk and dv are computed (K6) and delta is left
// for flash_bwd_dq.cu (K5). Any other call returns cudaErrorInvalidValue.
// Returns a cudaError_t.
extern "C" int dtt_flash_bwd_sm90(const void* q, const void* k, const void* v, const void* out,
                                  const void* dout, const void* lse, const void* cos,
                                  const void* sin, void* dq, void* dk, void* dv, void* dq_acc,
                                  void* delta, const long long* strides, int B, int H, int KV,
                                  int Sq, int Skv, int D, int is_bf16, int causal, int window,
                                  int q_pos_offset, long long tstride, float scale,
                                  void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (q_pos_offset < 0 || q_pos_offset + Sq > Skv))
    return (int)cudaErrorInvalidValue;
#define DTT_BWD_SM90(DIM)                                                                      \
  return cos != nullptr                                                                        \
             ? launch_sm90<DIM, true>(q, k, v, out, dout, lse, cos, sin, dq, dk, dv, dq_acc,   \
                                      delta, strides, B, H, KV, Sq, Skv, q_pos_offset, causal, \
                                      window, tstride, scale, st)                              \
             : launch_sm90<DIM, false>(q, k, v, out, dout, lse, cos, sin, dq, dk, dv, dq_acc,  \
                                       delta, strides, B, H, KV, Sq, Skv, q_pos_offset,        \
                                       causal, window, tstride, scale, st)
  if (D == 64) DTT_BWD_SM90(64);
  if (D == 128) DTT_BWD_SM90(128);
#undef DTT_BWD_SM90
  return (int)cudaErrorInvalidValue;
}
