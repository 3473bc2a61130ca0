// The two-pass pair's dq kernel for head dims 384 and 512 on strided (B, H,
// S, D) operands as a Hopper warpgroup kernel: every tile product is a
// wgmma, and each block computes the scores once for all of dq's columns.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_dq_kernel
// (:522, launched at :1114 by _flash_backward: K5, the dq half of the
// two-pass pair, whose dk/dv half is flash_bwd_cols_sm90.cu) wherever the
// call is bf16 at head_dim 384 or 512 (the wrapper pads 257-383 to 384 and
// 385-511 to 512). f32 above 256 and bf16 above 512 stay on the
// column-group kernel flash_bwd_dq_dstream.cu, whose C contract this file
// keeps: strided operands with a contiguous last dimension, GQA by head
// group, q_pos_offset and Sq != Skv with end-aligned causal masking,
// causal, window and non-causal masking, the prepare pass's q rotated and
// scale-folded and k rotated (flash_dstream.cuh), delta as the dk/dv half
// wrote it, dq summed once into the f32 dq_acc scratch and rotated back and
// cast by dstream_unrotate, and exact zeros for q rows that attend nothing.
// p is recomputed from the saved logsumexp (zeroed where the row attended
// nothing), dS = p∘(dO·vᵀ − delta) rounded to bf16, and dq = s·Σ dS·k over
// the kv tiles the row can see.
//
// Bound on this card: three products over the causal pairs (q·kᵀ, dO·vᵀ,
// dS·k), ~3.1e11 FLOPs at the head_dim 512 call of the trainer (B 12, S
// 2048, 4 heads of 512) against ~0.5 GB moved, so the tensor cores bound it
// (about 0.31 ms at 989 TFLOP/s). flash_bwd_dq_dstream.cu gives each
// 128-column group of dq its own block, and each block recomputes S and dP
// over all of D: (2·4 + 1)/3 = 3x the minimum work at D 512, on per-warp
// mma.sync.
//
// Design. One block of two warpgroups (256 threads) per (64-row q tile,
// head, batch), the q tiles with the most keys first; the block walks the
// 32-key kv tiles the causal/window band lets its rows see. Per kv tile:
//   S = (q·s)·Kᵀ     warpgroup 0, wgmma m64n32k16 over all of D (both
//                    K-major in shared memory); P = exp(S − lse) in its
//                    registers (exp2 on the special-function unit, the
//                    mask skipped on tiles wholly inside the band)
//   dP = dO·Vᵀ       warpgroup 1, the same instruction stream on other
//                    operands; handed over in f32 through shared memory
//   dS = P∘(dP − delta)  warpgroup 0, after a named barrier, rounded to
//                    bf16 (the TPU kernel's ds) into shared memory
//   dQ_c += dS·K_c   both warpgroups, after a second named barrier, each
//                    over its half of D's columns, [wg·D/2, +D/2), as
//                    m64n64k16 products (dS K-major, K MN-major): 4 (D 512)
//                    or 3 (D 384) accumulators of 32 f32 registers a thread
// So the block multiplies S and dP once for all of dq's columns: 1x the
// minimum work, against 3x. dq is written once, scaled, to the f32
// scratch; the rotate-back needs no pairs inside a warpgroup, since the dq
// pass does it.
//
// Shared memory at D 512 (bytes): q and dO, 64 x 512 each, 131,072; K and
// V, 32 x 512 each, 65,536; dS, bf16, 64 rows of a 64-column swizzled tile
// (32 columns used), 8,192; dP f32, 8,192; 1,024 to align the base:
// 214,016 of 232,448 (164,864 at 384). No room to double-buffer K and V at
// 512, so both are single-buffered and the next tile streams in as each
// part frees up: V once dP has retired (after the first named barrier), and
// each warpgroup's half of K's columns once its dQ product has retired; the
// next step's block barrier waits for both. All tiles use the 128-byte
// swizzle the wgmma descriptors read (sm90_common.cuh). Every wgmma group
// retires inside its step and is issued unconditionally. Simple first: no
// TMA, no warp specialisation, no ping-pong.
#include "flash_dstream.cuh"
#include "sm90_common.cuh"

namespace dtt {

constexpr int DQC90_BQ = 64, DQC90_BKV = 32;  // q rows a block, keys a step

template <int D>
constexpr size_t dqc90_smem_bytes() {
  // q, dO, K, V, dS (bf16), dP (f32), and room to align the base to 1024
  // bytes.
  return sizeof(bf16) * (2 * DQC90_BQ * D + 2 * DQC90_BKV * D + DQC90_BQ * 64) +
         sizeof(float) * DQC90_BQ * DQC90_BKV + 1024;
}
static_assert(dqc90_smem_bytes<512>() <= 232448, "a block's shared memory");

template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_bwd_dq_cols_sm90_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq_acc, Bhsd sk, Bhsd sv, Bhsd sg, int H,
                              int group, int Sq, int Skv, int off, int causal, int window,
                              float scale) {
  // HALF: a warpgroup's columns of dq; NB: its 64-column accumulators.
  constexpr int BQ = DQC90_BQ, BKV = DQC90_BKV, HALF = D / 2, NB = HALF / 64;
  static_assert(D == 384 || D == 512, "head_dim 384 or 512");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_at(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* sdO = sQ + BQ * D;
  bf16* sK = sdO + BQ * D;
  bf16* sV = sK + BKV * D;
  bf16* sdS = sV + BKV * D;  // dS: q rows x kv columns (of a 64-column tile)
  float2* sdP = reinterpret_cast<float2*>(sdS + BQ * 64);  // dP in fragment order

  const int num_q = (Sq + BQ - 1) / BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * BQ;  // the tiles with the most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const size_t head_row = ((size_t)b * H + h) * Sq;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int wi = wt >> 5;  // the warp: rows [16wi, +16) of the tile, in either warpgroup
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + 16 * wi;  // the warp's first q row
  const int row[2] = {r_lo + g, r_lo + g + 8};
  const int col0 = wg * HALF;  // the warpgroup's columns of dq: [col0, col0 + HALF)
  // This lane's rows: −lse·log2e (−inf where the row attends nothing or
  // lies past Sq, so that P is 0 there) and delta.
  float nlb[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = row[i] < Sq ? lse[head_row + row[i]] : NEG_INF;
    nlb[i] = l > NEG_INF / 2 ? -l * kLog2e : -INFINITY;
    rd[i] = row[i] < Sq ? delta[head_row + row[i]] : 0.f;
  }

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + BQ, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / BKV * BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  float dqa[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[c][i] = 0.f;

  if (n_tiles > 0) {
    auto key0 = [&](int n) { return kv_begin + n * BKV; };
    sw_issue_cols<BQ, D, SM90_THREADS>(sQ, qs + head_row * D, D, q0, Sq, 0, threadIdx.x);
    sw_issue_cols<BQ, D, SM90_THREADS>(sdO, dout + b * sg.b + h * sg.h, sg.s, q0, Sq, 0,
                                       threadIdx.x);
    sw_issue_cols<BKV, D, SM90_THREADS>(sK, kb, sk.s, key0(0), Skv, 0, threadIdx.x);
    sw_issue_cols<BKV, D, SM90_THREADS>(sV, vb, sv.s, key0(0), Skv, 0, threadIdx.x);
    cp_async_commit();
    const uint32_t aQ = smem_at(sQ), adO = smem_at(sdO), aK = smem_at(sK), aV = smem_at(sV),
                   adS = smem_at(sdS);

    for (int n = 0; n < n_tiles; ++n) {
      const int k0 = key0(n);
      cp_async_wait<0>();
      proxy_fence();
      __syncthreads();  // tile n is in place everywhere; step n - 1 is done

      // Warpgroup 0: S = (q·s)·Kᵀ; warpgroup 1: dP = dO·Vᵀ, over all of D.
      const uint32_t aA = wg == 0 ? aQ : adO, aB = wg == 0 ? aK : aV;
      float sc[16];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(sc, desc_k(aA + 2 * sw<BQ>(0, 16 * kk)),
                     desc_k(aB + 2 * sw<BKV>(0, 16 * kk)), kk > 0);
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
        for (int j = 0; j < BKV / 8; ++j)
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
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sdP[(2 * j + i) * 128 + wt] = make_float2(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
      }
      named_sync(1, SM90_THREADS);  // dP is in place; both score products retired
      // V is free: the next tile's, by every thread, while dS and dQ run.
      if (n + 1 < n_tiles)
        sw_issue_cols<BKV, D, SM90_THREADS>(sV, vb, sv.s, key0(n + 1), Skv, 0, threadIdx.x);
      cp_async_commit();

      // dS = P∘(dP − delta), rounded to bf16 (the TPU kernel's ds), into
      // shared memory: the K-major A of dQ += dS·K.
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
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
        for (int c = 0; c < NB; ++c)
          mma_ss<0, 1>(dqa[c], desc_k(adS + 2 * sw<BQ>(0, 16 * kk)),
                       desc_mn(aK + 2 * sw<BKV>(16 * kk, col0 + 64 * c)), 1);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < NB; ++c) reg_fence(dqa[c]);
      // This warpgroup's columns of K are free (warpgroup 0's S product
      // retired before the first barrier): the next tile's.
      if (n + 1 < n_tiles)
        sw_issue_cols<BKV, HALF, 128>(sK, kb, sk.s, key0(n + 1), Skv, col0, wt);
      cp_async_commit();
    }
  }

  // dq (in the rotated frame), scaled, to its f32 scratch; rows that see no
  // key (n_tiles == 0) get zeros. Fragment j of a block holds columns 8j +
  // 2t, + 1 of rows g and g + 8.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    float* dst = dq_acc + (head_row + row[i]) * D + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 64 * c + 8 * j) =
            make_float2(scale * dqa[c][4 * j + 2 * i], scale * dqa[c][4 * j + 2 * i + 1]);
  }
}

template <int D>
int launch_dq_cols90(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* cos, const void* sin,
                     void* dq, const long long* st, int B, int H, int KV, int Sq, int Skv,
                     int off, int causal, int window, long long tstride, float scale, void* q_s,
                     void* k_rot, void* dq_acc, cudaStream_t stream) {
  auto at = [&](int i) { return Bhsd{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  Bhsd sk = at(1);
  cudaError_t err = dstream_prep<bf16>(q, at(0), q_s, cos, sin, B, H, Sq, D, off, tstride, 1,
                                       scale, stream);
  if (err != cudaSuccess) return (int)err;
  if (cos != nullptr) {
    if ((err = dstream_prep<bf16>(k, sk, k_rot, cos, sin, B, KV, Skv, D, 0, tstride, 0, 1.f,
                                  stream)) != cudaSuccess)
      return (int)err;
    k = k_rot;
    sk = contiguous(KV, Skv, D);
  }
  const size_t smem = dqc90_smem_bytes<D>();
  if ((err = set_smem(flash_bwd_dq_cols_sm90_kernel<D>, smem)) != cudaSuccess) return (int)err;
  const dim3 grid((Sq + DQC90_BQ - 1) / DQC90_BQ, H, B);
  flash_bwd_dq_cols_sm90_kernel<D><<<grid, SM90_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q_s), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), sk, at(2), at(3), H,
      H / KV, Sq, Skv, off, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)dstream_unrotate<bf16>(dq_acc, cos, sin, dq, at(4), B, H, Sq, D, off, tstride,
                                     stream);
}

}  // namespace dtt

// dtt_flash_bwd_dq_dstream's contract (flash_bwd_dq_dstream.cu) in bf16 at
// head_dim 384 or 512: q_s (B, H, Sq, D) receives q rotated and
// scale-folded, k_rot (B, KV, Skv, D), with tables, k rotated (null
// without), dq_acc (B, H, Sq, D) f32 the dq sum before its rotate-back.
// Any other call (f32, another head dim) returns cudaErrorInvalidValue.
// Returns a cudaError_t.
extern "C" int dtt_flash_bwd_dq_cols_sm90(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* cos, const void* sin, void* dq,
                                          const long long* strides, int B, int H, int KV,
                                          int Sq, int Skv, int D, int is_bf16, int causal,
                                          int window, int q_pos_offset, long long tstride,
                                          float scale, void* q_s, void* k_rot, void* dq_acc,
                                          void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dstream_args_ok(B, H, KV, Sq, Skv, D, cos, k_rot, q_pos_offset) || q_s == nullptr ||
      dq_acc == nullptr || !is_bf16)
    return (int)cudaErrorInvalidValue;
#define DTT_DQ_COLS90(DIM)                                                                    \
  return launch_dq_cols90<DIM>(q, k, v, dout, lse, delta, cos, sin, dq, strides, B, H, KV, Sq, \
                               Skv, q_pos_offset, causal, window, tstride, scale, q_s, k_rot,  \
                               dq_acc, st)
  if (D == 384) DTT_DQ_COLS90(384);
  if (D == 512) DTT_DQ_COLS90(512);
#undef DTT_DQ_COLS90
  return (int)cudaErrorInvalidValue;
}
