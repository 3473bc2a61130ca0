// The two-pass pair's dk/dv kernel for head dims 384 and 512 on strided
// (B, H, S, D) operands as a Hopper warpgroup kernel: every tile product is
// a wgmma, and each block computes the scores once for half of D's columns.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// (:592, launched at :1140 by _flash_backward: K6, the dk/dv half of the
// two-pass pair, whose dq half is flash_bwd_dq_cols_sm90.cu) wherever the call
// is bf16 at head_dim 384 or 512 (the wrapper pads 257-383 to 384 and
// 385-511 to 512). The fused backward above 256 (K2/K4/K8, dq wanted), f32,
// and bf16 above 512 stay on the column-group kernel flash_bwd_dstream.cu,
// whose C contract this file keeps with dq null: strided operands with a
// contiguous last dimension, GQA by head group (a block loops over its kv
// head's q heads), q_pos_offset and Sq != Skv with end-aligned causal
// masking, causal, window and non-causal masking, the prepare pass's q
// rotated and scale-folded and k rotated (flash_dstream.cuh), the delta
// pre-pass (delta left for K5), dk summed in the f32 dk_acc scratch and
// rotated back by dstream_unrotate, dv written straight through its
// strides, and exact zeros for kv rows that no q row sees.
//
// Bound on this card: four products over the causal pairs, ~7e10 FLOPs at
// the head_dim 512 call (B 2, S 2048, 4 heads of 512) against ~0.05 GB
// moved, so the tensor cores bound it (about 0.07 ms at 989 TFLOP/s).
// flash_bwd_dstream.cu gives each 128-column group of dK and dV its own
// block, and each block recomputes Sᵀ and dPᵀ over all of D: (2·4 + 2)/4 =
// 2.5x the minimum work at D 512, on per-warp mma.sync.
//
// Design. A 64-row kv tile's dK and dV at 512 columns are 2 · 64 · 512 f32,
// the SM's whole register file, so two blocks share a tile: grid (Skv/64 ·
// 2 column halves, KV, B), low tiles first. A block of two warpgroups (256
// threads) owns kv rows [k0, +64) and the columns [c·D/2, +D/2) of dK and
// dV, and walks every q head of the GQA group and the 32-row q tiles the
// causal/window band lets see its tile. Per q tile:
//   Sᵀ = K·(q·s)ᵀ    warpgroup 0, wgmma m64n32k16 over all of D (A and B
//                    K-major in shared memory); Pᵀ = exp(Sᵀ − lse) in its
//                    registers, bf16 to shared memory
//   dPᵀ = V·dOᵀ      warpgroup 1, the same instruction stream on other
//                    operands; handed over in f32 through shared memory
//   dV_c += Pᵀ·dO_c  both warpgroups, after a named barrier, each over its
//                    columns (A K-major, dO MN-major), while warpgroup 0
//                    forms dSᵀ = Pᵀ∘(dPᵀ − delta) rounded to bf16
//   dK_c += dSᵀ·q_c  both, after a second named barrier
// A warpgroup owns a 64-column block and a second one of 64 (D 512) or 32
// (D 384) columns of the half: [64w, +64) and [128 + W·w, +W), W = 64 or
// 32, so both run the same products (the m64n32k16 overload at 384); 128
// or 96 f32 accumulator registers a thread for dK and dV. So the block
// multiplies the scores once for D/2 columns: (2·2 + 2)/4 = 1.5x the
// minimum work, against 2.5x.
//
// Shared memory at D 512 (bytes): K and V rows, 64 x 512 each, 131,072; one
// 32-row q tile and one 32-row dO tile, 32 x 512 each, 65,536; Pᵀ and dSᵀ,
// bf16, 64 rows of a 64-column swizzled tile each (32 columns used),
// 16,384; dPᵀ f32, 8,192; two buffers of [lse | delta], 512; 1,024 to align
// the base: 222,720 of 232,448. No room to double-buffer q and dO whole, so
// they are single-buffered and the next tile streams in two parts: the
// other half's columns (which only the score products read) once both score
// products have retired, and each warpgroup's own columns once its dK and
// dV products have retired; the next step's barrier waits for both. All
// tiles use the 128-byte swizzle the wgmma descriptors read
// (sm90_common.cuh). Every wgmma group retires inside its step and is
// issued unconditionally. Simple first: no TMA, no warp specialisation.
#include "flash_dstream.cuh"
#include "sm90_common.cuh"

namespace dtt {

constexpr int BC90_BKV = 64, BC90_BQ = 32;  // kv rows a block, q rows a step

template <int D>
constexpr size_t bc90_smem_bytes() {
  // K, V, q, dO, Pᵀ, dSᵀ (bf16), dPᵀ (f32), two [lse | delta] buffers, and
  // room to align the base to 1024 bytes.
  return sizeof(bf16) * (2 * BC90_BKV * D + 2 * BC90_BQ * D + 2 * BC90_BKV * 64) +
         sizeof(float) * (BC90_BKV * BC90_BQ + 4 * BC90_BQ) + 1024;
}
static_assert(bc90_smem_bytes<512>() <= 232448, "a block's shared memory");

template <int D>
__global__ void __launch_bounds__(SM90_THREADS, 1)
flash_bwd_cols_sm90_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk_acc, bf16* __restrict__ dv_out, Bhsd sk,
                           Bhsd sv, Bhsd sg, Bhsd sdv, int H, int group, int Sq, int Skv, int off,
                           int causal, int window) {
  // HALF: a block's columns; WB: the width of a warpgroup's second column
  // block (64 at D 512, 32 at D 384), NB its accumulator registers.
  constexpr int BKV = BC90_BKV, BQ = BC90_BQ, HALF = D / 2, WB = HALF / 2 - 64, NB = WB / 2;
  static_assert(D == 384 || D == 512, "head_dim 384 or 512");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_at(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* sV = sK + BKV * D;
  bf16* sQ = sV + BKV * D;        // the q tile (q rotated and scale-folded)
  bf16* sdO = sQ + BQ * D;        // the dO tile
  bf16* sPt = sdO + BQ * D;       // Pᵀ: kv rows x q columns (of a 64-column tile)
  bf16* sdS = sPt + BKV * 64;     // dSᵀ: the same layout
  float* sdP = reinterpret_cast<float*>(sdS + BKV * 64);  // dPᵀ in fragment order
  float* sStats = sdP + BKV * BQ;  // two buffers of [lse | delta]

  const int k0 = (int)(blockIdx.x >> 1) * BKV;  // low tiles first: they see most q
  const int cb = (int)(blockIdx.x & 1) * HALF;  // the block's first column
  const int kvh = blockIdx.y, b = blockIdx.z;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127, wi = wt >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kv_row[2] = {k0 + 16 * wi + g, k0 + 16 * wi + g + 8};
  // The warpgroup's two column blocks (absolute columns of D).
  const int colA = cb + 64 * wg, colB = cb + 128 + WB * wg;

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
  auto step_head = [&](int n) { return kvh * group + n / n_q; };
  auto step_q0 = [&](int n) { return q_begin + (n % n_q) * BQ; };

  float dkA[32], dvA[32], dkB[NB], dvB[NB];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkA[i] = dvA[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) dkB[i] = dvB[i] = 0.f;

  if (n_steps > 0) {
    auto qsrc = [&](int n) { return qs + head_row(step_head(n)) * D; };
    auto gsrc = [&](int n) { return dout + b * sg.b + step_head(n) * sg.h; };
    // The other half's columns of step n's q and dO tiles, and its lse and
    // delta rows: 256 threads, after both score products of step n - 1 retired.
    auto issue_other = [&](int n) {
      const int q0 = step_q0(n), co = HALF - cb;
      sw_issue_cols<BQ, HALF, SM90_THREADS>(sQ, qsrc(n), D, q0, Sq, co, threadIdx.x);
      sw_issue_cols<BQ, HALF, SM90_THREADS>(sdO, gsrc(n), sg.s, q0, Sq, co, threadIdx.x);
      float* st = sStats + (n & 1) * 2 * BQ;
      for (int i = threadIdx.x; i < 2 * BQ; i += SM90_THREADS) {
        const int qr = q0 + i % BQ;
        if (qr < Sq) cp_async4(st + i, (i < BQ ? lse : delta) + head_row(step_head(n)) + qr);
        else st[i] = 0.f;
      }
    };
    // This warpgroup's own columns of step n's q and dO tiles: its 128
    // threads, after its dK and dV products of step n - 1 retired.
    auto issue_own = [&](int n) {
      const int q0 = step_q0(n);
      sw_issue_cols<BQ, 64, 128>(sQ, qsrc(n), D, q0, Sq, colA, wt);
      sw_issue_cols<BQ, WB, 128>(sQ, qsrc(n), D, q0, Sq, colB, wt);
      sw_issue_cols<BQ, 64, 128>(sdO, gsrc(n), sg.s, q0, Sq, colA, wt);
      sw_issue_cols<BQ, WB, 128>(sdO, gsrc(n), sg.s, q0, Sq, colB, wt);
    };
    sw_issue<D, BKV>(sK, kb, sk.s, k0, Skv);
    sw_issue<D, BKV>(sV, vb, sv.s, k0, Skv);
    issue_other(0);
    issue_own(0);
    cp_async_commit();

    const uint32_t aK = smem_at(sK), aV = smem_at(sV), aQ = smem_at(sQ), adO = smem_at(sdO),
                   aPt = smem_at(sPt), adS = smem_at(sdS);
    float2* sdP2 = reinterpret_cast<float2*>(sdP);
    for (int n = 0; n < n_steps; ++n) {
      const int q0 = step_q0(n);
      const float* sLse = sStats + (n & 1) * 2 * BQ;
      const float* sDelta = sLse + BQ;
      cp_async_wait<0>();
      proxy_fence();
      __syncthreads();  // step n's tiles are in place; step n - 1 is done everywhere

      // Warpgroup 0: Sᵀ = K·(q·s)ᵀ; warpgroup 1: dPᵀ = V·dOᵀ, over all of D.
      const uint32_t aA = wg == 0 ? aK : aV, aB = wg == 0 ? aQ : adO;
      float sc[16];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(sc, desc_k(aA + 2 * sw<BKV>(0, 16 * kk)),
                     desc_k(aB + 2 * sw<BQ>(0, 16 * kk)), kk > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(sc);

      // Fragment (j, i) of this thread holds q columns c, c + 1 (c = 8j +
      // 2t) of kv row 16wi + g + 8i; its float2 of dPᵀ goes to (2j + i)·128
      // + wt, where the same thread of warpgroup 0 reads it.
      if (wg == 0) {
        // Pᵀ = exp(Sᵀ − lse) in place (0 where masked and on q rows that
        // attend nothing); tiles wholly inside the band skip the mask. Pᵀ
        // rounded to bf16 (the TPU kernel's p) is the A of dV += Pᵀ·dO.
        const int p0 = q0 + off;
        const bool full = q0 + BQ <= Sq && k0 + BKV - 1 < Skv &&
                          (!causal || (k0 + BKV - 1 <= p0 &&
                                       (window <= 0 || k0 > p0 + BQ - 1 - window)));
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int e = 4 * j + 2 * i + e2, c = 8 * j + 2 * t + e2;
              const bool live =
                  full || (attends_at(q0 + c, kv_row[i], Sq, Skv, off, causal, window) &&
                           sLse[c] > NEG_INF / 2);
              sc[e] = live ? ex2(fmaf(sc[e], kLog2e, -sLse[c] * kLog2e)) : 0.f;
            }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i;
            *reinterpret_cast<uint32_t*>(sPt + sw<BKV>(16 * wi + g + 8 * i, 8 * j + 2 * t)) =
                pack_bf16(sc[e], sc[e + 1]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sdP2[(2 * j + i) * 128 + wt] = make_float2(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
      }
      proxy_fence();
      named_sync(1, SM90_THREADS);  // Pᵀ and dPᵀ are in place; both score products retired
      if (n + 1 < n_steps) issue_other(n + 1);
      cp_async_commit();

      // dV += Pᵀ·dO over this warpgroup's columns: k-step kk takes q rows
      // [16kk, +16), Pᵀ K-major, dO MN-major.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t a = desc_k(aPt + 2 * sw<BKV>(0, 16 * kk));
        mma_ss<0, 1>(dvA, a, desc_mn(adO + 2 * sw<BQ>(16 * kk, colA)), 1);
        mma_ss<0, 1>(dvB, a, desc_mn(adO + 2 * sw<BQ>(16 * kk, colB)), 1);
      }
      wg_commit();

      // dSᵀ = Pᵀ∘(dPᵀ − delta) while dV multiplies, from the f32 Pᵀ and dPᵀ,
      // rounded to bf16 (the TPU kernel's ds): the A of dK += dSᵀ·(q·s).
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(sDelta + 8 * j + 2 * t);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i;
            const float2 dp = sdP2[(2 * j + i) * 128 + wt];
            *reinterpret_cast<uint32_t*>(sdS + sw<BKV>(16 * wi + g + 8 * i, 8 * j + 2 * t)) =
                pack_bf16(sc[e] * (dp.x - dl.x), sc[e + 1] * (dp.y - dl.y));
          }
        }
      }
      proxy_fence();
      named_sync(1, SM90_THREADS);  // dSᵀ is in place

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t a = desc_k(adS + 2 * sw<BKV>(0, 16 * kk));
        mma_ss<0, 1>(dkA, a, desc_mn(aQ + 2 * sw<BQ>(16 * kk, colA)), 1);
        mma_ss<0, 1>(dkB, a, desc_mn(aQ + 2 * sw<BQ>(16 * kk, colB)), 1);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(dkA);
      reg_fence(dkB);
      reg_fence(dvA);
      reg_fence(dvB);
      // This warpgroup's columns of q and dO are free: the next tile's.
      if (n + 1 < n_steps) issue_own(n + 1);
      cp_async_commit();
    }
  }

  // dk (in the rotated frame) to its f32 scratch, dv to its layout; kv rows
  // no query sees (n_steps == 0) get zeros. Fragment j of a block holds
  // columns 8j + 2t, + 1 of rows g and g + 8.
  float* dkb = dk_acc + ((size_t)b * (H / group) + kvh) * Skv * D;
  bf16* dvb = dv_out + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kv_row[i];
    if (r >= Skv) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = colA + 8 * j + 2 * t, e = 4 * j + 2 * i;
      *reinterpret_cast<float2*>(dkb + (size_t)r * D + col) = make_float2(dkA[e], dkA[e + 1]);
      store_pair<bf16>(dvb + r * sdv.s + col, dvA[e], dvA[e + 1]);
    }
#pragma unroll
    for (int j = 0; j < WB / 8; ++j) {
      const int col = colB + 8 * j + 2 * t, e = 4 * j + 2 * i;
      *reinterpret_cast<float2*>(dkb + (size_t)r * D + col) = make_float2(dkB[e], dkB[e + 1]);
      store_pair<bf16>(dvb + r * sdv.s + col, dvB[e], dvB[e + 1]);
    }
  }
}

template <int D>
int launch_bwd_cols90(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const void* lse, const void* cos, const void* sin,
                      void* dk, void* dv, void* delta, const long long* s, int B, int H, int KV,
                      int Sq, int Skv, int off, int causal, int window, long long tstride,
                      float scale, void* q_s, void* k_rot, void* dk_acc, cudaStream_t stream) {
  auto at = [&](int i) { return Bhsd{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; };
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
  const long long rows = (long long)B * H * Sq;
  flash_bwd_delta_kernel<bf16><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      at(3), at(4), H, Sq, D, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = bc90_smem_bytes<D>();
  if ((err = set_smem(flash_bwd_cols_sm90_kernel<D>, smem)) != cudaSuccess) return (int)err;
  const dim3 grid((Skv + BC90_BKV - 1) / BC90_BKV * 2, KV, B);
  flash_bwd_cols_sm90_kernel<D><<<grid, SM90_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q_s), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk_acc), static_cast<bf16*>(dv), sk,
      at(2), at(4), at(7), H, H / KV, Sq, Skv, off, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)dstream_unrotate<bf16>(dk_acc, cos, sin, dk, at(6), B, KV, Skv, D, 0, tstride,
                                     stream);
}

}  // namespace dtt

// dtt_flash_bwd_dstream's contract (flash_bwd_dstream.cu) for the two-pass
// pair's dk/dv half (dq null) in bf16 at head_dim 384 or 512: q_s (B, H, Sq,
// D) receives q rotated and scale-folded, k_rot (B, KV, Skv, D), with
// tables, k rotated (null without), dk_acc (B, KV, Skv, D) f32 the dk sum
// before its rotate-back; delta is left for K5 (flash_bwd_dq_cols_sm90.cu).
// Any other call (dq wanted, f32, another head dim) returns
// cudaErrorInvalidValue. Returns a cudaError_t.
extern "C" int dtt_flash_bwd_cols_sm90(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       const void* cos, const void* sin, void* dq, void* dk,
                                       void* dv, void* dq_acc, void* delta,
                                       const long long* strides, int B, int H, int KV, int Sq,
                                       int Skv, int D, int is_bf16, int causal, int window,
                                       int q_pos_offset, long long tstride, float scale,
                                       void* q_s, void* k_rot, void* dk_acc, void* stream) {
  using namespace dtt;
  (void)dq_acc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dstream_args_ok(B, H, KV, Sq, Skv, D, cos, k_rot, q_pos_offset) || q_s == nullptr ||
      dk_acc == nullptr || dq != nullptr || !is_bf16)
    return (int)cudaErrorInvalidValue;
#define DTT_BWD_COLS90(DIM)                                                                   \
  return launch_bwd_cols90<DIM>(q, k, v, out, dout, lse, cos, sin, dk, dv, delta, strides, B, \
                                H, KV, Sq, Skv, q_pos_offset, causal, window, tstride, scale, \
                                q_s, k_rot, dk_acc, st)
  if (D == 384) DTT_BWD_COLS90(384);
  if (D == 512) DTT_BWD_COLS90(512);
#undef DTT_BWD_COLS90
  return (int)cudaErrorInvalidValue;
}
