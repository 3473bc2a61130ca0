// Flash attention fused backward for head dims above 256 on strided
// (B, H, S, D) operands, D a multiple of 128 taken at run time, for Hopper.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_fused_kernel
// and _flash_bwd_dkv_kernel at any head dim, behind the launch sites of
// flash_bwd.cu: _flash_backward_qkv (K2), _flash_backward_fused (K4),
// _flash_backward_fused_bshd (K8, whole or on q segments placed by
// q_pos_offset), and, with dq compiled out, the two-pass pair's dk/dv half
// (K6), whose dq half is flash_bwd_dq_dstream.cu (K5).
//
// Bound on this card: five tile products against the forward's two, ~5.2e11
// FLOPs at the head_dim 512 call of the trainer (B 12, S 2048, 4 heads of
// 512, causal, bf16) against ~0.6 GB moved, so the tensor cores bound it
// (about 0.52 ms at 989 TFLOP/s). Each of the D/128 column groups recomputes
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over the whole of D, so the kernel does (2·NG +
// 3) / 5 times the minimal work: 2.2x at D 512 (K6: (2·NG + 2) / 4, 2.5x).
//
// Design: the passes of flash_bwd.cu around a new main kernel. A prepare
// pass gives q rotated and scale-folded, and k rotated (flash_dstream.cuh);
// the delta pre-pass and the dq pass are flash_bwd_passes.cuh's, which take
// D at run time, and the dq pass also rotates dk back. Main kernel: one
// block of 4 warps per (64-row kv tile, kv head, batch, column group g of
// 128 columns), each warp owning 16 kv rows; the block loops over every q
// head of the GQA group and over the 32-row q tiles the kv tile can see. For
// each q tile Sᵀ and dPᵀ are summed over D in 64-column chunks of K, V, q and
// dO streamed through two shared buffers by cp.async (chunk i + 1 loads
// while chunk i multiplies); then Pᵀ = exp(Sᵀ − lse), dSᵀ = Pᵀ∘(dPᵀ −
// delta) rounded to the operand dtype, dV_g += Pᵀ·dO_g and dK_g += dSᵀ·q_g
// over group g's columns in f32 registers (the GQA group sum included), and
// dQ_g += s·dS·K_g by float2 atomics into the zeroed f32 dq scratch (q_g,
// dO_g and K_g are group g's column slices, loaded beside the chunks). dK
// goes to an f32 scratch for the rotate-back pass, dV straight to its layout.
// Products run on mma.sync (bf16) with ldmatrix fragments, FMAs for f32.
// The dq atomics add the kv tiles' shares in an order that changes from run
// to run, so dq is reproducible only to f32 rounding; chip_smoke.py holds it
// by the limits every kernel meets (TOL, BLOCK_TOL), which are bf16's or
// 1e-4 of the largest value in f32, far above that. Simple first: no wgmma,
// TMA or warp specialisation.
#include "flash_dstream.cuh"

namespace dtt {

constexpr int DSB_BKV = 64, DSB_BQ = 32;

template <typename T>
constexpr size_t dsb_smem_bytes() {
  return sizeof(float) * 2 * DSB_BQ +
         sizeof(T) * (2 * (2 * DSB_BKV + 2 * DSB_BQ) * (DS_CH + kPad<T>) +
                      (DSB_BKV + 2 * DSB_BQ) * (DS_GROUP + kPad<T>) +
                      2 * DSB_BKV * (DSB_BQ + kPad<T>));
}

template <typename T, bool DQ>
__global__ void __launch_bounds__(DS_THREADS)
flash_bwd_dstream_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk_acc, T* __restrict__ dv_out,
                         float* __restrict__ dq_acc, Bhsd sk, Bhsd sv, Bhsd sg, Bhsd sdv, int H,
                         int group, int Sq, int Skv, int D, int off, int causal, int window,
                         float scale) {
  constexpr int LDC = DS_CH + kPad<T>, LDG = DS_GROUP + kPad<T>, LDQ = DSB_BQ + kPad<T>;
  constexpr int NQ = DSB_BQ / 8, NT = DS_GROUP / 8;
  constexpr int CHUNK = (2 * DSB_BKV + 2 * DSB_BQ) * LDC;  // [K_c | V_c | q_c | dO_c]
  extern __shared__ __align__(16) unsigned char smem[];
  float* sLse = reinterpret_cast<float*>(smem);
  float* sDelta = sLse + DSB_BQ;
  T* sC = reinterpret_cast<T*>(sDelta + DSB_BQ);  // two chunk buffers
  T* sKg = sC + 2 * CHUNK;                        // K's rows, group g's columns (dQ)
  T* sQg = sKg + DSB_BKV * LDG;                   // the q tile's group g columns (dK)
  T* sdOg = sQg + DSB_BQ * LDG;                   // the dO tile's group g columns (dV)
  T* sP = sdOg + DSB_BQ * LDG;                    // Pᵀ, kv rows major
  T* sdS = sP + DSB_BKV * LDQ;                    // dSᵀ, kv rows major
  auto chunk = [&](int i) { return sC + (i & 1) * CHUNK; };

  const int NG = D / DS_GROUP, NC = D / DS_CH;
  const int k0 = (int)(blockIdx.x / NG) * DSB_BKV;  // low tiles first: they see most q
  const int g = (int)blockIdx.x % NG, col0 = g * DS_GROUP;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int kv_row[2] = {k0 + warp * 16 + gr, k0 + warp * 16 + gr + 8};

  // q rows whose positions (row + off) can see this kv tile.
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = min(Sq, max(0, k0 - off)) / DSB_BQ * DSB_BQ;
    if (window > 0) q_end = min(Sq, max(0, k0 + DSB_BKV - 1 + window - off));
  }
  // Steps walk (q head of the group, q tile).
  const int n_q = q_end > q_begin ? (q_end - q_begin + DSB_BQ - 1) / DSB_BQ : 0;
  const int n_steps = group * n_q;
  auto head_row = [&](int h) { return ((size_t)b * H + h) * Sq; };  // this head's rows
  auto step_head = [&](int n) { return kvh * group + n / n_q; };
  auto step_q0 = [&](int n) { return q_begin + (n % n_q) * DSB_BQ; };

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (n_steps > 0) {
    // Load i of the flat sequence (step i / NC, D chunk i % NC): K, V, q and
    // dO chunks into buffer i % 2.
    const int n_loads = n_steps * NC;
    auto issue_chunk = [&](int i) {
      const int n = i / NC, c = (i % NC) * DS_CH, h = step_head(n), q0 = step_q0(n);
      T* dst = chunk(i);
      rows_issue<T, DS_CH, DSB_BKV>(dst, LDC, kb + c, sk.s, k0, Skv);
      rows_issue<T, DS_CH, DSB_BKV>(dst + DSB_BKV * LDC, LDC, vb + c, sv.s, k0, Skv);
      rows_issue<T, DS_CH, DSB_BQ>(dst + 2 * DSB_BKV * LDC, LDC, qs + head_row(h) * D + c, D,
                                   q0, Sq);
      rows_issue<T, DS_CH, DSB_BQ>(dst + (2 * DSB_BKV + DSB_BQ) * LDC, LDC,
                                   dout + b * sg.b + h * sg.h + c, sg.s, q0, Sq);
    };
    // Step n's group-g slices of q and dO and its lse and delta rows: the
    // buffers were last read before the previous step's closing barrier.
    auto issue_slices = [&](int n) {
      const int h = step_head(n), q0 = step_q0(n);
      rows_issue<T, DS_GROUP, DSB_BQ>(sQg, LDG, qs + head_row(h) * D + col0, D, q0, Sq);
      rows_issue<T, DS_GROUP, DSB_BQ>(sdOg, LDG, dout + b * sg.b + h * sg.h + col0, sg.s, q0,
                                      Sq);
      for (int i = threadIdx.x; i < 2 * DSB_BQ; i += DS_THREADS) {
        const int qr = q0 + i % DSB_BQ;
        if (qr < Sq) cp_async4(sLse + i, (i < DSB_BQ ? lse : delta) + head_row(h) + qr);
        else sLse[i] = 0.f;
      }
    };
    if constexpr (DQ) rows_issue<T, DS_GROUP, DSB_BKV>(sKg, LDG, kb + col0, sk.s, k0, Skv);
    issue_chunk(0);
    cp_async_commit();

    T* myP = sP + warp * 16 * LDQ;
    T* mydS = sdS + warp * 16 * LDQ;
    // dQ split: warp w adds q rows [16·(w%2), +16) x group columns [64·(w/2), +64).
    const int dq_r0 = (warp & 1) * 16, dq_c0 = (warp >> 1) * 64;

    for (int n = 0; n < n_steps; ++n) {
      const int h = step_head(n), q0 = step_q0(n);
      issue_slices(n);
      cp_async_commit();
      float pt[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[j][e] = dpt[j][e] = 0.f;
      for (int c = 0; c < NC; ++c) {
        const int i = n * NC + c;
        if (i + 1 < n_loads) issue_chunk(i + 1);  // its buffer was last read at load i - 1
        cp_async_commit();
        cp_async_wait<1>();  // load i (and, at c = 0, this step's slices) landed
        __syncthreads();
        const T* cc = chunk(i);
        // Sᵀ = K·(q·s)ᵀ and dPᵀ = V·dOᵀ for this warp's 16 kv rows.
        warp_mma<T, NQ, DS_CH, true, true>(pt, cc + warp * 16 * LDC, LDC,
                                           cc + 2 * DSB_BKV * LDC, LDC);
        warp_mma<T, NQ, DS_CH, true, true>(dpt, cc + (DSB_BKV + warp * 16) * LDC, LDC,
                                           cc + (2 * DSB_BKV + DSB_BQ) * LDC, LDC);
        __syncthreads();  // every warp is done with buffer i % 2
      }

      // Pᵀ = exp(Sᵀ − lse); tiles wholly inside the causal/window band skip
      // the per-element mask.
      const int kv_lo = k0 + warp * 16, p0 = q0 + off;  // p0: position of the tile's first row
      const bool full = q0 + DSB_BQ <= Sq && kv_lo + 15 < Skv &&
                        (!causal || (kv_lo + 15 <= p0 &&
                                     (window <= 0 || kv_lo > p0 + DSB_BQ - 1 - window)));
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool live =
              (full || attends_at(q0 + c, kv_row[e >> 1], Sq, Skv, off, causal, window)) &&
              sLse[c] > NEG_INF / 2;
          pt[j][e] = live ? expf(pt[j][e] - sLse[c]) : 0.f;
        }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          store_pair<T>(myP + (gr + 8 * i) * LDQ + 8 * j + 2 * t, pt[j][2 * i],
                        pt[j][2 * i + 1]);
      __syncwarp();
      warp_mma<T, NT, DSB_BQ, true, false>(dv, myP, LDQ, sdOg, LDG);  // dV_g += Pᵀ·dO_g

      // dSᵀ = Pᵀ∘(dPᵀ − delta), rounded to T like the TPU kernel's ds.
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 8 * j + 2 * t;
          store_pair<T>(mydS + (gr + 8 * i) * LDQ + c,
                        pt[j][2 * i] * (dpt[j][2 * i] - sDelta[c]),
                        pt[j][2 * i + 1] * (dpt[j][2 * i + 1] - sDelta[c + 1]));
        }
      if constexpr (DQ) {
        __syncthreads();  // dSᵀ of all four warps is in shared memory
      } else {
        __syncwarp();  // dK reads this warp's own dSᵀ rows only
      }
      warp_mma<T, NT, DSB_BQ, true, false>(dk, mydS, LDQ, sQg, LDG);  // dK_g += dSᵀ·(q·s)_g

      if constexpr (DQ) {
        // dQ_g += s · dS·K_g over this block's 64 kv rows, 32 of the warp's
        // columns at a time (beside dK and dV, 64 at once spilled); dS(q,
        // kv) = sdS[kv][q].
#pragma unroll 1
        for (int c = dq_c0; c < dq_c0 + 64; c += 32) {
          float dq[NT / 4][4];
#pragma unroll
          for (int j = 0; j < NT / 4; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
          warp_mma<T, NT / 4, DSB_BKV, false, false>(dq, sdS + dq_r0, LDQ, sKg + c, LDG);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int qr = q0 + dq_r0 + gr + 8 * i;
            if (qr >= Sq) continue;
            float* dst = dq_acc + (head_row(h) + qr) * D + col0 + c + 2 * t;
#pragma unroll
            for (int j = 0; j < NT / 4; ++j)
              atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                        make_float2(scale * dq[j][2 * i], scale * dq[j][2 * i + 1]));
          }
        }
      }
      __syncthreads();  // every warp is done with this step's slices, Pᵀ and dSᵀ
    }
  }

  // dk (still in the rotated frame) to its f32 scratch, dv to its layout;
  // dk and dv of kv rows no query sees (n_steps == 0) are zeros.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kv_row[i];
    if (r >= Skv) continue;
    float* dkr = dk_acc + (((size_t)b * (H / group) + kvh) * Skv + r) * D + col0 + 2 * t;
    T* dvr = dv_out + b * sdv.b + kvh * sdv.h + r * sdv.s + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<float2*>(dkr + 8 * j) = make_float2(dk[j][2 * i], dk[j][2 * i + 1]);
      store_pair<T>(dvr + 8 * j, dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <typename T>
int launch_bwd_dstream(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const void* lse, const void* cos, const void* sin,
                       void* dq, void* dk, void* dv, void* dq_acc, void* delta,
                       const long long* s, int B, int H, int KV, int Sq, int Skv, int D, int off,
                       int causal, int window, long long tstride, float scale, void* q_s,
                       void* k_rot, void* dk_acc, cudaStream_t stream) {
  auto at = [&](int i) { return Bhsd{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; };
  Bhsd sk = at(1);
  cudaError_t err = dstream_prep<T>(q, at(0), q_s, cos, sin, B, H, Sq, D, off, tstride, 1, scale,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  if (cos != nullptr) {
    if ((err = dstream_prep<T>(k, sk, k_rot, cos, sin, B, KV, Skv, D, 0, tstride, 0, 1.f,
                               stream)) != cudaSuccess)
      return (int)err;
    k = k_rot;
    sk = contiguous(KV, Skv, D);
  }
  const long long rows = (long long)B * H * Sq;
  if (dq != nullptr &&
      (err = cudaMemsetAsync(dq_acc, 0, rows * D * sizeof(float), stream)) != cudaSuccess)
    return (int)err;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<float*>(delta),
      at(3), at(4), H, Sq, D, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = dsb_smem_bytes<T>();
  const dim3 grid((Skv + DSB_BKV - 1) / DSB_BKV * (D / DS_GROUP), KV, B);
  auto main_kernel = [&](auto kernel) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, DS_THREADS, smem, stream>>>(
        static_cast<const T*>(q_s), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk_acc), static_cast<T*>(dv),
        static_cast<float*>(dq_acc), sk, at(2), at(4), at(7), H, H / KV, Sq, Skv, D, off,
        causal, window, scale);
    return cudaGetLastError();
  };
  err = dq == nullptr ? main_kernel(flash_bwd_dstream_kernel<T, false>)
                      : main_kernel(flash_bwd_dstream_kernel<T, true>);
  if (err != cudaSuccess) return (int)err;
  if (dq != nullptr &&
      (err = dstream_unrotate<T>(dq_acc, cos, sin, dq, at(5), B, H, Sq, D, off, tstride,
                                 stream)) != cudaSuccess)
    return (int)err;
  return (int)dstream_unrotate<T>(dk_acc, cos, sin, dk, at(6), B, KV, Skv, D, 0, tstride, stream);
}

}  // namespace dtt

// dtt_flash_bwd's operands (flash_bwd.cu) at a head dim D that is a multiple
// of 128, plus three scratches: q_s (B, H, Sq, D) of q's dtype (q rotated and
// scale-folded), k_rot (B, KV, Skv, D) of k's dtype with tables (null
// without), and dk_acc (B, KV, Skv, D) f32, all contiguous. With dq null
// only dk and dv are computed (K6; dq_acc unused) and delta is left for
// flash_bwd_dq_dstream.cu (K5). Returns a cudaError_t.
extern "C" int dtt_flash_bwd_dstream(const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, const void* lse,
                                     const void* cos, const void* sin, void* dq, void* dk,
                                     void* dv, void* dq_acc, void* delta,
                                     const long long* strides, int B, int H, int KV, int Sq,
                                     int Skv, int D, int is_bf16, int causal, int window,
                                     int q_pos_offset, long long tstride, float scale, void* q_s,
                                     void* k_rot, void* dk_acc, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dstream_args_ok(B, H, KV, Sq, Skv, D, cos, k_rot, q_pos_offset) || q_s == nullptr ||
      dk_acc == nullptr || (dq != nullptr && dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  return is_bf16
             ? launch_bwd_dstream<bf16>(q, k, v, out, dout, lse, cos, sin, dq, dk, dv, dq_acc,
                                        delta, strides, B, H, KV, Sq, Skv, D, q_pos_offset,
                                        causal, window, tstride, scale, q_s, k_rot, dk_acc, st)
             : launch_bwd_dstream<float>(q, k, v, out, dout, lse, cos, sin, dq, dk, dv, dq_acc,
                                         delta, strides, B, H, KV, Sq, Skv, D, q_pos_offset,
                                         causal, window, tstride, scale, q_s, k_rot, dk_acc, st);
}
