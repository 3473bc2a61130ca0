// Flash attention backward on strided (B, H, S, D) operands, for Hopper.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_fused_kernel,
// the one Pallas backward body behind three launch sites, and
// _flash_bwd_dkv_kernel:
//   * _flash_backward_qkv (K2): the packed qkv projection's backward, with
//     dq/dk rotated back by the inverse rope and the kv grads of a GQA group
//     summed into their shared kv head;
//   * _flash_backward_fused (K4): q (B, H, Sq, D) against k/v (B, H, Skv, D)
//     with end-aligned causal masking; the caller's q_pos_offset places q row
//     0 in the key sequence, so a call on a q segment of a longer sequence
//     computes that segment's dq and its share of dk/dv, as the TPU kernel's
//     segmented calls do.
//   * _flash_backward_fused_bshd (K8): the same on the (B, S, H, D)
//     activation layout, one call or one per q segment; the packed long-
//     sequence backward hands it head views of qkv (GQA and rope as for K2,
//     the rope tables read at each segment's positions).
//   * _flash_backward's _flash_bwd_dkv_kernel (K6), the dk/dv half of the
//     two-pass pair: the same kernel with the dq product compiled out (dq
//     null); its dq half, K5, is flash_bwd_dq.cu, which reads the delta this
//     launch writes.
// p is recomputed from the saved logsumexp (and zeroed on rows whose lse says
// they attended nothing: there NEG_INF is finite, so exp(logit - lse) would
// be 1), delta = rowsum(dO∘O), dv = pᵀ·dO, dS = p∘(dO·vᵀ − delta),
// dq = s·dS·k, dk = dSᵀ·(q·s).
//
// Bound on this card: five tile products against the forward's two, ~5.2e11
// FLOPs at the flagship call (B 12, S 2048, 16 heads of 128, causal, bf16)
// against ~0.6-0.8 GB moved — the tensor cores bound it (about 0.52 ms at
// 989 TFLOP/s). K6 (dq null) does four of the five products.
//
// Design: the TPU kernel walks its grid in order and keeps dq for the whole
// sequence in VMEM; blocks on Hopper run in no order, so nothing carries
// between them. Three launches instead:
//   1. delta pre-pass: one warp per (b, h, s) row, rowsum(dO∘O) in f32.
//   2. main kernel: one block of 4 warps per (64-row kv tile, kv head,
//      batch); each warp owns 16 kv rows and keeps their dk and dv in f32
//      registers while the block loops over every q head of the GQA group and
//      over the 32-row q tiles from the causal diagonal to the window's end,
//      so the group sum happens in registers and dk/dv are written once. Sᵀ,
//      Pᵀ and dSᵀ are computed kv-rows-major, so dV += Pᵀ·dO and dK += dSᵀ·Q
//      need no transpose; dQ += s·dS·K reads the block's dSᵀ tile from shared
//      memory transposed and is added with float2 atomics into a zeroed f32
//      (B, H, Sq, D) scratch the wrapper allocated.
//   3. dq pass: rotate the summed f32 dq back (rope) and cast it into the
//      caller's layout.
// Products run on mma.sync (bf16) with ldmatrix fragments from padded shared
// memory; each step's q-side tiles are double-buffered with cp.async. Every
// operand is read or written through its own (b, h, s) strides, so neither
// the packed projection nor the tp block's head-transposed views need a
// copy; rope is a template parameter. Instances: bf16 and f32 at head_dim
// 32, 64, 128 and 256. The bf16 calls at 64 and 128, K6 included, run
// flash_bwd_sm90.cu instead, the same design on wgmma; this kernel keeps
// f32, head_dim 32 and head_dim 256. At 256 a warp's dK and dV rows would
// take 256 f32 registers a thread, so each (kv tile, kv head, batch) takes
// two blocks: each multiplies all of Sᵀ and dPᵀ and accumulates half of the
// dK, dV and dQ columns (kCols, flash_common.cuh), the rope pairs of dK in
// one block; f32 at 256 keeps one q-side buffer, as two pass the 227 KB a
// block may have.
#include "flash_bwd_passes.cuh"

namespace dtt {

constexpr int BWD_BKV = 64, BWD_BQ = 32, BWD_THREADS = 128;

// q-side (q, dO, lse, delta) buffers: two, so that step n + 1 loads while
// step n multiplies.
template <typename T, int D>
constexpr int kBwdBufs = sizeof(T) == 4 && D > 128 ? 1 : 2;

template <typename T, int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * 4 * BWD_BQ +
         sizeof(T) * ((2 * BWD_BKV + 2 * kBwdBufs<T, D> * BWD_BQ) * (D + kPad<T>) +
                      (4 * 16 + BWD_BKV) * (BWD_BQ + kPad<T>));
}

template <typename T, int D, bool ROPE, bool DQ>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ cos,
                 const float* __restrict__ sin, T* __restrict__ dk_out, T* __restrict__ dv_out,
                 float* __restrict__ dq_acc, BwdStrides st, int H, int group, int Sq, int Skv,
                 int off, int causal, int window, long long tstride, float scale) {
  constexpr int LD = D + kPad<T>, LDQ = BWD_BQ + kPad<T>, NQ = BWD_BQ / 8;
  constexpr int DV = kCols<D>, NT = DV / 8, SPLIT = D / DV, NBUF = kBwdBufs<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sStats = reinterpret_cast<float*>(smem);  // NBUF buffers of [lse | delta] rows
  T* sK = reinterpret_cast<T*>(sStats + 4 * BWD_BQ);
  T* sV = sK + BWD_BKV * LD;
  T* sQdO = sV + BWD_BKV * LD;  // NBUF buffers of [q tile | dO tile]
  T* sP = sQdO + 2 * NBUF * BWD_BQ * LD;
  T* sdS = sP + 4 * 16 * LDQ;

  // Low tiles first: under causal masking they see most q.
  const int k0 = (int)(blockIdx.x / SPLIT) * BWD_BKV;
  const int c0 = (int)(blockIdx.x % SPLIT) * (DV / 2);  // this block's columns (block_col)
  const int kvh = blockIdx.y, b = blockIdx.z;
  const T* kb = k + b * st.k.b + kvh * st.k.h;
  const T* vb = v + b * st.v.b + kvh * st.v.h;
  T* dkb = dk_out + b * st.dk.b + kvh * st.dk.h;
  T* dvb = dv_out + b * st.dv.b + kvh * st.dv.h;
  // Rope tables are indexed by position: q row r sits at r + off, key row r at r.
  const float* cb = ROPE ? cos + b * tstride : nullptr;
  const float* sb = ROPE ? sin + b * tstride : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kv_row[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  // q rows whose positions (row + off) can see this kv tile.
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = min(Sq, max(0, k0 - off)) / BWD_BQ * BWD_BQ;
    if (window > 0) q_end = min(Sq, max(0, k0 + BWD_BKV - 1 + window - off));
  }
  // Steps walk (q head of the group, q tile).
  const int n_q = q_end > q_begin ? (q_end - q_begin + BWD_BQ - 1) / BWD_BQ : 0;
  const int n_steps = group * n_q;
  // This head's rows of lse, delta and dq_acc.
  auto head_row = [&](int h) { return ((size_t)b * H + h) * Sq; };

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (n_steps > 0) {
    // The copy of step n + 1's q, dO, lse and delta runs while step n is
    // multiplied.
    auto q_buf = [&](int n) { return sQdO + (n % NBUF) * 2 * BWD_BQ * LD; };
    auto stats_buf = [&](int n) { return sStats + (n % NBUF) * 2 * BWD_BQ; };
    auto issue_q = [&](int n) {
      const int h = kvh * group + n / n_q, q0 = q_begin + (n % n_q) * BWD_BQ;
      tile_issue<T, D, BWD_BQ, BWD_THREADS>(q_buf(n), LD, q + b * st.q.b + h * st.q.h,
                                            (int)st.q.s, q0, Sq);
      tile_issue<T, D, BWD_BQ, BWD_THREADS>(q_buf(n) + BWD_BQ * LD, LD,
                                            dout + b * st.g.b + h * st.g.h, (int)st.g.s, q0,
                                            Sq);
      float* sst = stats_buf(n);
      for (int i = threadIdx.x; i < 2 * BWD_BQ; i += blockDim.x) {
        const int qr = q0 + i % BWD_BQ;
        const float* from = (i < BWD_BQ ? lse : delta) + head_row(h) + qr;
        if (qr < Sq) cp_async4(sst + i, from);
        else sst[i] = 0.f;
      }
      cp_async_commit();
    };
    tile_issue<T, D, BWD_BKV, BWD_THREADS>(sK, LD, kb, (int)st.k.s, k0, Skv);
    tile_issue<T, D, BWD_BKV, BWD_THREADS>(sV, LD, vb, (int)st.v.s, k0, Skv);
    cp_async_commit();
    issue_q(0);

    T* myP = sP + warp * 16 * LDQ;
    T* mydS = sdS + warp * 16 * LDQ;
    // dQ split: warp w adds q rows [16·(w%2), +16) x the block's columns at
    // (w/2)·D/2 + c0, DV/2 of them.
    const int dq_r0 = (warp & 1) * 16, dq_c0 = (warp >> 1) * (D / 2) + c0;

    for (int n = 0; n < n_steps; ++n) {
      const int h = kvh * group + n / n_q, q0 = q_begin + (n % n_q) * BWD_BQ;
      T* sQ = q_buf(n);
      const T* sdO = sQ + BWD_BQ * LD;
      const float* sLse = stats_buf(n);
      const float* sDelta = sLse + BWD_BQ;
      if (NBUF == 2 && n + 1 < n_steps) {
        issue_q(n + 1);  // its buffers were last read before the previous barrier
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      if constexpr (ROPE) {
        if (n == 0)
          tile_finish<T, D, BWD_BKV, BWD_THREADS>(sK, LD, k0, Skv, cb, sb, false, 1.f, 0);
      }
      tile_finish<T, D, BWD_BQ, BWD_THREADS>(sQ, LD, q0, Sq, cb, sb, true, scale, off);
      __syncthreads();

      // Sᵀ = K·Qᵀ for this warp's 16 kv rows, then Pᵀ = exp(Sᵀ − lse).
      float pt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) pt[j][0] = pt[j][1] = pt[j][2] = pt[j][3] = 0.f;
      warp_mma<T, NQ, D, true, true>(pt, sK + warp * 16 * LD, LD, sQ, LD);
      // Tiles wholly inside the causal/window band skip the per-element mask.
      const int kv_lo = k0 + warp * 16, p0 = q0 + off;  // p0: position of the tile's first row
      const bool full = q0 + BWD_BQ <= Sq && kv_lo + 15 < Skv &&
                        (!causal || (kv_lo + 15 <= p0 &&
                                     (window <= 0 || kv_lo > p0 + BWD_BQ - 1 - window)));
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
          store_pair<T>(myP + (g + 8 * i) * LDQ + 8 * j + 2 * t, pt[j][2 * i], pt[j][2 * i + 1]);
      __syncwarp();
      warp_mma_cols<T, NT, BWD_BQ, true, D>(dv, myP, LDQ, sdO, LD, c0);  // dV += Pᵀ·dO

      // dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − delta), rounded to T like the TPU kernel's ds.
      float dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      warp_mma<T, NQ, D, true, true>(dpt, sV + warp * 16 * LD, LD, sdO, LD);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 8 * j + 2 * t;
          store_pair<T>(mydS + (g + 8 * i) * LDQ + c,
                        pt[j][2 * i] * (dpt[j][2 * i] - sDelta[c]),
                        pt[j][2 * i + 1] * (dpt[j][2 * i + 1] - sDelta[c + 1]));
        }
      if constexpr (DQ) {
        __syncthreads();  // dSᵀ of all four warps is in shared memory
      } else {
        __syncwarp();  // dK reads this warp's own dSᵀ rows only
      }

      warp_mma_cols<T, NT, BWD_BQ, true, D>(dk, mydS, LDQ, sQ, LD, c0);  // dK += dSᵀ·(q·s)

      if constexpr (DQ) {
        // dQ += s · dS·K over this block's 64 kv rows; dS(q, kv) = sdS[kv][q].
        float dq[NT / 2][4];
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
        warp_mma<T, NT / 2, BWD_BKV, false, false>(dq, sdS + dq_r0, LDQ, sK + dq_c0, LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qr = q0 + dq_r0 + g + 8 * i;
          if (qr >= Sq) continue;
          float* dst = dq_acc + (head_row(h) + qr) * D + dq_c0 + 2 * t;
#pragma unroll
          for (int j = 0; j < NT / 2; ++j)
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                      make_float2(scale * dq[j][2 * i], scale * dq[j][2 * i + 1]));
        }
      }
      __syncthreads();  // every warp is done with this step's buffers
      if (NBUF == 1 && n + 1 < n_steps) issue_q(n + 1);
    }
  }

  // dk rotates back by the inverse rope at its kv rows; columns i and i + D/2
  // are fragments j and j + NT/2 of the same lane (block_col).
  if constexpr (ROPE) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = kv_row[e >> 1];
      if (r >= Skv) continue;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int i = c0 + 8 * j + 2 * t + (e & 1);
        const float c = cb[(size_t)r * (D / 2) + i], s = sb[(size_t)r * (D / 2) + i];
        const float x1 = dk[j][e], x2 = dk[j + NT / 2][e];
        dk[j][e] = x1 * c + x2 * s;
        dk[j + NT / 2][e] = x2 * c - x1 * s;
      }
    }
  }
  // dk and dv of kv rows no query sees (n_steps == 0) are zeros.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kv_row[i];
    if (r >= Skv) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = block_col<D>(j, c0, t);
      store_pair<T>(dkb + r * st.dk.s + col, dk[j][2 * i], dk[j][2 * i + 1]);
      store_pair<T>(dvb + r * st.dv.s + col, dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <typename T, int D, bool ROPE>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, const void* cos, const void* sin, void* dq, void* dk, void* dv,
               void* dq_acc, void* delta, const long long* s, int B, int H, int KV, int Sq,
               int Skv, int off, int causal, int window, long long tstride, float scale,
               cudaStream_t stream) {
  auto at = [&](int i) { return Bhsd{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; };
  const BwdStrides st{at(0), at(1), at(2), at(4), at(6), at(7)};
  const size_t smem = bwd_smem_bytes<T, D>();
  const dim3 grid((Skv + BWD_BKV - 1) / BWD_BKV * (D / kCols<D>), KV, B);
  auto main_kernel = [&](auto kernel) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, BWD_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const float*>(cos),
        static_cast<const float*>(sin), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float*>(dq_acc), st, H, H / KV, Sq, Skv, off, causal, window, tstride,
        scale);
    return cudaGetLastError();
  };
  auto launch_main = [&]() {
    return dq == nullptr ? main_kernel(flash_bwd_kernel<T, D, ROPE, false>)
                         : main_kernel(flash_bwd_kernel<T, D, ROPE, true>);
  };
  return run_bwd<T, ROPE>(launch_main, out, dout, cos, sin, dq, dq_acc, delta, s, B, H, Sq, D,
                          off, tstride, stream);
}

}  // namespace dtt

// q, out, dout, dq (B, H, Sq, D) and k, v, dk, dv (B, KV, Skv, D), bf16|f32,
// each with its own (b, h, s) element strides in `strides` (in that order:
// q, k, v, out, dout, dq, dk, dv — 24 values) and a contiguous last
// dimension; lse (B, H, Sq) f32 contiguous; scratch: dq_acc (B, H, Sq, D)
// f32 and delta (B, H, Sq) f32. Query head h reads kv head h / (H / KV),
// and dk/dv sum over each kv head's group. q_pos_offset is the position of
// query row 0; cos/sin as in dtt_flash_fwd. With dq null only dk and dv are
// computed (K6; dq_acc unused) and delta is left for flash_bwd_dq.cu (K5).
// Returns a cudaError_t.
extern "C" int dtt_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const void* lse, const void* cos,
                             const void* sin, void* dq, void* dk, void* dv, void* dq_acc,
                             void* delta, const long long* strides, int B, int H, int KV, int Sq,
                             int Skv, int D, int is_bf16, int causal, int window,
                             int q_pos_offset, long long tstride, float scale, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (q_pos_offset < 0 || q_pos_offset + Sq > Skv))
    return (int)cudaErrorInvalidValue;
#define DTT_BWD(T, DIM)                                                                          \
  return cos != nullptr                                                                          \
             ? launch_bwd<T, DIM, true>(q, k, v, out, dout, lse, cos, sin, dq, dk, dv, dq_acc,   \
                                        delta, strides, B, H, KV, Sq, Skv, q_pos_offset, causal, \
                                        window, tstride, scale, st)                              \
             : launch_bwd<T, DIM, false>(q, k, v, out, dout, lse, cos, sin, dq, dk, dv, dq_acc,  \
                                         delta, strides, B, H, KV, Sq, Skv, q_pos_offset,        \
                                         causal, window, tstride, scale, st)
  if (is_bf16 && D == 32) DTT_BWD(bf16, 32);
  if (is_bf16 && D == 64) DTT_BWD(bf16, 64);
  if (is_bf16 && D == 128) DTT_BWD(bf16, 128);
  if (is_bf16 && D == 256) DTT_BWD(bf16, 256);
  if (!is_bf16 && D == 32) DTT_BWD(float, 32);
  if (!is_bf16 && D == 64) DTT_BWD(float, 64);
  if (!is_bf16 && D == 128) DTT_BWD(float, 128);
  if (!is_bf16 && D == 256) DTT_BWD(float, 256);
#undef DTT_BWD
  return (int)cudaErrorInvalidValue;
}
