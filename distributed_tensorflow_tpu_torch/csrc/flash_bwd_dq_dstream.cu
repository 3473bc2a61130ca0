// Flash attention backward, dq half of the two-pass pair, for head dims
// above 256 on strided (B, H, S, D) operands, D a multiple of 128 taken at
// run time, for Hopper.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_dq_kernel
// (K5) at any head dim, launched by _flash_backward when no q segmentation
// of the fused backward exists — at head_dim 512 that is every sequence of
// 1024 rows or more, since one f32 dq row and its delta take 2,560 bytes of
// the 2 MiB gate (819 rows, under the gate's 1024-row block). Its dk/dv half
// (K6) is flash_bwd_dstream.cu with dq null, which writes the delta read
// here.
//
// Bound on this card: three tile products (q·kᵀ, dO·vᵀ, dS·k), 1.5x the
// forward's FLOPs — ~3.1e11 at the head_dim 512 call of the trainer (B 12,
// S 2048, 4 heads of 512, causal, bf16) against ~0.4 GB moved, so the tensor
// cores bound it (about 0.31 ms at 989 TFLOP/s). Each of the D/128 column
// groups recomputes S and dP over the whole of D, so the kernel does (2·NG +
// 1) / 3 times the minimal work: 3x at D 512.
//
// Design: one block of 4 warps per (64-row q tile, head, batch, column group
// g of 128 columns), each warp owning 16 q rows, the kv loop inside the
// block. For each 64-key kv tile S = (q·s)·kᵀ and dP = dO·vᵀ are summed over
// D in 64-column chunks of q, dO, k and v streamed through two shared
// buffers by cp.async (chunk i + 1 loads while chunk i multiplies); then p
// from the saved lse (zeroed where the row attended nothing), dS = p∘(dP −
// delta) rounded to the operand dtype, and dq_g += dS·K_g over group g's
// columns of k (loaded beside the first chunk) in f32 registers. dq is
// written once, scaled, to an f32 scratch, and the dq pass of
// flash_bwd_passes.cuh rotates it back (rope) and casts it into the caller's
// layout; q arrives rotated and scale-folded, and k rotated, from the prepare
// pass (flash_dstream.cuh). Products run on mma.sync (bf16) with ldmatrix
// fragments, FMAs for f32. Simple first: no wgmma, TMA or warp
// specialisation.
#include "flash_dstream.cuh"

namespace dtt {

constexpr int DSQ_BQ = 64, DSQ_BKV = 64;

template <typename T>
constexpr size_t dsq_smem_bytes() {
  return sizeof(T) * (2 * (2 * DSQ_BQ + 2 * DSQ_BKV) * (DS_CH + kPad<T>) +
                      DSQ_BKV * (DS_GROUP + kPad<T>) + DSQ_BQ * (DSQ_BKV + kPad<T>));
}

template <typename T>
__global__ void __launch_bounds__(DS_THREADS)
flash_bwd_dq_dstream_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq_acc, Bhsd sk, Bhsd sv, Bhsd sg, int H,
                            int group, int Sq, int Skv, int D, int off, int causal, int window,
                            float scale) {
  constexpr int LDC = DS_CH + kPad<T>, LDG = DS_GROUP + kPad<T>, LDS = DSQ_BKV + kPad<T>;
  constexpr int NS = DSQ_BKV / 8, NT = DS_GROUP / 8;
  constexpr int CHUNK = (2 * DSQ_BQ + 2 * DSQ_BKV) * LDC;  // [q_c | dO_c | K_c | V_c]
  extern __shared__ __align__(16) unsigned char smem[];
  T* sC = reinterpret_cast<T*>(smem);  // two chunk buffers
  T* sKg = sC + 2 * CHUNK;             // the kv tile's K rows, group g's columns
  T* sdS = sKg + DSQ_BKV * LDG;
  auto chunk = [&](int i) { return sC + (i & 1) * CHUNK; };

  const int NG = D / DS_GROUP, NC = D / DS_CH;
  const int num_q = (Sq + DSQ_BQ - 1) / DSQ_BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x / NG) * DSQ_BQ;
  const int g = (int)blockIdx.x % NG, col0 = g * DS_GROUP;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const size_t head_row = ((size_t)b * H + h) * Sq;
  const T* qb = qs + head_row * D;  // contiguous, from the prepare pass
  const T* gb = dout + b * sg.b + h * sg.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + gr, q0 + warp * 16 + gr + 8};
  // This lane's rows' lse and delta; rows past Sq count as attending nothing.
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = row[i] < Sq ? lse[head_row + row[i]] : NEG_INF;
    rd[i] = row[i] < Sq ? delta[head_row + row[i]] : 0.f;
  }

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + DSQ_BQ, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / DSQ_BKV * DSQ_BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + DSQ_BKV - 1) / DSQ_BKV : 0;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (n_tiles > 0) {
    // Load i of the flat sequence (kv tile i / NC, D chunk i % NC): q, dO, K
    // and V chunks into buffer i % 2.
    const int n_loads = n_tiles * NC;
    auto issue_chunk = [&](int i) {
      const int c = (i % NC) * DS_CH, k0 = kv_begin + (i / NC) * DSQ_BKV;
      T* dst = chunk(i);
      rows_issue<T, DS_CH, DSQ_BQ>(dst, LDC, qb + c, D, q0, Sq);
      rows_issue<T, DS_CH, DSQ_BQ>(dst + DSQ_BQ * LDC, LDC, gb + c, sg.s, q0, Sq);
      rows_issue<T, DS_CH, DSQ_BKV>(dst + 2 * DSQ_BQ * LDC, LDC, kb + c, sk.s, k0, Skv);
      rows_issue<T, DS_CH, DSQ_BKV>(dst + (2 * DSQ_BQ + DSQ_BKV) * LDC, LDC, vb + c, sv.s, k0,
                                    Skv);
    };
    issue_chunk(0);
    cp_async_commit();
    T* mydS = sdS + warp * 16 * LDS;

    for (int n = 0; n < n_tiles; ++n) {
      const int k0 = kv_begin + n * DSQ_BKV;
      // K's rows of this tile, group g's columns: sKg was last read before the
      // previous tile's closing barrier.
      rows_issue<T, DS_GROUP, DSQ_BKV>(sKg, LDG, kb + col0, sk.s, k0, Skv);
      cp_async_commit();
      float sc[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      for (int c = 0; c < NC; ++c) {
        const int i = n * NC + c;
        if (i + 1 < n_loads) issue_chunk(i + 1);  // its buffer was last read at load i - 1
        cp_async_commit();
        cp_async_wait<1>();  // load i (and, at c = 0, this tile's K columns) landed
        __syncthreads();
        const T* cc = chunk(i);
        // S = (q·s)·Kᵀ and dP = dO·Vᵀ for this warp's 16 rows.
        warp_mma<T, NS, DS_CH, true, true>(sc, cc + warp * 16 * LDC, LDC,
                                           cc + 2 * DSQ_BQ * LDC, LDC);
        warp_mma<T, NS, DS_CH, true, true>(dp, cc + (DSQ_BQ + warp * 16) * LDC, LDC,
                                           cc + (2 * DSQ_BQ + DSQ_BKV) * LDC, LDC);
        __syncthreads();  // every warp is done with buffer i % 2
      }

      // Tiles wholly inside the causal/window band skip the per-element mask.
      const int p_lo = q0 + warp * 16 + off;  // position of the warp's first row
      const bool full = k0 + DSQ_BKV <= Skv &&
                        (!causal || (k0 + DSQ_BKV - 1 <= p_lo &&
                                     (window <= 0 || k0 > p_lo + 15 - window)));
      // dS = P∘(dP − delta), rounded to T like the TPU kernel's ds.
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * i + c;
            const bool live = (full || attends_at(row[i], k0 + 8 * j + 2 * t + c, Sq, Skv, off,
                                                  causal, window)) &&
                              rl[i] > NEG_INF / 2;
            const float p = live ? expf(sc[j][e] - rl[i]) : 0.f;
            ds[c] = p * (dp[j][e] - rd[i]);
          }
          store_pair<T>(mydS + (gr + 8 * i) * LDS + 8 * j + 2 * t, ds[0], ds[1]);
        }
      __syncwarp();
      warp_mma<T, NT, DSQ_BKV, true, false>(acc, mydS, LDS, sKg, LDG);  // dQ_g += dS·K_g
      __syncthreads();  // every warp is done with sKg
    }
  }

  // Rows that see no key (n_tiles == 0) get zeros.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    float* dst = dq_acc + (head_row + row[i]) * D + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(scale * acc[j][2 * i], scale * acc[j][2 * i + 1]);
  }
}

template <typename T>
int launch_dq_dstream(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* cos, const void* sin,
                      void* dq, const long long* st, int B, int H, int KV, int Sq, int Skv, int D,
                      int off, int causal, int window, long long tstride, float scale, void* q_s,
                      void* k_rot, void* dq_acc, cudaStream_t stream) {
  auto at = [&](int i) { return Bhsd{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
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
  const size_t smem = dsq_smem_bytes<T>();
  if ((err = set_smem(flash_bwd_dq_dstream_kernel<T>, smem)) != cudaSuccess) return (int)err;
  const dim3 grid((Sq + DSQ_BQ - 1) / DSQ_BQ * (D / DS_GROUP), H, B);
  flash_bwd_dq_dstream_kernel<T><<<grid, DS_THREADS, smem, stream>>>(
      static_cast<const T*>(q_s), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc), sk, at(2), at(3), H, H / KV,
      Sq, Skv, D, off, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)dstream_unrotate<T>(dq_acc, cos, sin, dq, at(4), B, H, Sq, D, off, tstride, stream);
}

}  // namespace dtt

// dtt_flash_bwd_dq's operands (flash_bwd_dq.cu) at a head dim D that is a
// multiple of 128, plus three contiguous scratches: q_s (B, H, Sq, D) of q's
// dtype (q rotated and scale-folded), k_rot (B, KV, Skv, D) of k's dtype
// with tables (null without), and dq_acc (B, H, Sq, D) f32. Returns a
// cudaError_t.
extern "C" int dtt_flash_bwd_dq_dstream(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* cos, const void* sin, void* dq,
                                        const long long* strides, int B, int H, int KV, int Sq,
                                        int Skv, int D, int is_bf16, int causal, int window,
                                        int q_pos_offset, long long tstride, float scale,
                                        void* q_s, void* k_rot, void* dq_acc, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dstream_args_ok(B, H, KV, Sq, Skv, D, cos, k_rot, q_pos_offset) || q_s == nullptr ||
      dq_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  return is_bf16
             ? launch_dq_dstream<bf16>(q, k, v, dout, lse, delta, cos, sin, dq, strides, B, H, KV,
                                       Sq, Skv, D, q_pos_offset, causal, window, tstride, scale,
                                       q_s, k_rot, dq_acc, st)
             : launch_dq_dstream<float>(q, k, v, dout, lse, delta, cos, sin, dq, strides, B, H,
                                        KV, Sq, Skv, D, q_pos_offset, causal, window, tstride,
                                        scale, q_s, k_rot, dq_acc, st);
}
