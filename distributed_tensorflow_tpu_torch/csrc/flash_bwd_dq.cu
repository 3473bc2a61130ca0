// Flash attention backward, dq half of the two-pass pair, on strided
// (B, H, S, D) operands, for Hopper.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_dq_kernel
// (K5), launched by _flash_backward when no q segmentation of the fused
// backward exists; its dk/dv half (K6, _flash_bwd_dkv_kernel) is the fused
// backward with dq null (flash_bwd_sm90.cu in bf16 at head_dim 64/128,
// flash_bwd.cu otherwise), which also writes the delta this kernel reads.
// p is recomputed from the saved logsumexp (zeroed where the row attended
// nothing), dS = p∘(dO·vᵀ − delta) rounded to the operand dtype, and
// dq = s·Σ dS·k over the kv tiles the row can see; dq is rotated back by the
// inverse rope at the row's position when the wrapper passes tables.
//
// Bound on this card: three tile products (q·kᵀ, dO·vᵀ, dS·k), 1.5x the
// forward's FLOPs — ~1.24e12 at the long-context call (B 3, S 8192, 16 heads
// of 128, causal, bf16) against ~0.3 GB moved, so the tensor cores bound it
// (about 1.25 ms at 989 TFLOP/s).
//
// Design: the TPU kernel carries dq in VMEM scratch across its sequential kv
// grid axis; here one block of 4 warps owns a 64-row q tile of one head and
// runs the kv loop itself, each warp keeping its 16 rows' dq in f32
// registers, so dq needs no atomics and no f32 scratch and is written once.
// The q tile is rotated (rope), scale-folded and rounded once in shared
// memory and dO stays beside it; kv tiles are double-buffered with cp.async
// (rotated on arrival under rope); each warp's dS tile goes through its own
// padded shared rows into the dS·K product. Products run on mma.sync (bf16)
// with ldmatrix fragments, the layout of flash_fwd.cu. kv tiles wholly
// outside the causal/window band are never visited, and the q tiles with the
// most work are scheduled first. GQA divides the head index by the group
// size for k/v. Instances: bf16 and f32 at head_dim 32, 64, 128 and 256; the
// bf16 calls at 64 and 128 run flash_bwd_dq_sm90.cu instead. At 256 each (q
// tile, head, batch) takes two blocks, each multiplying all of S and dP and
// accumulating half of dq's columns (kCols, flash_common.cuh; the rope pairs
// in one block), and f32 there takes 32-key tiles in one buffer, as q, dO
// and two buffers of 64-key tiles pass the 227 KB a block may have.
#include "flash_common.cuh"

namespace dtt {

constexpr int DQ_BQ = 64, DQ_THREADS = 128;

// The kv tile's keys, and its buffers (two: tile n + 1 loads while tile n
// multiplies).
template <typename T, int D>
constexpr int kDqBkv = sizeof(T) == 4 && D > 128 ? 32 : 64;
template <typename T, int D>
constexpr int kDqBufs = sizeof(T) == 4 && D > 128 ? 1 : 2;

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  constexpr int BKV = kDqBkv<T, D>;
  return sizeof(T) * ((2 * DQ_BQ + 2 * kDqBufs<T, D> * BKV) * (D + kPad<T>) +
                      4 * 16 * (BKV + kPad<T>));
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(DQ_THREADS, 2)
two_pass_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, const float* __restrict__ cos,
                   const float* __restrict__ sin, T* __restrict__ dq, Bhsd sq, Bhsd sk, Bhsd sv,
                   Bhsd sg, Bhsd sdq, int H, int group, int Sq, int Skv, int off, int causal,
                   int window, long long tstride, float scale) {
  constexpr int BKV = kDqBkv<T, D>, NBUF = kDqBufs<T, D>;
  constexpr int LD = D + kPad<T>, LDS = BKV + kPad<T>, NS = BKV / 8;
  constexpr int DV = kCols<D>, NT = DV / 8, SPLIT = D / DV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + DQ_BQ * LD;
  T* sKV = sdO + DQ_BQ * LD;  // NBUF buffers of [K tile | V tile]
  T* sdS = sKV + 2 * NBUF * BKV * LD;
  auto kv_buf = [&](int n) { return sKV + (n % NBUF) * 2 * BKV * LD; };

  const int num_q = (Sq + DQ_BQ - 1) / DQ_BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x / SPLIT) * DQ_BQ;
  const int c0 = (int)(blockIdx.x % SPLIT) * (DV / 2);  // this block's columns (block_col)
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  T* dqb = dq + b * sdq.b + h * sdq.h;
  // Rope tables are indexed by position: q row r sits at r + off, key row r at r.
  const float* cb = ROPE ? cos + b * tstride : nullptr;
  const float* sb = ROPE ? sin + b * tstride : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // This lane's rows' lse and delta; rows past Sq count as attending nothing.
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = ((size_t)b * H + h) * Sq + row[i];
    rl[i] = row[i] < Sq ? lse[r] : NEG_INF;
    rd[i] = row[i] < Sq ? delta[r] : 0.f;
  }

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + DQ_BQ, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / BKV * BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (n_tiles > 0) {
    // With two buffers the copy of kv tile n + 1 runs while tile n is
    // multiplied; with one it starts once every warp is done with tile n.
    auto issue_kv = [&](int n) {
      const int k0 = kv_begin + n * BKV;
      tile_issue<T, D, BKV, DQ_THREADS>(kv_buf(n), LD, kb, (int)sk.s, k0, Skv);
      tile_issue<T, D, BKV, DQ_THREADS>(kv_buf(n) + BKV * LD, LD, vb, (int)sv.s, k0, Skv);
      cp_async_commit();
    };
    tile_issue<T, D, DQ_BQ, DQ_THREADS>(sQ, LD, q + b * sq.b + h * sq.h, (int)sq.s, q0, Sq);
    tile_issue<T, D, DQ_BQ, DQ_THREADS>(sdO, LD, dout + b * sg.b + h * sg.h, (int)sg.s, q0, Sq);
    cp_async_commit();
    issue_kv(0);
    T* mydS = sdS + warp * 16 * LDS;

    for (int n = 0; n < n_tiles; ++n) {
      const int k0 = kv_begin + n * BKV;
      T* cK = kv_buf(n);
      const T* cV = cK + BKV * LD;
      if (NBUF == 2 && n + 1 < n_tiles) {
        issue_kv(n + 1);  // its buffers were last read before the previous barrier
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      if (n == 0) tile_finish<T, D, DQ_BQ, DQ_THREADS>(sQ, LD, q0, Sq, cb, sb, true, scale, off);
      if constexpr (ROPE)
        tile_finish<T, D, BKV, DQ_THREADS>(cK, LD, k0, Skv, cb, sb, false, 1.f, 0);
      __syncthreads();

      // S = (q·s)·Kᵀ and dP = dO·Vᵀ for this warp's 16 rows.
      float sc[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      warp_mma<T, NS, D, true, true>(sc, sQ + warp * 16 * LD, LD, cK, LD);
      warp_mma<T, NS, D, true, true>(dp, sdO + warp * 16 * LD, LD, cV, LD);

      // Tiles wholly inside the causal/window band skip the per-element mask.
      const int p_lo = q0 + warp * 16 + off;  // position of the warp's first row
      const bool full = k0 + BKV <= Skv &&
                        (!causal || (k0 + BKV - 1 <= p_lo &&
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
          store_pair<T>(mydS + (g + 8 * i) * LDS + 8 * j + 2 * t, ds[0], ds[1]);
        }
      __syncwarp();
      warp_mma_cols<T, NT, BKV, true, D>(acc, mydS, LDS, cK, LD, c0);  // dQ += dS·K
      __syncthreads();  // every warp is done with this tile's buffers
      if (NBUF == 1 && n + 1 < n_tiles) issue_kv(n + 1);
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= scale;
  // dq rotates back by the inverse rope at its rows' positions; columns i and
  // i + D/2 are fragments j and j + NT/2 of the same lane (block_col).
  if constexpr (ROPE) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e >> 1];
      if (r >= Sq) continue;
      const size_t at = (size_t)(r + off) * (D / 2);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int i = c0 + 8 * j + 2 * t + (e & 1);
        const float c = cb[at + i], s = sb[at + i];
        const float x1 = acc[j][e], x2 = acc[j + NT / 2][e];
        acc[j][e] = x1 * c + x2 * s;
        acc[j + NT / 2][e] = x2 * c - x1 * s;
      }
    }
  }
  // Rows that see no key (n_tiles == 0) get zeros.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store_pair<T>(dqb + row[i] * sdq.s + block_col<D>(j, c0, t), acc[j][2 * i],
                    acc[j][2 * i + 1]);
  }
}

template <typename T, int D, bool ROPE>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* cos, const void* sin, void* dq, const long long* st,
              int B, int H, int KV, int Sq, int Skv, int off, int causal, int window,
              long long tstride, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<T, D>();
  cudaError_t err = set_smem(two_pass_dq_kernel<T, D, ROPE>, smem);
  if (err != cudaSuccess) return (int)err;
  auto at = [&](int i) { return Bhsd{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ * (D / kCols<D>), H, B);
  two_pass_dq_kernel<T, D, ROPE><<<grid, DQ_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<T*>(dq), at(0), at(1), at(2), at(3), at(4), H,
      H / KV, Sq, Skv, off, causal, window, tstride, scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// q, dout, dq (B, H, Sq, D) and k, v (B, KV, Skv, D), bf16|f32, each with
// its own (b, h, s) element strides in `strides` (q, k, v, dout, dq: 15
// values) and a contiguous last dimension; lse and delta (B, H, Sq) f32
// contiguous (delta as dtt_flash_bwd writes it). Query head h reads kv head
// h / (H / KV); q_pos_offset is the position of query row 0; cos/sin as in
// dtt_flash_fwd. Returns a cudaError_t.
extern "C" int dtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* cos,
                                const void* sin, void* dq, const long long* strides, int B,
                                int H, int KV, int Sq, int Skv, int D, int is_bf16, int causal,
                                int window, int q_pos_offset, long long tstride, float scale,
                                void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (q_pos_offset < 0 || q_pos_offset + Sq > Skv))
    return (int)cudaErrorInvalidValue;
#define DTT_DQ(T, DIM)                                                                          \
  return cos != nullptr                                                                         \
             ? launch_dq<T, DIM, true>(q, k, v, dout, lse, delta, cos, sin, dq, strides, B, H,  \
                                       KV, Sq, Skv, q_pos_offset, causal, window, tstride,      \
                                       scale, st)                                               \
             : launch_dq<T, DIM, false>(q, k, v, dout, lse, delta, cos, sin, dq, strides, B, H, \
                                        KV, Sq, Skv, q_pos_offset, causal, window, tstride,     \
                                        scale, st)
  if (is_bf16 && D == 32) DTT_DQ(bf16, 32);
  if (is_bf16 && D == 64) DTT_DQ(bf16, 64);
  if (is_bf16 && D == 128) DTT_DQ(bf16, 128);
  if (is_bf16 && D == 256) DTT_DQ(bf16, 256);
  if (!is_bf16 && D == 32) DTT_DQ(float, 32);
  if (!is_bf16 && D == 64) DTT_DQ(float, 64);
  if (!is_bf16 && D == 128) DTT_DQ(float, 128);
  if (!is_bf16 && D == 256) DTT_DQ(float, 256);
#undef DTT_DQ
  return (int)cudaErrorInvalidValue;
}
