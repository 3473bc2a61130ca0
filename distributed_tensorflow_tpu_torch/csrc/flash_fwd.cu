// Flash attention forward on strided (B, H, S, D) operands, for Hopper.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_kernel, the one
// Pallas forward body behind two launch sites:
//   * _flash_forward_qkv (K1): self-attention on the packed qkv projection,
//     with GQA and the split-half rope rotation applied to the q/k tiles on
//     load. The wrapper hands q, k and v over as head-transposed views of
//     qkv's column sections and out as a view of (B, S, H·D).
//   * _flash_forward (K3): q (B, H, Sq, D) against k/v (B, H, Skv, D), rope
//     and kv-head repetition done by the caller; causal masking end-aligned
//     (query row i sits at position i + off, off = Skv - Sq unless the caller
//     passes one), so Sq != Skv and q segments are covered.
//   * _flash_forward_bshd (K7): the same on the (B, S, H, D) activation
//     layout, which the wrapper hands over as head-transposed views.
// Online softmax with an optional sliding window (keys in [p - window + 1,
// p]) or no mask at all; out in the input dtype, the row logsumexp in f32.
// A row with no attended key gets out 0 and lse NEG_INF + log(1e-30), as the
// TPU kernel writes them.
//
// Bound on this card: at the flagship call (B 12, S 2048, 16 heads of 128,
// causal, bf16) the work is ~2.1e11 FLOPs against ~0.4 GB moved, so the
// tensor cores bound it (about 0.21 ms at 989 TFLOP/s); only the causal half
// of the tiles is ever loaded or multiplied.
//
// Design: one block of 4 warps per (64-row q tile, head, batch), each warp
// owning 16 q rows; the q tile is rotated (rope), scale-folded and rounded
// once in shared memory, the kv loop runs inside the block with the running
// max, denominator and accumulator in f32 registers, kv tiles are
// double-buffered with cp.async (rotated on arrival under rope), and
// fragments come from padded shared memory by ldmatrix into mma.sync (bf16;
// FMAs for f32). Each operand is read through its own (b, h, s) element
// strides with a contiguous last dimension, so neither layout needs a copy:
// GQA divides the head index by the group size for k/v. Rope is a template
// parameter, so a rope-free call carries none of its registers. kv tiles
// wholly outside the causal/window band are never visited, and the q tiles
// with the most work are scheduled first. TMA, wgmma and warp specialisation
// are later work. Instances: bf16 and f32 at head_dim 32, 64, 128 and 256;
// the bf16 calls at 64 and 128 run flash_fwd_sm90.cu instead. At 256 a
// thread's 128 f32 accumulators would not fit beside the score tile, so
// each (q tile, head, batch) takes two blocks, each multiplying all of q·kᵀ
// and accumulating half of out's columns (kCols, flash_common.cuh); f32 at
// 256 keeps one kv buffer, as two pass the 227 KB a block may have.
#include "flash_common.cuh"

namespace dtt {

constexpr int FWD_BQ = 64, FWD_BKV = 64, FWD_THREADS = 128;

// kv tile buffers: two, so that tile n + 1 loads while tile n multiplies.
template <typename T, int D>
constexpr int kFwdBufs = sizeof(T) == 4 && D > 128 ? 1 : 2;

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * ((FWD_BQ + 2 * kFwdBufs<T, D> * FWD_BKV) * (D + kPad<T>) +
                      4 * 16 * (FWD_BKV + kPad<T>));
}

// Shared memory already holds a bf16 dh-128 block to two per SM, so asking
// for two costs no occupancy. It lets ptxas keep all the kernel's live state
// in registers; left to itself it picks 168 and spills ~100 bytes in the kv
// loop (7% slower on an H100).
template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(FWD_THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, const float* __restrict__ cos,
                 const float* __restrict__ sin, Bhsd sq, Bhsd sk, Bhsd sv, Bhsd so, int H,
                 int group, int Sq, int Skv, int off, int causal, int window, long long tstride,
                 float scale) {
  constexpr int LD = D + kPad<T>, LDP = FWD_BKV + kPad<T>, NS = FWD_BKV / 8;
  constexpr int DV = kCols<D>, NT = DV / 8, SPLIT = D / DV, NBUF = kFwdBufs<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + FWD_BQ * LD;  // NBUF buffers of [K tile | V tile]
  T* sP = sQ + (FWD_BQ + 2 * NBUF * FWD_BKV) * LD;
  auto k_buf = [&](int n) { return sKV + (n % NBUF) * 2 * FWD_BKV * LD; };

  const int num_q = (Sq + FWD_BQ - 1) / FWD_BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x / SPLIT) * FWD_BQ;
  // This block's columns of out (block_col); part 0 writes lse.
  const int part = (int)blockIdx.x % SPLIT, c0 = part * (DV / 2);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  T* ob = out + b * so.b + h * so.h;
  float* lb = lse + ((size_t)b * H + h) * Sq;
  // Rope tables are indexed by position: q row r sits at r + off, key row r at r.
  const float* cb = ROPE ? cos + b * tstride : nullptr;
  const float* sb = ROPE ? sin + b * tstride : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + FWD_BQ, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / FWD_BKV * FWD_BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + FWD_BKV - 1) / FWD_BKV : 0;
  if (n_tiles == 0) {  // every row of the tile attends nothing (Sq > Skv, causal)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= Sq) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        store_pair<T>(ob + row[i] * so.s + block_col<D>(j, c0, t), 0.f, 0.f);
      if (t == 0 && part == 0) lb[row[i]] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  // With two buffers the copy of kv tile n + 1 runs while tile n is
  // multiplied; with one it starts once every warp is done with tile n.
  auto issue_kv = [&](int n) {
    const int k0 = kv_begin + n * FWD_BKV;
    tile_issue<T, D, FWD_BKV, FWD_THREADS>(k_buf(n), LD, kb, (int)sk.s, k0, Skv);
    tile_issue<T, D, FWD_BKV, FWD_THREADS>(k_buf(n) + FWD_BKV * LD, LD, vb, (int)sv.s, k0,
                                           Skv);
    cp_async_commit();
  };
  tile_issue<T, D, FWD_BQ, FWD_THREADS>(sQ, LD, qb, (int)sq.s, q0, Sq);
  cp_async_commit();
  issue_kv(0);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  T* myP = sP + warp * 16 * LDP;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = kv_begin + n * FWD_BKV;
    T* cK = k_buf(n);
    const T* cV = cK + FWD_BKV * LD;
    if (NBUF == 2 && n + 1 < n_tiles) {
      issue_kv(n + 1);  // its buffers were last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (n == 0) tile_finish<T, D, FWD_BQ, FWD_THREADS>(sQ, LD, q0, Sq, cb, sb, true, scale, off);
    if constexpr (ROPE)
      tile_finish<T, D, FWD_BKV, FWD_THREADS>(cK, LD, k0, Skv, cb, sb, false, 1.f, 0);
    __syncthreads();

    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    warp_mma<T, NS, D, true, true>(sc, sQ + warp * 16 * LD, LD, cK, LD);

    // Tiles wholly inside the causal/window band skip the per-element mask.
    const int p_lo = q0 + warp * 16 + off;  // position of the warp's first row
    const bool full = k0 + FWD_BKV <= Skv &&
                      (!causal || (k0 + FWD_BKV - 1 <= p_lo &&
                                   (window <= 0 || k0 > p_lo + 15 - window)));
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full &&
            !attends_at(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), Sq, Skv, off, causal, window))
          sc[j][e] = NEG_INF;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[j][e]);
      }
    float m_safe[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(tmax[i]));
      const bool dead = m_new <= NEG_INF / 2;  // every key so far masked
      m_safe[i] = dead ? 0.f : m_new;
      corr[i] = expf(m[i] - m_safe[i]);
      m[i] = m_safe[i] + (dead ? NEG_INF : 0.f);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = expf(sc[j][2 * i] - m_safe[i]);
        const float p1 = expf(sc[j][2 * i + 1] - m_safe[i]);
        rsum[i] += p0 + p1;
        store_pair<T>(myP + (g + 8 * i) * LDP + 8 * j + 2 * t, p0, p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rsum[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    __syncwarp();
    warp_mma_cols<T, NT, FWD_BKV, true, D>(acc, myP, LDP, cV, LD, c0);
    __syncthreads();  // every warp is done with this tile's buffers
    if (NBUF == 1 && n + 1 < n_tiles) issue_kv(n + 1);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store_pair<T>(ob + row[i] * so.s + block_col<D>(j, c0, t), acc[j][2 * i] / denom,
                    acc[j][2 * i + 1] / denom);
    if (t == 0 && part == 0) lb[row[i]] = m[i] + logf(denom);
  }
}

template <typename T, int D, bool ROPE>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
               const void* cos, const void* sin, const long long* st, int B, int H, int KV,
               int Sq, int Skv, int off, int causal, int window, long long tstride, float scale,
               cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T, D>();
  cudaError_t err = set_smem(flash_fwd_kernel<T, D, ROPE>, smem);
  if (err != cudaSuccess) return (int)err;
  const Bhsd sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  const dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ * (D / kCols<D>), H, B);
  flash_fwd_kernel<T, D, ROPE><<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<const float*>(cos),
      static_cast<const float*>(sin), sq, sk, sv, so, H, H / KV, Sq, Skv, off, causal, window,
      tstride, scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// q, out (B, H, Sq, D) and k, v (B, KV, Skv, D), bf16|f32, each with its own
// (b, h, s) element strides in `strides` (q, k, v, out: 12 values) and a
// contiguous last dimension; lse (B, H, Sq) f32 contiguous. Query head h
// reads kv head h / (H / KV). q_pos_offset is the position of query row 0.
// cos/sin (1|B, Skv, D/2) f32 or null (tstride = elements between batch
// rows of the tables, 0 when shared) rotate q and k by position: key row r at
// r, query row i at i + q_pos_offset, which must then lie in [0, Skv - Sq].
// Returns a cudaError_t.
extern "C" int dtt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             const void* cos, const void* sin, const long long* strides, int B,
                             int H, int KV, int Sq, int Skv, int D, int is_bf16, int causal,
                             int window, int q_pos_offset, long long tstride, float scale,
                             void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (q_pos_offset < 0 || q_pos_offset + Sq > Skv))
    return (int)cudaErrorInvalidValue;
#define DTT_FWD(T, DIM)                                                                        \
  return cos != nullptr                                                                        \
             ? launch_fwd<T, DIM, true>(q, k, v, out, lse, cos, sin, strides, B, H, KV, Sq,    \
                                        Skv, q_pos_offset, causal, window, tstride, scale, st) \
             : launch_fwd<T, DIM, false>(q, k, v, out, lse, cos, sin, strides, B, H, KV, Sq,   \
                                         Skv, q_pos_offset, causal, window, tstride, scale, st)
  if (is_bf16 && D == 32) DTT_FWD(bf16, 32);
  if (is_bf16 && D == 64) DTT_FWD(bf16, 64);
  if (is_bf16 && D == 128) DTT_FWD(bf16, 128);
  if (is_bf16 && D == 256) DTT_FWD(bf16, 256);
  if (!is_bf16 && D == 32) DTT_FWD(float, 32);
  if (!is_bf16 && D == 64) DTT_FWD(float, 64);
  if (!is_bf16 && D == 128) DTT_FWD(float, 128);
  if (!is_bf16 && D == 256) DTT_FWD(float, 256);
#undef DTT_FWD
  return (int)cudaErrorInvalidValue;
}
