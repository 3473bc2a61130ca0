// Flash attention forward, software-pipelined across kv tiles, for Hopper (K9).
//
// Replaces: tools/pipeline_probe.py:_pipe_fwd_kernel, launched by
// pipe_flash_forward (:169): the TPU probe that asks whether overlapping the
// softmax of kv tile j with the matrix-unit product of tile j + 1 speeds the
// flash forward up. On the TPU the kv grid axis runs the body in order and
// the chain logits -> softmax -> p·v is serial inside it, so the probe
// computes the logits of step j into double-buffered scratch while it takes
// the softmax and p·v of step j - 1 from a v block fetched one step late,
// with one extra grid step to flush.
//
// Computes what csrc/flash_fwd.cu computes for q (B, H, Sq, D) against k, v
// (B, H, Skv, D) with no window, rope or GQA: q scaled and rounded to its
// dtype before the product, causal masking end-aligned (query row i at
// position i + off) or none, online softmax in f32, out in the input dtype
// and the row logsumexp in f32; a row with no attended key gets out 0 and
// lse NEG_INF + log(1e-30). Ragged tails are masked (the TPU probe needs
// lengths that its blocks divide).
//
// Bound on this card: at the probe's flagship shape (B 12, 16 heads, S 2048,
// D 128, causal, bf16) ~2.1e11 FLOPs against ~0.4 GB moved, so the tensor
// cores bound it (about 0.21 ms at 989 TFLOP/s).
//
// Design: flash_fwd.cu's block (4 warps per 64-row q tile, head and batch;
// 64-key tiles; mma.sync bf16 with ldmatrix fragments, FMAs for f32) with
// the probe's idea carried into each warp: the product Q·K_{n+1}ᵀ is issued
// before the softmax of tile n, so the tensor-core instructions of tile
// n + 1 and the FP32/MUFU softmax of tile n have no dependence and the warp
// scheduler can interleave them. K runs one tile ahead of V in the cp.async
// ring (the TPU's lagged v index): while tile n is in use the block holds
// K_{n+1} and V_n and loads K_{n+2} and V_{n+1} — four tiles, as
// flash_fwd.cu holds, so shared memory and the two blocks per SM stay. The
// last step has no next product: it is the probe's flush step. The cost is
// a second 16 x 64 score tile per warp (32 f32 registers a thread). The
// per-tile arithmetic is flash_fwd.cu's, in the same order. Instances: bf16
// and f32 at head_dim 64 and 128, and f32 at 256 (bf16 calls run
// flash_fwd_pipe_sm90.cu; the wrapper pads any other head_dim up to 256).
// At 256 the kernel follows flash_fwd.cu's instance there: each (q tile,
// head, batch) takes two blocks, each multiplying all of q·kᵀ and
// accumulating 128 of out's columns (kCols, flash_common.cuh), and the f32
// tiles leave room for one K and one V slot only, so the loads of K_{n+2}
// and V_{n+1} start once every warp is done with step n (a second barrier a
// step) instead of under it.
#include "flash_common.cuh"

namespace dtt {

constexpr int PIPE_BQ = 64, PIPE_BKV = 64, PIPE_THREADS = 128;

// Slots each for K and V: two, so that K_{n+2} and V_{n+1} load while step n
// multiplies; one for f32 above head_dim 128, where two pass the 227 KB a
// block may have.
template <typename T, int D>
constexpr int kPipeBufs = sizeof(T) == 4 && D > 128 ? 1 : 2;

template <typename T, int D>
constexpr size_t pipe_smem_bytes() {
  return sizeof(T) * ((PIPE_BQ + 2 * kPipeBufs<T, D> * PIPE_BKV) * (D + kPad<T>) +
                      4 * 16 * (PIPE_BKV + kPad<T>));
}

template <typename T, int D>
__global__ void __launch_bounds__(PIPE_THREADS, 2)
flash_fwd_pipe_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ out, float* __restrict__ lse, Bhsd sq, Bhsd sk, Bhsd sv,
                      Bhsd so, int H, int Sq, int Skv, int off, int causal, float scale) {
  constexpr int LD = D + kPad<T>, LDP = PIPE_BKV + kPad<T>, NS = PIPE_BKV / 8;
  constexpr int DV = kCols<D>, NT = DV / 8, SPLIT = D / DV, NBUF = kPipeBufs<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + PIPE_BQ * LD;             // NBUF K slots
  T* sV = sK + NBUF * PIPE_BKV * LD;     // NBUF V slots
  T* sP = sV + NBUF * PIPE_BKV * LD;     // each warp's 16 rows of p
  auto k_buf = [&](int n) { return sK + (n % NBUF) * PIPE_BKV * LD; };
  auto v_buf = [&](int n) { return sV + (n % NBUF) * PIPE_BKV * LD; };

  const int num_q = (Sq + PIPE_BQ - 1) / PIPE_BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x / SPLIT) * PIPE_BQ;  // most work first
  // This block's columns of out (block_col); part 0 writes lse.
  const int part = (int)blockIdx.x % SPLIT, c0 = part * (DV / 2);
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = out + b * so.b + h * so.h;
  float* lb = lse + ((size_t)b * H + h) * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const int kv_end = causal ? min(Skv, min(q0 + PIPE_BQ, Sq) + off) : Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + PIPE_BKV - 1) / PIPE_BKV : 0;
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

  auto issue_k = [&](int n) {
    tile_issue<T, D, PIPE_BKV, PIPE_THREADS>(k_buf(n), LD, kb, (int)sk.s, n * PIPE_BKV, Skv);
  };
  auto issue_v = [&](int n) {
    tile_issue<T, D, PIPE_BKV, PIPE_THREADS>(v_buf(n), LD, vb, (int)sv.s, n * PIPE_BKV, Skv);
  };
  // Prologue: Q and K_0 in one group, K_1 and V_0 in the next (with one
  // slot each, once every warp has read K_0).
  tile_issue<T, D, PIPE_BQ, PIPE_THREADS>(sQ, LD, qb, (int)sq.s, q0, Sq);
  issue_k(0);
  cp_async_commit();
  auto issue_next = [&](int n) {  // K_{n+1} and V_n
    if (n + 1 < n_tiles) issue_k(n + 1);
    if (n < n_tiles) issue_v(n);
    cp_async_commit();
  };
  if constexpr (NBUF == 2) {
    issue_next(0);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  tile_finish<T, D, PIPE_BQ, PIPE_THREADS>(sQ, LD, q0, Sq, nullptr, nullptr, true, scale, off);
  __syncthreads();

  const T* myQ = sQ + warp * 16 * LD;
  T* myP = sP + warp * 16 * LDP;
  const int p_lo = q0 + warp * 16 + off;  // position of the warp's first row
  auto scores = [&](float (*s)[4], int n) {
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    warp_mma<T, NS, D, true, true>(s, myQ, LD, k_buf(n), LD);
  };
  // Tiles wholly inside the causal band skip the per-element mask.
  auto mask = [&](float (*s)[4], int n) {
    const int k0 = n * PIPE_BKV;
    if (k0 + PIPE_BKV <= Skv && (!causal || k0 + PIPE_BKV - 1 <= p_lo)) return;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!attends_at(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), Sq, Skv, off, causal, 0))
          s[j][e] = NEG_INF;
  };

  float sc[NS][4], nx[NS][4];  // the scores of tile n, and of tile n + 1
  scores(sc, 0);
  mask(sc, 0);
  if constexpr (NBUF == 1) {
    __syncthreads();  // every warp is done with K_0's slot
    issue_next(0);
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();  // K_{n+1} and V_n have landed ...
    __syncthreads();     // ... for every thread, and every warp is done with K_n and V_{n-1}
    if constexpr (NBUF == 2) issue_next(n + 1);  // into K_n's and V_{n-1}'s slots
    const bool next = n + 1 < n_tiles;
    if (next) scores(nx, n + 1);  // no dependence on the softmax below

    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[j][e]);
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
    warp_mma_cols<T, NT, PIPE_BKV, true, D>(acc, myP, LDP, v_buf(n), LD, c0);
    if constexpr (NBUF == 1) {
      __syncthreads();  // every warp is done with K_{n+1}'s and V_n's slots
      issue_next(n + 1);
    }

    if (next) {
      mask(nx, n + 1);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = nx[j][e];
    }
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

template <typename T, int D>
int launch_fwd_pipe(const void* q, const void* k, const void* v, void* out, void* lse,
                    const long long* st, int B, int H, int Sq, int Skv, int off, int causal,
                    float scale, cudaStream_t stream) {
  const size_t smem = pipe_smem_bytes<T, D>();
  cudaError_t err = set_smem(flash_fwd_pipe_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const Bhsd sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  const dim3 grid((Sq + PIPE_BQ - 1) / PIPE_BQ * (D / kCols<D>), H, B);
  flash_fwd_pipe_kernel<T, D><<<grid, PIPE_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), sq, sk, sv, so, H, Sq, Skv, off, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// q, out (B, H, Sq, D) and k, v (B, H, Skv, D), bf16|f32 (head_dim 64 or 128)
// or f32 (head_dim 256), each with its own
// (b, h, s) element strides in `strides` (q, k, v, out: 12 values) and a
// contiguous last dimension; lse (B, H, Sq) f32 contiguous. q_pos_offset is
// the position of query row 0 (Skv - Sq for end-aligned causal masking).
// Returns a cudaError_t.
extern "C" int dtt_flash_fwd_pipe(const void* q, const void* k, const void* v, void* out,
                                  void* lse, const long long* strides, int B, int H, int Sq,
                                  int Skv, int D, int is_bf16, int causal, int q_pos_offset,
                                  float scale, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1) return (int)cudaErrorInvalidValue;
#define DTT_FWD_PIPE(T, DIM)                                                                  \
  return launch_fwd_pipe<T, DIM>(q, k, v, out, lse, strides, B, H, Sq, Skv, q_pos_offset,    \
                                 causal, scale, st)
  if (is_bf16 && D == 64) DTT_FWD_PIPE(bf16, 64);
  if (is_bf16 && D == 128) DTT_FWD_PIPE(bf16, 128);
  if (!is_bf16 && D == 64) DTT_FWD_PIPE(float, 64);
  if (!is_bf16 && D == 128) DTT_FWD_PIPE(float, 128);
  if (!is_bf16 && D == 256) DTT_FWD_PIPE(float, 256);
#undef DTT_FWD_PIPE
  return (int)cudaErrorInvalidValue;
}
