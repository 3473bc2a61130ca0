// Flash attention forward for head dims above 256 on strided (B, H, S, D)
// operands, D a multiple of 128 taken at run time, for Hopper.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_kernel at any
// head dim, behind the same launch sites as flash_fwd.cu: _flash_forward_qkv
// (K1, packed qkv with GQA and rope), _flash_forward (K3, BHSD, causal
// aligned at the end, q segments placed by q_pos_offset) and
// _flash_forward_bshd (K7, BSHD views). The TPU kernel keeps (block_q + 2 ·
// block_kv) · D rows in VMEM at any D; the plain-design kernels here keep
// whole q and K/V rows in shared memory, which at D 512 in f32 would need
// about 396 KB of the 227 KB a block may have. This kernel streams D.
//
// Bound on this card: at the head_dim 512 call of the trainer (B 12, S 2048,
// 4 heads of 512, causal, bf16) the work is ~2.1e11 FLOPs against ~0.4 GB
// moved, so the tensor cores bound it (about 0.21 ms at 989 TFLOP/s). Each
// of the D/128 column groups recomputes the whole score tile, so the kernel
// does (1 + NG) / 2 times the minimal work: 2.5x at D 512.
//
// Design: one block of 4 warps per (64-row q tile, head, batch, column group
// g of 128 output columns), each warp owning 16 q rows. For each 64-key kv
// tile S = q·kᵀ is summed over D in 64-column chunks of q and k streamed
// through two shared buffers by cp.async (chunk i + 1 loads while chunk i
// multiplies), then the online softmax runs in f32 as in flash_fwd.cu, and
// P·V multiplies only V's columns of group g, which load beside the first
// chunk. Every group computes S in the same order, so the groups agree bit
// for bit on the softmax; group 0 writes lse. q arrives rotated and
// scale-folded, and k rotated, from the prepare pass (flash_dstream.cuh), so
// the kernel carries no tables. Products run on mma.sync (bf16) with
// ldmatrix fragments, FMAs for f32 (warp_mma, flash_common.cuh). kv tiles
// wholly outside the causal/window band are never visited, and the q tiles
// with the most work are scheduled first. Simple first: no wgmma, TMA or
// warp specialisation.
#include "flash_dstream.cuh"

namespace dtt {

constexpr int DSF_BQ = 64, DSF_BKV = 64;

template <typename T>
constexpr size_t dsf_smem_bytes() {
  return sizeof(T) * (2 * (DSF_BQ + DSF_BKV) * (DS_CH + kPad<T>) +
                      DSF_BKV * (DS_GROUP + kPad<T>) + DSF_BQ * (DSF_BKV + kPad<T>));
}

template <typename T>
__global__ void __launch_bounds__(DS_THREADS)
flash_fwd_dstream_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                         Bhsd sk, Bhsd sv, Bhsd so, int H, int group, int Sq, int Skv, int D,
                         int off, int causal, int window) {
  constexpr int LDC = DS_CH + kPad<T>, LDG = DS_GROUP + kPad<T>, LDP = DSF_BKV + kPad<T>;
  constexpr int NS = DSF_BKV / 8, NT = DS_GROUP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sC = reinterpret_cast<T*>(smem);         // two buffers of [q chunk | k chunk]
  T* sV = sC + 2 * (DSF_BQ + DSF_BKV) * LDC;  // the kv tile's V columns of group g
  T* sP = sV + DSF_BKV * LDG;
  auto chunk = [&](int i) { return sC + (i & 1) * (DSF_BQ + DSF_BKV) * LDC; };

  const int NG = D / DS_GROUP, NC = D / DS_CH;
  const int num_q = (Sq + DSF_BQ - 1) / DSF_BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x / NG) * DSF_BQ;
  const int g = (int)blockIdx.x % NG, col0 = g * DS_GROUP;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const T* qb = qs + ((size_t)b * H + h) * Sq * D;  // contiguous, from the prepare pass
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  T* ob = out + b * so.b + h * so.h;
  float* lb = lse + ((size_t)b * H + h) * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + gr, q0 + warp * 16 + gr + 8};

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + DSF_BQ, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / DSF_BKV * DSF_BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + DSF_BKV - 1) / DSF_BKV : 0;
  if (n_tiles == 0) {  // every row of the tile attends nothing (Sq > Skv, causal)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= Sq) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        store_pair<T>(ob + row[i] * so.s + col0 + 8 * j + 2 * t, 0.f, 0.f);
      if (t == 0 && g == 0) lb[row[i]] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  // Load i of the flat sequence (kv tile i / NC, D chunk i % NC): its q and k
  // chunks, into buffer i % 2.
  const int n_loads = n_tiles * NC;
  auto issue_chunk = [&](int i) {
    const int c = (i % NC) * DS_CH, k0 = kv_begin + (i / NC) * DSF_BKV;
    rows_issue<T, DS_CH, DSF_BQ>(chunk(i), LDC, qb + c, D, q0, Sq);
    rows_issue<T, DS_CH, DSF_BKV>(chunk(i) + DSF_BQ * LDC, LDC, kb + c, sk.s, k0, Skv);
  };
  issue_chunk(0);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  T* myP = sP + warp * 16 * LDP;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = kv_begin + n * DSF_BKV;
    // V's rows of this tile, group g's columns: sV was last read before the
    // previous tile's closing barrier.
    rows_issue<T, DS_GROUP, DSF_BKV>(sV, LDG, vb + col0, sv.s, k0, Skv);
    cp_async_commit();
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    for (int c = 0; c < NC; ++c) {
      const int i = n * NC + c;
      if (i + 1 < n_loads) issue_chunk(i + 1);  // its buffer was last read at load i - 1
      cp_async_commit();
      cp_async_wait<1>();  // load i (and, at c = 0, this tile's V columns) landed
      __syncthreads();
      warp_mma<T, NS, DS_CH, true, true>(sc, chunk(i) + warp * 16 * LDC, LDC,
                                         chunk(i) + DSF_BQ * LDC, LDC);
      __syncthreads();  // every warp is done with buffer i % 2
    }

    // Tiles wholly inside the causal/window band skip the per-element mask.
    const int p_lo = q0 + warp * 16 + off;  // position of the warp's first row
    const bool full = k0 + DSF_BKV <= Skv &&
                      (!causal || (k0 + DSF_BKV - 1 <= p_lo &&
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
        store_pair<T>(myP + (gr + 8 * i) * LDP + 8 * j + 2 * t, p0, p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rsum[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    __syncwarp();
    warp_mma<T, NT, DSF_BKV, true, false>(acc, myP, LDP, sV, LDG);  // O_g += P·V_g
    __syncthreads();  // every warp is done with sV
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store_pair<T>(ob + row[i] * so.s + col0 + 8 * j + 2 * t, acc[j][2 * i] / denom,
                    acc[j][2 * i + 1] / denom);
    if (t == 0 && g == 0) lb[row[i]] = m[i] + logf(denom);
  }
}

template <typename T>
int launch_fwd_dstream(const void* q, const void* k, const void* v, void* out, void* lse,
                       const void* cos, const void* sin, const long long* st, int B, int H,
                       int KV, int Sq, int Skv, int D, int off, int causal, int window,
                       long long tstride, float scale, void* q_s, void* k_rot,
                       cudaStream_t stream) {
  const Bhsd sq{st[0], st[1], st[2]}, sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  Bhsd sk{st[3], st[4], st[5]};
  cudaError_t err = dstream_prep<T>(q, sq, q_s, cos, sin, B, H, Sq, D, off, tstride, 1, scale,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  if (cos != nullptr) {
    if ((err = dstream_prep<T>(k, sk, k_rot, cos, sin, B, KV, Skv, D, 0, tstride, 0, 1.f,
                               stream)) != cudaSuccess)
      return (int)err;
    k = k_rot;
    sk = contiguous(KV, Skv, D);
  }
  const size_t smem = dsf_smem_bytes<T>();
  if ((err = set_smem(flash_fwd_dstream_kernel<T>, smem)) != cudaSuccess) return (int)err;
  const dim3 grid((Sq + DSF_BQ - 1) / DSF_BQ * (D / DS_GROUP), H, B);
  flash_fwd_dstream_kernel<T><<<grid, DS_THREADS, smem, stream>>>(
      static_cast<const T*>(q_s), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), sk, sv, so, H, H / KV, Sq, Skv, D, off,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtt_flash_fwd's operands (flash_fwd.cu) at a head dim D that is a multiple
// of 128, plus two scratches: q_s, a contiguous (B, H, Sq, D) tensor of q's
// dtype that receives q rotated (tables) and scale-folded, and k_rot, with
// tables, a contiguous (B, KV, Skv, D) one that receives k rotated (null
// without tables). Returns a cudaError_t.
extern "C" int dtt_flash_fwd_dstream(const void* q, const void* k, const void* v, void* out,
                                     void* lse, const void* cos, const void* sin,
                                     const long long* strides, int B, int H, int KV, int Sq,
                                     int Skv, int D, int is_bf16, int causal, int window,
                                     int q_pos_offset, long long tstride, float scale, void* q_s,
                                     void* k_rot, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dstream_args_ok(B, H, KV, Sq, Skv, D, cos, k_rot, q_pos_offset) || q_s == nullptr)
    return (int)cudaErrorInvalidValue;
  return is_bf16
             ? launch_fwd_dstream<bf16>(q, k, v, out, lse, cos, sin, strides, B, H, KV, Sq, Skv,
                                        D, q_pos_offset, causal, window, tstride, scale, q_s,
                                        k_rot, st)
             : launch_fwd_dstream<float>(q, k, v, out, lse, cos, sin, strides, B, H, KV, Sq, Skv,
                                         D, q_pos_offset, causal, window, tstride, scale, q_s,
                                         k_rot, st);
}
