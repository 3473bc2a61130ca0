// Flash self-attention forward on the packed qkv projection, for Hopper.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_kernel as
// launched by _flash_forward_qkv — online-softmax causal/window attention
// with the split-half rope rotation applied to the q/k tiles on load, out in
// the input dtype and the row logsumexp in f32.
//
// Bound on this card: at the flagship call (B 12, S 2048, 16 heads of 128,
// causal, bf16) the work is ~2.1e11 FLOPs against ~0.4 GB moved, so the
// tensor cores bound it (about 0.21 ms at 989 TFLOP/s); only the causal
// half of the tiles is ever loaded or multiplied.
//
// Design: one block of 4 warps per (64-row q tile, head, batch); each warp
// owns 16 q rows. q, k and v are read straight out of `qkv` (column offsets
// h·D, (H + h/group)·D, (H + KV + h/group)·D; GQA shares kv columns, no
// expanded copy exists). The q tile is rotated, scale-folded and rounded
// once into shared memory; each 64-row kv tile is rotated on load, then
// S = Q·Kᵀ and O += P·V run on mma.sync (bf16) with the running max,
// denominator and accumulator in f32 registers. kv tiles wholly outside the
// causal/window band are never visited, and the q tiles with the most work
// (the last ones, under causal masking) are scheduled first. It is the
// simple first kernel: kv tiles are double-buffered with cp.async (the
// next tile's copy overlaps this tile's products), fragments come from
// padded shared memory by ldmatrix, and there is no TMA, wgmma or warp
// specialisation yet.
#include "flash_common.cuh"

namespace dtt {

constexpr int FWD_BQ = 64, FWD_BKV = 64, FWD_THREADS = 128;

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * ((FWD_BQ + 4 * FWD_BKV) * (D + kPad<T>) + 4 * 16 * (FWD_BKV + kPad<T>));
}

template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS)
flash_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ cos,
                 const float* __restrict__ sin, T* __restrict__ out, float* __restrict__ lse,
                 int S, int H, int KV, int causal, int window, long long tstride, float scale) {
  constexpr int LD = D + kPad<T>, LDP = FWD_BKV + kPad<T>, NT = D / 8, NS = FWD_BKV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + FWD_BQ * LD;  // two buffers of [K tile | V tile]
  T* sP = sQ + (FWD_BQ + 4 * FWD_BKV) * LD;
  auto k_buf = [&](int n) { return sKV + (n & 1) * 2 * FWD_BKV * LD; };

  const int num_q = (S + FWD_BQ - 1) / FWD_BQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * FWD_BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int width = (H + 2 * KV) * D;
  const T* src = qkv + (size_t)b * S * width;
  const float* cb = cos ? cos + b * tstride : nullptr;
  const float* sb = sin ? sin + b * tstride : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + FWD_BQ);
    if (window > 0) kv_begin = max(0, q0 - (window - 1)) / FWD_BKV * FWD_BKV;
  }
  const int n_tiles = (kv_end - kv_begin + FWD_BKV - 1) / FWD_BKV;
  // The copy of kv tile n + 1 runs while tile n is multiplied.
  auto issue_kv = [&](int n) {
    const int k0 = kv_begin + n * FWD_BKV;
    tile_issue<T, D, FWD_BKV, FWD_THREADS>(k_buf(n), LD, src, width, (H + kvh) * D, k0, S);
    tile_issue<T, D, FWD_BKV, FWD_THREADS>(k_buf(n) + FWD_BKV * LD, LD, src, width,
                                           (H + KV + kvh) * D, k0, S);
    cp_async_commit();
  };
  tile_issue<T, D, FWD_BQ, FWD_THREADS>(sQ, LD, src, width, h * D, q0, S);
  cp_async_commit();
  issue_kv(0);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  T* myP = sP + warp * 16 * LDP;

  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = kv_begin + n * FWD_BKV;
    T* cK = k_buf(n);
    const T* cV = cK + FWD_BKV * LD;
    if (n + 1 < n_tiles) {
      issue_kv(n + 1);  // its buffers were last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (n == 0) tile_finish<T, D, FWD_BQ, FWD_THREADS>(sQ, LD, q0, S, cb, sb, true, scale);
    tile_finish<T, D, FWD_BKV, FWD_THREADS>(cK, LD, k0, S, cb, sb, false, 1.f);
    __syncthreads();

    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    warp_mma<T, NS, D, true, true>(sc, sQ + warp * 16 * LD, LD, cK, LD);

    // Tiles wholly inside the causal/window band skip the per-element mask.
    const int r_lo = q0 + warp * 16;
    const bool full = k0 + FWD_BKV <= S &&
                      (!causal || (k0 + FWD_BKV - 1 <= r_lo &&
                                   (window <= 0 || k0 > r_lo + 15 - window)));
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full && !attends(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), S, causal, window))
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
    warp_mma<T, NT, FWD_BKV, true, false>(acc, myP, LDP, cV, LD);
    __syncthreads();  // every warp is done with this tile's buffers
  }

  T* dst = out + (size_t)b * S * H * D + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store_pair<T>(dst + (size_t)row[i] * H * D + 8 * j + 2 * t, acc[j][2 * i] / denom,
                    acc[j][2 * i + 1] / denom);
    if (t == 0) lse[((size_t)b * H + h) * S + row[i]] = m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch_fwd(const void* qkv, const void* cos, const void* sin, void* out, void* lse, int B,
               int S, int H, int KV, int causal, int window, long long tstride, float scale,
               cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<T, D>();
  cudaError_t err = set_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + FWD_BQ - 1) / FWD_BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<T*>(out), static_cast<float*>(lse), S, H, KV,
      causal, window, tstride, scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// qkv (B, S, (H + 2·KV)·D) bf16|f32; cos/sin (1|B, S, D/2) f32 or null
// (tstride = elements between batch rows of the tables, 0 when shared);
// out (B, S, H·D) like qkv; lse (B, H, S) f32. Returns a cudaError_t.
extern "C" int dtt_flash_fwd(const void* qkv, const void* cos, const void* sin, void* out,
                             void* lse, int B, int S, int H, int KV, int D, int is_bf16,
                             int causal, int window, long long tstride, float scale,
                             void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  if (is_bf16 && D == 64)
    return launch_fwd<bf16, 64>(qkv, cos, sin, out, lse, B, S, H, KV, causal, window, tstride, scale, st);
  if (is_bf16 && D == 128)
    return launch_fwd<bf16, 128>(qkv, cos, sin, out, lse, B, S, H, KV, causal, window, tstride, scale, st);
  if (!is_bf16 && D == 64)
    return launch_fwd<float, 64>(qkv, cos, sin, out, lse, B, S, H, KV, causal, window, tstride, scale, st);
  if (!is_bf16 && D == 128)
    return launch_fwd<float, 128>(qkv, cos, sin, out, lse, B, S, H, KV, causal, window, tstride, scale, st);
  return (int)cudaErrorInvalidValue;
}
