// Flash self-attention backward on the packed qkv projection, for Hopper.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_bwd_fused_kernel
// as launched by _flash_backward_qkv — p recomputed from the saved
// logsumexp, delta = rowsum(dO∘O), dv = pᵀ·dO, dS = p∘(dO·vᵀ − delta),
// dq = s·dS·k, dk = dSᵀ·(q·s), dq/dk rotated back by the inverse rope, and
// the kv grads of a GQA group summed into their shared kv columns.
//
// Bound on this card: five tile products against the forward's two, ~5.2e11
// FLOPs at the flagship call (B 12, S 2048, 16 heads of 128, causal, bf16)
// against ~0.8 GB moved — the tensor cores bound it (about 0.52 ms at
// 989 TFLOP/s).
//
// Design: the TPU kernel walks its grid in order and keeps dq for the whole
// sequence in VMEM; blocks on Hopper run in no order, so nothing carries
// between them. Three launches instead:
//   1. delta pre-pass: one warp per (b, s, h) row, rowsum(dO∘O) in f32.
//   2. main kernel: one block of 4 warps per (64-row kv tile, kv head,
//      batch); each warp owns 16 kv rows and keeps their dk and dv in f32
//      registers while it loops over every q head of the GQA group and over
//      the 32-row q tiles from the causal diagonal to the window's end, so
//      the group sum happens in registers and dk/dv are written once. Sᵀ,
//      Pᵀ and dSᵀ are computed kv-rows-major, so dV += Pᵀ·dO and
//      dK += dSᵀ·Q need no transpose; dQ += s·dS·K reads the block's dSᵀ
//      tile from shared memory transposed and is added with f32 atomics
//      into a zeroed (B, S, H, D) scratch the wrapper allocated.
//   3. dq pass: rotate the summed f32 dq back and cast it into dqkv.
// The products run on mma.sync (bf16) with ldmatrix fragments from padded
// shared memory, and each step's q-side tiles are double-buffered with
// cp.async, as in flash_fwd.cu; dq's float2 atomics and the missing TMA
// and wgmma are the levers of a later version.
#include "flash_common.cuh"

namespace dtt {

constexpr int BWD_BKV = 64, BWD_BQ = 32, BWD_THREADS = 128;

template <typename T, int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * 4 * BWD_BQ +
         sizeof(T) * ((2 * BWD_BKV + 4 * BWD_BQ) * (D + kPad<T>) +
                      (4 * 16 + BWD_BKV) * (BWD_BQ + kPad<T>));
}

// delta[b, h, s] = sum_d dO[b, s, h, d] · O[b, s, h, d]; one warp per row.
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                       float* __restrict__ delta, int S, int H, int D,
                                       long long rows) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* o = out + r * D;
  const T* d = dout + r * D;
  float acc = 0.f;
  for (int i = lane; i < D; i += 32) acc = fmaf(to_f32<T>(d[i]), to_f32<T>(o[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = r / ((long long)S * H), s = (r / H) % S, h = r % H;
    delta[(b * H + h) * S + s] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                 const float* __restrict__ delta, const T* __restrict__ dout,
                 const float* __restrict__ cos, const float* __restrict__ sin,
                 T* __restrict__ dqkv, float* __restrict__ dq_acc, int S, int H, int KV,
                 int causal, int window, long long tstride, float scale) {
  constexpr int LD = D + kPad<T>, LDQ = BWD_BQ + kPad<T>, NT = D / 8, NQ = BWD_BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sStats = reinterpret_cast<float*>(smem);  // two buffers of [lse | delta] rows
  T* sK = reinterpret_cast<T*>(sStats + 4 * BWD_BQ);
  T* sV = sK + BWD_BKV * LD;
  T* sQdO = sV + BWD_BKV * LD;  // two buffers of [q tile | dO tile]
  T* sP = sQdO + 4 * BWD_BQ * LD;
  T* sdS = sP + 4 * 16 * LDQ;

  const int k0 = blockIdx.x * BWD_BKV;  // low tiles first: under causal masking they see most q
  const int kvh = blockIdx.y, b = blockIdx.z, group = H / KV;
  const int width = (H + 2 * KV) * D;
  const T* src = qkv + (size_t)b * S * width;
  const T* gsrc = dout + (size_t)b * S * H * D;
  const float* cb = cos ? cos + b * tstride : nullptr;
  const float* sb = sin ? sin + b * tstride : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0 / BWD_BQ * BWD_BQ;
    if (window > 0) q_end = min(S, k0 + BWD_BKV - 1 + window);
  }
  // Steps walk (q head of the group, q tile); the copy of step n + 1's q,
  // dO, lse and delta runs while step n is multiplied.
  const int n_q = (q_end - q_begin + BWD_BQ - 1) / BWD_BQ, n_steps = group * n_q;
  auto q_buf = [&](int n) { return sQdO + (n & 1) * 2 * BWD_BQ * LD; };
  auto stats_buf = [&](int n) { return sStats + (n & 1) * 2 * BWD_BQ; };
  auto issue_q = [&](int n) {
    const int h = kvh * group + n / n_q, q0 = q_begin + (n % n_q) * BWD_BQ;
    tile_issue<T, D, BWD_BQ, BWD_THREADS>(q_buf(n), LD, src, width, h * D, q0, S);
    tile_issue<T, D, BWD_BQ, BWD_THREADS>(q_buf(n) + BWD_BQ * LD, LD, gsrc, H * D, h * D, q0, S);
    float* st = stats_buf(n);
    for (int i = threadIdx.x; i < 2 * BWD_BQ; i += blockDim.x) {
      const int q = q0 + i % BWD_BQ;
      const float* from = (i < BWD_BQ ? lse : delta) + ((size_t)b * H + h) * S + q;
      if (q < S) cp_async4(st + i, from);
      else st[i] = 0.f;
    }
    cp_async_commit();
  };
  tile_issue<T, D, BWD_BKV, BWD_THREADS>(sK, LD, src, width, (H + kvh) * D, k0, S);
  tile_issue<T, D, BWD_BKV, BWD_THREADS>(sV, LD, src, width, (H + KV + kvh) * D, k0, S);
  cp_async_commit();
  issue_q(0);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int kv_row[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  T* myP = sP + warp * 16 * LDQ;
  T* mydS = sdS + warp * 16 * LDQ;
  // dQ split: warp w adds q rows [16·(w%2), +16) x head columns [(w/2)·D/2, +D/2).
  const int dq_r0 = (warp & 1) * 16, dq_c0 = (warp >> 1) * (D / 2);

  for (int n = 0; n < n_steps; ++n) {
    const int h = kvh * group + n / n_q, q0 = q_begin + (n % n_q) * BWD_BQ;
    T* sQ = q_buf(n);
    const T* sdO = sQ + BWD_BQ * LD;
    const float* sLse = stats_buf(n);
    const float* sDelta = sLse + BWD_BQ;
    if (n + 1 < n_steps) {
      issue_q(n + 1);  // its buffers were last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (n == 0) tile_finish<T, D, BWD_BKV, BWD_THREADS>(sK, LD, k0, S, cb, sb, false, 1.f);
    tile_finish<T, D, BWD_BQ, BWD_THREADS>(sQ, LD, q0, S, cb, sb, true, scale);
    __syncthreads();

    // Sᵀ = K·Qᵀ for this warp's 16 kv rows, then Pᵀ = exp(Sᵀ − lse).
    float pt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) pt[j][0] = pt[j][1] = pt[j][2] = pt[j][3] = 0.f;
    warp_mma<T, NQ, D, true, true>(pt, sK + warp * 16 * LD, LD, sQ, LD);
    // Tiles wholly inside the causal/window band skip the per-element mask.
    const int kv_lo = k0 + warp * 16;
    const bool full = q0 + BWD_BQ <= S && kv_lo + 15 < S &&
                      (!causal || (kv_lo + 15 <= q0 &&
                                   (window <= 0 || kv_lo > q0 + BWD_BQ - 1 - window)));
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool live = (full || attends(q0 + c, kv_row[e >> 1], S, causal, window)) &&
                          sLse[c] > NEG_INF / 2;
        pt[j][e] = live ? expf(pt[j][e] - sLse[c]) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store_pair<T>(myP + (g + 8 * i) * LDQ + 8 * j + 2 * t, pt[j][2 * i], pt[j][2 * i + 1]);
    __syncwarp();
    warp_mma<T, NT, BWD_BQ, true, false>(dv, myP, LDQ, sdO, LD);  // dV += Pᵀ·dO

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
    __syncthreads();  // dSᵀ of all four warps is in shared memory

    warp_mma<T, NT, BWD_BQ, true, false>(dk, mydS, LDQ, sQ, LD);  // dK += dSᵀ·(q·s)

    // dQ += s · dS·K over this block's 64 kv rows; dS(q, kv) = sdS[kv][q].
    float dq[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
    warp_mma<T, NT / 2, BWD_BKV, false, false>(dq, sdS + dq_r0, LDQ, sK + dq_c0, LD);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + dq_r0 + g + 8 * i;
      if (q >= S) continue;
      float* dst = dq_acc + (((size_t)b * S + q) * H + h) * D + dq_c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                  make_float2(scale * dq[j][2 * i], scale * dq[j][2 * i + 1]));
    }
    __syncthreads();  // every warp is done with this step's buffers
  }

  // dk rotates back by the inverse rope at its kv rows; columns i and i + D/2
  // are fragments j and j + NT/2 of the same lane.
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = kv_row[e >> 1];
    if (r >= S) continue;
    if (cb != nullptr) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int i = 8 * j + 2 * t + (e & 1);
        const float c = cb[(size_t)r * (D / 2) + i], s = sb[(size_t)r * (D / 2) + i];
        const float x1 = dk[j][e], x2 = dk[j + NT / 2][e];
        dk[j][e] = x1 * c + x2 * s;
        dk[j + NT / 2][e] = x2 * c - x1 * s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kv_row[i];
    if (r >= S) continue;
    T* row = dqkv + ((size_t)b * S + r) * width + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      store_pair<T>(row + (H + kvh) * D + 8 * j, dk[j][2 * i], dk[j][2 * i + 1]);
      store_pair<T>(row + (H + KV + kvh) * D + 8 * j, dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// dq (B, S, H, D) f32 -> rotated back, cast, into dqkv's q columns.
template <typename T>
__global__ void flash_bwd_dq_kernel(const float* __restrict__ dq_acc, const float* __restrict__ cos,
                                    const float* __restrict__ sin, T* __restrict__ dqkv, int S,
                                    int H, int KV, int D, long long tstride, long long pairs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const int half = D / 2;
  const long long row = idx / half;  // (b, s, h) row of dq_acc
  const int i = idx % half;
  const long long bs = row / H;      // b·S + s
  const int h = row % H;
  const long long b = bs / S, s = bs % S;
  float x1 = dq_acc[row * D + i], x2 = dq_acc[row * D + i + half];
  if (cos != nullptr) {
    const float c = cos[b * tstride + s * half + i], sn = sin[b * tstride + s * half + i];
    const float y1 = x1 * c + x2 * sn, y2 = x2 * c - x1 * sn;
    x1 = y1;
    x2 = y2;
  }
  T* dst = dqkv + bs * (long long)(H + 2 * KV) * D + h * D;
  dst[i] = from_f32<T>(x1);
  dst[i + half] = from_f32<T>(x2);
}

template <typename T, int D>
int launch_bwd(const void* qkv, const void* out, const void* lse, const void* dout,
               const void* cos, const void* sin, void* dqkv, void* dq_acc, void* delta, int B,
               int S, int H, int KV, int causal, int window, long long tstride, float scale,
               cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, rows * D * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<float*>(delta), S,
      H, D, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem = bwd_smem_bytes<T, D>();
  if ((err = set_smem(flash_bwd_kernel<T, D>, smem)) != cudaSuccess) return (int)err;
  const dim3 grid((S + BWD_BKV - 1) / BWD_BKV, KV, B);
  flash_bwd_kernel<T, D><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout),
      static_cast<const float*>(cos), static_cast<const float*>(sin), static_cast<T*>(dqkv),
      static_cast<float*>(dq_acc), S, H, KV, causal, window, tstride, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long pairs = rows * (D / 2);
  flash_bwd_dq_kernel<T><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<T*>(dqkv), S, H, KV, D, tstride, pairs);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// qkv (B, S, (H + 2·KV)·D) bf16|f32; out and dout (B, S, H·D) like qkv;
// lse (B, H, S) f32; cos/sin (1|B, S, D/2) f32 or null (tstride as in
// dtt_flash_fwd); dqkv like qkv; scratch: dq_acc (B, S, H, D) f32 and
// delta (B, H, S) f32. Returns a cudaError_t.
extern "C" int dtt_flash_bwd(const void* qkv, const void* out, const void* lse,
                             const void* dout, const void* cos, const void* sin, void* dqkv,
                             void* dq_acc, void* delta, int B, int S, int H, int KV, int D,
                             int is_bf16, int causal, int window, long long tstride,
                             float scale, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
#define DTT_BWD(T, DIM)                                                                    \
  return launch_bwd<T, DIM>(qkv, out, lse, dout, cos, sin, dqkv, dq_acc, delta, B, S, H, KV, \
                            causal, window, tstride, scale, st)
  if (is_bf16 && D == 64) DTT_BWD(bf16, 64);
  if (is_bf16 && D == 128) DTT_BWD(bf16, 128);
  if (!is_bf16 && D == 64) DTT_BWD(float, 64);
  if (!is_bf16 && D == 128) DTT_BWD(float, 128);
#undef DTT_BWD
  return (int)cudaErrorInvalidValue;
}
