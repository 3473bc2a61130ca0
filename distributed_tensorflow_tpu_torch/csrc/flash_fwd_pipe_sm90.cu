// Flash attention forward in the pipelining probe's issue order, as a Hopper
// warpgroup kernel (K9): both tile products are wgmma.
//
// Replaces: tools/pipeline_probe.py:_pipe_fwd_kernel, launched by
// pipe_flash_forward (:169), wherever the call is bf16 at head_dim 64, 128 or
// 256 (the wrapper pads any other head_dim up to 256 to the next of them):
// the TPU probe that asks whether overlapping the softmax of kv tile n with
// the matrix-unit product of tile n + 1 speeds the flash forward up. f32
// calls stay on flash_fwd_pipe.cu, whose C contract this file keeps: q, out
// (B, H, Sq, D) and k, v (B, H, Skv, D) on strided operands with a
// contiguous last dimension, no window, rope or GQA, causal masking
// end-aligned (query row i at position i + off) or none, ragged tails
// masked, and, for a row that attends nothing, out exactly 0 and lse NEG_INF
// + log(1e-30).
//
// Bound on this card: at the probe's flagship shape (B 12, 16 heads, S 2048,
// D 128, causal) ~2.1e11 FLOPs against ~0.4 GB moved, so the tensor cores
// bound it (about 0.21 ms at 989 TFLOP/s), and only wgmma reaches that rate.
//
// Design: flash_fwd_sm90.cu's skeleton — one warpgroup per (64-row q tile,
// head, batch), two blocks an SM, the q tiles with the most keys first,
// 64-key tiles in the 128-byte swizzle, S = (q·s)·Kᵀ by mma_ss, O += P·V by
// mma_rs with P's bf16 conversion as the A fragments, the softmax in f32 on
// the S accumulator with exp2 on the special-function unit, K one tile ahead
// of V in two cp.async buffers each (the TPU probe's lagged v index) with
// one block barrier a step — with one change, the issue order. Step n
// issues S_{n+1} first and runs the softmax of S_n, finished in the step
// before, while S_{n+1} multiplies; it retires S_{n+1}, rescales O, issues
// P_n·V_n and retires that too, so S_{n+1} enters step n + 1 finished and no
// wgmma group lives across the loop's back edge (a group left in flight
// there made ptxas serialise every wgmma, C7514). Every wgmma of a step is
// issued unconditionally — the last step, which has no S_{n+1}, is peeled
// off — and O is rescaled at every step (by 0 at step 0, where O is 0): a
// first version that issued S_{n+1} under `if (n + 1 < n_tiles)` and skipped
// step 0's rescale made ptxas serialise every wgmma (C7515, accumulator
// registers defined by non-wgmma instructions inside a pipeline stage) and
// read 1.02-1.06x K3's time. The loop is unrolled by two, S_n and S_{n+1} in
// two named register tiles, so that no copy moves a score tile.
// flash_fwd_sm90.cu (K3) takes FlashAttention-3's order instead — S_n and
// P_{n-1}·V_{n-1} issued together, the softmax of S_n under P_{n-1}·V_{n-1}
// — so K9 against K3 on the same inputs isolates the order. The per-element
// arithmetic and the order of O's updates are K3's: O = (O·corr_n) +
// P_n·V_n, tile by tile.
//
// Head_dim 256 follows flash_fwd_sm90.cu's instance there: two warpgroups a
// block, each its own 64-row q tile, sharing the K and V tiles, one block an
// SM. The order holds two score tiles beside O, and O alone is 64 x 256 f32,
// 128 registers a thread; flash_fwd_sm90.cu's single 64-key S already
// reaches 228 at 256, so two 64-key tiles (32 registers each) would spill.
// At 256 the kv tiles are therefore 32 keys (m64n32k16 for S, 16 registers
// a score tile, 8 of packed P): the probe tests the issue order, not a tile
// size. Its out is not bit for bit K3's at 256, as the online softmax
// rescales at every 32 keys rather than every 64.
#include "sm90_common.cuh"

namespace dtt {

constexpr int PIPE90_BQ = 64;  // rows of a warpgroup's q tile

// Warpgroups a block and keys a kv tile: two and 32 at head_dim 256, one and
// 64 below.
template <int D>
constexpr int kPipe90Wgs = D == 256 ? 2 : 1;
template <int D>
constexpr int kPipe90Bkv = D == 256 ? 32 : 64;

template <int D>
constexpr size_t pipe90_smem_bytes() {
  // The warpgroups' q tiles, two K and two V tiles, and room to align the
  // base to 1024 bytes.
  return sizeof(bf16) * (kPipe90Wgs<D> * PIPE90_BQ + 4 * kPipe90Bkv<D>) * D + 1024;
}

template <int D>
__global__ void __launch_bounds__(128 * kPipe90Wgs<D>, kPipe90Wgs<D> == 1 ? 2 : 1)
flash_fwd_pipe_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, Bhsd sq, Bhsd sk, Bhsd sv, Bhsd so, int H,
                           int Sq, int Skv, int off, int causal, float scale) {
  // DB: 64-column blocks; BQB: q rows a block, BQ a warpgroup; NS: score
  // registers a thread, NP: packed P registers.
  constexpr int BQ = PIPE90_BQ, BKV = kPipe90Bkv<D>, DB = D / 64;
  constexpr int THREADS = 128 * kPipe90Wgs<D>, BQB = kPipe90Wgs<D> * BQ;
  constexpr int NS = BKV / 2, NP = BKV / 4;
  static_assert(D == 64 || D == 128 || D == 256, "head_dim 64, 128 or 256");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_at(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));  // BQB rows
  bf16* sK = sQ + BQB * D;      // two tiles
  bf16* sV = sK + 2 * BKV * D;  // two tiles

  const int num_q = (Sq + BQB - 1) / BQB;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * BQB;  // the tiles with the most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  bf16* ob = out + b * so.b + h * so.h;
  float* lb = lse + ((size_t)b * H + h) * Sq;
  const int wg = threadIdx.x >> 7;        // the warpgroup: rows [64wg, +64) of the block's
  const int wi = (threadIdx.x >> 5) & 3;  // the warp: rows [16wi, +16) of the warpgroup's
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + BQ * wg + 16 * wi;  // the warp's first q row
  const int row[2] = {r_lo + g, r_lo + g + 8};

  // At 256 a block's kv range is that of its later q tile: under causal
  // masking its earlier warpgroup multiplies tiles wholly masked for it,
  // which the mask zeroes, as in flash_fwd_sm90.cu.
  const int kv_end = causal ? min(Skv, min(q0 + BQB, Sq) + off) : Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  if (n_tiles == 0) {  // every row of the tile attends nothing (Sq > Skv, causal)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair<bf16>(ob + row[i] * so.s + 8 * j + 2 * t, 0.f, 0.f);
      if (t == 0) lb[row[i]] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  auto k_tile = [&](int n) { return sK + (n & 1) * BKV * D; };
  auto v_tile = [&](int n) { return sV + (n & 1) * BKV * D; };
  // sw_issue for the K and V tiles with the address arithmetic hoisted out
  // of the kv loop, as in flash_fwd_sm90.cu: this thread copies the 16-byte
  // chunks at rows kr0 + RPR·it, columns kc and kc + D/2.
  constexpr int CPH = D / 16, RPR = THREADS / CPH, ROUNDS = BKV / RPR;
  const int kr0 = (int)threadIdx.x / CPH, kc = ((int)threadIdx.x % CPH) * 8;
  const int so1 = sw<BKV>(kr0, kc), so2 = sw<BKV>(kr0, kc + D / 2);
  auto load_tile = [&](bf16* dst, const bf16* src, long long ld, int row0) {
    const bf16* p = src + (long long)(row0 + kr0) * ld + kc;
    const int left = Skv - row0 - kr0;
#pragma unroll
    for (int it = 0; it < ROUNDS; ++it) {
      bf16* d = dst + it * RPR * 64;
      if (it * RPR < left) {
        cp_async16(d + so1, p);
        cp_async16(d + so2, p + D / 2);
      } else {
        *reinterpret_cast<uint4*>(d + so1) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(d + so2) = make_uint4(0, 0, 0, 0);
      }
      p += RPR * ld;
    }
  };
  auto load_k = [&](int n) { load_tile(k_tile(n), kb, sk.s, n * BKV); };
  auto load_v = [&](int n) { load_tile(v_tile(n), vb, sv.s, n * BKV); };
  float s0[NS], s1[NS], o[DB][32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pf[NP];
#pragma unroll
  for (int blk = 0; blk < DB; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[blk][i] = 0.f;

  // S = (q·s)·K_nᵀ into `s`, one commit group.
  auto issue_s = [&](float (&s)[NS], int n) {
    const uint32_t aQ = smem_at(sQ), aK = smem_at(k_tile(n));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0, 0>(s, desc_k(aQ + 2 * sw<BQB>(BQ * wg, 16 * kk)),
                   desc_k(aK + 2 * sw<BKV>(0, 16 * kk)), kk > 0);
    wg_commit();
  };
  // O += P·V_n, one commit group: k-step kk takes keys [16kk, +16) from
  // fragments 4kk..4kk+3 of P.
  auto issue_pv = [&](int n) {
    const uint32_t aV = smem_at(v_tile(n));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int blk = 0; blk < DB; ++blk)
        mma_rs(o[blk], pf + 4 * kk, desc_mn(aV + 2 * sw<BKV>(16 * kk, 64 * blk)));
    wg_commit();
  };
  // flash_fwd_sm90.cu's online softmax of S_n in place, causal only: P =
  // exp(S − m) as exp2 of log2e-scaled logits, m and l updated, corr the
  // factor O takes. Tiles wholly inside the causal band skip the mask.
  auto softmax = [&](float (&s)[NS], int n) {
    const int k0 = n * BKV, p_lo = r_lo + off;  // p_lo: the warp's first row's position
    const bool full = k0 + BKV <= Skv && (!causal || k0 + BKV - 1 <= p_lo);
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full && !attends_at(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), Sq, Skv, off, causal,
                                 0))
          s[4 * j + e] = NEG_INF;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[4 * j + e]);
      }
    float mb[2], rsum[2] = {0.f, 0.f};  // mb: m in log2 units
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(tmax[i]));
      const bool dead = m_new <= NEG_INF / 2;  // every key so far masked
      const float m_safe = dead ? 0.f : m_new;
      corr[i] = ex2((m[i] - m_safe) * kLog2e);
      mb[i] = m_safe * kLog2e;
      m[i] = m_safe + (dead ? NEG_INF : 0.f);
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], kLog2e, -mb[e >> 1]));
        rsum[e >> 1] += s[4 * j + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rsum[i]);
  };

  // Prologue: q and K_0 land, q is scale-folded in place, then K_1 and V_0
  // load while S_0 multiplies.
  sw_issue<D, BQB, THREADS>(sQ, qb, sq.s, q0, Sq);
  load_k(0);
  cp_async_commit();
  cp_async_wait<0>();
  sw_finish<D, BQB, THREADS>(sQ, q0, Sq, nullptr, nullptr, true, scale, off);
  proxy_fence();
  __syncthreads();
  if (n_tiles > 1) load_k(1);
  load_v(0);
  cp_async_commit();
  issue_s(s0, 0);
  wg_wait<0>();
  reg_fence(s0);

  // O = O·corr_n + P_n·V_n, once no product is in flight. At step 0 O and
  // corr are 0, so the rescale changes nothing there.
  auto rescale_pv = [&](int n) {
#pragma unroll
    for (int blk = 0; blk < DB; ++blk)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[blk][i] *= corr[(i >> 1) & 1];
    issue_pv(n);
    wg_wait<0>();
    reg_fence(pf);
#pragma unroll
    for (int blk = 0; blk < DB; ++blk) reg_fence(o[blk]);
  };
  auto pack_p = [&](float (&s)[NS]) {
#pragma unroll
    for (int j = 0; j < NP; ++j) pf[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  };
  // Step n < n_tiles - 1, S_n finished in `cur`: S_{n+1} multiplies into
  // `nxt` while the softmax of S_n runs; then P_n·V_n. Every wgmma of a step
  // is issued unconditionally.
  auto step = [&](float (&cur)[NS], float (&nxt)[NS], int n) {
    // K_{n+1} and V_n have landed everywhere; every warp is done with step
    // n - 1, so K_n's and V_{n-1}'s buffers take K_{n+2} and V_{n+1}.
    cp_async_wait<0>();
    proxy_fence();
    __syncthreads();
    if (n + 2 < n_tiles) load_k(n + 2);
    load_v(n + 1);
    cp_async_commit();
    issue_s(nxt, n + 1);
    softmax(cur, n);
    pack_p(cur);
    wg_wait<0>();  // S_{n+1}
    reg_fence(nxt);
    rescale_pv(n);
  };
  // The last step has no next product: the TPU probe's flush step.
  auto last = [&](float (&cur)[NS], int n) {
    cp_async_wait<0>();  // V_n
    proxy_fence();
    __syncthreads();
    softmax(cur, n);
    pack_p(cur);
    rescale_pv(n);
  };
  int n = 0;
  for (; n + 2 < n_tiles; n += 2) {
    step(s0, s1, n);
    step(s1, s0, n + 1);
  }
  if (n + 1 < n_tiles) {
    step(s0, s1, n);
    last(s1, n + 1);
  } else {
    last(s0, n);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int blk = 0; blk < DB; ++blk)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair<bf16>(ob + row[i] * so.s + 64 * blk + 8 * j + 2 * t,
                         o[blk][4 * j + 2 * i] / denom, o[blk][4 * j + 2 * i + 1] / denom);
    if (t == 0) lb[row[i]] = m[i] + logf(denom);
  }
}

template <int D>
int launch_pipe90(const void* q, const void* k, const void* v, void* out, void* lse,
                  const long long* st, int B, int H, int Sq, int Skv, int off, int causal,
                  float scale, cudaStream_t stream) {
  const size_t smem = pipe90_smem_bytes<D>();
  cudaError_t err = set_smem(flash_fwd_pipe_sm90_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const Bhsd sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  constexpr int BQB = kPipe90Wgs<D> * PIPE90_BQ;
  const dim3 grid((Sq + BQB - 1) / BQB, H, B);
  flash_fwd_pipe_sm90_kernel<D><<<grid, 128 * kPipe90Wgs<D>, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), sq, sk, sv, so, H, Sq, Skv, off, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtt_flash_fwd_pipe's contract (flash_fwd_pipe.cu) for bf16 operands at
// head_dim 64, 128 or 256; any other call returns cudaErrorInvalidValue.
// Returns a cudaError_t.
extern "C" int dtt_flash_fwd_pipe_sm90(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const long long* strides, int B, int H,
                                       int Sq, int Skv, int D, int is_bf16, int causal,
                                       int q_pos_offset, float scale, void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || !is_bf16) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_pipe90<64>(q, k, v, out, lse, strides, B, H, Sq, Skv, q_pos_offset, causal,
                             scale, st);
  if (D == 128)
    return launch_pipe90<128>(q, k, v, out, lse, strides, B, H, Sq, Skv, q_pos_offset, causal,
                              scale, st);
  if (D == 256)
    return launch_pipe90<256>(q, k, v, out, lse, strides, B, H, Sq, Skv, q_pos_offset, causal,
                              scale, st);
  return (int)cudaErrorInvalidValue;
}
