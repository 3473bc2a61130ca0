// Flash attention forward on strided (B, H, S, D) operands as a Hopper
// warpgroup kernel: both tile products are wgmma.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py:_flash_kernel wherever
// the call is bf16 at head_dim 64, 128 or 256 — through _flash_forward_qkv
// (:1660, K1, packed qkv with GQA and rope), _flash_forward (:481, K3, BHSD,
// cross-length), _flash_forward_bshd (:1261, K7, BSHD views) and the BSHD
// probe's forward (tools/bshd_probe.py:49, K10, head views of (B, S, H·dh)).
// f32 and head_dim 32 stay on flash_fwd.cu, whose C contract this file
// keeps: strided operands with a contiguous last dimension, GQA by head
// group, q_pos_offset and Sq != Skv with end-aligned causal masking, causal,
// window and non-causal masking, rope tables read at each row's position,
// and, for a row that attends nothing, out exactly 0 and lse NEG_INF +
// log(1e-30).
//
// Bound on this card: at the flagship call (B 12, S 2048, 16 heads of 128,
// causal) ~2.1e11 FLOPs against ~0.4 GB moved, so the tensor cores bound it
// (about 0.21 ms at 989 TFLOP/s). Only wgmma reaches that rate; flash_fwd.cu's
// per-warp mma.sync reads every fragment from shared memory in each warp.
//
// Design. One warpgroup (128 threads) per 64-row q tile; at head_dim 64 and
// 128 one warpgroup a block and two blocks an SM, at 256 two warpgroups a
// block (each its own 64-row q tile, the two sharing the K and V tiles) and
// one block an SM: there a warpgroup's O alone is 128 f32 registers a
// thread, and q plus two K and two V tiles take 160 KB, so a second block
// would not fit beside the first; sharing K and V halves the loads a q row
// costs. Blocks run over (q tile, q head, batch), the q tiles with the most
// keys first. Per 64-key kv tile n, each warpgroup:
//   S = (q·s)·Kᵀ        wgmma m64n64k16, both operands K-major in shared
//                       memory
//   P = exp(S − m)      online softmax in f32 on the S accumulator: exp2 on
//                       the special-function unit of log2e-scaled logits
//                       (log2e applied in f32 here, not folded into q, so
//                       that q·s keeps the rounding of the plain version);
//                       the mask is skipped on tiles wholly inside the band
//   O = O·corr + P·V    A from registers (the bf16 conversion of the P
//                       accumulator is the A fragment), V MN-major in shared
//                       memory; O is D/64 accumulators of 64 x 64
// Step n issues S_n and then P·V_{n-1} as two commit groups, and the
// softmax of S_n runs while P·V_{n-1} multiplies (K9's overlap of one
// tile's softmax with a tensor-core product); both retire inside the step,
// so no wgmma group lives across the loop's back edge, which is what lets
// ptxas keep the products asynchronous (a group left in flight into the
// next step made it serialise them, C7514). K and V are double-buffered by
// cp.async in the 128-byte swizzle, K one tile ahead of V: step n holds K_n
// and V_{n-1} and loads K_{n+1} and V_n into the buffers step n - 1 freed,
// so one block barrier a step covers every hand-off. At 64 and 128 two
// blocks an SM, rather than two warpgroups of one block, let one block's
// softmax, loads and barrier overlap the other's products without a shared
// barrier. At 256 a block's kv range is that of its later q tile, so under
// causal masking its earlier warpgroup multiplies one tile that is wholly
// masked for it (the mask zeroes it). q is rotated (rope) and scale-folded
// in place once per block, on the swizzled tile; the split-half rope pairs
// columns i and i + D/2, which sit in 64-column blocks i/64 and i/64 + D/128,
// and the thread that copies one chunk of a pair copies the other too.
// Under rope, k is rotated once per call by flash_fwd_rotate_k
// (sm90_common.cuh) into a (B, KV, Skv, D) scratch the caller allocates,
// rounded as the plain version rounds it, so the main kernel reads k with no
// rope (flash_fwd.cu rotates every K tile again in each of a head's q-tile
// blocks). TMA, mbarrier rings, producer/consumer warp specialisation with
// setmaxnreg and persistent blocks are the next levers.
#include "sm90_common.cuh"

namespace dtt {

constexpr int FWD90_BQ = 64, FWD90_BKV = 64;  // rows of a warpgroup's q tile, of a kv tile

// Warpgroups a block: two at head_dim 256, which share their K and V tiles.
template <int D>
constexpr int kFwd90Wgs = D == 256 ? 2 : 1;
template <int D>
constexpr int kFwd90Threads = 128 * kFwd90Wgs<D>;

template <int D>
constexpr size_t fwd90_smem_bytes() {
  // The warpgroups' q tiles, two K and two V tiles, and room to align the
  // base to 1024 bytes.
  return sizeof(bf16) * (kFwd90Wgs<D> * FWD90_BQ + 4 * FWD90_BKV) * D + 1024;
}

template <int D>
__global__ void __launch_bounds__(kFwd90Threads<D>, kFwd90Wgs<D> == 1 ? 2 : 1)
flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, const float* __restrict__ cos,
                      const float* __restrict__ sin, Bhsd sq, Bhsd sk, Bhsd sv, Bhsd so, int H,
                      int group, int Sq, int Skv, int off, int causal, int window,
                      long long tstride, float scale) {
  // DB: 64-column blocks; BQB: q rows a block, BQ a warpgroup.
  constexpr int BQ = FWD90_BQ, BKV = FWD90_BKV, DB = D / 64, THREADS = kFwd90Threads<D>;
  constexpr int BQB = kFwd90Wgs<D> * BQ;
  static_assert(D == 64 || D == 128 || D == 256, "head_dim 64, 128 or 256");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_at(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));  // BQB rows
  bf16* sK = sQ + BQB * D;      // two tiles
  bf16* sV = sK + 2 * BKV * D;  // two tiles

  const int num_q = (Sq + BQB - 1) / BQB;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * BQB;  // the tiles with the most keys first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  bf16* ob = out + b * so.b + h * so.h;
  float* lb = lse + ((size_t)b * H + h) * Sq;
  // Rope tables are indexed by position: q row r sits at r + off.
  const float* cb = cos == nullptr ? nullptr : cos + b * tstride;
  const float* sb = sin == nullptr ? nullptr : sin + b * tstride;
  const int wg = threadIdx.x >> 7;        // the warpgroup: rows [64wg, +64) of the block's
  const int wi = (threadIdx.x >> 5) & 3;  // the warp: rows [16wi, +16) of the warpgroup's
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + BQ * wg + 16 * wi;  // the warp's first q row
  const int row[2] = {r_lo + g, r_lo + g + 8};

  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, min(q0 + BQB, Sq) + off);  // keys up to the last row's position
    if (window > 0) kv_begin = max(0, q0 + off - (window - 1)) / BKV * BKV;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
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
  auto key0 = [&](int n) { return kv_begin + n * BKV; };
  // sw_issue for the K and V tiles with the address arithmetic hoisted out
  // of the kv loop: this thread copies the 16-byte chunks at rows kr0 +
  // RPR·it, columns kc and kc + D/2, whose swizzled offsets are the same in
  // every round (RPR is a multiple of 8) and every tile.
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
  auto load_k = [&](int n) { load_tile(k_tile(n), kb, sk.s, key0(n)); };
  auto load_v = [&](int n) { load_tile(v_tile(n), vb, sv.s, key0(n)); };
  float s[32], o[DB][32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pf[16];
#pragma unroll
  for (int blk = 0; blk < DB; ++blk)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[blk][i] = 0.f;

  // S = (q·s)·K_nᵀ, one commit group.
  auto issue_s = [&](int n) {
    const uint32_t aQ = smem_at(sQ), aK = smem_at(k_tile(n));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0, 0>(s, desc_k(aQ + 2 * sw<BQB>(BQ * wg, 16 * kk)),
                   desc_k(aK + 2 * sw<BKV>(0, 16 * kk)), kk > 0);
    wg_commit();
  };
  // O += P·V_n, one commit group: P rounded to bf16 (the TPU kernel's p) is
  // the A fragments, k-step kk taking keys [16kk, +16) from fragments
  // 4kk..4kk+3.
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
  // Online softmax of S_n in place: P = exp(S − m) as exp2 of log2e-scaled
  // logits, the running max m and sum l updated, corr the factor O takes.
  // Tiles wholly inside the causal/window band skip the per-element mask.
  auto softmax = [&](int n) {
    const int k0 = key0(n), p_lo = r_lo + off;  // p_lo: the warp's first row's position
    const bool full = k0 + BKV <= Skv &&
                      (!causal || (k0 + BKV - 1 <= p_lo &&
                                   (window <= 0 || k0 > p_lo + 15 - window)));
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full &&
            !attends_at(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), Sq, Skv, off, causal, window))
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
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], kLog2e, -mb[e >> 1]));
        rsum[e >> 1] += s[4 * j + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rsum[i]);
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < 16; ++j) pf[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  };

  sw_issue<D, BQB, THREADS>(sQ, qb, sq.s, q0, Sq);
  load_k(0);
  cp_async_commit();
  cp_async_wait<0>();
  sw_finish<D, BQB, THREADS>(sQ, q0, Sq, cb, sb, true, scale, off);
  proxy_fence();
  __syncthreads();
  if (n_tiles > 1) load_k(1);
  load_v(0);
  cp_async_commit();
  issue_s(0);
  wg_wait<0>();
  reg_fence(s);
  softmax(0);  // O is still zero: nothing to rescale
  pack_p();

  // Step n: S_n and P·V_{n-1} multiply while nothing else does; the
  // softmax of S_n runs while P·V_{n-1} still multiplies. Every group
  // retires inside its step, so ptxas keeps both products asynchronous.
  for (int n = 1; n < n_tiles; ++n) {
    // K_n and V_{n-1} have landed everywhere; every warp is done with step
    // n - 1, so K_{n-1}'s and V_{n-2}'s buffers take K_{n+1} and V_n.
    cp_async_wait<0>();
    proxy_fence();
    __syncthreads();
    if (n + 1 < n_tiles) load_k(n + 1);
    load_v(n);
    cp_async_commit();
    issue_s(n);
    issue_pv(n - 1);
    wg_wait<1>();
    reg_fence(s);
    softmax(n);
    wg_wait<0>();
    reg_fence(pf);
#pragma unroll
    for (int blk = 0; blk < DB; ++blk) {
      reg_fence(o[blk]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[blk][i] *= corr[(i >> 1) & 1];
    }
    pack_p();
  }
  cp_async_wait<0>();  // V of the last tile
  proxy_fence();
  __syncthreads();
  issue_pv(n_tiles - 1);
  wg_wait<0>();
  reg_fence(pf);
#pragma unroll
  for (int blk = 0; blk < DB; ++blk) reg_fence(o[blk]);

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
int launch_fwd90(const void* q, const void* k, const void* v, void* out, void* lse,
                 const void* cos, const void* sin, void* k_rot, const long long* st, int B,
                 int H, int KV, int Sq, int Skv, int off, int causal, int window,
                 long long tstride, float scale, cudaStream_t stream) {
  const size_t smem = fwd90_smem_bytes<D>();
  cudaError_t err = set_smem(flash_fwd_sm90_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const Bhsd sq{st[0], st[1], st[2]}, sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  Bhsd sk{st[3], st[4], st[5]};
  if (cos != nullptr) {  // k rotated once, into the caller's contiguous scratch
    const long long n = (long long)B * KV * Skv * (D / 16);
    flash_fwd_rotate_k<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(cos),
        static_cast<const float*>(sin), static_cast<bf16*>(k_rot), sk, KV, Skv, tstride, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k = k_rot;
    sk = Bhsd{(long long)KV * Skv * D, (long long)Skv * D, D};
  }
  constexpr int BQB = kFwd90Wgs<D> * FWD90_BQ;
  const dim3 grid((Sq + BQB - 1) / BQB, H, B);
  flash_fwd_sm90_kernel<D><<<grid, kFwd90Threads<D>, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), static_cast<const float*>(cos),
      static_cast<const float*>(sin), sq, sk, sv, so, H, H / KV, Sq, Skv, off, causal, window,
      tstride, scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtt_flash_fwd's contract (flash_fwd.cu) for bf16 operands at head_dim 64,
// 128 or 256, plus `k_rot`: with rope tables, a contiguous (B, KV, Skv, D) bf16
// scratch that receives k rotated once (flash_fwd_rotate_k) and is what the
// main kernel reads; unused (may be null) without them. Any other call
// returns cudaErrorInvalidValue. Returns a cudaError_t.
extern "C" int dtt_flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                                  void* lse, const void* cos, const void* sin,
                                  const long long* strides, int B, int H, int KV, int Sq,
                                  int Skv, int D, int is_bf16, int causal, int window,
                                  int q_pos_offset, long long tstride, float scale, void* k_rot,
                                  void* stream) {
  using namespace dtt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV || !is_bf16)
    return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (q_pos_offset < 0 || q_pos_offset + Sq > Skv || k_rot == nullptr))
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_fwd90<64>(q, k, v, out, lse, cos, sin, k_rot, strides, B, H, KV, Sq, Skv,
                            q_pos_offset, causal, window, tstride, scale, st);
  if (D == 128)
    return launch_fwd90<128>(q, k, v, out, lse, cos, sin, k_rot, strides, B, H, KV, Sq, Skv,
                             q_pos_offset, causal, window, tstride, scale, st);
  if (D == 256)
    return launch_fwd90<256>(q, k, v, out, lse, cos, sin, k_rot, strides, B, H, KV, Sq, Skv,
                             q_pos_offset, causal, window, tstride, scale, st);
  return (int)cudaErrorInvalidValue;
}
