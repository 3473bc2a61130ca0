// Pieces shared by the warpgroup (wgmma) kernels for Hopper
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, flash_bwd_dq_sm90.cu,
// flash_fwd_pipe_sm90.cu, flash_fwd_cols_sm90.cu, flash_bwd_cols_sm90.cu,
// flash_bwd_dq_cols_sm90.cu): the 128-byte-swizzled shared tile layout, its
// row-tile loader with the split-half rope rotation and q-scale fold, a
// loader of a column range of a row tile (sw_issue_cols), wgmma's
// shared-memory descriptors, fences and waits, the
// m64n64k16 bf16 products with both operands in shared memory (mma_ss; also
// m64n32k16 for 32-key tiles) or A from registers (mma_rs), exp2 on the
// special-function unit, bf16 packing, and the pass that rotates k once a
// call under rope (flash_fwd_rotate_k, for the forward and the two-pass dq
// kernel). The loaders take the block's thread count: SM90_THREADS, two
// warpgroups, for the backward and the kernels with two warpgroups a block;
// one warpgroup for the others.
#pragma once

#include "flash_common.cuh"

namespace dtt {

constexpr int SM90_THREADS = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Element offset of (r, c) in a tile of R rows stored in wgmma's 128-byte
// swizzle: 64-column blocks of R rows x 128 bytes, 16-byte chunk c of row r
// at chunk c ^ (r % 8) of that row. A tile starts 1024-byte aligned.
template <int R>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 6) * (R * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// tile_issue/tile_finish (flash_common.cuh) on the swizzled layout: rows
// [row0, row0 + R) of one head's (S, D) bf16 rows, `ld` elements apart, zero
// past S. A thread owns the 16-byte chunks at columns i0 and i0 + D/2 of a
// row in both, so it transforms only what it copied itself and needs no
// barrier between its cp.async wait and the rotation.
template <int D, int R, int THREADS = SM90_THREADS>
__device__ __forceinline__ void sw_issue(bf16* dst, const bf16* src, long long ld, int row0,
                                         int S) {
  constexpr int half = D / 2, CPH = half / 8, N = R * CPH;
  static_assert(N % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < N / THREADS; ++it) {
    const int idx = it * THREADS + (int)threadIdx.x, r = idx / CPH, i0 = (idx % CPH) * 8;
    bf16* d1 = dst + sw<R>(r, i0);
    bf16* d2 = dst + sw<R>(r, i0 + half);
    if (row0 + r < S) {
      const bf16* p = src + (long long)(row0 + r) * ld + i0;
      cp_async16(d1, p);
      cp_async16(d2, p + half);
    } else {
      *reinterpret_cast<uint4*>(d1) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(d2) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int D, int R, int THREADS = SM90_THREADS>
__device__ __forceinline__ void sw_finish(bf16* dst, int row0, int S, const float* cos,
                                          const float* sin, bool fold, float scale, int tpos) {
  constexpr int half = D / 2, CPH = half / 8, N = R * CPH;
  if (cos == nullptr && !fold) return;
  // One round at a time: unrolled, the rounds' table loads would all be in
  // flight beside the dK/dV accumulators.
#pragma unroll 1
  for (int it = 0; it < N / THREADS; ++it) {
    const int idx = it * THREADS + (int)threadIdx.x, r = idx / CPH, i0 = (idx % CPH) * 8;
    const int grow = row0 + r;
    if (grow >= S) continue;
    bf16* d1 = dst + sw<R>(r, i0);
    bf16* d2 = dst + sw<R>(r, i0 + half);
    const size_t trow = (size_t)(grow + tpos) * half;
    alignas(16) bf16 x1[8], x2[8];
    alignas(16) float c[8], s[8];
    *reinterpret_cast<uint4*>(x1) = *reinterpret_cast<const uint4*>(d1);
    *reinterpret_cast<uint4*>(x2) = *reinterpret_cast<const uint4*>(d2);
    if (cos != nullptr) {
#pragma unroll
      for (int v = 0; v < 8; v += 4) {
        *reinterpret_cast<float4*>(c + v) = *reinterpret_cast<const float4*>(cos + trow + i0 + v);
        *reinterpret_cast<float4*>(s + v) = *reinterpret_cast<const float4*>(sin + trow + i0 + v);
      }
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float y1 = to_f32<bf16>(x1[v]), y2 = to_f32<bf16>(x2[v]);
      if (cos != nullptr) {
        const float a = y1, b = y2;
        y1 = round_to<bf16>(a * c[v] - b * s[v]);
        y2 = round_to<bf16>(b * c[v] + a * s[v]);
      }
      if (fold) {
        y1 *= scale;
        y2 *= scale;
      }
      x1[v] = from_f32<bf16>(y1);
      x2[v] = from_f32<bf16>(y2);
    }
    *reinterpret_cast<uint4*>(d1) = *reinterpret_cast<uint4*>(x1);
    *reinterpret_cast<uint4*>(d2) = *reinterpret_cast<uint4*>(x2);
  }
}

// Columns [c0, c0 + W) of rows [row0, +R) of a (S, D) bf16 source whose rows
// lie `ld` elements apart, by 16-byte cp.async into a swizzled sw<R> tile
// (absolute columns); rows past S are zeros. THREADS threads starting at
// thread `tid`.
template <int R, int W, int THREADS>
__device__ __forceinline__ void sw_issue_cols(bf16* dst, const bf16* src, long long ld, int row0,
                                              int S, int c0, int tid) {
  constexpr int CPR = W / 8, N = R * CPR;
  static_assert(N % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < N / THREADS; ++it) {
    const int idx = it * THREADS + tid, r = idx / CPR, c = c0 + (idx % CPR) * 8;
    bf16* d = dst + sw<R>(r, c);
    if (row0 + r < S) {
      cp_async16(d, src + (long long)(row0 + r) * ld + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 in bits
// 62-63. K-major operands (16 k-elements contiguous within a 128-byte row):
// stride 1024 bytes between 8-row groups, leading offset unused. MN-major
// operands (rows are k, N or M <= 64 contiguous within a row): 1024 bytes
// between the two 8-row k groups; the leading offset (between 64-wide MN
// blocks) is never crossed and set alike.
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k(uint32_t a) { return desc(a, 16, 1024); }
__device__ __forceinline__ uint64_t desc_mn(uint32_t a) { return desc(a, 1024, 1024); }

__device__ __forceinline__ uint32_t smem_at(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes by threads (st.shared, cp.async) made visible to the
// async proxy that wgmma reads through; a barrier follows.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the
// fences and waits (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void reg_fence(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// 2^x on the special-function unit (flush-to-zero): P rounds to bf16.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k (B, KV, Skv, D), strided, into k_rot (B, KV, Skv, D) contiguous, each row
// r rotated split-half by the tables' row r in f32 and rounded to bf16: the
// plain version's arithmetic (ops/rope.py apply_rope), with no fused
// multiply-add, so the two agree bit for bit. A thread owns the 16-byte
// chunks at columns i0 and i0 + D/2 of a row.
template <int D>
__global__ void flash_fwd_rotate_k(const bf16* __restrict__ k, const float* __restrict__ cos,
                                   const float* __restrict__ sin, bf16* __restrict__ k_rot,
                                   Bhsd sk, int KV, int Skv, long long tstride, long long n) {
  constexpr int half = D / 2, CPH = half / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long row = idx / CPH;  // (b·KV + h)·Skv + s
  const int i0 = (int)(idx % CPH) * 8;
  const long long s = row % Skv, h = (row / Skv) % KV, b = row / ((long long)KV * Skv);
  const bf16* src = k + b * sk.b + h * sk.h + s * sk.s + i0;
  const float* cr = cos + b * tstride + s * half + i0;
  const float* sr = sin + b * tstride + s * half + i0;
  alignas(16) bf16 x1[8], x2[8];
  alignas(16) float c[8], sn[8];
  *reinterpret_cast<uint4*>(x1) = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<uint4*>(x2) = *reinterpret_cast<const uint4*>(src + half);
#pragma unroll
  for (int v = 0; v < 8; v += 4) {
    *reinterpret_cast<float4*>(c + v) = *reinterpret_cast<const float4*>(cr + v);
    *reinterpret_cast<float4*>(sn + v) = *reinterpret_cast<const float4*>(sr + v);
  }
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float a = to_f32<bf16>(x1[v]), bb = to_f32<bf16>(x2[v]);
    x1[v] = from_f32<bf16>(__fsub_rn(__fmul_rn(a, c[v]), __fmul_rn(bb, sn[v])));
    x2[v] = from_f32<bf16>(__fadd_rn(__fmul_rn(bb, c[v]), __fmul_rn(a, sn[v])));
  }
  bf16* dst = k_rot + row * D + i0;
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(x1);
  *reinterpret_cast<uint4*>(dst + half) = *reinterpret_cast<uint4*>(x2);
}

#define DTT_ACC32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define DTT_REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32, the warpgroup's accumulator fragment: thread (warp w, lane
// g·4 + t) holds d[4j + e] at row 16w + g + 8(e/2), column 8j + 2t + e%2)
// = [d +] A (64 x 16) · B (16 x 64), both from shared memory; TA/TB = 1 for
// an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DTT_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : DTT_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

#define DTT_ACC16(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define DTT_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// The same at N = 32 (m64n32k16), for 32-key score tiles: the accumulator
// layout above with j < 4. Overloaded on the accumulator's size, so a kernel
// templated on its kv tile calls mma_ss either way.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DTT_REGS16
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : DTT_ACC16(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d += A (64 x 16, from registers: a[0..3] are mma.sync's A fragment of the
// thread's warp rows, which is the accumulator layout above, two columns a
// register) · B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DTT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DTT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace dtt
