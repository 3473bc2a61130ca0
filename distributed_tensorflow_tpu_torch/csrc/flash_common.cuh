// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// on strided (B, H, S, D) operands): dtype conversions, the asynchronous
// row-tile loader with the split-half rope rotation, a one-warp tile
// product on mma.sync, and the column split of head dims above 128.
//
// Tile products: every operand is read from shared memory through a strided
// view (ldmatrix for bf16) and the sum lives in registers in the C-fragment
// layout of mma.sync.m16n8k16 — lane (g = lane/4, t = lane%4) holds acc[j][e] at
// row g + 8*(e/2), column 8*j + 2*t + e%2. bf16 operands go through the
// tensor cores (f32 accumulation); f32 operands are summed with FMAs into
// the same fragment layout, so the softmax code around the products is one
// code path for both dtypes and f32 keeps full precision (no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dtt {

constexpr float NEG_INF = -1e30f;  // ops/attention.py NEG_INF

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// Round f32 through T and back: what casting to the operand dtype does.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32<T>(from_f32<T>(x)); }

// Row padding of shared tiles: 16 bytes, so consecutive rows start 4 banks
// apart and the fragment loads of one warp hit 32 distinct banks.
template <typename T>
constexpr int kPad = 16 / sizeof(T);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// Wait until at most N of this thread's most recent copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tiles of one head's (S, D) rows, `ldg` elements apart in global memory,
// rows [row0, row0 + NROWS), staged in shared memory with row stride `lds`
// in two steps. tile_issue starts 16-byte asynchronous copies (the wrapper
// checks 16-byte alignment) and zero-fills rows at or past S (masked later;
// zeros keep 0·x finite). Once this thread's copies have landed,
// tile_finish transforms the same elements in place: with tables (`cos` !=
// nullptr, rows of D/2 f32 indexed by position; tile row r sits at position
// row0 + r + `tpos`, so a q segment placed by q_pos_offset reads its own
// rows of the tables) each row is rotated
// split-half in f32 and rounded to T; with `fold` it is then multiplied by
// `scale` in f32 and rounded again — the kernels' q operand, as the Pallas
// kernels and the plain version round it. A thread owns the vectors at
// columns i0 and i0 + D/2 of a row, so the rotation needs no other thread's
// data.
template <typename T, int D, int NROWS, int THREADS>
__device__ __forceinline__ void tile_issue(T* dst, int lds, const T* src, int ldg, int row0,
                                           int S) {
  constexpr int half = D / 2, V = 16 / sizeof(T), VPR = half / V, N = NROWS * VPR;
#pragma unroll
  for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
    const int idx = it * THREADS + (int)threadIdx.x;
    if (N % THREADS != 0 && idx >= N) break;
    const int r = idx / VPR, i0 = (idx % VPR) * V;
    T* d = dst + r * lds + i0;
    if (row0 + r < S) {
      const T* p = src + (size_t)(row0 + r) * ldg + i0;
      cp_async16(d, p);
      cp_async16(d + half, p + half);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(d + half) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <typename T, int D, int NROWS, int THREADS>
__device__ __forceinline__ void tile_finish(T* dst, int lds, int row0, int S, const float* cos,
                                            const float* sin, bool fold, float scale,
                                            int tpos) {
  constexpr int half = D / 2, V = 16 / sizeof(T), VPR = half / V, N = NROWS * VPR;
  if (cos == nullptr && !fold) return;
#pragma unroll
  for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
    const int idx = it * THREADS + (int)threadIdx.x;
    if (N % THREADS != 0 && idx >= N) break;
    const int r = idx / VPR, i0 = (idx % VPR) * V, grow = row0 + r;
    if (grow >= S) continue;
    const size_t trow = (size_t)(grow + tpos) * half;
    T* d = dst + r * lds + i0;
    alignas(16) T x1[V], x2[V];
    alignas(16) float c[V], s[V];
    *reinterpret_cast<uint4*>(x1) = *reinterpret_cast<const uint4*>(d);
    *reinterpret_cast<uint4*>(x2) = *reinterpret_cast<const uint4*>(d + half);
    if (cos != nullptr) {
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        *reinterpret_cast<float4*>(c + v) =
            *reinterpret_cast<const float4*>(cos + trow + i0 + v);
        *reinterpret_cast<float4*>(s + v) =
            *reinterpret_cast<const float4*>(sin + trow + i0 + v);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float y1 = to_f32<T>(x1[v]), y2 = to_f32<T>(x2[v]);
      if (cos != nullptr) {
        const float a = y1, b = y2;
        y1 = round_to<T>(a * c[v] - b * s[v]);
        y2 = round_to<T>(b * c[v] + a * s[v]);
      }
      if (fold) {
        y1 *= scale;
        y2 *= scale;
      }
      x1[v] = from_f32<T>(y1);
      x2[v] = from_f32<T>(y2);
    }
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<uint4*>(x1);
    *reinterpret_cast<uint4*>(d + half) = *reinterpret_cast<uint4*>(x2);
  }
}

// Store two adjacent elements (columns c, c + 1 of a C fragment) at once.
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l%8 of matrix l/8. Without .trans lane (g, t) receives row g, columns
// 2t..2t+1 of each matrix; with .trans, of its transpose.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  }
}

// acc[NT][4] += A (16 x K) · B (K x 8·NT), one warp, operands in shared memory:
//   A(m, k) = A_KCONTIG ? a[m * lda + k] : a[k * lda + m]
//   B(k, n) = B_KCONTIG ? b[n * ldb + k] : b[k * ldb + n]
// K is a multiple of 16 and NT even; rows start 16-byte aligned. bf16
// fragments come from ldmatrix (transposed where k is not the contiguous
// axis): A's four matrices are (rows 0-7 | 8-15) x (k 0-7 | 8-15), and B's
// are n-tiles j, j+1 x (k 0-7 | 8-15), which is mma.m16n8k16's fragment
// order.
template <typename T, int NT, int K, bool A_KCONTIG, bool B_KCONTIG>
__device__ __forceinline__ void warp_mma(float (*acc)[4], const T* a, int lda, const T* b,
                                         int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4];
      if constexpr (A_KCONTIG) {
        ldsm_x4<false>(af, a + ((mat & 1) * 8 + r8) * lda + k0 + (mat >> 1) * 8);
      } else {
        ldsm_x4<true>(af, a + (k0 + (mat >> 1) * 8 + r8) * lda + (mat & 1) * 8);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];
        if constexpr (B_KCONTIG) {
          ldsm_x4<false>(bf, b + (8 * (j + (mat >> 1)) + r8) * ldb + k0 + (mat & 1) * 8);
        } else {
          ldsm_x4<true>(bf, b + (k0 + (mat & 1) * 8 + r8) * ldb + 8 * (j + (mat >> 1)));
        }
        mma_16816(acc[j], af, bf[0], bf[1]);
        mma_16816(acc[j + 1], af, bf[2], bf[3]);
      }
    }
  } else {
    auto A = [&](int m, int k) { return A_KCONTIG ? a[m * lda + k] : a[k * lda + m]; };
    auto B = [&](int k, int n) { return B_KCONTIG ? b[n * ldb + k] : b[k * ldb + n]; };
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = A(g, k), a1 = A(g + 8, k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + 2 * t;
        const float b0 = B(k, n), b1 = B(k, n + 1);
        acc[j][0] = fmaf(a0, b0, acc[j][0]);
        acc[j][1] = fmaf(a0, b1, acc[j][1]);
        acc[j][2] = fmaf(a1, b0, acc[j][2]);
        acc[j][3] = fmaf(a1, b1, acc[j][3]);
      }
    }
  }
}

// Head dims above 128 split the columns of a kernel's f32 accumulators (out,
// dq, dk and dv) over blocks, kCols<D> a block: at D 256 the whole row would
// not fit in a thread's 255 registers beside the score tile. A block still
// multiplies every column of q·kᵀ and dO·vᵀ, and owns columns [c0, c0 +
// kCols/2) and [D/2 + c0, +kCols/2), so that the split-half rope's pairs
// (i, i + D/2) stay in one block. kCols<D> == D (one block, c0 0) up to 128.
template <int D>
constexpr int kCols = D > 128 ? 128 : D;

// Global column of accumulator fragment j (of NT = kCols/8) and lane t in a
// block that owns the columns at c0.
template <int D>
__device__ __forceinline__ int block_col(int j, int c0, int t) {
  constexpr int NT = kCols<D> / 8;
  return (j < NT / 2 ? c0 + 8 * j : D / 2 + c0 + 8 * (j - NT / 2)) + 2 * t;
}

// warp_mma with a row-major B (B(k, n) = b[k * ldb + n]) restricted to the
// columns a block owns (block_col): acc[0, NT/2) from B's columns c0..., acc
// [NT/2, NT) from D/2 + c0... One product when the block owns all D.
template <typename T, int NT, int K, bool A_KCONTIG, int D>
__device__ __forceinline__ void warp_mma_cols(float (*acc)[4], const T* a, int lda, const T* b,
                                              int ldb, int c0) {
  if constexpr (8 * NT == D) {
    warp_mma<T, NT, K, A_KCONTIG, false>(acc, a, lda, b, ldb);
  } else {
    warp_mma<T, NT / 2, K, A_KCONTIG, false>(acc, a, lda, b + c0, ldb);
    warp_mma<T, NT / 2, K, A_KCONTIG, false>(acc + NT / 2, a, lda, b + D / 2 + c0, ldb);
  }
}

// Sum a per-row value over the four lanes (t = 0..3) that share a row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Element strides of a (B, H, S, D) operand whose last dimension is
// contiguous: element (b, h, s, d) sits at b·b + h·h + s·s + d. A contiguous
// BHSD tensor and a head-transposed view of a (B, S, H·D) projection are both
// such operands.
struct Bhsd {
  long long b, h, s;
};

// Whether query row qr (of Sq) attends key kp (of Skv) when the query's
// position is qr + off — end-aligned causal masking for Sq != Skv, and the
// position of a q segment inside a longer sequence.
__device__ __forceinline__ bool attends_at(int qr, int kp, int Sq, int Skv, int off, int causal,
                                           int window) {
  if (qr >= Sq || kp >= Skv) return false;
  if (!causal) return true;
  const int qp = qr + off;
  return kp <= qp && (window <= 0 || kp > qp - window);
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace dtt
