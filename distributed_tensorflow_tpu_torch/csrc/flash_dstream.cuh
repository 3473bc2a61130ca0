// Shared pieces of the column-group flash-attention kernels for head dims
// above 256 (flash_fwd_dstream.cu, flash_bwd_dstream.cu,
// flash_bwd_dq_dstream.cu), which take the head dim D at run time (a
// multiple of 128): the chunk loader, the prepare pass that gives the kernels
// q rotated and scale-folded (and k rotated) once a call, and the launch
// helpers of those passes. The warpgroup kernels at 384 and 512
// (flash_fwd_cols_sm90.cu, flash_bwd_cols_sm90.cu,
// flash_bwd_dq_cols_sm90.cu) take the same passes.
//
// Why a pass: the split-half rope pairs column i with i + D/2, which lie in
// two different 128-column groups, so no block of these kernels holds both
// halves of a pair. q is rotated at its rows' positions in f32, rounded to
// the operand dtype, multiplied by the softmax scale and rounded again (the
// order of the plain version and of the other kernels' tile_finish), k
// rotated and rounded, each into a contiguous scratch the wrapper allocates;
// the products then read those and need no table. The gradients go the other
// way: dq and dk are summed in f32 scratch and rotated back by the dq pass of
// flash_bwd_passes.cuh, which takes D at run time. Without rope the pass
// still folds the scale into q; k is read in place.
#pragma once

#include "flash_bwd_passes.cuh"

namespace dtt {

constexpr int DS_CH = 64;      // columns of a D chunk streamed through shared memory
constexpr int DS_GROUP = 128;  // output columns a block owns (its column group)
constexpr int DS_THREADS = 128;

// Rows [row0, row0 + NROWS) x W columns of a row-major source whose rows lie
// `ldg` elements apart, by 16-byte cp.async, into shared rows `lds` apart;
// rows at or past S are zero-filled (masked later; zeros keep 0·x finite).
// `src` points at the first column; every row start is 16-byte aligned (the
// wrapper checks the strides, and chunk offsets are multiples of 64).
template <typename T, int W, int NROWS>
__device__ __forceinline__ void rows_issue(T* dst, int lds, const T* src, long long ldg, int row0,
                                           int S) {
  constexpr int V = 16 / sizeof(T), VPR = W / V, N = NROWS * VPR;
  static_assert(N % DS_THREADS == 0, "a tile is a whole number of sweeps");
#pragma unroll
  for (int it = 0; it < N / DS_THREADS; ++it) {
    const int idx = it * DS_THREADS + (int)threadIdx.x;
    const int r = idx / VPR, c = (idx % VPR) * V;
    T* d = dst + r * lds + c;
    if (row0 + r < S) {
      cp_async16(d, src + (long long)(row0 + r) * ldg + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// src (B, n, S, D) through its (b, h, s) strides into dst (B, n, S, D)
// contiguous. With tables each row s is rotated split-half by the tables'
// row s + pos in f32 and rounded to T, with no fused multiply-add, so the
// pass equals the plain version's rotation (ops/rope.py apply_rope) bit for
// bit; with `fold` the result is multiplied by `scale` in f32 and rounded
// again. One thread per (row, pair i).
template <typename T>
__global__ void dstream_prep_kernel(const T* __restrict__ src, Bhsd ss, T* __restrict__ dst,
                                    const float* __restrict__ cos, const float* __restrict__ sin,
                                    int n, int S, int D, int pos, long long tstride, int fold,
                                    float scale, long long pairs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const int half = D / 2;
  const long long row = idx / half;  // (b·n + h)·S + s
  const int i = (int)(idx % half);
  const long long s = row % S, h = (row / S) % n, b = row / ((long long)n * S);
  const T* p = src + b * ss.b + h * ss.h + s * ss.s;
  float y1 = to_f32<T>(p[i]), y2 = to_f32<T>(p[i + half]);
  if (cos != nullptr) {
    const long long at = b * tstride + (s + pos) * half + i;
    const float c = cos[at], sn = sin[at], x1 = y1, x2 = y2;
    y1 = round_to<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
    y2 = round_to<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn)));
  }
  if (fold) {
    y1 = __fmul_rn(y1, scale);
    y2 = __fmul_rn(y2, scale);
  }
  dst[row * D + i] = from_f32<T>(y1);
  dst[row * D + i + half] = from_f32<T>(y2);
}

template <typename T>
cudaError_t dstream_prep(const void* src, Bhsd ss, void* dst, const void* cos, const void* sin,
                         int B, int n, int S, int D, int pos, long long tstride, int fold,
                         float scale, cudaStream_t stream) {
  const long long pairs = (long long)B * n * S * (D / 2);
  dstream_prep_kernel<T><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(src), ss, static_cast<T*>(dst), static_cast<const float*>(cos),
      static_cast<const float*>(sin), n, S, D, pos, tstride, fold, scale, pairs);
  return cudaGetLastError();
}

// An f32 (B, n, S, D) sum rotated back (rope, the tables' row s + pos) and
// cast into the caller's strided layout: the dq pass of flash_bwd_passes.cuh,
// which serves dk as well (n = KV heads, pos 0).
template <typename T>
cudaError_t dstream_unrotate(const void* acc, const void* cos, const void* sin, void* dst,
                             Bhsd sd, int B, int n, int S, int D, int pos, long long tstride,
                             cudaStream_t stream) {
  const long long pairs = (long long)B * n * S * (D / 2);
  const unsigned blocks = (unsigned)((pairs + 255) / 256);
  if (cos != nullptr) {
    flash_bwd_dq_kernel<T, true><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(acc), static_cast<const float*>(cos),
        static_cast<const float*>(sin), static_cast<T*>(dst), sd, n, S, D, pos, tstride, pairs);
  } else {
    flash_bwd_dq_kernel<T, false><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(acc), nullptr, nullptr, static_cast<T*>(dst), sd, n, S, D, pos,
        tstride, pairs);
  }
  return cudaGetLastError();
}

// The contiguous (b, h, s) strides of a (B, n, S, D) scratch.
inline Bhsd contiguous(int n, int S, int D) {
  return Bhsd{(long long)n * S * D, (long long)S * D, (long long)D};
}

// The operands every column-group entry point checks: D a multiple of 128
// (the wrapper pads to it), and with tables the q rows' positions inside the
// key sequence and a k scratch.
inline bool dstream_args_ok(int B, int H, int KV, int Sq, int Skv, int D, const void* cos,
                            const void* k_rot, int off) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV) return false;
  if (D < DS_GROUP || D % DS_GROUP) return false;
  return cos == nullptr || (off >= 0 && off + Sq <= Skv && k_rot != nullptr);
}

}  // namespace dtt
