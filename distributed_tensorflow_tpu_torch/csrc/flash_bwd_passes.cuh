// The passes around a fused flash-attention backward kernel (flash_bwd.cu,
// flash_bwd_sm90.cu): the delta pre-pass, which also zeroes the f32 dq
// scratch the main kernel adds into, and the dq pass, which rotates the
// summed dq back (rope) and casts it into the caller's layout.
#pragma once

#include "flash_common.cuh"

namespace dtt {

struct BwdStrides {
  Bhsd q, k, v, g, dk, dv;
};

// delta[r] = sum_d dO[b, h, s, d] · O[b, h, s, d] for row r = (b·H + h)·Sq + s;
// one warp per row.
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                       float* __restrict__ delta, Bhsd so, Bhsd sg, int H,
                                       int Sq, int D, long long rows) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const long long b = r / ((long long)H * Sq), h = (r / Sq) % H, s = r % Sq;
  const T* o = out + b * so.b + h * so.h + s * so.s;
  const T* d = dout + b * sg.b + h * sg.h + s * sg.s;
  float acc = 0.f;
  for (int i = lane; i < D; i += 32) acc = fmaf(to_f32<T>(d[i]), to_f32<T>(o[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// dq (B, H, Sq, D) f32 scratch -> rotated back (rope), cast, into the
// caller's dq; a thread owns columns i and i + D/2 of a row.
template <typename T, bool ROPE>
__global__ void flash_bwd_dq_kernel(const float* __restrict__ dq_acc,
                                    const float* __restrict__ cos, const float* __restrict__ sin,
                                    T* __restrict__ dq, Bhsd sd, int H, int Sq, int D, int off,
                                    long long tstride, long long pairs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const int half = D / 2;
  const long long row = idx / half;  // (b·H + h)·Sq + s
  const int i = (int)(idx % half);
  const long long b = row / ((long long)H * Sq), h = (row / Sq) % H, s = row % Sq;
  float x1 = dq_acc[row * D + i], x2 = dq_acc[row * D + i + half];
  if constexpr (ROPE) {
    const long long at = b * tstride + (s + off) * half + i;  // the row's position: s + off
    const float c = cos[at], sn = sin[at];
    const float y1 = x1 * c + x2 * sn, y2 = x2 * c - x1 * sn;
    x1 = y1;
    x2 = y2;
  }
  T* dst = dq + b * sd.b + h * sd.h + s * sd.s;
  dst[i] = from_f32<T>(x1);
  dst[i + half] = from_f32<T>(x2);
}

// One backward: zero dq_acc (when dq is wanted), the delta pre-pass,
// `launch_main` (a callable launching the kernel on `stream` and returning
// its cudaError_t), then the dq pass. `s` holds the (b, h, s) strides of q, k,
// v, out, dout, dq, dk, dv in that order; with dq null the dq pass is
// skipped and delta is left for the caller.
template <typename T, bool ROPE, typename Launch>
int run_bwd(Launch launch_main, const void* out, const void* dout, const void* cos,
            const void* sin, void* dq, void* dq_acc, void* delta, const long long* s, int B, int H,
            int Sq, int D, int off, long long tstride, cudaStream_t stream) {
  auto at = [&](int i) { return Bhsd{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; };
  const long long rows = (long long)B * H * Sq;
  cudaError_t err;
  if (dq != nullptr && (err = cudaMemsetAsync(dq_acc, 0, rows * D * sizeof(float), stream)) !=
                           cudaSuccess)
    return (int)err;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<float*>(delta),
      at(3), at(4), H, Sq, D, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_main()) != cudaSuccess || dq == nullptr) return (int)err;
  const long long pairs = rows * (D / 2);
  flash_bwd_dq_kernel<T, ROPE><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<T*>(dq), at(5), H, Sq, D, off, tstride, pairs);
  return (int)cudaGetLastError();
}

}  // namespace dtt
