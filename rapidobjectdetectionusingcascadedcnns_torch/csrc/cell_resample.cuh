// Cell-bounded bilinear sampling with K1's rounding points: the tap rule,
// the two sums and the store shared by kernels K2 (csrc/sched.cu) and K4
// (csrc/rowbound.cu), and the rounding helper of K2p
// (csrc/sched_precomp.cu).
//
// The TPU kernels these replace contract each window against one image
// cell with dense triangle tap matrices relu(1 - |i - s|) over the cell's
// rows and columns only. Here each output value reads just its two-tap
// support, with the same function: for i = floor(s) and floor(s) + 1
// (s cell-local),
//   weight  bf16_rn(max(0, 1 - |i - s|)) if 0 <= i < cell extent, else 0
//   pixel   plane[row0 + i, col0 + j], or 0 past the image (the TPU kernels
//           pad the image with zeros)
//   vertical   v(x) = bf16_rn(wy0 * p[y0, x] + wy1 * p[y0 + 1, x])
//   horizontal o = wx0 * v(x0) + wx1 * v(x0 + 1)
//   out = min(max(rint(o), 0), 255)   (rint: half to even)
// Products of two bf16 values are exact in f32, so each sum rounds once;
// the adds are still written with explicit round-to-nearest intrinsics.

#pragma once

#include <cuda_bf16.h>

namespace rodc {

__host__ __device__ constexpr long long align16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Tap weight of integer position i (as float fi) for cell-local sample s,
// zero outside the cell [0, extent).
__device__ __forceinline__ float cell_tap(float fi, int i, float s, int extent) {
  if (i < 0 || i >= extent) {
    return 0.0f;
  }
  return bf16_round(fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(fi, s))));
}

// The two taps of a cell-local position: indices i0 = floor(s) and
// i1 = i0 + 1 with their weights. An index is -1 where its pixel reads 0:
// its weight is 0 (outside the cell [0, extent)) or it lies at or past
// `limit` (the image's end, cell-local). A product w * 0 is +0 whatever w,
// so a dead tap's pixel need not be read.
struct Taps {
  int i0;
  int i1;
  float w0;
  float w1;
};

__device__ __forceinline__ Taps cell_taps(float s, int extent, int limit) {
  const float f = floorf(s);
  const int i = (int)f;
  Taps t;
  t.w0 = cell_tap(f, i, s, extent);
  t.w1 = cell_tap(f + 1.0f, i + 1, s, extent);
  t.i0 = (t.w0 != 0.0f && i < limit) ? i : -1;
  t.i1 = (t.w1 != 0.0f && i + 1 < limit) ? i + 1 : -1;
  return t;
}

// The vertical sum in f32, before its rounding to bf16.
__device__ __forceinline__ float vertical_sum(float w0, float p0, float w1, float p1) {
  return __fadd_rn(__fmul_rn(w0, p0), __fmul_rn(w1, p1));
}

// The horizontal sum of two bf16 vertical values, rounded half to even and
// clipped to the u8 range.
__device__ __forceinline__ float quantize(float w0, float v0, float w1, float v1) {
  return fminf(fmaxf(rintf(__fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1))), 0.0f), 255.0f);
}

// Every thread of the block calls this after writing its part of `tile`:
// the tile's generic-proxy writes are made visible to the async proxy, then
// thread 0 copies `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from shared to global memory with one bulk copy
// (cp.async.bulk, the TMA's non-tensor form) and commits it. With `wait`,
// it waits until the copy has read the tile, so the block may exit or
// overwrite it; without, the caller waits (bulk_store_wait) before either.
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store_tile(void* dst, const void* tile,
                                                unsigned int bytes, bool wait = true) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int src = static_cast<unsigned int>(__cvta_generic_to_shared(tile));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(dst), "r"(src), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (wait) {
      bulk_store_wait();
    }
  }
}

}  // namespace rodc
