// Cell-bounded bilinear sampling of one output element with K1's rounding
// points, shared by kernels K2 (csrc/sched.cu) and K4 (csrc/rowbound.cu).
//
// The TPU kernels these replace contract each window against one image
// cell of cell_r x cell_c pixels at (row0, col0) with dense triangle tap
// matrices relu(1 - |i - s|) over the cell's rows and columns only. Here
// each output element reads just its two-tap support, with the same
// function: for i = floor(s) and floor(s) + 1 (s cell-local),
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

// One output value of a cell-bounded resample. `plane` is one (h, w) bf16
// channel plane; (s, t) the cell-local row/column sample; the cell sits at
// (row0, col0) with extent (cell_r, cell_c).
__device__ __forceinline__ float cell_sample(const __nv_bfloat16* __restrict__ plane,
                                             int h, int w, float s, float t,
                                             int row0, int col0, int cell_r,
                                             int cell_c) {
  const float y0f = floorf(s);
  const float x0f = floorf(t);
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const float wy0 = cell_tap(y0f, y0, s, cell_r);
  const float wy1 = cell_tap(y0f + 1.0f, y0 + 1, s, cell_r);
  const float wx[2] = {cell_tap(x0f, x0, t, cell_c), cell_tap(x0f + 1.0f, x0 + 1, t, cell_c)};
  const int ra = row0 + y0;
  const int rb = ra + 1;
  float v[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = col0 + x0 + j;
    float pa = 0.0f;
    float pb = 0.0f;
    if (wx[j] != 0.0f && col < w) {
      if (wy0 != 0.0f && ra < h) {
        pa = __bfloat162float(plane[(long long)ra * w + col]);
      }
      if (wy1 != 0.0f && rb < h) {
        pb = __bfloat162float(plane[(long long)rb * w + col]);
      }
    }
    v[j] = bf16_round(__fadd_rn(__fmul_rn(wy0, pa), __fmul_rn(wy1, pb)));
  }
  const float o = __fadd_rn(__fmul_rn(wx[0], v[0]), __fmul_rn(wx[1], v[1]));
  return fminf(fmaxf(rintf(o), 0.0f), 255.0f);
}

}  // namespace rodc
