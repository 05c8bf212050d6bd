// Kernel K4: re-extraction of dynamic survivor boxes with the contraction
// rows bounded to a 128-row lattice cell, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// rapidobjectdetectionusingcascadedcnns_tpu/ops/windows_dyn.py::_dyn_kernel
// (its pallas_call in extract_rowbound). The TPU kernel reads the image
// through a lattice of 4 copies shifted by 32 rows, so that cell m (original
// rows [32 m, 32 m + 128)) is an aligned block; that is a block-addressing
// device of the TPU. Here one CTA per (tile, frame) reads the original bf16
// planes at rows cell_start + r, r in [0, 128), with rows past the image
// read as zero, and the full padded width. A tap whose row leaves the
// tile's cell contributes exactly zero (csrc/cell_resample.cuh), so every
// slot, including those the merge then replaces with the big class, equals
// the TPU kernel's output. The sort, the big class, the overflow count and
// the merge stay in PyTorch (ops/windows_dyn.py), as they sit outside the
// pallas_call in JAX.
//
// What bounds it: the output stores (16,512 boxes x 24x24x3 bf16 = 57 MB
// per frame at FDDB density's stage-1 capacity); the 1.2 MB bf16 frame
// sits in L2. Stores are contiguous per tile and coalesce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cell_resample.cuh"

namespace {

__global__ void rowbound_kernel(const __nv_bfloat16* __restrict__ planes,
                                const float* __restrict__ sy_local,
                                const float* __restrict__ sx,
                                const int* __restrict__ cell_start,
                                __nv_bfloat16* __restrict__ out, int n_pad,
                                int c, int h, int w, int out_h, int out_w,
                                int tile, int cell_rows, int w_pad) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = gridDim.x;
  const int row0 = cell_start[(long long)b * n_tiles + t];
  const int per_window = out_h * out_w * c;
  const int per_tile = tile * per_window;
  const long long slot0 = (long long)b * n_pad + (long long)t * tile;
  __nv_bfloat16* dst = out + slot0 * per_window;
  const __nv_bfloat16* frame = planes + (long long)b * c * h * w;
  for (int e = threadIdx.x; e < per_tile; e += blockDim.x) {
    const int ci = e % c;
    const int ox = (e / c) % out_w;
    const int oy = (e / (c * out_w)) % out_h;
    const long long slot = slot0 + e / per_window;
    const float s = sy_local[slot * out_h + oy];
    const float x = sx[slot * out_w + ox];
    const float o = rodc::cell_sample(frame + (long long)ci * h * w, h, w, s, x,
                                      row0, 0, cell_rows, w_pad);
    dst[e] = __float2bfloat16_rn(o);
  }
}

}  // namespace

// planes (B, C, H, W) bf16; sy_local (B, n_pad, out_h) f32 rows relative to
// each window's tile cell; sx (B, n_pad, out_w) f32 image columns;
// cell_start (B, n_tiles) int32 first image row of each tile's cell; out
// (B, n_pad, out_h, out_w, C) bf16, allocated by the caller; n_pad =
// n_tiles * tile. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() of the launch (0 on success).
extern "C" int rodc_rowbound(const void* planes, const void* sy_local,
                             const void* sx, const void* cell_start, void* out,
                             int b, int n_pad, int c, int h, int w, int out_h,
                             int out_w, int tile, int cell_rows, int w_pad,
                             void* stream) {
  if (b == 0 || n_pad == 0) {
    return 0;
  }
  const dim3 grid((unsigned int)(n_pad / tile), (unsigned int)b);
  rowbound_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const float*)sy_local, (const float*)sx,
      (const int*)cell_start, (__nv_bfloat16*)out, n_pad, c, h, w, out_h,
      out_w, tile, cell_rows, w_pad);
  return (int)cudaGetLastError();
}
