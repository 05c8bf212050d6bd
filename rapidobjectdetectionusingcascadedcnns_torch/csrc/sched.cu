// Kernel K2: stage-0 extraction of a static (scheduled) window set, every
// window resampled inside its tile's aligned image cell, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// rapidobjectdetectionusingcascadedcnns_tpu/ops/windows_sched.py::_sched_kernel
// (one pallas_call per cell class, in _run_class). The host schedule
// (ops/windows_sched.py::build_schedule) bins every window into the
// smallest aligned cell of a ladder (R in {64, 128, 256, 512, h_pad} rows,
// C in {256, 512, w_pad} columns) holding its two-tap support, and tiles
// same-cell windows together. Here one launch covers every class and every
// frame: one CTA per (tile, frame), reading the tile's (row0, col0, cell_r,
// cell_c) from a per-tile table; each thread computes whole output
// elements with csrc/cell_resample.cuh, so a window reads only its support
// and the cell bound matters only through the zero taps at its edge.
//
// What bounds it: the output. At FDDB density (450x450, scale factor 1.005)
// a frame has 132,480 slots x 12x12x3 bf16 values = 114.5 MB of stores,
// about 34 us at 3.35 TB/s, against a 1.2 MB bf16 frame that sits in L2.
// Stores are contiguous per tile (channel fastest) and coalesce; the four
// gathered pixels per element come from L2. Staging the cell in shared
// memory, TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cell_resample.cuh"

namespace {

__global__ void sched_kernel(const __nv_bfloat16* __restrict__ planes,
                             const float* __restrict__ sy_local,
                             const float* __restrict__ sx_local,
                             const int* __restrict__ tiles,
                             __nv_bfloat16* __restrict__ out, int n_slots,
                             int c, int h, int w, int out_h, int out_w,
                             int tile) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = tiles[4 * t + 0];
  const int col0 = tiles[4 * t + 1];
  const int cell_r = tiles[4 * t + 2];
  const int cell_c = tiles[4 * t + 3];
  const int per_window = out_h * out_w * c;
  const int per_tile = tile * per_window;
  const long long slot0 = (long long)t * tile;
  __nv_bfloat16* dst = out + ((long long)b * n_slots + slot0) * per_window;
  const __nv_bfloat16* frame = planes + (long long)b * c * h * w;
  for (int e = threadIdx.x; e < per_tile; e += blockDim.x) {
    const int ci = e % c;
    const int ox = (e / c) % out_w;
    const int oy = (e / (c * out_w)) % out_h;
    const long long slot = slot0 + e / per_window;
    const float s = sy_local[slot * out_h + oy];
    const float x = sx_local[slot * out_w + ox];
    const float o = rodc::cell_sample(frame + (long long)ci * h * w, h, w, s, x,
                                      row0, col0, cell_r, cell_c);
    dst[e] = __float2bfloat16_rn(o);
  }
}

}  // namespace

// planes (B, C, H, W) bf16; sy_local (n_slots, out_h) and sx_local
// (n_slots, out_w) f32 cell-local positions, shared by all frames; tiles
// (n_tiles, 4) int32 rows (row0, col0, cell_r, cell_c); out (B, n_slots,
// out_h, out_w, C) bf16, allocated by the caller; n_slots = n_tiles * tile.
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int rodc_sched(const void* planes, const void* sy_local,
                          const void* sx_local, const void* tiles, void* out,
                          int b, int n_slots, int c, int h, int w, int out_h,
                          int out_w, int tile, void* stream) {
  if (b == 0 || n_slots == 0) {
    return 0;
  }
  const dim3 grid((unsigned int)(n_slots / tile), (unsigned int)b);
  sched_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const float*)sy_local,
      (const float*)sx_local, (const int*)tiles, (__nv_bfloat16*)out, n_slots,
      c, h, w, out_h, out_w, tile);
  return (int)cudaGetLastError();
}
