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
// frame. The values are those of csrc/cell_resample.cuh: taps outside the
// tile's cell are 0, pixels past the image read 0.
//
// What bounds it on an H100: the bytes. At FDDB density (450x450, scale
// factor 1.005) a frame has 132,480 slots x 12x12x3 bf16 values = 114.5 MB
// of stores, a bound of about 0.142 ms for 4 frames at 3.35 TB/s. A first
// port computed every value alone (four runtime divisions, its taps and a
// 2x2 gather from the L2 per value) and wrote about 100 G values/s; its
// gathers read 4 pixels per value, 55,296 per tile. This design writes
// about 340 G values/s (0.67 ms, 21% of the bound): a block's phases --
// taps and compaction, staging, sampling, store -- follow one another, and
// the two blocks an SM holds (113.7 KB of shared memory each) overlap
// them only in part (PERF.md, section 6).
//
// Design: one 512-thread block per tile, the frames in a loop (the frames
// share the schedule, so the taps and the support are built once):
//   1. taps: the tile's slot-row taps (y0, y1, wy0, wy1) and slot-column
//      taps (x0, x1, wx0, wx1) in shared tables, with the cell bound of the
//      tile's (row0, col0, cell_r, cell_c) row; a dead tap (weight 0, or a
//      pixel past the image) gets index -1;
//   2. compaction: the live taps mark their cell-local rows and columns in
//      two bitmaps (kMapBits each); a warp per bitmap turns them into
//      __popc prefix counts and lists of the distinct source rows and
//      columns (a median of 47 and 104 at FDDB density), and the tables
//      are rewritten to offsets into the compacted support;
//   3. staging, per frame: the support, (distinct rows) x (distinct
//      columns) x C bf16 (a median of 30 KB), is copied from the (C, H, W)
//      planes into shared memory, neighbouring threads on increasing
//      columns of one row, every channel of a pixel per item: a median of
//      about 15,200 reads from the L2 a tile instead of 55,296;
//   4. sampling: a thread takes a slot column (slot, ox), loads its taps
//      once and walks its rows; each (slot, oy, ox) reads its 2x2 pixels'
//      channels from shared memory into a bf16 (slot, oy, ox, c) output
//      tile;
//   5. store: one cp.async.bulk copy per frame (27,648 B at 12 px), which
//      runs while the next frame is staged.
// A tile whose support exceeds the staging budget (launch_geometry in
// ops/windows_sched_cuda.py; 64 KB, 4 of the 4,140 FDDB-density tiles), or
// whose cell reaches more than kMapBits rows or columns into the image, is
// sampled by gathers from the planes in the same kernel, with the same
// tables and arithmetic. Phases 2-5 live in csrc/sched_tile.cuh, shared
// with kernel K2p (csrc/sched_precomp.cu), which reads its taps instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cell_resample.cuh"
#include "sched_tile.cuh"

namespace {

using namespace rodc::sched_tile;

// kC: the channel count (1 to 4; 3 for the cascade's frames).
template <int kC>
__global__ void __launch_bounds__(kThreads, 2)
    sched_kernel(const __nv_bfloat16* __restrict__ planes,
                 const float* __restrict__ sy_local, const float* __restrict__ sx_local,
                 const int* __restrict__ tiles, __nv_bfloat16* __restrict__ out, int frames,
                 int n_slots, int h, int w, int out_h, int out_w, int tile, int budget) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = blockIdx.x;
  const int n_rows = tile * out_h;  // row entries r = slot * out_h + oy
  const int n_cols = tile * out_w;  // column entries slot * out_w + ox
  const Tile s = carve(smem, tile * out_h * out_w * kC, budget, n_rows, n_cols);

  const int row0 = tiles[4 * t + 0];
  const int col0 = tiles[4 * t + 1];
  const int cell_r = tiles[4 * t + 2];
  const int cell_c = tiles[4 * t + 3];
  // a live tap lies inside the cell and before the image's end
  const int lim_r = h - row0;
  const int lim_c = w - col0;
  const bool is_mapped = mapped(cell_r, cell_c, lim_r, lim_c);
  clear_maps(s);
  __syncthreads();

  // 1. taps, marking the live ones
  const long long slot0 = (long long)t * tile;
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const rodc::Taps tp = rodc::cell_taps(sy_local[slot0 * out_h + r], cell_r, lim_r);
    s.rtab[r] = make_int4(tp.i0, tp.i1, __float_as_int(tp.w0), __float_as_int(tp.w1));
    if (is_mapped) {
      mark(s.rmap, tp.i0);
      mark(s.rmap, tp.i1);
    }
  }
  for (int x = threadIdx.x; x < n_cols; x += kThreads) {
    const rodc::Taps tp = rodc::cell_taps(sx_local[slot0 * out_w + x], cell_c, lim_c);
    s.ctab[x] = make_int4(tp.i0, tp.i1, __float_as_int(tp.w0), __float_as_int(tp.w1));
    if (is_mapped) {
      mark(s.cmap, tp.i0);
      mark(s.cmap, tp.i1);
    }
  }
  __syncthreads();

  // 2-5. compaction, staging, sampling and the stores
  finish_tile<kC>(s, planes, out, frames, n_slots, h, w, out_h, out_w, tile, budget, slot0, row0,
                  col0, is_mapped);
}

}  // namespace

// planes (B, C, H, W) bf16; sy_local (n_slots, out_h) and sx_local
// (n_slots, out_w) f32 cell-local positions, shared by all frames; tiles
// (n_tiles, 4) int32 rows (row0, col0, cell_r, cell_c); out (B, n_slots,
// out_h, out_w, C) bf16, allocated by the caller (its base 16-byte
// aligned); n_slots = n_tiles * tile. budget and smem_bytes are
// windows_sched_cuda.launch_geometry's: budget a multiple of 16 and
// smem_bytes equal to rodc::sched_tile::smem_bytes(..., budget), else the
// call launches nothing and returns cudaErrorInvalidValue. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int rodc_sched(const void* planes, const void* sy_local,
                          const void* sx_local, const void* tiles, void* out,
                          int b, int n_slots, int c, int h, int w, int out_h,
                          int out_w, int tile, int budget, int smem_bytes,
                          void* stream) {
  if (b == 0 || n_slots == 0 || (long long)out_h * out_w * c == 0) {
    return 0;
  }
  if (c < 1 || c > 4 || tile < 1 || n_slots % tile || budget < 0 || budget % 16 ||
      rodc::sched_tile::smem_bytes(tile, out_h, out_w, c, budget) != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  void (*const kernels[4])(const __nv_bfloat16*, const float*, const float*, const int*,
                           __nv_bfloat16*, int, int, int, int, int, int, int, int) = {
      sched_kernel<1>, sched_kernel<2>, sched_kernel<3>, sched_kernel<4>};
  const auto kernel = kernels[c - 1];
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      return (int)err;
    }
  }
  kernel<<<(unsigned int)(n_slots / tile), rodc::sched_tile::kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const float*)sy_local, (const float*)sx_local,
      (const int*)tiles, (__nv_bfloat16*)out, b, n_slots, h, w, out_h, out_w, tile, budget);
  return (int)cudaGetLastError();
}
