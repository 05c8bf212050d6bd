// Kernel K4: re-extraction of dynamic survivor boxes with the contraction
// rows bounded to a 128-row lattice cell, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// rapidobjectdetectionusingcascadedcnns_tpu/ops/windows_dyn.py::_dyn_kernel
// (its pallas_call in extract_rowbound). The TPU kernel reads the image
// through a lattice of 4 copies shifted by 32 rows, so that cell m (original
// rows [32 m, 32 m + 128)) is an aligned block; that is a block-addressing
// device of the TPU. Here the kernel reads the original bf16 planes at rows
// cell_start + r, r in [0, 128), and the full padded width. The sort, the
// big class, the overflow count and the merge stay in PyTorch
// (ops/windows_dyn.py), as they sit outside the pallas_call in JAX.
//
// Per output value (slot, oy, ox, c), with s = sy_local[slot, oy] (rows
// relative to the slot's tile cell) and t = sx[slot, ox] (image columns),
// the rule of the plain version (windows_sched.resample_cells_plain):
//   taps   w(i) = bf16_rn(max(0, 1 - |i - s|)) for i = floor(s), floor(s) + 1,
//          and 0 for a row outside [0, cell_rows) or a column outside
//          [0, w_pad); a pixel past the image reads 0
//   vertical   v(x) = bf16_rn(wy0 * p[y0, x] + wy1 * p[y0 + 1, x])
//   horizontal o = wx0 * v(x0) + wx1 * v(x0 + 1)
//   out = bf16(min(max(rint(o), 0), 255))   (rint: half to even)
// Products of two bf16 values are exact in f32, so each sum rounds once;
// the adds are still written with explicit round-to-nearest intrinsics.
//
// What bounds it on an H100: the bytes (bf16 stores, 2 bytes a value:
// 16,512 boxes x 24x24x3 = 57 MB a frame at FDDB density's stage-1
// capacity) set a bound of about 0.073 ms for 4 frames; the 2x2 gathers
// from the 1.2 MB bf16 frame hit the L2. A first port computed every value
// alone (four runtime divisions, its taps and a 2x2 gather per value, 2
// bytes stored per thread) and wrote about 100 G values/s. This design
// writes about 260 G values/s (0.44 ms, 16% of the bound), as K1 does at
// the same boxes with twice the bytes: a cost per value, the gathers from
// (C, H, W) planes through the L2, sets the pace, not the stores.
//
// Design (the one of K1, csrc/resample.cu): a 256-thread block takes a few
// consecutive slots (slots_per_block: 5, 2 and 1 at 12, 24 and 48 px, from
// windows_dyn_cuda.launch_geometry); slots are contiguous in the output, so
// a block may span two tiles or two frames, and each slot reads its own
// frame and its own tile's cell_start. In dynamic shared memory:
//   1. taps: each row's (y0, y1, wy0, wy1) and each column's (x0, x1, wx0,
//      wx1), once per slot row and slot column; a dead tap (outside the
//      cell, or past the image) gets index -1 and reads 0;
//   2. vertical pass: items (slot row, k), k fastest over the 2 * out_w
//      source columns the horizontal pass needs, so neighbouring threads
//      read neighbouring columns of one (C, H, W) plane; one item gathers
//      every channel and writes them to a bf16 intermediate;
//   3. horizontal pass: each (oy, ox) writes its channels into a bf16
//      (slot, oy, ox, c) output tile;
//   4. store: one cp.async.bulk copy (after fence.proxy.async) moves the
//      block's tile when a slot's output is a multiple of 16 bytes (every
//      window of 1 or 3 channels at 12, 24 and 48 px); other shapes are
//      stored by the threads.
// Indices inside a block are 32-bit and advance by compares, not
// divisions; only the frame and slot offsets are 64-bit. Frames of 1 to 4
// channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cell_resample.cuh"

namespace {

constexpr int kThreads = 256;

// kC: the channel count (1 to 4; 3 for the cascade's frames).
template <int kC>
__global__ void __launch_bounds__(kThreads)
    rowbound_kernel(const __nv_bfloat16* __restrict__ planes,
                    const float* __restrict__ sy_local,
                    const float* __restrict__ sx,
                    const int* __restrict__ cell_start,
                    __nv_bfloat16* __restrict__ out, long long slots, int n_pad,
                    int h, int w, int out_h, int out_w, int tile, int cell_rows,
                    int w_pad, int per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int per_slot = out_h * out_w * kC;
  const long long slot0 = (long long)blockIdx.x * per_block;
  const int nb = (int)min((long long)per_block, slots - slot0);
  const int rows = nb * out_h;  // ry = j * out_h + oy over the block's slots
  const int two_w = 2 * out_w;

  // shared layout (sized for per_block slots, see rowbound_smem): output
  // tile (16-byte aligned); bf16 intermediate; per row its two source rows,
  // weights, slot and frame; per slot its cell's first row; per source
  // column its index; per output column its weights
  __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* inter = reinterpret_cast<__nv_bfloat16*>(
      smem + rodc::align16(2 * per_block * per_slot));
  int* row_y0 = reinterpret_cast<int*>(inter + per_block * out_h * two_w * kC);
  int* row_y1 = row_y0 + per_block * out_h;
  float* row_w0 = reinterpret_cast<float*>(row_y1 + per_block * out_h);
  float* row_w1 = row_w0 + per_block * out_h;
  int* row_slot = reinterpret_cast<int*>(row_w1 + per_block * out_h);
  int* row_frame = row_slot + per_block * out_h;
  int* slot_row0 = row_frame + per_block * out_h;
  int* col_src = slot_row0 + per_block;
  float* col_w0 = reinterpret_cast<float*>(col_src + per_block * two_w);
  float* col_w1 = col_w0 + per_block * out_w;

  // each slot's cell is its tile's [cell_start, cell_start + cell_rows)
  // rows; n_pad is a multiple of tile, so the flat slot index over tile is
  // the flat (frame, tile) index of cell_start
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    slot_row0[j] = cell_start[(slot0 + j) / tile];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int j = t / out_h;
    const int row0 = slot_row0[j];
    const rodc::Taps tp = rodc::cell_taps(sy_local[slot0 * out_h + t], cell_rows, h - row0);
    row_y0[t] = tp.i0 < 0 ? -1 : row0 + tp.i0;
    row_y1[t] = tp.i1 < 0 ? -1 : row0 + tp.i1;
    row_w0[t] = tp.w0;
    row_w1[t] = tp.w1;
    row_slot[t] = j;
    row_frame[t] = (int)((slot0 + j) / n_pad);
  }
  // column taps: image columns, the cell [0, w_pad)
  for (int t = threadIdx.x; t < nb * out_w; t += blockDim.x) {
    const rodc::Taps tp = rodc::cell_taps(sx[slot0 * out_w + t], w_pad, w);
    col_src[2 * t] = tp.i0;
    col_src[2 * t + 1] = tp.i1;
    col_w0[t] = tp.w0;
    col_w1[t] = tp.w1;
  }
  __syncthreads();

  // vertical pass: items (ry, k), k fastest over the 2 * out_w source
  // columns (x0 and x1 of every ox), all channels per item; a dead column
  // gives v = 0, a dead row reads 0
  const long long plane = (long long)h * w;
  {
    const int step_r = blockDim.x / two_w;
    const int step_k = blockDim.x % two_w;
    int k = threadIdx.x % two_w;
    int ry = threadIdx.x / two_w;
    while (ry < rows) {
      const int col = col_src[row_slot[ry] * two_w + k];
      __nv_bfloat16* dst = inter + (ry * two_w + k) * kC;
      if (col < 0) {
#pragma unroll
        for (int ci = 0; ci < kC; ++ci) {
          dst[ci] = __float2bfloat16_rn(0.0f);
        }
      } else {
        const __nv_bfloat16* p = planes + (long long)row_frame[ry] * kC * plane + col;
        const int y0 = row_y0[ry];
        const int y1 = row_y1[ry];
        const long long o0 = (long long)y0 * w;
        const long long o1 = (long long)y1 * w;
        const float w0 = row_w0[ry];
        const float w1 = row_w1[ry];
#pragma unroll
        for (int ci = 0; ci < kC; ++ci) {
          const float p0 = y0 < 0 ? 0.0f : __bfloat162float(p[ci * plane + o0]);
          const float p1 = y1 < 0 ? 0.0f : __bfloat162float(p[ci * plane + o1]);
          dst[ci] = __float2bfloat16_rn(rodc::vertical_sum(w0, p0, w1, p1));
        }
      }
      k += step_k;
      ry += step_r;
      if (k >= two_w) {
        k -= two_w;
        ++ry;
      }
    }
  }
  __syncthreads();

  // horizontal pass: items (ry, ox), all channels per item, written in
  // (oy, ox, c) order into the output tile
  {
    const int step_r = blockDim.x / out_w;
    const int step_x = blockDim.x % out_w;
    int ox = threadIdx.x % out_w;
    int ry = threadIdx.x / out_w;
    while (ry < rows) {
      const int cx = row_slot[ry] * out_w + ox;
      const float w0 = col_w0[cx];
      const float w1 = col_w1[cx];
      const __nv_bfloat16* v = inter + (ry * two_w + 2 * ox) * kC;
      __nv_bfloat16* o = otile + (ry * out_w + ox) * kC;
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) {
        o[ci] = __float2bfloat16_rn(rodc::quantize(
            w0, __bfloat162float(v[ci]), w1, __bfloat162float(v[kC + ci])));
      }
      ox += step_x;
      ry += step_r;
      if (ox >= out_w) {
        ox -= out_w;
        ++ry;
      }
    }
  }

  const int n_out = nb * per_slot;
  __nv_bfloat16* dst = out + slot0 * per_slot;
  if ((per_slot & 7) == 0) {
    rodc::bulk_store_tile(dst, otile, (unsigned int)n_out * 2u);
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
      dst[e] = otile[e];
    }
  }
}

}  // namespace

// Dynamic shared memory of a launch of slots_per_block slots:
// windows_dyn_cuda.launch_geometry computes the same.
static long long rowbound_smem(int per_block, int out_h, int out_w, int c) {
  const long long per_slot = (long long)out_h * out_w * c;
  return rodc::align16(2LL * per_block * per_slot) +
         (long long)per_block * (4 * per_slot + 24LL * out_h + 16LL * out_w + 4);
}

// planes (B, C, H, W) bf16; sy_local (B, n_pad, out_h) f32 rows relative to
// each window's tile cell; sx (B, n_pad, out_w) f32 image columns;
// cell_start (B, n_tiles) int32 first image row of each tile's cell; out
// (B, n_pad, out_h, out_w, C) bf16, allocated by the caller (its base
// 16-byte aligned); n_pad = n_tiles * tile. slots_per_block and smem_bytes
// are windows_dyn_cuda.launch_geometry's: smem_bytes must equal
// rowbound_smem(slots_per_block, ...), else the call launches nothing and
// returns cudaErrorInvalidValue. Launches on `stream`, allocates nothing,
// does not synchronise. Returns cudaGetLastError() of the launch (0 on
// success).
extern "C" int rodc_rowbound(const void* planes, const void* sy_local,
                             const void* sx, const void* cell_start, void* out,
                             int b, int n_pad, int c, int h, int w, int out_h,
                             int out_w, int tile, int cell_rows, int w_pad,
                             int slots_per_block, int smem_bytes, void* stream) {
  const long long slots = (long long)b * n_pad;
  if (slots == 0 || (long long)out_h * out_w * c == 0) {
    return 0;
  }
  if (c < 1 || c > 4 || slots_per_block < 1 || tile < 1 ||
      rowbound_smem(slots_per_block, out_h, out_w, c) != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (slots + slots_per_block - 1) / slots_per_block;
  if (blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  void (*const kernels[4])(const __nv_bfloat16*, const float*, const float*,
                           const int*, __nv_bfloat16*, long long, int, int, int,
                           int, int, int, int, int, int) = {
      rowbound_kernel<1>, rowbound_kernel<2>, rowbound_kernel<3>, rowbound_kernel<4>};
  const auto kernel = kernels[c - 1];
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      return (int)err;
    }
  }
  kernel<<<(unsigned int)blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const float*)sy_local, (const float*)sx,
      (const int*)cell_start, (__nv_bfloat16*)out, slots, n_pad, h, w, out_h,
      out_w, tile, cell_rows, w_pad, slots_per_block);
  return (int)cudaGetLastError();
}
