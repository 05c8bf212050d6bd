// Kernel K1: batched crop + bilinear resize of survivor boxes (window
// re-extraction between cascade stages), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// rapidobjectdetectionusingcascadedcnns_tpu/ops/windows_pallas.py::_resample_kernel.
// The TPU kernel builds dense two-tap interpolation matrices and runs two
// MXU matmuls, because gathers are slow there. On Hopper a gather is cheap,
// so each output value reads only its 2x2 support.
//
// Per output value (b, n, oy, ox, c), with s = sy[b, n, oy], t = sx[b, n, ox]
// (computed by the Python wrapper with the same expressions as the plain
// version):
//   y0 = floor(s), x0 = floor(t)
//   taps  w(i) = bf16_rn(max(0, 1 - |i - s|)) for i = y0, y0 + 1 (same in x);
//         a tap on row H or column W is exactly 0, so that row/column is
//         never read (row y0 is read in its place, times 0)
//   vertical   v(x) = bf16_rn(w(y0) * p[y0, x] + w(y0+1) * p[y0+1, x])
//   horizontal o = w(x0) * v(x0) + w(x0+1) * v(x0+1)
//   out = min(max(rint(o), 0), 255)   (rint: half to even, like jnp.round)
// Products of two bf16 values are exact in f32, so each sum rounds once and
// FMA contraction cannot change the result; the adds are still written
// with explicit round-to-nearest intrinsics.
//
// What bounds it on an H100: the f32 stores. The output is 4 bytes per
// value against 2 x 2 bf16 reads that mostly hit the 50 MB L2 (a VGA bf16
// frame is 1.8 MB): 70.8 MB at 16 VGA frames x 640 boxes at 24 px, 113 MB
// at 256 boxes at 48 px. So the kernel is bound by device-memory bytes.
//
// Design: one block per (frame, box), or a few consecutive boxes per block
// at small output sizes (boxes_per_block, from the wrapper), staged through
// dynamic shared memory:
//   1. taps: each row's (y0, y1, w(y0), w(y0+1)) and each column's, once
//      per row and column of the block's boxes (not once per value);
//   2. vertical pass: threads walk (box, oy, k) with k fastest over the
//      2 * out_w source columns the horizontal pass needs (x0 and x1 of
//      every ox), so neighbouring threads read neighbouring columns of one
//      (C, H, W) plane, every channel of an item at once; the bf16 sums go
//      to a shared intermediate (out_h x 2 out_w x C per box);
//   3. horizontal pass: writes each (oy, ox)'s channels into a shared
//      output tile in (oy, ox, c) order;
//   4. store: the block's boxes are contiguous in the output, so one thread
//      writes the whole tile with one bulk copy from shared to global memory
//      (cp.async.bulk, the TMA's non-tensor form) when its size is a
//      multiple of 16 bytes (every 3-channel window whose side is even:
//      12, 24 and 48 px), else the threads store it value by value. The
//      bulk copy keeps the threads free of store addressing and writes
//      whole lines.
// Index arithmetic is 32-bit inside a block and advances without division;
// only the frame and box offsets are 64-bit, so one launch may write more
// than 2^31 values (8,007 boxes of 299 px). Frames of 1 to 4 channels.
//
// Banded launch (windows too large to stage whole: a 3-channel box above
// 97 px needs more than a block's 227 KB, 2,157,584 bytes at 299 px): a
// block takes one box and a band of consecutive output rows [r0, r0 +
// band), grid (boxes, ceil(out_h / band)). It stages the band's row taps,
// all the box's column taps, the band's bf16 intermediate (band x 2 out_w
// x C) and the band's f32 output tile, and runs the same two passes, so
// every value is computed exactly as above. The band's output is
// contiguous but not 16-byte aligned in general (a 299 px box is
// 1,072,812 bytes, a row 3,588), so the threads store it value by value,
// consecutive threads to consecutive addresses. The wrapper chooses the
// band (windows_cuda.launch_geometry).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float tap(float i, float s) {
  return bf16_round(fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(i, s))));
}

// One axis' taps: lo/hi indices and their weights at positions s[0..count).
__device__ __forceinline__ void axis_taps(const float* __restrict__ s, int count,
                                          int size, int* lo, int* hi, float* w0,
                                          float* w1) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const float v = s[t];
    const float f = floorf(v);
    const int i = (int)f;
    lo[t] = i;
    hi[t] = i + 1 < size ? i + 1 : i;  // tap is 0 when i + 1 == size
    w0[t] = tap(f, v);
    w1[t] = tap(f + 1.0f, v);
  }
}

// kC: the channel count (1 to 4; 3 for the cascade's frames). kBanded: the
// banded launch (one box a block, rows [blockIdx.y * band, + band)); else
// band == out_h and a block takes per_block whole boxes.
template <int kC, bool kBanded>
__global__ void __launch_bounds__(kThreads)
    resample_kernel(const __nv_bfloat16* __restrict__ planes,
                    const float* __restrict__ sy, const float* __restrict__ sx,
                    float* __restrict__ out, long long boxes, int n, int h,
                    int w, int out_h, int out_w, int per_block, int band) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int per_box = out_h * out_w * kC;
  const long long box0 = (long long)blockIdx.x * per_block;
  const int nb = kBanded ? 1 : (int)min((long long)per_block, boxes - box0);
  const int r0 = kBanded ? (int)blockIdx.y * band : 0;
  const int brows = kBanded ? min(band, out_h - r0) : out_h;  // rows of a box here
  const int rows = nb * brows;  // ry = j * brows + (oy - r0) over the block's boxes

  // shared layout (sized for per_block boxes of band rows): output tile;
  // per row its taps, its box in the block and that box's frame; per
  // column its taps; the bf16 intermediate
  float* tile = reinterpret_cast<float*>(smem);
  int* row_lo = reinterpret_cast<int*>(tile + per_block * band * out_w * kC);
  int* row_hi = row_lo + per_block * band;
  float* row_w0 = reinterpret_cast<float*>(row_hi + per_block * band);
  float* row_w1 = row_w0 + per_block * band;
  int* row_box = reinterpret_cast<int*>(row_w1 + per_block * band);
  int* row_frame = row_box + per_block * band;
  int* col_lo = row_frame + per_block * band;
  int* col_hi = col_lo + per_block * out_w;
  float* col_w0 = reinterpret_cast<float*>(col_hi + per_block * out_w);
  float* col_w1 = col_w0 + per_block * out_w;
  __nv_bfloat16* inter = reinterpret_cast<__nv_bfloat16*>(col_w1 + per_block * out_w);

  // a whole-box block's rows are its boxes' rows back to back; a band's are
  // rows r0.. of one box: either way consecutive entries of sy
  axis_taps(sy + box0 * out_h + r0, rows, h, row_lo, row_hi, row_w0, row_w1);
  axis_taps(sx + box0 * out_w, nb * out_w, w, col_lo, col_hi, col_w0, col_w1);
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int j = kBanded ? 0 : t / out_h;
    row_box[t] = j;
    row_frame[t] = (int)((box0 + j) / n);
  }
  __syncthreads();

  // vertical pass: thread items (ry, k), k fastest over the 2 * out_w
  // source columns (x0 and x1 of every ox), all channels per item; the
  // item index advances by blockDim.x without a division
  const int two_w = 2 * out_w;
  const long long plane = (long long)h * w;
  {
    const int step_r = blockDim.x / two_w;
    const int step_k = blockDim.x % two_w;
    int k = threadIdx.x % two_w;
    int ry = threadIdx.x / two_w;
    while (ry < rows) {
      const int cx = row_box[ry] * out_w + (k >> 1);
      const int col = (k & 1) ? col_hi[cx] : col_lo[cx];
      const __nv_bfloat16* p = planes + (long long)row_frame[ry] * kC * plane + col;
      const long long o0 = (long long)row_lo[ry] * w;
      const long long o1 = (long long)row_hi[ry] * w;
      const float w0 = row_w0[ry];
      const float w1 = row_w1[ry];
      __nv_bfloat16* dst = inter + (ry * two_w + k) * kC;
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) {
        const float p0 = __bfloat162float(p[ci * plane + o0]);
        const float p1 = __bfloat162float(p[ci * plane + o1]);
        dst[ci] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(w0, p0), __fmul_rn(w1, p1)));
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

  // horizontal pass: thread items (ry, ox), all channels per item, written
  // in (oy, ox, c) order into the output tile
  {
    const int step_r = blockDim.x / out_w;
    const int step_x = blockDim.x % out_w;
    int ox = threadIdx.x % out_w;
    int ry = threadIdx.x / out_w;
    while (ry < rows) {
      const int cx = row_box[ry] * out_w + ox;
      const float w0 = col_w0[cx];
      const float w1 = col_w1[cx];
      const __nv_bfloat16* v = inter + (ry * two_w + 2 * ox) * kC;
      float* o = tile + (ry * out_w + ox) * kC;
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) {
        const float r = __fadd_rn(__fmul_rn(w0, __bfloat162float(v[ci])),
                                  __fmul_rn(w1, __bfloat162float(v[kC + ci])));
        o[ci] = fminf(fmaxf(rintf(r), 0.0f), 255.0f);
      }
      ox += step_x;
      ry += step_r;
      if (ox >= out_w) {
        ox -= out_w;
        ++ry;
      }
    }
  }

  const int n_out = rows * out_w * kC;
  float* dst = out + box0 * per_box + (long long)r0 * out_w * kC;
  if (!kBanded && (per_box & 3) == 0) {
    // make the tile's generic-proxy writes visible to the bulk copy, then
    // one thread copies the block's contiguous output
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned int src = static_cast<unsigned int>(__cvta_generic_to_shared(tile));
      const unsigned int bytes = static_cast<unsigned int>(n_out) * 4u;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   :: "l"(dst), "r"(src), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the tile must stay readable until the copy has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
      dst[e] = tile[e];
    }
  }
}

}  // namespace

// planes (B, C, H, W) bf16 contiguous; sy (B, N, out_h) and sx (B, N, out_w)
// f32 contiguous; out (B, N, out_h, out_w, C) f32, allocated by the caller
// (its base 16-byte aligned, as every CUDA allocation is). boxes_per_block,
// band and smem_bytes are the wrapper's launch geometry
// (windows_cuda.launch_geometry): band == out_h for whole boxes, else
// boxes_per_block == 1 and the launch is banded; smem_bytes must equal
// boxes_per_block * (8 * band * out_w * C + 24 * band + 16 * out_w), else
// the call launches nothing and returns cudaErrorInvalidValue. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int rodc_resample(const void* planes, const void* sy,
                             const void* sx, void* out, int b, int n, int c,
                             int h, int w, int out_h, int out_w,
                             int boxes_per_block, int band, int smem_bytes,
                             void* stream) {
  const long long boxes = (long long)b * n;
  if (boxes == 0 || (long long)out_h * out_w * c == 0) {
    return 0;
  }
  const bool banded = band < out_h;
  const long long need = (long long)boxes_per_block *
                         (8LL * band * out_w * c + 24LL * band + 16LL * out_w);
  if (boxes_per_block < 1 || band < 1 || band > out_h || need != smem_bytes ||
      (banded && boxes_per_block != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (boxes + boxes_per_block - 1) / boxes_per_block;
  const int bands = (out_h + band - 1) / band;
  if (blocks > 0x7fffffffLL || bands > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  using Kernel = void (*)(const __nv_bfloat16*, const float*, const float*, float*,
                          long long, int, int, int, int, int, int, int);
  const Kernel whole[4] = {resample_kernel<1, false>, resample_kernel<2, false>,
                           resample_kernel<3, false>, resample_kernel<4, false>};
  const Kernel band_kernels[4] = {resample_kernel<1, true>, resample_kernel<2, true>,
                                  resample_kernel<3, true>, resample_kernel<4, true>};
  if (c < 1 || c > 4) {
    return (int)cudaErrorInvalidValue;
  }
  const Kernel kernel = banded ? band_kernels[c - 1] : whole[c - 1];
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      return (int)err;
    }
  }
  if (banded) {
    // the band is sized for several blocks an SM: ask for the largest
    // shared-memory carveout, so the SM can hold them
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) {
      return (int)err;
    }
  }
  const dim3 grid((unsigned int)blocks, (unsigned int)bands);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const float*)sy, (const float*)sx,
      (float*)out, boxes, n, h, w, out_h, out_w, boxes_per_block, band);
  return (int)cudaGetLastError();
}
