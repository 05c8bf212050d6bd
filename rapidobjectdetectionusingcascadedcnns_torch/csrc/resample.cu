// Kernel K1: batched crop + bilinear resize of survivor boxes (window
// re-extraction between cascade stages), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// rapidobjectdetectionusingcascadedcnns_tpu/ops/windows_pallas.py::_resample_kernel.
// The TPU kernel builds dense two-tap interpolation matrices and runs two
// MXU matmuls, because gathers are slow there. On Hopper a gather is cheap,
// so each output element reads only its 2x2 support.
//
// Per output element (b, n, oy, ox, c), with s = sy[b, n, oy], t = sx[b, n, ox]
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
// What bounds it: 4 bf16 pixel reads per output element (a VGA bf16 frame
// is 1.8 MB and sits in the 50 MB L2) and one f32 store; the stage-2 output
// at 16 frames x 256 boxes x 48x48x3 is 113 MB. So it is memory and latency
// bound. Consecutive threads write consecutive output floats (channel
// fastest), so stores coalesce; the grid-stride loop keeps blocks at 256
// threads whatever the window size. Making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float tap(float i, float s) {
  return bf16_round(fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(i, s))));
}

__global__ void resample_kernel(const __nv_bfloat16* __restrict__ planes,
                                const float* __restrict__ sy,
                                const float* __restrict__ sx,
                                float* __restrict__ out, long long total,
                                int n, int c, int h, int w, int out_h,
                                int out_w) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    long long r = idx;
    const int ci = (int)(r % c);
    r /= c;
    const int ox = (int)(r % out_w);
    r /= out_w;
    const int oy = (int)(r % out_h);
    const long long bn = r / out_h;  // b * n + box
    const long long b = bn / n;

    const float s = sy[bn * out_h + oy];
    const float t = sx[bn * out_w + ox];
    const float y0f = floorf(s);
    const float x0f = floorf(t);
    const int y0 = (int)y0f;
    const int x0 = (int)x0f;
    const float wy0 = tap(y0f, s);
    const float wy1 = tap(y0f + 1.0f, s);
    const float wx0 = tap(x0f, t);
    const float wx1 = tap(x0f + 1.0f, t);
    const int y1 = y0 + 1 < h ? y0 + 1 : y0;  // tap is 0 when y0 + 1 == h
    const int x1 = x0 + 1 < w ? x0 + 1 : x0;

    const __nv_bfloat16* p = planes + (b * c + ci) * (long long)h * w;
    const float p00 = __bfloat162float(p[(long long)y0 * w + x0]);
    const float p10 = __bfloat162float(p[(long long)y1 * w + x0]);
    const float p01 = __bfloat162float(p[(long long)y0 * w + x1]);
    const float p11 = __bfloat162float(p[(long long)y1 * w + x1]);

    const float v0 = bf16_round(__fadd_rn(__fmul_rn(wy0, p00), __fmul_rn(wy1, p10)));
    const float v1 = bf16_round(__fadd_rn(__fmul_rn(wy0, p01), __fmul_rn(wy1, p11)));
    const float o = __fadd_rn(__fmul_rn(wx0, v0), __fmul_rn(wx1, v1));
    out[idx] = fminf(fmaxf(rintf(o), 0.0f), 255.0f);
  }
}

}  // namespace

// planes (B, C, H, W) bf16 contiguous; sy (B, N, out_h) and sx (B, N, out_w)
// f32 contiguous; out (B, N, out_h, out_w, C) f32, allocated by the caller.
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int rodc_resample(const void* planes, const void* sy,
                             const void* sx, void* out, int b, int n, int c,
                             int h, int w, int out_h, int out_w, void* stream) {
  const long long total = (long long)b * n * out_h * out_w * c;
  if (total == 0) {
    return 0;
  }
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long max_blocks = 132LL * 64;  // 64 blocks per SM; the loop does the rest
  if (blocks > max_blocks) {
    blocks = max_blocks;
  }
  resample_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const float*)sy, (const float*)sx,
      (float*)out, total, n, c, h, w, out_h, out_w);
  return (int)cudaGetLastError();
}
