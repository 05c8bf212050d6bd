// Kernel K2p: stage-0 extraction of a scheduled window set with tap
// matrices precomputed once per plan and read from device memory, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// tools/profile_sched_precomp.py:62 (_sched_kernel_pre, one pallas_call per
// cell class in _run_class_pre): K2 (csrc/sched.cu) with the two-tap
// triangle weights read from HBM instead of built. Per tile, RY is a
// (tile * out_h, cell_r) bf16 block and RX a (cell_c, tile * out_w) bf16
// block; the TPU kernel contracts them densely with the tile's image cell
// on the MXU (bf16 operands, f32 accumulation, bf16 intermediate).
//
// What bounds it on an H100: the weight bytes. At FDDB density (450x450,
// scale factor 1.005) the matrices of all 4,140 tiles are 1.6 GB, read
// once per launch, against 114.5 MB of bf16 output per frame. The dense
// block does not fit in shared memory (a 512x512 bf16 cell is 512 KB, an
// RY block 393 KB), so it is never staged. One CTA per tile streams its
// RY rows and RX columns once, with 16-byte coalesced loads, and records
// each output row's and column's first nonzero tap in shared memory: a
// triangle row has at most two nonzero taps, adjacent. Then it loops over
// the frames and computes each output from its 2x2 support with the
// rounding points of csrc/cell_resample.cuh. This equals the dense
// contraction bit for bit: the skipped terms are exact zeros, products of
// two bf16 values are exact in f32, so each sum rounds once in any order.
// It still reads every weight byte, which is what the experiment measures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cell_resample.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 values per 16-byte load

__device__ __forceinline__ void scan_nonzero(const uint4 chunk, int e0, int row_len,
                                             int* lo) {
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&chunk);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (__bfloat162float(v[k]) != 0.0f) {
      const int e = e0 + k;
      atomicMin(&lo[e / row_len], e % row_len);
    }
  }
}

// grid: one CTA per tile of the class. Shared memory: the first nonzero tap
// index of each of the tile's R = tile * out_h rows and Q = tile * out_w
// columns, and the two weights at it and after it.
__global__ void sched_precomp_kernel(const __nv_bfloat16* __restrict__ planes,
                                     const __nv_bfloat16* __restrict__ ry,
                                     const __nv_bfloat16* __restrict__ rx,
                                     const int* __restrict__ tiles,
                                     __nv_bfloat16* __restrict__ out, int b_frames,
                                     int n_slots, int slot0, int tile0, int c, int h,
                                     int w, int out_h, int out_w, int tile, int cell_r,
                                     int cell_c, int rx_cols) {
  extern __shared__ int smem[];
  const int R = tile * out_h;
  const int Q = tile * out_w;
  int* row_lo = smem;
  int* col_lo = row_lo + R;
  float* wy = reinterpret_cast<float*>(col_lo + Q);  // (R, 2)
  float* wx = wy + 2 * R;                            // (Q, 2)
  const int t = blockIdx.x;

  for (int i = threadIdx.x; i < R + Q; i += blockDim.x) {
    row_lo[i] = INT_MAX;  // col_lo follows row_lo
  }
  __syncthreads();

  // RY block of the tile: R contiguous rows of cell_r values
  const __nv_bfloat16* ry_t = ry + (long long)t * R * cell_r;
  const uint4* ry_v = reinterpret_cast<const uint4*>(ry_t);
  const int n_ry = R * cell_r / kVec;
  for (int i = threadIdx.x; i < n_ry; i += blockDim.x) {
    scan_nonzero(ry_v[i], i * kVec, cell_r, row_lo);
  }
  // RX block of the tile: cell_c rows of Q values at column t * Q of a
  // (cell_c, rx_cols) matrix
  const int q_vec = Q / kVec;
  const int n_rx = cell_c * q_vec;
  for (int i = threadIdx.x; i < n_rx; i += blockDim.x) {
    const int ci = i / q_vec;
    const int q = (i % q_vec) * kVec;
    const uint4 chunk =
        *reinterpret_cast<const uint4*>(rx + (long long)ci * rx_cols + (long long)t * Q + q);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&chunk);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (__bfloat162float(v[k]) != 0.0f) {
        atomicMin(&col_lo[q + k], ci);
      }
    }
  }
  __syncthreads();

  // the two taps of each row and column: at the first nonzero and after it
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int lo = row_lo[r];
    const __nv_bfloat16* row = ry_t + (long long)r * cell_r;
    wy[2 * r] = lo < cell_r ? __bfloat162float(row[lo]) : 0.0f;
    wy[2 * r + 1] = lo + 1 < cell_r ? __bfloat162float(row[lo + 1]) : 0.0f;
    if (lo >= cell_r) row_lo[r] = 0;
  }
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const int lo = col_lo[q];
    const long long col = (long long)t * Q + q;
    wx[2 * q] = lo < cell_c ? __bfloat162float(rx[(long long)lo * rx_cols + col]) : 0.0f;
    wx[2 * q + 1] =
        lo + 1 < cell_c ? __bfloat162float(rx[(long long)(lo + 1) * rx_cols + col]) : 0.0f;
    if (lo >= cell_c) col_lo[q] = 0;
  }
  __syncthreads();

  const int row0 = tiles[4 * (tile0 + t) + 0];
  const int col0 = tiles[4 * (tile0 + t) + 1];
  const int per_window = out_h * out_w * c;
  const int per_tile = tile * per_window;
  for (int bi = 0; bi < b_frames; ++bi) {
    const __nv_bfloat16* frame = planes + (long long)bi * c * h * w;
    __nv_bfloat16* dst = out + ((long long)bi * n_slots + slot0 + (long long)t * tile) * per_window;
    for (int e = threadIdx.x; e < per_tile; e += blockDim.x) {
      const int ci = e % c;
      const int ox = (e / c) % out_w;
      const int oy = (e / (c * out_w)) % out_h;
      const int k = e / per_window;
      const int r = k * out_h + oy;
      const int q = k * out_w + ox;
      const int ya = row0 + row_lo[r];
      const int xa = col0 + col_lo[q];
      const float wy0 = wy[2 * r];
      const float wy1 = wy[2 * r + 1];
      const __nv_bfloat16* plane = frame + (long long)ci * h * w;
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = xa + j;
        float pa = 0.0f;
        float pb = 0.0f;
        if (wx[2 * q + j] != 0.0f && col < w) {
          if (wy0 != 0.0f && ya < h) {
            pa = __bfloat162float(plane[(long long)ya * w + col]);
          }
          if (wy1 != 0.0f && ya + 1 < h) {
            pb = __bfloat162float(plane[(long long)(ya + 1) * w + col]);
          }
        }
        v[j] = rodc::bf16_round(__fadd_rn(__fmul_rn(wy0, pa), __fmul_rn(wy1, pb)));
      }
      const float o = __fadd_rn(__fmul_rn(wx[2 * q], v[0]), __fmul_rn(wx[2 * q + 1], v[1]));
      dst[e] = __float2bfloat16_rn(fminf(fmaxf(rintf(o), 0.0f), 255.0f));
    }
  }
}

}  // namespace

// One cell class: planes (B, C, H, W) bf16; ry (n_tiles_cls * tile * out_h,
// cell_r) and rx (cell_c, rx_cols = n_tiles_cls * tile * out_w) bf16; tiles
// (n_tiles, 4) int32 rows (row0, col0, cell_r, cell_c) of the whole
// schedule, the class's tiles at [tile0, tile0 + n_tiles_cls); out (B,
// n_slots, out_h, out_w, C) bf16, the class's slots from slot0. Requires
// tile * out_h * cell_r and tile * out_w to be multiples of 8 and 16-byte
// aligned ry/rx. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() of the launch (0 on success).
extern "C" int rodc_sched_precomp(const void* planes, const void* ry, const void* rx,
                                  const void* tiles, void* out, int b, int n_slots,
                                  int slot0, int tile0, int n_tiles_cls, int c, int h,
                                  int w, int out_h, int out_w, int tile, int cell_r,
                                  int cell_c, void* stream) {
  if (b == 0 || n_tiles_cls == 0) {
    return 0;
  }
  const int R = tile * out_h;
  const int Q = tile * out_w;
  const size_t smem = (size_t)(R + Q) * sizeof(int) + (size_t)2 * (R + Q) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sched_precomp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      return (int)err;
    }
  }
  sched_precomp_kernel<<<n_tiles_cls, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const __nv_bfloat16*)ry, (const __nv_bfloat16*)rx,
      (const int*)tiles, (__nv_bfloat16*)out, b, n_slots, slot0, tile0, c, h, w, out_h,
      out_w, tile, cell_r, cell_c, n_tiles_cls * Q);
  return (int)cudaGetLastError();
}
