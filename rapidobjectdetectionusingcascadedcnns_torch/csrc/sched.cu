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
// tables and arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cell_resample.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMapBits = 4096;  // cell-local rows (columns) a bitmap covers
constexpr int kMapWords = kMapBits / 32;
constexpr int kWordsPerLane = kMapWords / 32;

// Cell-local index -> its rank among the marked indices below it.
__device__ __forceinline__ int compact_index(const unsigned int* map, const int* pre, int i) {
  return pre[i >> 5] + __popc(map[i >> 5] & ((1u << (i & 31)) - 1u));
}

// Prefix counts of one bitmap and the list of its marked indices (plus
// `base`), by one warp; returns the count on every lane.
__device__ __forceinline__ int scan_map(const unsigned int* map, int* pre, int* list, int base) {
  const int lane = threadIdx.x & 31;
  unsigned int words[kWordsPerLane];
  int count = 0;
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) {
    words[q] = map[lane * kWordsPerLane + q];
    count += __popc(words[q]);
  }
  int inclusive = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inclusive, d);
    if (lane >= d) {
      inclusive += v;
    }
  }
  int pos = inclusive - count;
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) {
    const int word = lane * kWordsPerLane + q;
    pre[word] = pos;
    unsigned int bits = words[q];
    while (bits) {
      list[pos++] = base + word * 32 + __ffs(bits) - 1;
      bits &= bits - 1u;
    }
  }
  return __shfl_sync(0xffffffffu, inclusive, 31);
}

// One frame's output tile from the tables: kStaged reads the compacted
// support in shared memory (table entries are offsets into it), else the
// planes (table entries are image rows and columns). A thread takes one
// slot column (slot, ox) at a time and walks its out_h rows, so it loads
// the column's taps once; each output issues its 4 x kC pixel loads before
// any sum.
template <int kC, bool kStaged>
__device__ __forceinline__ void sample_tile(const int4* rtab, const int4* ctab,
                                            const __nv_bfloat16* src, long long plane, int w,
                                            int n_cols, int out_h, int out_w,
                                            __nv_bfloat16* otile) {
  using Off = typename std::conditional<kStaged, int, long long>::type;
  for (int x = threadIdx.x; x < n_cols; x += kThreads) {
    const int4 ce = ctab[x];
    const float wx0 = __int_as_float(ce.z);
    const float wx1 = __int_as_float(ce.w);
    const int slot = x / out_w;
    int r = slot * out_h;
    __nv_bfloat16* out = otile + (r * out_w + x - slot * out_w) * kC;
    for (int oy = 0; oy < out_h; ++oy, ++r, out += out_w * kC) {
      const int4 re = rtab[r];
      const int ia[4] = {re.x, re.x, re.y, re.y};
      const int ib[4] = {ce.x, ce.y, ce.x, ce.y};
      float p[4][kC];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // offsets: 32-bit into the support, 64-bit into a frame's planes
        const bool live = (ia[q] | ib[q]) >= 0;
        const Off o = kStaged ? (Off)(ia[q] + ib[q]) : (Off)ia[q] * w + ib[q];
#pragma unroll
        for (int ci = 0; ci < kC; ++ci) {
          const Off off = kStaged ? (Off)ci : (Off)(ci * plane);
          p[q][ci] = live ? __bfloat162float(src[o + off]) : 0.0f;
        }
      }
      const float wy0 = __int_as_float(re.z);
      const float wy1 = __int_as_float(re.w);
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) {
        const float v0 = rodc::bf16_round(rodc::vertical_sum(wy0, p[0][ci], wy1, p[2][ci]));
        const float v1 = rodc::bf16_round(rodc::vertical_sum(wy0, p[1][ci], wy1, p[3][ci]));
        out[ci] = __float2bfloat16_rn(rodc::quantize(wx0, v0, wx1, v1));
      }
    }
  }
}

// kC: the channel count (1 to 4; 3 for the cascade's frames).
template <int kC>
__global__ void __launch_bounds__(kThreads, 2)
    sched_kernel(const __nv_bfloat16* __restrict__ planes,
                 const float* __restrict__ sy_local, const float* __restrict__ sx_local,
                 const int* __restrict__ tiles, __nv_bfloat16* __restrict__ out, int frames,
                 int n_slots, int h, int w, int out_h, int out_w, int tile, int budget) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = blockIdx.x;
  const int per_tile = tile * out_h * out_w * kC;
  const int n_rows = tile * out_h;  // row entries r = slot * out_h + oy
  const int n_cols = tile * out_w;  // column entries slot * out_w + ox

  // shared layout (see sched_smem): output tile; staged support (budget
  // bytes); row and column tables (int4: two indices, two weights); lists
  // of the distinct rows and columns; the two bitmaps and their prefix
  // counts; the two counts
  const long long tile_bytes = rodc::align16(2LL * per_tile);
  __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + tile_bytes);
  int4* rtab = reinterpret_cast<int4*>(smem + tile_bytes + budget);
  int4* ctab = rtab + n_rows;
  int* rlist = reinterpret_cast<int*>(ctab + n_cols);
  int* clist = rlist + 2 * n_rows;
  unsigned int* rmap = reinterpret_cast<unsigned int*>(clist + 2 * n_cols);
  unsigned int* cmap = rmap + kMapWords;
  int* rpre = reinterpret_cast<int*>(cmap + kMapWords);
  int* cpre = rpre + kMapWords;
  int* counts = cpre + kMapWords;

  const int row0 = tiles[4 * t + 0];
  const int col0 = tiles[4 * t + 1];
  const int cell_r = tiles[4 * t + 2];
  const int cell_c = tiles[4 * t + 3];
  // a live tap lies inside the cell and before the image's end
  const int lim_r = h - row0;
  const int lim_c = w - col0;
  const bool mapped = min(cell_r, lim_r) <= kMapBits && min(cell_c, lim_c) <= kMapBits;
  for (int i = threadIdx.x; i < 2 * kMapWords; i += kThreads) {
    rmap[i] = 0u;  // rmap and cmap
  }
  __syncthreads();

  // 1. taps, marking the live ones
  const long long slot0 = (long long)t * tile;
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const rodc::Taps tp = rodc::cell_taps(sy_local[slot0 * out_h + r], cell_r, lim_r);
    rtab[r] = make_int4(tp.i0, tp.i1, __float_as_int(tp.w0), __float_as_int(tp.w1));
    if (mapped) {
      if (tp.i0 >= 0) atomicOr(&rmap[tp.i0 >> 5], 1u << (tp.i0 & 31));
      if (tp.i1 >= 0) atomicOr(&rmap[tp.i1 >> 5], 1u << (tp.i1 & 31));
    }
  }
  for (int x = threadIdx.x; x < n_cols; x += kThreads) {
    const rodc::Taps tp = rodc::cell_taps(sx_local[slot0 * out_w + x], cell_c, lim_c);
    ctab[x] = make_int4(tp.i0, tp.i1, __float_as_int(tp.w0), __float_as_int(tp.w1));
    if (mapped) {
      if (tp.i0 >= 0) atomicOr(&cmap[tp.i0 >> 5], 1u << (tp.i0 & 31));
      if (tp.i1 >= 0) atomicOr(&cmap[tp.i1 >> 5], 1u << (tp.i1 & 31));
    }
  }
  __syncthreads();

  // 2. compaction: warp 0 the rows, warp 1 the columns
  if (mapped && threadIdx.x < 64) {
    const bool rows = threadIdx.x < 32;
    const int n = scan_map(rows ? rmap : cmap, rows ? rpre : cpre, rows ? rlist : clist,
                           rows ? row0 : col0);
    if ((threadIdx.x & 31) == 0) {
      counts[rows ? 0 : 1] = n;
    }
  }
  __syncthreads();
  const int nr = mapped ? counts[0] : 0;
  const int nc = mapped ? counts[1] : 0;
  const bool staged = mapped && 2LL * kC * nr * nc <= budget;
  // table entries: offsets into the support, or image rows and columns
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    int4 e = rtab[r];
    if (staged) {
      e.x = e.x < 0 ? -1 : compact_index(rmap, rpre, e.x) * nc * kC;
      e.y = e.y < 0 ? -1 : compact_index(rmap, rpre, e.y) * nc * kC;
    } else {
      e.x = e.x < 0 ? -1 : row0 + e.x;
      e.y = e.y < 0 ? -1 : row0 + e.y;
    }
    rtab[r] = e;
  }
  for (int x = threadIdx.x; x < n_cols; x += kThreads) {
    int4 e = ctab[x];
    if (staged) {
      e.x = e.x < 0 ? -1 : compact_index(cmap, cpre, e.x) * kC;
      e.y = e.y < 0 ? -1 : compact_index(cmap, cpre, e.y) * kC;
    } else {
      e.x = e.x < 0 ? -1 : col0 + e.x;
      e.y = e.y < 0 ? -1 : col0 + e.y;
    }
    ctab[x] = e;
  }

  // the staging items (ri, cj), cj fastest, advance by compares
  const int n_items = nr * nc;
  const int ri0 = nc > 0 ? threadIdx.x / nc : 0;
  const int cj0 = nc > 0 ? threadIdx.x % nc : 0;
  const int step_ri = nc > 0 ? kThreads / nc : 0;
  const int step_cj = nc > 0 ? kThreads % nc : 0;
  const long long plane = (long long)h * w;
  const bool bulk = (per_tile & 7) == 0;
  __syncthreads();

  for (int b = 0; b < frames; ++b) {
    const __nv_bfloat16* frame = planes + (long long)b * kC * plane;
    // 3. staging: two items in flight per thread, every channel per item
    if (staged) {
      int e = threadIdx.x;
      int ri = ri0;
      int cj = cj0;
      while (e < n_items) {
        __nv_bfloat16 v[2][kC];
        int idx[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          idx[u] = e;
          if (e < n_items) {
            const __nv_bfloat16* p = frame + (long long)rlist[ri] * w + clist[cj];
#pragma unroll
            for (int ci = 0; ci < kC; ++ci) {
              v[u][ci] = p[ci * plane];
            }
          }
          e += kThreads;
          ri += step_ri;
          cj += step_cj;
          if (cj >= nc) {
            cj -= nc;
            ++ri;
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (idx[u] < n_items) {
#pragma unroll
            for (int ci = 0; ci < kC; ++ci) {
              stage[idx[u] * kC + ci] = v[u][ci];
            }
          }
        }
      }
    }
    // the previous frame's store must have read the output tile
    if (bulk && b > 0 && threadIdx.x == 0) {
      rodc::bulk_store_wait();
    }
    __syncthreads();

    // 4. sampling
    if (staged) {
      sample_tile<kC, true>(rtab, ctab, stage, plane, w, n_cols, out_h, out_w, otile);
    } else {
      sample_tile<kC, false>(rtab, ctab, frame, plane, w, n_cols, out_h, out_w, otile);
    }

    // 5. store
    __nv_bfloat16* dst = out + ((long long)b * n_slots + slot0) * (per_tile / tile);
    if (bulk) {
      rodc::bulk_store_tile(dst, otile, (unsigned int)per_tile * 2u, /*wait=*/false);
    } else {
      __syncthreads();
      for (int i = threadIdx.x; i < per_tile; i += kThreads) {
        dst[i] = otile[i];
      }
    }
  }
  if (bulk && threadIdx.x == 0) {
    rodc::bulk_store_wait();
  }
}

}  // namespace

// Dynamic shared memory of a launch with the given staging budget:
// windows_sched_cuda.launch_geometry computes the same.
static long long sched_smem(int tile, int out_h, int out_w, int c, int budget) {
  return rodc::align16(2LL * tile * out_h * out_w * c) + budget + 24LL * tile * out_h +
         24LL * tile * out_w + 16LL * kMapWords + 8;
}

// planes (B, C, H, W) bf16; sy_local (n_slots, out_h) and sx_local
// (n_slots, out_w) f32 cell-local positions, shared by all frames; tiles
// (n_tiles, 4) int32 rows (row0, col0, cell_r, cell_c); out (B, n_slots,
// out_h, out_w, C) bf16, allocated by the caller (its base 16-byte
// aligned); n_slots = n_tiles * tile. budget and smem_bytes are
// windows_sched_cuda.launch_geometry's: budget a multiple of 16 and
// smem_bytes equal to sched_smem(..., budget), else the call launches
// nothing and returns cudaErrorInvalidValue. Launches on `stream`,
// allocates nothing, does not synchronise. Returns cudaGetLastError() of
// the launch (0 on success).
extern "C" int rodc_sched(const void* planes, const void* sy_local,
                          const void* sx_local, const void* tiles, void* out,
                          int b, int n_slots, int c, int h, int w, int out_h,
                          int out_w, int tile, int budget, int smem_bytes,
                          void* stream) {
  if (b == 0 || n_slots == 0 || (long long)out_h * out_w * c == 0) {
    return 0;
  }
  if (c < 1 || c > 4 || tile < 1 || n_slots % tile || budget < 0 || budget % 16 ||
      sched_smem(tile, out_h, out_w, c, budget) != smem_bytes) {
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
  kernel<<<(unsigned int)(n_slots / tile), kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const float*)sy_local, (const float*)sx_local,
      (const int*)tiles, (__nv_bfloat16*)out, b, n_slots, h, w, out_h, out_w, tile, budget);
  return (int)cudaGetLastError();
}
