// The per-tile phases that kernels K2 (csrc/sched.cu) and K2p
// (csrc/sched_precomp.cu) share once a tile's taps are in shared memory:
// compaction of the source rows and columns the taps use, staging of that
// support from each frame, sampling into a bf16 output tile, and one bulk
// store per frame. The two kernels differ only in where the taps come
// from: K2 builds them from sampling positions, K2p reads them from the
// precomputed tap matrices.
//
// A block of kThreads threads takes one tile of `tile` slots. Its shared
// memory (smem_bytes) holds, in order: the bf16 output tile (rounded up to
// 16 bytes); the staging region (`budget` bytes); the row and column
// tables (int4: two tap indices and their two f32 weights, as bits) of the
// tile's tile * out_h row entries (r = slot * out_h + oy) and tile * out_w
// column entries (slot * out_w + ox); lists of the distinct source rows
// and columns; two bitmaps of kMapBits bits with their prefix counts; two
// counts. A table entry's index is cell-local and -1 for a dead tap (a
// weight of 0, or a pixel past the image), whose pixel reads 0.
//
// finish_tile, after the caller has filled the tables and marked every
// live tap in the bitmaps (mark) and synchronised the block:
//   2. compaction: a warp per bitmap turns it into __popc prefix counts
//      and the list of the distinct source rows (columns), and the tables
//      are rewritten to offsets into the compacted support;
//   3. staging, per frame: the support, (distinct rows) x (distinct
//      columns) x C bf16, is copied from the (C, H, W) planes into shared
//      memory, neighbouring threads on increasing columns of one row,
//      every channel of a pixel per item;
//   4. sampling: a thread takes a slot column (slot, ox), loads its taps
//      once and walks its rows; each (slot, oy, ox) reads its 2x2 pixels'
//      channels from shared memory into the bf16 (slot, oy, ox, c) output
//      tile, with the rounding points of csrc/cell_resample.cuh;
//   5. store: one cp.async.bulk copy per frame, which runs while the next
//      frame is staged.
// A tile whose support exceeds the staging budget, or whose cell reaches
// more than kMapBits rows or columns into the image (not `mapped`), is
// sampled by gathers from the planes with the same tables and arithmetic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cell_resample.cuh"

namespace rodc {
namespace sched_tile {

constexpr int kThreads = 512;
constexpr int kMapBits = 4096;  // cell-local rows (columns) a bitmap covers
constexpr int kMapWords = kMapBits / 32;
constexpr int kWordsPerLane = kMapWords / 32;

// Dynamic shared memory of a block with the given staging budget:
// windows_sched_cuda.launch_geometry computes the same.
__host__ __device__ constexpr long long smem_bytes(int tile, int out_h, int out_w, int c,
                                                   int budget) {
  return align16(2LL * tile * out_h * out_w * c) + budget + 24LL * tile * out_h +
         24LL * tile * out_w + 16LL * kMapWords + 8;
}

// The regions of a block's shared memory (see the layout above).
struct Tile {
  __nv_bfloat16* otile;
  __nv_bfloat16* stage;
  int4* rtab;
  int4* ctab;
  int* rlist;
  int* clist;
  unsigned int* rmap;
  unsigned int* cmap;
  int* rpre;
  int* cpre;
  int* counts;
};

__device__ __forceinline__ Tile carve(unsigned char* smem, int per_tile, int budget, int n_rows,
                                      int n_cols) {
  const long long tile_bytes = align16(2LL * per_tile);
  Tile s;
  s.otile = reinterpret_cast<__nv_bfloat16*>(smem);
  s.stage = reinterpret_cast<__nv_bfloat16*>(smem + tile_bytes);
  s.rtab = reinterpret_cast<int4*>(smem + tile_bytes + budget);
  s.ctab = s.rtab + n_rows;
  s.rlist = reinterpret_cast<int*>(s.ctab + n_cols);
  s.clist = s.rlist + 2 * n_rows;
  s.rmap = reinterpret_cast<unsigned int*>(s.clist + 2 * n_cols);
  s.cmap = s.rmap + kMapWords;
  s.rpre = reinterpret_cast<int*>(s.cmap + kMapWords);
  s.cpre = s.rpre + kMapWords;
  s.counts = s.cpre + kMapWords;
  return s;
}

// Whether the tile's cell fits the bitmaps: a live tap lies inside the
// cell and before the image's end.
__device__ __forceinline__ bool mapped(int cell_r, int cell_c, int lim_r, int lim_c) {
  return min(cell_r, lim_r) <= kMapBits && min(cell_c, lim_c) <= kMapBits;
}

// Zero both bitmaps (rmap and cmap are adjacent).
__device__ __forceinline__ void clear_maps(const Tile& s) {
  for (int i = threadIdx.x; i < 2 * kMapWords; i += kThreads) {
    s.rmap[i] = 0u;
  }
}

// Mark a live tap's cell-local index in a bitmap.
__device__ __forceinline__ void mark(unsigned int* map, int i) {
  if (i >= 0) {
    atomicOr(&map[i >> 5], 1u << (i & 31));
  }
}

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
        const float v0 = bf16_round(vertical_sum(wy0, p[0][ci], wy1, p[2][ci]));
        const float v1 = bf16_round(vertical_sum(wy0, p[1][ci], wy1, p[3][ci]));
        out[ci] = __float2bfloat16_rn(quantize(wx0, v0, wx1, v1));
      }
    }
  }
}

// Phases 2-5 of the tile whose slots start at slot0 and whose cell starts
// at (row0, col0), for every frame: planes (frames, kC, h, w), out
// (frames, n_slots, out_h, out_w, kC). The block has filled the tables,
// marked the live taps (when `is_mapped`) and synchronised.
template <int kC>
__device__ __forceinline__ void finish_tile(const Tile& s, const __nv_bfloat16* __restrict__ planes,
                                            __nv_bfloat16* __restrict__ out, int frames,
                                            int n_slots, int h, int w, int out_h, int out_w,
                                            int tile, int budget, long long slot0, int row0,
                                            int col0, bool is_mapped) {
  const int per_tile = tile * out_h * out_w * kC;
  const int n_rows = tile * out_h;
  const int n_cols = tile * out_w;

  // 2. compaction: warp 0 the rows, warp 1 the columns
  if (is_mapped && threadIdx.x < 64) {
    const bool rows = threadIdx.x < 32;
    const int n = scan_map(rows ? s.rmap : s.cmap, rows ? s.rpre : s.cpre,
                           rows ? s.rlist : s.clist, rows ? row0 : col0);
    if ((threadIdx.x & 31) == 0) {
      s.counts[rows ? 0 : 1] = n;
    }
  }
  __syncthreads();
  const int nr = is_mapped ? s.counts[0] : 0;
  const int nc = is_mapped ? s.counts[1] : 0;
  const bool staged = is_mapped && 2LL * kC * nr * nc <= budget;
  // table entries: offsets into the support, or image rows and columns
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    int4 e = s.rtab[r];
    if (staged) {
      e.x = e.x < 0 ? -1 : compact_index(s.rmap, s.rpre, e.x) * nc * kC;
      e.y = e.y < 0 ? -1 : compact_index(s.rmap, s.rpre, e.y) * nc * kC;
    } else {
      e.x = e.x < 0 ? -1 : row0 + e.x;
      e.y = e.y < 0 ? -1 : row0 + e.y;
    }
    s.rtab[r] = e;
  }
  for (int x = threadIdx.x; x < n_cols; x += kThreads) {
    int4 e = s.ctab[x];
    if (staged) {
      e.x = e.x < 0 ? -1 : compact_index(s.cmap, s.cpre, e.x) * kC;
      e.y = e.y < 0 ? -1 : compact_index(s.cmap, s.cpre, e.y) * kC;
    } else {
      e.x = e.x < 0 ? -1 : col0 + e.x;
      e.y = e.y < 0 ? -1 : col0 + e.y;
    }
    s.ctab[x] = e;
  }

  // the staging items (ri, cj), cj fastest, advance by compares
  const int n_items = nr * nc;
  const int ri0 = nc > 0 ? threadIdx.x / nc : 0;
  const int cj0 = nc > 0 ? threadIdx.x % nc : 0;
  const int step_ri = nc > 0 ? kThreads / nc : 0;
  const int step_cj = nc > 0 ? kThreads % nc : 0;
  const long long plane = (long long)h * w;
  const bool bulk = (per_tile & 7) == 0;
  const int* rlist = s.rlist;
  const int* clist = s.clist;
  __nv_bfloat16* stage = s.stage;
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
      bulk_store_wait();
    }
    __syncthreads();

    // 4. sampling
    if (staged) {
      sample_tile<kC, true>(s.rtab, s.ctab, stage, plane, w, n_cols, out_h, out_w, s.otile);
    } else {
      sample_tile<kC, false>(s.rtab, s.ctab, frame, plane, w, n_cols, out_h, out_w, s.otile);
    }

    // 5. store
    __nv_bfloat16* dst = out + ((long long)b * n_slots + slot0) * (per_tile / tile);
    if (bulk) {
      bulk_store_tile(dst, s.otile, (unsigned int)per_tile * 2u, /*wait=*/false);
    } else {
      __syncthreads();
      for (int i = threadIdx.x; i < per_tile; i += kThreads) {
        dst[i] = s.otile[i];
      }
    }
  }
  if (bulk && threadIdx.x == 0) {
    bulk_store_wait();
  }
}

}  // namespace sched_tile
}  // namespace rodc
