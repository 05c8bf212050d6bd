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
// What bounds it on an H100: the tap bytes. At FDDB density (450x450,
// scale factor 1.005) the matrices of the 4,140 tiles are 1,617.8 MB, read
// once per call, against 4 x 114.5 MB of bf16 output for 4 frames: about
// 0.62 ms at 3.35 TB/s. The kernel reads every tap byte, which is what the
// experiment measures; it does not rebuild taps from positions.
//
// A first port (3.24 ms, 19% of that bound) lost time three ways: one
// launch per cell class, 8 at FDDB density, each lasting as long as its
// slowest block, so the card's time was a sum of 8 per-tile latencies;
// each 256-thread block streamed its 246-786 KB of taps with one 16-byte
// load per thread in flight, each followed by shared atomics, about 4 KB
// in flight a block; and every output value made up to four dependent
// gathers from the (C, H, W) planes through the L2.
//
// Design: one launch over every class and frame. The wrapper's class
// table (ops/windows_sched_precomp_cuda.py::class_table) numbers the
// blocks through the classes by tap bytes a tile, largest first, so the
// last wave is made of small tiles. One 512-thread block takes a tile:
//   1. the tap stream: warp 15, the producer, keeps cp.async.bulk copies
//      (global to shared, completion on an mbarrier, L2 evict-first) in
//      flight into a ring of kStages stages over the output tile and the
//      staging region, both dead until phase 2 (3 x 31,056 bytes at 12 px
//      and a 64 KB budget): first the tile's RY block (tile * out_h
//      contiguous rows of cell_r values, whole rows a stage), then its RX
//      block (cell_c rows of tile * out_w values at the class's row
//      stride, a copy a row). Warps 0-14 reduce each stage without shared
//      atomics and release it on the stage's empty barrier: for RY, a
//      group of lanes takes a row, ORs its 16-byte chunks with independent
//      loads and reduces the row's first nonzero tap and count with
//      shuffles; for RX, a thread owns two columns, walks the stage's rows
//      with its first nonzero and count in registers and merges them into
//      the column's state only where the stage holds a nonzero. A row's or
//      column's taps are its first nonzero and the one after it (a
//      triangle row has at most two nonzeros, adjacent); they become K2's
//      table entries, a dead tap (no nonzero, a zero weight, a pixel past
//      the image) at index -1, and mark K2's bitmaps. Every other nonzero
//      is counted into `violations`, which a caller holds at 0.
//   2-5. K2's phases from csrc/sched_tile.cuh: compaction, staging of the
//      support from each frame, sampling from shared memory, one bulk
//      store per frame. The block's shared memory is K2's plus the ring's
//      barriers and the violation count (56 bytes), so two blocks fit an SM.
// At FDDB density the stream alone runs at about 3.1 TB/s, the copies'
// own rate; the kernel takes about 1.12 ms, 55% of its bound, because a
// block's phases follow one another and the two blocks of an SM overlap
// the stream with K2's sampling only in part (PERF.md, section 6).
// The values equal K2's bit for bit: the same live taps and weights give
// the same support and the same sums (a product of two bf16 values is
// exact in f32, and a tap whose pixel reads 0 adds +0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cell_resample.cuh"
#include "sched_tile.cuh"

namespace {

using namespace rodc::sched_tile;

constexpr int kStages = 3;                          // ring stages
constexpr int kConsumerWarps = kThreads / 32 - 1;   // warp 15 is the producer
constexpr int kConsumers = kConsumerWarps * 32;

// A row of the class table: the class's RY and RX matrices, RX's row
// stride in values, its first tile in slot order and its tile count, its
// first block, and its cell.
struct ClassEntry {
  long long ry;
  long long rx;
  long long rx_stride;
  long long tile0;
  long long n_tiles;
  long long block0;
  long long cell_r;
  long long cell_c;
};

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive on the barrier and add `bytes` to the transfers its phase awaits.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned int parity) {
  const unsigned int addr = smem_addr(bar);
  unsigned int done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// An L2 policy for data read once: the tap stream evicts itself first,
// so the frames' planes stay in the L2 for staging.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; the barrier's transfer count falls on arrival.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned int bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Bit k of the result: bf16 value k of the chunk is not 0 (either sign).
__device__ __forceinline__ unsigned int nonzero_mask(const uint4 v) {
  const unsigned int q[4] = {v.x, v.y, v.z, v.w};
  unsigned int m = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m |= ((q[k] & 0x7fffu) != 0u ? 1u : 0u) << (2 * k);
    m |= ((q[k] & 0x7fff0000u) != 0u ? 1u : 0u) << (2 * k + 1);
  }
  return m;
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits) {
  return __uint_as_float(bits << 16);
}

// K2's table entry of a row or column whose first nonzero tap is `lo`
// (-1: none) with weight w0, and w1 after it: index -1 for a dead tap;
// the live ones are marked.
__device__ __forceinline__ int4 two_taps(int lo, float w0, float w1, int limit, bool is_mapped,
                                         unsigned int* map) {
  if (lo < 0) {
    return make_int4(-1, -1, 0, 0);
  }
  const int i0 = lo < limit ? lo : -1;
  const int i1 = (w1 != 0.0f && lo + 1 < limit) ? lo + 1 : -1;
  if (is_mapped) {
    mark(map, i0);
    mark(map, i1);
  }
  return make_int4(i0, i1, __float_as_int(w0), __float_as_int(w1));
}

// One ring stage of RY rows [r0, r0 + rows), each cell_r values, by the
// consumer threads: a group of `parts` neighbouring lanes takes a row (the
// most a power of two up to 32 gives the stage's rows), lane k of the
// group its 16-byte chunks k, k + parts, ... Each lane ORs its chunks with
// independent loads (a chunk with a nonzero tap, rare, gives its first
// nonzero and count), the group reduces the first nonzero and the count
// with shuffles, and its first lane writes the row's taps and adds the
// nonzeros besides lo and lo + 1 to `bad`. The chunk order rotates by row,
// so lanes of neighbouring rows read other banks.
__device__ __forceinline__ void reduce_ry(const unsigned char* src, int r0, int rows, int cell_r,
                                          int lim_r, bool is_mapped, const Tile& s, int& bad) {
  const int cpr = cell_r >> 3;  // 16-byte chunks a row
  int parts = 32;
  while (parts > 1 && (parts > cpr || parts * rows > kConsumers)) {
    parts >>= 1;
  }
  const int per_sweep = kConsumers / parts;
  const int part = threadIdx.x & (parts - 1);
  const int passes = (cpr + parts - 1) / parts;
  const uint4* base = reinterpret_cast<const uint4*>(src);
  for (int first = 0; first < rows; first += per_sweep) {
    const int row = first + threadIdx.x / parts;
    const bool live = row < rows;
    const uint4* chunks = base + (long long)row * cpr;
    int lo = INT_MAX;
    int count = 0;
    if (live) {
#pragma unroll 4
      for (int k = 0; k < passes; ++k) {
        int pass = k + row;
        pass -= pass / passes * passes;
        const int chunk = pass * parts + part;
        if (chunk < cpr) {
          const uint4 v = chunks[chunk];
          if (((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0u) {
            const unsigned int m = nonzero_mask(v);
            count += __popc(m);
            lo = min(lo, chunk * 8 + __ffs(m) - 1);
          }
        }
      }
    }
    for (int d = parts >> 1; d > 0; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
      count += __shfl_xor_sync(0xffffffffu, count, d);
    }
    if (live && part == 0) {
      const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(chunks);
      float w0 = 0.0f;
      float w1 = 0.0f;
      if (count > 0) {
        w0 = __bfloat162float(vals[lo]);
        w1 = lo + 1 < cell_r ? __bfloat162float(vals[lo + 1]) : 0.0f;
        bad += count - 1 - (w1 != 0.0f ? 1 : 0);
      }
      s.rtab[r0 + row] = two_taps(count > 0 ? lo : -1, w0, w1, lim_r, is_mapped, s.rmap);
    }
  }
}

// A column's stage summary into its state (first nonzero row, count, w0
// bits, w1 bits) in ctab: the stage's rows [c0, c0 + rows) hold `count`
// nonzeros, the first at row c0 + f. `words` and `pair` give the stage's
// values of the column's pair, `half` its half of them.
__device__ __forceinline__ void rx_merge(int4* e, const unsigned int* words, int pairs, int pair,
                                         int half, int c0, int rows, int f, unsigned int wf,
                                         int count) {
  int4 v = *e;
  if (v.y == 0) {
    v.x = c0 + f;
    v.z = __float_as_int(bf16_bits_to_float(wf));
    // the weight after it, if this stage holds its row (else the next one)
    v.w = f + 1 < rows
              ? __float_as_int(bf16_bits_to_float((words[(f + 1) * pairs + pair] >> (16 * half)) & 0xffffu))
              : 0;
  } else if (v.x == c0 - 1) {
    // the first nonzero was the last row of the previous stage
    v.w = __float_as_int(bf16_bits_to_float((words[pair] >> (16 * half)) & 0xffffu));
  }
  v.y += count;
  *e = v;
}

// One ring stage of RX rows [c0, c0 + rows), each n_cols values: consumer
// thread i owns the column pairs i, i + kConsumers, ... It walks a pair's
// rows with its first nonzero row and count in registers (no stores
// between the loads, so they pipeline) and merges a column into its state
// in ctab only where the stage holds a nonzero.
__device__ __forceinline__ void reduce_rx(const unsigned char* src, int c0, int rows, int n_cols,
                                          const Tile& s) {
  const int pairs = n_cols >> 1;
  const unsigned int* words = reinterpret_cast<const unsigned int*>(src);
  for (int p = threadIdx.x; p < pairs; p += kConsumers) {
    int f0 = -1, f1 = -1, n0 = 0, n1 = 0;
    unsigned int w0 = 0u, w1 = 0u;
#pragma unroll 8
    for (int i = 0; i < rows; ++i) {
      const unsigned int v = words[i * pairs + p];
      if ((v & 0x7fff7fffu) != 0u) {
        if ((v & 0x7fffu) != 0u) {
          if (n0++ == 0) {
            f0 = i;
            w0 = v & 0xffffu;
          }
        }
        if ((v & 0x7fff0000u) != 0u) {
          if (n1++ == 0) {
            f1 = i;
            w1 = v >> 16;
          }
        }
      }
    }
    if (n0 > 0) {
      rx_merge(&s.ctab[2 * p], words, pairs, p, 0, c0, rows, f0, w0, n0);
    }
    if (n1 > 0) {
      rx_merge(&s.ctab[2 * p + 1], words, pairs, p, 1, c0, rows, f1, w1, n1);
    }
  }
}

// kC: the channel count (1 to 4; 3 for the cascade's frames).
template <int kC>
__global__ void __launch_bounds__(kThreads, 2)
    sched_precomp_kernel(const __nv_bfloat16* __restrict__ planes,
                         const ClassEntry* __restrict__ classes, int n_classes,
                         const int* __restrict__ tiles, __nv_bfloat16* __restrict__ out,
                         int* __restrict__ violations, int frames, int n_slots, int h, int w,
                         int out_h, int out_w, int tile, int budget, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_rows = tile * out_h;  // RY rows of a tile (K2's row entries)
  const int n_cols = tile * out_w;  // RX columns of a tile (K2's column entries)
  const Tile s = carve(smem, tile * out_h * out_w * kC, budget, n_rows, n_cols);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + smem_bytes(tile, out_h, out_w, kC, budget));
  uint64_t* empty = full + kStages;
  int* bad_total = reinterpret_cast<int*>(empty + kStages);

  // the block's class and tile
  int k = 0;
  while (k + 1 < n_classes && blockIdx.x >= classes[k + 1].block0) {
    ++k;
  }
  const ClassEntry cls = classes[k];
  const int local = blockIdx.x - (int)cls.block0;
  const int t = (int)cls.tile0 + local;
  const int row0 = tiles[4 * t + 0];
  const int col0 = tiles[4 * t + 1];
  const int cell_r = tiles[4 * t + 2];
  const int cell_c = tiles[4 * t + 3];
  const int lim_r = h - row0;
  const int lim_c = w - col0;
  const bool is_mapped = mapped(cell_r, cell_c, lim_r, lim_c);
  clear_maps(s);
  for (int x = threadIdx.x; x < n_cols; x += kThreads) {
    s.ctab[x] = make_int4(0, 0, 0, 0);  // no nonzero seen yet
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    *bad_total = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 1. the tap stream: n_ry stages of RY rows, then RX rows
  const int ry_rows = stage_bytes / (2 * cell_r);
  const int rx_rows = stage_bytes / (2 * n_cols);
  const int n_ry = (n_rows + ry_rows - 1) / ry_rows;
  const int n_stages = n_ry + (cell_c + rx_rows - 1) / rx_rows;
  const __nv_bfloat16* ry =
      reinterpret_cast<const __nv_bfloat16*>(cls.ry) + (long long)local * n_rows * cell_r;
  const __nv_bfloat16* rx = reinterpret_cast<const __nv_bfloat16*>(cls.rx) + (long long)local * n_cols;
  // the ring: the output tile and the staging region, dead until phase 2
  unsigned char* ring = reinterpret_cast<unsigned char*>(s.otile);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int bad = 0;
  if (warp == kConsumerWarps) {
    const uint64_t policy = evict_first_policy();
    for (int j = 0; j < n_stages; ++j) {
      const int slot = j % kStages;
      if (j >= kStages) {
        mbar_wait(&empty[slot], (j / kStages - 1) & 1);  // its last round was read
      }
      unsigned char* dst = ring + slot * stage_bytes;
      if (j < n_ry) {
        if (lane == 0) {
          const int r0 = j * ry_rows;
          const unsigned int bytes = 2u * min(ry_rows, n_rows - r0) * cell_r;
          mbar_expect_tx(&full[slot], bytes);
          bulk_load(dst, ry + (long long)r0 * cell_r, bytes, &full[slot], policy);
        }
      } else {
        const int c0 = (j - n_ry) * rx_rows;
        const int rows = min(rx_rows, cell_c - c0);
        if (lane == 0) {
          mbar_expect_tx(&full[slot], 2u * rows * n_cols);
        }
        __syncwarp();
        for (int i = lane; i < rows; i += 32) {
          bulk_load(dst + 2 * i * n_cols, rx + (long long)(c0 + i) * cls.rx_stride,
                    2u * n_cols, &full[slot], policy);
        }
      }
    }
  } else {
    for (int j = 0; j < n_stages; ++j) {
      const int slot = j % kStages;
      mbar_wait(&full[slot], (j / kStages) & 1);
      const unsigned char* src = ring + slot * stage_bytes;
      if (j < n_ry) {
        const int r0 = j * ry_rows;
        reduce_ry(src, r0, min(ry_rows, n_rows - r0), cell_r, lim_r, is_mapped, s, bad);
      } else {
        const int c0 = (j - n_ry) * rx_rows;
        reduce_rx(src, c0, min(rx_rows, cell_c - c0), n_cols, s);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[slot]);  // the stage may be refilled
      }
    }
  }
  __syncthreads();
  // the columns' taps from their state; the nonzeros besides lo and lo + 1
  for (int x = threadIdx.x; x < n_cols; x += kThreads) {
    const int4 e = s.ctab[x];
    const float w1 = __int_as_float(e.w);
    if (e.y > 0) {
      bad += e.y - 1 - (w1 != 0.0f ? 1 : 0);
    }
    s.ctab[x] = two_taps(e.y > 0 ? e.x : -1, __int_as_float(e.z), w1, lim_c, is_mapped, s.cmap);
  }
  if (bad != 0) {
    atomicAdd(bad_total, bad);
  }
  __syncthreads();
  if (threadIdx.x == 0 && *bad_total != 0) {
    atomicAdd(violations, *bad_total);
  }

  // 2-5. compaction, staging, sampling and the stores, as K2
  finish_tile<kC>(s, planes, out, frames, n_slots, h, w, out_h, out_w, tile, budget,
                  (long long)t * tile, row0, col0, is_mapped);
}

// Dynamic shared memory of a launch: K2's with the same budget, the ring's
// full and empty barriers and the block's violation count (8 bytes).
long long precomp_smem(int tile, int out_h, int out_w, int c, int budget) {
  return smem_bytes(tile, out_h, out_w, c, budget) + 16LL * kStages + 8;
}

}  // namespace

// planes (B, C, H, W) bf16; classes (n_classes, 8) int64 rows of
// ops/windows_sched_precomp_cuda.py::class_table, on the device (their
// RY and RX addresses 16-byte aligned, tile * out_w and every cell_r
// multiples of 8); tiles (n_tiles, 4) int32 rows (row0, col0, cell_r,
// cell_c); out (B, n_slots, out_h, out_w, C) bf16 (its base 16-byte
// aligned); violations one int32 on the device, to which the kernel adds
// the nonzero taps besides each row's and column's two; n_slots = n_tiles
// * tile, and the classes' blocks number n_tiles. budget, stage_bytes and
// smem_bytes are windows_sched_precomp_cuda.launch_geometry's: budget a
// multiple of 16, kStages stages of stage_bytes (a multiple of 16) within
// the output tile and the staging region, and smem_bytes equal to
// precomp_smem(..., budget), else the call launches nothing and returns
// cudaErrorInvalidValue. Launches once on `stream`, allocates nothing,
// does not synchronise. Returns cudaGetLastError() of the launch (0 on
// success).
extern "C" int rodc_sched_precomp(const void* planes, const void* classes, const void* tiles,
                                  void* out, void* violations, int b, int n_slots,
                                  int n_classes, int c, int h, int w, int out_h, int out_w,
                                  int tile, int budget, int stage_bytes, int smem_bytes,
                                  void* stream) {
  if (b == 0 || n_slots == 0 || (long long)out_h * out_w * c == 0) {
    return 0;
  }
  if (c < 1 || c > 4 || tile < 1 || n_slots % tile || n_classes < 1 || budget < 0 ||
      budget % 16 || stage_bytes < 16 || stage_bytes % 16 ||
      (long long)kStages * stage_bytes > rodc::align16(2LL * tile * out_h * out_w * c) + budget ||
      (tile * out_w) % 8 ||
      precomp_smem(tile, out_h, out_w, c, budget) != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  void (*const kernels[4])(const __nv_bfloat16*, const ClassEntry*, int, const int*,
                           __nv_bfloat16*, int*, int, int, int, int, int, int, int, int, int) = {
      sched_precomp_kernel<1>, sched_precomp_kernel<2>, sched_precomp_kernel<3>,
      sched_precomp_kernel<4>};
  const auto kernel = kernels[c - 1];
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      return (int)err;
    }
  }
  kernel<<<(unsigned int)(n_slots / tile), rodc::sched_tile::kThreads, smem_bytes,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)planes, (const ClassEntry*)classes, n_classes, (const int*)tiles,
      (__nv_bfloat16*)out, (int*)violations, b, n_slots, h, w, out_h, out_w, tile, budget,
      stage_bytes);
  return (int)cudaGetLastError();
}
