// Kernel K3: groupRectangles clustering of the cascade's last-stage
// survivors (the on-device NMS tail), batched over frames, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// rapidobjectdetectionusingcascadedcnns_tpu/ops/nms_pallas.py::_cluster_kernel
// and the containment pass its caller applies, i.e. it computes
// group_rectangles_jax (ops/nms.py:124-209 of the JAX package) per frame,
// with eps as an argument and the labels at their fixed point: the
// connected components of the SimilarRects graph, each labelled with its
// least row (the JAX tail's min-label propagation stops after a fixed step
// count and does not always reach it). The TPU kernel keeps the whole
// (N, N) adjacency in VMEM and propagates labels step by step; here a
// lock-free union-find reaches the fixed point directly, and no adjacency
// is stored: the workspace is O(B * N).
//
// Four launches per call, whatever the data, all on the caller's stream:
//   1. init: parent[i] = i, counts and int64 sums zeroed, status zeroed;
//   2. pairs: one block per (frame, row tile I, column tile J >= I) of
//      kTile rows; both tiles' rects and valid flags are staged in shared
//      memory. A block whose two tiles lie apart (the ranges of one
//      coordinate further apart than any delta of their rows) stops there;
//      otherwise each pair i < j is tested once (the test is symmetric),
//      a thread's 64 tests into a bit mask before any join.
//      A similar pair is first joined in a union-find over the block's own
//      rows in shared memory; then each row whose block-local root is
//      another row is joined to it in the frame's global union-find. A join
//      hooks the larger root under the smaller with atomicCAS, after finds
//      with path halving, and retries until the two roots agree. A root is
//      only ever hooked under a smaller root of the same component, so
//      every parent is at most its child and the final root of each
//      component is its least row, whatever order the atomics ran in: the
//      labels equal the plain version's;
//   3. compress + aggregate: one thread per row; label = find(row) (N on
//      invalid rows), then 1 and the row's integer xywh are added into the
//      slot of its label (integer atomics: exact, order-free);
//   4. finalize: one thread per row, kFinalThreads rows a block; avg =
//      rint(f32(sum) / f32(count)), counts, pre-containment keep =
//      representative & count > min_n; then, in blocks that keep a row,
//      containment of the block's kept rows (compacted) against every kept
//      row j of the frame, in tiles of kFinalRows * kFinalThreads rows
//      whose kept rows are compacted too, the (kept, container) pairs
//      spread over the threads: drop i if it lies inside j
//      (tolerance rint(0.2f * container w/h)) and
//      (count_j > max(3, count_i) || count_i < 3).
//
// Rounding points of the JAX tail: delta = f32(eps * 0.5) * (min w + min h)
// (the double product is rounded to f32 by the caller); x + w formed in
// f32; IEEE division and rint (no fast math). A status word reports
// non-integer coordinates (bit 0) and a cluster sum reaching 2^24 (bit 1),
// where the JAX f32 sums stop being exact; the wrapper raises on either.
//
// What bounds it on an H100: the pair tests, B * N(N-1)/2 * ~16 f32
// operations (0.032 ms at B = 16, N = 4096 at 67 TFLOP/s); the bytes it
// must move are B * N * ~46, negligible. The test has no fused
// multiply-add, so its issue rate is half the f32 peak, which counts an
// FMA as two operations. The design keeps the tiles' rows in shared
// memory and registers; rows come in window order (scale, then x, then
// y), so most tile pairs lie apart and are pruned whole; and it keeps the
// many similar pairs of a cluster off global memory: they meet in the
// block's shared union-find, so at most one global join per row and tile
// pair is left.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;  // rows per tile; a pair block has 2 * kTile = kThreads threads
static_assert(2 * kTile == kThreads, "a pair block holds one local row per thread");
static_assert(kTile / 2 == 64, "a thread's tests of half a column tile fill one 64-bit mask");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFinalThreads = 512;  // rows per finalize block
constexpr int kFinalRows = 2;  // rows a finalize thread scans per containment tile
constexpr long long kSumLimit = 1LL << 24;

// ---- union-find with hook-to-minimum (parent[v] <= v always) -----------

// Global finds read through L2 (ld.cg): other blocks hook and halve
// concurrently, and L1 is not coherent across SMs.
__device__ __forceinline__ int find_global(int* parent, int x) {
  int cur = __ldcg(parent + x);
  if (cur == x) {
    return x;
  }
  int prev = x;
  int next;
  while (cur > (next = __ldcg(parent + cur))) {  // cur is no root: halve
    __stcg(parent + prev, next);
    prev = cur;
    cur = next;
  }
  return cur;
}

__device__ void join_global(int* parent, int a, int b) {
  int ra = find_global(parent, a);
  int rb = find_global(parent, b);
  while (ra != rb) {
    if (ra < rb) {
      const int t = ra;
      ra = rb;
      rb = t;
    }
    // hook the larger root under the smaller; if it is no longer a root,
    // the CAS returns its parent and the walk goes on from there
    const int seen = atomicCAS(parent + ra, ra, rb);
    if (seen == ra) {
      return;
    }
    ra = seen;
  }
}

__device__ __forceinline__ int find_shared(volatile int* parent, int x) {
  int cur = parent[x];
  if (cur == x) {
    return x;
  }
  int prev = x;
  int next;
  while (cur > (next = parent[cur])) {
    parent[prev] = next;
    prev = cur;
    cur = next;
  }
  return cur;
}

__device__ void join_shared(int* parent, int a, int b) {
  int ra = find_shared(parent, a);
  int rb = find_shared(parent, b);
  while (ra != rb) {
    if (ra < rb) {
      const int t = ra;
      ra = rb;
      rb = t;
    }
    const int seen = atomicCAS(parent + ra, ra, rb);
    if (seen == ra) {
      return;
    }
    ra = seen;
  }
}

// ---- launches ------------------------------------------------------------

__global__ void init_kernel(int32_t* __restrict__ parent,
                            int32_t* __restrict__ counts,
                            long long* __restrict__ sums,
                            int* __restrict__ status, long long rows, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < rows; row += stride) {
    parent[row] = (int)(row % n);
    counts[row] = 0;
    for (int k = 0; k < 4; ++k) {
      sums[row * 4 + k] = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *status = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_kernel(const float4* __restrict__ rects,
                const uint8_t* __restrict__ valid, int32_t* __restrict__ parent,
                int n, float half_eps) {
  __shared__ float4 s_box[2 * kTile];  // x, y, x + w, y + h
  __shared__ float2 s_wh[2 * kTile];
  __shared__ uint8_t s_valid[2 * kTile];
  __shared__ int s_parent[2 * kTile];
  __shared__ float s_red[kThreads / 32][9];
  __shared__ bool s_apart;

  // tile pair p = tj * (tj + 1) / 2 + ti with ti <= tj
  const long long p = blockIdx.x;
  long long tj = (long long)((sqrtf(8.0f * (float)p + 1.0f) - 1.0f) * 0.5f);
  while (tj * (tj + 1) / 2 > p) {
    --tj;
  }
  while ((tj + 1) * (tj + 2) / 2 <= p) {
    ++tj;
  }
  const int ti = (int)(p - tj * (tj + 1) / 2);
  const bool diag = ti == (int)tj;
  const int row0 = ti * kTile;
  const int col0 = (int)tj * kTile;
  const long long frame0 = (long long)blockIdx.y * n;
  int* fparent = parent + frame0;

  // local index l = threadIdx.x: row row0 + l for l < kTile, column
  // col0 + l - kTile above (a diagonal block uses only the first half). An
  // invalid row gets x = +inf, which no similarity test passes.
  const int l = threadIdx.x;
  const int g = l < kTile ? row0 + l : col0 + l - kTile;
  bool v = false;
  float4 box = make_float4(INFINITY, 0.0f, INFINITY, 0.0f);
  float2 wh = make_float2(0.0f, 0.0f);
  if (g < n && (l < kTile || !diag) && valid[frame0 + g]) {
    const float4 r = rects[frame0 + g];
    v = true;
    box = make_float4(r.x, r.y, __fadd_rn(r.x, r.z), __fadd_rn(r.y, r.w));
    wh = make_float2(r.z, r.w);
  }
  s_box[l] = box;
  s_wh[l] = wh;
  s_valid[l] = v;
  s_parent[l] = l;

  // Tile pruning. For i in I and j in J, delta_ij <= D_j = f32(half_eps *
  // (w_j + h_j)) (rounding is monotone), so a similar pair has each
  // coordinate distance at most D = min(max_I D, max_J D). If the two
  // tiles' ranges of one coordinate lie more than D apart, no pair of
  // them is similar and the block stops here. Warps 0-3 hold tile I's
  // rows, warps 4-7 tile J's.
  float red[9];
  red[0] = v ? box.x : INFINITY;
  red[1] = v ? box.y : INFINITY;
  red[2] = v ? box.z : INFINITY;
  red[3] = v ? box.w : INFINITY;
  red[4] = v ? box.x : -INFINITY;
  red[5] = v ? box.y : -INFINITY;
  red[6] = v ? box.z : -INFINITY;
  red[7] = v ? box.w : -INFINITY;
  red[8] = v ? __fmul_rn(half_eps, __fadd_rn(wh.x, wh.y)) : 0.0f;
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float o = __shfl_xor_sync(kFull, red[k], off);
      red[k] = k < 4 ? fminf(red[k], o) : fmaxf(red[k], o);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      s_red[threadIdx.x >> 5][k] = red[k];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool apart = false;
    if (!diag) {
      float t[2][9];
      for (int side = 0; side < 2; ++side) {
        for (int k = 0; k < 9; ++k) {
          constexpr int warps = kTile / 32;  // per tile
          float r = s_red[warps * side][k];
          for (int wi = 1; wi < warps; ++wi) {
            const float o = s_red[warps * side + wi][k];
            r = k < 4 ? fminf(r, o) : fmaxf(r, o);
          }
          t[side][k] = r;
        }
      }
      const float d = fminf(t[0][8], t[1][8]);
      for (int k = 0; k < 4; ++k) {
        apart = apart || __fsub_rn(t[1][k], t[0][4 + k]) > d ||
                __fsub_rn(t[0][k], t[1][4 + k]) > d;
      }
    }
    s_apart = apart;
  }
  __syncthreads();
  if (s_apart) {
    return;
  }

  // thread: row il against half of the column tile. The 64 tests go into
  // a bit mask first (a loop with no branch, which the compiler unrolls),
  // then the few similar pairs are joined. A warp shares each column, so
  // its shared reads are broadcasts. Similar iff the largest of the four
  // coordinate distances is at most delta (coordinates are finite: a
  // non-finite one sets the status word, and the call raises).
  const int il = threadIdx.x % kTile;
  const int half = threadIdx.x / kTile;
  const int jbase = (diag ? 0 : kTile) + half * (kTile / 2);
  const float4 bi = s_box[il];
  const float2 wi = s_wh[il];
  unsigned long long similar = 0;  // bit t: local column jbase + t
#pragma unroll 8
  for (int t = 0; t < kTile / 2; ++t) {
    const float4 bj = s_box[jbase + t];
    const float2 wj = s_wh[jbase + t];
    const float delta =
        __fmul_rn(half_eps, __fadd_rn(fminf(wi.x, wj.x), fminf(wi.y, wj.y)));
    const float d = fmaxf(fmaxf(fabsf(__fsub_rn(bi.x, bj.x)), fabsf(__fsub_rn(bi.y, bj.y))),
                          fmaxf(fabsf(__fsub_rn(bi.z, bj.z)), fabsf(__fsub_rn(bi.w, bj.w))));
    similar |= (unsigned long long)(d <= delta) << t;
  }
  if (!s_valid[il]) {
    similar = 0;
  } else if (diag) {  // pairs i < j only: columns jbase + t > il
    const int first = il + 1 - half * (kTile / 2);
    similar &= first <= 0 ? ~0ULL : (first >= kTile / 2 ? 0ULL : ~0ULL << first);
  }
  while (similar) {
    const int t = __ffsll(similar) - 1;
    similar &= similar - 1;
    join_shared(s_parent, il, jbase + t);
  }
  __syncthreads();

  const int n_local = diag ? kTile : 2 * kTile;
  for (int l = threadIdx.x; l < n_local; l += blockDim.x) {
    const int r = find_shared(s_parent, l);
    if (r != l) {
      const int gl = l < kTile ? row0 + l : col0 + l - kTile;
      const int gr = r < kTile ? row0 + r : col0 + r - kTile;
      join_global(fparent, gl, gr);
    }
  }
}

__global__ void compress_kernel(const float4* __restrict__ rects,
                                const uint8_t* __restrict__ valid,
                                int32_t* __restrict__ parent,
                                int64_t* __restrict__ labels,
                                int32_t* __restrict__ counts,
                                unsigned long long* __restrict__ sums,
                                int* __restrict__ status, long long rows, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < rows; row += stride) {
    if (!valid[row]) {
      labels[row] = n;
      continue;
    }
    const long long frame0 = (row / n) * n;
    const int label = find_global(parent + frame0, (int)(row - frame0));
    labels[row] = label;
    const float4 r = rects[row];
    const float v[4] = {r.x, r.y, r.z, r.w};
    const long long slot = frame0 + label;
    atomicAdd(&counts[slot], 1);
    for (int k = 0; k < 4; ++k) {
      if (v[k] != rintf(v[k]) || fabsf(v[k]) >= (float)kSumLimit) {
        atomicOr(status, v[k] != rintf(v[k]) ? 1 : 2);
        continue;
      }
      atomicAdd(&sums[slot * 4 + k], (unsigned long long)__float2ll_rz(v[k]));
    }
  }
}

// A representative row's rounded mean from its own aggregate slot.
__device__ __forceinline__ void cluster_mean(const long long* sums,
                                             long long slot, int count,
                                             float out[4], int* status) {
  for (int k = 0; k < 4; ++k) {
    const long long s = sums[slot * 4 + k];
    if (s >= kSumLimit || s <= -kSumLimit) {
      atomicOr(status, 2);
    }
    out[k] = rintf(__fdiv_rn(__ll2float_rn(s), (float)count));
  }
}

__global__ void __launch_bounds__(kFinalThreads)
    finalize_kernel(const uint8_t* __restrict__ valid,
                    const int64_t* __restrict__ labels,
                    const int32_t* __restrict__ counts,
                    const long long* __restrict__ sums,
                    int32_t* __restrict__ avg_out,
                    int32_t* __restrict__ counts_out,
                    uint8_t* __restrict__ keep_out, int* __restrict__ status,
                    int n, int min_neighbors) {
  // the block's kept rows (compacted): x0, y0, x1, y1, count, row, rejected
  __shared__ float4 s_mine[kFinalThreads];
  __shared__ int s_mine_count[kFinalThreads], s_mine_row[kFinalThreads];
  __shared__ uint8_t s_rejected[kFinalThreads];
  // one tile's containers (compacted): x0 - dx, y0 - dy, x1 + dx, y1 + dy
  __shared__ float4 s_cont[kFinalRows * kFinalThreads];
  __shared__ int s_cont_count[kFinalRows * kFinalThreads], s_cont_row[kFinalRows * kFinalThreads];
  __shared__ int s_n_mine, s_n_cont;

  const long long frame0 = (long long)blockIdx.y * n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (threadIdx.x == 0) {
    s_n_mine = 0;
  }
  __syncthreads();
  bool kept = false;
  int slot = -1;
  if (i < n) {
    const long long row = frame0 + i;
    int count_i = 0;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (valid[row]) {
      const int label = (int)labels[row];
      count_i = counts[frame0 + label];
      cluster_mean(sums, frame0 + label, count_i, a, status);
      kept = label == i && count_i > min_neighbors;
    }
    counts_out[row] = count_i;
    for (int k = 0; k < 4; ++k) {
      avg_out[row * 4 + k] = (int32_t)a[k];
    }
    if (kept) {
      slot = atomicAdd(&s_n_mine, 1);
      s_mine[slot] = make_float4(a[0], a[1], __fadd_rn(a[0], a[2]), __fadd_rn(a[1], a[3]));
      s_mine_count[slot] = count_i;
      s_mine_row[slot] = i;
      s_rejected[slot] = 0;
    }
  }
  __syncthreads();
  const int n_mine = s_n_mine;

  // containment only where this block keeps a row (a block-uniform test):
  // every (kept row, container) pair of each tile of the frame's rows,
  // spread over the block's threads
  if (n_mine > 0) {
    for (int j0 = 0; j0 < n; j0 += kFinalRows * blockDim.x) {
      if (threadIdx.x == 0) {
        s_n_cont = 0;
      }
      __syncthreads();
      // the tile's rows: every load issued before any is used
      bool lead[kFinalRows];
      int count_j[kFinalRows];
#pragma unroll
      for (int u = 0; u < kFinalRows; ++u) {
        const int j = j0 + u * blockDim.x + threadIdx.x;
        lead[u] = false;
        if (j < n) {
          const long long row = frame0 + j;
          count_j[u] = counts[row];  // j's own slot: its count if j leads
          lead[u] = valid[row] && labels[row] == j && count_j[u] > min_neighbors;
        }
      }
#pragma unroll
      for (int u = 0; u < kFinalRows; ++u) {
        if (lead[u]) {
          const int j = j0 + u * blockDim.x + threadIdx.x;
          float b[4];
          cluster_mean(sums, frame0 + j, count_j[u], b, status);
          const float dx = rintf(__fmul_rn(0.2f, b[2]));
          const float dy = rintf(__fmul_rn(0.2f, b[3]));
          const int t = atomicAdd(&s_n_cont, 1);
          s_cont[t] = make_float4(__fsub_rn(b[0], dx), __fsub_rn(b[1], dy),
                                  __fadd_rn(__fadd_rn(b[0], b[2]), dx),
                                  __fadd_rn(__fadd_rn(b[1], b[3]), dy));
          s_cont_count[t] = count_j[u];
          s_cont_row[t] = j;
        }
      }
      __syncthreads();
      const int n_cont = s_n_cont;
      // a warp per container, its lanes over the kept rows
      const int warps = blockDim.x / 32;
      for (int t = threadIdx.x / 32; t < n_cont; t += warps) {
        const float4 c = s_cont[t];
        const int count_t = s_cont_count[t];
        const int row_t = s_cont_row[t];
        for (int m = threadIdx.x % 32; m < n_mine; m += 32) {
          const float4 a = s_mine[m];
          const int count_i = s_mine_count[m];
          const bool inside = a.x >= c.x && a.y >= c.y && a.z <= c.z && a.w <= c.w;
          const bool stronger = count_t > max(3, count_i) || count_i < 3;
          if (inside && stronger && row_t != s_mine_row[m]) {
            s_rejected[m] = 1;
          }
        }
      }
      __syncthreads();
    }
  }
  if (i < n) {
    keep_out[frame0 + i] = kept && !s_rejected[slot];
  }
}

unsigned int grid_for(long long threads) {
  long long blocks = (threads + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 16;  // the grid-stride loops do the rest
  return (unsigned int)(blocks < max_blocks ? (blocks > 0 ? blocks : 1) : max_blocks);
}

}  // namespace

// rects (B, N, 4) f32 xywh and valid (B, N) bool (one byte each), both
// contiguous. workspace: cluster_workspace_bytes(B, N) bytes, allocated by
// the caller, 8-byte aligned, in any state (the first launch initialises
// it): int64 sums (B, N, 4), then int32 parents (B, N), int32 counts
// (B, N) and the int32 status word. Outputs: avg (B, N, 4) int32, counts
// (B, N) int32, keep (B, N) bool, labels (B, N) int64. half_eps is
// f32(eps * 0.5). Four launches on `stream`; allocates nothing, does not
// synchronise. Returns the first cudaGetLastError() of its launches (0 on
// success); B > 65535 or more than 2^31 - 1 tile pairs per frame return
// cudaErrorInvalidValue without a launch.
extern "C" int rodc_cluster(const void* rects, const void* valid,
                            void* workspace, void* avg, void* counts,
                            void* keep, void* labels, int b, int n,
                            int min_neighbors, float half_eps, void* stream) {
  const long long rows = (long long)b * n;
  if (rows == 0) {
    return 0;
  }
  const long long tiles = (n + kTile - 1) / kTile;
  const long long pairs = tiles * (tiles + 1) / 2;
  if (b > 65535 || pairs > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  long long* sums = (long long*)workspace;
  int32_t* parent = (int32_t*)(sums + rows * 4);
  int32_t* counts_ws = parent + rows;
  int* status = counts_ws + rows;

  init_kernel<<<grid_for(rows), kThreads, 0, s>>>(parent, counts_ws, sums, status, rows, n);
  int err = (int)cudaGetLastError();
  if (err != 0) {
    return err;
  }
  pair_kernel<<<dim3((unsigned int)pairs, (unsigned int)b), kThreads, 0, s>>>(
      (const float4*)rects, (const uint8_t*)valid, parent, n, half_eps);
  err = (int)cudaGetLastError();
  if (err != 0) {
    return err;
  }
  compress_kernel<<<grid_for(rows), kThreads, 0, s>>>(
      (const float4*)rects, (const uint8_t*)valid, parent, (int64_t*)labels,
      counts_ws, (unsigned long long*)sums, status, rows, n);
  err = (int)cudaGetLastError();
  if (err != 0) {
    return err;
  }
  const dim3 grid((unsigned int)((n + kFinalThreads - 1) / kFinalThreads), (unsigned int)b);
  finalize_kernel<<<grid, kFinalThreads, 0, s>>>(
      (const uint8_t*)valid, (const int64_t*)labels, (const int32_t*)counts_ws,
      (const long long*)sums, (int32_t*)avg, (int32_t*)counts, (uint8_t*)keep,
      status, n, min_neighbors);
  return (int)cudaGetLastError();
}
