// Kernel K3: groupRectangles clustering of the cascade's last-stage
// survivors (the on-device NMS tail), batched over frames, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// rapidobjectdetectionusingcascadedcnns_tpu/ops/nms_pallas.py::_cluster_kernel
// and the containment pass its caller applies, i.e. it computes
// group_rectangles_jax (ops/nms.py:124-209 of the JAX package) per frame,
// with eps as an argument and the label propagation run to convergence. The TPU kernel keeps the whole (N, N) adjacency
// in VMEM, which caps N near 1536; the tail meets N = 4096 on the VGA
// path's open rung and N = 131,903 on the dense path's, so here the
// adjacency is a bitmask in global memory ((B, N, ceil(N/32)) words: 32 MB
// at B = 16, N = 4096, which stays in the 50 MB L2).
//
// Three phases, each a call of rodc_cluster, all on the caller's stream:
//   0. adjacency: one warp per (frame, row, word); lane k tests column
//      32 * word + k and __ballot_sync packs the word. Also writes the
//      initial labels (valid ? i : N).
//   1. `steps` propagation steps, each two launches: neighbour-min, one
//      warp per row walking the row's words with __ffs,
//      label_b[i] = min(label_a[i], min over neighbours j of label_a[j]);
//      pointer jump, one thread per row,
//      label_a[i] = min(label_b[i], label_b[label_b[i]]) (label N -> N).
//      Both read the vector from before them (Jacobi, double-buffered), as
//      the JAX tail does. The last jump of the call sets *changed when a
//      label moved. The wrapper runs the JAX tail's ceil(log2 N) + 1 steps,
//      then more until a step changes nothing: the fixed point is the
//      connected components (each label the component's least row), which
//      the JAX tail's fixed step count does not always reach.
//   2. aggregate: one thread per valid row adds 1 and its integer xywh into
//      the slot of its label (integer atomics: exact, order-free); then
//      finalize: one thread per row; avg = rint(f32(sum) / f32(count)),
//      counts, pre-containment keep = representative & count > min_n; then
//      containment against every kept row j, tiled through shared memory:
//      drop i if it lies inside j (tolerance rint(0.2f * container w/h))
//      and (count_j > max(3, count_i) || count_i < 3).
//
// Rounding points of the JAX tail: delta = f32(eps * 0.5) * (min w + min h)
// (the double product is rounded to f32 by the caller); x + w formed in
// f32; IEEE division and rint (no fast math). A status word reports
// non-integer coordinates (bit 0) and a cluster sum reaching 2^24 (bit 1),
// where the JAX f32 sums stop being exact; the wrapper raises on either.
//
// What bounds it on an H100: the adjacency, B * N^2 * ~16 f32 operations
// (about 0.06 ms at B = 16, N = 4096 at 67 TFLOP/s); the bytes the function
// must move are B * N * ~42, negligible. The label walks are latency bound
// (dependent loads per set bit); making them fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr long long kSumLimit = 1LL << 24;

__global__ void adjacency_kernel(const float4* __restrict__ rects,
                                 const uint8_t* __restrict__ valid,
                                 uint32_t* __restrict__ adj,
                                 int32_t* __restrict__ labels, int b, int n,
                                 int words, float half_eps) {
  const int lane = threadIdx.x & 31;
  const long long total = (long long)b * n * words;
  const long long stride = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long wi = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       wi < total; wi += stride) {
    const int word = (int)(wi % words);
    const long long row = wi / words;  // frame * n + i
    const long long frame0 = (row / n) * n;
    const int j = word * 32 + lane;
    bool bit = false;
    if (j < n && valid[row] && valid[frame0 + j]) {
      const float4 ri = rects[row];
      const float4 rj = rects[frame0 + j];
      const float delta =
          __fmul_rn(half_eps, __fadd_rn(fminf(ri.z, rj.z), fminf(ri.w, rj.w)));
      bit = fabsf(__fsub_rn(ri.x, rj.x)) <= delta &&
            fabsf(__fsub_rn(ri.y, rj.y)) <= delta &&
            fabsf(__fsub_rn(__fadd_rn(ri.x, ri.z), __fadd_rn(rj.x, rj.z))) <= delta &&
            fabsf(__fsub_rn(__fadd_rn(ri.y, ri.w), __fadd_rn(rj.y, rj.w))) <= delta;
    }
    const unsigned bits = __ballot_sync(kFull, bit);
    if (lane == 0) {
      adj[wi] = bits;
      if (word == 0) {
        labels[row] = valid[row] ? (int)(row - frame0) : n;
      }
    }
  }
}

__global__ void neighbor_min_kernel(const uint32_t* __restrict__ adj,
                                    const int32_t* __restrict__ src,
                                    int32_t* __restrict__ dst, int b, int n,
                                    int words) {
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)b * n;
  const long long stride = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       row < rows; row += stride) {
    const int32_t* lab = src + (row / n) * n;
    const uint32_t* a = adj + row * words;
    int m = src[row];
    for (int w = lane; w < words; w += 32) {
      unsigned bits = a[w];
      while (bits) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        m = min(m, lab[w * 32 + k]);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      m = min(m, __shfl_xor_sync(kFull, m, off));
    }
    if (lane == 0) {
      dst[row] = m;
    }
  }
}

__global__ void jump_kernel(const int32_t* __restrict__ src,
                            int32_t* __restrict__ dst, int* changed, int b,
                            int n) {
  const long long rows = (long long)b * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < rows; row += stride) {
    const int l = src[row];
    const int target = l < n ? src[(row / n) * n + l] : n;
    const int label = min(l, target);
    if (changed != nullptr && label != dst[row]) {
      *changed = 1;  // dst still holds the labels from before this step
    }
    dst[row] = label;
  }
}

__global__ void aggregate_kernel(const float4* __restrict__ rects,
                                 const uint8_t* __restrict__ valid,
                                 const int32_t* __restrict__ labels,
                                 int32_t* __restrict__ counts,
                                 unsigned long long* __restrict__ sums,
                                 int* __restrict__ status, int b, int n) {
  const long long rows = (long long)b * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < rows; row += stride) {
    if (!valid[row]) {
      continue;
    }
    const float4 r = rects[row];
    const float v[4] = {r.x, r.y, r.z, r.w};
    const long long slot = (row / n) * n + labels[row];
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

__global__ void finalize_kernel(const uint8_t* __restrict__ valid,
                                const int32_t* __restrict__ labels,
                                const int32_t* __restrict__ counts,
                                const long long* __restrict__ sums,
                                int32_t* __restrict__ avg_out,
                                int32_t* __restrict__ counts_out,
                                uint8_t* __restrict__ keep_out,
                                int64_t* __restrict__ labels_out,
                                int* __restrict__ status, int n,
                                int min_neighbors) {
  __shared__ float s_x0[kThreads], s_y0[kThreads], s_x1[kThreads],
      s_y1[kThreads], s_dx[kThreads], s_dy[kThreads];
  __shared__ int s_count[kThreads];
  __shared__ uint8_t s_keep[kThreads];

  const long long frame0 = (long long)blockIdx.y * n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool kept = false;
  int count_i = 0;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (i < n) {
    const long long row = frame0 + i;
    const int label = labels[row];
    labels_out[row] = label;
    if (valid[row]) {
      count_i = counts[frame0 + label];
      cluster_mean(sums, frame0 + label, count_i, a, status);
      kept = label == i && count_i > min_neighbors;
    }
    counts_out[row] = count_i;
    for (int k = 0; k < 4; ++k) {
      avg_out[row * 4 + k] = (int32_t)a[k];
    }
  }

  bool rejected = false;
  for (int j0 = 0; j0 < n; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    uint8_t keep_j = 0;
    if (j < n) {
      const long long row = frame0 + j;
      const int count_j = counts[row];  // j's own slot: its count if j leads
      if (valid[row] && labels[row] == j && count_j > min_neighbors) {
        float b4[4];
        cluster_mean(sums, row, count_j, b4, status);
        keep_j = 1;
        s_x0[threadIdx.x] = b4[0];
        s_y0[threadIdx.x] = b4[1];
        s_x1[threadIdx.x] = __fadd_rn(b4[0], b4[2]);
        s_y1[threadIdx.x] = __fadd_rn(b4[1], b4[3]);
        s_dx[threadIdx.x] = rintf(__fmul_rn(0.2f, b4[2]));
        s_dy[threadIdx.x] = rintf(__fmul_rn(0.2f, b4[3]));
        s_count[threadIdx.x] = count_j;
      }
    }
    s_keep[threadIdx.x] = keep_j;
    __syncthreads();
    if (kept) {
      const int tile = min((int)blockDim.x, n - j0);
      const float x1 = __fadd_rn(a[0], a[2]);
      const float y1 = __fadd_rn(a[1], a[3]);
      for (int t = 0; t < tile; ++t) {
        if (!s_keep[t] || j0 + t == i) {
          continue;
        }
        const bool inside = a[0] >= __fsub_rn(s_x0[t], s_dx[t]) &&
                            a[1] >= __fsub_rn(s_y0[t], s_dy[t]) &&
                            x1 <= __fadd_rn(s_x1[t], s_dx[t]) &&
                            y1 <= __fadd_rn(s_y1[t], s_dy[t]);
        const bool stronger = s_count[t] > max(3, count_i) || count_i < 3;
        rejected = rejected || (inside && stronger);
      }
    }
    __syncthreads();
  }
  if (i < n) {
    keep_out[frame0 + i] = kept && !rejected;
  }
}

unsigned int grid_for(long long threads) {
  long long blocks = (threads + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 64;  // the grid-stride loops do the rest
  return (unsigned int)(blocks < max_blocks ? (blocks > 0 ? blocks : 1) : max_blocks);
}

}  // namespace

// phase 0, 1 or 2 (see the header). rects (B, N, 4) f32 xywh and valid
// (B, N) bool (one byte each), both contiguous. Workspace, allocated by the
// caller: adj (B, N, ceil(N/32)) uint32; label_a, label_b (B, N) int32;
// counts_ws (B, N) int32 and sums_ws (B, N, 4) int64, both zeroed; status
// and changed, one int32 each, zeroed. Outputs: avg (B, N, 4) int32,
// counts (B, N) int32, keep (B, N) bool, labels (B, N) int64. half_eps is
// f32(eps * 0.5). Launches on `stream`, allocates nothing, does not
// synchronise. Returns the first cudaGetLastError() of its launches (0 on
// success).
extern "C" int rodc_cluster(int phase, const void* rects, const void* valid,
                            void* adj, void* label_a, void* label_b,
                            void* counts_ws, void* sums_ws, void* status,
                            void* changed, void* avg, void* counts,
                            void* keep, void* labels, int b, int n, int steps,
                            int min_neighbors, float half_eps, void* stream) {
  if ((long long)b * n == 0) {
    return 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int words = (n + 31) / 32;
  const long long rows = (long long)b * n;
  int32_t* la = (int32_t*)label_a;
  int32_t* lb = (int32_t*)label_b;

  if (phase == 0) {
    adjacency_kernel<<<grid_for(rows * words * 32), kThreads, 0, s>>>(
        (const float4*)rects, (const uint8_t*)valid, (uint32_t*)adj, la, b,
        n, words, half_eps);
    return (int)cudaGetLastError();
  }
  if (phase == 1) {
    for (int step = 0; step < steps; ++step) {
      neighbor_min_kernel<<<grid_for(rows * 32), kThreads, 0, s>>>(
          (const uint32_t*)adj, la, lb, b, n, words);
      jump_kernel<<<grid_for(rows), kThreads, 0, s>>>(
          lb, la, step == steps - 1 ? (int*)changed : nullptr, b, n);
      const int err = (int)cudaGetLastError();
      if (err != 0) {
        return err;
      }
    }
    return 0;
  }
  aggregate_kernel<<<grid_for(rows), kThreads, 0, s>>>(
      (const float4*)rects, (const uint8_t*)valid, la, (int32_t*)counts_ws,
      (unsigned long long*)sums_ws, (int*)status, b, n);
  const int err = (int)cudaGetLastError();
  if (err != 0) {
    return err;
  }
  const dim3 grid((unsigned int)((n + kThreads - 1) / kThreads), (unsigned int)b);
  finalize_kernel<<<grid, kThreads, 0, s>>>(
      (const uint8_t*)valid, la, (const int32_t*)counts_ws,
      (const long long*)sums_ws, (int32_t*)avg, (int32_t*)counts,
      (uint8_t*)keep, (int64_t*)labels, (int*)status, n, min_neighbors);
  return (int)cudaGetLastError();
}
