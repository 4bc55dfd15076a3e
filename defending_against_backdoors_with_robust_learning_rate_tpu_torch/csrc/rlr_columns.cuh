// The body of both RLR server kernels: a column reduction over the [m, n]
// update stacks of every leaf of one server step, in one launch, with the
// epilogue as a template argument (K1: rlr_fused.cu, K2: rlr_partial.cu).
//
// For every column j of every leaf, over the m rows of its stack U:
//
//   s_j = sum_i sign(U_ij)          w_j = sum_i wn_i * U_ij
//
// and the epilogue turns (s_j, w_j) into the kernel's output.
//
// Bound: bytes. Each column reads m floats of U and writes one or two, and
// the arithmetic (about 3m operations) is far below the card's rate per
// byte. So the design keeps the memory busy and reads U exactly once:
//
// - One launch over all leaves. The leaves come as a table (rlr_table.h)
//   passed by value as a __grid_constant__ parameter; each leaf is cut into
//   tiles of [m, cols] columns, numbered leaf after leaf. A persistent grid
//   of (SMs x blocks per SM) blocks walks the tiles: block b takes tiles b,
//   b + grid, b + 2 grid, ..., and finds each tile's leaf by walking the
//   table's tile prefix forward.
// - A ring of kStages stages in shared memory. Thread 0 copies a tile's m
//   row segments with 1-D bulk copies (cp.async.bulk ... complete_tx), and
//   the stage's mbarrier, armed with the byte count, reports their arrival.
//   So the next tiles' bytes are in flight while the block reduces this
//   one. An epilogue that reads the params (K1) has their segment copied
//   into the stage as one more row, so no thread waits on device memory in
//   the epilogue either. cols is chosen from m so that a stage holds at
//   most 24 KB (K1 at m = 10: 512 columns, 22 KB; K2 at m = 2: 2048
//   columns, 16 KB), which leaves room for three or four blocks on an SM,
//   each with its ring in flight; above 47 rows a tile takes several
//   stages of `rows` rows each.
// - Every thread reduces float4 column groups out of the stage: thread t
//   reads groups t, t + 128, ..., so a warp reads 512 consecutive bytes of
//   a row and no two threads of a quarter-warp share a bank. Both sums stay
//   in registers, and the epilogue writes 16 bytes a thread.
// - A bulk copy needs 16-byte aligned addresses and a size that is a
//   multiple of 16 bytes. A leaf that cannot give that (n % 4 != 0, or a
//   pointer off 16 bytes) is marked `bulk = 0` by the binding and takes the
//   plain branch inside the same launch: one thread per column walks the m
//   rows with coalesced loads from device memory. On CNN_MNIST that is
//   Dense_1.bias (n = 10).
//
// Pallas tiled 1024 columns per sequential grid step through VMEM, one
// launch per leaf; here the tile walk is spread over the SMs and the ring
// takes the place of Pallas's double-buffered block copies.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "rlr_table.h"

namespace rlr {

constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kStageFloats = 6144;  // 24 KB a stage at most
constexpr int kMinCols = 128;
constexpr int kMaxCols = 2048;
constexpr int kGroups = kMaxCols / 4 / kThreads;  // float4 groups a thread
constexpr int kBarrierBytes = 128;  // the stages' mbarriers, before the ring

static_assert(sizeof(Table) <= 4096, "the leaf table must fit in 4 KB");

// jnp.sign / torch.sign: +1, -1, the zero itself, NaN stays NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` more from the bulk copies of this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int leaf_end(const Table& t, int li) {
  return li + 1 < t.n_leaves ? t.leaf[li + 1].tile0 : t.tiles;
}

// Columns of the tile that starts at column c0 (the leaf's last is short).
__device__ __forceinline__ int tile_cols(const Table& t, const Leaf& leaf,
                                         int64_t c0) {
  return leaf.n - c0 < t.cols ? static_cast<int>(leaf.n - c0) : t.cols;
}

__device__ __forceinline__ void accumulate(float4& s, float4& w, float4 x,
                                           float wr) {
  s.x += sign_of(x.x);
  s.y += sign_of(x.y);
  s.z += sign_of(x.z);
  s.w += sign_of(x.w);
  w.x = fmaf(wr, x.x, w.x);
  w.y = fmaf(wr, x.y, w.y);
  w.z = fmaf(wr, x.z, w.z);
  w.w = fmaf(wr, x.w, w.w);
}

// Thread 0's place in the block's sequence of bulk loads: the tile (counted
// in the block's own walk), its chunk of rows, and the tile's leaf.
struct Producer {
  int k = 0;
  int chunk = 0;
  int li = 0;
};

// Issue the block's next bulk load, if any is left, into `stage` and arm
// `bar` with its bytes. Loads go out in the order the block consumes them,
// so the q-th load lands in stage q % kStages. With `p_row`, a tile's last
// chunk also brings the params' segment, as the row after `rows`.
__device__ __forceinline__ void issue_next(const Table& t, Producer& pr,
                                           float* stage, uint64_t* bar,
                                           bool p_row) {
  int g;
  for (;;) {
    g = blockIdx.x + pr.k * gridDim.x;
    if (g >= t.tiles) return;
    while (g >= leaf_end(t, pr.li)) ++pr.li;
    if (t.leaf[pr.li].bulk) break;
    ++pr.k;  // a plain leaf's tile: its threads load it themselves
  }
  const Leaf& leaf = t.leaf[pr.li];
  const int64_t c0 = static_cast<int64_t>(g - leaf.tile0) * t.cols;
  const int ncols = tile_cols(t, leaf, c0);
  const int r0 = pr.chunk * t.rows;
  const int nrows = min(t.rows, t.m - r0);
  const bool last = pr.chunk + 1 == t.chunks;
  const uint32_t row_bytes = static_cast<uint32_t>(ncols) * 4u;
  mbar_expect_tx(bar, row_bytes * (nrows + (p_row && last ? 1 : 0)));
  for (int r = 0; r < nrows; ++r) {
    bulk_load(stage + r * t.cols, leaf.u + (r0 + r) * leaf.n + c0, row_bytes,
              bar);
  }
  if (p_row && last) {
    bulk_load(stage + t.rows * t.cols, leaf.p + c0, row_bytes, bar);
  }
  if (++pr.chunk == t.chunks) {
    pr.chunk = 0;
    ++pr.k;
  }
}

template <class Epilogue>
__global__ void __launch_bounds__(kThreads)
    rlr_columns_kernel(const __grid_constant__ Table t) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);
  constexpr bool p_row = Epilogue::kParamsRow;
  const int stage_floats = (t.rows + p_row) * t.cols;

  Producer pr;  // used by thread 0 alone
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      issue_next(t, pr, ring + s * stage_floats, &full[s], p_row);
    }
  }

  int q = 0;  // bulk loads consumed
  int li = 0;
  for (int k = 0;; ++k) {
    const int g = blockIdx.x + k * gridDim.x;
    if (g >= t.tiles) break;
    while (g >= leaf_end(t, li)) ++li;
    const Leaf& leaf = t.leaf[li];
    const int64_t c0 = static_cast<int64_t>(g - leaf.tile0) * t.cols;
    const int ncols = tile_cols(t, leaf, c0);
    if (leaf.bulk) {
      float4 s[kGroups];
      float4 w[kGroups];
      float4 p[kGroups];  // the params' segment, where the epilogue reads it
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        w[i] = s[i];
        p[i] = s[i];
      }
      const int n4 = ncols / 4;  // ncols % 4 == 0 on a bulk leaf
      for (int c = 0; c < t.chunks; ++c, ++q) {
        const int stage = q % kStages;
        mbar_wait(&full[stage], (q / kStages) & 1);
        const float* buf = ring + stage * stage_floats;
        const int r0 = c * t.rows;
        const int nrows = min(t.rows, t.m - r0);
        for (int r = 0; r < nrows; ++r) {
          const float wr = __ldg(t.wn + r0 + r);
          const float4* row = reinterpret_cast<const float4*>(buf + r * t.cols);
#pragma unroll
          for (int i = 0; i < kGroups; ++i) {
            const int j = threadIdx.x + i * kThreads;
            if (j < n4) accumulate(s[i], w[i], row[j], wr);
          }
        }
        if (p_row && c + 1 == t.chunks) {
          const float4* prow =
              reinterpret_cast<const float4*>(buf + t.rows * t.cols);
#pragma unroll
          for (int i = 0; i < kGroups; ++i) {
            const int j = threadIdx.x + i * kThreads;
            if (j < n4) p[i] = prow[j];
          }
        }
        __syncthreads();  // every thread is done with this stage: refill it
        if (threadIdx.x == 0) {
          issue_next(t, pr, ring + stage * stage_floats, &full[stage], p_row);
        }
      }
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int j = threadIdx.x + i * kThreads;
        if (j < n4) Epilogue::store4(t, leaf, c0 + 4 * j, s[i], w[i], p[i]);
      }
    } else {
      for (int j = threadIdx.x; j < ncols; j += kThreads) {
        const int64_t col = c0 + j;
        float s = 0.f;
        float w = 0.f;
        for (int i = 0; i < t.m; ++i) {
          const float x = __ldg(leaf.u + i * leaf.n + col);
          s += sign_of(x);
          w = fmaf(__ldg(t.wn + i), x, w);
        }
        Epilogue::store1(t, leaf, col, s, w);
      }
      if (c0 + ncols == leaf.n && threadIdx.x < leaf.pad) {
        Epilogue::store_zero(leaf, leaf.n + threadIdx.x);
      }
    }
  }
}

// The tile geometry from m (and the params' row, where there is one), and
// each leaf's first tile.
inline void plan_tiles(Table& t, int p_row) {
  int cols = kMaxCols;
  while (cols > kMinCols && cols * (t.m + p_row) > kStageFloats) cols /= 2;
  t.cols = cols;
  t.rows = std::min(t.m, kStageFloats / cols - p_row);
  t.chunks = (t.m + t.rows - 1) / t.rows;
  int64_t tiles = 0;
  for (int i = 0; i < t.n_leaves; ++i) {
    t.leaf[i].tile0 = static_cast<int32_t>(tiles);
    tiles += (t.leaf[i].n + cols - 1) / cols;
  }
  t.tiles = static_cast<int32_t>(tiles);
}

// Plan the tiles and launch on `stream` without synchronising. Returns the
// error of the host calls before the launch; the caller checks the launch
// itself with cudaGetLastError() right after, so this function must not
// read or clear that error.
template <class Epilogue>
cudaError_t launch_columns(Table t, cudaStream_t stream) {
  constexpr int p_row = Epilogue::kParamsRow ? 1 : 0;
  plan_tiles(t, p_row);
  const int smem = kBarrierBytes + kStages * (t.rows + p_row) * t.cols *
                                       static_cast<int>(sizeof(float));
  const auto kernel = rlr_columns_kernel<Epilogue>;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const int grid = std::max(1, std::min(t.tiles, sms * std::max(per_sm, 1)));
  kernel<<<grid, kThreads, smem, stream>>>(t);
  return cudaSuccess;
}

}  // namespace rlr
