// The leaf table of the RLR column kernels (rlr_columns.cuh): up to
// kMaxLeaves leaves of one server step, passed to one launch by value.
//
// Plain C++ (no CUDA and no PyTorch header): rlr_fused_binding.cpp fills a
// Table on the host; rlr_fused.cu and rlr_partial.cu launch it.

#pragma once

#include <cstdint>

namespace rlr {

// 64 leaves x 48 bytes + the header: 3,120 bytes, inside the 4 KB that a
// kernel's parameters take without a copy.
constexpr int kMaxLeaves = 64;

struct Leaf {
  const float* u;  // [m, n] update stack, row-major
  const float* p;  // [n] params (K1), unused by K2
  float* out;      // K1: [n + pad] new params; K2: [n + pad] sign sums or null
  float* out2;     // K2: [n + pad] weighted sums or null; unused by K1
  int64_t n;       // columns
  int32_t tile0;   // the leaf's first tile in the launch (set by the launcher)
  int16_t pad;     // out[n, n + pad) are written with zeros (pad < 4)
  int16_t bulk;    // 1: rows go through the bulk-copy ring (every pointer
                   // 16-byte aligned and n % 4 == 0); 0: plain loads
};

struct Table {
  Leaf leaf[kMaxLeaves];
  const float* wn;     // [m] weights, normalized by the caller
  int32_t n_leaves;
  int32_t m;           // rows of every leaf's stack
  // set by the launcher from m: a tile is [m, cols] columns of one leaf,
  // copied `rows` rows at a time into one stage of the ring
  int32_t cols;
  int32_t rows;
  int32_t chunks;      // ceil(m / rows) stages per tile
  int32_t tiles;       // tiles of every leaf of the launch
  float threshold;     // K1: the RLR vote's threshold
  float server_lr;     // K1
  int32_t use_rlr;     // K1: threshold > 0
  int32_t sign_mode;   // K1: agg = sign(sign sum) instead of the weighted sum
};

}  // namespace rlr
