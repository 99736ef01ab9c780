// Bit-addressed tiles of a flat complex64 state vector, shared by
// fused_apply.cu and shm_apply.cu.
//
// A tile is the set of 2^t amplitudes whose index bits outside the tile's
// bit set `pos` (t positions, ascending) are fixed. Tile number `id` fixes
// those bits to the bits of `id`, in order; tile element j sits at
//   base(id) + (bit i of j placed at pos[i], for every i).
// Because `pos` is ascending, consecutive j walk the tile in address order,
// so loads and stores are as contiguous as the bit set allows. Two small
// tables in shared memory (the low 7 and the high t-7 bits of j) turn the
// bit scatter into two lookups and an add. All addresses are 64-bit: a
// 2^30-amplitude state has float offsets up to 2^31.
#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int kMaxBits = 16;  // largest tile: 2^16 amplitudes
constexpr int kLoBits = 7;    // bits of j resolved by the low table

// Index with zero bits inserted at the ascending positions pos[0..t).
__device__ __forceinline__ long long insert_zero_bits(long long id, const int* pos, int t) {
  for (int i = 0; i < t; ++i) {
    const long long low = id & ((1LL << pos[i]) - 1);
    id = ((id >> pos[i]) << (pos[i] + 1)) | low;
  }
  return id;
}

__host__ __device__ constexpr int hi_entries(int t) {
  return t > kLoBits ? 1 << (t - kLoBits) : 1;
}

// Fill the address tables (lo: 2^kLoBits entries, hi: hi_entries(t)).
// Call from every thread of the block; synchronise before use.
__device__ __forceinline__ void build_tables(long long* lo, long long* hi, const int* pos, int t) {
  for (int e = threadIdx.x; e < (1 << kLoBits); e += blockDim.x) {
    long long o = 0;
    for (int i = 0; i < kLoBits && i < t; ++i)
      if ((e >> i) & 1) o |= 1LL << pos[i];
    lo[e] = o;
  }
  for (int e = threadIdx.x; e < hi_entries(t); e += blockDim.x) {
    long long o = 0;
    for (int i = kLoBits; i < t; ++i)
      if ((e >> (i - kLoBits)) & 1) o |= 1LL << pos[i];
    hi[e] = o;
  }
}

__device__ __forceinline__ long long offset(const long long* lo, const long long* hi, int j) {
  return lo[j & ((1 << kLoBits) - 1)] + hi[j >> kLoBits];
}

// Whole-tile copies between the state and shared memory. Each thread keeps
// kInFlight loads outstanding, so a block with few warps still covers the
// memory latency.
constexpr int kInFlight = 8;

__device__ __forceinline__ void load(float2* dst, const float2* __restrict__ state, long long base,
                                     const long long* lo, const long long* hi, int t) {
  const int n = 1 << t;
  for (int j0 = threadIdx.x; j0 < n; j0 += kInFlight * blockDim.x) {
    float2 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n) v[u] = state[base + offset(lo, hi, j)];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n) dst[j] = v[u];
    }
  }
}

__device__ __forceinline__ void store(float2* __restrict__ state, const float2* src, long long base,
                                      const long long* lo, const long long* hi, int t) {
  const int n = 1 << t;
  for (int j0 = threadIdx.x; j0 < n; j0 += kInFlight * blockDim.x) {
    float2 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n) v[u] = src[j];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n) state[base + offset(lo, hi, j)] = v[u];
    }
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc += a * b in fp32 FMAs (no tensor cores, no TF32).
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

}  // namespace tile
