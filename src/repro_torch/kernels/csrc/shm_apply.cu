// shm_apply: apply one shared-memory group (a list of small gates whose
// bits all lie in a window of at most 13 local index bits) to a complex64
// state vector in place, with one read and one write of the state.
//
// Replaces the TPU kernel src/repro/kernels/shm.py::shm_apply (body built by
// make_shm_kernel / _apply_gate_in_block) together with the window
// transposes of its wrapper src/repro/kernels/ops.py::apply_shm_group.
//
// What bounds it on an H100 SXM: one read and one write of a 2^30-amplitude
// complex64 state is 17.2 GB, about 5.1 ms at 3.35 TB/s. Each member then
// costs 8 * 2^kg fp32 operations per amplitude for a kg-bit matrix (6 for a
// diagonal); a group of ~26 one- and two-bit members is ~3e11 operations,
// ~5 ms at 67 TFLOP/s fp32. So groups are near the balance point: memory
// for short groups, arithmetic for long ones.
//
// Design:
// * one block per tile: the window bits plus, where the window leaves them
//   out, the lowest local bits (so the tile is read and written in runs of
//   whole 32-byte sectors where it can be), gathered into dynamic shared
//   memory by bit insertion (tile.cuh) — arbitrary window bits need no
//   transpose; at 13 window bits plus one the tile is 128 KiB;
// * the members run one after another on the tile in shared memory, with
//   __syncthreads() between them, and the tile is written back once;
// * the gate structure is a small device descriptor table (kind, kg, the
//   tile bits of the operand's index bits, operand pointer, variant
//   stride, per-shard variant-index pointer), so one compiled kernel
//   serves every group of every circuit and nothing is compiled per
//   circuit; operands are runtime inputs with a leading variant axis;
// * a matrix member (and a diagonal of up to 256 entries) is staged in
//   shared memory; for a matrix each thread takes whole sub-groups of 2^kg
//   amplitudes into registers, so the update is in place; a diagonal is one
//   complex multiply per amplitude, its operand index read from two small
//   tables built per member;
// * every thread keeps 8 tile loads in flight (tile.cuh).

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxMatBits = 4;
constexpr int kStagedOperand = 1 << (2 * kMaxMatBits);  // complex entries staged in shared memory
// descriptor words per member: [0] kind (0 matrix, 1 diagonal), [1] kg,
// [2 + j] tile bit of operand index bit j (j < 16), [18] operand pointer,
// [19] complex elements per variant, [20] int32 variant-index pointer
constexpr int kDescWords = 24;

struct ShmArgs {
  int L;
  int t;
  int n_members;
  int pos[tile::kMaxBits];
};

__device__ __forceinline__ const float2* operand(const long long* d, long long shard) {
  const int* vidx = reinterpret_cast<const int*>(d[20]);
  return reinterpret_cast<const float2*>(d[18]) + (long long)vidx[shard] * d[19];
}

__device__ __forceinline__ int operand_entries(const long long* d) {
  return d[0] == 0 ? 1 << (2 * d[1]) : 1 << d[1];
}

// A kg-bit matrix member on the tile: each thread takes whole sub-groups of
// 2^kg amplitudes into registers, so the update is in place. `bits` are the
// member's descriptor words (tile bit of operand index bit j).
template <int KG>
__device__ void apply_mat(float2* buf, int t, const long long* bits, const float2* mat) {
  constexpr int D = 1 << KG;
  int sb[KG];
  int offs[D];
#pragma unroll
  for (int j = 0; j < KG; ++j) sb[j] = int(bits[j]);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    int o = 0;
#pragma unroll
    for (int j = 0; j < KG; ++j)
      if ((c >> j) & 1) o |= 1 << sb[j];
    offs[c] = o;
  }
#pragma unroll
  for (int i = 1; i < KG; ++i)  // ascending, for zero-bit insertion
#pragma unroll
    for (int j = KG - 1; j >= i; --j)
      if (sb[j - 1] > sb[j]) {
        const int x = sb[j];
        sb[j] = sb[j - 1];
        sb[j - 1] = x;
      }
  const int n_sub = 1 << (t - KG);
  for (int s = threadIdx.x; s < n_sub; s += blockDim.x) {
    int b = s;
#pragma unroll
    for (int j = 0; j < KG; ++j) b = ((b >> sb[j]) << (sb[j] + 1)) | (b & ((1 << sb[j]) - 1));
    float2 x[D];
#pragma unroll
    for (int c = 0; c < D; ++c) x[c] = buf[b + offs[c]];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < D; ++c) tile::cfma(acc, mat[r * D + c], x[c]);
      buf[b + offs[r]] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
shm_apply_kernel(float2* __restrict__ state, const long long* __restrict__ desc, const ShmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);                // the tile, 2^t amplitudes
  float2* opbuf = buf + (1 << a.t);                              // one staged operand
  long long* lo = reinterpret_cast<long long*>(opbuf + kStagedOperand);
  long long* hi = lo + (1 << tile::kLoBits);
  int* elo = reinterpret_cast<int*>(hi + tile::hi_entries(a.t));  // diagonal index tables
  int* ehi = elo + (1 << tile::kLoBits);

  const long long base = tile::insert_zero_bits(blockIdx.x, a.pos, a.t);
  const long long shard = base >> a.L;
  tile::build_tables(lo, hi, a.pos, a.t);
  __syncthreads();
  tile::load(buf, state, base, lo, hi, a.t);

  for (int mi = 0; mi < a.n_members; ++mi) {
    const long long* d = desc + (long long)mi * kDescWords;
    const int kind = int(d[0]);
    const int kg = int(d[1]);
    const float2* op = operand(d, shard);
    const bool staged = operand_entries(d) <= kStagedOperand;
    if (staged)
      for (int e = threadIdx.x; e < operand_entries(d); e += blockDim.x) opbuf[e] = op[e];
    if (kind != 0) {  // diagonal: operand index of tile element j = elo[j & 127] | ehi[j >> 7]
      for (int e = threadIdx.x; e < (1 << tile::kLoBits); e += blockDim.x) {
        int x = 0;
        for (int b = 0; b < kg; ++b) {
          const int p = int(d[2 + b]);
          if (p < tile::kLoBits) x |= ((e >> p) & 1) << b;
        }
        elo[e] = x;
      }
      for (int e = threadIdx.x; e < tile::hi_entries(a.t); e += blockDim.x) {
        int x = 0;
        for (int b = 0; b < kg; ++b) {
          const int p = int(d[2 + b]);
          if (p >= tile::kLoBits) x |= ((e >> (p - tile::kLoBits)) & 1) << b;
        }
        ehi[e] = x;
      }
    }
    __syncthreads();  // the tile, the staged operand and the tables are ready
    if (kind == 0) {
      switch (kg) {
        case 1: apply_mat<1>(buf, a.t, d + 2, opbuf); break;
        case 2: apply_mat<2>(buf, a.t, d + 2, opbuf); break;
        case 3: apply_mat<3>(buf, a.t, d + 2, opbuf); break;
        default: apply_mat<4>(buf, a.t, d + 2, opbuf); break;
      }
    } else {
      const float2* w = staged ? opbuf : op;
      for (int j = threadIdx.x; j < (1 << a.t); j += blockDim.x) {
        const int e = elo[j & ((1 << tile::kLoBits) - 1)] | ehi[j >> tile::kLoBits];
        buf[j] = tile::cmul(buf[j], w[e]);
      }
    }
    __syncthreads();  // the next member restages the operand and reads the tile
  }
  tile::store(state, buf, base, lo, hi, a.t);
}

}  // namespace

extern "C" {

// state: complex64 [S * 2^L]; desc: device int64 [n_members, 24] (see
// kDescWords); pos: host array of the t tile bits, ascending. One block per
// tile, n_tiles = 2^(n - t). Returns a cudaError_t.
int shm_apply(void* state, const void* desc, long long n_tiles, int L, int t, int n_members,
              const int* pos, void* stream) {
  if (t < 1 || t > 14 || n_members < 1 || n_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ShmArgs a{};
  a.L = L;
  a.t = t;
  a.n_members = n_members;
  for (int i = 0; i < t; ++i) a.pos[i] = pos[i];
  const size_t smem = sizeof(float2) * ((size_t(1) << t) + kStagedOperand) +
                      sizeof(long long) * ((1 << tile::kLoBits) + tile::hi_entries(t)) +
                      sizeof(int) * ((1 << tile::kLoBits) + tile::hi_entries(t));
  cudaError_t e = cudaFuncSetAttribute(shm_apply_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  shm_apply_kernel<<<unsigned(n_tiles), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(state), static_cast<const long long*>(desc), a);
  return cudaGetLastError();
}

int shm_max_matrix_bits() { return kMaxMatBits; }

const char* shm_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
