// fused_apply: apply a fused 2^k x 2^k unitary (k <= 7) to a complex64 state
// vector on the target index bits, in place, with one variant of the
// unitary per shard.
//
// Replaces the TPU kernel src/repro/kernels/fusion.py::fused_matmul (bodies
// _kernel4/_kernel3) together with the transposes of its wrapper
// src/repro/kernels/ops.py::apply_fused_shard: out[g, r] = sum_c U[r, c] *
// s[g, c] over every group g of 2^k amplitudes that differ only in the
// target bits.
//
// What bounds it on an H100 SXM: at k = 7 every amplitude costs 2^7 complex
// multiply-adds, 8 * 2^7 = 1024 fp32 operations, against 16 bytes of state
// traffic (one read, one write). For a 2^30-amplitude state that is 1.1e12
// operations, about 16 ms at the data sheet's 67 TFLOP/s of fp32 on CUDA
// cores, and 17.2 GB, about 5.1 ms at 3.35 TB/s. So at k = 7 the kernel is
// bound by fp32 arithmetic; below k ~ 5 it is bound by memory.
//
// Design:
// * no transposes: a block stages whole tiles of groups in shared memory by
//   bit insertion (tile.cuh); the tile's bits are the k target bits plus
//   the lowest non-target bits, so a tile is read and written in address
//   order, and it is updated in place (each tile belongs to one block);
// * the block keeps U transposed in dynamic shared memory (128 KiB at
//   K = 128, above the 48 KiB default, hence cudaFuncSetAttribute) and
//   reloads it only when the shard's variant changes; blocks walk
//   contiguous runs of tiles, so that happens about once per shard;
// * each thread accumulates a TG x TR register tile of outputs (8 groups x
//   4 rows), so each shared-memory load feeds several FMAs; accumulation is
//   plain fp32 FMA, four products per complex multiply-add (no tensor
//   cores, no TF32), so results match a float32 reference to ~1e-6.
// Tensor cores with an accurate split, and overlapping the tile copies with
// the arithmetic, are later work.

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;

struct FusedArgs {
  long long n_tiles;         // 2^(n - t)
  int L;                     // local bits: shard of an index = index >> L
  int t;                     // tile bits
  int k;                     // target bits
  int nb;                    // group bits inside a tile (t - k)
  int pos[tile::kMaxBits];   // state bit of each tile bit, ascending
  int tb[8];                 // tile bit of matrix index bit j
  int gb[tile::kMaxBits];    // tile bit of group bit i
};

template <int K>
struct Shape {
  static constexpr int TR = K < 4 ? K : 4;     // rows per thread
  static constexpr int RT = K / TR;            // threads along rows
  static constexpr int GT = kThreads / RT;     // threads along groups
  static constexpr int TG = 8;                 // groups per thread
  static constexpr int NG = GT * TG;           // groups per tile
};

template <int K>
size_t smem_bytes(int t) {
  return sizeof(float2) * (size_t(K) * (K + 1) + (size_t(1) << t)) +
         sizeof(long long) * ((1 << tile::kLoBits) + tile::hi_entries(t)) +
         sizeof(int) * (K + Shape<K>::NG);
}

// Below K = 128 the tile and U fit twice in shared memory; capping registers
// at 128 a thread lets two blocks share an SM.
template <int K>
__global__ void __launch_bounds__(kThreads, K < 128 ? 2 : 1)
fused_apply_kernel(float2* __restrict__ state, const float2* __restrict__ u,
                   const int* __restrict__ vidx, const FusedArgs a) {
  using S = Shape<K>;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* ut = reinterpret_cast<float2*>(smem);  // ut[c * (K + 1) + r] = U[r, c]
  float2* buf = ut + K * (K + 1);                 // the tile, 2^t amplitudes
  long long* lo = reinterpret_cast<long long*>(buf + (1 << a.t));
  long long* hi = lo + (1 << tile::kLoBits);
  int* jc = reinterpret_cast<int*>(hi + tile::hi_entries(a.t));  // tile index of column c
  int* jg = jc + K;                                               // tile index of group g

  const int tid = threadIdx.x;
  tile::build_tables(lo, hi, a.pos, a.t);
  for (int c = tid; c < K; c += kThreads) {
    int j = 0;
    for (int b = 0; b < a.k; ++b)
      if ((c >> b) & 1) j |= 1 << a.tb[b];
    jc[c] = j;
  }
  for (int g = tid; g < S::NG; g += kThreads) {
    int j = 0;
    for (int b = 0; b < a.nb; ++b)
      if ((g >> b) & 1) j |= 1 << a.gb[b];
    jg[g] = j;
  }
  __syncthreads();

  const int tr = tid % S::RT;
  const int tg = tid / S::RT;
  const int n_groups = 1 << a.nb;
  int jgm[S::TG];
  bool live[S::TG];
#pragma unroll
  for (int m = 0; m < S::TG; ++m) {
    const int g = tg + m * S::GT;
    live[m] = g < n_groups;
    jgm[m] = live[m] ? jg[g] : 0;  // dead slots compute on group 0, never stored
  }

  const long long per = (a.n_tiles + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per;
  const long long last = min(a.n_tiles, first + per);
  int cur = -1;
  for (long long id = first; id < last; ++id) {
    const long long base = tile::insert_zero_bits(id, a.pos, a.t);
    const int v = vidx[base >> a.L];
    if (v != cur) {  // uniform across the block
      const float2* uv = u + (long long)v * K * K;
      for (int e = tid; e < K * K; e += kThreads) ut[(e % K) * (K + 1) + e / K] = uv[e];
      cur = v;
    }
    tile::load(buf, state, base, lo, hi, a.t);
    __syncthreads();

    float2 acc[S::TG][S::TR];
#pragma unroll
    for (int m = 0; m < S::TG; ++m)
#pragma unroll
      for (int i = 0; i < S::TR; ++i) acc[m][i] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < K; ++c) {
      const int jcc = jc[c];
      float2 uu[S::TR];
#pragma unroll
      for (int i = 0; i < S::TR; ++i) uu[i] = ut[c * (K + 1) + tr + i * S::RT];
#pragma unroll
      for (int m = 0; m < S::TG; ++m) {
        const float2 s = buf[jgm[m] + jcc];
#pragma unroll
        for (int i = 0; i < S::TR; ++i) tile::cfma(acc[m][i], uu[i], s);
      }
    }
    __syncthreads();  // every read of the tile is done: overwrite in place
#pragma unroll
    for (int m = 0; m < S::TG; ++m)
      if (live[m])
#pragma unroll
        for (int i = 0; i < S::TR; ++i) buf[jgm[m] + jc[tr + i * S::RT]] = acc[m][i];
    __syncthreads();
    tile::store(state, buf, base, lo, hi, a.t);
    __syncthreads();  // the next tile (and U reload) overwrites shared memory
  }
}

template <int K>
int launch(float2* state, const float2* u, const int* vidx, const FusedArgs& a, cudaStream_t stream) {
  if ((1 << a.nb) > Shape<K>::NG || a.t > 14 || a.k + a.nb != a.t) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<K>(a.t);
  cudaError_t e = cudaFuncSetAttribute(fused_apply_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_apply_kernel<K>, kThreads,
                                                         smem)) != cudaSuccess)
    return e;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > a.n_tiles) grid = a.n_tiles;
  fused_apply_kernel<K><<<unsigned(grid), kThreads, smem, stream>>>(state, u, vidx, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Groups of 2^k amplitudes one tile holds (the Python layout must agree).
int fused_groups_per_tile(int k) {
  switch (k) {
    case 1: return Shape<2>::NG;
    case 2: return Shape<4>::NG;
    case 3: return Shape<8>::NG;
    case 4: return Shape<16>::NG;
    case 5: return Shape<32>::NG;
    case 6: return Shape<64>::NG;
    case 7: return Shape<128>::NG;
    default: return 0;
  }
}

// state: complex64 [S * 2^L]; u: complex64 [V, 2^k, 2^k]; vidx: int32 [S].
// pos/tb/gb are host arrays of t, k and nb entries. Returns a cudaError_t.
int fused_apply(void* state, const void* u, const void* vidx, long long n_tiles, int L, int t,
                int k, int nb, const int* pos, const int* tb, const int* gb, void* stream) {
  if (t > tile::kMaxBits || k < 1 || k > 7 || nb < 0 || nb > tile::kMaxBits)
    return cudaErrorInvalidValue;
  FusedArgs a{};
  a.n_tiles = n_tiles;
  a.L = L;
  a.t = t;
  a.k = k;
  a.nb = nb;
  for (int i = 0; i < t; ++i) a.pos[i] = pos[i];
  for (int i = 0; i < k; ++i) a.tb[i] = tb[i];
  for (int i = 0; i < nb; ++i) a.gb[i] = gb[i];
  float2* s = static_cast<float2*>(state);
  const float2* m = static_cast<const float2*>(u);
  const int* vi = static_cast<const int*>(vidx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<2>(s, m, vi, a, st);
    case 2: return launch<4>(s, m, vi, a, st);
    case 3: return launch<8>(s, m, vi, a, st);
    case 4: return launch<16>(s, m, vi, a, st);
    case 5: return launch<32>(s, m, vi, a, st);
    case 6: return launch<64>(s, m, vi, a, st);
    default: return launch<128>(s, m, vi, a, st);
  }
}

const char* fused_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
