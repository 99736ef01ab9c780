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
// multiply-adds, 8 * 2^7 = 1024 real operations, against 16 bytes of state
// traffic (one read, one write). On the tensor cores with the 3xTF32 split
// (three TF32 products per real product) that is 3 * 1024 operations per
// amplitude: 3.3e12 for a 2^30-amplitude state, about 6.7 ms at the data
// sheet's 495 TFLOP/s of dense TF32, against 17.2 GB, about 5.1 ms at
// 3.35 TB/s. (On CUDA cores in fp32 the same product is 1.1e12 operations,
// about 16 ms at 67 TFLOP/s.) The Karatsuba form below does 3/4 of those
// products, 2.5e12 operations or ~5.0 ms: then the 5.1 ms of bytes bound it.
//
// Design:
// * the product runs on the tensor cores, mma.sync.m16n8k8 with TF32
//   operands and fp32 accumulation, in the three-product (Karatsuba) form
//   of _kernel3: P1 = Re U Re s, P2 = Im U Im s, P3 = (Re U + Im U)(Re s +
//   Im s), out = (P1 - P2, P3 - P1 - P2), as out^T = U s^T with m16 tiles
//   of 16 rows of U, k8 steps of 8 columns and n8 tiles of 8 groups. One
//   8-byte shared-memory load of an interleaved complex entry gives a
//   fragment register of all three A (or B) operands;
// * 3xTF32: each fp32 operand x splits in registers into big = tf32(x) and
//   small = tf32(x - big) (integer masks, see split); each real product
//   takes small*big + big*small + big*big with fp32 accumulation, which
//   keeps ~fp32 accuracy where a single TF32 pass keeps ~3 digits. U stays
//   fp32 complex in shared memory;
// * no transposes: tiles of groups are gathered by bit insertion
//   (tile.cuh) straight into the operand layout, [group][column] with the
//   column contiguous and rows padded by 4 entries (bank-conflict free
//   fragment loads), by 8-byte cp.async copies;
// * persistent blocks walk contiguous runs of tiles with two tile buffers:
//   the next tile's cp.async copies fly while the current tile's MMAs run
//   and its results go back (through the tile buffer, so the stores walk
//   the state in address order);
// * below k = 4 the unitary is embedded as I (x) U on 4 matrix bits (the
//   extra bits are the lowest other local bits), so every k fills m16 tiles;
// * U is reloaded only when the shard's variant changes; blocks walk
//   contiguous runs of tiles, so that happens about once per shard.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileAmps = 1 << 12;  // amplitudes per tile (fewer when a shard is smaller)
constexpr int kPad = 4;             // complex entries of padding per row of U and of the tile
constexpr int kMinMatBits = 4;      // smaller unitaries are embedded as I (x) U

struct FusedArgs {
  long long n_tiles;         // S * 2^(L - t) for S shards
  int L;                     // local bits: shard of an index = index >> L
  int t;                     // tile bits
  int k;                     // target bits of U
  int pos[tile::kMaxBits];   // state bit of each tile bit, ascending
  int sw[tile::kMaxBits];    // offset in a tile buffer (complex entries) of each tile bit
};

// Warp tiling of one tile: KE x KE (complex) times KE x NG.
template <int KE>
struct Shape {
  static constexpr int ROW = KE + kPad;                      // row stride, complex entries
  static constexpr int NG = kTileAmps / (KE > 32 ? KE : 32);  // groups per tile
  static constexpr int MT = KE / 16;                         // m16 tiles of 16 complex rows
  static constexpr int WM = MT < 2 ? MT : 2;                 // m16 tiles per warp
  static constexpr int WARPS_M = MT / WM;
  static constexpr int WARPS_N = kThreads / 32 / WARPS_M;
  static constexpr int WN = NG / (8 * WARPS_N);              // n8 tiles per warp
  static_assert(WM * WARPS_M == MT && WN * 8 * WARPS_N == NG && WN >= 1, "tiling");
};

template <int KE>
size_t smem_bytes(int t) {
  using S = Shape<KE>;
  return sizeof(float2) * (size_t(KE) * S::ROW + 2 * size_t(S::NG) * S::ROW) +
         (sizeof(long long) + sizeof(int)) * ((1 << tile::kLoBits) + tile::hi_entries(t));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = big + small to ~2^-21 relative, both TF32 values (the low 13 bits of
// the fp32 pattern zero). big rounds to nearest (ties away from zero, as
// cvt.rna.tf32.f32 does), so |x - big| <= 2^-11 |x|, and x - big is exact in
// fp32; small truncates it. Integer and fp32 ALU operations only: no cvt.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// d += a * b, one m16n8k8 TF32 tensor-core product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Below k = 4 every KE x KE matrix is I (x) U: only the diagonal blocks.
template <int KE>
__device__ void load_u(float2* ut, const float2* __restrict__ uv, int k) {
  const int K = 1 << k;
  for (int e = threadIdx.x; e < KE * KE; e += kThreads) {
    const int r = e / KE, c = e % KE;
    ut[r * Shape<KE>::ROW + c] =
        (r >> k) == (c >> k) ? uv[(r & (K - 1)) * K + (c & (K - 1))] : make_float2(0.f, 0.f);
  }
}

template <int KE>
__global__ void __launch_bounds__(kThreads, KE < 128 ? 2 : 1)
fused_apply_kernel(float2* __restrict__ state, const float2* __restrict__ u,
                   const int* __restrict__ vidx, const FusedArgs a) {
  using S = Shape<KE>;
  constexpr int ROW = S::ROW;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* ut = reinterpret_cast<float2*>(smem);  // ut[r * ROW + c] = U[r][c]
  float2* tiles = ut + KE * ROW;                  // two buffers of NG * ROW: [group][column]
  long long* glo = reinterpret_cast<long long*>(tiles + 2 * S::NG * ROW);
  long long* ghi = glo + (1 << tile::kLoBits);
  int* slo = reinterpret_cast<int*>(ghi + tile::hi_entries(a.t));
  int* shi = slo + (1 << tile::kLoBits);

  const int tid = threadIdx.x;
  tile::build_tables(glo, ghi, a.pos, a.t);  // state offset of tile element j
  for (int e = tid; e < (1 << tile::kLoBits); e += kThreads) {  // buffer offset of j
    int o = 0;
    for (int i = 0; i < tile::kLoBits && i < a.t; ++i)
      if ((e >> i) & 1) o += a.sw[i];
    slo[e] = o;
  }
  for (int e = tid; e < tile::hi_entries(a.t); e += kThreads) {
    int o = 0;
    for (int i = tile::kLoBits; i < a.t; ++i)
      if ((e >> (i - tile::kLoBits)) & 1) o += a.sw[i];
    shi[e] = o;
  }
  __syncthreads();

  const int n = 1 << a.t;
  const long long per = (a.n_tiles + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per;
  const long long last = min(a.n_tiles, first + per);
  // a thread always copies the tile elements j = tid + 256 u: their low 7
  // bits, and so the low halves of both offsets, are fixed
  const long long g_lo = glo[tid & 127];
  const int s_lo = slo[tid & 127];
  if (first < last) {
    const long long base = tile::insert_zero_bits(first, a.pos, a.t) + g_lo;
    for (int j = tid; j < n; j += kThreads)
      cp_async8(tiles + s_lo + shi[j >> 7], state + base + ghi[j >> 7]);
  }
  cp_async_commit();

  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wm = warp % S::WARPS_M, wn = warp / S::WARPS_M;
  const int r_base = wm * S::WM * 16 + gid;  // row of fragment row gid, m16 tile 0
  const int g_base = wn * S::WN * 8;         // first group of this warp's n8 tiles
  int cur = -1;
  for (long long id = first; id < last; ++id) {
    float2* buf = tiles + (int(id - first) & 1) * S::NG * ROW;
    float2* nxt = tiles + (int(id - first + 1) & 1) * S::NG * ROW;
    cp_async_wait_all();  // this tile's copies (the only group in flight) have landed
    __syncthreads();      // ... for every thread; the last tile's stores have read nxt
    if (id + 1 < last) {
      const long long nb = tile::insert_zero_bits(id + 1, a.pos, a.t) + g_lo;
      for (int j = tid; j < n; j += kThreads)
        cp_async8(nxt + s_lo + shi[j >> 7], state + nb + ghi[j >> 7]);
    }
    cp_async_commit();
    const long long base = tile::insert_zero_bits(id, a.pos, a.t);
    const int v = vidx[base >> a.L];
    if (v != cur) {  // uniform across the block; no warp reads ut here
      load_u<KE>(ut, u + (long long)v * (1 << a.k) * (1 << a.k), a.k);
      cur = v;
      __syncthreads();
    }

    // p[i][j][0..2]: P1, P2, P3 of m16 tile i, n8 tile j (4 registers each)
    float p[S::WM][S::WN][3][4];
#pragma unroll
    for (int i = 0; i < S::WM; ++i)
#pragma unroll
      for (int j = 0; j < S::WN; ++j)
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) p[i][j][m][q] = 0.f;
    const float2* arow = ut + r_base * ROW + tig;
    const float2* brow = buf + (g_base + gid) * ROW + tig;
#pragma unroll 2
    for (int c0 = 0; c0 < KE; c0 += 8) {
      // B: b0 = s[g][c0 + tig], b1 = s[g][c0 + tig + 4] of group g = gid
      uint32_t bb[S::WN][3][2], bs[S::WN][3][2];
#pragma unroll
      for (int j = 0; j < S::WN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 y = brow[j * 8 * ROW + c0 + 4 * h];
          split(y.x, bb[j][0][h], bs[j][0][h]);
          split(y.y, bb[j][1][h], bs[j][1][h]);
          split(y.x + y.y, bb[j][2][h], bs[j][2][h]);
        }
      // A: a0 = U[r][c], a1 = U[r + 8][c], a2 = U[r][c + 4], a3 = U[r + 8][c + 4]
      uint32_t ab[S::WM][3][4], as[S::WM][3][4];
#pragma unroll
      for (int i = 0; i < S::WM; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = arow[(i * 16 + (e & 1) * 8) * ROW + c0 + (e >> 1) * 4];
          split(x.x, ab[i][0][e], as[i][0][e]);
          split(x.y, ab[i][1][e], as[i][1][e]);
          split(x.x + x.y, ab[i][2][e], as[i][2][e]);
        }
      // the WM * WN * 3 accumulators are independent: each pass over them
      // puts that many products between two that depend; big*big last
#pragma unroll
      for (int i = 0; i < S::WM; ++i)
#pragma unroll
        for (int j = 0; j < S::WN; ++j)
#pragma unroll
          for (int m = 0; m < 3; ++m) mma_tf32(p[i][j][m], as[i][m], bb[j][m]);
#pragma unroll
      for (int i = 0; i < S::WM; ++i)
#pragma unroll
        for (int j = 0; j < S::WN; ++j)
#pragma unroll
          for (int m = 0; m < 3; ++m) mma_tf32(p[i][j][m], ab[i][m], bs[j][m]);
#pragma unroll
      for (int i = 0; i < S::WM; ++i)
#pragma unroll
        for (int j = 0; j < S::WN; ++j)
#pragma unroll
          for (int m = 0; m < 3; ++m) mma_tf32(p[i][j][m], ab[i][m], bb[j][m]);
    }
    __syncthreads();  // every warp has read the tile: overwrite it in place
    // D: q = 0, 1 -> row r, groups g, g + 1; q = 2, 3 -> row r + 8
#pragma unroll
    for (int i = 0; i < S::WM; ++i)
#pragma unroll
      for (int j = 0; j < S::WN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r_base + i * 16 + (q >> 1) * 8;
          const int g = g_base + j * 8 + 2 * tig + (q & 1);
          const float p1 = p[i][j][0][q], p2 = p[i][j][1][q], p3 = p[i][j][2][q];
          buf[g * ROW + r] = make_float2(p1 - p2, p3 - p1 - p2);
        }
    __syncthreads();
#pragma unroll 4
    for (int j = tid; j < n; j += kThreads)
      state[base + g_lo + ghi[j >> 7]] = buf[s_lo + shi[j >> 7]];
  }
}

template <int KE>
int launch(float2* state, const float2* u, const int* vidx, FusedArgs& a, const int* tb, int ke,
           const int* gb, int nb, cudaStream_t stream) {
  using S = Shape<KE>;
  if ((1 << nb) > S::NG || a.t > 12 || ke + nb != a.t) return cudaErrorInvalidValue;
  for (int i = 0; i < a.t; ++i) a.sw[i] = -1;
  for (int m = 0; m < ke; ++m) a.sw[tb[m]] = 1 << m;
  for (int b = 0; b < nb; ++b) a.sw[gb[b]] = (1 << b) * S::ROW;
  for (int i = 0; i < a.t; ++i)
    if (a.sw[i] < 0) return cudaErrorInvalidValue;  // tb and gb must cover the tile bits
  const size_t smem = smem_bytes<KE>(a.t);
  cudaError_t e = cudaFuncSetAttribute(fused_apply_kernel<KE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_apply_kernel<KE>, kThreads,
                                                         smem)) != cudaSuccess)
    return e;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > a.n_tiles) grid = a.n_tiles;
  fused_apply_kernel<KE><<<unsigned(grid), kThreads, smem, stream>>>(state, u, vidx, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Groups of 2^max(k, 4) amplitudes one tile holds (the Python layout must agree).
int fused_groups_per_tile(int k) {
  return k >= 1 && k <= 7 ? kTileAmps >> (k > 5 ? k : 5) : 0;
}

// state: complex64 [S * 2^L]; u: complex64 [V, 2^k, 2^k]; vidx: int32 [S].
// pos: the t tile bits (ascending); tb: the tile bit of each of the
// ke = max(k, 4) matrix index bits (bits k.. index the identity of I (x) U);
// gb: the tile bits of the nb group bits. Host arrays. Returns a cudaError_t.
int fused_apply(void* state, const void* u, const void* vidx, long long n_tiles, int L, int t,
                int k, int ke, int nb, const int* pos, const int* tb, const int* gb, void* stream) {
  if (t > tile::kMaxBits || k < 1 || k > 7 || ke != (k < kMinMatBits ? kMinMatBits : k) ||
      nb < 0 || nb > tile::kMaxBits)
    return cudaErrorInvalidValue;
  FusedArgs a{};
  a.n_tiles = n_tiles;
  a.L = L;
  a.t = t;
  a.k = k;
  for (int i = 0; i < t; ++i) a.pos[i] = pos[i];
  float2* s = static_cast<float2*>(state);
  const float2* m = static_cast<const float2*>(u);
  const int* vi = static_cast<const int*>(vidx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ke) {
    case 4: return launch<16>(s, m, vi, a, tb, ke, gb, nb, st);
    case 5: return launch<32>(s, m, vi, a, tb, ke, gb, nb, st);
    case 6: return launch<64>(s, m, vi, a, tb, ke, gb, nb, st);
    default: return launch<128>(s, m, vi, a, tb, ke, gb, nb, st);
  }
}

const char* fused_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
