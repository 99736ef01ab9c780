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
// diagonal); a group of ~30 one-bit members is ~5e11 operations, ~8 ms at
// 67 TFLOP/s fp32. So long groups are bound by fp32 arithmetic and the
// kernel's own overheads (barriers, shared-memory traffic, addressing) are
// what it has to keep small.
//
// Design:
// * one block of 2^(t-5) threads per tile of 2^t amplitudes (t <= 13: the
//   window bits plus the lowest other local bits); each thread holds 32
//   amplitudes of the tile in registers, on 5 "register bits" of the tile;
// * the host (kernels/ops.py: shm_schedule) turns the member list into a
//   program of steps. A phase is a set of register bits plus the members
//   that act inside it (members that commute - disjoint bits, or both
//   diagonal - may be reordered so that phases fill and the first and
//   last phases are the I/O layout): one- and two-bit matrices are applied
//   from registers, their entries held in registers, with no barrier and no
//   shared-memory traffic; diagonals in any phase (elementwise: the operand
//   index is the register index plus the thread's fixed bits, read through
//   L1). Between phases the amplitudes are exchanged through a tile buffer
//   in shared memory: every thread writes its amplitudes, one barrier,
//   every thread reads those of the next phase. (A thread's next write goes
//   to exactly the slots it read last, so no barrier is needed before it.)
//   The buffer's XOR swizzle and the choice of lane bits make both sides of
//   an exchange free of bank conflicts where the register bits allow;
// * 3- and 4-bit matrices are applied to the tile while it lies in shared
//   memory between the two halves of an exchange, the operand staged in
//   shared memory, as whole sub-groups per thread;
// * the tile is read from the state straight into registers and written
//   back from them, in the I/O layout whose thread bits are the tile's
//   lowest bits (address order); a thread keeps its 32 loads in flight;
// * 256 threads and one 64 KiB tile buffer a block, registers capped at 128
//   a thread: two blocks share an SM, so one block's copies overlap the
//   other's member work;
// * the step table (kind, packed bit fields, operand and variant-index
//   pointers) is copied to shared memory per block, kChunkSteps steps at a
//   time, with each operand pointer resolved for the tile's shard: one
//   compiled kernel serves every group of every circuit, nothing is
//   compiled per circuit, and a program of any length runs in a block's
//   fixed share of shared memory (a chunk is 12 KiB; the next one is
//   staged between two barriers, which a program of kChunkSteps steps or
//   fewer never meets).

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kRegBits = 5;                  // amplitudes a thread holds: 2^5
constexpr int kRegs = 1 << kRegBits;
constexpr int kMaxTileBits = 13;
constexpr int kMaxThreads = 1 << (kMaxTileBits - kRegBits);
constexpr int kMaxMatBits = 4;
constexpr int kStagedOperand = 1 << (2 * kMaxMatBits);  // complex entries of a 4-bit matrix
constexpr int kChunkSteps = 128;  // steps of the table in shared memory at a time
// A step is one row of kDescWords int64: [0] kind, [1] operand bits,
// [2..5] sixteen 16-bit fields (field f: bits 16 (f % 4) of word 2 + f / 4),
// [6] operand pointer, [7] complex entries per variant, [8] int32
// variant-index pointer. Fields by kind:
//   kMat1, kMat2: the register bit of each operand index bit;
//   kDiag: for each layout bit k (k < 5: register bit, else thread bit
//          k - 5), its weight in the diagonal's index (0 if not an operand bit);
//   kWrite, kRead: the layout, the tile bit of each layout bit;
//   kSmemMat: the tile bit of each operand index bit.
constexpr int kDescWords = 12;
enum Kind { kMat1 = 0, kMat2 = 1, kDiag = 2, kWrite = 3, kSmemMat = 4, kRead = 5 };

struct ShmArgs {
  int L;
  int t;
  int n_steps;
  int pos[tile::kMaxBits];
};

__device__ __forceinline__ int field(const long long* d, int f) {
  return int((static_cast<unsigned long long>(d[2 + (f >> 2)]) >> (16 * (f & 3))) & 0xffff);
}

// Shared-memory slot of tile element j: the low 4 bits (16 slots of 8
// bytes = all 32 banks) take the XOR of bits 0-3, 4-7 and 8-11, so any four
// lane bits below 12 with distinct residues mod 4 reach 16 distinct slots.
__device__ __forceinline__ int swz(int j) { return j ^ (((j >> 4) ^ (j >> 8)) & 15); }

// Bit of a register index that changes from Gray code g - 1 to g.
__host__ __device__ constexpr int gray_flip(int g) {
  int n = 0;
  while (!((g >> n) & 1)) ++n;
  return n;
}

// Steps [s0, s0 + m) of the table into sd, m = min(kChunkSteps, n_steps -
// s0), one row per thread in turn; resolve_steps then points each operand
// at the shard's variant. A thread resolves the rows it copied, so no
// barrier is needed between the two.
__device__ __forceinline__ void copy_steps(long long* sd, const long long* __restrict__ desc,
                                           int s0, int m) {
  for (int s = threadIdx.x; s < m; s += blockDim.x)
#pragma unroll
    for (int w = 0; w < kDescWords; ++w)
      sd[s * kDescWords + w] = desc[(long long)(s0 + s) * kDescWords + w];
}

__device__ __forceinline__ void resolve_steps(long long* sd, int m, long long shard) {
  for (int s = threadIdx.x; s < m; s += blockDim.x) {
    long long* d = sd + s * kDescWords;
    if (d[0] != kWrite && d[0] != kRead) {
      const int* vidx = reinterpret_cast<const int*>(d[8]);
      d[6] = reinterpret_cast<long long>(reinterpret_cast<const float2*>(d[6]) +
                                         (long long)vidx[shard] * d[7]);
    }
  }
}

// Tile offset of the thread's fixed bits in layout d (layout bits 5..t-1).
__device__ __forceinline__ int thread_part(const long long* d, int t, int weighted) {
  int o = 0;
  for (int b = 0; b < t - kRegBits; ++b)
    if ((threadIdx.x >> b) & 1) o += weighted ? field(d, kRegBits + b) : 1 << field(d, kRegBits + b);
  return o;
}

// Registers -> tile buffer (layout d), or back. The slot of (thread,
// register i) is swz(thread part | register part), and swz is linear over
// GF(2): walking i in Gray-code order, each slot is the last one XOR the
// swizzled offset of the one register bit that changed.
template <bool kToShared>
__device__ __forceinline__ void exchange(float2 (&x)[kRegs], float2* buf, const long long* d, int t) {
  int s[kRegBits];
#pragma unroll
  for (int q = 0; q < kRegBits; ++q) s[q] = swz(1 << field(d, q));
  int slot = swz(thread_part(d, t, 0));
#pragma unroll
  for (int g = 0; g < kRegs; ++g) {
    if (g > 0) slot ^= s[gray_flip(g)];
    const int i = g ^ (g >> 1);
    if (kToShared)
      buf[slot] = x[i];
    else
      x[i] = buf[slot];
  }
}

template <int Q>
__device__ __forceinline__ void mat1(float2 (&x)[kRegs], const float2* __restrict__ m) {
  const float2 m00 = m[0], m01 = m[1], m10 = m[2], m11 = m[3];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    if ((i >> Q) & 1) continue;
    const float2 a = x[i], b = x[i | (1 << Q)];
    float2 o0 = make_float2(0.f, 0.f), o1 = make_float2(0.f, 0.f);
    tile::cfma(o0, m00, a);
    tile::cfma(o0, m01, b);
    tile::cfma(o1, m10, a);
    tile::cfma(o1, m11, b);
    x[i] = o0;
    x[i | (1 << Q)] = o1;
  }
}

// A two-bit matrix on register bits P < Q; `swap`: operand index bit 0 sits
// on Q (so the entries are read with their two index bits exchanged).
template <int P, int Q>
__device__ __forceinline__ void mat2(float2 (&x)[kRegs], const float2* __restrict__ m, bool swap) {
  float2 mm[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int rs = swap ? ((r & 1) << 1) | (r >> 1) : r;
      const int cs = swap ? ((c & 1) << 1) | (c >> 1) : c;
      mm[r][c] = m[rs * 4 + cs];
    }
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    if (((i >> P) & 1) || ((i >> Q) & 1)) continue;
    const int o[4] = {i, i | (1 << P), i | (1 << Q), i | (1 << P) | (1 << Q)};
    float2 a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = x[o[c]];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 4; ++c) tile::cfma(acc, mm[r][c], a[c]);
      x[o[r]] = acc;
    }
  }
}

__device__ __forceinline__ void apply_mat2(float2 (&x)[kRegs], const float2* m, int q0, int q1) {
  const bool swap = q0 > q1;
  switch (swap ? q1 * kRegBits + q0 : q0 * kRegBits + q1) {
    case 0 * kRegBits + 1: mat2<0, 1>(x, m, swap); break;
    case 0 * kRegBits + 2: mat2<0, 2>(x, m, swap); break;
    case 0 * kRegBits + 3: mat2<0, 3>(x, m, swap); break;
    case 0 * kRegBits + 4: mat2<0, 4>(x, m, swap); break;
    case 1 * kRegBits + 2: mat2<1, 2>(x, m, swap); break;
    case 1 * kRegBits + 3: mat2<1, 3>(x, m, swap); break;
    case 1 * kRegBits + 4: mat2<1, 4>(x, m, swap); break;
    case 2 * kRegBits + 3: mat2<2, 3>(x, m, swap); break;
    case 2 * kRegBits + 4: mat2<2, 4>(x, m, swap); break;
    default: mat2<3, 4>(x, m, swap); break;
  }
}

__device__ __forceinline__ void diag(float2 (&x)[kRegs], const float2* __restrict__ w,
                                     const long long* d, int t) {
  int wr[kRegBits];  // distinct powers of two or 0: XOR adds them
#pragma unroll
  for (int q = 0; q < kRegBits; ++q) wr[q] = field(d, q);
  int e = thread_part(d, t, 1);
#pragma unroll
  for (int g = 0; g < kRegs; ++g) {  // Gray-code order, as in exchange
    if (g > 0) e ^= wr[gray_flip(g)];
    const int i = g ^ (g >> 1);
    x[i] = tile::cmul(x[i], __ldg(w + e));
  }
}

// A kg-bit matrix (kg = 3, 4) on the tile in shared memory: each thread
// takes whole sub-groups of 2^kg amplitudes into registers.
template <int KG>
__device__ void smem_mat(float2* __restrict__ buf, int t, const long long* d,
                         const float2* __restrict__ mat) {
  constexpr int D = 1 << KG;
  int sb[KG];
  int offs[D];
#pragma unroll
  for (int j = 0; j < KG; ++j) sb[j] = field(d, j);
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
        const int s = sb[j];
        sb[j] = sb[j - 1];
        sb[j - 1] = s;
      }
  for (int s = threadIdx.x; s < (1 << (t - KG)); s += blockDim.x) {
    int b = s;
#pragma unroll
    for (int j = 0; j < KG; ++j) b = ((b >> sb[j]) << (sb[j] + 1)) | (b & ((1 << sb[j]) - 1));
    float2 v[D];
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = buf[swz(b + offs[c])];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int c = 0; c < D; ++c) tile::cfma(acc, mat[r * D + c], v[c]);
      buf[swz(b + offs[r])] = acc;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2)
shm_apply_kernel(float2* __restrict__ state, const long long* __restrict__ desc, const ShmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);        // the tile, 2^t amplitudes, swizzled
  float2* opbuf = buf + (1 << a.t);                      // a staged 3- or 4-bit matrix
  long long* goff = reinterpret_cast<long long*>(opbuf + kStagedOperand);  // state offset per register index
  long long* sd = goff + kRegs;                          // a chunk of the step table
  const int tid = threadIdx.x;
  const int t = a.t;

  const long long base = tile::insert_zero_bits(blockIdx.x, a.pos, t);
  const long long shard = base >> a.L;
  const int m0 = min(a.n_steps, kChunkSteps);
  copy_steps(sd, desc, 0, m0);
  for (int i = tid; i < kRegs; i += blockDim.x) {  // I/O layout: register bit q is tile bit t - 5 + q
    long long o = 0;
    for (int q = 0; q < kRegBits; ++q)
      if ((i >> q) & 1) o += 1LL << a.pos[t - kRegBits + q];
    goff[i] = o;
  }
  long long gt = base;  // thread bit b is tile bit b
  for (int b = 0; b < t - kRegBits; ++b)
    if ((tid >> b) & 1) gt += 1LL << a.pos[b];
  __syncthreads();
  float2 x[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) x[i] = state[gt + goff[i]];
  resolve_steps(sd, m0, shard);  // while the loads are in flight
  __syncthreads();

  for (int s = 0; s < a.n_steps; ++s) {
    const int c = s % kChunkSteps;
    if (c == 0 && s > 0) {  // the next chunk, once every thread is done with this one
      __syncthreads();
      const int m = min(a.n_steps - s, kChunkSteps);
      copy_steps(sd, desc, s, m);
      resolve_steps(sd, m, shard);
      __syncthreads();
    }
    const long long* d = sd + c * kDescWords;
    const float2* op = reinterpret_cast<const float2*>(d[6]);
    switch (int(d[0])) {
      case kMat1:
        switch (field(d, 0)) {
          case 0: mat1<0>(x, op); break;
          case 1: mat1<1>(x, op); break;
          case 2: mat1<2>(x, op); break;
          case 3: mat1<3>(x, op); break;
          default: mat1<4>(x, op); break;
        }
        break;
      case kMat2:
        apply_mat2(x, op, field(d, 0), field(d, 1));
        break;
      case kDiag:
        diag(x, op, d, t);
        break;
      case kWrite:
        exchange<true>(x, buf, d, t);
        __syncthreads();
        break;
      case kSmemMat: {
        const int kg = int(d[1]);
        for (int e = tid; e < (1 << (2 * kg)); e += blockDim.x) opbuf[e] = op[e];
        __syncthreads();
        if (kg == 3)
          smem_mat<3>(buf, t, d, opbuf);
        else
          smem_mat<4>(buf, t, d, opbuf);
        __syncthreads();
        break;
      }
      default:  // kRead
        exchange<false>(x, buf, d, t);
        break;
    }
  }
#pragma unroll
  for (int i = 0; i < kRegs; ++i) state[gt + goff[i]] = x[i];
}

}  // namespace

extern "C" {

// state: complex64 [S * 2^L]; desc: device int64 [n_steps, 12] (see
// kDescWords), the program ops.py::shm_schedule makes; pos: host array of
// the t tile bits, ascending. One block of 2^(t-5) threads per tile,
// n_tiles = S * 2^(L - t) for S shards. Returns a cudaError_t.
int shm_apply(void* state, const void* desc, long long n_tiles, int L, int t, int n_steps,
              const int* pos, void* stream) {
  if (t < kRegBits || t > kMaxTileBits || n_steps < 0 || n_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ShmArgs a{};
  a.L = L;
  a.t = t;
  a.n_steps = n_steps;
  for (int i = 0; i < t; ++i) a.pos[i] = pos[i];
  const size_t chunk = size_t(n_steps < kChunkSteps ? n_steps : kChunkSteps);
  const size_t smem = sizeof(float2) * ((size_t(1) << t) + kStagedOperand) +
                      sizeof(long long) * (kRegs + chunk * kDescWords);
  cudaError_t e = cudaFuncSetAttribute(shm_apply_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  shm_apply_kernel<<<unsigned(n_tiles), 1 << (t - kRegBits), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(state), static_cast<const long long*>(desc), a);
  return cudaGetLastError();
}

int shm_max_matrix_bits() { return kMaxMatBits; }

int shm_register_bits() { return kRegBits; }

int shm_table_chunk() { return kChunkSteps; }

const char* shm_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
