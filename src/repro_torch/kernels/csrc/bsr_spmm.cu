// Block-sparse x dense multiply for Hopper (sm_90a), batched over tiles,
// over the real blocks alone, reading its operands where they lie.
//
//   C[t, r*bs : +bs, :] (+)= sum over the real blocks e of block-row r of
//                            output tile t of
//                            A_pool[slot(e)] @ B_pool[btile(t), col(e)*bs : +bs, :]
//
// Replaces the TPU kernel bsr_spmm_pallas (src/repro/kernels/bsr_spmm.py,
// body _spmm_kernel): the local multiply of every dense-output schedule,
// and steal3d's pair lists (ops.steal_pair_accumulate: one output tile a
// device, B the placed stack as one flat tile).
// The TPU kernel walks a tile's whole stored-block list as a sequential grid
// axis, capacity padding and coverage zeros included, and zeroes an output
// block on its first visit.  Hopper blocks run in no order, so the work is
// cut by block-row segment, and the list of what to multiply is a plan-time
// table (kernels/bsr_spmm.py::spmm_table, host numpy, built by the plan once
// per ring step):
//
// * Only real blocks are multiplied.  The table lists, per output tile, the
//   stored slots that hold data, by block-row: a tile's capacity padding
//   (its last (row, col) repeated as zero blocks, 1.72x the real flops at
//   R-MAT scale 15) and its coverage zeros never reach the kernel.  A block-
//   row that no real block visits is zero-filled in a fresh output
//   (spmm_fill_kernel).
// * The result on non-finite B is the reference's all the same.  There a
//   stored zero block (padding, coverage, a steal3d dummy pair) at block-row
//   r and B chunk c gives 0 * inf = NaN in every row of r at each column
//   where B's chunk c holds an inf or a NaN.  The table keeps the skipped
//   entries, one per (tile, block-row, B chunk), and after the multiply
//   spmm_flag_kernel marks the columns of each skipped chunk that hold a
//   non-finite value (reading only those chunks, and raising one device
//   flag), and spmm_nan_kernel writes NaN there; it returns at once when the
//   flag is clear, so finite B costs the flag pass alone, with no host sync.
// * Operands are read in place.  Each entry names an A block by its slot in
//   a pool (the placed stack of A tiles on the padded wire, the packed
//   buffers on the packed wire), each chunk the B tile of its output tile,
//   both composed at plan time from the ring step's tile maps: a ring step
//   on one card copies neither operand.
// * One unit of work is a (chunk, row part, n-panel of BN columns): a chunk
//   is a block-row segment of at most MAX_CHUNK real blocks, so on the
//   rings' main paths (segments of at most nbc = 128 real blocks) each is one
//   chunk and writes C directly.  Longer segments (raw calls that list
//   padding, steal3d's segments that span g A tiles) store ordered float32
//   partials that spmm_reduce_kernel sums in chunk order: no atomics, the
//   result does not depend on block order.
// * A plain grid, not a persistent one: the main paths give 1,024 (SpMM)
//   and 32,768 (SpGEMM) units of up to 128 blocks, at least two thread
//   blocks are resident on an SM, so one unit's epilogue overlaps another's
//   loads without a work queue.  The table sorts chunks by tile and then
//   longest first, so long units start early and one tile's B is hot in L2;
//   n-panels go in groups of PANEL_GROUP that every chunk visits before the
//   next group, so a group's B panels (32 MB float32 at the SpGEMM shape,
//   n 8,192) stay in the 50 MB L2 while the chunks stream past them.
// * Slabs of A (BM x BK) and B (BK x BN) come in through a cp.async ring of
//   STAGES stages; rows and columns past a ragged edge are zero in shared
//   memory.
//
// What bounds it on an H100: a real block is 2*bs^2*n flops on bs^2 + bs*n
// elements read (bs 128, n 256 float32: 16.8 MFLOP on 192 KB, ~85 flop a
// byte), so float32 is bound by the CUDA cores' FMA rate (67 TFLOP/s; IEEE
// FMA, as the reference: TF32 would break its 1e-5), bf16 by the bytes.
//
// * float32 (and bf16 at block sizes that are not a multiple of 16): SIMT
//   FMA, a TM x TN = 8 x 8 register tile per thread on a BM x 128 unit tile
//   (BM 128 at bs > 64, 64 at bs > 32; narrower for the tests' small
//   blocks), 16-deep slabs.  A thread's rows are interleaved (ty + TY*i) and
//   read 4 k at a time, its columns are two runs of 4 (tx*4, 64 + tx*4): 16
//   FMA per LDS.128, against B2's 4 x 8 tile's ~10.7.  Registers are capped
//   at 128 a thread (__launch_bounds__ with 512 threads an SM at the least):
//   uncapped, the BM 64 tile took 255 and ran slower (PERF.md).
// * bf16 with bs % 16 == 0: tensor cores, mma.sync m16n8k16 (bf16 in,
//   float32 accumulate) fed by ldmatrix (.trans for B), warp tiles of
//   64 x 32 (fragment code shared with bsr_pair.cu, mma_fragments.cuh),
//   64-deep slabs and two thread blocks an SM (the BM 128 tile capped at
//   128 registers), which beat 32-deep slabs at one block an SM (PERF.md).
// * A fresh output is written once: the real sums, zeros on unvisited block-
//   rows.  With `accumulate` each visited element becomes C + sum, read and
//   written once (the ring's later steps add into C in place), the sum
//   rounded to the output type first: float32 C + s; bf16 bf16(C + bf16(s)),
//   the reference's two roundings (c + the step's product in C's type).
// * An optional device counter adds the real blocks each launch multiplied.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, loaded with
// ctypes (repro_torch/kernels/loader.py).  Plain C interface; returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mma_fragments.cuh"  // cp.async ring, bf16 reads, mma.sync fragments

namespace {

constexpr int BN = 128;          // output columns of a unit (one n-panel)
constexpr int MAX_CHUNK = 128;   // real blocks of a chunk, at most
constexpr int PANEL_GROUP = 8;   // n-panels every chunk visits in turn
constexpr int STAGES = 3;        // slabs in flight in the cp.async ring

struct Params {
  const void* a;         // A pool: blocks of bs x bs
  const void* b;         // B pool [*, K, n]
  const int* ent;        // [2, n_ent]: A pool slot, block column
  long long n_ent;
  const int* chunks;     // [6, n_chunks]: tile, first, end, block-row,
                         // part (-1: store C), B tile
  long long n_chunks;
  void* out;             // [T, nbr * bs, n] in the output type
  float* partial;        // [parts, bs, n]
  unsigned long long* count;
  int bs, nbr, K, n, accumulate;
  int row_parts, n_panels;
  int vec_a, vec_b;      // 16-byte copies of A rows / B rows
};

// ---------------------------------------------------------------------------
// element conversions and stores
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// The stored value: the sum rounded to T, added to C in T with `add`.
template <typename T>
__device__ __forceinline__ T combine(T old, float sum, bool add) {
  const T s = from_f32<T>(sum);
  return add ? from_f32<T>(to_f32(old) + to_f32(s)) : s;
}

template <typename T, int W>
struct alignas(sizeof(T) * W) Run {
  T x[W];
};

// W consecutive results of row `row` of a unit, from column `col` on: into
// C (part < 0) or the chunk's float32 partial.  Columns past n are dropped.
template <typename T, int W>
__device__ __forceinline__ void emit(const Params& p, int tile, int brow,
                                     int part, int row, int col,
                                     const float* v) {
  if (row >= p.bs || col >= p.n) return;
  const int cnt = min(W, p.n - col);
  if (part >= 0) {
    float* o = p.partial +
               (static_cast<long long>(part) * p.bs + row) * p.n + col;
    if (cnt == W && reinterpret_cast<uintptr_t>(o) % sizeof(Run<float, W>)
                        == 0) {
      Run<float, W> r;
#pragma unroll
      for (int j = 0; j < W; ++j) r.x[j] = v[j];
      *reinterpret_cast<Run<float, W>*>(o) = r;
    } else {
      for (int j = 0; j < cnt; ++j) o[j] = v[j];
    }
    return;
  }
  T* o = static_cast<T*>(p.out) +
         ((static_cast<long long>(tile) * p.nbr + brow) * p.bs + row) * p.n +
         col;
  const bool add = p.accumulate != 0;
  if (cnt == W && reinterpret_cast<uintptr_t>(o) % sizeof(Run<T, W>) == 0) {
    Run<T, W> r;
    if (add) r = *reinterpret_cast<const Run<T, W>*>(o);
#pragma unroll
    for (int j = 0; j < W; ++j) r.x[j] = combine<T>(r.x[j], v[j], add);
    *reinterpret_cast<Run<T, W>*>(o) = r;
  } else {
    for (int j = 0; j < cnt; ++j) o[j] = combine<T>(o[j], v[j], add);
  }
}

// ---------------------------------------------------------------------------
// staging: an R x C window of a row-major source into shared memory
// ---------------------------------------------------------------------------
// Rows [0, rows) and columns [0, cols) of `src` (row stride ld) land at
// dst[r * LDS + c]; the rest of the R x C window is zero.  With `vec` (row
// bytes and base a multiple of 16) 16-byte cp.async copies, else one
// element a copy (4-byte cp.async for float32, a plain copy for bf16).
template <typename T, int R, int C, int LDS, int THREADS>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld,
                                           int rows, int cols, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    constexpr int CPR = C / E;
#pragma unroll
    for (int i = tid; i < R * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * E;
      T* d = dst + r * LDS + c;
      if (r < rows && c < cols)
        copy_async<16>(d, src + r * ld + c);
      else
        zero_vec<16>(d);
    }
  } else {
    constexpr int VE = static_cast<int>(sizeof(T));
    for (int i = tid; i < R * C; i += THREADS) {
      const int r = i / C, c = i % C;
      T* d = dst + r * LDS + c;
      if (r < rows && c < cols)
        copy_async<VE>(d, src + r * ld + c);
      else
        zero_vec<VE>(d);
    }
  }
}

// ---------------------------------------------------------------------------
// the two multiply variants
// ---------------------------------------------------------------------------
// SIMT (CUDA cores, float32 FMA; bf16 widened as it is read): thread (ty,
// tx) owns rows ty + TY*i (i < TM) and columns q*TX*4 + tx*4 + j (q < TN/4,
// j < 4) of the BM x BN unit tile.
template <typename T, int BM_, int TM, int TN>
struct Simt {
  using Elem = T;
  static constexpr int BM = BM_, BK = 16;
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));
  static constexpr int LDA = BK + PAD, LDB = BN + PAD;
  static constexpr int TY = BM / TM, TX = BN / TN, THREADS = TY * TX;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static_assert(TN % 4 == 0 && BM % TM == 0 && BN % TN == 0, "tile shape");
  // thread blocks resident on an SM at the least: 512 threads, so each
  // thread keeps at most 128 registers (2 blocks of 256 threads, 4 of 128)
  static constexpr int MINB = 512 / THREADS;
  float acc[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const T* As, const T* Bs, int tid) {
    const int ty = tid / TX, tx = tid % TX;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) load_n<4>(As + (ty + TY * i) * LDA + k, a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q)
          load_n<4>(Bs + (k + kk) * LDB + q * TX * 4 + tx * 4, b + 4 * q);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }

  __device__ __forceinline__ void store(const Params& p, int tile, int brow,
                                        int part, int m0, int n0,
                                        int tid) const {
    const int ty = tid / TX, tx = tid % TX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN / 4; ++q)
        emit<T, 4>(p, tile, brow, part, m0 + ty + TY * i,
                   n0 + q * TX * 4 + tx * 4, &acc[i][4 * q]);
  }
};

// Tensor cores (bf16 in, float32 accumulate): WARPS_M x 4 warps, each a WM
// x 32 warp tile of m16n8k16 products over 64-deep slabs (32-deep below BM
// 64, whose blocks are no deeper), two thread blocks an SM.
template <int BM_>
struct Mma {
  using Elem = bf16;
  static constexpr int BM = BM_, BK = BM_ >= 64 ? 64 : 32, MINB = 2;
  static constexpr int WM = BM < 64 ? BM : 64, WN = 32;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  float acc[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ __forceinline__ void mma(const bf16* As, const bf16* Bs,
                                      int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16)
      mma_k16<MT, NT>(acc, As + wm * WM * LDA + ks, LDA,
                      Bs + ks * LDB + wn * WN, LDB, lane);
  }

  __device__ __forceinline__ void store(const Params& p, int tile, int brow,
                                        int part, int m0, int n0,
                                        int tid) const {
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = m0 + (warp / WARPS_N) * WM, c0 = n0 + (warp % WARPS_N) * WN;
    mma_for_each_pair<MT, NT>(acc, lane, [&](int r, int c, float v0,
                                             float v1) {
      const float v[2] = {v0, v1};
      emit<bf16, 2>(p, tile, brow, part, r0 + r, c0 + c, v);
    });
  }
};

// ---------------------------------------------------------------------------
// the unit kernel
// ---------------------------------------------------------------------------
// Unit u -> (chunk, row part, n-panel): panel groups of PANEL_GROUP panels
// in order; inside a group, (chunk, row part) in table order with the
// group's panels of one chunk side by side (they share its A blocks).
struct Unit {
  int chunk, rp, panel;
};

__device__ __forceinline__ Unit unit_of(const Params& p, long long u) {
  const long long rows = p.n_chunks * p.row_parts;
  const long long per_group = rows * PANEL_GROUP;
  const int group = static_cast<int>(u / per_group);
  const int first = group * PANEL_GROUP;
  const int w = min(PANEL_GROUP, p.n_panels - first);
  const long long r = u - group * per_group;
  const long long cr = r / w;
  Unit x;
  x.panel = first + static_cast<int>(r % w);
  x.chunk = static_cast<int>(cr / p.row_parts);
  x.rp = static_cast<int>(cr % p.row_parts);
  return x;
}

template <class Op>
__global__ void __launch_bounds__(Op::THREADS, Op::MINB)
    spmm_kernel(const Params p) {
  using T = typename Op::Elem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_slot[MAX_CHUNK];
  __shared__ int s_col[MAX_CHUNK];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const Unit u = unit_of(p, blockIdx.x);
  const long long nc = p.n_chunks;
  const int tile = p.chunks[u.chunk];
  const int first = p.chunks[nc + u.chunk];
  const int len = p.chunks[2 * nc + u.chunk] - first;
  const int brow = p.chunks[3 * nc + u.chunk];
  const int part = p.chunks[4 * nc + u.chunk];
  const int btile = p.chunks[5 * nc + u.chunk];
  for (int e = tid; e < len; e += Op::THREADS) {
    s_slot[e] = p.ent[first + e];
    s_col[e] = p.ent[p.n_ent + first + e];
  }
  __syncthreads();

  const int m0 = u.rp * Op::BM, n0 = u.panel * BN;
  const int nk = (p.bs + Op::BK - 1) / Op::BK;
  const int total = len * nk;            // slabs of this unit
  const long long bsq = static_cast<long long>(p.bs) * p.bs;
  const T* A = static_cast<const T*>(p.a) + static_cast<long long>(m0) * p.bs;
  const T* B = static_cast<const T*>(p.b) +
               static_cast<long long>(btile) * p.K * p.n + n0;
  const int a_rows = min(Op::BM, p.bs - m0);
  const int b_cols = min(BN, p.n - n0);
  const bool va = p.vec_a != 0, vb = p.vec_b != 0;

  auto load = [&](int i, int s) {        // slab i into stage s
    const int e = i / nk, k0 = (i % nk) * Op::BK;
    const int kv = min(Op::BK, p.bs - k0);
    T* st = ring + s * Op::STAGE;
    stage_tile<T, Op::BM, Op::BK, Op::LDA, Op::THREADS>(
        st, A + s_slot[e] * bsq + k0, p.bs, a_rows, kv, va, tid);
    stage_tile<T, Op::BK, BN, Op::LDB, Op::THREADS>(
        st + Op::A_ELEMS,
        B + (static_cast<long long>(s_col[e]) * p.bs + k0) * p.n, p.n, kv,
        b_cols, vb, tid);
  };

  Op op;
  op.zero();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_commit();
  }
  for (int i = 0; i < total; ++i) {
    cp_wait<STAGES - 2>();   // this thread's copies of slab i landed
    __syncthreads();         // ... and every thread's; stage (i-1) is free
    const int next = i + STAGES - 1;
    if (next < total) load(next, next % STAGES);
    cp_commit();
    const T* st = ring + (i % STAGES) * Op::STAGE;
    op.mma(st, st + Op::A_ELEMS, tid);
  }
  cp_wait<0>();
  if (p.count != nullptr && tid == 0 && u.rp == 0 && u.panel == 0)
    atomicAdd(p.count, static_cast<unsigned long long>(len));
  op.store(p, tile, brow, part, m0, n0, tid);
}

// C[tile, block-row] (+)= the segment's partials, summed in chunk order.
// reduce rows are (tile, block-row, first part, parts); blockIdx.y walks
// the rows, blockIdx.x the bs * n elements.
template <typename T>
__global__ void __launch_bounds__(256)
    spmm_reduce_kernel(const float* __restrict__ partial,
                       const int* __restrict__ reduce, long long n_reduce,
                       T* __restrict__ out, int bs, int nbr, int n,
                       int accumulate) {
  const long long elems = static_cast<long long>(bs) * n;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= elems) return;
  for (long long r = blockIdx.y; r < n_reduce; r += gridDim.y) {
    const int t = reduce[r];
    const int brow = reduce[n_reduce + r];
    const long long first = reduce[2 * n_reduce + r];
    const int parts = reduce[3 * n_reduce + r];
    const float* src = partial + first * elems + e;
    float sum = 0.f;
    for (int c = 0; c < parts; ++c) sum += src[c * elems];
    T* o = out + (static_cast<long long>(t) * nbr + brow) * elems + e;
    *o = combine<T>(*o, sum, accumulate != 0);
  }
}

// flags[u * n + col] = 1 where the bs rows of B chunk u (B tile, block
// column: chunks [2, n_chunks]) hold an inf or a NaN in column col, else 0;
// any = 1 if some flag is set (the caller zeroes it first).  blockIdx.x
// walks the columns, blockIdx.y the chunks.
template <typename T>
__global__ void __launch_bounds__(256)
    spmm_flag_kernel(const T* __restrict__ b, const int* __restrict__ chunks,
                     long long n_chunks, unsigned char* __restrict__ flags,
                     int* __restrict__ any, int bs, int K, int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  for (long long u = blockIdx.y; u < n_chunks; u += gridDim.y) {
    const long long bt = chunks[u], c = chunks[n_chunks + u];
    const T* src = b + (bt * K + c * bs) * n + col;
    bool bad = false;
    for (int r = 0; r < bs; ++r)
      bad |= !isfinite(to_f32(src[static_cast<long long>(r) * n]));
    flags[u * n + col] = bad ? 1 : 0;
    if (bad) *any = 1;
  }
}

// NaN into every row of each skipped entry's block-row (skip [3, n_skip]:
// tile, block-row, chunk) at the columns its chunk flags; nothing at all
// unless the any flag is set.
template <typename T>
__global__ void __launch_bounds__(256)
    spmm_nan_kernel(const int* __restrict__ skip, long long n_skip,
                    const unsigned char* __restrict__ flags,
                    const int* __restrict__ any, T* __restrict__ out, int bs,
                    int nbr, int n) {
  if (*any == 0) return;
  const long long elems = static_cast<long long>(bs) * n;
  const T nan = from_f32<T>(__int_as_float(0x7fc00000));
  for (long long x = blockIdx.x; x < n_skip; x += gridDim.x) {
    const int t = skip[x], brow = skip[n_skip + x];
    const unsigned char* f =
        flags + static_cast<long long>(skip[2 * n_skip + x]) * n;
    T* o = out + (static_cast<long long>(t) * nbr + brow) * elems;
    for (long long e = threadIdx.x; e < elems; e += blockDim.x)
      if (f[e % n]) o[e] = nan;
  }
}

// Zero the block-rows that no real block visits (a fresh output only): one
// thread block per fill row (tile, block-row).
template <typename T>
__global__ void __launch_bounds__(256)
    spmm_fill_kernel(const int* __restrict__ fill, long long n_fill,
                     T* __restrict__ out, int bs, int nbr, int n) {
  const long long f = blockIdx.x;
  const int t = fill[f];
  const int brow = fill[n_fill + f];
  const long long elems = static_cast<long long>(bs) * n;
  T* o = out + (static_cast<long long>(t) * nbr + brow) * elems;
  const long long bytes = elems * static_cast<long long>(sizeof(T));
  if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0) {
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (long long e = threadIdx.x; e < bytes / 16; e += blockDim.x)
      o4[e] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (long long e = threadIdx.x; e < elems; e += blockDim.x)
      o[e] = from_f32<T>(0.f);
  }
}

template <class Op>
cudaError_t launch_units(Params& p, cudaStream_t stream) {
  p.row_parts = (p.bs + Op::BM - 1) / Op::BM;
  const long long units = p.n_chunks * p.row_parts * p.n_panels;
  if (units > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kern = spmm_kernel<Op>;
  const int smem = STAGES * Op::STAGE *
                   static_cast<int>(sizeof(typename Op::Elem));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(units), Op::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// 1: tensor cores (bf16, bs a multiple of 16); 0: the SIMT variant
int path_of(int bs, int dtype) { return dtype == 1 && bs % 16 == 0 ? 1 : 0; }

template <typename T>
cudaError_t dispatch(Params& p, int dtype, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (path_of(p.bs, dtype) == 1) {
      if (p.bs >= 128) return launch_units<Mma<128>>(p, stream);
      if (p.bs >= 64) return launch_units<Mma<64>>(p, stream);
      if (p.bs >= 32) return launch_units<Mma<32>>(p, stream);
      return launch_units<Mma<16>>(p, stream);
    }
  }
  if (p.bs > 64) return launch_units<Simt<T, 128, 8, 8>>(p, stream);
  if (p.bs > 32) return launch_units<Simt<T, 64, 8, 8>>(p, stream);
  if (p.bs > 16) return launch_units<Simt<T, 32, 4, 8>>(p, stream);
  if (p.bs > 8) return launch_units<Simt<T, 16, 2, 8>>(p, stream);
  return launch_units<Simt<T, 8, 1, 8>>(p, stream);
}

template <typename T>
cudaError_t run(Params& p, const int* reduce, long long n_reduce,
                const int* fill, long long n_fill, int dtype,
                cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  T* out = static_cast<T*>(p.out);
  if (!p.accumulate && n_fill > 0) {
    spmm_fill_kernel<T><<<static_cast<unsigned>(n_fill), 256, 0, st>>>(
        fill, n_fill, out, p.bs, p.nbr, p.n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (p.n_chunks > 0 && (err = dispatch<T>(p, dtype, st)) != cudaSuccess)
    return err;
  if (n_reduce > 0) {
    const long long elems = static_cast<long long>(p.bs) * p.n;
    const long long gx = (elems + 255) / 256;
    if (gx > INT_MAX) return cudaErrorInvalidConfiguration;
    const unsigned gy =
        static_cast<unsigned>(n_reduce < 65535 ? n_reduce : 65535);
    spmm_reduce_kernel<T><<<dim3(static_cast<unsigned>(gx), gy), 256, 0,
                            st>>>(p.partial, reduce, n_reduce, out, p.bs,
                                  p.nbr, p.n, p.accumulate);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t nan_pass(const T* b, const int* chunks, long long n_chunks,
                     const int* skip, long long n_skip, unsigned char* flags,
                     int* any, T* out, int bs, int nbr, int K, int n,
                     cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(any, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  const unsigned gy =
      static_cast<unsigned>(n_chunks < 65535 ? n_chunks : 65535);
  spmm_flag_kernel<T><<<dim3((n + 255) / 256, gy), 256, 0, st>>>(
      b, chunks, n_chunks, flags, any, bs, K, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned gx = static_cast<unsigned>(n_skip < 4096 ? n_skip : 4096);
  spmm_nan_kernel<T><<<gx, 256, 0, st>>>(skip, n_skip, flags, any, out, bs,
                                         nbr, n);
  return cudaGetLastError();
}

}  // namespace

// Which multiply a launch of this block size and type runs: 1 = tensor
// cores (mma.sync m16n8k16), 0 = CUDA cores (SIMT float32 FMA).
extern "C" int bsr_spmm_path(int bs, int dtype) { return path_of(bs, dtype); }

// dtype: 0 = float32, 1 = bfloat16 (a, b and out all of it; partial is
// float32).  a: the A pool, bs x bs blocks; b: the B pool [*, K, n]; ent
// int32 [2, n_ent] (A pool slot, block column of each real block, chunk by
// chunk); chunks int32 [6, n_chunks] (tile, first, end into ent, block-row,
// part or -1, B tile), each at most 128 blocks; reduce int32 [4, n_reduce]
// (tile, block-row, first part, parts); fill int32 [2, n_fill] (tile,
// block-row), zeroed unless accumulate; partial float32 [parts, bs, n]
// (workspace); out [T, nbr * bs, n]; count uint64 [1] or null: the blocks
// multiplied are added to it.  All contiguous on one device.  accumulate
// != 0 adds into out in place, touching only the block-rows the chunks name.
extern "C" int bsr_spmm_launch(const void* a, const void* b, const void* ent,
                               long long n_ent, const void* chunks,
                               long long n_chunks, const void* reduce,
                               long long n_reduce, const void* fill,
                               long long n_fill, void* partial, void* out,
                               void* count, int bs, int nbr, int K, int n,
                               int accumulate, int dtype, void* stream) {
  if (bs <= 0 || nbr <= 0 || K <= 0 || n <= 0 || K % bs != 0 ||
      n_ent < 0 || n_chunks < 0 || n_reduce < 0 || n_fill < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_ent > INT_MAX || n_chunks > INT_MAX || n_fill > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int elem = dtype == 0 ? 4 : 2;
  Params p;
  p.a = a;
  p.b = b;
  p.ent = static_cast<const int*>(ent);
  p.n_ent = n_ent;
  p.chunks = static_cast<const int*>(chunks);
  p.n_chunks = n_chunks;
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.count = static_cast<unsigned long long*>(count);
  p.bs = bs;
  p.nbr = nbr;
  p.K = K;
  p.n = n;
  p.accumulate = accumulate;
  p.row_parts = 1;
  p.n_panels = (n + BN - 1) / BN;
  p.vec_a = (bs * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  p.vec_b = (n * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* red = static_cast<const int*>(reduce);
  const int* fil = static_cast<const int*>(fill);
  const cudaError_t err =
      dtype == 0 ? run<float>(p, red, n_reduce, fil, n_fill, dtype, st)
                 : run<bf16>(p, red, n_reduce, fil, n_fill, dtype, st);
  return static_cast<int>(err);
}

// The non-finite pass of one launch, after bsr_spmm_launch on the same
// stream: b the launch's B pool [*, K, n]; chunks int32 [2, n_chunks] (B
// tile, block column of each B chunk that a skipped entry names); skip
// int32 [3, n_skip] (tile, block-row, chunk index); flags uint8 [n_chunks,
// n] and any int32 [1] (workspace); out the launch's [T, nbr * bs, n].
extern "C" int bsr_spmm_nan_launch(const void* b, const void* chunks,
                                   long long n_chunks, const void* skip,
                                   long long n_skip, void* flags, void* any,
                                   void* out, int bs, int nbr, int K, int n,
                                   int dtype, void* stream) {
  if (bs <= 0 || nbr <= 0 || K <= 0 || n <= 0 || K % bs != 0 ||
      n_chunks < 0 || n_skip < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0 || n_skip == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ch = static_cast<const int*>(chunks);
  const int* sk = static_cast<const int*>(skip);
  unsigned char* fl = static_cast<unsigned char*>(flags);
  int* an = static_cast<int*>(any);
  const cudaError_t err =
      dtype == 0
          ? nan_pass<float>(static_cast<const float*>(b), ch, n_chunks, sk,
                            n_skip, fl, an, static_cast<float*>(out), bs, nbr,
                            K, n, st)
          : nan_pass<bf16>(static_cast<const bf16*>(b), ch, n_chunks, sk,
                           n_skip, fl, an, static_cast<bf16*>(out), bs, nbr,
                           K, n, st);
  return static_cast<int>(err);
}
