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
// The element path (spmm_elem_kernel), for handles whose real blocks are
// nearly empty (R-MAT at bs 128: ~6 of 16,384 slots): the same sums over a
// plan-time table of each row's nonzeros (kernels/bsr_spmm.py::ElementLists,
// built once per handle; A's values read in the pool at call time), a
// row-gather SpMM as cuSPARSE's CSR @ dense:
//
// * What bounds it is bytes: each nonzero reads one row of B (n values) and
//   does 2n flops, so the rows of B gathered (nnz * n * 4 B at float32, 0.5
//   GB a launch at R-MAT scale 16, n 256) plus C written once set its time.
//   A tile's B (33.5 MB at that shape) fits the 50 MB L2, and units run by
//   tile, so most gathers hit L2.
// * A unit is a run of rows of one block-row segment, cut by entries (about
//   UNIT_WORK, kernels/bsr_spmm.py) so R-MAT's skewed rows balance by their
//   nonzeros, by an n-panel of G lanes x 16 bytes.  A lane group of G lanes
//   owns a whole row: it loads G entries' B rows and A values at once
//   (coalesced), walks them by shuffle with E_UNROLL 16-byte B loads in
//   flight, and sums in float32 FMA (IEEE, never TF32; bf16 widened) in the
//   block path's order.  A row longer than SPLIT_ROW is a unit alone, its
//   entries split over the thread block's groups, whose shares group 0 adds
//   in order: no atomics, a fixed order.
// * Each row of a visited block-row is written once: the sum, or C + the sum
//   rounded to the output type; block-rows no real block visits are left to
//   the zero fill (or left as they are under accumulate).
// * The NaN pass covers the zero slots it skips: the flag kernel counts, per
//   column, the non-finite rows of every B chunk a real block reads, and
//   spmm_zero_nan_kernel writes NaN at C[r, j] where a segment's real blocks
//   meet more non-finite rows at column j than row r's nonzeros do (a zero
//   slot then meets one: the block path's 0 * inf).  On finite B the cost is
//   the counting pass, one read of those chunks.
//
// The sparse-B path (spmm_sparse_b_kernel) replaces no TPU kernel: B1 gains
// it for a B that is itself a nearly empty block-sparse handle (the dense-
// output SpGEMM), where the other two paths need B densified every multiply
// (a 17.2 GB scatter and copy at the R-MAT scale-16 square) and then gather
// whole dense B rows, 99.8 % zeros.  It multiplies A's nonzeros by B's
// (kernels/bsr_spmm.py::SparseBTable: both handles' element lists, built
// once, their values gathered at launch into float32 beside them):
//
//   C[t][r, j] (+)= sum over A's nonzeros (k, a) of row r, in list order, of
//                   a * B[k, j] over B's nonzeros (j, b) of row k
//
// * What bounds it is C itself, written once: the products (56.9 M at the
//   square, 114 MFLOP) and both lists (4 MB, held in L2) are small beside a
//   dense 65,536^2 float32 C (17.2 GB, 5.13 ms at 3.35 TB/s).  So a fresh C
//   is written once, coalesced, zeros included (spmm_zero_rows_kernel for
//   the rows with no nonzero of A, the unit's windows for the others), and a
//   later step reads and writes only the positions its sums reach (about
//   480 a row at the square), not the whole row.
// * A warp sums one window of SB_WINDOW columns of one row in shared memory
//   (4 KB): for each of the row's A entries in list order it adds a * b of
//   the B row's entries inside the window, the lanes over those entries (a
//   B row holds each column once, so no two lanes meet), a __syncwarp
//   between entries.  B rows are sorted by column, and a per-row table of
//   window offsets (SparseBTable.windows) gives each entry's range in one
//   read; four entries' loads go out together.  No atomics: one order.
// * A unit is one row's windows, or a group of SB_WARPS windows of a heavy
//   row (R-MAT's hubs: up to 45 k products a row at the square), so a hub
//   spreads over the warps of several thread blocks; units go heaviest
//   first.
// * Non-finite values give the reference's (A's real blocks times the
//   densified B) exactly, from the two lists' values, with no host
//   synchronisation: the gather raises one flag for A and one for B, and
//   two passes that return at once while their flag is clear write the
//   NaNs of the zeros the multiply skipped: a non-finite B[k, j] meets every
//   zero slot of A's listed blocks in column k (a column index of the
//   launch's blocks, SparseBTable.colptr), a non-finite A[r, k] every zero
//   of the densified B row k (the columns the sorted B row does not hold).
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

// flags[u * n + col]: how many of the bs rows of B chunk u (B tile, block
// column: chunks [2, n_chunks]) hold an inf or a NaN in column col (F int),
// or whether any does (F unsigned char); any = 1 if some row does (the
// caller zeroes it first).  blockIdx.x walks the columns, blockIdx.y the
// chunks.
template <typename T, typename F>
__global__ void __launch_bounds__(256)
    spmm_flag_kernel(const T* __restrict__ b, const int* __restrict__ chunks,
                     long long n_chunks, F* __restrict__ flags,
                     int* __restrict__ any, int bs, int K, int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  for (long long u = blockIdx.y; u < n_chunks; u += gridDim.y) {
    const long long bt = chunks[u], c = chunks[n_chunks + u];
    const T* src = b + (bt * K + c * bs) * n + col;
    int bad = 0;
    for (int r = 0; r < bs; ++r)
      bad += !isfinite(to_f32(src[static_cast<long long>(r) * n]));
    flags[u * n + col] = static_cast<F>(sizeof(F) == 1 ? bad > 0 : bad);
    if (bad) *any = 1;
  }
}

// NaN into every row of each skipped entry's block-row (skip [3, n_skip]:
// tile, block-row, chunk) at the columns its chunk flags; nothing at all
// unless the any flag is set.
template <typename T, typename F>
__global__ void __launch_bounds__(256)
    spmm_nan_kernel(const int* __restrict__ skip, long long n_skip,
                    const F* __restrict__ flags,
                    const int* __restrict__ any, T* __restrict__ out, int bs,
                    int nbr, int n) {
  if (*any == 0) return;
  const long long elems = static_cast<long long>(bs) * n;
  const T nan = from_f32<T>(__int_as_float(0x7fc00000));
  for (long long x = blockIdx.x; x < n_skip; x += gridDim.x) {
    const int t = skip[x], brow = skip[n_skip + x];
    const F* f = flags + static_cast<long long>(skip[2 * n_skip + x]) * n;
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

// ---------------------------------------------------------------------------
// the element path: a row-gather multiply over the real blocks' nonzeros
// ---------------------------------------------------------------------------
constexpr int E_THREADS = 256;   // threads of a unit's thread block
constexpr int E_UNROLL = 4;      // B rows in flight a lane group

struct EParams {
  const void* a;                 // A pool, read element by element
  const void* b;                 // B pool [*, K, n]
  const long long* rowptr;       // [P * R + 1]: each pool tile row's entries
  const int* brow;               // [E]: B row inside the B tile (col*bs + c)
  const long long* aoff;         // [E]: A's value, an element of the pool
  const int* units;              // [6, n_units]: tile, pool tile, B tile,
                                 // first row, rows, blocks credited
  long long n_units;
  void* out;                     // [T, R, n] in the output type
  unsigned long long* count_blocks;
  unsigned long long* count_elems;
  int R, K, n, accumulate, vec;  // R = nbr * bs rows a tile
};

// `VEC` B values of row `br` from column `col` on, widened to float32: one
// 16-byte load with `vec`, else one element a load, zero past n.
template <typename T, int VEC>
__device__ __forceinline__ void load_b(const T* B, int br, int col, int n,
                                       bool vec, float* v) {
  const T* src = B + static_cast<long long>(br) * n + col;
  if (vec) {
    load_n<VEC>(src, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = col + i < n ? to_f32(src[i]) : 0.f;
  }
}

// Row `o` (the output row's first element) from column `col` on: the sums,
// or C + the sums rounded to T with `add`.
template <typename T, int VEC>
__device__ __forceinline__ void store_c(T* o, int col, int n, bool vec,
                                        bool add, const float* v) {
  if (col >= n) return;
  if (vec) {
    Run<T, VEC>* d = reinterpret_cast<Run<T, VEC>*>(o + col);
    Run<T, VEC> r;
    if (add) r = *d;
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.x[i] = combine<T>(r.x[i], v[i], add);
    *d = r;
  } else {
    for (int i = 0; i < VEC && col + i < n; ++i)
      o[col + i] = combine<T>(o[col + i], v[i], add);
  }
}

// acc += the entries [lo, hi) of one row, in order: a lane group of G lanes
// loads G entries' B rows and A values at once (coalesced), then each lane
// walks them by shuffle, with E_UNROLL B rows in flight, and adds A x B into
// its VEC columns by float32 FMA.  Every lane of the warp calls this (its
// groups step together; a group past its end multiplies nothing).
template <typename T, int G>
__device__ __forceinline__ void gather_row(const EParams& p, const T* A,
                                           const T* B, long long lo,
                                           long long hi, int lane, int col,
                                           float* acc) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int U = E_UNROLL < G ? E_UNROLL : G;
  constexpr unsigned FULL = 0xffffffffu;
  const bool in = col < p.n, vec = p.vec != 0;
  const int batches = __reduce_max_sync(
      FULL, static_cast<int>((hi - lo + G - 1) / G));
  for (int bi = 0; bi < batches; ++bi) {
    const long long first = lo + static_cast<long long>(bi) * G;
    const long long e = first + lane;
    int br = 0;
    float av = 0.f;
    if (e < hi) {
      br = p.brow[e];
      av = to_f32(A[p.aoff[e]]);
    }
    const int cnt = static_cast<int>(hi - first < G ? hi - first : G);
    const int most = __reduce_max_sync(FULL, cnt > 0 ? cnt : 0);
#pragma unroll
    for (int j0 = 0; j0 < G; j0 += U) {
      if (j0 >= most) break;
      int bj[U];
      float aj[U], v[U][VEC];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        bj[k] = __shfl_sync(FULL, br, j0 + k, G);
        aj[k] = __shfl_sync(FULL, av, j0 + k, G);
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (in && j0 + k < cnt) {
          load_b<T, VEC>(B, bj[k], col, p.n, vec, v[k]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[k][i] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (j0 + k < cnt)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fmaf(aj[k], v[k][i], acc[i]);
    }
  }
}

// One unit (a run of rows of one block-row segment) by one n-panel of G*VEC
// columns.  The block's E_THREADS / G lane groups take the unit's rows in
// turn, a row each; a unit of one row (a long one) is split: each group sums
// a contiguous share of its entries, and group 0 adds the shares in order.
// The gather is latency-bound: four thread blocks an SM (at most 64
// registers a thread) with 4 B rows in flight a group beat two with 8
// (PERF.md, section 6).
template <typename T, int G>
__global__ void __launch_bounds__(E_THREADS, 4)
    spmm_elem_kernel(const EParams p) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int NG = E_THREADS / G;
  constexpr int PW = G * VEC;
  __shared__ float s_part[NG][PW];
  const long long nu = p.n_units, u = blockIdx.x;
  const int tile = p.units[u], q = p.units[nu + u], bt = p.units[2 * nu + u];
  const int row0 = p.units[3 * nu + u], nrows = p.units[4 * nu + u];
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int col = blockIdx.y * PW + lane * VEC;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b) +
               static_cast<long long>(bt) * p.K * p.n;
  const long long* rp = p.rowptr + static_cast<long long>(q) * p.R + row0;
  T* C = static_cast<T*>(p.out) +
         (static_cast<long long>(tile) * p.R + row0) * p.n;
  const bool vec = p.vec != 0, add = p.accumulate != 0;
  if (threadIdx.x == 0 && blockIdx.y == 0) {
    if (p.count_blocks != nullptr && p.units[5 * nu + u] > 0)
      atomicAdd(p.count_blocks,
                static_cast<unsigned long long>(p.units[5 * nu + u]));
    if (p.count_elems != nullptr)
      atomicAdd(p.count_elems,
                static_cast<unsigned long long>(rp[nrows] - rp[0]));
  }
  float acc[VEC];
  if (nrows == 1) {
    const long long lo = rp[0], len = rp[1] - lo;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    gather_row<T, G>(p, A, B, lo + len * group / NG,
                     lo + len * (group + 1) / NG, lane, col, acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_part[group][lane * VEC + i] = acc[i];
    __syncthreads();
    if (group == 0) {
      for (int g = 1; g < NG; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += s_part[g][lane * VEC + i];
      store_c<T, VEC>(C, col, p.n, vec, add, acc);
    }
    return;
  }
  // the warp's groups move together, so its shuffles see every lane
  const int warp_group = (threadIdx.x / 32) * (32 / G);
  for (int base = 0; base + warp_group < nrows; base += NG) {
    const int i = base + group;
    const bool live = i < nrows;
    const long long lo = live ? rp[i] : 0, hi = live ? rp[i + 1] : 0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    gather_row<T, G>(p, A, B, lo, hi, lane, col, acc);
    if (live)
      store_c<T, VEC>(C + static_cast<long long>(i) * p.n, col, p.n, vec,
                      add, acc);
  }
}

template <typename T, int G>
cudaError_t launch_elem(const EParams& p, cudaStream_t st) {
  constexpr int PW = G * (16 / static_cast<int>(sizeof(T)));
  const int panels = (p.n + PW - 1) / PW;
  if (p.n_units > INT_MAX || panels > 65535)
    return cudaErrorInvalidConfiguration;
  spmm_elem_kernel<T, G>
      <<<dim3(static_cast<unsigned>(p.n_units), panels), E_THREADS, 0, st>>>(
          p);
  return cudaGetLastError();
}

// Lanes a row: the fewest (at least 4) whose 16-byte loads span n, at most
// a warp.
template <typename T>
cudaError_t elem_dispatch(const EParams& p, cudaStream_t st) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  if (p.n > 16 * VEC) return launch_elem<T, 32>(p, st);
  if (p.n > 8 * VEC) return launch_elem<T, 16>(p, st);
  if (p.n > 4 * VEC) return launch_elem<T, 8>(p, st);
  return launch_elem<T, 4>(p, st);
}

template <typename T>
cudaError_t run_elem(const EParams& p, const int* fill, long long n_fill,
                     int bs, int nbr, cudaStream_t st) {
  cudaError_t err;
  if (!p.accumulate && n_fill > 0) {
    spmm_fill_kernel<T><<<static_cast<unsigned>(n_fill), 256, 0, st>>>(
        fill, n_fill, static_cast<T*>(p.out), bs, nbr, p.n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (p.n_units == 0) return cudaSuccess;
  return elem_dispatch<T>(p, st);
}

// The element path's zero slots on non-finite B.  segs [6, n_segs]: tile,
// block-row, pool tile, B tile, first and end into seg_chunks, which holds
// the chunk (row of counts) of each real block of the segment; counts
// [*, n]: the non-finite rows of each B chunk at each column.  Summed over
// a segment's real blocks they are the slots that meet a non-finite B at
// column j; those that row r's nonzeros meet are among them.  Where the
// segment has more, a zero slot (r, c) of a real block meets a non-finite
// B[c, j], and C[r, j] becomes NaN (the block path's 0 * inf).  Nothing
// unless the any flag is set.  blockIdx.x walks the segments, blockIdx.y
// the columns.
template <typename T>
__global__ void __launch_bounds__(256)
    spmm_zero_nan_kernel(const T* __restrict__ b, const int* __restrict__ segs,
                         long long n_segs, const int* __restrict__ seg_chunks,
                         const int* __restrict__ counts,
                         const int* __restrict__ any,
                         const long long* __restrict__ rowptr,
                         const int* __restrict__ brow, T* __restrict__ out,
                         int bs, int R, int K, int n) {
  if (*any == 0) return;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const T nan = from_f32<T>(__int_as_float(0x7fc00000));
  for (long long s = blockIdx.x; s < n_segs; s += gridDim.x) {
    const int tile = segs[s], br = segs[n_segs + s], q = segs[2 * n_segs + s];
    const int bt = segs[3 * n_segs + s];
    long long bad = 0;
    for (int e = segs[4 * n_segs + s]; e < segs[5 * n_segs + s]; ++e)
      bad += counts[static_cast<long long>(seg_chunks[e]) * n + j];
    if (bad == 0) continue;
    const T* B = b + static_cast<long long>(bt) * K * n + j;
    const long long row0 = static_cast<long long>(br) * bs;
    const long long* rp = rowptr + static_cast<long long>(q) * R + row0;
    T* o = out + (static_cast<long long>(tile) * R + row0) * n + j;
    for (int r = 0; r < bs; ++r) {
      long long met = 0;
      for (long long e = rp[r]; e < rp[r + 1]; ++e)
        met += !isfinite(to_f32(B[static_cast<long long>(brow[e]) * n]));
      if (bad > met) o[static_cast<long long>(r) * n] = nan;
    }
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

template <typename T, typename F>
cudaError_t nan_pass(const T* b, const int* chunks, long long n_chunks,
                     const int* skip, long long n_skip, F* flags, int* any,
                     T* out, int bs, int nbr, int K, int n, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(any, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  const unsigned gy =
      static_cast<unsigned>(n_chunks < 65535 ? n_chunks : 65535);
  spmm_flag_kernel<T, F><<<dim3((n + 255) / 256, gy), 256, 0, st>>>(
      b, chunks, n_chunks, flags, any, bs, K, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (n_skip == 0) return cudaSuccess;
  const unsigned gx = static_cast<unsigned>(n_skip < 4096 ? n_skip : 4096);
  spmm_nan_kernel<T, F><<<gx, 256, 0, st>>>(skip, n_skip, flags, any, out,
                                            bs, nbr, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t elem_nan_pass(const T* b, const int* flag_chunks, long long n_flag,
                          const int* skip, long long n_skip, const int* segs,
                          long long n_segs, const int* seg_chunks,
                          const long long* rowptr, const int* brow,
                          int* counts, int* any, T* out, int bs, int nbr,
                          int K, int n, cudaStream_t st) {
  cudaError_t err = nan_pass<T, int>(b, flag_chunks, n_flag, skip, n_skip,
                                     counts, any, out, bs, nbr, K, n, st);
  if (err != cudaSuccess || n_segs == 0) return err;
  const unsigned gx = static_cast<unsigned>(n_segs < 4096 ? n_segs : 4096);
  spmm_zero_nan_kernel<T><<<dim3(gx, (n + 255) / 256), 256, 0, st>>>(
      b, segs, n_segs, seg_chunks, counts, any, rowptr, brow, out, bs,
      nbr * bs, K, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the sparse-B path: A's nonzeros times B's nonzeros, a window at a time
// ---------------------------------------------------------------------------
constexpr int SB_WARPS = 8;                   // warps of a unit's block
constexpr int SB_THREADS = 32 * SB_WARPS;
constexpr int SB_WINDOW = 1024;               // C columns a warp sums at once
constexpr int SB_AHEAD = 4;                   // A entries' loads in flight
constexpr int SB_NAN_BLOCKS = 264;            // the NaN passes' grid

struct SBParams {
  const float* aval;             // [Ea] A's listed values, float32
  const long long* a_rowptr;     // [Pa * R + 1]
  const int* a_brow;             // [Ea] the B row of each
  const float* bval;             // [Eb] B's listed values, float32
  const long long* b_rowptr;     // [Pb * K + 1]
  const int* b_col;              // [Eb] the C column of each, sorted a row
  const int* windows;            // [Pb * K, nwin + 1]: each row's first
                                 // entry of each window, from its start
  const int* units;              // [5, n_units]: tile, row, first and end
                                 // window, blocks credited
  long long n_units;
  const int* maps;               // [2, T]: A pool tile, B pool tile
  void* out;                     // [T, R, n] in the output type
  unsigned long long* count_blocks;
  int tiles, R, K, n, nwin, accumulate, vec;
};

// One unit: windows [first, end) of one row of one output tile, warp w
// taking windows first + w, first + w + SB_WARPS, ...  Each window's sums
// go to C as the fresh row (every column: a rows's window is written once)
// or, with `accumulate`, as C + the sum rounded to T at the columns the
// sums reach, the others left as they are.
template <typename T>
__global__ void __launch_bounds__(SB_THREADS)
    spmm_sparse_b_kernel(const SBParams p) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ __align__(16) float s_acc[SB_WARPS][SB_WINDOW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nu = p.n_units, u = blockIdx.x;
  const int tile = p.units[u], row = p.units[nu + u];
  const int w_end = p.units[3 * nu + u];
  if (threadIdx.x == 0 && p.count_blocks != nullptr && p.units[4 * nu + u] > 0)
    atomicAdd(p.count_blocks,
              static_cast<unsigned long long>(p.units[4 * nu + u]));
  const long long a_row = static_cast<long long>(p.maps[tile]) * p.R + row;
  const long long lo = p.a_rowptr[a_row], hi = p.a_rowptr[a_row + 1];
  const long long b_row0 =
      static_cast<long long>(p.maps[p.tiles + tile]) * p.K;
  T* C = static_cast<T*>(p.out) +
         (static_cast<long long>(tile) * p.R + row) * p.n;
  float* acc = s_acc[warp];
  const bool add = p.accumulate != 0, vec = p.vec != 0;
  for (int w = p.units[2 * nu + u] + warp; w < w_end; w += SB_WARPS) {
    const int c0 = w * SB_WINDOW;
    const int width = min(SB_WINDOW, p.n - c0);
#pragma unroll
    for (int i = lane * 4; i < SB_WINDOW; i += 128)
      *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    bool hit = false;
    for (long long e0 = lo; e0 < hi; e0 += 32) {
      // lane i: entry e0 + i's value and its B row's range in the window
      const long long e = e0 + lane;
      float a = 0.f;
      long long s = 0;
      int cnt = 0;
      if (e < hi) {
        const long long br = b_row0 + p.a_brow[e];
        const int* wo = p.windows + br * (p.nwin + 1) + w;
        a = p.aval[e];
        s = p.b_rowptr[br] + wo[0];
        cnt = wo[1] - wo[0];
      }
      unsigned live = __ballot_sync(FULL, cnt > 0);
      hit |= live != 0;
      while (live) {
        // up to SB_AHEAD live entries, in list order: their first 32 B
        // entries loaded together, then added one entry after another
        int src[SB_AHEAD], m = 0;
#pragma unroll
        for (int x = 0; x < SB_AHEAD; ++x) {
          src[x] = live ? __ffs(static_cast<int>(live)) - 1 : 0;
          if (live) {
            live &= live - 1;
            ++m;
          }
        }
        float ax[SB_AHEAD], v[SB_AHEAD];
        long long sx[SB_AHEAD];
        int cx[SB_AHEAD], j[SB_AHEAD];
#pragma unroll
        for (int x = 0; x < SB_AHEAD; ++x) {
          ax[x] = __shfl_sync(FULL, a, src[x]);
          sx[x] = __shfl_sync(FULL, s, src[x]);
          cx[x] = x < m ? __shfl_sync(FULL, cnt, src[x]) : 0;
          j[x] = 0;
          v[x] = 0.f;
          if (lane < cx[x]) {
            j[x] = p.b_col[sx[x] + lane] - c0;
            v[x] = p.bval[sx[x] + lane];
          }
        }
#pragma unroll
        for (int x = 0; x < SB_AHEAD; ++x) {
          if (x >= m) break;
          if (lane < cx[x]) acc[j[x]] = fmaf(ax[x], v[x], acc[j[x]]);
          for (long long f = sx[x] + 32 + lane; f < sx[x] + cx[x]; f += 32) {
            const int jj = p.b_col[f] - c0;
            acc[jj] = fmaf(ax[x], p.bval[f], acc[jj]);
          }
          __syncwarp();
        }
      }
    }
    if (add && !hit) continue;      // nothing reaches this window
    if (vec) {
      for (int i = lane * VEC; i < width; i += 32 * VEC) {
        float sum[VEC];
#pragma unroll
        for (int x = 0; x < VEC; x += 4) {
          const float4 q = *reinterpret_cast<const float4*>(acc + i + x);
          sum[x] = q.x;
          sum[x + 1] = q.y;
          sum[x + 2] = q.z;
          sum[x + 3] = q.w;
        }
        Run<T, VEC>* d = reinterpret_cast<Run<T, VEC>*>(C + c0 + i);
        if (!add) {
          Run<T, VEC> r;
#pragma unroll
          for (int x = 0; x < VEC; ++x) r.x[x] = from_f32<T>(sum[x]);
          *d = r;
          continue;
        }
        bool reach = false;
#pragma unroll
        for (int x = 0; x < VEC; ++x) reach |= __float_as_uint(sum[x]) != 0u;
        if (!reach) continue;
        Run<T, VEC> r = *d;
#pragma unroll
        for (int x = 0; x < VEC; ++x)
          if (__float_as_uint(sum[x]) != 0u)
            r.x[x] = combine<T>(r.x[x], sum[x], true);
        *d = r;
      }
    } else {
      for (int i = lane; i < width; i += 32) {
        const float sum = acc[i];
        if (!add)
          C[c0 + i] = from_f32<T>(sum);
        else if (__float_as_uint(sum) != 0u)
          C[c0 + i] = combine<T>(C[c0 + i], sum, true);
      }
    }
    __syncwarp();                   // the window is read before it is zeroed
  }
}

// Zero whole rows of a fresh output (rows: tile * R + row of each row that
// no nonzero of A reaches), one thread block a row.
template <typename T>
__global__ void __launch_bounds__(256)
    spmm_zero_rows_kernel(const int* __restrict__ rows, long long n_rows,
                          T* __restrict__ out, int n, int vec) {
  for (long long x = blockIdx.x; x < n_rows; x += gridDim.x) {
    T* o = out + static_cast<long long>(rows[x]) * n;
    if (vec) {
      uint4* o4 = reinterpret_cast<uint4*>(o);
      const int n4 = n * static_cast<int>(sizeof(T)) / 16;
      for (int e = threadIdx.x; e < n4; e += blockDim.x)
        o4[e] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int e = threadIdx.x; e < n; e += blockDim.x) o[e] = from_f32<T>(0.f);
    }
  }
}

// The two lists' values at launch, into float32 beside them: A's at a_off
// in the A pool, B's at b_off in the B pool; flags[0] (flags[1]) is raised
// where one of A's (B's) is an inf or a NaN (the caller zeroes them first).
// Block 0 also credits the real blocks that hold no nonzero to the counter.
template <typename T>
__global__ void __launch_bounds__(256)
    spmm_gather_kernel(const T* __restrict__ a,
                       const long long* __restrict__ a_off, long long ea,
                       const T* __restrict__ b,
                       const long long* __restrict__ b_off, long long eb,
                       float* __restrict__ aval, float* __restrict__ bval,
                       int* __restrict__ flags,
                       unsigned long long* count_blocks, long long credit) {
  if (count_blocks != nullptr && credit > 0 && blockIdx.x == 0 &&
      threadIdx.x == 0)
    atomicAdd(count_blocks, static_cast<unsigned long long>(credit));
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  bool bad_a = false, bad_b = false;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < ea + eb; i += step) {
    if (i < ea) {
      const float x = to_f32(a[a_off[i]]);
      aval[i] = x;
      bad_a |= !isfinite(x);
    } else {
      const float x = to_f32(b[b_off[i - ea]]);
      bval[i - ea] = x;
      bad_b |= !isfinite(x);
    }
  }
  if (bad_a) flags[0] = 1;
  if (bad_b) flags[1] = 1;
}

// The row of a list that holds entry e: the last r in [0, rows) with
// rowptr[r] <= e.
__device__ __forceinline__ long long row_of(const long long* rowptr,
                                            long long rows, long long e) {
  long long lo = 0, hi = rows;
  while (hi - lo > 1) {
    const long long mid = (lo + hi) / 2;
    if (rowptr[mid] <= e)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

struct SBNan {
  const void* a;                 // the A pool, blocks of bs x bs
  const long long* a_rowptr;
  const int* a_brow;
  const float* aval;
  long long ea, a_rows;          // entries, rows (Pa * R) of A's lists
  const long long* b_rowptr;
  const int* b_col;
  const float* bval;
  long long eb, b_rows;
  const int* maps;
  const int* colptr;             // [T * span + 1]
  const int* col_ent;            // [2, n_col]: block-row, A pool slot (-1:
                                 // a listed zero block)
  long long n_col;
  const int* flags;
  void* out;
  int tiles, span, bs, R, K, n;
};

// A non-finite B[k, j] (a B entry of pool tile bt): in each output tile t
// that reads bt, NaN at C[t][r, j] for every row r of a block-row that
// lists a block in A's block column k / bs whose slot (r, k) is zero (a
// listed zero block: every row).  Nothing while B's flag is clear.
template <typename T>
__global__ void __launch_bounds__(256) spmm_sb_nan_b_kernel(const SBNan p) {
  if (p.flags[1] == 0) return;
  const T* A = static_cast<const T*>(p.a);
  T* out = static_cast<T*>(p.out);
  const T nan = from_f32<T>(__int_as_float(0x7fc00000));
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long f = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       f < p.eb; f += step) {
    if (isfinite(p.bval[f])) continue;
    const long long row = row_of(p.b_rowptr, p.b_rows, f);
    const int bt = static_cast<int>(row / p.K);
    const int k = static_cast<int>(row % p.K);
    const int c = k / p.bs, kk = k % p.bs, j = p.b_col[f];
    if (c >= p.span) continue;
    for (int t = 0; t < p.tiles; ++t) {
      if (p.maps[p.tiles + t] != bt) continue;
      const long long key = static_cast<long long>(t) * p.span + c;
      for (int x = p.colptr[key]; x < p.colptr[key + 1]; ++x) {
        const int br = p.col_ent[x];
        const long long slot = p.col_ent[p.n_col + x];
        for (int rr = 0; rr < p.bs; ++rr) {
          if (slot >= 0 &&
              to_f32(A[(slot * p.bs + rr) * p.bs + kk]) != 0.f)
            continue;
          out[(static_cast<long long>(t) * p.R + br * p.bs + rr) * p.n + j] =
              nan;
        }
      }
    }
  }
}

// A non-finite A[r, k] (an A entry of pool tile q): in each output tile t
// that reads q, NaN at C[t][r, j] for every column j that B row k of its B
// tile does not hold.  Each block gathers its stride's non-finite entries,
// then writes each one's row with all its threads.  Nothing while A's flag
// is clear.
template <typename T>
__global__ void __launch_bounds__(256) spmm_sb_nan_a_kernel(const SBNan p) {
  if (p.flags[0] == 0) return;
  __shared__ long long s_bad[256];
  __shared__ int s_n;
  T* out = static_cast<T*>(p.out);
  const T nan = from_f32<T>(__int_as_float(0x7fc00000));
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < p.ea; base += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    const long long e = base + threadIdx.x;
    if (e < p.ea && !isfinite(p.aval[e])) s_bad[atomicAdd(&s_n, 1)] = e;
    __syncthreads();
    for (int i = 0; i < s_n; ++i) {
      const long long bad = s_bad[i];
      const long long row = row_of(p.a_rowptr, p.a_rows, bad);
      const int q = static_cast<int>(row / p.R);
      const int r = static_cast<int>(row % p.R);
      const int k = p.a_brow[bad];
      for (int t = 0; t < p.tiles; ++t) {
        if (p.maps[t] != q) continue;
        const long long br =
            static_cast<long long>(p.maps[p.tiles + t]) * p.K + k;
        const long long b_lo = p.b_rowptr[br], b_hi = p.b_rowptr[br + 1];
        T* o = out + (static_cast<long long>(t) * p.R + r) * p.n;
        for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
          long long lo = b_lo, hi = b_hi;       // first entry >= j
          while (lo < hi) {
            const long long mid = (lo + hi) / 2;
            if (p.b_col[mid] < j)
              lo = mid + 1;
            else
              hi = mid;
          }
          if (lo == b_hi || p.b_col[lo] != j) o[j] = nan;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t run_sparse_b(const SBParams& p, const SBNan& nan, const void* b,
                         const long long* a_off, const long long* b_off,
                         float* vals, int* flags, const int* zero_rows,
                         long long n_zero, long long credit,
                         cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return err;
  const long long elems = nan.ea + nan.eb;
  if (elems > 0 || credit > 0) {
    const long long blocks = (elems + 255) / 256;
    spmm_gather_kernel<T><<<static_cast<unsigned>(
                                blocks < 4096 ? (blocks > 0 ? blocks : 1)
                                              : 4096),
                            256, 0, st>>>(
        static_cast<const T*>(nan.a), a_off, nan.ea,
        static_cast<const T*>(b), b_off, nan.eb, vals,
        vals + nan.ea, flags, p.count_blocks, credit);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (!p.accumulate && n_zero > 0) {
    spmm_zero_rows_kernel<T><<<static_cast<unsigned>(n_zero), 256, 0, st>>>(
        zero_rows, n_zero, static_cast<T*>(p.out), p.n, p.vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (p.n_units > 0) {
    spmm_sparse_b_kernel<T>
        <<<static_cast<unsigned>(p.n_units), SB_THREADS, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (nan.eb > 0) {
    spmm_sb_nan_b_kernel<T><<<SB_NAN_BLOCKS, 256, 0, st>>>(nan);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (nan.ea > 0) {
    spmm_sb_nan_a_kernel<T><<<SB_NAN_BLOCKS, 256, 0, st>>>(nan);
    err = cudaGetLastError();
  }
  return err;
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

// The element path (a handle's nonzeros, kernels/bsr_spmm.py::ElementLists):
// a the A pool, read at element offsets; b the B pool [*, K, n]; rowptr
// int64 [P * nbr * bs + 1] and brow int32 / aoff int64 [E]: each pool tile
// row's nonzeros, in the block path's order (real block, then column);
// units int32 [6, n_units] (tile, pool tile, B tile, first row, rows,
// blocks credited to count_blocks); fill int32 [2, n_fill] as
// bsr_spmm_launch's; out [T, nbr * bs, n]; count_blocks and count_elems
// uint64 [1] or null.  The units cover every row of every block-row that a
// real block visits, each once.
extern "C" int bsr_spmm_elem_launch(const void* a, const void* b,
                                    const void* rowptr, const void* brow,
                                    const void* aoff, const void* units,
                                    long long n_units, const void* fill,
                                    long long n_fill, void* out,
                                    void* count_blocks, void* count_elems,
                                    int bs, int nbr, int K, int n,
                                    int accumulate, int dtype, void* stream) {
  if (bs <= 0 || nbr <= 0 || K <= 0 || n <= 0 || K % bs != 0 ||
      n_units < 0 || n_fill < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_fill > INT_MAX || static_cast<long long>(nbr) * bs > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  EParams p;
  p.a = a;
  p.b = b;
  p.rowptr = static_cast<const long long*>(rowptr);
  p.brow = static_cast<const int*>(brow);
  p.aoff = static_cast<const long long*>(aoff);
  p.units = static_cast<const int*>(units);
  p.n_units = n_units;
  p.out = out;
  p.count_blocks = static_cast<unsigned long long*>(count_blocks);
  p.count_elems = static_cast<unsigned long long*>(count_elems);
  p.R = nbr * bs;
  p.K = K;
  p.n = n;
  p.accumulate = accumulate;
  const int elem = dtype == 0 ? 4 : 2;
  p.vec = (n * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* fil = static_cast<const int*>(fill);
  const cudaError_t err =
      dtype == 0 ? run_elem<float>(p, fil, n_fill, bs, nbr, st)
                 : run_elem<bf16>(p, fil, n_fill, bs, nbr, st);
  return static_cast<int>(err);
}

// The element path's non-finite pass, after bsr_spmm_elem_launch on the same
// stream: flag_chunks int32 [2, n_flag] (B tile, block column of every B
// chunk that a real block reads or a skipped entry names, the skipped ones
// first, as skip indexes them); skip int32 [3, n_skip] as
// bsr_spmm_nan_launch's; segs int32 [6, n_segs] and seg_chunks int32 (see
// spmm_zero_nan_kernel); rowptr and brow as bsr_spmm_elem_launch's; counts
// int32 [n_flag, n] and any int32 [1] (workspace).
extern "C" int bsr_spmm_elem_nan_launch(
    const void* b, const void* flag_chunks, long long n_flag, const void* skip,
    long long n_skip, const void* segs, long long n_segs,
    const void* seg_chunks, const void* rowptr, const void* brow, void* counts,
    void* any, void* out, int bs, int nbr, int K, int n, int dtype,
    void* stream) {
  if (bs <= 0 || nbr <= 0 || K <= 0 || n <= 0 || K % bs != 0 ||
      n_flag < 0 || n_skip < 0 || n_segs < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_flag == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* fc = static_cast<const int*>(flag_chunks);
  const int* sk = static_cast<const int*>(skip);
  const int* sg = static_cast<const int*>(segs);
  const int* sc = static_cast<const int*>(seg_chunks);
  const long long* rp = static_cast<const long long*>(rowptr);
  const int* br = static_cast<const int*>(brow);
  int* cn = static_cast<int*>(counts);
  int* an = static_cast<int*>(any);
  const cudaError_t err =
      dtype == 0
          ? elem_nan_pass<float>(static_cast<const float*>(b), fc, n_flag, sk,
                                 n_skip, sg, n_segs, sc, rp, br, cn, an,
                                 static_cast<float*>(out), bs, nbr, K, n, st)
          : elem_nan_pass<bf16>(static_cast<const bf16*>(b), fc, n_flag, sk,
                                n_skip, sg, n_segs, sc, rp, br, cn, an,
                                static_cast<bf16*>(out), bs, nbr, K, n, st);
  return static_cast<int>(err);
}

// The sparse-B path (kernels/bsr_spmm.py::SparseBTable), one launch: a the
// A pool (bs x bs blocks), b the B pool, both in `dtype`; A's lists
// a_rowptr int64 [a_rows + 1], a_brow int32 and a_off int64 [ea]; B's
// b_rowptr [b_rows + 1], b_col int32 and b_off int64 [eb], each row sorted
// by column; windows int32 [b_rows, ceil(n / window) + 1]; units int32 [5,
// n_units]; zero_rows int32 [n_zero] (tile * R + row), zeroed unless
// accumulate; maps int32 [2, T]; colptr int32 [T * span + 1] and col_ent
// int32 [2, n_col]; vals float32 [ea + eb] and flags int32 [2] (workspace);
// out [T, R, n]; count_blocks uint64 [1] or null, to which the units'
// credits and `credit` are added.  `window` must be the kernel's
// SB_WINDOW.  All contiguous on one device.
extern "C" int bsr_spmm_sparse_b_launch(
    const void* a, const void* b, const void* a_rowptr, const void* a_brow,
    const void* a_off, long long ea, long long a_rows, const void* b_rowptr,
    const void* b_col, const void* b_off, long long eb, long long b_rows,
    const void* windows, const void* units, long long n_units,
    const void* zero_rows, long long n_zero, const void* maps,
    const void* colptr, const void* col_ent, long long n_col, void* vals,
    void* flags, void* out, void* count_blocks, long long credit, int T,
    int span, int bs, int R, int K, int n, int window, int accumulate,
    int dtype, void* stream) {
  if (bs <= 0 || R <= 0 || K <= 0 || n <= 0 || T <= 0 || span <= 0 ||
      ea < 0 || eb < 0 || n_units < 0 || n_zero < 0 || n_col < 0 ||
      a_rows <= 0 || b_rows <= 0 || window != SB_WINDOW ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_units > INT_MAX || n_zero > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int elem = dtype == 0 ? 4 : 2;
  SBParams p;
  p.aval = static_cast<const float*>(vals);
  p.a_rowptr = static_cast<const long long*>(a_rowptr);
  p.a_brow = static_cast<const int*>(a_brow);
  p.bval = static_cast<const float*>(vals) + ea;
  p.b_rowptr = static_cast<const long long*>(b_rowptr);
  p.b_col = static_cast<const int*>(b_col);
  p.windows = static_cast<const int*>(windows);
  p.units = static_cast<const int*>(units);
  p.n_units = n_units;
  p.maps = static_cast<const int*>(maps);
  p.out = out;
  p.count_blocks = static_cast<unsigned long long*>(count_blocks);
  p.tiles = T;
  p.R = R;
  p.K = K;
  p.n = n;
  p.nwin = (n + SB_WINDOW - 1) / SB_WINDOW;
  p.accumulate = accumulate;
  p.vec = (n * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  SBNan nan;
  nan.a = a;
  nan.a_rowptr = p.a_rowptr;
  nan.a_brow = p.a_brow;
  nan.aval = p.aval;
  nan.ea = ea;
  nan.a_rows = a_rows;
  nan.b_rowptr = p.b_rowptr;
  nan.b_col = p.b_col;
  nan.bval = p.bval;
  nan.eb = eb;
  nan.b_rows = b_rows;
  nan.maps = p.maps;
  nan.colptr = static_cast<const int*>(colptr);
  nan.col_ent = static_cast<const int*>(col_ent);
  nan.n_col = n_col;
  nan.flags = static_cast<const int*>(flags);
  nan.out = out;
  nan.tiles = T;
  nan.span = span;
  nan.bs = bs;
  nan.R = R;
  nan.K = K;
  nan.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ao = static_cast<const long long*>(a_off);
  const long long* bo = static_cast<const long long*>(b_off);
  float* v = static_cast<float*>(vals);
  int* fl = static_cast<int*>(flags);
  const int* zr = static_cast<const int*>(zero_rows);
  const cudaError_t err =
      dtype == 0 ? run_sparse_b<float>(p, nan, b, ao, bo, v, fl, zr, n_zero,
                                       credit, st)
                 : run_sparse_b<bf16>(p, nan, b, ao, bo, v, fl, zr, n_zero,
                                      credit, st);
  return static_cast<int>(err);
}
