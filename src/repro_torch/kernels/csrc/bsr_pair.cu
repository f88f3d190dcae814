// Block-pair products reduced by output block, for Hopper (sm_90a),
// batched over tiles.
//
//   C[t, slot(p)] (+)= sum over the real pairs p of tile t of
//                      A[t, pa[t,p]] @ B[t, pb[t,p]]
//
// One source serves two TPU kernels of src/repro/kernels/bsr_spmm.py:
//
// * bsr_pair_accumulate_pallas (body _pair_acc_kernel), the numeric phase
//   of sparse-output SpGEMM: slot(p) = ps[p], output [T, n_slots, bs, bs]
//   (packed C blocks), fresh or added in place into a float32 carry;
// * bsr_pair_matmul_pallas (body _pair_kernel), the dense-tile SpGEMM:
//   slot(p) = pr[p] * nbc + pc[p], output the dense [T, nbr*bs, nbc*bs]
//   tile, block (r, c) at rows r*bs.., columns c*bs...
//
// What bounds the work on an H100.  A real pair is 2*bs^3 flops on two
// gathered bs x bs blocks: at bs 32 float32, 64 KFLOP on 8 KB, below the
// card's ~20 flop/byte balance for the CUDA cores, so the gathers must come
// from L2, not HBM; in bf16 on the tensor cores the flops are cheap and the
// gathers and the output store bound it.  The output of sparse-output
// SpGEMM is a packed store far larger than the real pairs' work (7.55 GB at
// the main size), so writing it once is the floor.
//
// What the design does about that:
//
// * Only real pairs are multiplied.  The wrapper's table (kernels/
//   bsr_pair.py::pair_table, built on the host once per pair list, at plan
//   time) lists the real pairs' positions (pidx) and cuts them into chunks
//   of one output segment (a run of equal slot), each chunk a row (tile,
//   first, end, slot, part) over pidx.  Inert pairs (both blocks the
//   operands' guaranteed-zero slots) never reach the kernel.  A fresh
//   output zero-fills the slots that no real pair visits (pair_fill_kernel,
//   a list of slot runs); an accumulate touches only the visited slots and
//   leaves the rest of the carry untouched.  So the store is written once.
// * Short segments (about 2 real pairs at the main size): one warp per
//   chunk (per 32x32 sub-tile of the output block for bs > 32), in a
//   persistent grid of WARPS independent warps per block.  Each warp walks
//   its chunks as a stream of units (a pair's k-slab) and copies unit n+1..
//   into its own shared-memory ring with cp.async while unit n multiplies;
//   no block-wide barrier.  A chunk's pair indices are loaded once, one per
//   lane, and handed out by shuffles.
// * L2 order: warp w of the grid takes chunks w, w + W, w + 2W, ... (W =
//   warps in the grid), so the ~W chunks in flight are neighbouring slots
//   of one tile: neighbouring output blocks of a few C block-rows, which
//   share their A blocks and reuse B blocks while they stay in the 50 MB L2.
// * bf16 with bs a multiple of 16 runs on the tensor cores: mma.sync
//   m16n8k16 (bf16 in, float32 accumulate) fed by ldmatrix from the padded
//   ring.  float32 stays IEEE on the CUDA cores (FMA): TF32 would break the
//   reference's 1e-5.  Other block sizes (the tests' 4 and 8, ragged ones)
//   run the SIMT variant, bf16 widened as it is read; a unit that the block
//   does not fill is zero-padded in shared memory.
// * Sums inside a segment stay in pair order, in float32.  A segment longer
//   than one chunk stores ordered float32 partials (workspace sized to those
//   chunks alone) that pair_reduce_kernel sums in chunk order: no atomics on
//   the output, so the result does not depend on the order in which warps
//   ran.  With `accumulate` a slot's stored value is carry + segment sum,
//   the carry read once (the JAX bodies' c + step).  Every output and
//   partial offset is 64-bit (the C store holds 1.89 G elements).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, loaded with
// ctypes (repro_torch/kernels/loader.py).  Plain C interface; returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

#include "mma_fragments.cuh"  // cp.async ring, bf16 reads, mma.sync fragments

namespace {

constexpr int WARPS = 4;                 // independent warps per block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* a;
  const void* b;
  const int* pa;
  const int* pb;
  const int* pidx;
  const int* chunks;
  long long n_chunks;
  float* out;
  float* partial;
  unsigned long long* count;
  int Sa, Sb, P, bs, n_slots, nbc, accumulate;
  int nsb;  // sub-tiles per side of an output block
  int nk;   // k-slabs per pair
};

// Offset of element (i, j) of output block `slot` of tile t.  nbc == 0:
// packed slots [T, n_slots, bs, bs]; nbc > 0: a dense [T, nbr*bs, nbc*bs]
// tile with n_slots = nbr * nbc and slot = r * nbc + c.
__device__ __forceinline__ long long out_offset(int t, int slot, int i, int j,
                                                int bs, int n_slots,
                                                int nbc) {
  const long long tile = static_cast<long long>(t) * n_slots * bs * bs;
  if (nbc == 0)
    return tile + (static_cast<long long>(slot) * bs + i) * bs + j;
  const int r = slot / nbc, c = slot % nbc;
  return tile + (static_cast<long long>(r) * bs + i) * nbc * bs +
         static_cast<long long>(c) * bs + j;
}

// Copy the TR x TC window at (r0, c0) of a row-major bs x bs block into a
// shared tile with row stride LD, VEC bytes a copy, one warp; positions
// outside the block are zero.  (bs * sizeof(T)) % VEC == 0 and c0 is a
// multiple of TC, so a copy never straddles the block's edge.
template <typename T, int TR, int TC, int LD, int VEC>
__device__ __forceinline__ void stage(T* dst, const T* blk, int bs, int r0,
                                      int c0, int lane) {
  constexpr int E = VEC / static_cast<int>(sizeof(T));
  constexpr int CPR = TC / E;
  const int rows = min(TR, bs - r0), cols = min(TC, bs - c0);
#pragma unroll
  for (int i = lane; i < TR * CPR; i += 32) {
    const int r = i / CPR, c = (i % CPR) * E;
    T* d = dst + r * LD + c;
    if (r < rows && c < cols)
      copy_async<VEC>(d, blk + static_cast<long long>(r0 + r) * bs + c0 + c);
    else
      zero_vec<VEC>(d);
  }
}

// ---------------------------------------------------------------------------
// the two multiply variants: a C x C warp tile per unit
// ---------------------------------------------------------------------------
// SIMT (CUDA cores, float32 FMA): lane (ly, lx) = (lane / 4, lane % 4) owns
// rows ly + 8 i (interleaved, so the A reads of one k hit 8 distinct bank
// groups) and the RN adjacent columns lx * RN...
template <typename T, int C>
struct Simt {
  using Elem = T;
  static constexpr int TM = C, TN = C, BK = C;
  static constexpr int LD = C + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int A_ELEMS = TM * LD, B_ELEMS = BK * LD;
  static constexpr int STAGES = (sizeof(T) == 4 && C == 32) ? 2 : 3;
  static constexpr int RM = C / 8, RN = C / 4;
  float acc[RM][RN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const T* As, const T* Bs, int lane) {
    const int ly = lane >> 2, lx = lane & 3;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float a[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) load_n<4>(As + (ly + 8 * i) * LD + k, a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[RN];
        load_n<RN>(Bs + (k + kk) * LD + lx * RN, b);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }

  template <class F>
  __device__ __forceinline__ void for_each_pair(int lane, F f) const {
    const int ly = lane >> 2, lx = lane & 3;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; j += 2)
        f(ly + 8 * i, lx * RN + j, acc[i][j], acc[i][j + 1]);
  }
};

// Tensor cores (bf16 in, float32 accumulate): a TW x TW warp tile of
// m16n8k16 products; A fragments by ldmatrix from the row-major A tile, B
// fragments by ldmatrix.trans from the row-major (k-major) B tile.  Rows of
// TW + 8 bf16 keep the eight row addresses of each 8x8 matrix on distinct
// banks.
template <int TW>
struct Mma {
  using Elem = bf16;
  static constexpr int TM = TW, TN = TW, BK = TW, LD = TW + 8;
  static constexpr int A_ELEMS = TM * LD, B_ELEMS = BK * LD;
  static constexpr int STAGES = 3;
  static constexpr int MT = TW / 16, NT = TW / 8;
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
                                      int lane) {
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16)
      mma_k16<MT, NT>(acc, As + ks, LD, Bs + ks * LD, LD, lane);
  }

  template <class F>
  __device__ __forceinline__ void for_each_pair(int lane, F f) const {
    mma_for_each_pair<MT, NT>(acc, lane, f);
  }
};

// ---------------------------------------------------------------------------
// the persistent pair kernel
// ---------------------------------------------------------------------------
struct Walk {           // where a warp is in its stream of units
  long long task;       // chunk * nsub + sub; >= n_tasks when done
  int q, q0, q1, ks;    // pair (index into pidx) and k-slab
  int tile, sub;
};

struct Grid {
  long long n_tasks, stride;
  int nsub;
};

// Open task `task`: the chunk's tile and pair range, and (for the load
// walk) the pair indices q0.. q0+31, one per lane.
__device__ __forceinline__ void walk_open(Walk& w, const Params& p,
                                          const Grid& g, long long task) {
  w.task = task;
  if (task >= g.n_tasks) return;
  const long long ch = task / g.nsub;
  w.sub = static_cast<int>(task - ch * g.nsub);
  w.tile = p.chunks[ch];
  w.q = w.q0 = p.chunks[p.n_chunks + ch];
  w.q1 = p.chunks[2 * p.n_chunks + ch];
  w.ks = 0;
}

__device__ __forceinline__ void fetch_pairs(const Params& p, int tile,
                                            int base, int q1, int lane,
                                            int& ia, int& ib) {
  ia = ib = 0;
  const int q = base + lane;
  if (q < q1) {
    const long long pair = static_cast<long long>(tile) * p.P + p.pidx[q];
    ia = p.pa[pair];
    ib = p.pb[pair];
  }
}

template <class Op, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
    pair_kernel(const Params p) {
  using T = typename Op::Elem;
  constexpr int STAGE = Op::A_ELEMS + Op::B_ELEMS;
  constexpr int S = Op::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * S * STAGE;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  const long long bsq = static_cast<long long>(p.bs) * p.bs;
  Grid g;
  g.nsub = p.nsb * p.nsb;
  g.n_tasks = p.n_chunks * g.nsub;
  g.stride = static_cast<long long>(gridDim.x) * WARPS;
  const long long first = static_cast<long long>(blockIdx.x) * WARPS + warp;

  Walk ld, cw;                 // the load walk runs S - 1 units ahead
  walk_open(ld, p, g, first);
  walk_open(cw, p, g, first);
  int base = 0, ia_l = 0, ib_l = 0;
  if (ld.task < g.n_tasks) {
    base = ld.q0;
    fetch_pairs(p, ld.tile, base, ld.q1, lane, ia_l, ib_l);
  }

  auto load_unit = [&](int s) {  // copy the load walk's unit into stage s
    const int ia = __shfl_sync(FULL, ia_l, ld.q - base);
    const int ib = __shfl_sync(FULL, ib_l, ld.q - base);
    const T* ablk = A + (static_cast<long long>(ld.tile) * p.Sa + ia) * bsq;
    const T* bblk = B + (static_cast<long long>(ld.tile) * p.Sb + ib) * bsq;
    const int sm = ld.sub / p.nsb, sn = ld.sub % p.nsb;
    const int k0 = ld.ks * Op::BK;
    T* st = ring + s * STAGE;
    stage<T, Op::TM, Op::BK, Op::LD, VEC>(st, ablk, p.bs, sm * Op::TM, k0,
                                          lane);
    stage<T, Op::BK, Op::TN, Op::LD, VEC>(st + Op::A_ELEMS, bblk, p.bs, k0,
                                          sn * Op::TN, lane);
    // advance the load walk by one unit
    if (++ld.ks < p.nk) return;
    ld.ks = 0;
    if (++ld.q < ld.q1) {
      if (ld.q - base == 32) {            // a chunk longer than 32 pairs
        base = ld.q;
        fetch_pairs(p, ld.tile, base, ld.q1, lane, ia_l, ib_l);
      }
      return;
    }
    walk_open(ld, p, g, ld.task + g.stride);
    if (ld.task < g.n_tasks) {
      base = ld.q0;
      fetch_pairs(p, ld.tile, base, ld.q1, lane, ia_l, ib_l);
    }
  };

  Op op;
  op.zero();
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (ld.task < g.n_tasks) load_unit(s);
    cp_commit();
  }
  unsigned long long pairs = 0;
  int cur = 0;
  while (cw.task < g.n_tasks) {
    if (ld.task < g.n_tasks) load_unit((cur + S - 1) % S);
    cp_commit();
    cp_wait<S - 1>();          // this lane's copies of unit `cur` landed
    __syncwarp();              // ... and every lane's
    op.mma(ring + cur * STAGE, ring + cur * STAGE + Op::A_ELEMS, lane);
    __syncwarp();              // the stage may be refilled from here on
    cur = (cur + 1) % S;
    if (++cw.ks < p.nk) continue;
    cw.ks = 0;
    if (++cw.q < cw.q1) continue;
    // the task's last unit: a segment's only chunk stores C (carry + sum
    // with accumulate); the chunks of a longer segment store partials
    const long long ch = cw.task / g.nsub;
    const int slot = p.chunks[3 * p.n_chunks + ch];
    const int part = p.chunks[4 * p.n_chunks + ch];
    const int m0 = (cw.sub / p.nsb) * Op::TM, n0 = (cw.sub % p.nsb) * Op::TN;
    if (cw.sub == 0) pairs += static_cast<unsigned long long>(cw.q1 - cw.q0);
    const bool add = part < 0 && p.accumulate;
    op.for_each_pair(lane, [&](int r, int c, float v0, float v1) {
      const int gr = m0 + r, gc = n0 + c;
      if (gr >= p.bs || gc >= p.bs) return;
      const bool two = gc + 1 < p.bs;
      float* o = part < 0
                     ? p.out + out_offset(cw.tile, slot, gr, gc, p.bs,
                                          p.n_slots, p.nbc)
                     : p.partial + static_cast<long long>(part) * bsq +
                           static_cast<long long>(gr) * p.bs + gc;
      if (two && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
        float2 x = make_float2(v0, v1);
        if (add) {
          const float2 y = *reinterpret_cast<const float2*>(o);
          x.x = y.x + v0;
          x.y = y.y + v1;
        }
        *reinterpret_cast<float2*>(o) = x;
      } else {
        o[0] = add ? o[0] + v0 : v0;
        if (two) o[1] = add ? o[1] + v1 : v1;
      }
    });
    op.zero();
    walk_open(cw, p, g, cw.task + g.stride);
  }
  cp_wait<0>();
  if (p.count != nullptr && lane == 0 && pairs > 0) atomicAdd(p.count, pairs);
}

// C[tile, slot] (+)= the segment's partials, summed in chunk order.  One
// thread block per multi-chunk segment; reduce rows are (tile, slot, first
// part, number of parts).
__global__ void __launch_bounds__(256)
    pair_reduce_kernel(const float* __restrict__ partial,
                       const int* __restrict__ reduce, long long n_reduce,
                       float* __restrict__ out, int bs, int n_slots, int nbc,
                       int accumulate) {
  const long long r = blockIdx.x;
  const int t = reduce[r];
  const int slot = reduce[n_reduce + r];
  const long long first = reduce[2 * n_reduce + r];
  const int n_parts = reduce[3 * n_reduce + r];
  const long long bsq = static_cast<long long>(bs) * bs;
  for (int e = threadIdx.x; e < bsq; e += blockDim.x) {
    const float* p = partial + first * bsq + e;
    float sum = 0.f;
    for (int c = 0; c < n_parts; ++c) sum += p[c * bsq];
    float* o = out + out_offset(t, slot, e / bs, e % bs, bs, n_slots, nbc);
    *o = accumulate ? *o + sum : sum;
  }
}

// Zero the slots that no real pair visits (a fresh output only): one
// thread block per fill row (tile, first slot, number of slots).
__global__ void __launch_bounds__(256)
    pair_fill_kernel(const int* __restrict__ fill, long long n_fill,
                     float* __restrict__ out, int bs, int n_slots, int nbc) {
  const long long r = blockIdx.x;
  const int t = fill[r];
  const int s0 = fill[n_fill + r];
  const int n = fill[2 * n_fill + r];
  const long long bsq = static_cast<long long>(bs) * bs;
  const long long len = n * bsq;
  if (nbc == 0) {              // the run's slots are one contiguous range
    float* o = out + (static_cast<long long>(t) * n_slots + s0) * bsq;
    if ((len & 3) == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      float4* o4 = reinterpret_cast<float4*>(o);
      for (long long e = threadIdx.x; e < len / 4; e += blockDim.x)
        o4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (long long e = threadIdx.x; e < len; e += blockDim.x) o[e] = 0.f;
    }
  } else {
    for (long long e = threadIdx.x; e < len; e += blockDim.x) {
      const int s = s0 + static_cast<int>(e / bsq);
      const int w = static_cast<int>(e % bsq);
      out[out_offset(t, s, w / bs, w % bs, bs, n_slots, nbc)] = 0.f;
    }
  }
}

template <class Op, int VEC>
cudaError_t launch_pairs(const Params& p, cudaStream_t stream) {
  auto kern = pair_kernel<Op, VEC>;
  const int smem = WARPS * Op::STAGES * (Op::A_ELEMS + Op::B_ELEMS) *
                   static_cast<int>(sizeof(typename Op::Elem));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, WARPS * 32, smem)) != cudaSuccess)
    return err;
  const long long tasks = p.n_chunks * p.nsb * p.nsb;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (tasks + WARPS - 1) / WARPS;
  if (need < blocks) blocks = need;
  kern<<<static_cast<unsigned>(blocks), WARPS * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class Op>
cudaError_t launch_vec(const Params& p, int vec, cudaStream_t stream) {
  if (vec == 16) return launch_pairs<Op, 16>(p, stream);
  if (vec == 4) return launch_pairs<Op, 4>(p, stream);
  if constexpr (sizeof(typename Op::Elem) == 2) {
    if (vec == 2) return launch_pairs<Op, 2>(p, stream);
  }
  return cudaErrorInvalidValue;
}

// 1: tensor cores (bf16, bs a multiple of 16); 0: the SIMT variant
int path_of(int bs, int dtype) { return dtype == 1 && bs % 16 == 0 ? 1 : 0; }

// The widest copy that the block rows and both operands' addresses allow.
int vec_of(int bs, int elem, const void* a, const void* b) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  for (int v : {16, 4, 2})
    if (v >= elem && (bs * elem) % v == 0 && pa % v == 0 && pb % v == 0)
      return v;
  return 0;
}

template <typename T>
cudaError_t dispatch(Params& p, int dtype, cudaStream_t stream) {
  const int vec = vec_of(p.bs, static_cast<int>(sizeof(T)), p.a, p.b);
  if (vec == 0) return cudaErrorMisalignedAddress;
  if constexpr (sizeof(T) == 2) {
    if (path_of(p.bs, dtype) == 1) {
      const int tw = p.bs == 16 ? 16 : 32;
      p.nsb = p.nk = (p.bs + tw - 1) / tw;
      return tw == 16 ? launch_vec<Mma<16>>(p, vec, stream)
                      : launch_vec<Mma<32>>(p, vec, stream);
    }
  }
  const int c = p.bs <= 8 ? 8 : p.bs <= 16 ? 16 : 32;
  p.nsb = p.nk = (p.bs + c - 1) / c;
  if (c == 8) return launch_vec<Simt<T, 8>>(p, vec, stream);
  if (c == 16) return launch_vec<Simt<T, 16>>(p, vec, stream);
  return launch_vec<Simt<T, 32>>(p, vec, stream);
}

}  // namespace

// Which multiply a launch of this block size and type runs: 1 = tensor
// cores (mma.sync m16n8k16), 0 = CUDA cores (SIMT float32 FMA).
extern "C" int bsr_pair_path(int bs, int dtype) { return path_of(bs, dtype); }

// dtype: 0 = float32, 1 = bfloat16 (a and b both of it; out and partial are
// float32).  a [T, Sa, bs, bs], b [T, Sb, bs, bs], pa and pb int32 [T, P];
// pidx int32 [Q], the real pairs' positions in their tile's list; chunks
// int32 [5, n_chunks] (tile, first, end into pidx, slot, part); reduce
// int32 [4, n_reduce] (tile, slot, first part, parts); fill int32 [3,
// n_fill] (tile, first slot, slots), zeroed unless accumulate; partial
// float32 [parts, bs, bs] (workspace); out float32 [T, n_slots, bs, bs]
// (nbc == 0) or [T, nbr*bs, nbc*bs] with n_slots = nbr*nbc (nbc > 0);
// count uint64 [1] or null: the pairs multiplied are added to it.  All
// contiguous on one device.  accumulate != 0 adds into out in place,
// touching only the slots that the chunks name.
extern "C" int bsr_pair_launch(const void* a, const void* b, const void* pa,
                               const void* pb, const void* pidx,
                               const void* chunks, long long n_chunks,
                               const void* reduce, long long n_reduce,
                               const void* fill, long long n_fill,
                               void* partial, void* out, void* count, int T_,
                               int Sa, int Sb, int P, int bs, int n_slots,
                               int nbc, int accumulate, int dtype,
                               void* stream) {
  if (T_ <= 0 || Sa <= 0 || Sb <= 0 || P < 0 || bs <= 0 || n_slots <= 0 ||
      nbc < 0 || (nbc > 0 && n_slots % nbc != 0) || n_chunks < 0 ||
      n_reduce < 0 || n_fill < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks > INT_MAX || n_reduce > INT_MAX || n_fill > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (!accumulate && n_fill > 0) {
    pair_fill_kernel<<<static_cast<unsigned>(n_fill), 256, 0, st>>>(
        static_cast<const int*>(fill), n_fill, static_cast<float*>(out), bs,
        n_slots, nbc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (n_chunks > 0) {
    Params p;
    p.a = a;
    p.b = b;
    p.pa = static_cast<const int*>(pa);
    p.pb = static_cast<const int*>(pb);
    p.pidx = static_cast<const int*>(pidx);
    p.chunks = static_cast<const int*>(chunks);
    p.n_chunks = n_chunks;
    p.out = static_cast<float*>(out);
    p.partial = static_cast<float*>(partial);
    p.count = static_cast<unsigned long long*>(count);
    p.Sa = Sa;
    p.Sb = Sb;
    p.P = P;
    p.bs = bs;
    p.n_slots = n_slots;
    p.nbc = nbc;
    p.accumulate = accumulate;
    p.nsb = p.nk = 1;
    err = dtype == 0 ? dispatch<float>(p, dtype, st)
                     : dispatch<bf16>(p, dtype, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_reduce > 0) {
    pair_reduce_kernel<<<static_cast<unsigned>(n_reduce), 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<const int*>(reduce),
        n_reduce, static_cast<float*>(out), bs, n_slots, nbc, accumulate);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
