// Block-pair products reduced by output block, for Hopper (sm_90a),
// batched over tiles.
//
//   C[t, slot(p)] (+)= sum over pairs p of tile t of  A[t, pa[t,p]] @ B[t, pb[t,p]]
//
// One source serves two TPU kernels of src/repro/kernels/bsr_spmm.py:
//
// * bsr_pair_accumulate_pallas (body _pair_acc_kernel), the numeric phase
//   of sparse-output SpGEMM: slot(p) = ps[p], output [T, n_slots, bs, bs]
//   (packed C blocks), optionally added into a float32 carry;
// * bsr_pair_matmul_pallas (body _pair_kernel), the dense-tile SpGEMM:
//   slot(p) = pr[p] * nbc + pc[p], output the dense [T, nbr*bs, nbc*bs]
//   tile, block (r, c) at rows r*bs.., columns c*bs...
//
// The TPU kernels walk the pair list as a sequential grid axis and zero an
// output block on its first visit.  Hopper blocks run in no order, so the
// work is cut by output segment instead (a run of equal slots; the lists
// are sorted by slot).  The wrapper builds the cut on the host, once per
// pair list (kernels/bsr_pair.py::pair_table): each segment is cut into
// chunks, and a chunk table row is (tile, first pair, end pair, slot,
// part).  part = -1 marks a segment's only chunk, whose thread block
// stores C itself; the chunks of a longer segment store float32 partials
// into a workspace sized to those chunks alone, and a second pass sums
// each such segment's partials in chunk order and stores C.  No atomics:
// the result does not depend on the order in which blocks ran, and each
// output element is written by one thread.  With `accumulate` the stored
// value is carry + segment sum, the carry read once: the reference's
// `c + step` in the same order, without a step buffer.
//
// Why chunks: the symbolic phase pads every pair list with inert pairs that
// all land on the last slot, so one segment of a light tile holds ~2 M
// pairs at the main path's size.  One thread block per segment would leave
// it running alone on one SM.
//
// What bounds it on an H100: each pair is 2*bs^3 flops on 2*bs^2 loaded
// elements, so in float32 the CUDA cores' FMA rate bounds it (67 TFLOP/s;
// IEEE float32 as the reference, no tensor cores); the f32 partials and C
// store are bs^2 per segment.  The design stages both blocks of a pair in
// shared memory (A transposed, k-major) and gives each thread a TM x TN
// register tile.  Not done yet: skipping the inert pairs (82 % of the pairs
// at the main size), tensor cores for bf16, TMA and a pipelined ring.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, loaded with
// ctypes (repro_torch/kernels/loader.py).  Plain C interface; returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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

// One thread block per (chunk, output sub-tile): a BM x BN part of one
// bs x bs output block, BK-deep slabs, TM x TN outputs per thread.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    pair_chunk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int* __restrict__ pa, const int* __restrict__ pb,
                      const int* __restrict__ chunks, long long n_chunks,
                      float* __restrict__ out, float* __restrict__ partial,
                      int Sa, int Sb, int P, int bs, int n_slots, int nbc,
                      int col_parts, int accumulate) {
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0,
                "every thread stages the same number of slab elements");
  // +4 keeps rows 16-byte aligned and spreads the banks of the
  // transposing store
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const long long ch = blockIdx.x;
  const int t = chunks[ch];
  const int p0 = chunks[n_chunks + ch];
  const int p1 = chunks[2 * n_chunks + ch];
  const int slot = chunks[3 * n_chunks + ch];
  const int part = chunks[4 * n_chunks + ch];
  const int m0 = (blockIdx.y / col_parts) * BM;
  const int j0 = (blockIdx.y % col_parts) * BN;

  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const long long bsq = static_cast<long long>(bs) * bs;
  const int* tpa = pa + static_cast<long long>(t) * P;
  const int* tpb = pb + static_cast<long long>(t) * P;
  const T* ta = a + static_cast<long long>(t) * Sa * bsq;
  const T* tb = b + static_cast<long long>(t) * Sb * bsq;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int p = p0; p < p1; ++p) {
    const T* ab = ta + static_cast<long long>(tpa[p]) * bsq;
    const T* bb = tb + static_cast<long long>(tpb[p]) * bsq;
    for (int k0 = 0; k0 < bs; k0 += BK) {
#pragma unroll
      for (int it = 0; it < BM * BK / NT; ++it) {
        const int e = tid + it * NT;
        const int m = e / BK, k = e % BK;
        const int gm = m0 + m, gk = k0 + k;
        As[k][m] = (gm < bs && gk < bs) ? load_f32(ab + gm * bs + gk) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < BK * BN / NT; ++it) {
        const int e = tid + it * NT;
        const int k = e / BN, j = e % BN;
        const int gk = k0 + k, gj = j0 + j;
        Bs[k][j] = (gk < bs && gj < bs) ? load_f32(bb + gk * bs + gj) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float af[TM], bf[TN];
        if constexpr (TM % 4 == 0 && TN % 4 == 0) {
#pragma unroll
          for (int i = 0; i < TM; i += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(&As[k][ty * TM + i]);
            af[i] = v.x; af[i + 1] = v.y; af[i + 2] = v.z; af[i + 3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(&Bs[k][tx * TN + j]);
            bf[j] = v.x; bf[j + 1] = v.y; bf[j + 2] = v.z; bf[j + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) af[i] = As[k][ty * TM + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) bf[j] = Bs[k][tx * TN + j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // a segment's only chunk stores C; the chunks of a longer segment store
  // their partial, which the reduce pass sums
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= bs) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = j0 + tx * TN + j;
      if (gj >= bs) continue;
      if (part < 0) {
        float* o = out + out_offset(t, slot, gm, gj, bs, n_slots, nbc);
        *o = accumulate ? *o + acc[i][j] : acc[i][j];
      } else {
        partial[static_cast<long long>(part) * bsq + gm * bs + gj] =
            acc[i][j];
      }
    }
  }
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

template <typename T, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const void* a, const void* b, const void* pa,
                   const void* pb, const void* chunks, long long n_chunks,
                   const void* reduce, long long n_reduce, void* partial,
                   void* out, int Sa, int Sb, int P, int bs, int n_slots,
                   int nbc, int accumulate, cudaStream_t stream) {
  const int row_parts = (bs + BM - 1) / BM;
  const int col_parts = (bs + BN - 1) / BN;
  if (n_chunks > INT_MAX || n_reduce > INT_MAX ||
      row_parts * col_parts > 65535)
    return cudaErrorInvalidConfiguration;
  if (n_chunks > 0) {
    pair_chunk_kernel<T, BM, BN, BK, TM, TN>
        <<<dim3(static_cast<unsigned>(n_chunks), row_parts * col_parts),
           (BM / TM) * (BN / TN), 0, stream>>>(
            static_cast<const T*>(a), static_cast<const T*>(b),
            static_cast<const int*>(pa), static_cast<const int*>(pb),
            static_cast<const int*>(chunks), n_chunks,
            static_cast<float*>(out), static_cast<float*>(partial), Sa, Sb,
            P, bs, n_slots, nbc, col_parts, accumulate);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_reduce > 0) {
    pair_reduce_kernel<<<static_cast<unsigned>(n_reduce), 256, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<const int*>(reduce),
        n_reduce, static_cast<float*>(out), bs, n_slots, nbc, accumulate);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* b, const void* pa,
                     const void* pb, const void* chunks, long long n_chunks,
                     const void* reduce, long long n_reduce, void* partial,
                     void* out, int Sa, int Sb, int P, int bs, int n_slots,
                     int nbc, int accumulate, cudaStream_t stream) {
  // one tile shape per range of bs; a larger bs takes several sub-tiles
  if (bs <= 8)
    return launch<T, 8, 8, 8, 1, 1>(a, b, pa, pb, chunks, n_chunks, reduce,
                                    n_reduce, partial, out, Sa, Sb, P, bs,
                                    n_slots, nbc, accumulate, stream);
  if (bs <= 16)
    return launch<T, 16, 16, 16, 2, 2>(a, b, pa, pb, chunks, n_chunks,
                                       reduce, n_reduce, partial, out, Sa,
                                       Sb, P, bs, n_slots, nbc, accumulate,
                                       stream);
  if (bs <= 32)
    return launch<T, 32, 32, 32, 4, 4>(a, b, pa, pb, chunks, n_chunks,
                                       reduce, n_reduce, partial, out, Sa,
                                       Sb, P, bs, n_slots, nbc, accumulate,
                                       stream);
  return launch<T, 64, 64, 16, 4, 4>(a, b, pa, pb, chunks, n_chunks, reduce,
                                     n_reduce, partial, out, Sa, Sb, P, bs,
                                     n_slots, nbc, accumulate, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a and b both of it; out and partial are
// float32).  a [T, Sa, bs, bs], b [T, Sb, bs, bs], pa and pb int32 [T, P],
// chunks int32 [5, n_chunks] (tile, first pair, end pair, slot, part),
// reduce int32 [4, n_reduce] (tile, slot, first part, parts), partial
// float32 [parts, bs, bs] (workspace), out float32 [T, n_slots, bs, bs]
// (nbc == 0) or [T, nbr*bs, nbc*bs] with n_slots = nbr*nbc (nbc > 0); all
// contiguous on one device.  accumulate != 0 adds into out.
extern "C" int bsr_pair_launch(const void* a, const void* b, const void* pa,
                               const void* pb, const void* chunks,
                               long long n_chunks, const void* reduce,
                               long long n_reduce, void* partial, void* out,
                               int T_, int Sa, int Sb, int P, int bs,
                               int n_slots, int nbc, int accumulate,
                               int dtype, void* stream) {
  if (T_ <= 0 || Sa <= 0 || Sb <= 0 || P < 0 || bs <= 0 || n_slots <= 0 ||
      nbc < 0 || (nbc > 0 && n_slots % nbc != 0) || n_chunks < 0 ||
      n_reduce < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(a, b, pa, pb, chunks, n_chunks, reduce, n_reduce,
                          partial, out, Sa, Sb, P, bs, n_slots, nbc,
                          accumulate, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(a, b, pa, pb, chunks, n_chunks, reduce,
                                  n_reduce, partial, out, Sa, Sb, P, bs,
                                  n_slots, nbc, accumulate, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
