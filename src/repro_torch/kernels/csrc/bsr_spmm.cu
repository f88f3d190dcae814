// Block-sparse x dense multiply for Hopper (sm_90a), batched over tiles.
//
//   C[t, rows[t,s]*bs : +bs, :] += blocks[t,s] @ dense[t, cols[t,s]*bs : +bs, :]
//
// Replaces the TPU kernel bsr_spmm_pallas (src/repro/kernels/bsr_spmm.py,
// body _spmm_kernel): the local multiply of every dense-output schedule.
// The TPU kernel walks the stored-block list as a sequential grid axis and
// zeroes an output block on its first visit.  Hopper blocks run in no
// order, so here the work is cut by block-row segment instead: the wrapper
// passes per-tile segment bounds row_ptr (a searchsorted of the sorted
// rows) and chunk bounds chunk_ptr (each segment cut into chunks of at most
// `chunk` stored blocks, an empty segment into one empty chunk).
//
//   1. bsr_spmm_chunk_kernel: one thread block per (tile, chunk, row part,
//      n-panel) loops over the chunk's stored blocks, stages A and B slabs
//      in shared memory, accumulates in float32 registers with FMA, and
//      stores its float32 partial once into a workspace.
//   2. bsr_spmm_reduce_kernel: sums each segment's partials in chunk order
//      and stores C once, cast to the output type.  No atomics: the result
//      does not depend on the order in which blocks ran.
//
// Why chunks: a tile's capacity padding repeats its last (row, col), so all
// of it lands in one block-row.  On the main path (R-MAT scale 15, bs 128,
// g 2) that segment holds ~6,500 of the tile's 13,065 stored blocks, and
// one thread block per segment left it running alone on a few SMs.
//
// What bounds it on an H100: every stored block is reused for 2*bs*n flops
// per n-panel, so in float32 it is bound by the CUDA cores' FMA rate
// (67 TFLOP/s; no tensor cores, IEEE float32 as the reference), in bf16 by
// the bytes of the stored blocks.  The design answers the first with an
// 8x4 (or 4x4) register tile per thread and float4 shared-memory reads.
// Not done yet: wgmma/tensor cores, TMA, a pipelined ring of slabs and a
// persistent schedule.
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

template <typename T>
__device__ __forceinline__ T store_cast(float x);
template <>
__device__ __forceinline__ float store_cast<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// BM x BN partial per thread block (BM rows of one bs-row block row, BN
// columns of n), BK-deep slabs, TM x TN outputs per thread.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    bsr_spmm_chunk_kernel(const T* __restrict__ blocks,
                          const int* __restrict__ cols,
                          const int* __restrict__ row_ptr,
                          const int* __restrict__ chunk_ptr,
                          const T* __restrict__ dense,
                          float* __restrict__ partial, int S, int bs, int nbr,
                          int K, int n, int row_parts, int n_panels,
                          int max_chunks, int chunk) {
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragment reads");
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0,
                "every thread stages the same number of slab elements");
  // A slab stored transposed (k-major) so a thread's TM rows are one
  // contiguous run; +4 keeps rows 16-byte aligned and spreads the banks of
  // the transposing store.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int t = blockIdx.z;
  // blockIdx.x = (chunk, row part, n-panel) with the panel fastest, so the
  // panels of one chunk run side by side and share its A blocks in L2
  const long long bx = blockIdx.x;
  const int panel = static_cast<int>(bx % n_panels);
  const long long rc = bx / n_panels;
  const int part = static_cast<int>(rc % row_parts);
  const int c = static_cast<int>(rc / row_parts);

  const int* cp = chunk_ptr + static_cast<long long>(t) * (nbr + 1);
  if (c >= cp[nbr]) return;  // the grid is sized for the most chunks a tile
                             // can have
  // the segment r holding chunk c: the last r with cp[r] <= c (every
  // segment has at least one chunk, so cp is strictly increasing)
  int lo = 0, hi = nbr - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (cp[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int r = lo;
  const int* seg = row_ptr + static_cast<long long>(t) * (nbr + 1) + r;
  const int s0 = seg[0] + (c - cp[r]) * chunk;
  const int s1 = min(seg[1], s0 + chunk);

  const int m0 = part * BM;
  const int j0 = panel * BN;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const long long bsq = static_cast<long long>(bs) * bs;
  const T* tile_blocks = blocks + static_cast<long long>(t) * S * bsq;
  const int* tile_cols = cols + static_cast<long long>(t) * S;
  const T* tile_dense = dense + static_cast<long long>(t) * K * n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = s0; s < s1; ++s) {
    const T* a = tile_blocks + s * bsq;
    const T* b = tile_dense + static_cast<long long>(tile_cols[s]) * bs * n;
    for (int k0 = 0; k0 < bs; k0 += BK) {
#pragma unroll
      for (int it = 0; it < BM * BK / NT; ++it) {
        const int e = tid + it * NT;
        const int m = e / BK, k = e % BK;
        const int gm = m0 + m, gk = k0 + k;
        As[k][m] = (gm < bs && gk < bs)
                       ? load_f32(a + static_cast<long long>(gm) * bs + gk)
                       : 0.f;
      }
#pragma unroll
      for (int it = 0; it < BK * BN / NT; ++it) {
        const int e = tid + it * NT;
        const int k = e / BN, j = e % BN;
        const int gk = k0 + k, gj = j0 + j;
        Bs[k][j] = (gk < bs && gj < n)
                       ? load_f32(b + static_cast<long long>(gk) * n + gj)
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float af[TM], bf[TN];
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
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // one store per partial element; an empty chunk stores zeros
  float* p = partial +
             (static_cast<long long>(t) * max_chunks + c) * bs * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= bs) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = j0 + tx * TN + j;
      if (gj < n) p[static_cast<long long>(gm) * n + gj] = acc[i][j];
    }
  }
}

// out[t, r*bs:(r+1)*bs, :] = sum of segment r's chunk partials, in order
template <typename T>
__global__ void __launch_bounds__(256)
    bsr_spmm_reduce_kernel(const float* __restrict__ partial,
                           const int* __restrict__ chunk_ptr,
                           T* __restrict__ out, int bs, int nbr, int n,
                           int max_chunks) {
  const long long elems = static_cast<long long>(bs) * n;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= elems) return;
  const int r = blockIdx.y;
  const int t = blockIdx.z;
  const int* cp = chunk_ptr + static_cast<long long>(t) * (nbr + 1);
  const float* p = partial + static_cast<long long>(t) * max_chunks * elems;
  float sum = 0.f;
  for (int c = cp[r]; c < cp[r + 1]; ++c) sum += p[c * elems + e];
  out[(static_cast<long long>(t) * nbr + r) * elems + e] = store_cast<T>(sum);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const void* blocks, const void* cols, const void* row_ptr,
                   const void* chunk_ptr, const void* dense, void* partial,
                   void* out, int T_, int S, int bs, int nbr, int K, int n,
                   int max_chunks, int chunk, cudaStream_t stream) {
  const int row_parts = (bs + BM - 1) / BM;
  const int n_panels = (n + BN - 1) / BN;
  const long long nx =
      static_cast<long long>(max_chunks) * row_parts * n_panels;
  const long long elems = static_cast<long long>(bs) * n;
  const long long rx = (elems + 255) / 256;
  if (nx > INT_MAX || rx > INT_MAX || T_ > 65535 || nbr > 65535)
    return cudaErrorInvalidConfiguration;
  bsr_spmm_chunk_kernel<T, BM, BN, BK, TM, TN>
      <<<dim3(static_cast<unsigned>(nx), 1, T_), (BM / TM) * (BN / TN), 0,
         stream>>>(static_cast<const T*>(blocks),
                   static_cast<const int*>(cols),
                   static_cast<const int*>(row_ptr),
                   static_cast<const int*>(chunk_ptr),
                   static_cast<const T*>(dense),
                   static_cast<float*>(partial), S, bs, nbr, K, n, row_parts,
                   n_panels, max_chunks, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bsr_spmm_reduce_kernel<T>
      <<<dim3(static_cast<unsigned>(rx), nbr, T_), 256, 0, stream>>>(
          static_cast<const float*>(partial),
          static_cast<const int*>(chunk_ptr), static_cast<T*>(out), bs, nbr,
          n, max_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* blocks, const void* cols, const void* row_ptr,
                     const void* chunk_ptr, const void* dense, void* partial,
                     void* out, int T_, int S, int bs, int nbr, int K, int n,
                     int max_chunks, int chunk, cudaStream_t stream) {
  if (bs > 64)
    return launch<T, 128, 64, 16, 8, 4>(blocks, cols, row_ptr, chunk_ptr,
                                        dense, partial, out, T_, S, bs, nbr,
                                        K, n, max_chunks, chunk, stream);
  if (bs > 32)
    return launch<T, 64, 64, 16, 4, 4>(blocks, cols, row_ptr, chunk_ptr,
                                       dense, partial, out, T_, S, bs, nbr, K,
                                       n, max_chunks, chunk, stream);
  return launch<T, 32, 64, 16, 4, 4>(blocks, cols, row_ptr, chunk_ptr, dense,
                                     partial, out, T_, S, bs, nbr, K, n,
                                     max_chunks, chunk, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (blocks, dense and out all of it).
// blocks [T, S, bs, bs], cols int32 [T, S], row_ptr and chunk_ptr int32
// [T, nbr + 1], dense [T, K, n], partial float32 [T, max_chunks, bs, n]
// (workspace), out [T, nbr * bs, n]; all contiguous on one device.
extern "C" int bsr_spmm_launch(const void* blocks, const void* cols,
                               const void* row_ptr, const void* chunk_ptr,
                               const void* dense, void* partial, void* out,
                               int T_, int S, int bs, int nbr, int K, int n,
                               int max_chunks, int chunk, int dtype,
                               void* stream) {
  if (T_ <= 0 || S < 0 || bs <= 0 || nbr <= 0 || K < 0 || n <= 0 ||
      K % bs != 0 || chunk <= 0 || max_chunks < nbr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(blocks, cols, row_ptr, chunk_ptr, dense, partial,
                          out, T_, S, bs, nbr, K, n, max_chunks, chunk, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(blocks, cols, row_ptr, chunk_ptr, dense,
                                  partial, out, T_, S, bs, nbr, K, n,
                                  max_chunks, chunk, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
