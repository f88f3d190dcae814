// Device helpers shared by the port's block-sparse kernels (bsr_spmm.cu,
// bsr_pair.cu), for Hopper (sm_90a):
//
// * copies into a shared-memory ring: cp.async of 4/8/16 bytes, zero
//   fills, commit and wait;
// * bf16 widening reads of shared memory (2, 4 or 8 values at once);
// * tensor-core fragments: ldmatrix (.trans for a k-major B tile) and
//   mma.sync m16n8k16 bf16 -> float32, over an MT x NT grid of 16x8
//   output tiles of one warp, and the walk over that grid's accumulators.
//
// Header only; every function is __forceinline__ with internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// copies into the ring
// ---------------------------------------------------------------------------
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (VEC >= 4) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(VEC)
                 : "memory");
  } else {  // 2-byte bf16 elements of an odd block size: a plain copy
    *static_cast<unsigned short*>(dst) =
        *static_cast<const unsigned short*>(src);
  }
}

template <int VEC>
__device__ __forceinline__ void zero_vec(void* dst) {
  if constexpr (VEC == 16)
    *static_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else if constexpr (VEC == 8)
    *static_cast<uint2*>(dst) = make_uint2(0u, 0u);
  else if constexpr (VEC == 4)
    *static_cast<unsigned*>(dst) = 0u;
  else
    *static_cast<unsigned short*>(dst) = 0;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// shared-memory reads, widened to float32
// ---------------------------------------------------------------------------
__device__ __forceinline__ float bf_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_n(const float* p, float* v) {
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_n(const bf16* p, float* v) {
  if constexpr (N == 2) {
    const unsigned x = *reinterpret_cast<const unsigned*>(p);
    v[0] = bf_lo(x); v[1] = bf_hi(x);
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = bf_lo(x.x); v[1] = bf_hi(x.x); v[2] = bf_lo(x.y); v[3] = bf_hi(x.y);
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    v[0] = bf_lo(x.x); v[1] = bf_hi(x.x); v[2] = bf_lo(x.y); v[3] = bf_hi(x.y);
    v[4] = bf_lo(x.z); v[5] = bf_hi(x.z); v[6] = bf_lo(x.w); v[7] = bf_hi(x.w);
  }
}

// ---------------------------------------------------------------------------
// tensor-core fragments (bf16 in, float32 accumulate)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 16-deep step of a warp's (MT*16) x (NT*8) tile: acc += A[:, 0:16] @
// B[0:16, :].  A fragments by ldmatrix from the row-major A tile at `as`
// (row stride lda), B fragments by ldmatrix.trans from the row-major
// (k-major) B tile at `bs_` (row stride ldb).  NT is even.  Rows of a
// multiple of 8 bf16 plus 8 keep the eight row addresses of each 8x8
// matrix on distinct banks.
template <int MT, int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT][4],
                                        const bf16* as, int lda,
                                        const bf16* bs_, int ldb, int lane) {
  static_assert(NT % 2 == 0, "B fragments come two n8 tiles at a time");
  unsigned a[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
    ldsm_x4(a[mi], as + (mi * 16 + (lane & 15)) * lda + (lane >> 4) * 8);
  unsigned b[NT][2];
#pragma unroll
  for (int nj = 0; nj < NT; nj += 2) {
    unsigned r[4];
    ldsm_x4_trans(r, bs_ + (lane & 15) * ldb + nj * 8 + (lane >> 4) * 8);
    b[nj][0] = r[0]; b[nj][1] = r[1];
    b[nj + 1][0] = r[2]; b[nj + 1][1] = r[3];
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
}

// f(row, col, v[row][col], v[row][col + 1]) over a warp's accumulators, in
// the m16n8 fragment layout (row and col within the warp tile).
template <int MT, int NT, class F>
__device__ __forceinline__ void mma_for_each_pair(
    const float (&acc)[MT][NT][4], int lane, F f) {
  const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      f(mi * 16 + r, ni * 8 + c, acc[mi][ni][0], acc[mi][ni][1]);
      f(mi * 16 + r + 8, ni * 8 + c, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

}  // namespace
