// Flash attention for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// These replace the Pallas TPU kernels of the JAX package's attention hot op
// (pytorch_ps_mpi_tpu/ops/flash_attention.py):
//
//   ps_flash_fwd        <- _fwd_call          (_fwd_kernel)
//   ps_flash_bwd_dkdv   <- _bwd_call, 1st call (_bwd_dkdv_kernel)
//   ps_flash_bwd_dq     <- _bwd_call, 2nd call (_bwd_dq_kernel)
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrappers in ops/flash_attention.py allocate
// every output, check dtypes, shapes and alignment, pad an unsupported head
// dim up to 64 or 128, and raise on a nonzero return.  The plain PyTorch
// versions beside those wrappers repeat the same tile math, and
// chip_smoke.py holds each kernel against its plain version.
//
// Layout.  q, k, v and dout are [B, L, H, D] read through their (batch,
// seq, head) element strides with unit stride along D, so the model's
// qkv.view(b, l, h, 3, d) slices feed the kernels without a transpose.
// o, dq, dk and dv are written contiguous [B, L, H, D]; lse and delta are
// f32 [B, H, L].  The Pallas kernel replicates lse across a 128-lane tile
// (TPU output tiling); that does not carry over.
//
// Design.  The Pallas grid runs in order on one core and carries the
// running softmax state (m, l, acc) in VMEM scratch from one k step to the
// next.  Here each block owns one 64-row tile of one (batch, head) and
// loops over the other operand's 64-row tiles itself:
//   * flash_fwd: one block per q tile, looping over k tiles; tiles wholly
//     above the causal diagonal are skipped, as the Pallas kernel skips
//     them; the heaviest q tiles are launched first.
//   * flash_bwd_dkdv: one block per k tile, looping over the q tiles from
//     the diagonal down, dK and dV accumulated in f32 shared memory.
//   * flash_bwd_dq: one block per q tile, looping over k tiles, dQ in f32.
// Every intermediate tile (scores, probabilities, dP, dS) lives in shared
// memory as f32, and the softmax and masking run there, row per warp.  The
// tile products run on the tensor cores through WMMA 16x16x16 for bf16
// (bf16 operands, f32 sums: the MXU's preferred_element_type=f32) and as
// f32 FMAs for f32 inputs, which keeps them exact f32 (no TF32).  The ragged
// end of the sequence is masked inside the kernels: rows past L load as
// zeros and are never written.
//
// Bounds on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s), per (batch, head)
// with P = L(L+1)/2 unmasked pairs when causal (L*L otherwise):
//   fwd   4*D*P operations (two products); bytes q, k, v, o (+ lse)
//   dkdv  8*D*P operations (four products); bytes q, k, v, do, dk, dv
//   dq    6*D*P operations (three products); bytes q, k, v, do, dq
// At the LM's D = 64 in bf16 the forward moves about 254 operations per
// byte, under the ~295 at which the tensor cores, not the memory, limit an
// H100: it is bound by bytes; the two backward kernels by operations.  This
// first version stages every tile through shared memory and synchronises
// the block between phases; wgmma, TMA and warp specialisation are left to
// a later version.
//
// Numerics follow the Pallas kernels: scores f32 times scale, the finite
// NEG_INF = -1e30 for masked positions, p rounded to the value dtype before
// p.v, lse = m + log(l > 0 ? l : 1), o = acc / (l > 0 ? l : 1); in the
// backward the mask applies before the exp, ds = p * (dp - delta) * scale,
// and p and ds are rounded to the operand dtype before each product.  Build
// without --use_fast_math: expf, logf and the division stay IEEE-accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // rows of a q or k tile

// Element strides of a [B, L, H, D] operand (unit stride along D).
struct Strides {
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, L]: fwd output, bwd input
  const float* delta;  // [B, H, L]: bwd input
  void* out0;          // fwd: o; dkdv: dk; dq: dq
  void* out1;          // dkdv: dv
  float* lse_out;
  Strides sq, sk, sv, sdo;
  int B, H, L;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr size_t up128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Leading dims in shared memory: each row padded by 16 bytes (fewer bank
// conflicts; still a multiple of 16 bytes, as WMMA and uint4 need).
template <typename T, int D>
struct Ld {
  static constexpr int kT = D + 16 / (int)sizeof(T);  // q/k/v/do tiles
  static constexpr int kS = kTile + 4;                 // f32 score tiles
  static constexpr int kP = kTile + 8;                 // bf16 p/ds tiles
  static constexpr int kO = D + 4;                     // f32 accumulators
};

// rows x D elements of one (b, h) slice, from sequence row row0 on, into
// shared memory with leading dim ld; rows at or past L read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          const Strides& st, int b, int h,
                                          int row0, int rows, int L) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = D / kVec;
  const T* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const int pos = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos < L)
      val = *reinterpret_cast<const uint4*>(base + (long long)pos * st.s + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// rows of one (b, h) row of a [B, H, L] f32 vector; zeros past L.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         long long bh, int L, int row0,
                                         int rows) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int pos = row0 + i;
    dst[i] = pos < L ? src[bh * L + pos] : 0.0f;
  }
}

// C[M x N] (f32, row-major, ldc) = [C +] A[M x K] . B[K x N], all in shared
// memory.  A(i, k) is A[i * lda + k], or A[k * lda + i] with TA; B(k, j) is
// B[k * ldb + j], or B[j * ldb + k] with TB.  Warps (bf16) or threads (f32)
// own disjoint output tiles, so no two write the same element.
//
// bf16: WMMA 16x16x16 on the tensor cores, bf16 operands and f32 sums.
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void gemm(const bf16* A, int lda, const bf16* B,
                                     int ldb, float* C, int ldc) {
  using namespace nvcuda;
  using LA = typename std::conditional<TA, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<TB, wmma::col_major,
                                       wmma::row_major>::type;
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "WMMA tiles");
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * (N / 16); t += kWarps) {
    const int i0 = (t / (N / 16)) * 16, j0 = (t % (N / 16)) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (ACC)
      wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bm;
      wmma::load_matrix_sync(a, TA ? A + k0 * lda + i0 : A + i0 * lda + k0,
                             lda);
      wmma::load_matrix_sync(bm, TB ? B + j0 * ldb + k0 : B + k0 * ldb + j0,
                             ldb);
      wmma::mma_sync(c, a, bm, c);
    }
    wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
  }
}

// f32: FMAs, a 4x4 register tile of C per thread and step.
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void gemm(const float* A, int lda, const float* B,
                                     int ldb, float* C, int ldc) {
  constexpr int kR = 4;
  static_assert(M % kR == 0 && N % kR == 0, "4x4 register tiles");
  for (int t = threadIdx.x; t < (M / kR) * (N / kR); t += kThreads) {
    const int i0 = (t / (N / kR)) * kR, j0 = (t % (N / kR)) * kR;
    float c[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j)
        c[i][j] = ACC ? C[(i0 + i) * ldc + j0 + j] : 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[kR], bv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        a[i] = TA ? A[k * lda + i0 + i] : A[(i0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < kR; ++j)
        bv[j] = TB ? B[(j0 + j) * ldb + k] : B[k * ldb + j0 + j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) c[i][j] = fmaf(a[i], bv[j], c[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) C[(i0 + i) * ldc + j0 + j] = c[i][j];
  }
}

// Shared-memory carving: each buffer starts on a 128-byte boundary (WMMA
// wants 32-byte aligned tile pointers, uint4 16).
struct Carve {
  char* p;
  template <typename U>
  __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += up128(n * sizeof(U));
    return r;
  }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  using L = Ld<T, D>;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  return 3 * up128(kTile * L::kT * sizeof(T))   // q, k, v
         + up128(kTile * L::kS * 4)             // scores / f32 p
         + (kBf16 ? up128(kTile * L::kP * 2) : 0)  // bf16 p
         + up128(kTile * L::kO * 4)             // acc
         + 2 * up128(kTile * 4);                // m, l
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  using L = Ld<T, D>;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sQ = cv.take<T>(kTile * L::kT);
  T* sK = cv.take<T>(kTile * L::kT);
  T* sV = cv.take<T>(kTile * L::kT);
  float* sS = cv.take<float>(kTile * L::kS);
  bf16* sP = kBf16 ? cv.take<bf16>(kTile * L::kP) : nullptr;
  float* sO = cv.take<float>(kTile * L::kO);
  float* sM = cv.take<float>(kTile);
  float* sL = cv.take<float>(kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_q = (a.L + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * kTile;  // heaviest first
  int n_k = (a.L + kTile - 1) / kTile;
  if (a.causal) n_k = min(n_k, (q0 + kTile - 1) / kTile + 1);

  load_tile<T, D>(sQ, L::kT, static_cast<const T*>(a.q), a.sq, b, h, q0,
                  kTile, a.L);
  for (int i = tid; i < kTile * L::kO; i += kThreads) sO[i] = 0.0f;
  for (int i = tid; i < kTile; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last step's products are done with sK, sV, sP
    load_tile<T, D>(sK, L::kT, static_cast<const T*>(a.k), a.sk, b, h, k0,
                    kTile, a.L);
    load_tile<T, D>(sV, L::kT, static_cast<const T*>(a.v), a.sv, b, h, k0,
                    kTile, a.L);
    __syncthreads();
    gemm<kTile, kTile, D, false, true, false>(sQ, L::kT, sK, L::kT, sS,
                                              L::kS);
    __syncthreads();
    // Online softmax, one row per warp: mask, running max, rescale.
    for (int r = warp; r < kTile; r += kWarps) {
      const int qpos = q0 + r;
      float s[kTile / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int c = lane + 32 * u, kpos = k0 + c;
        const bool ok = kpos < a.L && (!a.causal || qpos >= kpos);
        s[u] = ok ? sS[r * L::kS + c] * a.scale : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int c = lane + 32 * u;
        const float p = expf(s[u] - m_new);
        sum += p;
        if constexpr (kBf16)
          sP[r * L::kP + c] = __float2bfloat16_rn(p);
        else
          sS[r * L::kS + c] = p;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < D; c += 32) sO[r * L::kO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncthreads();
    if constexpr (kBf16)
      gemm<kTile, D, kTile, false, false, true>(sP, L::kP, sV, L::kT, sO,
                                                L::kO);
    else
      gemm<kTile, D, kTile, false, false, true>(sS, L::kS, sV, L::kT, sO,
                                                L::kO);
  }
  __syncthreads();

  T* o = static_cast<T*>(a.out0);
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, pos = q0 + r;
    if (pos >= a.L) continue;
    const float l = sL[r];
    const float safe = l > 0.0f ? l : 1.0f;
    o[(((long long)b * a.L + pos) * a.H + h) * D + c] =
        from_f32<T>(sO[r * L::kO + c] / safe);
  }
  for (int i = tid; i < kTile; i += kThreads) {
    const int pos = q0 + i;
    if (pos >= a.L) continue;
    const float l = sL[i];
    a.lse_out[(long long)bh * a.L + pos] = sM[i] + logf(l > 0.0f ? l : 1.0f);
  }
}

// ---------------------------------------------------------------------------
// backward: shared tile math
// ---------------------------------------------------------------------------

// p and ds of one (q tile, k tile) pair from the scores sS and dP = do.v^T
// in sdP.  f32: written over sS and sdP; bf16: rounded into sP (when kP)
// and sdS.
template <typename T, int BQ, bool kP>
__device__ __forceinline__ void bwd_probs(const Args& a, float* sS,
                                          float* sdP, bf16* sP, bf16* sdS,
                                          const float* sLse,
                                          const float* sDelta, int q0,
                                          int k0, int lds, int ldp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += kWarps) {
    const int qpos = q0 + r;
    const float lse = sLse[r], dlt = sDelta[r];
    for (int c = lane; c < kTile; c += 32) {
      const int kpos = k0 + c;
      const bool ok = kpos < a.L && qpos < a.L && (!a.causal || qpos >= kpos);
      const float s = sS[r * lds + c] * a.scale;
      const float p = expf(ok ? s - lse : kNegInf);
      const float ds = p * (sdP[r * lds + c] - dlt) * a.scale;
      if constexpr (std::is_same<T, bf16>::value) {
        if (kP) sP[r * ldp + c] = __float2bfloat16_rn(p);
        sdS[r * ldp + c] = __float2bfloat16_rn(ds);
      } else {
        sS[r * lds + c] = p;
        sdP[r * lds + c] = ds;
      }
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float* acc, int ld,
                                           const Args& a, int b, int h,
                                           int row0, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, pos = row0 + r;
    if (pos >= a.L) continue;
    out[(((long long)b * a.L + pos) * a.H + h) * D + c] =
        from_f32<T>(acc[r * ld + c]);
  }
}

// ---------------------------------------------------------------------------
// backward: dK, dV (one block per k tile, sweeping q tiles)
// ---------------------------------------------------------------------------

// q tile rows of the dK/dV kernel: 32 for f32 at D = 128, which would
// otherwise need more than the 227 KB of shared memory a block may use.
template <typename T, int D>
__host__ __device__ constexpr int dkdv_bq() {
  return (std::is_same<T, float>::value && D == 128) ? 32 : kTile;
}

template <typename T, int D>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  using L = Ld<T, D>;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int BQ = dkdv_bq<T, D>();
  return 2 * up128(kTile * L::kT * sizeof(T))          // k, v
         + 2 * up128(BQ * L::kT * sizeof(T))           // q, do
         + 2 * up128(BQ * L::kS * 4)                   // s, dp
         + (kBf16 ? 2 * up128(BQ * L::kP * 2) : 0)     // bf16 p, ds
         + 2 * up128(kTile * L::kO * 4)                // dk, dv
         + 2 * up128(BQ * 4);                          // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  using L = Ld<T, D>;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int BQ = dkdv_bq<T, D>();
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sK = cv.take<T>(kTile * L::kT);
  T* sV = cv.take<T>(kTile * L::kT);
  T* sQ = cv.take<T>(BQ * L::kT);
  T* sdO = cv.take<T>(BQ * L::kT);
  float* sS = cv.take<float>(BQ * L::kS);
  float* sdP = cv.take<float>(BQ * L::kS);
  bf16* sP = kBf16 ? cv.take<bf16>(BQ * L::kP) : nullptr;
  bf16* sdS = kBf16 ? cv.take<bf16>(BQ * L::kP) : nullptr;
  float* sdK = cv.take<float>(kTile * L::kO);
  float* sdV = cv.take<float>(kTile * L::kO);
  float* sLse = cv.take<float>(BQ);
  float* sDelta = cv.take<float>(BQ);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = (int)blockIdx.y * kTile;  // k tile 0 sweeps the most q tiles
  const int n_q = (a.L + BQ - 1) / BQ;
  // Causal: q tile i meets this k tile iff its last row (i+1)*BQ-1 >= k0.
  const int i0 = a.causal ? k0 / BQ : 0;

  load_tile<T, D>(sK, L::kT, static_cast<const T*>(a.k), a.sk, b, h, k0,
                  kTile, a.L);
  load_tile<T, D>(sV, L::kT, static_cast<const T*>(a.v), a.sv, b, h, k0,
                  kTile, a.L);
  for (int i = tid; i < kTile * L::kO; i += kThreads) {
    sdK[i] = 0.0f;
    sdV[i] = 0.0f;
  }

  for (int it = i0; it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the last step's products are done with the q side
    load_tile<T, D>(sQ, L::kT, static_cast<const T*>(a.q), a.sq, b, h, q0,
                    BQ, a.L);
    load_tile<T, D>(sdO, L::kT, static_cast<const T*>(a.dout), a.sdo, b, h,
                    q0, BQ, a.L);
    load_vec(sLse, a.lse, bh, a.L, q0, BQ);
    load_vec(sDelta, a.delta, bh, a.L, q0, BQ);
    __syncthreads();
    gemm<BQ, kTile, D, false, true, false>(sQ, L::kT, sK, L::kT, sS, L::kS);
    gemm<BQ, kTile, D, false, true, false>(sdO, L::kT, sV, L::kT, sdP,
                                           L::kS);
    __syncthreads();
    bwd_probs<T, BQ, true>(a, sS, sdP, sP, sdS, sLse, sDelta, q0, k0, L::kS,
                     L::kP);
    __syncthreads();
    if constexpr (kBf16) {
      gemm<kTile, D, BQ, true, false, true>(sP, L::kP, sdO, L::kT, sdV,
                                            L::kO);
      gemm<kTile, D, BQ, true, false, true>(sdS, L::kP, sQ, L::kT, sdK,
                                            L::kO);
    } else {
      gemm<kTile, D, BQ, true, false, true>(sS, L::kS, sdO, L::kT, sdV,
                                            L::kO);
      gemm<kTile, D, BQ, true, false, true>(sdP, L::kS, sQ, L::kT, sdK,
                                            L::kO);
    }
  }
  __syncthreads();
  store_rows<T, D>(static_cast<T*>(a.out0), sdK, L::kO, a, b, h, k0, kTile);
  store_rows<T, D>(static_cast<T*>(a.out1), sdV, L::kO, a, b, h, k0, kTile);
}

// ---------------------------------------------------------------------------
// backward: dQ (one block per q tile, sweeping k tiles)
// ---------------------------------------------------------------------------

template <typename T, int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  using L = Ld<T, D>;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  return 4 * up128(kTile * L::kT * sizeof(T))   // q, do, k, v
         + 2 * up128(kTile * L::kS * 4)         // s, dp
         + (kBf16 ? up128(kTile * L::kP * 2) : 0)  // bf16 ds
         + up128(kTile * L::kO * 4)             // dq
         + 2 * up128(kTile * 4);                // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  using L = Ld<T, D>;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sQ = cv.take<T>(kTile * L::kT);
  T* sdO = cv.take<T>(kTile * L::kT);
  T* sK = cv.take<T>(kTile * L::kT);
  T* sV = cv.take<T>(kTile * L::kT);
  float* sS = cv.take<float>(kTile * L::kS);
  float* sdP = cv.take<float>(kTile * L::kS);
  bf16* sdS = kBf16 ? cv.take<bf16>(kTile * L::kP) : nullptr;
  float* sdQ = cv.take<float>(kTile * L::kO);
  float* sLse = cv.take<float>(kTile);
  float* sDelta = cv.take<float>(kTile);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_q = (a.L + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * kTile;  // heaviest first
  int n_k = (a.L + kTile - 1) / kTile;
  if (a.causal) n_k = min(n_k, (q0 + kTile - 1) / kTile + 1);

  load_tile<T, D>(sQ, L::kT, static_cast<const T*>(a.q), a.sq, b, h, q0,
                  kTile, a.L);
  load_tile<T, D>(sdO, L::kT, static_cast<const T*>(a.dout), a.sdo, b, h, q0,
                  kTile, a.L);
  load_vec(sLse, a.lse, bh, a.L, q0, kTile);
  load_vec(sDelta, a.delta, bh, a.L, q0, kTile);
  for (int i = tid; i < kTile * L::kO; i += kThreads) sdQ[i] = 0.0f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last step's product is done with sK and sdS
    load_tile<T, D>(sK, L::kT, static_cast<const T*>(a.k), a.sk, b, h, k0,
                    kTile, a.L);
    load_tile<T, D>(sV, L::kT, static_cast<const T*>(a.v), a.sv, b, h, k0,
                    kTile, a.L);
    __syncthreads();
    gemm<kTile, kTile, D, false, true, false>(sQ, L::kT, sK, L::kT, sS,
                                              L::kS);
    gemm<kTile, kTile, D, false, true, false>(sdO, L::kT, sV, L::kT, sdP,
                                              L::kS);
    __syncthreads();
    bwd_probs<T, kTile, false>(a, sS, sdP, nullptr, sdS, sLse, sDelta, q0, k0,
                        L::kS, L::kP);
    __syncthreads();
    if constexpr (kBf16)
      gemm<kTile, D, kTile, false, false, true>(sdS, L::kP, sK, L::kT, sdQ,
                                                L::kO);
    else
      gemm<kTile, D, kTile, false, false, true>(sdP, L::kS, sK, L::kT, sdQ,
                                                L::kO);
  }
  __syncthreads();
  store_rows<T, D>(static_cast<T*>(a.out0), sdQ, L::kO, a, b, h, q0, kTile);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

template <typename T, int D>
cudaError_t launch(Kind kind, const Args& a, cudaStream_t stream) {
  void (*kern)(Args);
  size_t bytes;
  if (kind == kFwd) {
    kern = flash_fwd_kernel<T, D>;
    bytes = fwd_smem_bytes<T, D>();
  } else if (kind == kDkdv) {
    kern = flash_bwd_dkdv_kernel<T, D>;
    bytes = dkdv_smem_bytes<T, D>();
  } else {
    kern = flash_bwd_dq_kernel<T, D>;
    bytes = dq_smem_bytes<T, D>();
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // One block per (batch x head, 64-row tile that the block owns).
  const dim3 grid((unsigned int)(a.B * a.H),
                  (unsigned int)((a.L + kTile - 1) / kTile));
  kern<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(Kind kind, int dtype, int d, const Args& a,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.L <= 0 || a.B * a.H <= 0) return cudaSuccess;
  if (dtype == 1 && d == 64) return launch<bf16, 64>(kind, a, s);
  if (dtype == 1 && d == 128) return launch<bf16, 128>(kind, a, s);
  if (dtype == 0 && d == 64) return launch<float, 64>(kind, a, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(kind, a, s);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const long long* strides, int B, int H, int L, float scale,
               int causal) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.sdo = {strides[9], strides[10], strides[11]};
  a.B = B;
  a.H = H;
  a.L = L;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

extern "C" {

// dtype 0 = f32, 1 = bf16; d = 64 or 128.  strides: the (batch, seq, head)
// element strides of q, k, v and dout, 12 values (dout's unused by the
// forward).  o: contiguous [B, L, H, d]; lse: f32 [B, H, L].
int ps_flash_fwd(int dtype, int d, const void* q, const void* k,
                 const void* v, const long long* strides, void* o,
                 float* lse, int B, int H, int L, float scale, int causal,
                 void* stream) {
  Args a = make_args(q, k, v, nullptr, strides, B, H, L, scale, causal);
  a.out0 = o;
  a.lse_out = lse;
  return (int)dispatch(kFwd, dtype, d, a, stream);
}

// lse, delta: f32 [B, H, L]; dk, dv: contiguous [B, L, H, d].
int ps_flash_bwd_dkdv(int dtype, int d, const void* q, const void* k,
                      const void* v, const void* dout,
                      const long long* strides, const float* lse,
                      const float* delta, void* dk, void* dv, int B, int H,
                      int L, float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, dout, strides, B, H, L, scale, causal);
  a.lse = lse;
  a.delta = delta;
  a.out0 = dk;
  a.out1 = dv;
  return (int)dispatch(kDkdv, dtype, d, a, stream);
}

// dq: contiguous [B, L, H, d].
int ps_flash_bwd_dq(int dtype, int d, const void* q, const void* k,
                    const void* v, const void* dout,
                    const long long* strides, const float* lse,
                    const float* delta, void* dq, int B, int H, int L,
                    float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, dout, strides, B, H, L, scale, causal);
  a.lse = lse;
  a.delta = delta;
  a.out0 = dq;
  return (int)dispatch(kDq, dtype, d, a, stream);
}

const char* ps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
