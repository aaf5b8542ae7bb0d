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
// Two designs live here:
//
//   * bf16, all three kernels (flash_fwd_bf16_kernel,
//     flash_bwd_dkdv_bf16_kernel, flash_bwd_dq_bf16_kernel): Hopper kernels
//     built from TMA, mbarriers and wgmma, with every score, probability
//     and accumulator tile in registers.  Their notes stand beside them,
//     below.
//   * f32, all three kernels (flash_fwd_f32_kernel,
//     flash_bwd_dkdv_f32_kernel, flash_bwd_dq_f32_kernel): one block of
//     256 threads per 64-row tile, every tile staged through shared memory
//     with block barriers between phases, the softmax and masking one row
//     per warp, and the products as f32 FMAs, which keeps f32 exact (no
//     TF32: the CLI's f32 LM would change function).
//
// In both, each block owns one tile of one (batch, head) and loops over the
// other operand's tiles itself, as the Pallas grid's sequential axis did
// with its VMEM scratch; tiles wholly above the causal diagonal are
// skipped, and the ragged end of the sequence is masked inside the kernels:
// rows past L load as zeros and are never written.
//
// Bounds on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s), per (batch, head)
// with P = L(L+1)/2 unmasked pairs when causal (L*L otherwise):
//   fwd   4*D*P operations (two products); bytes q, k, v, o (+ lse)
//   dkdv  8*D*P operations (four products); bytes q, k, v, do, dk, dv
//   dq    6*D*P operations (three products); bytes q, k, v, do, dq
// At the LM's D = 64 in bf16 the forward moves about 254 operations per
// byte, under the ~295 at which the tensor cores, not the memory, limit an
// H100: it is bound by bytes; the two backward kernels by operations.
//
// Numerics follow the Pallas kernels: scores f32 times scale, the finite
// NEG_INF = -1e30 for masked positions, p rounded to the value dtype before
// p.v, lse = m + log(l > 0 ? l : 1), o = acc / (l > 0 ? l : 1); in the
// backward the mask applies before the exp, ds = p * (dp - delta) * scale,
// and p and ds are rounded to the operand dtype before each product.  Build
// without --use_fast_math: expf, logf and the division stay IEEE-accurate.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // the runtime (tensor_map_encoder), so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
// Geometry of the shared-memory (f32) kernels: 256 threads per block,
// 64-row tiles.
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
// conflicts; still a multiple of 16 bytes, as uint4 needs).
template <int D>
struct Ld {
  static constexpr int kT = D + 4;      // q/k/v/do tiles
  static constexpr int kS = kTile + 4;  // score tiles
  static constexpr int kO = D + 4;      // accumulators
};

// rows x D elements of one (b, h) slice, from sequence row row0 on, into
// shared memory with leading dim ld; rows at or past L read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, const Strides& st,
                                          int b, int h, int row0, int rows,
                                          int L) {
  constexpr int kVec = 4;
  constexpr int kChunks = D / kVec;
  const float* base = src + b * st.b + h * st.h;
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

// C[M x N] (row-major, ldc) = [C +] A[M x K] . B[K x N], all in shared
// memory.  A(i, k) is A[i * lda + k], or A[k * lda + i] with TA; B(k, j) is
// B[k * ldb + j], or B[j * ldb + k] with TB.  f32 FMAs, a 4x4 register tile
// of C per thread and step; threads own disjoint output tiles, so no two
// write the same element.
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

// Shared-memory carving: each buffer starts on a 128-byte boundary (uint4
// wants 16).
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
// forward, f32 (shared-memory design)
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t fwd_f32_smem_bytes() {
  using L = Ld<D>;
  return 3 * up128(kTile * L::kT * 4)  // q, k, v
         + up128(kTile * L::kS * 4)    // scores, then p
         + up128(kTile * L::kO * 4)    // acc
         + 2 * up128(kTile * 4);       // m, l
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Args a) {
  using L = Ld<D>;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  float* sQ = cv.take<float>(kTile * L::kT);
  float* sK = cv.take<float>(kTile * L::kT);
  float* sV = cv.take<float>(kTile * L::kT);
  float* sS = cv.take<float>(kTile * L::kS);
  float* sO = cv.take<float>(kTile * L::kO);
  float* sM = cv.take<float>(kTile);
  float* sL = cv.take<float>(kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_q = (a.L + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * kTile;  // heaviest first
  int n_k = (a.L + kTile - 1) / kTile;
  if (a.causal) n_k = min(n_k, (q0 + kTile - 1) / kTile + 1);

  load_tile<D>(sQ, L::kT, static_cast<const float*>(a.q), a.sq, b, h,
               q0, kTile, a.L);
  for (int i = tid; i < kTile * L::kO; i += kThreads) sO[i] = 0.0f;
  for (int i = tid; i < kTile; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last step's products are done with sK, sV, sS
    load_tile<D>(sK, L::kT, static_cast<const float*>(a.k), a.sk, b, h,
                 k0, kTile, a.L);
    load_tile<D>(sV, L::kT, static_cast<const float*>(a.v), a.sv, b, h,
                 k0, kTile, a.L);
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
    gemm<kTile, D, kTile, false, false, true>(sS, L::kS, sV, L::kT, sO,
                                              L::kO);
  }
  __syncthreads();

  float* o = static_cast<float*>(a.out0);
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, pos = q0 + r;
    if (pos >= a.L) continue;
    const float l = sL[r];
    const float safe = l > 0.0f ? l : 1.0f;
    o[(((long long)b * a.L + pos) * a.H + h) * D + c] =
        sO[r * L::kO + c] / safe;
  }
  for (int i = tid; i < kTile; i += kThreads) {
    const int pos = q0 + i;
    if (pos >= a.L) continue;
    const float l = sL[i];
    a.lse_out[(long long)bh * a.L + pos] = sM[i] + logf(l > 0.0f ? l : 1.0f);
  }
}

// ---------------------------------------------------------------------------
// backward, shared-memory design: shared tile math
// ---------------------------------------------------------------------------

// p and ds of one (q tile, k tile) pair from the scores sS and dP = do.v^T
// in sdP, written over them.
template <int BQ>
__device__ __forceinline__ void bwd_probs(const Args& a, float* sS,
                                          float* sdP, const float* sLse,
                                          const float* sDelta, int q0,
                                          int k0, int lds) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += kWarps) {
    const int qpos = q0 + r;
    const float lse = sLse[r], dlt = sDelta[r];
    for (int c = lane; c < kTile; c += 32) {
      const int kpos = k0 + c;
      const bool ok = kpos < a.L && qpos < a.L && (!a.causal || qpos >= kpos);
      const float s = sS[r * lds + c] * a.scale;
      const float p = expf(ok ? s - lse : kNegInf);
      sdP[r * lds + c] = p * (sdP[r * lds + c] - dlt) * a.scale;
      sS[r * lds + c] = p;
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* out, const float* acc,
                                           int ld, const Args& a, int b,
                                           int h, int row0, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, pos = row0 + r;
    if (pos >= a.L) continue;
    out[(((long long)b * a.L + pos) * a.H + h) * D + c] = acc[r * ld + c];
  }
}

// ---------------------------------------------------------------------------
// backward, f32: dK, dV (one block per k tile, sweeping q tiles)
// ---------------------------------------------------------------------------

// q tile rows: 32 at D = 128, which would otherwise need more than the
// 227 KB of shared memory a block may use.
template <int D>
__host__ __device__ constexpr int dkdv_f32_bq() {
  return D == 128 ? 32 : kTile;
}

template <int D>
__host__ __device__ constexpr size_t dkdv_f32_smem_bytes() {
  using L = Ld<D>;
  constexpr int BQ = dkdv_f32_bq<D>();
  return 2 * up128(kTile * L::kT * 4)   // k, v
         + 2 * up128(BQ * L::kT * 4)    // q, do
         + 2 * up128(BQ * L::kS * 4)    // s then p, dp then ds
         + 2 * up128(kTile * L::kO * 4) // dk, dv
         + 2 * up128(BQ * 4);           // lse, delta
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32_kernel(Args a) {
  using L = Ld<D>;
  constexpr int BQ = dkdv_f32_bq<D>();
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  float* sK = cv.take<float>(kTile * L::kT);
  float* sV = cv.take<float>(kTile * L::kT);
  float* sQ = cv.take<float>(BQ * L::kT);
  float* sdO = cv.take<float>(BQ * L::kT);
  float* sS = cv.take<float>(BQ * L::kS);
  float* sdP = cv.take<float>(BQ * L::kS);
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

  load_tile<D>(sK, L::kT, static_cast<const float*>(a.k), a.sk, b, h,
               k0, kTile, a.L);
  load_tile<D>(sV, L::kT, static_cast<const float*>(a.v), a.sv, b, h,
               k0, kTile, a.L);
  for (int i = tid; i < kTile * L::kO; i += kThreads) {
    sdK[i] = 0.0f;
    sdV[i] = 0.0f;
  }

  for (int it = i0; it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the last step's products are done with the q side
    load_tile<D>(sQ, L::kT, static_cast<const float*>(a.q), a.sq, b, h,
                 q0, BQ, a.L);
    load_tile<D>(sdO, L::kT, static_cast<const float*>(a.dout), a.sdo,
                 b, h, q0, BQ, a.L);
    load_vec(sLse, a.lse, bh, a.L, q0, BQ);
    load_vec(sDelta, a.delta, bh, a.L, q0, BQ);
    __syncthreads();
    gemm<BQ, kTile, D, false, true, false>(sQ, L::kT, sK, L::kT, sS, L::kS);
    gemm<BQ, kTile, D, false, true, false>(sdO, L::kT, sV, L::kT, sdP,
                                           L::kS);
    __syncthreads();
    bwd_probs<BQ>(a, sS, sdP, sLse, sDelta, q0, k0, L::kS);
    __syncthreads();
    gemm<kTile, D, BQ, true, false, true>(sS, L::kS, sdO, L::kT, sdV, L::kO);
    gemm<kTile, D, BQ, true, false, true>(sdP, L::kS, sQ, L::kT, sdK, L::kO);
  }
  __syncthreads();
  store_rows<D>(static_cast<float*>(a.out0), sdK, L::kO, a, b, h, k0, kTile);
  store_rows<D>(static_cast<float*>(a.out1), sdV, L::kO, a, b, h, k0, kTile);
}

// ---------------------------------------------------------------------------
// backward, f32: dQ (one block per q tile, sweeping k tiles)
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t dq_f32_smem_bytes() {
  using L = Ld<D>;
  return 4 * up128(kTile * L::kT * 4)    // q, do, k, v
         + 2 * up128(kTile * L::kS * 4)  // s then p, dp then ds
         + up128(kTile * L::kO * 4)      // dq
         + 2 * up128(kTile * 4);         // lse, delta
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(Args a) {
  using L = Ld<D>;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  float* sQ = cv.take<float>(kTile * L::kT);
  float* sdO = cv.take<float>(kTile * L::kT);
  float* sK = cv.take<float>(kTile * L::kT);
  float* sV = cv.take<float>(kTile * L::kT);
  float* sS = cv.take<float>(kTile * L::kS);
  float* sdP = cv.take<float>(kTile * L::kS);
  float* sdQ = cv.take<float>(kTile * L::kO);
  float* sLse = cv.take<float>(kTile);
  float* sDelta = cv.take<float>(kTile);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_q = (a.L + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * kTile;  // heaviest first
  int n_k = (a.L + kTile - 1) / kTile;
  if (a.causal) n_k = min(n_k, (q0 + kTile - 1) / kTile + 1);

  load_tile<D>(sQ, L::kT, static_cast<const float*>(a.q), a.sq, b, h, q0,
               kTile, a.L);
  load_tile<D>(sdO, L::kT, static_cast<const float*>(a.dout), a.sdo, b, h,
               q0, kTile, a.L);
  load_vec(sLse, a.lse, bh, a.L, q0, kTile);
  load_vec(sDelta, a.delta, bh, a.L, q0, kTile);
  for (int i = tid; i < kTile * L::kO; i += kThreads) sdQ[i] = 0.0f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last step's product is done with sK and sdP
    load_tile<D>(sK, L::kT, static_cast<const float*>(a.k), a.sk, b, h, k0,
                 kTile, a.L);
    load_tile<D>(sV, L::kT, static_cast<const float*>(a.v), a.sv, b, h, k0,
                 kTile, a.L);
    __syncthreads();
    gemm<kTile, kTile, D, false, true, false>(sQ, L::kT, sK, L::kT, sS,
                                              L::kS);
    gemm<kTile, kTile, D, false, true, false>(sdO, L::kT, sV, L::kT, sdP,
                                              L::kS);
    __syncthreads();
    bwd_probs<kTile>(a, sS, sdP, sLse, sDelta, q0, k0, L::kS);
    __syncthreads();
    gemm<kTile, D, kTile, false, false, true>(sdP, L::kS, sK, L::kT, sdQ,
                                              L::kO);
  }
  __syncthreads();
  store_rows<D>(static_cast<float*>(a.out0), sdQ, L::kO, a, b, h, q0, kTile);
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes, the period of the
// 128-byte swizzle (each kernel asks for 1024 bytes more than it carves).
__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA data.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A box of a rank-4 tensor map ([D, H, L, B]) into shared memory; the
// barrier counts its bytes.  Coordinates past the tensor read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of a tile as TMA's 128-byte swizzle
// lays it out: rows of 128 bytes (64 bf16), in atoms of 8 rows (1024
// bytes).  sbo: the stride between 8-row groups (1024); lbo: for an
// MN-major operand, the stride between its 64-element column panels (unused
// by a K-major one, whose k16 steps advance the start by 32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// K-major: the k16 step kk of a tile of `rows` rows stored as 64-column
// panels (k16 steps are 32 bytes along a panel's 128-byte rows).
__device__ __forceinline__ uint64_t kmajor_desc(const char* tile, int rows,
                                                int kk) {
  return sw128_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major: the k16 step kk (16 rows, 2048 bytes) of a tile of `rows` rows
// stored as 64-column panels, its N columns running across the panels.
__device__ __forceinline__ uint64_t mnmajor_desc(const char* tile, int rows,
                                                 int kk) {
  return sw128_desc(tile + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins an accumulator across wgmma's asynchrony: no read or write of d may
// move across this point.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 rounded to bf16, the lower column in the low half: an A-operand
// register of wgmma.  For 16-bit operands the f32 accumulator of
// m64nNk16 holds, per thread, the same (row, column) pairs as the A
// fragment of m64nKk16 over those columns, so a[k] = (d[2k], d[2k+1]).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 operands, f32 accumulators in registers.  A thread
// t of the warpgroup (warp w = t / 32, lane l) holds d[i] at row
// 16 w + l / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.

// d[64 x 32] (+)= a . b, both from shared memory, K-major (acc = 0: d = a . b).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] (+)= a . b, both from shared memory, K-major (acc = 0: d = a . b).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += a . b: a in registers, b from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += a . b: a in registers, b from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ---------------------------------------------------------------------------
// forward, bf16 (Hopper design)
// ---------------------------------------------------------------------------
//
// Replaces _fwd_call/_fwd_kernel (pytorch_ps_mpi_tpu/ops/flash_attention.py).
//
// Bound: at the LM's [16, 1024, 16, 64], causal, the forward is bound by
// bytes on paper (q, k, v and o once each), but the shared-memory design
// before this one ran at 21x that bound: every product went through shared
// memory as f32 (WMMA hides which row a fragment element holds), the
// softmax reread it a row per warp, and four block barriers per k step left
// the tensor cores idle while tiles were copied.
//
// Design.  One block per 128-row q tile of one (batch, head): two consumer
// warpgroups of 64 q rows and one producer warp (288 threads).
//   * Q (the 128 rows, resident) and a ring of kStages K/V stages of 64 k
//     rows each sit in shared memory in TMA's 128-byte swizzle, one panel
//     of 64 columns per 128 bytes of a row.  The producer warp's first
//     thread loads them by TMA from rank-4 tensor maps over [D, H, L, B]
//     built from the operands' strides (the model's strided q/k/v views go
//     in as they are); rows past L arrive as zeros.  A "full" mbarrier per
//     stage counts the bytes in; an "empty" one counts the 256 consumer
//     threads out, and only then is the stage refilled, so the copy of the
//     next tiles overlaps the products on this one.
//   * S = Q.K^T runs as wgmma m64n64k16 from shared memory into registers.
//     The mask, scale, running max (a row lives in the 4 threads of a quad:
//     two shuffles), exp, row sum and the rescale of the O accumulator run
//     on those registers; no score or accumulator tile touches shared
//     memory.  p is rounded to bf16 in registers (the Pallas rounding before
//     p.v) and is wgmma's register A operand of O += P.V, with V from
//     shared memory as an MN-major B operand (wgmma's transpose bit).
//   * Causal: the block stops at the diagonal of its last row, and the
//     first warpgroup skips the last k tile, wholly above its own rows
//     (it still waits for and releases the stage); the heaviest q tiles
//     are launched first.  Only tiles on the diagonal or past L are masked.
//   * The epilogue writes o ([B, L, H, D]) and lse from registers.
// Shared memory: Q 128 x D plus kStages x (K, V) of 64 x D, bf16: 48 KB at
// D = 64, 96 KB at D = 128, plus 1 KB of alignment and the barriers.
// Registers: S (32 f32 a thread), O (D / 2), p (16); at D = 64 two blocks
// fit an SM (at most 112 registers a thread), at D = 128 one.
template <int D>
struct FwdBf16 {
  static constexpr int kRows = 128;  // q rows per block
  static constexpr int kKRows = 64;  // k rows per ring stage
  static constexpr int kStages = 2;
  static constexpr int kThreads = 288;
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kKRows * D * 2;  // one of K, V per stage
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 128;
};

template <int D>
__global__ void __launch_bounds__(FwdBf16<D>::kThreads,
                                  FwdBf16<D>::kMinBlocks)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, Args a) {
  using C = FwdBf16<D>;
  constexpr int kBK = C::kKRows, kS = C::kStages, kPanels = D / 64;
  extern __shared__ char smem_raw[];
  char* sQ = align1024(smem_raw);
  char* sK = sQ + C::kQBytes;
  char* sV = sK + kS * C::kKVBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + kS * C::kKVBytes);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kS;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_q = (a.L + C::kRows - 1) / C::kRows;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * C::kRows;  // heaviest first
  int n_k = (a.L + kBK - 1) / kBK;
  if (a.causal) n_k = min(n_k, (q0 + C::kRows - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp; its first thread copies
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_q, C::kQBytes);
      for (int p = 0; p < kPanels; ++p)
        tma_load_4d(sQ + p * C::kRows * 128, &tq, full_q, 64 * p, h, q0, b);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kS;
        mbar_wait(&empty[s], ((kt / kS) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKVBytes);
        for (int p = 0; p < kPanels; ++p) {
          const int off = s * C::kKVBytes + p * kBK * 128;
          tma_load_4d(sK + off, &tk, &full[s], 64 * p, h, kt * kBK, b);
          tma_load_4d(sV + off, &tv, &full[s], 64 * p, h, kt * kBK, b);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wq0 = q0 + 64 * wg;                // this warpgroup's first row
  const int r0 = wq0 + 16 * warp + lane / 4;   // rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);               // columns c0, c0 + 1 of 8
  const int wn_k = a.causal ? min(n_k, (wq0 + 63) / kBK + 1) : n_k;
  const char* sQw = sQ + wg * 64 * 128;

  float acc[D / 2], s[kBK / 2];
  uint32_t pa[kBK / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  mbar_wait(full_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % kS;
    mbar_wait(&full[st], (kt / kS) & 1);
    if (kt < wn_k) {
      const char* sKs = sK + st * C::kKVBytes;
      const char* sVs = sV + st * C::kKVBytes;
      // S = Q.K^T over D.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, kmajor_desc(sQw, C::kRows, kk), kmajor_desc(sKs, kBK, kk),
                 kk);
      wg_commit();
      wg_wait_all();
      reg_fence(s);

      const int k0 = kt * kBK;
      const bool edge = (a.causal && k0 + kBK - 1 > wq0) || k0 + kBK > a.L;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int hr = (i >> 1) & 1;
        float v = s[i] * a.scale;
        if (edge) {
          const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
          if (!(col < a.L && (!a.causal || r0 + 8 * hr >= col))) v = kNegInf;
        }
        s[i] = v;
        mx[hr] = fmaxf(mx[hr], v);
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr]);
        alpha[hr] = expf(m[hr] - m_new);
        m[hr] = m_new;
        l[hr] *= alpha[hr];
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float p = expf(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;
        s[i] = p;
      }
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i)
        pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P.V over the stage's k rows.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs(acc, pa + 4 * kk, mnmajor_desc(sVs, kBK, kk));
      wg_commit();
      wg_wait_all();
      reg_fence(acc);
    }
    mbar_arrive(&empty[st]);
  }

  bf16* o = static_cast<bf16*>(a.out0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int pos = r0 + 8 * hr;
    if (pos < a.L) {
      const float safe = l[hr] > 0.0f ? l[hr] : 1.0f;
      bf16* row = o + (((long long)b * a.L + pos) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * hr;
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
            __floats2bfloat162_rn(acc[i] / safe, acc[i + 1] / safe);
      }
      if (lane % 4 == 0)
        a.lse_out[(long long)bh * a.L + pos] = m[hr] + logf(safe);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, bf16: dK, dV (Hopper design)
// ---------------------------------------------------------------------------
//
// Replaces _bwd_call's first call, _bwd_dkdv_kernel
// (pytorch_ps_mpi_tpu/ops/flash_attention.py).
//
// Bound: operations (four products per (q, k) pair).  The shared-memory
// design before this one staged S, dP, P, dS and both f32 accumulators in
// 125 KB of shared memory, one block of 8 warps per SM, four block
// barriers per q step, and ran at 30x that bound.
//
// Design.  One block per k tile of one (batch, head): kConsumers
// warpgroups of 64 k rows and one producer warp, sweeping the q tiles from
// the causal diagonal down.
//   * K and V (the block's rows) are loaded once; Q, dO and their lse and
//     delta stream through a ring of kStages stages of kQRows q rows, with
//     full/empty mbarriers as in the forward.  Q and dO come by TMA; lse and
//     delta by the producer warp's own loads (zero past L, as the plain
//     version pads them), since a TMA box of the flat [B * H * L] vectors
//     would start at bh * L + q0, not 16-byte aligned when L is odd.
//   * S^T = K.Q^T and dP^T = V.dO^T run as wgmma from shared memory into
//     registers, so each thread owns k rows, the rows dK and dV sum over.
//     P^T = exp(mask ? S^T * scale - lse : NEG_INF) and
//     dS^T = P^T (dP^T - delta) scale are formed in registers, with lse and
//     delta indexed by column from the stage's vectors.
//   * P^T and dS^T, rounded to bf16 in registers, are the register A
//     operands of dV += P^T.dO and dK += dS^T.Q, with dO and Q from shared
//     memory as MN-major B operands.  The dK and dV accumulators stay in
//     registers for the whole sweep and are written once at the end.
//   * Causal: a warpgroup skips the q tiles wholly above its k rows
//     (waiting for and releasing their stages).  Only tiles on the
//     diagonal or past L are masked.  No atomics: each block owns its dK
//     and dV rows, so the result is deterministic.
// Registers: dK, dV, S^T and dP^T take 128 f32 a thread at D = 64 (q
// stages of 64 rows) and 160 at D = 128 (q stages of 32 rows).  A warp may
// hold at most a third of an SM quarter's 16,384 registers when three warps
// share it, as they do in a block of nine (168 a thread): D = 64 fits
// there, two consumer warpgroups; D = 128 does not, and takes one (five
// warps, up to 255 registers a thread).
// Shared memory: K, V kRows x D plus kStages x (Q, dO of kQRows x D, lse,
// delta), bf16: 65 KB at D = 64 (128 k rows), 65 KB at D = 128 (64 k
// rows), plus 1 KB of alignment and the barriers.
template <int D>
struct DkdvBf16 {
  static constexpr int kConsumers = D == 64 ? 2 : 1;  // warpgroups
  static constexpr int kRows = 64 * kConsumers;       // k rows per block
  static constexpr int kQRows = D == 64 ? 64 : 32;    // q rows per stage
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kKBytes = kRows * D * 2;    // one of K, V
  static constexpr int kQBytes = kQRows * D * 2;   // one of Q, dO per stage
  static constexpr int kVecBytes = kQRows * 4;     // one of lse, delta
  static constexpr size_t kSmem =
      1024 + 2 * kKBytes + kStages * 2 * (kQBytes + kVecBytes) + 128;
};

template <int D>
__global__ void __launch_bounds__(DkdvBf16<D>::kThreads, 1)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               Args a) {
  using C = DkdvBf16<D>;
  constexpr int kBQ = C::kQRows, kS = C::kStages, kPanels = D / 64;
  constexpr int kConsumerThreads = 128 * C::kConsumers;
  extern __shared__ char smem_raw[];
  char* sK = align1024(smem_raw);
  char* sV = sK + C::kKBytes;
  char* sQ = sV + C::kKBytes;             // stage s at s * kQBytes
  char* sdO = sQ + kS * C::kQBytes;
  float* sLse = reinterpret_cast<float*>(sdO + kS * C::kQBytes);
  float* sDelta = sLse + kS * kBQ;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sDelta + kS * kBQ);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kS;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = (int)blockIdx.y * C::kRows;  // k tile 0 sweeps the most
  const int n_q = (a.L + kBQ - 1) / kBQ;
  const int i0 = a.causal ? k0 / kBQ : 0;    // first q tile that meets k0
  const int n_steps = n_q - i0;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(full_kv, 2 * C::kKBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load_4d(sK + p * C::kRows * 128, &tk, full_kv, 64 * p, h, k0, b);
        tma_load_4d(sV + p * C::kRows * 128, &tv, full_kv, 64 * p, h, k0, b);
      }
    }
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % kS, q0 = (i0 + t) * kBQ;
      mbar_wait(&empty[s], ((t / kS) & 1) ^ 1);
      for (int i = lane; i < kBQ; i += 32) {
        const int pos = q0 + i;
        const long long at = (long long)bh * a.L + pos;
        sLse[s * kBQ + i] = pos < a.L ? a.lse[at] : 0.0f;
        sDelta[s * kBQ + i] = pos < a.L ? a.delta[at] : 0.0f;
      }
      if (lane == 0) {  // its arrival, with the bytes of Q and dO to come
        mbar_expect_tx(&full[s], 2 * C::kQBytes);
        for (int p = 0; p < kPanels; ++p) {
          const int off = s * C::kQBytes + p * kBQ * 128;
          tma_load_4d(sQ + off, &tq, &full[s], 64 * p, h, q0, b);
          tma_load_4d(sdO + off, &tdo, &full[s], 64 * p, h, q0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wk0 = k0 + 64 * wg;                // this warpgroup's first k row
  const int r0 = wk0 + 16 * warp + lane / 4;   // k rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);               // q columns c0, c0 + 1 of 8
  const char* sKw = sK + wg * 64 * 128;
  const char* sVw = sV + wg * 64 * 128;

  float dk[D / 2], dv[D / 2], st[kBQ / 2], dp[kBQ / 2];
  uint32_t pa[kBQ / 4], da[kBQ / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kBQ / 2; ++i) st[i] = dp[i] = 0.0f;

  mbar_wait(full_kv, 0);
  for (int t = 0; t < n_steps; ++t) {
    const int s = t % kS, q0 = (i0 + t) * kBQ;
    mbar_wait(&full[s], (t / kS) & 1);
    if (!(a.causal && q0 + kBQ - 1 < wk0)) {
      const char* sQs = sQ + s * C::kQBytes;
      const char* sdOs = sdO + s * C::kQBytes;
      // S^T = K.Q^T and dP^T = V.dO^T over D.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, kmajor_desc(sKw, C::kRows, kk),
                 kmajor_desc(sQs, kBQ, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, kmajor_desc(sVw, C::kRows, kk),
                 kmajor_desc(sdOs, kBQ, kk), kk);
      wg_commit();
      wg_wait_all();
      reg_fence(st);
      reg_fence(dp);

      const float* lse = sLse + s * kBQ;
      const float* dlt = sDelta + s * kBQ;
      const bool edge = (a.causal && q0 < wk0 + 63) || q0 + kBQ > a.L ||
                        wk0 + 64 > a.L;
      // A column pair at a time, packed as soon as formed: S^T and dP^T
      // die pair by pair (the block's 168 registers a thread hold no more).
#pragma unroll
      for (int i = 0; i < kBQ / 4; ++i) {
        float p[2], ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * i + u, c = 8 * (e >> 2) + c0 + u;
          bool ok = true;
          if (edge) {
            const int qpos = q0 + c, kpos = r0 + 8 * ((e >> 1) & 1);
            ok = qpos < a.L && kpos < a.L && (!a.causal || qpos >= kpos);
          }
          p[u] = expf(ok ? st[e] * a.scale - lse[c] : kNegInf);
          ds[u] = p[u] * (dp[e] - dlt[c]) * a.scale;
        }
        pa[i] = pack_bf16(p[0], p[1]);
        da[i] = pack_bf16(ds[0], ds[1]);
      }

      // dV += P^T.dO and dK += dS^T.Q over the stage's q rows.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs(dv, pa + 4 * kk, mnmajor_desc(sdOs, kBQ, kk));
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs(dk, da + 4 * kk, mnmajor_desc(sQs, kBQ, kk));
      wg_commit();
      wg_wait_all();
      reg_fence(dv);
      reg_fence(dk);
    }
    mbar_arrive(&empty[s]);
  }

  bf16* dk_out = static_cast<bf16*>(a.out0);
  bf16* dv_out = static_cast<bf16*>(a.out1);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int pos = r0 + 8 * hr;
    if (pos >= a.L) continue;
    const long long row = (((long long)b * a.L + pos) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hr;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + row + 8 * j + c0) =
          __floats2bfloat162_rn(dk[i], dk[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + row + 8 * j + c0) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, bf16: dQ (Hopper design)
// ---------------------------------------------------------------------------
//
// Replaces _bwd_call's second call, _bwd_dq_kernel
// (pytorch_ps_mpi_tpu/ops/flash_attention.py).
//
// Bound: operations (three products per (q, k) pair), so the products run
// on wgmma from tiles that TMA keeps in flight, and nothing the products
// make goes through shared memory.
//
// Design.  The dK/dV kernel with the owned and streamed operands swapped:
// one block per q tile of one (batch, head), kConsumers warpgroups of 64 q
// rows and one producer warp, sweeping the k tiles up to the causal
// diagonal.
//   * Q and dO (the block's rows) are loaded once by TMA; K and V stream
//     through a ring of kStages stages of 64 k rows, with full/empty
//     mbarriers as in the forward.  lse and delta belong to q rows, so each
//     consumer thread loads its two rows' values once into registers (a TMA
//     box of the flat [B * H * L] vectors would start at bh * L + q0, not
//     16-byte aligned when L is odd); zero past L, as the plain version pads
//     them.
//   * S = Q.K^T and dP = dO.V^T run as wgmma m64n64k16 from shared memory
//     (both operands K-major over D) into registers, so each thread owns q
//     rows, the rows dQ sums over.  P = exp(mask ? S * scale - lse :
//     NEG_INF) and dS = P (dP - delta) scale are formed a column pair at a
//     time and rounded to bf16 pairs at once: the accumulator layout of one
//     product is the register A layout of the next, so dS needs no shuffle.
//   * dQ += dS.K runs as wgmma with dS in registers and K from shared memory
//     as an MN-major B operand (N = D), as dK/dV reads Q for dK += dS^T.Q.
//     The dQ accumulator stays in registers for the whole sweep and is
//     written once, as bf16 pairs straight into [B, L, H, D].
//   * Causal: the block stops at its last row's diagonal; a warpgroup waits
//     for and releases the stages wholly above its own rows; the heaviest
//     q tiles are launched first.  Only tiles on the diagonal or past L are
//     masked, before the exp.
// Registers: dQ (D / 2 f32 a thread), S and dP (32 each) and the packed dS
// (16) are 112 values at D = 64 and 144 at D = 128; ptxas gives 128 and 160
// registers a thread, no spill, under the 168 of a block of nine warps, so
// both head dims take two consumer warpgroups.
// Shared memory: Q, dO kRows x D plus kStages x (K, V) of 64 x D, bf16:
// 64 KB at D = 64, 128 KB at D = 128, plus 1 KB of alignment and the
// barriers.
template <int D>
struct DqBf16 {
  static constexpr int kConsumers = 2;            // warpgroups
  static constexpr int kRows = 64 * kConsumers;   // q rows per block
  static constexpr int kKRows = 64;               // k rows per ring stage
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kQBytes = kRows * D * 2;    // one of Q, dO
  static constexpr int kKVBytes = kKRows * D * 2;  // one of K, V per stage
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 128;
};

template <int D>
__global__ void __launch_bounds__(DqBf16<D>::kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             Args a) {
  using C = DqBf16<D>;
  constexpr int kBK = C::kKRows, kS = C::kStages, kPanels = D / 64;
  constexpr int kConsumerThreads = 128 * C::kConsumers;
  extern __shared__ char smem_raw[];
  char* sQ = align1024(smem_raw);
  char* sdO = sQ + C::kQBytes;
  char* sK = sdO + C::kQBytes;  // stage s at s * kKVBytes
  char* sV = sK + kS * C::kKVBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + kS * C::kKVBytes);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kS;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_q = (a.L + C::kRows - 1) / C::kRows;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * C::kRows;  // heaviest first
  int n_k = (a.L + kBK - 1) / kBK;
  if (a.causal) n_k = min(n_k, (q0 + C::kRows - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warp
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(full_q, 2 * C::kQBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load_4d(sQ + p * C::kRows * 128, &tq, full_q, 64 * p, h, q0, b);
        tma_load_4d(sdO + p * C::kRows * 128, &tdo, full_q, 64 * p, h, q0,
                    b);
      }
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kS;
        mbar_wait(&empty[s], ((kt / kS) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKVBytes);
        for (int p = 0; p < kPanels; ++p) {
          const int off = s * C::kKVBytes + p * kBK * 128;
          tma_load_4d(sK + off, &tk, &full[s], 64 * p, h, kt * kBK, b);
          tma_load_4d(sV + off, &tv, &full[s], 64 * p, h, kt * kBK, b);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wq0 = q0 + 64 * wg;                // this warpgroup's first row
  const int r0 = wq0 + 16 * warp + lane / 4;   // q rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);               // k columns c0, c0 + 1 of 8
  const int wn_k = a.causal ? min(n_k, (wq0 + 63) / kBK + 1) : n_k;
  const char* sQw = sQ + wg * 64 * 128;
  const char* sdOw = sdO + wg * 64 * 128;

  float lse[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int pos = r0 + 8 * hr;
    const long long at = (long long)bh * a.L + pos;
    lse[hr] = pos < a.L ? a.lse[at] : 0.0f;
    dlt[hr] = pos < a.L ? a.delta[at] : 0.0f;
  }
  float dq[D / 2], s[kBK / 2], dp[kBK / 2];
  uint32_t da[kBK / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.0f;

  mbar_wait(full_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % kS;
    mbar_wait(&full[st], (kt / kS) & 1);
    if (kt < wn_k) {
      const char* sKs = sK + st * C::kKVBytes;
      const char* sVs = sV + st * C::kKVBytes;
      // S = Q.K^T and dP = dO.V^T over D.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, kmajor_desc(sQw, C::kRows, kk), kmajor_desc(sKs, kBK, kk),
                 kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, kmajor_desc(sdOw, C::kRows, kk),
                 kmajor_desc(sVs, kBK, kk), kk);
      wg_commit();
      wg_wait_all();
      reg_fence(s);
      reg_fence(dp);

      const int k0 = kt * kBK;
      const bool edge = (a.causal && k0 + kBK - 1 > wq0) || k0 + kBK > a.L ||
                        wq0 + 64 > a.L;
      // A column pair at a time, packed as soon as formed: S and dP die
      // pair by pair.
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const int hr = i & 1;  // elements 2i, 2i + 1 lie in row r0 + 8 hr
        float ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * i + u;
          bool ok = true;
          if (edge) {
            const int qpos = r0 + 8 * hr, kpos = k0 + 8 * (i >> 1) + c0 + u;
            ok = qpos < a.L && kpos < a.L && (!a.causal || qpos >= kpos);
          }
          const float p = expf(ok ? s[e] * a.scale - lse[hr] : kNegInf);
          ds[u] = p * (dp[e] - dlt[hr]) * a.scale;
        }
        da[i] = pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS.K over the stage's k rows.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs(dq, da + 4 * kk, mnmajor_desc(sKs, kBK, kk));
      wg_commit();
      wg_wait_all();
      reg_fence(dq);
    }
    mbar_arrive(&empty[st]);
  }

  bf16* out = static_cast<bf16*>(a.out0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int pos = r0 + 8 * hr;
    if (pos >= a.L) continue;
    const long long row = (((long long)b * a.L + pos) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hr;
      *reinterpret_cast<__nv_bfloat162*>(out + row + 8 * j + c0) =
          __floats2bfloat162_rn(dq[i], dq[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

// How one kernel is launched: its block, the rows of the tile a block owns
// (the grid's y extent is ceil(L / rows)), the rows of each ring stage of
// the operand it streams (the Hopper kernels' TMA boxes), and its dynamic
// shared memory.
struct Geometry {
  const void* fn;
  int threads, rows, ring_rows;
  size_t smem;
};

template <int D>
Geometry geometry(Kind kind, int dtype) {
  if (dtype == 1 && kind == kFwd)
    return {(const void*)flash_fwd_bf16_kernel<D>, FwdBf16<D>::kThreads,
            FwdBf16<D>::kRows, FwdBf16<D>::kKRows, FwdBf16<D>::kSmem};
  if (dtype == 1 && kind == kDkdv)
    return {(const void*)flash_bwd_dkdv_bf16_kernel<D>, DkdvBf16<D>::kThreads,
            DkdvBf16<D>::kRows, DkdvBf16<D>::kQRows, DkdvBf16<D>::kSmem};
  if (dtype == 1)
    return {(const void*)flash_bwd_dq_bf16_kernel<D>, DqBf16<D>::kThreads,
            DqBf16<D>::kRows, DqBf16<D>::kKRows, DqBf16<D>::kSmem};
  if (kind == kFwd)
    return {(const void*)flash_fwd_f32_kernel<D>, kThreads, kTile, 0,
            fwd_f32_smem_bytes<D>()};
  if (kind == kDkdv)
    return {(const void*)flash_bwd_dkdv_f32_kernel<D>, kThreads, kTile, 0,
            dkdv_f32_smem_bytes<D>()};
  return {(const void*)flash_bwd_dq_f32_kernel<D>, kThreads, kTile, 0,
          dq_f32_smem_bytes<D>()};
}

bool find_geometry(Kind kind, int dtype, int d, Geometry* g) {
  if (dtype != 0 && dtype != 1) return false;
  if (d == 64) *g = geometry<64>(kind, dtype);
  else if (d == 128) *g = geometry<128>(kind, dtype);
  else return false;
  return true;
}

// cuTensorMapEncodeTiled lives in libcuda; the runtime's entry-point query
// hands it over, so the library needs no -lcuda at link time.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [B, L, H, D] operand as a rank-4 map over [D, H, L, B] (strides in
// bytes), read in boxes of 64 columns x `rows` rows of one (batch, head),
// swizzled 128 bytes as wgmma reads them; coordinates past the tensor
// read as zeros.
bool rows_map(CUtensorMap* map, const void* base, const Strides& st, int d,
              const Args& a, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)a.H,
                              (cuuint64_t)a.L, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const Geometry& g, void** params, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      g.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return err;
  // One block per (batch x head, tile of g.rows rows that the block owns).
  const dim3 grid((unsigned int)(a.B * a.H),
                  (unsigned int)((a.L + g.rows - 1) / g.rows));
  err = cudaLaunchKernel(g.fn, grid, dim3(g.threads), params, g.smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t dispatch(Kind kind, int dtype, int d, const Args& a,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.L <= 0 || a.B * a.H <= 0) return cudaSuccess;
  Geometry g;
  if (!find_geometry(kind, dtype, d, &g)) return cudaErrorInvalidValue;
  Args args = a;
  if (g.ring_rows == 0) {  // a shared-memory kernel: Args alone
    void* params[] = {&args};
    return launch(g, params, a, s);
  }
  // The Hopper kernels read their operands through TMA tensor maps, passed
  // by value (__grid_constant__), in boxes of the rows a block owns (q and
  // dO for the forward and dQ, k and v for dK/dV) or of a ring stage.
  const bool owns_q = kind != kDkdv;
  const int q_rows = owns_q ? g.rows : g.ring_rows;
  const int k_rows = owns_q ? g.ring_rows : g.rows;
  CUtensorMap tq, tk, tv, tdo;
  if (!rows_map(&tq, a.q, a.sq, d, a, q_rows) ||
      !rows_map(&tk, a.k, a.sk, d, a, k_rows) ||
      !rows_map(&tv, a.v, a.sv, d, a, k_rows))
    return cudaErrorInvalidValue;
  if (kind == kFwd) {
    void* params[] = {&tq, &tk, &tv, &args};
    return launch(g, params, a, s);
  }
  if (!rows_map(&tdo, a.dout, a.sdo, d, a, q_rows))
    return cudaErrorInvalidValue;
  void* params[] = {&tq, &tk, &tv, &tdo, &args};
  return launch(g, params, a, s);
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

// What the kernel of (kind 0 fwd / 1 dkdv / 2 dq, dtype, d) occupies, into
// out[6]: threads per block, rows per block, dynamic shared memory bytes,
// registers per thread, local (spill) bytes per thread, resident blocks
// per SM.
int ps_flash_kernel_info(int kind, int dtype, int d, int* out) {
  Geometry g;
  if (kind < kFwd || kind > kDq || !find_geometry((Kind)kind, dtype, d, &g))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, g.fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        g.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, g.fn,
                                                        g.threads, g.smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = g.threads;
  out[1] = g.rows;
  out[2] = (int)g.smem;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = blocks;
  return 0;
}

const char* ps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
