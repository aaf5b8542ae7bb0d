// Gradient-codec kernels for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// These replace the three Pallas TPU kernels of the JAX package's codec hot
// path (pytorch_ps_mpi_tpu/ops/pallas_kernels.py):
//
//   ps_block_quantize      <- block_quantize_tpu     (_quantize_kernel)
//   ps_block_dequant_sum   <- block_dequant_sum_tpu  (_dequant_sum_kernel)
//   ps_cast_sum            <- cast_sum_tpu           (_cast_sum_kernel)
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrappers in ops/codec_kernels.py allocate
// every output, check shapes, strides and alignment, and raise on a nonzero
// return.  The plain PyTorch versions beside those wrappers compute the same
// bits, and chip_smoke.py holds each kernel against its plain version.
//
// All three are bound by device memory: each element is touched by a handful
// of arithmetic instructions, far below the ~20 FLOP per byte at which an
// H100 (3.35 TB/s, 67 TFLOP/s f32 off the tensor cores) stops being bound by
// its memory.  The least time for a call is its bytes over 3.35 TB/s: every
// input read once and every output written once.  So the designs below aim
// at one pass of 16-byte (or 8-/4-byte for narrow types) coalesced accesses
// per thread, and nothing else.
//
// Numerics follow the JAX package exactly.  Build without --use_fast_math:
// the quantizer divides with __fdiv_rn and rounds with rintf (half to even,
// as jnp.round), and the decode sums use __fmul_rn/__fadd_rn so that nvcc
// cannot contract a multiply and an add into an FMA.  The sums run over the
// ranks in order 0..w-1, starting from rank 0's value, as the Pallas kernels
// accumulate them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// block_quantize
// ---------------------------------------------------------------------------
// Pallas: one grid step per (block_rows x 128) tile, the whole tile in VMEM;
// amax -> scale -> round -> clip -> cast in one pass over it.
//
// Bound: bytes (each f32 read once, each code written once), so the card's
// SMs all need loads in flight: one block per tile would keep 36 of the 132
// SMs busy on ResNet-18's largest gradient (36 tiles of 256 KB), and a tile
// does not fit one block's registers, so it would be read twice.
//
// Here: a thread-block cluster of `c` CTAs per tile (c <= 8, the portable
// cluster size; the wrapper's cluster_ctas picks it from the tile size), so
// each CTA's share of the tile, at most kMaxVec float4 groups a thread,
// sits in registers:
//   1. each thread starts all of its float4 loads at once, so they are in
//      flight together, and reduces max|x| over them;
//   2. warp shuffles, then the CTA through shared memory, give the CTA's
//      partial max, which its shared memory holds for the cluster;
//   3. after a cluster barrier one warp reads the c partials through
//      distributed shared memory (mapa + ld.shared::cluster), and every CTA
//      derives the same scale; cluster rank 0 writes it to `scales`;
//   4. each thread quantizes from its registers and stores its codes four
//      at a time.  A second cluster barrier, arrived at once the partials
//      are read and waited on before exit, keeps every CTA's shared memory
//      alive while a peer may still read it.
// So device memory sees each input byte once and each output byte once, and
// a 36-tile gradient fills 288 CTAs.  A tile larger than c * kThreads *
// kMaxVec groups (block_rows > 512) reads what its registers do not hold a
// second time, from L2.  The kernel reads the unpadded flat gradient and
// treats the tail past n as zeros, which saves the padding copy; the codes
// keep the padded (n_blocks * block_rows, 128) shape.
//
// NaN: jnp.max propagates NaN, so a tile holding one gets amax = NaN, the
// scale falls to 1.0 through `amax > 0`, and the NaN element converts to 0.
// CUDA's fmaxf would drop the NaN, so the reduction runs over the bit
// patterns of |x| as unsigned integers: for non-negative floats the integer
// order is the float order, and every NaN sorts above +inf.

constexpr int kMaxCluster = 8;  // CTAs per tile, the portable cluster size
constexpr int kMaxVec = 8;      // float4 groups a thread holds in registers

__device__ __forceinline__ float4 load4_tail(const float* __restrict__ x,
                                             long long e, long long n,
                                             bool vec) {
  if (vec && e + 3 < n) return *reinterpret_cast<const float4*>(x + e);
  float4 v;
  v.x = e < n ? x[e] : 0.0f;
  v.y = e + 1 < n ? x[e + 1] : 0.0f;
  v.z = e + 2 < n ? x[e + 2] : 0.0f;
  v.w = e + 3 < n ? x[e + 3] : 0.0f;
  return v;
}

__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

__device__ __forceinline__ unsigned int abs_bits4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)),
             max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ float quantize_one(float v, float scale,
                                              float qmax) {
  float r = rintf(__fdiv_rn(v, scale));
  if (isnan(r)) return 0.0f;  // XLA's float->int convert of NaN
  return fminf(fmaxf(r, -qmax), qmax);
}

__device__ __forceinline__ void store4(int8_t* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<char4*>(p) = make_char4(
      (signed char)a, (signed char)b, (signed char)c, (signed char)d);
}

__device__ __forceinline__ void store4(int16_t* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<short4*>(p) = make_short4((short)a, (short)b, (short)c,
                                              (short)d);
}

template <typename QT>
__device__ __forceinline__ void quantize4(QT* q, float4 v, float scale,
                                          float qmax) {
  store4(q, quantize_one(v.x, scale, qmax), quantize_one(v.y, scale, qmax),
         quantize_one(v.z, scale, qmax), quantize_one(v.w, scale, qmax));
}

__device__ __forceinline__ unsigned int cluster_rank() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The word at `p` in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ unsigned int load_peer(const unsigned int* p,
                                                  unsigned int rank) {
  const unsigned int local =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  unsigned int remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename QT>
__global__ void __launch_bounds__(kThreads)
block_quantize_kernel(const float* __restrict__ x, long long n, int tile,
                      int ctas, bool vec, float qmax, QT* __restrict__ q,
                      float* __restrict__ scales) {
  const unsigned int rank = cluster_rank();
  const long long blk = blockIdx.x / ctas;
  const int share = tile / 4 / ctas;  // float4 groups of this CTA
  const long long base = blk * tile + 4LL * rank * share;

  float4 v[kMaxVec];
  unsigned int m = 0u;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int g = threadIdx.x + j * kThreads;
    v[j] = g < share ? load4_tail(x, base + 4LL * g, n, vec)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) m = max(m, abs_bits4(v[j]));
  // What the registers do not hold (block_rows > 512 only).
  for (int g = threadIdx.x + kMaxVec * kThreads; g < share; g += kThreads)
    m = max(m, abs_bits4(load4_tail(x, base + 4LL * g, n, vec)));
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));

  __shared__ unsigned int warp_max[kWarps];
  __shared__ unsigned int cta_max;  // read by the whole cluster
  __shared__ float tile_scale;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_max[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) cta_max = m;
  }
  cluster_arrive();  // cta_max is published to the cluster
  cluster_wait();
  if (warp == 0) {
    m = lane < ctas ? load_peer(&cta_max, lane) : 0u;
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) {
      const float amax = __uint_as_float(m);
      const float scale = amax > 0.0f ? __fdiv_rn(amax, qmax) : 1.0f;
      tile_scale = scale;
      if (rank == 0) scales[blk] = scale;
    }
  }
  cluster_arrive();  // this CTA has read its peers' cta_max
  __syncthreads();
  const float scale = tile_scale;

#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int g = threadIdx.x + j * kThreads;
    if (g < share) quantize4(q + base + 4LL * g, v[j], scale, qmax);
  }
  for (int g = threadIdx.x + kMaxVec * kThreads; g < share; g += kThreads)
    quantize4(q + base + 4LL * g, load4_tail(x, base + 4LL * g, n, vec),
              scale, qmax);
  cluster_wait();  // no peer reads this CTA's cta_max any more
}

// ---------------------------------------------------------------------------
// block_dequant_sum
// ---------------------------------------------------------------------------
// Pallas: grid (n_blocks, world) with the world minor, so one output tile
// stays in VMEM while the ranks' tiles stream through and add into it.
//
// Here: blocks run in no order, so nothing carries between them; the rank
// loop moves inside the thread.  One thread owns four consecutive elements:
// it loads four codes per rank (4 or 8 bytes), finds the tile's scale from
// element / tile, and keeps the four partial sums in registers, so the
// output is written once, 16 bytes per thread.  Codes may be strided views of
// a gathered bucket: each rank's row is contiguous, ranks are rank_stride
// elements apart.

template <typename QT>
struct Vec4;
template <>
struct Vec4<int8_t> {
  using type = char4;
};
template <>
struct Vec4<int16_t> {
  using type = short4;
};

template <typename QT>
__global__ void __launch_bounds__(kThreads)
block_dequant_sum_kernel(const QT* __restrict__ q, long long q_rank_stride,
                         const float* __restrict__ scales,
                         long long s_rank_stride, int world, long long total,
                         int tile, float* __restrict__ out) {
  const long long e =
      4LL * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (e >= total) return;
  const long long blk = e / tile;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = 0; r < world; ++r) {
    const typename Vec4<QT>::type c =
        *reinterpret_cast<const typename Vec4<QT>::type*>(
            q + r * q_rank_stride + e);
    const float s = scales[r * s_rank_stride + blk];
    const float a = __fmul_rn((float)c.x, s);
    const float b = __fmul_rn((float)c.y, s);
    const float d = __fmul_rn((float)c.z, s);
    const float f = __fmul_rn((float)c.w, s);
    if (r == 0) {
      acc = make_float4(a, b, d, f);
    } else {
      acc.x = __fadd_rn(acc.x, a);
      acc.y = __fadd_rn(acc.y, b);
      acc.z = __fadd_rn(acc.z, d);
      acc.w = __fadd_rn(acc.w, f);
    }
  }
  *reinterpret_cast<float4*>(out + e) = acc;
}

// ---------------------------------------------------------------------------
// cast_sum
// ---------------------------------------------------------------------------
// Pallas: the same world-minor grid as the dequant sum, minus the scales:
// each rank's bf16 tile is upcast in VMEM and added into the f32 tile.
//
// Here: the same thread-owns-four-elements loop over ranks, upcasting in
// registers, so the (world, n) f32 intermediate never exists.  The wire
// tensor is flat (world, n): the (rows x 128) padding of the Pallas kernel is
// TPU layout, not wire format.  A leaf gathered inside a shared bucket starts
// at any element offset, so the 8- or 16-byte loads are taken only when every
// rank's row is aligned for them (the wrapper decides); otherwise, and for the
// last ragged group, the thread loads element by element.

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cast_sum_kernel(const T* __restrict__ x, long long rank_stride, int world,
                long long n, bool vec, float* __restrict__ out) {
  const long long e =
      4LL * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (e >= n) return;
  if (vec && e + 3 < n) {
    float4 acc = load4(x + e);
    for (int r = 1; r < world; ++r) {
      const float4 v = load4(x + r * rank_stride + e);
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    *reinterpret_cast<float4*>(out + e) = acc;
    return;
  }
  for (long long k = e; k < e + 4 && k < n; ++k) {
    float acc = to_f32(x[k]);
    for (int r = 1; r < world; ++r)
      acc = __fadd_rn(acc, to_f32(x[r * rank_stride + k]));
    out[k] = acc;
  }
}

inline unsigned int grid_for(long long groups) {
  return (unsigned int)((groups + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// x: n contiguous f32 (16-byte aligned when vec); q: (n_blocks * tile)
// int8 (bits 8) or int16 (bits 16); scales: n_blocks f32.  ctas: the
// cluster size, CTAs per tile (1, 2, 4 or 8, dividing the tile's float4
// groups).
int ps_block_quantize(const void* x, long long n, int tile,
                      long long n_blocks, int bits, int vec, int ctas,
                      void* q, void* scales, void* stream) {
  if (ctas < 1 || ctas > kMaxCluster || (ctas & (ctas - 1)) || tile % 4 ||
      (tile / 4) % ctas || n_blocks * ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(n_blocks * ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned int)ctas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const float* xf = (const float*)x;
  cudaError_t err;
  if (bits == 8)
    err = cudaLaunchKernelEx(&cfg, block_quantize_kernel<int8_t>, xf, n, tile,
                             ctas, vec != 0, qmax, (int8_t*)q,
                             (float*)scales);
  else
    err = cudaLaunchKernelEx(&cfg, block_quantize_kernel<int16_t>, xf, n,
                             tile, ctas, vec != 0, qmax, (int16_t*)q,
                             (float*)scales);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// q: world rows of `total` codes, q_rank_stride apart; scales: world rows of
// total / tile f32, s_rank_stride apart; out: total f32.
int ps_block_dequant_sum(const void* q, long long q_rank_stride, int bits,
                         const void* scales, long long s_rank_stride,
                         int world, long long total, int tile, void* out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = grid_for(total / 4);
  if (bits == 8) {
    block_dequant_sum_kernel<int8_t><<<grid, kThreads, 0, s>>>(
        (const int8_t*)q, q_rank_stride, (const float*)scales, s_rank_stride,
        world, total, tile, (float*)out);
  } else {
    block_dequant_sum_kernel<int16_t><<<grid, kThreads, 0, s>>>(
        (const int16_t*)q, q_rank_stride, (const float*)scales, s_rank_stride,
        world, total, tile, (float*)out);
  }
  return (int)cudaGetLastError();
}

// x: world rows of n elements, rank_stride apart; dtype 0 = f32, 1 = bf16,
// 2 = f16; out: n f32.
int ps_cast_sum(const void* x, long long rank_stride, int dtype, int world,
                long long n, int vec, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = grid_for((n + 3) / 4);
  if (dtype == 0) {
    cast_sum_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, rank_stride, world, n, vec != 0, (float*)out);
  } else if (dtype == 1) {
    cast_sum_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, rank_stride, world, n, vec != 0,
        (float*)out);
  } else {
    cast_sum_kernel<__half><<<grid, kThreads, 0, s>>>(
        (const __half*)x, rank_stride, world, n, vec != 0, (float*)out);
  }
  return (int)cudaGetLastError();
}

const char* ps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
