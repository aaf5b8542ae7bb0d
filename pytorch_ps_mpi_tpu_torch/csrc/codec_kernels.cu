// Gradient-codec kernels for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// These replace the three Pallas TPU kernels of the JAX package's codec hot
// path (pytorch_ps_mpi_tpu/ops/pallas_kernels.py):
//
//   ps_block_quantize           <- block_quantize_tpu     (_quantize_kernel)
//   ps_block_dequant_sum_group  <- block_dequant_sum_tpu  (_dequant_sum_kernel)
//   ps_cast_sum_group           <- cast_sum_tpu           (_cast_sum_kernel)
//
// The two decode sums take a whole group of leaves (a step's gradients) in
// one launch.  Each entry point launches on the stream it is given and
// returns cudaGetLastError(); the Python wrappers in ops/codec_kernels.py
// allocate every output, check shapes, strides and alignment, and raise on
// a nonzero return.  The plain PyTorch versions beside those wrappers
// compute the same bits, and chip_smoke.py holds each kernel against its
// plain version.
//
// All three are bound by device memory: each element is touched by a handful
// of arithmetic instructions, far below the ~20 FLOP per byte at which an
// H100 (3.35 TB/s, 67 TFLOP/s f32 off the tensor cores) stops being bound by
// its memory.  The least time for a call is its bytes over 3.35 TB/s: every
// input read once and every output written once.  So the designs below aim
// at one pass of 16-byte coalesced accesses per thread (4-byte code stores
// in the quantizer), and nothing else.
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

#include <vector>

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
// Grouped decode sums: block_dequant_sum and cast_sum over a leaf table
// ---------------------------------------------------------------------------
// Pallas: one call per leaf, grid (n_blocks, world) with the world minor,
// so one output tile stays in VMEM while the ranks' tiles stream through
// and add into it.  Under jit a step's calls sit in one XLA program.
//
// Here one launch decodes and sums all the leaves of a step: eager PyTorch
// would pay a launch (its ramp and tail on a few thousand elements, for
// most ResNet-18 leaves) and the host's wrapper call for every leaf.  The
// leaf table travels by value in the kernel's parameters
// (__grid_constant__, read through the constant cache), so no copy of it
// goes through the step's stream.  The parameter space holds 4 KB, or
// 32,764 bytes where the toolkit and the CUDA driver are 12.1 or later;
// a group the table cannot hold is split into as few consecutive launches
// as it needs.  Each CTA takes a fixed chunk of one leaf's elements and finds
// its leaf by a binary search over the table's prefix sums of chunks, so
// small leaves share the grid with large ones and no CTA idles on a
// 64-element bias.
//
// Bound: bytes (a multiply and an add per element and rank), most of them
// written: 4 f32 bytes out for each int8 code in.  So each thread takes
// kGroupVecs 16-byte vectors of every rank (16 int8 codes, 8 int16, bf16 or
// f16, or 4 f32 each) and issues the loads of all ranks and vectors
// (unrolled for world <= 8) before it sums; a warp then writes its sums as
// 16-byte stores contiguous across the warp, the sums moved between lanes
// by shuffles (store_warp).  Each thread storing its own vector's sums
// would leave the 32-byte sectors of every store half written: the int8
// decode then ran at under half its bound on an H100.  The output is one
// f32 buffer for the group, each leaf at an offset padded to 4 elements by
// the wrapper, and only a leaf's n valid elements are written.  The sums
// are those of the plain versions: __fmul_rn then __fadd_rn, ranks 0..w-1
// from rank 0's value.
//
// block_dequant_sum: codes may be strided views of a gathered bucket (each
// rank's row contiguous, q_stride elements apart) and are padded to whole
// tiles of a multiple of 1,024 elements, so a 16-byte vector never
// straddles two tiles (one scale per rank and vector) and never reads past
// the codes.  A leaf whose codes do not start, or whose ranks do not lie,
// 16 bytes apart takes an element-wise path.
//
// cast_sum: the wire rows are flat (the Pallas kernel's (rows x 128)
// padding is TPU layout, not wire format), and a leaf inside a shared
// bucket starts at any element offset.  Such a leaf sums its first `head`
// elements one by one, until its rows are 16-byte aligned, then runs the
// vectors, then its ragged tail one by one.  The vectors' stores are
// 16-byte stores where the output lines up with them, else element-wise.
// Where the ranks' rows are not 16 bytes apart (a bucket of odd length
// gathered from several ranks), the whole leaf is element-wise.

constexpr int kGroupVecs = 2;  // 16-byte vectors per thread and rank
constexpr int kUnroll = 8;     // ranks whose loads are issued together
constexpr int kSmallParams = 4096;
#if CUDART_VERSION >= 12010
constexpr int kLargeParams = 32764;
#else
constexpr int kLargeParams = kSmallParams;
#endif

struct DequantLeaf {
  const void* q;         // rank 0's codes; rank r's at q + r * q_stride
  const float* scales;   // rank 0's scales; rank r's at scales + r * s_stride
  long long q_stride;    // elements
  long long s_stride;    // elements
  float* out;            // n f32, 16-byte aligned
  long long n;
  int tile;              // elements per scale, a multiple of 1,024
  int vec;               // 16-byte loads
};

struct CastLeaf {
  const void* x;         // rank 0's row; rank r's at x + r * stride
  long long stride;      // elements
  float* out;            // n f32, 16-byte aligned
  long long n;
  int head;              // elements before the rows are 16-byte aligned
  int vec;               // 16-byte loads after the head
};

// The table of one launch: its leaves and the first chunk of each, with
// first_chunk[count] the launch's grid.
template <typename Leaf, int Bytes>
struct LeafTable {
  static constexpr int kCap =
      (Bytes - 16) / static_cast<int>(sizeof(Leaf) + sizeof(int));
  Leaf leaf[kCap];
  int first_chunk[kCap + 1];
  int count;
  int world;
};

template <typename Leaf>
constexpr bool fits_params() {
  return sizeof(LeafTable<Leaf, kSmallParams>) <= kSmallParams &&
         sizeof(LeafTable<Leaf, kLargeParams>) <= kLargeParams;
}
static_assert(fits_params<DequantLeaf>() && fits_params<CastLeaf>(),
              "a leaf table must fit the kernel parameter space");

// The leaf of chunk `chunk`: the last with first_chunk <= chunk.
template <typename Table>
__device__ __forceinline__ int find_leaf(const Table& t, int chunk) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= chunk)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// One 16-byte vector of T as floats (16 / sizeof(T) of them).
template <typename T>
__device__ __forceinline__ void to_floats(uint4 v, float* f);
template <>
__device__ __forceinline__ void to_floats<int8_t>(uint4 v, float* f) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}
template <>
__device__ __forceinline__ void to_floats<int16_t>(uint4 v, float* f) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] =
        static_cast<float>(static_cast<int16_t>(w[i / 2] >> (16 * (i % 2))));
}
template <>
__device__ __forceinline__ void to_floats<__nv_bfloat16>(uint4 v, float* f) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void to_floats<__half>(uint4 v, float* f) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
template <>
__device__ __forceinline__ void to_floats<float>(uint4 v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(int16_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The V sums of one vector: 16-byte stores where `out` is 16-byte aligned
// and all V are valid, else one by one up to `left`.
template <int V>
__device__ __forceinline__ void store_sums(float* out, const float* acc,
                                           long long left, bool aligned) {
  if (aligned && left >= V) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < left) out[j] = acc[j];
}

// The warp's 32 * V sums, lane l holding V consecutive ones (its vector),
// stored as 16-byte stores that are contiguous across the warp: store j of
// lane u takes the 4 sums at 128 j + 4 u, which lie in lane (32 / Q) j +
// u / Q as its 4-sum quad u % Q (Q = V / 4 quads a lane).  The quads move
// by shuffles in Q rounds: in round i, lane u fetches the quad of store
// (i + u % Q) % Q, so each lane sends one quad a round, to one lane.  Each
// lane's own stores would leave the warp's 16-byte stores 4 V bytes apart,
// half-filling the 32-byte sectors they touch; this writes whole sectors.
// All 32 lanes must hold valid sums.
template <int V>
__device__ __forceinline__ void store_warp(float* __restrict__ warp_out,
                                           const float* acc) {
  constexpr int Q = V / 4;
  constexpr int kSpread = 32 / Q;  // lanes a store's quads come from
  const int lane = threadIdx.x & 31;
  if constexpr (Q == 1) {  // f32: each lane's own store is contiguous
    *reinterpret_cast<float4*>(warp_out + 4 * lane) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
  float4 quad[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    // This lane sends its quad (lane / kSpread - i) mod Q ...
    const int k = (lane / kSpread - i + Q) % Q;
    float send[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      send[c] = acc[c];
#pragma unroll
      for (int kk = 1; kk < Q; ++kk)
        if (k == kk) send[c] = acc[4 * kk + c];
    }
    // ... and fetches the quad of store j from lane kSpread j + lane / Q.
    const int j = (i + lane % Q) % Q;
    const int src = kSpread * j + lane / Q;
    float got[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) got[c] = __shfl_sync(0xffffffffu, send[c], src);
#pragma unroll
    for (int jj = 0; jj < Q; ++jj)
      if (j == jj) quad[jj] = make_float4(got[0], got[1], got[2], got[3]);
  }
#pragma unroll
  for (int j = 0; j < Q; ++j)
    *reinterpret_cast<float4*>(warp_out + 128 * j + 4 * lane) = quad[j];
}

// acc[j] (+)= f32(v[j]) * s, the plain versions' unfused multiply and add.
template <typename T, int V>
__device__ __forceinline__ void add_scaled(float* acc, uint4 v, float s,
                                           bool first) {
  float d[V];
  to_floats<T>(v, d);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float p = __fmul_rn(d[j], s);
    acc[j] = first ? p : __fadd_rn(acc[j], p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void add_cast(float* acc, uint4 v, bool first) {
  float d[V];
  to_floats<T>(v, d);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = first ? d[j] : __fadd_rn(acc[j], d[j]);
}

// W: the ranks unrolled, the least of 1, 2, 4, 8 that covers the world
// (ranks past 8 follow one at a time).
template <typename QT, int W, typename Table>
__global__ void __launch_bounds__(kThreads)
dequant_sum_group_kernel(const __grid_constant__ Table t) {
  constexpr int V = 16 / sizeof(QT);
  constexpr long long kChunk = (long long)kThreads * kGroupVecs * V;
  const int chunk = blockIdx.x;
  const int i = find_leaf(t, chunk);
  const DequantLeaf& L = t.leaf[i];
  const QT* __restrict__ q = static_cast<const QT*>(L.q);
  const float* __restrict__ scales = L.scales;
  const long long base = (chunk - t.first_chunk[i]) * kChunk;
  const long long n = L.n;
  const int world = t.world;

  if (!L.vec) {  // element by element, neighbouring threads on neighbours
#pragma unroll 1
    for (int k = 0; k < kGroupVecs * V; ++k) {
      const long long e = base + threadIdx.x + (long long)k * kThreads;
      if (e >= n) break;
      const long long blk = e / L.tile;
      float acc = __fmul_rn(to_f32(q[e]), scales[blk]);
      for (int r = 1; r < world; ++r)
        acc = __fadd_rn(acc, __fmul_rn(to_f32(q[r * L.q_stride + e]),
                                       scales[r * L.s_stride + blk]));
      L.out[e] = acc;
    }
    return;
  }

  uint4 c[kGroupVecs][W];
  float s[kGroupVecs][W];
  long long e[kGroupVecs];
#pragma unroll
  for (int g = 0; g < kGroupVecs; ++g) {
    e[g] = base + (long long)(threadIdx.x + g * kThreads) * V;
    if (e[g] < n) {
      const long long blk = e[g] / L.tile;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        if (r < world) {
          c[g][r] = load16(q + r * L.q_stride + e[g]);
          s[g][r] = __ldg(scales + r * L.s_stride + blk);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kGroupVecs; ++g) {
    float acc[V];
    if (e[g] < n) {
#pragma unroll
      for (int r = 0; r < W; ++r)
        if (r < world) add_scaled<QT, V>(acc, c[g][r], s[g][r], r == 0);
      const long long blk = e[g] / L.tile;
      for (int r = W; r < world; ++r)
        add_scaled<QT, V>(acc, load16(q + r * L.q_stride + e[g]),
                          __ldg(scales + r * L.s_stride + blk), false);
    }
    // The warp's first element; the same in all its lanes.
    const long long first = e[g] - (long long)(threadIdx.x & 31) * V;
    if (first + 32 * V <= n)
      store_warp<V>(L.out + first, acc);
    else if (e[g] < n)
      store_sums<V>(L.out + e[g], acc, n - e[g], true);
  }
}

// Element e of a cast leaf, summed on its own.
template <typename T>
__device__ __forceinline__ void cast_one(const T* __restrict__ x,
                                         long long stride, int world,
                                         float* out, long long e) {
  float acc = to_f32(x[e]);
  for (int r = 1; r < world; ++r)
    acc = __fadd_rn(acc, to_f32(x[r * stride + e]));
  out[e] = acc;
}

template <typename T, int W, typename Table>
__global__ void __launch_bounds__(kThreads)
cast_sum_group_kernel(const __grid_constant__ Table t) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunkVecs = kThreads * kGroupVecs;
  const int chunk = blockIdx.x;
  const int i = find_leaf(t, chunk);
  const CastLeaf& L = t.leaf[i];
  const T* __restrict__ x = static_cast<const T*>(L.x);
  const long long local = chunk - t.first_chunk[i];
  const long long n = L.n;
  const int world = t.world;

  if (!L.vec) {  // element by element, neighbouring threads on neighbours
    const long long base = local * kChunkVecs * V;
#pragma unroll 1
    for (int k = 0; k < kGroupVecs * V; ++k) {
      const long long e = base + threadIdx.x + (long long)k * kThreads;
      if (e >= n) break;
      cast_one(x, L.stride, world, L.out, e);
    }
    return;
  }

  const long long head = L.head;
  const long long nvec = (n - head) / V;
  if (local == 0) {  // the head and the ragged tail
    if (threadIdx.x < head) cast_one(x, L.stride, world, L.out, threadIdx.x);
    const long long tail = head + nvec * V;
    if (threadIdx.x < n - tail)
      cast_one(x, L.stride, world, L.out, tail + threadIdx.x);
  }
  const T* __restrict__ xv = x + head;
  float* ov = L.out + head;
  const bool aligned = (reinterpret_cast<uintptr_t>(ov) & 15) == 0;

  uint4 c[kGroupVecs][W];
  long long v[kGroupVecs];
#pragma unroll
  for (int g = 0; g < kGroupVecs; ++g) {
    v[g] = local * kChunkVecs + threadIdx.x + g * kThreads;
    if (v[g] < nvec) {
#pragma unroll
      for (int r = 0; r < W; ++r)
        if (r < world) c[g][r] = load16(xv + r * L.stride + v[g] * V);
    }
  }
#pragma unroll
  for (int g = 0; g < kGroupVecs; ++g) {
    float acc[V];
    if (v[g] < nvec) {
#pragma unroll
      for (int r = 0; r < W; ++r)
        if (r < world) add_cast<T, V>(acc, c[g][r], r == 0);
      for (int r = W; r < world; ++r)
        add_cast<T, V>(acc, load16(xv + r * L.stride + v[g] * V), false);
    }
    // The warp's first vector; the same in all its lanes.
    const long long first = v[g] - (threadIdx.x & 31);
    if (aligned && first + 32 <= nvec)
      store_warp<V>(ov + first * V, acc);
    else if (v[g] < nvec)
      store_sums<V>(ov + v[g] * V, acc, V, aligned);
  }
}

// Whether this process may launch with the large table: the toolkit built
// it (CUDA >= 12.1) and the CUDA driver takes it.
bool large_params_ok() {
  static const bool ok = [] {
    int version = 0;
    return kLargeParams > kSmallParams &&
           cudaDriverGetVersion(&version) == cudaSuccess && version >= 12010;
  }();
  return ok;
}

template <typename Leaf>
int large_cap() {
  return large_params_ok() ? LeafTable<Leaf, kLargeParams>::kCap
                           : LeafTable<Leaf, kSmallParams>::kCap;
}

template <typename Leaf, int Bytes>
cudaError_t launch_table(void (*kernel)(LeafTable<Leaf, Bytes>),
                         const Leaf* leaves, const int* chunks, int count,
                         int world, cudaStream_t stream) {
  LeafTable<Leaf, Bytes> t;
  int grid = 0;
  for (int i = 0; i < count; ++i) {
    t.leaf[i] = leaves[i];
    t.first_chunk[i] = grid;
    grid += chunks[i];
  }
  t.first_chunk[count] = grid;
  t.count = count;
  t.world = world;
  void* args[] = {&t};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                          dim3(kThreads), args, 0, stream);
}

// Launch `count` leaves in as few launches as the table allows: the large
// table where the toolkit and CUDA driver take it, else the 4 KB one.  The
// wrapper has checked that the chunks sum to less than 2^31.
template <typename Leaf>
cudaError_t launch_group(void (*small)(LeafTable<Leaf, kSmallParams>),
                         void (*large)(LeafTable<Leaf, kLargeParams>),
                         const Leaf* leaves, const int* chunks, int count,
                         int world, cudaStream_t stream, int* launches) {
  const bool big = large_params_ok();
  const int cap = large_cap<Leaf>();
  for (int done = 0; done < count;) {
    const int take = count - done < cap ? count - done : cap;
    const cudaError_t err =
        big ? launch_table(large, leaves + done, chunks + done, take, world,
                           stream)
            : launch_table(small, leaves + done, chunks + done, take, world,
                           stream);
    if (err != cudaSuccess) return err;
    ++*launches;
    done += take;
  }
  return cudaSuccess;
}

template <typename QT, int W>
cudaError_t dequant_launch(const DequantLeaf* leaves, const int* chunks,
                           int count, int world, cudaStream_t stream,
                           int* launches) {
  return launch_group<DequantLeaf>(
      dequant_sum_group_kernel<QT, W, LeafTable<DequantLeaf, kSmallParams>>,
      dequant_sum_group_kernel<QT, W, LeafTable<DequantLeaf, kLargeParams>>,
      leaves, chunks, count, world, stream, launches);
}

template <typename T, int W>
cudaError_t cast_launch(const CastLeaf* leaves, const int* chunks, int count,
                        int world, cudaStream_t stream, int* launches) {
  return launch_group<CastLeaf>(
      cast_sum_group_kernel<T, W, LeafTable<CastLeaf, kSmallParams>>,
      cast_sum_group_kernel<T, W, LeafTable<CastLeaf, kLargeParams>>, leaves,
      chunks, count, world, stream, launches);
}

// W = the least of 1, 2, 4 and 8 that covers the world.
template <typename QT>
cudaError_t dequant_world(const DequantLeaf* leaves, const int* chunks,
                          int count, int world, cudaStream_t s, int* l) {
  if (world == 1) return dequant_launch<QT, 1>(leaves, chunks, count, 1, s, l);
  if (world == 2) return dequant_launch<QT, 2>(leaves, chunks, count, 2, s, l);
  if (world <= 4)
    return dequant_launch<QT, 4>(leaves, chunks, count, world, s, l);
  return dequant_launch<QT, kUnroll>(leaves, chunks, count, world, s, l);
}

template <typename T>
cudaError_t cast_world(const CastLeaf* leaves, const int* chunks, int count,
                       int world, cudaStream_t s, int* l) {
  if (world == 1) return cast_launch<T, 1>(leaves, chunks, count, 1, s, l);
  if (world == 2) return cast_launch<T, 2>(leaves, chunks, count, 2, s, l);
  if (world <= 4) return cast_launch<T, 4>(leaves, chunks, count, world, s, l);
  return cast_launch<T, kUnroll>(leaves, chunks, count, world, s, l);
}

constexpr long long kMaxGrid = 0x7fffffffLL;

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

// The group decode sums.  `rows` holds `count` leaves of kDequantFields or
// kCastFields 64-bit values each (below); `launches` gets the number of
// launches the group took.  The wrappers in ops/codec_kernels.py check
// shapes, dtypes and devices, pad each leaf's output offset to 4 elements
// and keep the tensors alive across the call.

// q (address), scales (address), q_stride, s_stride (elements between
// ranks), n, tile (elements per scale, a multiple of 1,024), out (address
// of n f32, 16-byte aligned).  bits: 8 (int8 codes) or 16 (int16).
int ps_block_dequant_sum_group(const long long* rows, int count, int world,
                               int bits, void* stream, int* launches) {
  *launches = 0;
  if (count < 0 || world < 1 || (bits != 8 && bits != 16))
    return (int)cudaErrorInvalidValue;
  const long long item = bits / 8;
  const long long chunk = (long long)kThreads * kGroupVecs * (16 / item);
  std::vector<DequantLeaf> leaves(count);
  std::vector<int> chunks(count);
  long long grid = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + 7 * i;
    DequantLeaf& L = leaves[i];
    L.q = reinterpret_cast<const void*>(r[0]);
    L.scales = reinterpret_cast<const float*>(r[1]);
    L.q_stride = r[2];
    L.s_stride = r[3];
    L.n = r[4];
    L.tile = (int)r[5];
    L.out = reinterpret_cast<float*>(r[6]);
    if (L.n < 1 || r[5] < 1024 || r[5] % 1024 || r[5] > 0x7fffffffLL ||
        r[6] % 16)
      return (int)cudaErrorInvalidValue;
    L.vec = r[0] % 16 == 0 && (world == 1 || (L.q_stride * item) % 16 == 0);
    const long long c = (L.n + chunk - 1) / chunk;
    grid += c;
    if (grid > kMaxGrid) return (int)cudaErrorInvalidValue;
    chunks[i] = (int)c;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      bits == 8
          ? dequant_world<int8_t>(leaves.data(), chunks.data(), count, world,
                                  s, launches)
          : dequant_world<int16_t>(leaves.data(), chunks.data(), count,
                                   world, s, launches);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// x (address of rank 0's row), stride (elements between ranks), n, out
// (address of n f32, 16-byte aligned).  dtype 0 = f32, 1 = bf16, 2 = f16.
int ps_cast_sum_group(const long long* rows, int count, int world, int dtype,
                      void* stream, int* launches) {
  *launches = 0;
  if (count < 0 || world < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const long long item = dtype == 0 ? 4 : 2;
  const long long vec = 16 / item;  // elements per 16-byte vector
  const long long chunk_vecs = (long long)kThreads * kGroupVecs;
  std::vector<CastLeaf> leaves(count);
  std::vector<int> chunks(count);
  long long grid = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + 4 * i;
    CastLeaf& L = leaves[i];
    L.x = reinterpret_cast<const void*>(r[0]);
    L.stride = r[1];
    L.n = r[2];
    L.out = reinterpret_cast<float*>(r[3]);
    if (L.n < 1 || r[3] % 16 || r[0] % item) return (int)cudaErrorInvalidValue;
    L.vec = world == 1 || (L.stride * item) % 16 == 0;
    const long long head = ((16 - r[0] % 16) % 16) / item;
    L.head = (int)(head < L.n ? head : L.n);
    const long long nvec = (L.n - L.head) / vec;
    const long long c = L.vec ? (nvec + chunk_vecs - 1) / chunk_vecs
                              : (L.n + chunk_vecs * vec - 1) /
                                    (chunk_vecs * vec);
    grid += c > 0 ? c : 1;
    if (grid > kMaxGrid) return (int)cudaErrorInvalidValue;
    chunks[i] = (int)(c > 0 ? c : 1);
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = cast_world<float>(leaves.data(), chunks.data(), count, world, s,
                            launches);
  else if (dtype == 1)
    err = cast_world<__nv_bfloat16>(leaves.data(), chunks.data(), count,
                                    world, s, launches);
  else
    err = cast_world<__half>(leaves.data(), chunks.data(), count, world, s,
                             launches);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// What a group launch can hold, for the wrappers and chip_smoke.py: out[0]
// the leaves of kernel `kind`'s 4 KB table (0 = block_dequant_sum, 1 =
// cast_sum), out[1] those of the table its launches use (the 4 KB one
// unless toolkit and CUDA driver are both >= 12.1) and out[2] that table's
// parameter bytes, out[3] the CUDA runtime's and out[4] the CUDA
// driver's version.
int ps_group_info(int kind, int* out) {
  out[0] = kind == 0 ? LeafTable<DequantLeaf, kSmallParams>::kCap
                     : LeafTable<CastLeaf, kSmallParams>::kCap;
  out[1] = kind == 0 ? large_cap<DequantLeaf>() : large_cap<CastLeaf>();
  out[2] = large_params_ok() ? kLargeParams : kSmallParams;
  out[3] = CUDART_VERSION;
  const cudaError_t err = cudaDriverGetVersion(&out[4]);
  return (int)err;
}

const char* ps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
