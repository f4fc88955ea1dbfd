// The static int8 convolution of a conv site: the activations quantized as
// they are loaded, an s8 x s8 -> s32 product, and the rescale, in one launch.
//
// Replaces the int8 convolution of the JAX package's models/qconv.py
// (Conv8, lines 149-179): XLA's s8 x s8 -> s32 conv_general_dilated on the
// TPU, not a Pallas kernel, with the elementwise quantize before it and the
// rescale after it.  torch has no CUDA int8 convolution, and a float
// convolution of the integer values would not be exact on the card (cuDNN
// runs f32 convolutions in TF32 by default, and an f32 sum rounds once it
// passes 2^24), so the port computes it here.
//
// What one launch computes, for output pixel (b, oy, ox) and channel n:
//   xq  = clip(rint(x * (1 / sx[b])), -127, 127)   (x / sx[b] when `divide`,
//                                                    the calibration branch)
//   acc = sum over (ci, ky, kx) of xq * wq[n, ci, ky, kx]      (int32, exact)
//   s   = sx[b] * w_scale[n]                                   (f32, first)
//   a plain site:   y = cast(fma(float(acc), s, bias[n]))
//   a ConvBN site:  y = cast(float(cast(float(acc) * s)) + bias[n])
// with SAME zero padding (pad_t, pad_l given; the far side is the bounds).
// The plain site's fused multiply-add is the JAX graph's: compiled XLA
// contracts acc * s + bias into one.  A ConvBN site's conv has no bias; its
// folded BatchNorm adds the bias in f32 after the conv's cast.  Every
// operation is pinned with an _rn intrinsic, so nvcc contracts nothing else,
// and rint rounds half to even as jnp.round and torch.round do.  The sum is
// exact in int32 (at most 127 * 127 * K, 3.7e7 at K = 2304), so any order of
// K and any split of it across blocks give the same bits.
//
// Bound: the larger of the bytes (x read once, y written once, the s8
// weights) over 3.35 TB/s and 2 * M * N * K operations over the int8 peak
// (1979 TOP/s).  At batch 1 every site of the model is bound by bytes, and
// each moves under a megabyte: what a launch costs is latency, so the design
// keeps loads in flight and the card's SMs busy.
//
// Dense sites (groups == 1): an implicit GEMM, M = B * Ho * Wo output
// pixels, N = Cout, K = Cin * k * k, on Hopper's warpgroup tensor-core
// instruction, wgmma.mma_async m64n64k32 .s32.s8.s8, both operands K-major
// in shared memory in the 128-byte swizzle.
// - The weights are packed once, at load (kernels/qconv.py pack_kernel):
//   K ordered (ky, kx, ci) with ci padded to 32 (or the flat (ci, ky, kx)
//   padded to 32 where Cin < 32 at 3x3 or 7x7: MobileNetV2's stem, and
//   ResNet's 7x7 stride-2 stem, K = 147), cut into stages of 128 K
//   bytes, each stage of an N tile one contiguous, already swizzled run of
//   BN x 128 bytes.  One thread brings a stage's B with one cp.async.bulk
//   completing on the stage's mbarrier.
// - A block is five warpgroups (three at BN 256) over a ring of 4 stages.
//   Warpgroup 0 consumes: it waits for a stage's A and B, issues its wgmmas,
//   and frees the stage behind the next.  The others produce A: eight
//   threads a pixel of the 64-pixel tile, each a chunk of 16 K values a
//   stage (four threads, two chunks each, at BN 256),
//   read from NCHW x by predicated loads with no branch between them
//   (neighbouring threads on neighbouring pixels), quantized in f32 and
//   stored as swizzled s8 rows.  A producer issues a stage's loads before it
//   quantizes the stage before, so one stage's loads are in flight while
//   the other is stored, and the ring lets it run up to 4 stages ahead of
//   the tensor cores.  The B of the first 4 stages is asked for at the
//   start.  A pixel's im2col origin is computed once; a chunk of 16 K
//   values lies in one tap.
// - N: one block covers all of a site's channels up to 256 (BN 64, 128 or
//   256, as BN / 64 wgmmas a K step), so x is read and quantized once.
// - The grid fills the card at batch 1: where M / 64 x N tiles give fewer
//   blocks than SMs, K is split by whole stages across up to 8 blocks
//   (qconv_tiling), launched as one thread block cluster a tile.  Each block
//   stages its int32 part in shared memory; after a cluster barrier block r
//   sums channels r, r + splits, ... of every part through distributed
//   shared memory and writes them.  A site is one launch, with no workspace
//   in device memory (atomics into a workspace with a last-block counter
//   measured slower: PERF.md).
// - The epilogue stages the int32 tile in shared memory and writes each
//   channel's run of pixels with neighbouring threads on neighbouring pixels.
// Depthwise sites (groups == Cin == Cout, only with quantize_depthwise) are
// a direct int32 loop, one thread an output value.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kBM = 64;                        // output pixels a tile (one wgmma's M)
constexpr int kStageK = 128;                   // K bytes a stage: one swizzled 128-byte row
constexpr int kStepK = 32;                     // K a wgmma
constexpr int kSteps = kStageK / kStepK;       // wgmmas a stage and N block of 64
constexpr int kChunk = 16;                     // K values a producer chunk (16 bytes)
constexpr int kRing = 4;                       // stages in the ring
constexpr int kGroup = 128;                    // threads a warpgroup

// A block's warpgroups: 0 consumes, the others produce.  Four producer
// warpgroups (a chunk a producer a stage) where the consumer's accumulators
// leave the registers for them; two at BN 256 (128 accumulators a thread).
template <int BN>
struct Roles {
  static constexpr int kProducers = (BN == 256 ? 2 : 4) * kGroup;
  static constexpr int kThreads = kGroup + kProducers;
  static constexpr int kLanes = kProducers / kBM;              // producers a pixel of the tile
  static constexpr int kMine = kStageK / kChunk / kLanes;      // chunks a producer a stage
};
constexpr int kStagingLd = kBM + 4;            // words a staged channel (conflict-free stores)
constexpr int kMaxSplits = 8;                  // blocks a cluster: the portable most
constexpr int kDwThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// v rounded to the storage type T and back
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// clip(rint(x * inv), -127, 127) or clip(rint(x / sx), -127, 127)
__device__ __forceinline__ int quantize(float x, float sx, float inv, bool divide) {
  const float v = divide ? __fdiv_rn(x, sx) : __fmul_rn(x, inv);
  return (int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

// the low bytes of four words as the bytes of one, the first lowest
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// 16 values quantized as ``quantize`` does and packed as s8.  Clipped
// first, then rounded half to even by adding 1.5 * 2^23 (exact for the
// integers and halves of [-127, 127], and the same as rounding first: the
// bounds are integers; NaN clips to -127 as fmaxf leaves it), so that each
// value's byte is the low byte of the sum's bits: no float-to-int conversion.
template <bool kDivide>
__device__ __forceinline__ uint4 quantize_chunk(const float (&v)[16], float sx, float inv) {
  unsigned q[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float t = kDivide ? __fdiv_rn(v[e], sx) : __fmul_rn(v[e], inv);
    q[e] = __float_as_uint(__fadd_rn(fminf(fmaxf(t, -127.0f), 127.0f), 12582912.0f));
  }
  return make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

template <typename T>
__device__ __forceinline__ void epilogue(T* y, long long at, int acc, float sx, float ws,
                                         const float* bias, int n, bool bn) {
  const float s = __fmul_rn(sx, ws);
  const float a = __int2float_rn(acc);
  store_f(y + at, bn ? __fadd_rn(round_to(__fmul_rn(a, s), y), bias[n])
                    : __fmaf_rn(a, s, bias[n]));
}

// The shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset;
// the leading one is unused in this mode), the tile 1024-byte aligned.  A K
// step of 32 bytes inside the row advances the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the thread block cluster: a barrier across its blocks (every thread of
// each arrives), this block's rank, and another block's shared memory
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address in block ``rank``'s shared memory of this block's ``addr``
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ int ld_cluster(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
// that is still in flight
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64 s32, the warpgroup's fragments) += A (64 x 32 s8) * B (64 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

struct Shape {
  int b, cin, h, w, cout, ho, wo, stride, pad_t, pad_l;
};

// A dense site's layout (kernels/qconv.py qconv_tiling).
struct Dense {
  Shape s;
  int k;                 // the kernel's side
  int flat;              // K in (ci, ky, kx) order, else (ky, kx, ci) with ci padded
  int cin_pad;           // ci padded to 32 (the (ky, kx, ci) order)
  int k_len;             // K values: cin * k * k (flat) or k * k * cin_pad
  int k_steps;           // wgmma K steps: ceil(k_len / 32)
  int n_stages;          // stages of the packed kernel a tile: ceil(k_steps / 4)
  int n_tiles;           // N tiles of BN channels
  int splits;            // blocks a tile splits K into
  int stages_per_split;  // stages a split
  int m_total;           // B * Ho * Wo
  int sx_stride, divide, bn;
};

// v = *p where ``pred``, else 0, as one predicated load: no branch, so that
// every load of a stage is in flight before the first value is used
__device__ __forceinline__ float ldg_if(const float* p, bool pred) {
  float v = 0.0f;
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q ld.global.nc.f32 %0, [%1];\n}"
               : "+f"(v) : "l"(p), "r"((int)pred));
  return v;
}
__device__ __forceinline__ float ldg_if(const __nv_bfloat16* p, bool pred) {
  unsigned short v = 0;
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q ld.global.nc.u16 %0, [%1];\n}"
               : "+h"(v) : "l"(p), "r"((int)pred));
  return __uint_as_float((unsigned)v << 16);
}

// The 16 values of K from k0 of one output pixel's im2col row, loaded with
// no branch (a padded or past-K value, or any where ``live`` is false, is 0,
// and quantizes to 0 since the scales are positive and finite).  FK: the
// side of a flat site's kernel (3, or 7 at the ResNet stem), a template
// argument so that each side's division by FK * FK is by a constant.
template <int FK, typename T>
__device__ __forceinline__ void load_chunk(float (&v)[kChunk], const T* __restrict__ xb,
                                           const Dense& p, int k0, int iy0, int ix0, bool live) {
  const int plane = p.s.h * p.s.w;
  if (p.flat) {  // an FK x FK kernel (flat only where Cin < 32 at 3x3 or 7x7)
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int kk = k0 + i;
      const int ci = kk / (FK * FK), r = kk - ci * (FK * FK);
      const int ky = r / FK, kx = r - ky * FK;
      const int iy = iy0 + ky, ix = ix0 + kx;
      const bool in = live && kk < p.k_len && iy >= 0 && iy < p.s.h && ix >= 0 && ix < p.s.w;
      v[i] = ldg_if(xb + (in ? ci * plane + iy * p.s.w + ix : 0), in);
    }
    return;
  }
  const int tap = k0 / p.cin_pad;  // a chunk lies in one tap: cin_pad % 32 == 0
  const int ci0 = k0 - tap * p.cin_pad;
  const int ky = tap / p.k, kx = tap - ky * p.k;
  const int iy = iy0 + ky, ix = ix0 + kx;
  const bool in = live && iy >= 0 && iy < p.s.h && ix >= 0 && ix < p.s.w;
  const int n = in ? min(kChunk, p.s.cin - ci0) : 0;  // the chunk's channels inside x
  const T* src = xb + (in ? ci0 * plane + iy * p.s.w + ix : 0);
#pragma unroll
  for (int i = 0; i < kChunk; ++i) v[i] = ldg_if(src + i * plane, i < n);
}

template <int BN>
constexpr int dense_smem_bytes() {
  // the ring, its full and empty barriers, the tile's scales and biases,
  // and 1024 bytes to align the ring for the swizzle
  return kRing * (kBM + BN) * kStageK + 2 * kRing * 8 + 2 * BN * 4 + 1024;
}

// grid (M tiles, N tiles, K splits), Roles<BN>::kThreads threads,
// dense_smem_bytes<BN>(); FK as in load_chunk (3 at every site but a flat 7x7)
template <typename T, int BN, int FK>
__global__ void __launch_bounds__(Roles<BN>::kThreads, 1)
qconv_wgmma_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                   const float* __restrict__ w_scale, const float* __restrict__ sx,
                   const float* __restrict__ bias, T* __restrict__ y, Dense p) {
  constexpr int NB = BN / 64;                  // wgmmas a K step
  constexpr int kProducers = Roles<BN>::kProducers, kThreads = Roles<BN>::kThreads;
  constexpr int kLanes = Roles<BN>::kLanes, kMine = Roles<BN>::kMine;
  constexpr int kABytes = kBM * kStageK;
  constexpr int kBBytes = BN * kStageK;
  constexpr int kStageBytes = kABytes + kBBytes;
  static_assert(BN * kStagingLd * 4 <= kRing * kStageBytes, "the staging fits in the ring");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tod::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * kStageBytes);
  uint64_t* empty = full + kRing;
  float* tile_ws = reinterpret_cast<float*>(empty + kRing);  // w_scale and bias of the N tile
  float* tile_bias = tile_ws + BN;

  const int tid = threadIdx.x;
  const int m_tile = blockIdx.x, n_tile = blockIdx.y;
  const int s_begin = blockIdx.z * p.stages_per_split;
  const int n_local = min(p.n_stages - s_begin, p.stages_per_split);

  const int8_t* b_src = packed + ((long long)n_tile * p.n_stages + s_begin) * kBBytes;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      tod::bar_init(&full[s], kProducers + 1);  // the producers, and the B copy's announcement
      tod::bar_init(&empty[s], kGroup);          // the consumers
    }
    // the B of the ring's first round of stages, at once
    for (int i = 0; i < min(n_local, kRing); ++i) {
      tod::bulk_expect(&full[i], kBBytes);
      tod::bulk_load(smem + i * kStageBytes + kABytes, b_src + (long long)i * kBBytes, kBBytes,
                     &full[i]);
    }
  }
  if (tid < BN) {
    const int n = min(n_tile * BN + tid, p.s.cout - 1);
    tile_ws[tid] = w_scale[n];
    tile_bias[tid] = bias[n];
  }
  // a producer's pixel of the tile, its image and scale, read before the wait
  const int am = tid & (kBM - 1);
  const int pm = m_tile * kBM + am;
  const bool m_ok = pm < p.m_total;
  int pb = 0, oy = 0, ox = 0;
  if (m_ok) {
    const int hw_out = p.s.ho * p.s.wo;
    pb = pm / hw_out;
    const int r = pm - pb * hw_out;
    oy = r / p.s.wo;
    ox = r - oy * p.s.wo;
  }
  const float sxb = sx[pb * p.sx_stride];
  __syncthreads();

  int acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0;

  // the warpgroup's role, uniform across each warp as the compiler can see
  // (a branch it takes for divergent would make it serialize the wgmmas)
  const int role = __shfl_sync(0xffffffffu, tid / kGroup, 0);
  if (role == 0) {
    // consumer: the wgmmas of each stage once its A and B have landed.  All
    // four K steps of a stage run: past K the packed B is zero, so whatever
    // A holds there adds nothing.
    for (int i = 0; i < n_local; ++i) {
      const int s = i % kRing;
      tod::bulk_wait(&full[s], (i / kRing) & 1);
      const uint32_t a0 = tod::smem_u32(smem + s * kStageBytes);
      const uint32_t b0 = a0 + kABytes;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_acc(acc[nb]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const uint64_t da = sw128_desc(a0 + j * kStepK);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          wgmma_s8(acc[nb], da, sw128_desc(b0 + nb * 64 * kStageK + j * kStepK));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one has been read: free it
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_acc(acc[nb]);
      if (i > 0) tod::bar_arrive(&empty[(i - 1) % kRing]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_acc(acc[nb]);
  } else {
    // producer: the quantized A rows of each stage, and its B by bulk copy
    const int pt = tid - kGroup;
    const int lane = pt / kBM;  // its chunks of a stage: lane, lane + kLanes, ...
    const float inv = __frcp_rn(sxb);
    const int iy0 = oy * p.s.stride - p.s.pad_t, ix0 = ox * p.s.stride - p.s.pad_l;
    const T* xb = x + (long long)pb * p.s.cin * p.s.h * p.s.w;
    const bool divide = p.divide != 0;
    // a stage's loads are issued one stage ahead: while one stage's values
    // are quantized and stored, the next stage's are in flight
    const auto chunks_of = [&](int i) {
      return 2 * min(kSteps, p.k_steps - (s_begin + i) * kSteps);
    };
    const auto load = [&](float (&v)[kMine][kChunk], int i) {
      const int chunks = chunks_of(i);
#pragma unroll
      for (int c2 = 0; c2 < kMine; ++c2) {
        const int c = lane + kLanes * c2;
        load_chunk<FK>(v[c2], xb, p, (s_begin + i) * kStageK + c * kChunk, iy0, ix0,
                       m_ok && c < chunks);
      }
    };
    const auto put = [&](const float (&v)[kMine][kChunk], int i) {
      const int s = i % kRing;
      const int chunks = chunks_of(i);
      tod::bulk_wait(&empty[s], ((i / kRing) & 1) ^ 1);
      uint8_t* a_s = smem + s * kStageBytes;
      if (pt == 0 && i >= kRing) {  // a later round's B, once its stage is free
        tod::bulk_expect(&full[s], kBBytes);
        tod::bulk_load(a_s + kABytes, b_src + (long long)i * kBBytes, kBBytes, &full[s]);
      }
#pragma unroll
      for (int c2 = 0; c2 < kMine; ++c2) {
        const int c = lane + kLanes * c2;
        if (c < chunks) {
          // the 128-byte swizzle: chunk c of row am at chunk c ^ (am % 8)
          *reinterpret_cast<uint4*>(a_s + am * kStageK + ((c ^ (am & 7)) * kChunk)) =
              divide ? quantize_chunk<true>(v[c2], sxb, inv)
                     : quantize_chunk<false>(v[c2], sxb, inv);
        }
      }
      // make the stores visible to the tensor cores' (async proxy) reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      tod::bar_arrive(&full[s]);
    };
    float va[kMine][kChunk], vb[kMine][kChunk];
    if (n_local > 0) load(va, 0);
    for (int i = 0; i < n_local; i += 2) {
      if (i + 1 < n_local) load(vb, i + 1);
      put(va, i);
      if (i + 1 < n_local) {
        if (i + 2 < n_local) load(va, i + 2);
        put(vb, i + 1);
      }
    }
  }

  // every stage has been read: the ring becomes the int32 tile's staging,
  // [channel][pixel] with a padded stride
  __syncthreads();
  int* stg = reinterpret_cast<int*>(smem);
  if (tid < kGroup) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        // fragment i: row 16 warp + lane / 4 (+ 8), column 8 (i / 4) + 2 (lane % 4) (+ 1)
        const int row = warp * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
        const int col = nb * 64 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        stg[col * kStagingLd + row] = acc[nb][i];
      }
  }
  __syncthreads();

  // each thread: the tile's pixel am, channels tid / 64 + kNStep j
  const int em = am, n0 = tid / kBM;
  constexpr int kNStep = kThreads / kBM;
  const int n_valid = min(BN, p.s.cout - n_tile * BN);
  const int hw_out = p.s.ho * p.s.wo;
  T* yb = y + ((long long)pb * p.s.cout + n_tile * BN) * hw_out + (pm - pb * hw_out);
  const bool bn = p.bn != 0;
  if (p.splits == 1) {
    if (m_ok) {
#pragma unroll 8
      for (int n = n0; n < n_valid; n += kNStep) {
        epilogue(yb, (long long)n * hw_out, stg[n * kStagingLd + em], sxb, tile_ws[n],
                 tile_bias, n, bn);
      }
    }
    return;
  }

  // K is split across the blocks of a cluster (one a split): once every
  // block has staged its part, block r sums channels r, r + splits, ... of
  // all the parts, read from the blocks' shared memory, and writes them
  cluster_sync();
  const int rank = (int)cluster_rank();
  uint32_t part[kMaxSplits];  // each block's staging, as this block addresses it
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r) {
    part[r] = mapa(tod::smem_u32(stg), r < p.splits ? r : 0);
  }
  if (m_ok) {
    for (int n = rank + p.splits * n0; n < n_valid; n += p.splits * kNStep) {
      const uint32_t at = (uint32_t)(n * kStagingLd + em) * 4u;
      int v[kMaxSplits];  // every part's load in flight, then the sum
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) v[r] = r < p.splits ? ld_cluster(part[r] + at) : 0;
      int sum = 0;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) sum += v[r];
      epilogue(yb, (long long)n * hw_out, sum, sxb, tile_ws[n], tile_bias, n, bn);
    }
  }
  cluster_sync();  // no block leaves while another reads its part
}

// one thread an output value of a depthwise site (groups == Cin == Cout)
template <typename T, int KS>
__global__ void __launch_bounds__(kDwThreads)
qconv_depthwise_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                       const float* __restrict__ w_scale, const float* __restrict__ sx,
                       int sx_stride, const float* __restrict__ bias, T* __restrict__ y,
                       Shape s, int divide, int bn) {
  const long long total = (long long)s.b * s.cout * s.ho * s.wo;
  for (long long at = (long long)blockIdx.x * blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    const int ox = (int)(at % s.wo);
    long long r = at / s.wo;
    const int oy = (int)(r % s.ho);
    r /= s.ho;
    const int c = (int)(r % s.cout);
    const int b = (int)(r / s.cout);
    const float sxb = sx[b * sx_stride];
    const float inv = __frcp_rn(sxb);
    const T* xc = x + ((long long)b * s.cin + c) * s.h * s.w;
    const int8_t* wc = wq + c * KS * KS;
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
      const int iy = oy * s.stride - s.pad_t + ky;
      if (iy < 0 || iy >= s.h) continue;
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const int ix = ox * s.stride - s.pad_l + kx;
        if (ix < 0 || ix >= s.w) continue;
        acc += quantize(load_f(xc + (long long)iy * s.w + ix), sxb, inv, divide) *
               (int)wc[ky * KS + kx];
      }
    }
    epilogue(y, at, acc, sxb, w_scale[c], bias, c, bn != 0);
  }
}

template <typename T, int BN, int FK>
cudaError_t launch_dense(const void* x, const void* packed, const void* w_scale, const void* sx,
                         const void* bias, void* y, const Dense& p, cudaStream_t stream) {
  constexpr int smem = dense_smem_bytes<BN>();
  auto kernel = qconv_wgmma_kernel<T, BN, FK>;
  static unsigned configured = 0;  // a bit a device: the shared-memory opt-in is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 32) configured |= 1u << dev;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((p.m_total + kBM - 1) / kBM), (unsigned)p.n_tiles,
                        (unsigned)p.splits);
  config.blockDim = dim3(Roles<BN>::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = (unsigned)p.splits;  // a tile's splits: one cluster
  config.attrs = cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x),
                           static_cast<const int8_t*>(packed), static_cast<const float*>(w_scale),
                           static_cast<const float*>(sx), static_cast<const float*>(bias),
                           static_cast<T*>(y), p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int FK>
cudaError_t launch_dense_n(int bn_tile, const void* x, const void* packed, const void* w_scale,
                           const void* sx, const void* bias, void* y, const Dense& p,
                           cudaStream_t stream) {
  switch (bn_tile) {
    case 64: return launch_dense<T, 64, FK>(x, packed, w_scale, sx, bias, y, p, stream);
    case 128: return launch_dense<T, 128, FK>(x, packed, w_scale, sx, bias, y, p, stream);
    default: return launch_dense<T, 256, FK>(x, packed, w_scale, sx, bias, y, p, stream);
  }
}

template <typename T, int KS>
cudaError_t launch_depthwise(const void* x, const void* wq, const void* w_scale, const void* sx,
                             int sx_stride, const void* bias, void* y, const Shape& s,
                             int divide, int bn, cudaStream_t stream) {
  const long long total = (long long)s.b * s.cout * s.ho * s.wo;
  long long blocks = (total + kDwThreads - 1) / kDwThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  qconv_depthwise_kernel<T, KS><<<(unsigned)blocks, kDwThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(w_scale), static_cast<const float*>(sx), sx_stride,
      static_cast<const float*>(bias), static_cast<T*>(y), s, divide, bn);
  return cudaGetLastError();
}

}  // namespace

// A dense site.  x (B, Cin, H, W) and y (B, Cout, Ho, Wo) of one type (dtype
// 0: f32, 1: bf16); packed: the s8 kernel as kernels/qconv.py pack_kernel
// lays it out, (n_tiles, n_stages, bn_tile, 128); w_scale (Cout,) f32; sx
// (B,) f32 read at b * sx_stride (0: one scale for the batch); bias (Cout,)
// f32; the tiling as kernels/qconv.py qconv_tiling picks it (splits at most 8:
// a tile's splits are one thread block cluster).
extern "C" int tod_qconv_dense(const void* x, const void* packed, const void* w_scale,
                               const void* sx, int sx_stride, const void* bias, void* y,
                               int dtype, int b, int cin, int h, int w, int cout, int k,
                               int stride, int pad_t, int pad_l, int ho, int wo, int divide,
                               int bn, int bn_tile, int n_tiles, int flat, int cin_pad,
                               int k_steps, int splits, int stages_per_split, void* stream) {
  const int k_len = flat ? cin * k * k : k * k * cin_pad;
  const int n_stages = (k_steps + kSteps - 1) / kSteps;
  const bool tiles_ok = (bn_tile == 64 || bn_tile == 128 || bn_tile == 256) &&
                        n_tiles >= 1 && (long long)n_tiles * bn_tile >= cout &&
                        (long long)(n_tiles - 1) * bn_tile < cout;
  const bool k_ok = (flat ? (k == 3 || k == 7) && cin < kStepK
                          : cin_pad % kStepK == 0 && cin_pad >= cin) && k_steps >= 1 &&
                    (long long)k_steps * kStepK >= k_len && (k_steps - 1) * kStepK < k_len;
  const bool split_ok = splits >= 1 && stages_per_split >= 1 && splits <= kMaxSplits &&
                        (long long)splits * stages_per_split >= n_stages &&
                        (splits - 1) * stages_per_split < n_stages;
  const long long m_total = (long long)b * ho * wo;
  if (b < 1 || cin < 1 || cout < 1 || ho < 1 || wo < 1 || stride < 1 ||
      (k != 1 && k != 3 && k != 7) || (dtype != 0 && dtype != 1) || !tiles_ok || !k_ok ||
      !split_ok || n_tiles > 65535 ||
      m_total + kBM > INT32_MAX || (long long)cin * h * w > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  Dense p;
  p.s = Shape{b, cin, h, w, cout, ho, wo, stride, pad_t, pad_l};
  p.k = k;
  p.flat = flat;
  p.cin_pad = cin_pad;
  p.k_len = k_len;
  p.k_steps = k_steps;
  p.n_stages = n_stages;
  p.n_tiles = n_tiles;
  p.splits = splits;
  p.stages_per_split = stages_per_split;
  p.m_total = (int)m_total;
  p.sx_stride = sx_stride;
  p.divide = divide;
  p.bn = bn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const bool seven = flat && k == 7;  // the ResNet stem; every other site's FK is 3
  cudaError_t err;
  if (dtype == 0) {
    err = seven ? launch_dense_n<float, 7>(bn_tile, x, packed, w_scale, sx, bias, y, p, st)
                : launch_dense_n<float, 3>(bn_tile, x, packed, w_scale, sx, bias, y, p, st);
  } else {
    err = seven ? launch_dense_n<bf16, 7>(bn_tile, x, packed, w_scale, sx, bias, y, p, st)
                : launch_dense_n<bf16, 3>(bn_tile, x, packed, w_scale, sx, bias, y, p, st);
  }
  return (int)err;
}

// A depthwise site (Cin == Cout channels): x, y, sx and bias as above, wq
// (C, 1, k, k) s8, w_scale (C,) f32.
extern "C" int tod_qconv_depthwise(const void* x, const void* wq, const void* w_scale,
                                   const void* sx, int sx_stride, const void* bias, void* y,
                                   int dtype, int b, int c, int h, int w, int k, int stride,
                                   int pad_t, int pad_l, int ho, int wo, int divide, int bn,
                                   void* stream) {
  if (b < 1 || c < 1 || ho < 1 || wo < 1 || stride < 1 || (k != 1 && k != 3) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Shape s{b, c, h, w, c, ho, wo, stride, pad_t, pad_l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(k == 1 ? launch_depthwise<float, 1>(x, wq, w_scale, sx, sx_stride, bias, y, s,
                                                     divide, bn, st)
                        : launch_depthwise<float, 3>(x, wq, w_scale, sx, sx_stride, bias, y, s,
                                                     divide, bn, st));
  }
  return (int)(k == 1 ? launch_depthwise<__nv_bfloat16, 1>(x, wq, w_scale, sx, sx_stride, bias,
                                                           y, s, divide, bn, st)
                      : launch_depthwise<__nv_bfloat16, 3>(x, wq, w_scale, sx, sx_stride, bias,
                                                           y, s, divide, bn, st));
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
