// FlowNet correlation, its channel-split form and its backward for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Forward (dtt_correlation):
// Replaces the TPU kernel _corr_mm_kernel (dtt/ops/correlation.py), which
// computed each vertical displacement as a banded row matmul on the MXU and
// read the horizontal displacements off as diagonals (84 columns computed to
// keep 9):
//
//   out[b, y, x, iy*nd + ix] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y + dy, x + dx, c]
//   dy = -dmax + iy*stride, dx = -dmax + ix*stride, zero outside f2,
//
// accumulated in f32 and written in the input dtype (dy-major channels).
//
// Bound: at the main-path shapes (38x68 maps, C = 512/1024, 81 outputs) the
// op needs ~13 bf16 MAC per input byte, so the card's memory rate bounds
// it. What a kernel has to keep small is the traffic from L2 into the SMs:
// every f2 row meets nd output rows and every f2 column nd output columns.
//
// The caller names the body (dtt_correlation's `tensor_cores`; the rule is
// correlation_body in dtt_torch/ops/correlation.py: the tensor cores for
// bfloat16 maps whose window fits the band, dmax <= 8 and nd <= 9, the CUDA
// cores otherwise). A body refuses what it cannot take; neither falls back
// to the other:
//
// * bfloat16 maps run on the tensor cores (correlation_tc_kernel): the TPU
//   kernel's band on mma.sync.m16n8k16 (bf16 in, exact products, f32 sums).
//   A block owns R = 2 output rows of one residue class mod stride (they
//   share nd - 1 of their f2 rows, so a block stages nd + 1 f2 rows for two
//   output rows instead of 2 nd) and 64 columns of one pair; one warp per
//   (row, dy), each over 4 tiles of 16 x-positions. Per 32-channel step one
//   thread loads f1's two 64-pixel row tiles and the f2 rows over the
//   group's columns plus the 2 dmax halo (80 columns) by TMA into a 3-stage
//   ring (two steps in flight while one computes); the TMA's bounds give
//   the zeros outside the map and past C, and its 64-byte swizzle lets
//   ldmatrix read 8 pixel rows without bank conflicts. For each 16-channel
//   k step a warp loads the 5 B fragment pairs of its f2 row once and, per
//   tile, f1's A fragment, and multiplies the band of 16 x 32 f2 columns
//   that holds the tile's nd horizontal displacements (4 n8 tiles). The
//   epilogue keeps the diagonals n - q = ix * stride, divides by C (IEEE,
//   as the plain version's / C), rounds once to bf16 and writes the rows'
//   dy-major channels through shared memory, so the stores coalesce.
//   Sizes: a stage is 59 KB, so 3 stages fill one SM; 64 columns keep the
//   halo's extra reads at 25%, and a ragged last group (W = 68: 4 columns)
//   loads only its own columns through tail-sized TMA boxes. A grid with
//   fewer one-row blocks than SMs (one pair: 76) takes R = 1 and splits
//   its dy over three blocks (228 blocks, each staging nd / 3 f2 rows) to
//   spread over more of them. The accumulators (4 tiles x 4 n8 tiles x 4 f32)
//   stay at 64 registers a thread because dy is split across warps. The
//   band takes dmax <= 8 (kMaxD). TMA needs C % 8 == 0 and 16-byte aligned
//   maps; other maps fill the same swizzled stage with 2-byte loads, one
//   step at a time.
// * float32 maps keep the CUDA-core body (correlation_kernel below), whose
//   f32 multiply-adds hold the 1e-5 references; TF32 tensor cores would
//   not: one block per (pair, output row, 32-column tile), f1's row tile
//   and the nd rows of f2 it meets staged in 16-channel chunks, each thread
//   one (x, dy) with its nd horizontal displacements in registers. bf16
//   windows past the band (FlowNet-C's d=20/s=2, d=16/s=4) run it too. Its
//   limits are the card's: 32 x nd threads a block (nd <= 32, kMaxNdCore)
//   and nd * 16 * ((32 + 2 dmax) | 1) f32 of staged f2 rows in a block's
//   227 KB of shared memory (98 KB at d=20/s=2, past 48 KB by opt-in).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// --- PTX wrappers for the tensor-core bodies (sm_80+ instructions) ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// displacements per axis, nd = 2*dmax/stride + 1 (rounded down): the
// tensor-core bodies take nd <= kMaxNd (one warp per dy), the CUDA-core
// forward nd <= kMaxNdCore (a block of 32 x nd threads, at most 1024)
constexpr int kMaxNd = 9;
constexpr int kMaxNdCore = 32;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kTileX = 32;   // output columns per block (one warp wide)
constexpr int kChunkC = 16;  // channels staged per step
constexpr int kPitch1 = kTileX + 1;  // odd pitches: conflict-free transposed stores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Lets `kernel` take `bytes` (> 48 KB) of dynamic shared memory.
template <typename K>
int allow_smem(K* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The body is shared with the channel-split forward (dtt_correlation_split,
// below): with kSplit each block sums only the channels [cb*block_c,
// (cb+1)*block_c) of its pair, blockIdx.z = cb*B + b, and writes its raw f32
// sums to the (nblk, B, H, W, nd*nd) workspace; without it blockIdx.z = b,
// block_c = C, and the block writes the channel mean in the input dtype.
// kMaxJ bounds nd: correlation_kernel keeps the main path's 9 sums
// (kMaxNd), correlation_kernel_wide takes the wide windows (kMaxNdCore; at
// most 64 registers a thread, for 1024 threads).
template <typename T, bool kSplit, int kMaxJ>
__device__ __forceinline__ void correlation_core(
    const T* __restrict__ f1, const T* __restrict__ f2,
    void* __restrict__ out_, int B, int H, int W, int C, int dmax, int stride,
    int nd, int block_c) {
  extern __shared__ float smem[];
  const int halo_w = kTileX + 2 * dmax;
  const int pitch2 = halo_w | 1;
  float* s1 = smem;                       // [kChunkC][kPitch1]
  float* s2 = smem + kChunkC * kPitch1;   // [nd][kChunkC][pitch2]

  const int tx = threadIdx.x;             // column within the tile
  const int ty = threadIdx.y;             // vertical displacement index
  const int tid = ty * kTileX + tx;
  const int nthreads = kTileX * nd;
  const int x0 = blockIdx.x * kTileX;
  const int y = blockIdx.y;
  const int b = kSplit ? blockIdx.z % B : blockIdx.z;
  const int c_lo = kSplit ? (blockIdx.z / B) * block_c : 0;
  const int c_hi = kSplit ? min(C, c_lo + block_c) : C;
  const int64_t frame = (int64_t)b * H * W * C;

  float acc[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) acc[j] = 0.f;

  for (int c0 = c_lo; c0 < c_hi; c0 += kChunkC) {
    const int cc = min(kChunkC, c_hi - c0);
    // channel-fastest global reads (contiguous in NHWC), transposed stores
    for (int i = tid; i < kTileX * kChunkC; i += nthreads) {
      const int c = i % kChunkC;
      const int xi = i / kChunkC;
      const int x = x0 + xi;
      float v = 0.f;
      if (x < W && c < cc) v = to_f32(f1[frame + ((int64_t)y * W + x) * C + c0 + c]);
      s1[c * kPitch1 + xi] = v;
    }
    for (int i = tid; i < nd * halo_w * kChunkC; i += nthreads) {
      const int c = i % kChunkC;
      const int rest = i / kChunkC;
      const int xi = rest % halo_w;
      const int iy = rest / halo_w;
      const int yy = y - dmax + iy * stride;
      const int x = x0 - dmax + xi;
      float v = 0.f;
      if (yy >= 0 && yy < H && x >= 0 && x < W && c < cc)
        v = to_f32(f2[frame + ((int64_t)yy * W + x) * C + c0 + c]);
      s2[(iy * kChunkC + c) * pitch2 + xi] = v;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const float a = s1[c * kPitch1 + tx];
      const float* row = s2 + (ty * kChunkC + c) * pitch2 + tx;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < nd) acc[j] += a * row[j * stride];
    }
    __syncthreads();
  }

  const int x = x0 + tx;
  if (x < W) {
    const int64_t o = (((int64_t)blockIdx.z * H + y) * W + x) * nd * nd + ty * nd;
    if (kSplit) {
      float* part = static_cast<float*>(out_) + o;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < nd) part[j] = acc[j];
    } else {
      T* dst = static_cast<T*>(out_) + o;
      const float fc = (float)C;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < nd) store(dst + j, acc[j] / fc);
    }
  }
}

template <typename T, bool kSplit>
__global__ void correlation_kernel(const T* __restrict__ f1,
                                   const T* __restrict__ f2,
                                   void* __restrict__ out_, int B, int H,
                                   int W, int C, int dmax, int stride, int nd,
                                   int block_c) {
  correlation_core<T, kSplit, kMaxNd>(f1, f2, out_, B, H, W, C, dmax, stride,
                                      nd, block_c);
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kTileX * kMaxNdCore)
correlation_kernel_wide(const T* __restrict__ f1, const T* __restrict__ f2,
                        void* __restrict__ out_, int B, int H, int W, int C,
                        int dmax, int stride, int nd, int block_c) {
  correlation_core<T, kSplit, kMaxNdCore>(f1, f2, out_, B, H, W, C, dmax,
                                          stride, nd, block_c);
}

template <typename T>
int launch_corr_body(void (*kernel)(const T*, const T*, void*, int, int, int,
                                    int, int, int, int, int),
                     const void* f1, const void* f2, void* out, int B, int H,
                     int W, int C, int dmax, int stride, int nd, int block_c,
                     int nblk, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const int err = allow_smem(kernel, smem);
    if (err) return err;
  }
  dim3 grid((W + kTileX - 1) / kTileX, H, B * nblk);
  dim3 block(kTileX, nd);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), out, B, H, W, C,
      dmax, stride, nd, block_c);
  return (int)cudaGetLastError();
}

// The CUDA-core forward (both forms); refuses nd > kMaxNdCore and staging
// past a block's shared memory (correlation.py window_limit names both).
template <typename T, bool kSplit>
int launch_corr(const void* f1, const void* f2, void* out, int B, int H,
                int W, int C, int dmax, int stride, int block_c, int nblk,
                cudaStream_t stream) {
  const int nd = (2 * dmax) / stride + 1;
  const int halo_w = kTileX + 2 * dmax;
  const size_t smem = sizeof(float) *
      (kChunkC * kPitch1 + (size_t)nd * kChunkC * (halo_w | 1));
  if (nd > kMaxNdCore || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_corr_body<T>(nd <= kMaxNd ? correlation_kernel<T, kSplit>
                                          : correlation_kernel_wide<T, kSplit>,
                             f1, f2, out, B, H, W, C, dmax, stride, nd,
                             block_c, nblk, smem, stream);
}

// --- the bf16 tensor-core forward (see the note at the top) ---

constexpr int kMaxD = 8;        // the band of 16 + 2*dmax <= 32 columns
constexpr int kGroupX = 64;     // output columns per block: 4 tiles of 16
constexpr int kTilesX = kGroupX / 16;
constexpr int kCols = kGroupX + 2 * kMaxD;  // staged f2 columns (halo incl.)
constexpr int kStepC = 32;      // channels per stage: 64-byte pixel rows
constexpr int kRowB = kStepC * 2;   // bytes per staged pixel row
constexpr int kStages = 3;      // TMA ring: 2 stages in flight, 1 computed

// The current device's SM count.
int sm_count() {
  int dev = 0, n = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Byte offset of 16-byte chunk `ch` (0..3) of 64-byte row `row` of a ring
// that starts 1024-byte aligned, in the TMA's 64-byte swizzle (chunk bits
// 4-5 XOR address bits 7-8): ldmatrix then reads 8 rows without conflicts.
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return (uint32_t)row * 64 + ((ch ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar));
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// TMA: the box of `map` at (c, x, y, b) into shared memory at `dst`,
// completing on `bar`; coordinates outside the map read as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int x, int y, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x),
         "r"(y), "r"(b), "r"(bar) : "memory");
}

// One stage's products for the first NT tiles of a warp: 32 channels (two
// k16 steps) of f1's rows at 64-byte row `row1` (A, 16 x-positions a
// tile) against the band of 32 f2 columns at `row2` (B). B fragment pair P
// holds f2 columns 16P ... 16P + 15 (n8 tiles 2P, 2P + 1); tile t's band
// is pairs t and t + 1, so each pair is loaded once a step. All 4 n8 tiles
// are multiplied whatever dmax: an f2 column past 15 + 2 dmax (or past a
// tail box) only reaches accumulator columns that hold no kept diagonal.
template <int NT>
__device__ __forceinline__ void band_step(float (&acc)[kTilesX][4][4],
                                          const uint8_t* ring, int row1,
                                          int row2, int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < kStepC / 16; ++ks) {
    uint32_t pairs[NT + 1][4];
#pragma unroll
    for (int p = 0; p <= NT; ++p)
      ldmatrix_x4(pairs[p], ring + swz(row2 + 16 * p + 8 * (m >> 1)
                                       + (lane & 7), 2 * ks + (m & 1)));
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      uint32_t a[4];
      ldmatrix_x4(a, ring + swz(row1 + 16 * t + (lane & 15),
                                2 * ks + (lane >> 4)));
      mma_bf16(acc[t][0], a, pairs[t][0], pairs[t][1]);
      mma_bf16(acc[t][1], a, pairs[t][2], pairs[t][3]);
      mma_bf16(acc[t][2], a, pairs[t + 1][0], pairs[t + 1][1]);
      mma_bf16(acc[t][3], a, pairs[t + 1][2], pairs[t + 1][3]);
    }
  }
}

// Block: R output rows y_r = yb + r * stride (one residue class mod stride,
// so consecutive rows share nd - 1 of their f2 rows) x 64 columns of one
// pair x nw of its nd dy; warp (r, dy). A stage holds 32 channels of f1's R
// row tiles ([R][64 px]) and of the R + nw - 1 f2 rows yb - dmax + (iy0 +
// t) * stride ([t][80 px]), 64-byte swizzled pixel rows. With kTma one thread fills
// the stages by TMA (zeros outside the map and past C from the TMA's
// bounds), 2 ahead of the stage the warps compute on; without (C % 8 != 0
// or unaligned maps) all threads fill one stage with 2-byte loads before
// each step.
template <int R, bool kTma>
__global__ void __launch_bounds__(32 * kMaxNd * R, 1)
correlation_tc_kernel(const __grid_constant__ CUtensorMap map1,
                      const __grid_constant__ CUtensorMap map2,
                      const __grid_constant__ CUtensorMap tail1,
                      const __grid_constant__ CUtensorMap tail2,
                      const uint16_t* __restrict__ f1,
                      const uint16_t* __restrict__ f2,
                      __nv_bfloat16* __restrict__ out, int H, int W, int C,
                      int dmax, int stride, int nd, int nw) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring_addr = smem_addr(ring);
  const int nrows2 = R + nw - 1;
  const int stage_rows = R * kGroupX + nrows2 * kCols;  // 64-byte rows
  const uint32_t stage_bytes = stage_rows * kRowB;
  const uint32_t bars = ring_addr + kStages * stage_bytes;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  // blockIdx.x = (column group, dy part): the block's dy are iy0 ... iy0 +
  // nw - 1 (all nd unless a small grid splits them over blocks)
  const int nsplit = (nd + nw - 1) / nw;
  const int iy0 = (blockIdx.x % nsplit) * nw;
  const int r = warp / nw, iyl = warp - r * nw, iy = iy0 + iyl;
  const int xg0 = (blockIdx.x / nsplit) * kGroupX;
  const int yb = blockIdx.y % stride + stride * R * (blockIdx.y / stride);
  const int b = blockIdx.z;
  const int nchunks = (C + kStepC - 1) / kStepC;

  // the last column group of a ragged W loads only its W - x0 columns
  // (+ the halo) through the tail maps; the rows past them are never read
  // into a kept diagonal
  const bool tail = xg0 + kGroupX > W;
  const CUtensorMap* m1 = tail ? &tail1 : &map1;
  const CUtensorMap* m2 = tail ? &tail2 : &map2;
  const uint32_t box_bytes = tail
      ? (R * (W - xg0) + nrows2 * (W - xg0 + 2 * dmax)) * kRowB : stage_bytes;
  auto issue = [&](int chunk) {   // kTma, one thread
    const int buf = chunk % kStages;
    const uint32_t s = ring_addr + buf * stage_bytes;
    const uint32_t bar = bars + 8 * buf;
    mbar_expect(bar, box_bytes);
    for (int rr = 0; rr < R; ++rr)
      tma_load(s + rr * kGroupX * kRowB, m1, chunk * kStepC, xg0,
               yb + rr * stride, b, bar);
    for (int t = 0; t < nrows2; ++t)
      tma_load(s + (R * kGroupX + t * kCols) * kRowB, m2, chunk * kStepC,
               xg0 - dmax, yb - dmax + (iy0 + t) * stride, b, bar);
  };
  auto fill = [&](int chunk) {    // !kTma, all threads, into stage 0
    const int64_t frame = (int64_t)b * H * W;
    for (int i = tid; i < stage_rows * (kStepC / 8); i += nthreads) {
      const int p = i / (kStepC / 8), part = i % (kStepC / 8);
      int yy, x;
      const uint16_t* src;
      if (p < R * kGroupX) {
        const int rr = p / kGroupX;
        yy = yb + rr * stride; x = xg0 + p - rr * kGroupX; src = f1;
      } else {
        const int t = (p - R * kGroupX) / kCols;
        yy = yb - dmax + (iy0 + t) * stride;
        x = xg0 - dmax + (p - R * kGroupX - t * kCols);
        src = f2;
      }
      const int c = chunk * kStepC + part * 8;
      const bool in = yy >= 0 && yy < H && x >= 0 && x < W;
      __align__(16) uint16_t v[8];
      const int64_t off = in ? (frame + (int64_t)yy * W + x) * C + c : 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = in && c + e < C ? src[off + e] : 0;
      *reinterpret_cast<uint4*>(ring + swz(p, part)) =
          *reinterpret_cast<const uint4*>(v);
    }
  };

  if (kTma) {
    if (tid == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int st = 0; st < kStages - 1 && st < nchunks; ++st) issue(st);
  }

  const int yo = yb + r * stride;                       // output row
  const int yy2 = yb - dmax + (r + iy) * stride;        // its f2 row for dy
  const bool live = iy < nd && yo < H && yy2 >= 0 && yy2 < H;  // else 0
  const int ntiles = min(kTilesX, (W - xg0 + 15) / 16);
  const int row1 = r * kGroupX, row2 = R * kGroupX + (r + iyl) * kCols;
  float acc[kTilesX][4][4];
#pragma unroll
  for (int t = 0; t < kTilesX; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  for (int i = 0; i < nchunks; ++i) {
    __syncthreads();                 // the stage computed last is free
    int buf = 0;
    if (kTma) {
      if (tid == 0 && i + kStages - 1 < nchunks) issue(i + kStages - 1);
      buf = i % kStages;
      mbar_wait(bars + 8 * buf, (i / kStages) & 1);
    } else {
      fill(i);
      __syncthreads();
    }
    if (!live) continue;
    const int base = buf * stage_rows;
    switch (ntiles) {     // a branch-free body per tile count
      case 4: band_step<4>(acc, ring, base + row1, base + row2, lane); break;
      case 3: band_step<3>(acc, ring, base + row1, base + row2, lane); break;
      case 2: band_step<2>(acc, ring, base + row1, base + row2, lane); break;
      default: band_step<1>(acc, ring, base + row1, base + row2, lane);
    }
  }
  __syncthreads();

  // keep the diagonals: accumulator (q, n) of tile t holds f1[x0 + 16t + q]
  // . f2[x0 - dmax + 16t + n], i.e. dx index ix = (n - q) / stride; the
  // division of k = n - q < 32 by stride <= 16 is (k * inv) >> 16, exact
  // in that range
  const int nd2 = nd * nd, pitch = nw * nd;   // so: [R][64 px][nw * nd]
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(ring);
  const float fc = (float)C;
  const int g = lane >> 2, t4 = lane & 3;
  const int inv = (65535 + stride) / stride;
#pragma unroll
  for (int t = 0; t < kTilesX; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = g + 8 * (e >> 1);
        const int k = 8 * j + 2 * t4 + (e & 1) - q;
        const int ix = (k * inv) >> 16;
        if (k >= 0 && ix * stride == k && ix < nd && iy < nd)
          so[(row1 + 16 * t + q) * pitch + iyl * nd + ix] =
              __float2bfloat16(acc[t][j][e] / fc);
      }
  __syncthreads();
  const int nx = min(kGroupX, W - xg0);
  const int seg = (min(nw, nd - iy0)) * nd;     // this block's channels
  for (int rr = 0; rr < R; ++rr) {
    const int y = yb + rr * stride;
    if (y >= H) break;
    __nv_bfloat16* dst = out + (((int64_t)b * H + y) * W + xg0) * nd2
                         + iy0 * nd;
    const __nv_bfloat16* src = so + rr * kGroupX * pitch;
    if (seg == nd2 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0
        && (nx * nd2 & 1) == 0) {
      // all the rows' dy-major channels, contiguous in `out`: 4-byte words
      for (int i = tid; i < nx * nd2 / 2; i += nthreads)
        reinterpret_cast<uint32_t*>(dst)[i] =
            reinterpret_cast<const uint32_t*>(src)[i];
    } else {
      for (int i = tid; i < nx * seg; i += nthreads)
        dst[(i / seg) * nd2 + i % seg] = src[(i / seg) * pitch + i % seg];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A TMA map of the (B, H, W, C) bf16 maps at `ptr`, boxes of `box_c`
// channels x `box_w` pixels of one row, swizzled, zeros out of bounds.
// Returns a cudaError_t.
int encode_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int C,
               int box_c, int box_w, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult res;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &res);
    if (err != cudaSuccess) return (int)err;
    if (res != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int R, bool kTma>
int launch_tc_rows(const CUtensorMap (&maps)[4], const void* f1,
                   const void* f2, void* out, int B, int H, int W, int C,
                   int dmax, int stride, int nd, int nw,
                   cudaStream_t stream) {
  auto smem = [&](int n) {
    return (size_t)kStages * kRowB * (R * kGroupX + (R + n - 1) * kCols)
           + 8 * kStages + 1024;
  };
  int err = allow_smem(correlation_tc_kernel<R, kTma>, smem(kMaxNd));
  if (err) return err;
  const int per_class = ((H + stride - 1) / stride + R - 1) / R;
  dim3 grid((W + kGroupX - 1) / kGroupX * ((nd + nw - 1) / nw),
            stride * per_class, B);
  correlation_tc_kernel<R, kTma><<<grid, 32 * nw * R, smem(nw), stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const uint16_t*>(f1),
      static_cast<const uint16_t*>(f2), static_cast<__nv_bfloat16*>(out), H,
      W, C, dmax, stride, nd, nw);
  return (int)cudaGetLastError();
}

// Two rows a block where the one-row grid has a block for every SM (two
// pairs or more at 38 x 68); below that one row, with the dy split over
// three blocks, so a one-pair grid has 228 blocks instead of 38.
int launch_tc(const void* f1, const void* f2, void* out, int B, int H, int W,
              int C, int dmax, int stride, cudaStream_t stream) {
  const int nd = (2 * dmax) / stride + 1;
  if (dmax > kMaxD || nd > kMaxNd) return (int)cudaErrorInvalidValue;
  const bool tma = C % 8 == 0 && ((uintptr_t)f1 | (uintptr_t)f2) % 16 == 0;
  // f1 and f2 boxes for full column groups and for the ragged last one
  CUtensorMap maps[4] = {};
  if (tma) {
    const int tail = W % kGroupX ? W % kGroupX : kGroupX;
    const void* src[4] = {f1, f2, f1, f2};
    const int box_w[4] = {kGroupX, kCols, tail, tail + 2 * dmax};
    for (int i = 0; i < 4; ++i) {
      const int err = encode_map(&maps[i], src[i], B, H, W, C, kStepC,
                                 box_w[i], CU_TENSOR_MAP_SWIZZLE_64B);
      if (err) return err;
    }
  }
  const bool two = (long)B * H * ((W + kGroupX - 1) / kGroupX)
                   >= sm_count();
  const int nw = two ? nd : (nd + 2) / 3;
  const auto args = [&](auto fn) {
    return fn(maps, f1, f2, out, B, H, W, C, dmax, stride, nd, nw, stream);
  };
  if (two)
    return tma ? args(launch_tc_rows<2, true>) : args(launch_tc_rows<2, false>);
  return tma ? args(launch_tc_rows<1, true>) : args(launch_tc_rows<1, false>);
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int B, int H, int W,
           int C, int dmax, int stride, cudaStream_t stream) {
  return launch_corr<T, false>(f1, f2, out, B, H, W, C, dmax, stride, C, 1,
                               stream);
}

// Channel-split forward (dtt_correlation_split). Replaces the TPU kernel
// _corr_kernel (dtt/ops/correlation.py), which walked a sequential grid of
// 128-channel blocks (channels zero-padded to a whole block) and added each
// block's 81 planes into one f32 accumulator that stayed in VMEM. On Hopper
// blocks run in parallel in no order, so the channel blocks become
// concurrent CUDA blocks: the body above, one block per (column tile, row,
// pair, channel block), e.g. 3 x 38 x 8 = 912 blocks for one pair at
// C = 1024 where the unsplit kernel has 114 (under one wave of 132 SMs).
// Each writes its partial planes to an f32 workspace; a second kernel adds
// the partials in block order, divides by C and casts to the input dtype,
// so the result does not depend on the order the blocks ran in (no
// atomics). Channels past C are not read, which the zero padding made
// inert on the TPU.
//
// Bound: the maps are read once and the output written once (~13 bf16 MAC
// per input byte at the main-path shapes), so the memory rate bounds it;
// the workspace adds nblk x 4 bytes per output each way.
template <typename T>
__global__ void correlation_split_sum_kernel(const float* __restrict__ part,
                                             T* __restrict__ out,
                                             int64_t total, int nblk, int C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int cb = 0; cb < nblk; ++cb) acc = __fadd_rn(acc, part[cb * total + i]);
  store(out + i, acc / (float)C);
}

template <typename T>
int launch_split(const void* f1, const void* f2, void* part, void* out,
                 int B, int H, int W, int C, int dmax, int stride,
                 int block_c, cudaStream_t stream) {
  if (stride < 1 || dmax < 0 || C < 1 || block_c < 1)
    return (int)cudaErrorInvalidValue;
  const int nd = (2 * dmax) / stride + 1;
  const int nblk = (C + block_c - 1) / block_c;
  int err = launch_corr<T, true>(f1, f2, part, B, H, W, C, dmax, stride,
                                 block_c, nblk, stream);
  if (err) return err;
  const int64_t total = (int64_t)B * H * W * nd * nd;
  if (total == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  correlation_split_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), total, nblk, C);
  return (int)cudaGetLastError();
}

// Backward (dtt_correlation_bwd). dtt has no TPU kernel here: its backward
// is XLA's AD of the banded-matmul form (dtt/ops/correlation.py _corr_bwd).
// With g the output gradient, per input element
//
//   df1[b, y, x, c] = (1/C) * sum_j g[b, y, x, j] * f2[b, y + dy_j, x + dx_j, c]
//   df2[b, y, x, c] = (1/C) * sum_j g[b, y - dy_j, x - dx_j, j]
//                                 * f1[b, y - dy_j, x - dx_j, c]
//
// (terms outside the map are 0), summed in f32 and written in the input
// dtype. Both are gathers, so no atomics and each element is written once.
//
// Bound: f1, f2 and g are read and df1, df2 written once; at the main-path
// shapes that is ~40 operations (2 x 81 MACs) per byte moved, far below
// the card's bf16 rate per byte, so the memory rate bounds it, and again
// the design's work is to reuse each staged value instead of gathering it
// 81 times. The caller names the body by the forward's rule:
//
// * bfloat16 in the band (correlation_bwd_tc_kernel): the forward's band used the other
//   way, on mma.sync.m16n8k16. For one row y, a 16-column tile at x0 and
//   each dy, df1[y, x0 + q, c] += sum_n B[q, n] f2[y + dy, x0 - dmax + n, c]
//   with the band B[q, q + ix * stride] = g[y, x0 + q, (iy, ix)] (16 x 32,
//   zero off its nd diagonals), and df2[y, x0 + q, c] += sum_n B'[q, n]
//   f1[y - dy, x0 - dmax + n, c] with B'[q, q + 2 dmax - ix * stride] =
//   g[y - dy, x0 - dmax + n, (iy, ix)]. One launch: blockIdx.z picks df1 or
//   df2; a block owns one row and 64 columns and walks the channels in
//   tiles of 128, one warp per (16-column tile, 64-channel half). It builds
//   the A fragments of every dy once, from g staged in shared memory, and
//   keeps them there, so the gathers of g and the band's index arithmetic
//   are paid once per block and not once per channel tile; then one thread
//   loads the (channel tile, in-map dy row) stages of f2 (or f1), 80
//   columns x 128 channels, by TMA into a 3-stage ring (128-byte swizzled
//   pixel rows: ldmatrix.trans reads the B fragments without bank
//   conflicts). A ragged last column group loads tail-sized boxes into a
//   ring zeroed once. g is bf16 (the
//   wrapper's autograd casts it), so every product is exact and the f32
//   sum is rounded once, as in the gather form; each element is written by
//   one block, so the result is deterministic.
// * float32, and bfloat16 windows past the band: the gather body below,
//   one thread per input element computing both gradients, channel-fastest
//   so a warp's g loads are broadcasts and its f1/f2 loads coalesce; it
//   takes any window.
template <typename T>
__global__ void correlation_bwd_kernel(const T* __restrict__ f1,
                                       const T* __restrict__ f2,
                                       const T* __restrict__ g,
                                       T* __restrict__ df1,
                                       T* __restrict__ df2, int64_t total,
                                       int H, int W, int C, int dmax,
                                       int stride, int nd) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const int64_t p = i / C;                 // pixel (b*H + y)*W + x
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  const int64_t frame = p - ((int64_t)y * W + x);
  const int nd2 = nd * nd;
  float a1 = 0.f, a2 = 0.f;
  for (int iy = 0; iy < nd; ++iy) {
    const int dy = -dmax + iy * stride;
    const int y1 = y + dy, y2 = y - dy;
    const bool in1 = y1 >= 0 && y1 < H, in2 = y2 >= 0 && y2 < H;
    for (int ix = 0; ix < nd; ++ix) {
      const int dx = -dmax + ix * stride;
      const int j = iy * nd + ix;
      const int x1 = x + dx, x2 = x - dx;
      if (in1 && x1 >= 0 && x1 < W)
        a1 += to_f32(g[p * nd2 + j])
              * to_f32(f2[(frame + (int64_t)y1 * W + x1) * C + c]);
      if (in2 && x2 >= 0 && x2 < W) {
        const int64_t p2 = frame + (int64_t)y2 * W + x2;
        a2 += to_f32(g[p2 * nd2 + j]) * to_f32(f1[p2 * C + c]);
      }
    }
  }
  const float fc = (float)C;
  store(df1 + i, a1 / fc);
  store(df2 + i, a2 / fc);
}

constexpr int kBwdC = 128;      // channels per stage: 2 warp halves x 64
constexpr int kFragBytes = kTilesX * kMaxNd * 2 * 32 * 16;  // A fragments

// Byte offset of 16-byte chunk `ch` (0..7) of 128-byte row `row` in the
// TMA's 128-byte swizzle (chunk bits 4-6 XOR address bits 7-9), from a
// 1024-byte aligned base: ldmatrix reads 8 rows without conflicts.
__device__ __forceinline__ uint32_t swz128(int row, int ch) {
  return (uint32_t)row * 128 + ((ch ^ (row & 7)) << 4);
}

// Block: one row y x 64 columns of df1 or df2, all channels; warp (x-tile
// t, channel half h). The band fragments (A) of every dy are built once
// from the staged g and kept in shared memory; then the block walks
// (128-channel tile, in-map dy row) stages of the displaced map, one
// thread filling them by TMA (two boxes of 64 channels x 80 columns,
// 128-byte swizzled rows) 2 ahead of the warps, or, without kTma, all
// threads filling one stage with 2-byte loads before each step.
template <bool kTma>
__global__ void __launch_bounds__(64 * kTilesX, 2)
correlation_bwd_tc_kernel(const __grid_constant__ CUtensorMap map1,
                          const __grid_constant__ CUtensorMap map2,
                          const __grid_constant__ CUtensorMap tail1,
                          const __grid_constant__ CUtensorMap tail2,
                          const uint16_t* __restrict__ f1,
                          const uint16_t* __restrict__ f2,
                          const uint16_t* __restrict__ g,
                          __nv_bfloat16* __restrict__ df1,
                          __nv_bfloat16* __restrict__ df2, int B, int H,
                          int W, int C, int dmax, int stride, int nd) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring_addr = smem_addr(ring);
  constexpr uint32_t kHalfBytes = kCols * 128;
  constexpr uint32_t kStageBytes = 2 * kHalfBytes;
  uint4* frag = reinterpret_cast<uint4*>(ring + kStages * kStageBytes);
  const uint32_t bars = ring_addr + kStages * kStageBytes + kFragBytes;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = warp % kTilesX, h = warp / kTilesX;
  const bool second = blockIdx.z >= B;         // df2 (else df1)
  const int b = second ? blockIdx.z - B : blockIdx.z;
  const int xg0 = blockIdx.x * kGroupX, y = blockIdx.y;
  const int64_t frame = (int64_t)b * H * W;
  const int nd2 = nd * nd;
  const int gq = lane >> 2, t4 = lane & 3;
  __nv_bfloat16* out = second ? df2 : df1;
  // the in-map rows y + dy (df1) or y - dy (df2) are consecutive iy
  int iy0 = nd, iy1 = -1;
  for (int iy = 0; iy < nd; ++iy) {
    const int dy = -dmax + iy * stride;
    const int yy = second ? y - dy : y + dy;
    if (yy >= 0 && yy < H) { iy0 = min(iy0, iy); iy1 = iy; }
  }
  const int nrows = iy1 - iy0 + 1;
  const int nx = min(kGroupX, W - xg0);
  if (nrows <= 0) {                  // no term: the gradient is 0
    for (int i = tid; i < nx * C; i += nthreads)
      out[(frame + (int64_t)y * W + xg0) * C + i] = __float2bfloat16(0.f);
    return;
  }

  // 1. the g values of the bands, staged in the ring: df1 g[y, x0 + p, :]
  // (64 x nd2); df2, per dy, g[y - dy, x0 - dmax + col, (iy, :)]
  // (nd x 80 x nd); 8 loads in flight a thread
  uint16_t* gs = reinterpret_cast<uint16_t*>(ring);
  const int ng = second ? nd * kCols * nd : kGroupX * nd2;
  for (int i0 = tid; i0 < ng; i0 += 8 * nthreads) {
    uint16_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthreads;
      int yy = y, x = xg0 + i / nd2, ch = i % nd2;
      if (second) {
        const int iy = i / (nd * kCols);
        yy = y + dmax - iy * stride;
        x = xg0 - dmax + (i / nd) % kCols;
        ch = iy * nd + i % nd;
      }
      v[u] = i < ng && yy >= 0 && yy < H && x >= 0 && x < W
          ? g[(frame + (int64_t)yy * W + x) * nd2 + ch] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * nthreads < ng) gs[i0 + u * nthreads] = v[u];
  }
  __syncthreads();

  // 2. the A fragments: for tile t, dy index iy and band step ks, the band
  // B[q, n] (df1: n = q + ix * stride, g[y, x0 + q, (iy, ix)]; df2: n =
  // q + 2 dmax - ix * stride, g[y - dy, x0 - dmax + n, (iy, ix)]) at rows
  // q of the tile and columns n in [16 ks, 16 ks + 16)
  const int nks = (15 + 2 * dmax) / 16 + 1;    // k16 steps of the band
  for (int iy = iy0 + h; iy <= iy1; iy += 2)
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int q = gq + 8 * (reg & 1);
        uint16_t v[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = 16 * ks + 8 * (reg >> 1) + 2 * t4 + hh;
          const int k = second ? q + 2 * dmax - n : n - q;
          v[hh] = 0;
          if (k >= 0 && k % stride == 0 && k / stride < nd)
            v[hh] = second ? gs[(iy * kCols + 16 * t + n) * nd + k / stride]
                           : gs[(16 * t + q) * nd2 + iy * nd + k / stride];
        }
        a[reg] = pack2(v[0], v[1]);
      }
      frag[((t * kMaxNd + iy) * 2 + ks) * 32 + lane] =
          make_uint4(a[0], a[1], a[2], a[3]);
    }

  // 3. (channel tile, dy row) stages of the displaced map: f2 for df1, f1
  // for df2
  // the last column group of a ragged W loads only its W - x0 columns (+
  // the halo) through the tail maps, into a ring zeroed once: the band's
  // zeros meet those rows, and 0 times stale shared memory could be NaN
  const bool tail = xg0 + kGroupX > W;
  const CUtensorMap* map = second ? (tail ? &tail1 : &map1)
                                  : (tail ? &tail2 : &map2);
  const uint32_t box_bytes = tail ? 2 * (nx + 2 * dmax) * 128 : kStageBytes;
  const uint16_t* src = second ? f1 : f2;
  const int nstages = (C + kBwdC - 1) / kBwdC * nrows;
  auto stage_row = [&](int st) {
    const int dy = -dmax + (iy0 + st % nrows) * stride;
    return second ? y - dy : y + dy;
  };
  auto issue = [&](int st) {   // kTma, one thread
    const int buf = st % kStages;
    const uint32_t bar = bars + 8 * buf;
    mbar_expect(bar, box_bytes);
    for (int hh = 0; hh < 2; ++hh)
      tma_load(ring_addr + buf * kStageBytes + hh * kHalfBytes, map,
               (st / nrows) * kBwdC + 64 * hh, xg0 - dmax, stage_row(st), b,
               bar);
  };
  auto fill = [&](int st) {    // !kTma, all threads, into stage 0
    const int yy = stage_row(st);
    for (int i = tid; i < kCols * (kBwdC / 8); i += nthreads) {
      const int p = i % kCols, piece = i / kCols;
      const int x = xg0 - dmax + p, c = (st / nrows) * kBwdC + piece * 8;
      const bool in = x >= 0 && x < W;
      __align__(16) uint16_t v[8];
      const int64_t off = in ? (frame + (int64_t)yy * W + x) * C + c : 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = in && c + e < C ? src[off + e] : 0;
      *reinterpret_cast<uint4*>(ring + (piece >> 3) * kHalfBytes
                                + swz128(p, piece & 7)) =
          *reinterpret_cast<const uint4*>(v);
    }
  };

  __syncthreads();                   // fragments built; gs is free
  if (kTma) {
    if (tail) {
      for (int i = tid; i < kStages * kStageBytes / 16; i += nthreads)
        reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
      // order these writes before the TMA's (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if (tid == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int st = 0; st < kStages - 1 && st < nstages; ++st) issue(st);
  }

  float acc[8][4];
  const bool tile_in = 16 * t < nx;
  const int m = lane >> 3;
  const float fc = (float)C;
  for (int st = 0; st < nstages; ++st) {
    __syncthreads();                 // the stage computed last is free
    int buf = 0;
    if (kTma) {
      if (tid == 0 && st + kStages - 1 < nstages) issue(st + kStages - 1);
      buf = st % kStages;
      mbar_wait(bars + 8 * buf, (st / kStages) & 1);
    } else {
      fill(st);
      __syncthreads();
    }
    const int i = st % nrows;
    if (i == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    if (tile_in) {
      const uint8_t* s = ring + buf * kStageBytes + h * kHalfBytes;
      for (int ks = 0; ks < nks; ++ks) {
        const uint4 f = frag[((t * kMaxNd + iy0 + i) * 2 + ks) * 32 + lane];
        const uint32_t a[4] = {f.x, f.y, f.z, f.w};
        // B = staged pixels 16t + 16ks + (0..15) x the half's 64 channels
        const int row = 16 * t + 16 * ks + 8 * (m & 1) + (lane & 7);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, s + swz128(row, 2 * np + (m >> 1)));
          mma_bf16(acc[2 * np], a, bb[0], bb[1]);
          mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    if (i == nrows - 1 && tile_in) {
      const int c0 = (st / nrows) * kBwdC + 64 * h;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int x = xg0 + 16 * t + gq + 8 * (e >> 1);
          const int c = c0 + 8 * n + 2 * t4;
          if (x >= W) continue;
          __nv_bfloat16* o = out + (frame + (int64_t)y * W + x) * C + c;
          if ((C & 1) == 0 && c < C) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(
                acc[n][e] / fc, acc[n][e + 1] / fc);
          } else {
            if (c < C) o[0] = __float2bfloat16(acc[n][e] / fc);
            if (c + 1 < C) o[1] = __float2bfloat16(acc[n][e + 1] / fc);
          }
        }
    }
  }
}

template <bool kTma>
int launch_bwd_tc_form(const CUtensorMap (&maps)[4], const void* f1, const void* f2, const void* g,
                       void* df1, void* df2, int B, int H, int W, int C,
                       int dmax, int stride, int nd, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * 2 * kCols * 128 + kFragBytes
                      + 8 * kStages + 1024;
  int err = allow_smem(correlation_bwd_tc_kernel<kTma>, smem);
  if (err) return err;
  dim3 grid((W + kGroupX - 1) / kGroupX, H, 2 * B);
  correlation_bwd_tc_kernel<kTma><<<grid, 64 * kTilesX, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const uint16_t*>(f1),
      static_cast<const uint16_t*>(f2), static_cast<const uint16_t*>(g),
      static_cast<__nv_bfloat16*>(df1), static_cast<__nv_bfloat16*>(df2), B,
      H, W, C, dmax, stride, nd);
  return (int)cudaGetLastError();
}

int launch_bwd_tc(const void* f1, const void* f2, const void* g, void* df1,
                  void* df2, int B, int H, int W, int C, int dmax, int stride,
                  cudaStream_t stream) {
  const int nd = (2 * dmax) / stride + 1;
  if (dmax > kMaxD || nd > kMaxNd) return (int)cudaErrorInvalidValue;
  const bool tma = C % 8 == 0 && ((uintptr_t)f1 | (uintptr_t)f2) % 16 == 0;
  // f1 and f2 boxes (64 channels) for full column groups and the ragged
  // last one
  CUtensorMap maps[4] = {};
  if (tma) {
    const int tail = W % kGroupX ? W % kGroupX : kGroupX;
    const void* src[4] = {f1, f2, f1, f2};
    const int box_w[4] = {kCols, kCols, tail + 2 * dmax, tail + 2 * dmax};
    for (int i = 0; i < 4; ++i) {
      const int err = encode_map(&maps[i], src[i], B, H, W, C, 64, box_w[i],
                                 CU_TENSOR_MAP_SWIZZLE_128B);
      if (err) return err;
    }
    return launch_bwd_tc_form<true>(maps, f1, f2, g, df1, df2, B, H, W, C,
                                    dmax, stride, nd, stream);
  }
  return launch_bwd_tc_form<false>(maps, f1, f2, g, df1, df2, B, H, W, C,
                                   dmax, stride, nd, stream);
}

template <typename T>
int launch_bwd(const void* f1, const void* f2, const void* g, void* df1,
               void* df2, int B, int H, int W, int C, int dmax, int stride,
               cudaStream_t stream) {
  if (stride < 1 || dmax < 0) return (int)cudaErrorInvalidValue;
  const int nd = (2 * dmax) / stride + 1;
  const int64_t total = (int64_t)B * H * W * C;
  if (total == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  correlation_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const T*>(g), static_cast<T*>(df1), static_cast<T*>(df2),
      total, H, W, C, dmax, stride, nd);
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2: (B, H, W, C) contiguous; out: (B, H, W, nd*nd) of the same dtype.
// dtype: 0 = float32, 1 = bfloat16. tensor_cores: 1 runs the bf16 band
// (dmax <= 8, nd <= 9), 0 the CUDA-core body (nd <= 32). Returns a
// cudaError_t (0 = launched).
extern "C" int dtt_correlation(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, int dmax,
                               int stride, int dtype, int tensor_cores,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride < 1 || dmax < 0) return (int)cudaErrorInvalidValue;
  if (tensor_cores)
    return dtype == 1 ? launch_tc(f1, f2, out, B, H, W, C, dmax, stride, s)
                      : (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(f1, f2, out, B, H, W, C, dmax, stride, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(f1, f2, out, B, H, W, C, dmax, stride, s);
  return (int)cudaErrorInvalidValue;
}

// f1, f2: (B, H, W, C) contiguous; part: (ceil(C / block_c), B, H, W,
// nd*nd) float32 workspace; out: (B, H, W, nd*nd) of the maps' dtype.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dtt_correlation_split(const void* f1, const void* f2,
                                     void* part, void* out, int B, int H,
                                     int W, int C, int dmax, int stride,
                                     int block_c, int dtype, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_split<float>(f1, f2, part, out, B, H, W, C, dmax, stride,
                               block_c, s);
  if (dtype == 1)
    return launch_split<__nv_bfloat16>(f1, f2, part, out, B, H, W, C, dmax,
                                       stride, block_c, s);
  return (int)cudaErrorInvalidValue;
}

// f1, f2, df1, df2: (B, H, W, C) contiguous; g: (B, H, W, nd*nd); all of
// one dtype (0 = float32, 1 = bfloat16). tensor_cores: 1 runs the bf16 band
// (dmax <= 8, nd <= 9), 0 the gather (any window). Returns a cudaError_t
// (0 = launched).
extern "C" int dtt_correlation_bwd(const void* f1, const void* f2,
                                   const void* g, void* df1, void* df2, int B,
                                   int H, int W, int C, int dmax, int stride,
                                   int dtype, int tensor_cores, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride < 1 || dmax < 0) return (int)cudaErrorInvalidValue;
  if (tensor_cores)
    return dtype == 1
        ? launch_bwd_tc(f1, f2, g, df1, df2, B, H, W, C, dmax, stride, s)
        : (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(f1, f2, g, df1, df2, B, H, W, C, dmax, stride, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(f1, f2, g, df1, df2, B, H, W, C, dmax,
                                     stride, s);
  return (int)cudaErrorInvalidValue;
}
