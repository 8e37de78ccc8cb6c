// FlowNet correlation, its channel-split form and its backward for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Forward (dtt_correlation):
// Replaces the TPU kernel _corr_mm_kernel (dtt/ops/correlation.py), which
// computed each vertical displacement as a banded row matmul on the MXU and
// read the horizontal displacements off as diagonals (84 columns computed to
// keep 9). On this card the 81 dot products are computed directly:
//
//   out[b, y, x, iy*nd + ix] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y + dy, x + dx, c]
//   dy = -dmax + iy*stride, dx = -dmax + ix*stride, zero outside f2,
//
// accumulated in f32 and written in the input dtype (dy-major channels).
//
// Bound: at the main-path shapes (38x68 maps, C = 512/1024, 81 outputs) the
// op needs ~13 bf16 MAC per input byte, so the card's memory rate bounds
// it. This first version runs on the CUDA cores: one block per (pair, output
// row, 32-column tile); f1's row tile and the nd rows of f2 it meets (with a
// dmax-column halo) are staged through shared memory in 16-channel chunks,
// converted to f32 once. Each thread owns one (x, dy) pair and keeps its nd
// horizontal displacements in registers, so every staged f2 value is reused
// by nd outputs and no partial sum leaves the block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxNd = 9;    // displacements per axis: 2*dmax/stride + 1 (rounded down)
constexpr int kTileX = 32;   // output columns per block (one warp wide)
constexpr int kChunkC = 16;  // channels staged per step
constexpr int kPitch1 = kTileX + 1;  // odd pitches: conflict-free transposed stores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The body is shared with the channel-split forward (dtt_correlation_split,
// below): with kSplit each block sums only the channels [cb*block_c,
// (cb+1)*block_c) of its pair, blockIdx.z = cb*B + b, and writes its raw f32
// sums to the (nblk, B, H, W, nd*nd) workspace; without it blockIdx.z = b,
// block_c = C, and the block writes the channel mean in the input dtype.
template <typename T, bool kSplit>
__global__ void correlation_kernel(const T* __restrict__ f1,
                                   const T* __restrict__ f2,
                                   void* __restrict__ out_,
                                   int B, int H, int W, int C, int dmax,
                                   int stride, int nd, int block_c) {
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

  float acc[kMaxNd];
#pragma unroll
  for (int j = 0; j < kMaxNd; ++j) acc[j] = 0.f;

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
      for (int j = 0; j < kMaxNd; ++j)
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
      for (int j = 0; j < kMaxNd; ++j)
        if (j < nd) part[j] = acc[j];
    } else {
      T* dst = static_cast<T*>(out_) + o;
      const float fc = (float)C;
#pragma unroll
      for (int j = 0; j < kMaxNd; ++j)
        if (j < nd) store(dst + j, acc[j] / fc);
    }
  }
}

template <typename T, bool kSplit>
int launch_corr(const void* f1, const void* f2, void* out, int B, int H,
                int W, int C, int dmax, int stride, int block_c, int nblk,
                cudaStream_t stream) {
  const int nd = (2 * dmax) / stride + 1;
  const int halo_w = kTileX + 2 * dmax;
  const size_t smem = sizeof(float) *
      (kChunkC * kPitch1 + (size_t)nd * kChunkC * (halo_w | 1));
  dim3 grid((W + kTileX - 1) / kTileX, H, B * nblk);
  dim3 block(kTileX, nd);
  correlation_kernel<T, kSplit><<<grid, block, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), out, B, H, W, C,
      dmax, stride, nd, block_c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int B, int H, int W,
           int C, int dmax, int stride, cudaStream_t stream) {
  if (stride < 1 || dmax < 0) return (int)cudaErrorInvalidValue;
  if ((2 * dmax) / stride + 1 > kMaxNd) return (int)cudaErrorInvalidValue;
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
  if (nd > kMaxNd) return (int)cudaErrorInvalidValue;
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
// dtype. Both are gathers, so no atomics: one launch, one thread per input
// element computing both gradients.
//
// Bound: f1, f2 and g are read and df1, df2 written once; at the main-path
// shapes that is ~40 operations (2 x 81 MACs) per byte moved, far below
// the card's bf16 rate per byte, so the memory rate bounds it. Threads run channel-fastest: a warp shares one pixel, so its g
// loads are broadcasts and its f1/f2 loads of the displaced pixel
// coalesce; the 81-fold reuse of each f1/f2 value is left to the caches.
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
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dtt_correlation(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, int dmax,
                               int stride, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
// one dtype (0 = float32, 1 = bfloat16). Returns a cudaError_t (0 = launched).
extern "C" int dtt_correlation_bwd(const void* f1, const void* f2,
                                   const void* g, void* df1, void* df2, int B,
                                   int H, int W, int C, int dmax, int stride,
                                   int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(f1, f2, g, df1, df2, B, H, W, C, dmax, stride, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(f1, f2, g, df1, df2, B, H, W, C, dmax,
                                     stride, s);
  return (int)cudaErrorInvalidValue;
}
