// Position-sensitive RoI pooling for Hopper (sm_90a), plain C interface for
// ctypes: the direct bin sums and their backward, and the bin sums and bin
// means off a summed-area table (dtt_psroi_sat, dtt_psroi_sat_mean, below).
//
// Forward (dtt_psroi_direct):
// Replaces the TPU kernel _psroi_direct_kernel (dtt/ops/psroi.py), which
// contracted 0/1 row and column interval indicators against each bin's map
// slab with two MXU matmuls per (frame, bin). Here each sum is computed
// directly, one thread per output (the reference lineage's layout):
//
//   sums[b, n, ph, pw, d] = sum_{hs <= y < he} sum_{ws <= x < we}
//                           M[b, y, x, (ph*k + pw)*D + d]
//
// with integer bounds (B, N, k) made outside the kernel, accumulated and
// written in f32; the wrapper divides by the area and zeroes empty bins.
//
// Bound: the maps are read and the sums written once, with one add per
// pixel of a bin, so the memory rate bounds it. Output index and channel
// share their fastest axis: for a fixed RoI, consecutive threads read
// consecutive channels of the NHWC map, so each warp's loads of one pixel
// coalesce, and the indicator matmuls' zeros are never multiplied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

constexpr int kMaxBwdRois = 4000;  // 3 ints of shared memory per RoI, < 48 KB

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void psroi_direct_kernel(const T* __restrict__ maps,
                                    const int* __restrict__ hs,
                                    const int* __restrict__ he,
                                    const int* __restrict__ ws,
                                    const int* __restrict__ we,
                                    float* __restrict__ sums,
                                    int64_t total, int N, int H, int W, int k,
                                    int D) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ckk = k * k * D;
  const int c = (int)(i % ckk);          // channel (ph*k + pw)*D + d
  const int64_t bn = i / ckk;            // b*N + n
  const int64_t b = bn / N;
  const int bin = c / D;
  const int ph = bin / k;
  const int pw = bin % k;
  const int y0 = hs[bn * k + ph], y1 = he[bn * k + ph];
  const int x0 = ws[bn * k + pw], x1 = we[bn * k + pw];
  const T* m = maps + b * H * W * ckk + c;
  float acc = 0.f;
  for (int y = y0; y < y1; ++y) {
    const T* row = m + (int64_t)y * W * ckk;
    for (int x = x0; x < x1; ++x) acc += to_f32(row[(int64_t)x * ckk]);
  }
  sums[i] = acc;
}

template <typename T>
int launch(const void* maps, const int* hs, const int* he, const int* ws,
           const int* we, float* sums, int B, int N, int H, int W, int k,
           int D, cudaStream_t stream) {
  const int64_t total = (int64_t)B * N * k * k * D;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  psroi_direct_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(maps), hs, he, ws, we, sums, total, N, H, W, k, D);
  return (int)cudaGetLastError();
}

// Backward (dtt_psroi_direct_bwd). Replaces the TPU kernel
// _psroi_direct_bwd_kernel (dtt/ops/psroi.py), which expanded ghat along x
// with a 0/1 selection matmul, masked it with the column indicator and
// contracted the RoI axis against the row indicator on the MXU. Here, per
// output element,
//
//   dmaps[b, y, x, (ph*k + pw)*D + d] = sum_n 1[hs <= y < he] 1[ws <= x < we]
//                                       * ghat[b, n, ph, pw, d]
//
// with ghat = g / area (0 for empty bins) made outside the kernel, summed in
// f32 and written in the maps' dtype. A gather form with no atomics, so the
// result does not depend on the order blocks run in.
//
// Bound: each output is written once and ghat is read once, so the memory
// rate bounds it. One block per (output row y, bin, frame): warp 0 first
// lists, in RoI order, the RoIs whose bin row ph holds y and whose bin
// column pw is not empty (a ballot compaction into shared memory), so the
// block's threads then loop over the few RoIs that touch the row instead
// of all N. Threads walk the row's (x, d) outputs with d fastest: ghat
// loads for one RoI and the stores of one pixel coalesce.
template <typename T>
__global__ void psroi_direct_bwd_kernel(const float* __restrict__ ghat,
                                        const int* __restrict__ hs,
                                        const int* __restrict__ he,
                                        const int* __restrict__ ws,
                                        const int* __restrict__ we,
                                        T* __restrict__ dmaps, int N, int H,
                                        int W, int k, int D) {
  extern __shared__ int smem[];
  int* s_n = smem;            // [N] RoI index
  int* s_x0 = smem + N;       // [N] its bin column [x0, x1)
  int* s_x1 = smem + 2 * N;
  __shared__ int s_count;
  const int y = blockIdx.x;
  const int bin = blockIdx.y;
  const int ph = bin / k;
  const int pw = bin % k;
  const int64_t bn0 = (int64_t)blockIdx.z * N;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < N; base += 32) {
      const int n = base + lane;
      bool hit = false;
      int x0 = 0, x1 = 0;
      if (n < N) {
        const int64_t r = (bn0 + n) * k;
        x0 = ws[r + pw];
        x1 = we[r + pw];
        hit = hs[r + ph] <= y && y < he[r + ph] && x0 < x1;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int pos = count + __popc(mask & ((1u << lane) - 1u));
        s_n[pos] = n;
        s_x0[pos] = x0;
        s_x1[pos] = x1;
      }
      count += __popc(mask);
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();
  const int count = s_count;
  const int C = k * k * D;
  T* out = dmaps + ((int64_t)blockIdx.z * H + y) * W * C + bin * D;
  const float* g = ghat + bin * D;
  for (int e = threadIdx.x; e < W * D; e += blockDim.x) {
    const int x = e / D;
    const int d = e - x * D;
    float acc = 0.f;
    for (int j = 0; j < count; ++j)
      if (s_x0[j] <= x && x < s_x1[j]) acc += g[(bn0 + s_n[j]) * C + d];
    store(out + (int64_t)x * C + d, acc);
  }
}

template <typename T>
int launch_bwd(const float* ghat, const int* hs, const int* he, const int* ws,
               const int* we, void* dmaps, int B, int N, int H, int W, int k,
               int D, cudaStream_t stream) {
  if (N > kMaxBwdRois) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W * k * k * D == 0) return (int)cudaSuccess;
  dim3 grid(H, k * k, B);
  const size_t smem = sizeof(int) * 3 * (size_t)(N > 0 ? N : 1);
  psroi_direct_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      ghat, hs, he, ws, we, static_cast<T*>(dmaps), N, H, W, k, D);
  return (int)cudaGetLastError();
}

// SAT bin sums (dtt_psroi_sat). Replaces the TPU kernel _psroi_mm_kernel_b
// (dtt/ops/psroi.py), which contracted one-hot +-1 row and column
// difference indicators against each (frame, bin) slab of the summed-area
// table on the MXU at HIGHEST precision: dense matmul work over almost all
// zeros, done to avoid the TPU's slow gathers. On Hopper the same value is
// four loads per output:
//
//   sums[b, n, ph, pw, d] = (S[he, we] - S[hs, we]) - (S[he, ws] - S[hs, ws])
//
// with S = SAT[b, :, :, (ph*k + pw)*D + d], in the row-first order the
// indicator form evaluates (rows give t1[x] = S[he, x] - S[hs, x], then the
// columns t1[we] - t1[ws]). A one-hot contraction adds only exact zeros
// beside its two nonzero terms, so the plain einsum form gives the same
// bits on the same table. The subtractions are __fsub_rn: nothing may
// contract or reorder them (no --use_fast_math). The wrapper divides by the
// area and zeroes empty bins. The per-frame TPU kernel _psroi_mm_kernel
// (dtt/ops/psroi.py) has the same body without the frame axis; the port
// launches this entry at B=1 for it.
//
// SAT bin means (dtt_psroi_sat_mean). Replaces the TPU kernel _psroi_kernel
// (dtt/ops/psroi.py), which kept one bin's SAT slab in VMEM (bin-major, for
// Mosaic's block rules), read the RoIs' bounds from SMEM and walked the
// RoIs one by one: the 4-corner difference ((S11 - S01) - S10) + S00,
// divided by the area inside the kernel, empty bins 0. Here the index is
// computed straight off the NHWC table and every output is its own
// thread; the corners are combined in that order with __fsub_rn/__fadd_rn
// and divided with __fdiv_rn, so the result equals the plain gather form
// to the bit.
//
// Bound: 4 f32 corner reads and one f32 write per output, so the memory
// rate bounds both. A pair batch (4 frames x 300 RoIs x 2107 channels) needs
// ~29 MB of distinct table corners and writes 10 MB of sums: ~12 us at
// 3.35 TB/s; on an H100 80GB HBM3 at 700 W the sums take 0.028-0.051 ms
// (chip_smoke.py). One thread per output, channel fastest: for a fixed RoI
// and bin a warp reads 32 consecutive channels of each corner pixel, so
// the corner loads coalesce.
template <bool kMean>
__global__ void psroi_sat_kernel(const float* __restrict__ sat,
                                 const int* __restrict__ hs,
                                 const int* __restrict__ he,
                                 const int* __restrict__ ws,
                                 const int* __restrict__ we,
                                 float* __restrict__ out, int64_t total,
                                 int N, int H, int W, int k, int D) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ckk = k * k * D;
  const int c = (int)(i % ckk);          // channel (ph*k + pw)*D + d
  const int64_t bn = i / ckk;            // b*N + n
  const int64_t b = bn / N;
  const int bin = c / D;
  const int ph = bin / k;
  const int pw = bin % k;
  // bounds from roi_bounds lie in [0, H] x [0, W]; clamp anyway so a bad
  // bound can never read outside the table
  const int y0 = min(max(hs[bn * k + ph], 0), H);
  const int y1 = min(max(he[bn * k + ph], 0), H);
  const int x0 = min(max(ws[bn * k + pw], 0), W);
  const int x1 = min(max(we[bn * k + pw], 0), W);
  const int64_t row = (int64_t)(W + 1) * ckk;
  const float* s = sat + b * (H + 1) * row + c;
  const float s11 = __ldg(s + y1 * row + (int64_t)x1 * ckk);
  const float s01 = __ldg(s + y0 * row + (int64_t)x1 * ckk);
  const float s10 = __ldg(s + y1 * row + (int64_t)x0 * ckk);
  const float s00 = __ldg(s + y0 * row + (int64_t)x0 * ckk);
  if (kMean) {
    const float sum = __fadd_rn(__fsub_rn(__fsub_rn(s11, s01), s10), s00);
    const int area = max(y1 - y0, 0) * max(x1 - x0, 0);
    out[i] = area > 0 ? __fdiv_rn(sum, fmaxf((float)area, 1.f)) : 0.f;
  } else {
    out[i] = __fsub_rn(__fsub_rn(s11, s01), __fsub_rn(s10, s00));
  }
}

template <bool kMean>
int launch_sat(const void* sat, const void* hs, const void* he,
               const void* ws, const void* we, void* out, int B, int N,
               int H, int W, int k, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * N * k * k * D;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  psroi_sat_kernel<kMean><<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sat), static_cast<const int*>(hs),
      static_cast<const int*>(he), static_cast<const int*>(ws),
      static_cast<const int*>(we), static_cast<float*>(out), total, N, H, W,
      k, D);
  return (int)cudaGetLastError();
}

}  // namespace

// sat: (B, H+1, W+1, k*k*D) float32 contiguous; hs/he/ws/we: (B, N, k)
// int32; sums: (B, N, k, k, D) float32. Returns a cudaError_t (0 = launched).
extern "C" int dtt_psroi_sat(const void* sat, const void* hs, const void* he,
                             const void* ws, const void* we, void* sums,
                             int B, int N, int H, int W, int k, int D,
                             int device, void* stream) {
  return launch_sat<false>(sat, hs, he, ws, we, sums, B, N, H, W, k, D,
                           device, stream);
}

// The same arguments; means: (B, N, k, k, D) float32 bin means, 0 for empty
// bins. Returns a cudaError_t (0 = launched).
extern "C" int dtt_psroi_sat_mean(const void* sat, const void* hs,
                                  const void* he, const void* ws,
                                  const void* we, void* means, int B, int N,
                                  int H, int W, int k, int D, int device,
                                  void* stream) {
  return launch_sat<true>(sat, hs, he, ws, we, means, B, N, H, W, k, D,
                          device, stream);
}

// maps: (B, H, W, k*k*D) contiguous; hs/he/ws/we: (B, N, k) int32;
// sums: (B, N, k, k, D) float32. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = launched).
extern "C" int dtt_psroi_direct(const void* maps, const void* hs,
                                const void* he, const void* ws,
                                const void* we, void* sums, int B, int N,
                                int H, int W, int k, int D, int dtype,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(hs);
  const int* b = static_cast<const int*>(he);
  const int* c = static_cast<const int*>(ws);
  const int* d = static_cast<const int*>(we);
  float* out = static_cast<float*>(sums);
  if (dtype == 0)
    return launch<float>(maps, a, b, c, d, out, B, N, H, W, k, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(maps, a, b, c, d, out, B, N, H, W, k, D, s);
  return (int)cudaErrorInvalidValue;
}

// ghat: (B, N, k, k, D) float32 (g / area, 0 for empty bins);
// hs/he/ws/we: (B, N, k) int32; dmaps: (B, H, W, k*k*D) of `dtype`
// (0 = float32, 1 = bfloat16), every element written. N <= 4000.
// Returns a cudaError_t (0 = launched).
extern "C" int dtt_psroi_direct_bwd(const void* ghat, const void* hs,
                                    const void* he, const void* ws,
                                    const void* we, void* dmaps, int B, int N,
                                    int H, int W, int k, int D, int dtype,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ghat);
  const int* a = static_cast<const int*>(hs);
  const int* b = static_cast<const int*>(he);
  const int* c = static_cast<const int*>(ws);
  const int* d = static_cast<const int*>(we);
  if (dtype == 0)
    return launch_bwd<float>(g, a, b, c, d, dmaps, B, N, H, W, k, D, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, a, b, c, d, dmaps, B, N, H, W, k, D,
                                     s);
  return (int)cudaErrorInvalidValue;
}
