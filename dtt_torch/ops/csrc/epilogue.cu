// The trunk's conv epilogue for Hopper (sm_90a), plain C interface for
// ctypes: the frozen-BN affine, the ReLU and the residual add after a conv
// in one pass (dtt_conv_epilogue) and its backward (dtt_conv_epilogue_bwd).
//
// Replaces no Pallas kernel. dtt traces its trunk (dtt/models/resnet.py:33-45
// FrozenAffine, :101-119 Bottleneck, :181-185 the stem) into one jitted
// program, where XLA is free to fuse each conv's affine, ReLU and residual
// add into one pass over the activations. The port runs its convs eagerly,
// and each `*`, `+` and relu was its own pass; this kernel is that fusion,
// written by hand. With x the conv's output, z the block's shortcut, s, b,
// t, c the affines' float32 buffers rounded to the compute type T first and
// r() a rounding to T:
//
//   A  y = relu(r(r(x s) + b))                        stem bn1; bn1, bn2
//   B  y = relu(r(r(r(x s) + b) + z))                 bn3, identity shortcut
//   C  y = relu(r(r(r(x s) + b) + r(r(z t) + c)))     bn3 with downsample_bn
//
// and the backward, with m = (y <= 0) ? 0 : g (threshold_backward on the
// output, so a NaN output passes g): gx = r(m s); B: gz = m; C: gz = r(m t).
// The sum of a block input's two gradients is left to autograd.
//
// Bit-equal to PyTorch's eager ops on the card: each product and sum is
// taken in float32 by __fmul_rn / __fadd_rn (nvcc would otherwise contract
// x s + b into one FMA) and rounded once to T by __float2bfloat16_rn, as
// PyTorch's bf16 ops round their float32 result; relu is PyTorch's CUDA
// clamp_min(v, 0): a NaN returns v, anything else fmaxf(v, 0).
//
// Bound: memory. A call moves 2 (A) or 3 (B, C) tensors of the output's
// size S forward and 3 (A) or 4 (B, C) backward, each byte once, so it
// takes at least that many S over 3.35 TB/s; its at most 7 float32
// operations an element (< 2 a byte) are far below the card's rate. Design:
// a grid-stride loop in which a thread takes 16 bytes of every tensor a
// step (8 bf16 or 4 float32 channels of one position of the channels-last
// NHWC layout), so a warp's loads and stores are 512 contiguous bytes; a
// thread reads and rounds the per-channel buffers only when its channel
// group changes, which on a grid whose stride is a multiple of C/8 (every
// trunk call) is once; 8 blocks of 256 threads an SM keep enough 16-byte
// loads in flight for the memory rate. A channel count that is not a
// multiple of the vector width takes the same loop one element at a time
// (the tests' odd C; every C of the trunk is a multiple of 64).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
enum Form { kA = 0, kB = 1, kC = 2 };

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// PyTorch's CUDA relu (clamp_min(v, 0)) of a value already in T
template <typename T>
__device__ __forceinline__ T relu(float v) {
  return from_f<T>(isnan(v) ? v : fmaxf(v, 0.0f));
}

// The per-channel buffers of channel group `cg`, rounded to T.
template <typename T, int V, bool TWO>
__device__ __forceinline__ void load_params(const float* __restrict__ p,
                                            const float* __restrict__ q,
                                            int cg, float (&pr)[V],
                                            float (&qr)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    pr[k] = rnd<T>(__ldg(p + cg * V + k));
    if constexpr (TWO) qr[k] = rnd<T>(__ldg(q + cg * V + k));
  }
}

// n / V vectors of V elements, C / V channel groups a position.
template <typename T, int V, int FORM>
__global__ void __launch_bounds__(kThreads)
    epilogue_fwd(const T* __restrict__ x, const float* __restrict__ s,
                 const float* __restrict__ b, const T* __restrict__ z,
                 const float* __restrict__ t, const float* __restrict__ c,
                 T* __restrict__ y, int64_t nvec, int groups) {
  using P = Vec<T, V>;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nvec) return;
  const int step = (int)(stride % groups);
  int cg = (int)(i % groups), have = -1;
  float sr[V], br[V], tr[V], cr[V];
  for (; i < nvec; i += stride) {
    if (cg != have) {
      have = cg;
      load_params<T, V, true>(s, b, cg, sr, br);
      if constexpr (FORM == kC) load_params<T, V, true>(t, c, cg, tr, cr);
    }
    const P xv = reinterpret_cast<const P*>(x)[i];
    P zv, yv;
    if constexpr (FORM != kA) zv = reinterpret_cast<const P*>(z)[i];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(to_f(xv.v[k]), sr[k])),
                                 br[k]));
      if constexpr (FORM == kB) v = rnd<T>(__fadd_rn(v, to_f(zv.v[k])));
      if constexpr (FORM == kC)
        v = rnd<T>(__fadd_rn(
            v, rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(to_f(zv.v[k]), tr[k])),
                                cr[k]))));
      yv.v[k] = relu<T>(v);
    }
    reinterpret_cast<P*>(y)[i] = yv;
    cg += step;
    if (cg >= groups) cg -= groups;
  }
}

// gz null: the shortcut's gradient is not wanted (forms B and C).
template <typename T, int V, int FORM>
__global__ void __launch_bounds__(kThreads)
    epilogue_bwd(const T* __restrict__ g, const T* __restrict__ y,
                 const float* __restrict__ s, const float* __restrict__ t,
                 T* __restrict__ gx, T* __restrict__ gz, int64_t nvec,
                 int groups) {
  using P = Vec<T, V>;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nvec) return;
  const int step = (int)(stride % groups);
  int cg = (int)(i % groups), have = -1;
  float sr[V], tr[V];
  for (; i < nvec; i += stride) {
    if (cg != have) {
      have = cg;
      load_params<T, V, FORM == kC>(s, t, cg, sr, tr);
    }
    const P gv = reinterpret_cast<const P*>(g)[i];
    const P yv = reinterpret_cast<const P*>(y)[i];
    P xo, zo;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T m = to_f(yv.v[k]) <= 0.0f ? from_f<T>(0.0f) : gv.v[k];
      xo.v[k] = from_f<T>(__fmul_rn(to_f(m), sr[k]));
      if constexpr (FORM == kB) zo.v[k] = m;
      if constexpr (FORM == kC) zo.v[k] = from_f<T>(__fmul_rn(to_f(m), tr[k]));
    }
    reinterpret_cast<P*>(gx)[i] = xo;
    if constexpr (FORM != kA) {
      if (gz) reinterpret_cast<P*>(gz)[i] = zo;
    }
    cg += step;
    if (cg >= groups) cg -= groups;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, m = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess && m > 0)
      n = m;
    else
      return 1;
  }
  return n;
}

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int grid(int64_t nvec) {
  const int64_t want = (nvec + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sm_count() * kBlocksPerSm;
  return (int)(want < most ? want : most);
}

template <typename T, int V>
int launch_fwd(const void* x, const void* s, const void* b, const void* z,
               const void* t, const void* c, void* y, int64_t n, int C,
               int form, cudaStream_t stream) {
  const int64_t nvec = n / V;
  const int groups = C / V;
  auto* xp = static_cast<const T*>(x);
  auto* zp = static_cast<const T*>(z);
  auto* sp = static_cast<const float*>(s);
  auto* bp = static_cast<const float*>(b);
  auto* tp = static_cast<const float*>(t);
  auto* cp = static_cast<const float*>(c);
  auto* yp = static_cast<T*>(y);
  const int blocks = grid(nvec);
  if (form == kA)
    epilogue_fwd<T, V, kA><<<blocks, kThreads, 0, stream>>>(
        xp, sp, bp, zp, tp, cp, yp, nvec, groups);
  else if (form == kB)
    epilogue_fwd<T, V, kB><<<blocks, kThreads, 0, stream>>>(
        xp, sp, bp, zp, tp, cp, yp, nvec, groups);
  else
    epilogue_fwd<T, V, kC><<<blocks, kThreads, 0, stream>>>(
        xp, sp, bp, zp, tp, cp, yp, nvec, groups);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* g, const void* y, const void* s, const void* t,
               void* gx, void* gz, int64_t n, int C, int form,
               cudaStream_t stream) {
  const int64_t nvec = n / V;
  const int groups = C / V;
  auto* gp = static_cast<const T*>(g);
  auto* yp = static_cast<const T*>(y);
  auto* sp = static_cast<const float*>(s);
  auto* tp = static_cast<const float*>(t);
  auto* gxp = static_cast<T*>(gx);
  auto* gzp = static_cast<T*>(gz);
  const int blocks = grid(nvec);
  if (form == kA)
    epilogue_bwd<T, V, kA><<<blocks, kThreads, 0, stream>>>(
        gp, yp, sp, tp, gxp, gzp, nvec, groups);
  else if (form == kB)
    epilogue_bwd<T, V, kB><<<blocks, kThreads, 0, stream>>>(
        gp, yp, sp, tp, gxp, gzp, nvec, groups);
  else
    epilogue_bwd<T, V, kC><<<blocks, kThreads, 0, stream>>>(
        gp, yp, sp, tp, gxp, gzp, nvec, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// x, z, y: (N, C, H, W) channels-last, n = N*C*H*W elements, in float32
// (bf16 = 0) or bfloat16 (bf16 = 1), 16-byte aligned; s, b, t, c: (C,)
// float32. form 0 (A) takes x, s, b; 1 (B) also z; 2 (C) also z, t, c.
// Returns a cudaError_t (0 = launched).
extern "C" int dtt_conv_epilogue(const void* x, const void* s, const void* b,
                                 const void* z, const void* t, const void* c,
                                 void* y, int64_t n, int C, int form,
                                 int bf16, int device, void* stream) {
  if (n < 1 || C < 1 || n % C || form < kA || form > kC || !x || !s || !b ||
      !y || (form != kA && !z) || (form == kC && (!t || !c)) ||
      !aligned(x) || !aligned(z) || !aligned(y))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return C % 8 ? launch_fwd<__nv_bfloat16, 1>(x, s, b, z, t, c, y, n, C,
                                                form, st)
                 : launch_fwd<__nv_bfloat16, 8>(x, s, b, z, t, c, y, n, C,
                                                form, st);
  return C % 4 ? launch_fwd<float, 1>(x, s, b, z, t, c, y, n, C, form, st)
               : launch_fwd<float, 4>(x, s, b, z, t, c, y, n, C, form, st);
}

// g, y, gx, gz: like x; s, t: like s, t above (t for form C only); gz
// null or, for forms B and C, the shortcut's gradient. Returns a cudaError_t (0 = launched).
extern "C" int dtt_conv_epilogue_bwd(const void* g, const void* y,
                                     const void* s, const void* t, void* gx,
                                     void* gz, int64_t n, int C, int form,
                                     int bf16, int device, void* stream) {
  if (n < 1 || C < 1 || n % C || form < kA || form > kC || !g || !y || !s ||
      !gx || (form == kA && gz) || (form == kC && !t) ||
      !aligned(g) || !aligned(y) || !aligned(gx) || !aligned(gz))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return C % 8 ? launch_bwd<__nv_bfloat16, 1>(g, y, s, t, gx, gz, n, C,
                                                form, st)
                 : launch_bwd<__nv_bfloat16, 8>(g, y, s, t, gx, gz, n, C,
                                                form, st);
  return C % 4 ? launch_bwd<float, 1>(g, y, s, t, gx, gz, n, C, form, st)
               : launch_bwd<float, 4>(g, y, s, t, gx, gz, n, C, form, st);
}
