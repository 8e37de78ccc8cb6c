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
// operations an element (< 2 a byte) are far below the card's rate. The
// trunk's tensors are 2.6-360 MB a call, so the kernel has to keep enough
// bytes in flight to stay at the memory rate between one step's load and
// the next. Design, over the flat channels-last NHWC tensors: a thread
// issues kUnroll independent 16-byte streaming loads (ld.global.cs) of each
// input before any arithmetic, its first ones before the per-channel
// buffers are staged, then computes and stores them, at kMinBlocks blocks
// an SM (launch bounds: at most 64 registers a thread). The buffers are
// staged once a block in shared memory, already rounded to T, so an
// element's channel is its index mod C (a mask at powers of two). A block
// takes one chunk of kThreads * kUnroll vectors, or as many chunks,
// grid-strided, as keep the buffers' staging under a quarter of the
// inputs' bytes (2 to 8 at C = 512 to 2,048), so the grid is as large as
// the tensor and the hardware keeps every SM full of blocks. In bf16 a
// vector's elements go in pairs: each rounding of a pair is one
// cvt.rn.bf16x2.f32, and the relu's output, which bf16 holds exactly, is
// packed without a conversion (the same bits as one __float2bfloat16_rn an
// element).
//
// Dropped: a ring of bulk copies (persistent blocks, one lane of a copy
// warp issuing 1-D TMA copies, cp.async.bulk, of 8 KB tiles of each input
// into 4 stages in shared memory on full / empty mbarriers) kept many KB in
// flight without registers, but lost to this design at every path's trunk
// calls by more than the runs' spread. Device ms of one trunk call's calls
// in bf16 on one H100 at 700 W (tools/epilogue_device_torch.py while this
// source still held the ring; PERF.md), ring against this design: 17
// frames 6.94 / 6.56 (bound 5.60), 16 frames 6.51-6.53 / 6.19 (5.27), their
// backward 6.23-6.36 / 6.08 (5.31), 8 frames 3.37 / 3.26 (2.64); one frame
// 0.63 / 0.59 (0.33).
//
// A channel count that is not a multiple of the 16-byte vector, or whose
// buffers do not fit kParamBytes, takes a grid-stride loop one element at
// a time that reads the buffers from global memory (the tests' odd C;
// every C of the trunk is 64 * 2^k).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // threads a block
constexpr int kMaxBlocksPerSm = 8;         // the scalar loop's, 2,048 threads
constexpr int kUnroll = 2;                 // 16-byte loads a thread in flight
constexpr int kMinBlocks = 4;              // blocks an SM
constexpr int kParamBytes = 32768;         // buffers in shared memory, most
constexpr int kMaxDevices = 64;
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

// One output element of form FORM from x, z and the buffers (in T).
template <typename T, int FORM>
__device__ __forceinline__ T fwd_one(T x, T z, float s, float b, float t,
                                     float c) {
  float v = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(to_f(x), s)), b));
  if constexpr (FORM == kB) v = rnd<T>(__fadd_rn(v, to_f(z)));
  if constexpr (FORM == kC)
    v = rnd<T>(__fadd_rn(
        v, rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(to_f(z), t)), c))));
  return relu<T>(v);
}

// One element's (gx, gz) from g, y and the buffers (in T).
template <typename T, int FORM>
__device__ __forceinline__ void bwd_one(T g, T y, float s, float t, T& gx,
                                        T& gz) {
  const T m = to_f(y) <= 0.0f ? from_f<T>(0.0f) : g;
  gx = from_f<T>(__fmul_rn(to_f(m), s));
  if constexpr (FORM == kB) gz = m;
  if constexpr (FORM == kC) gz = from_f<T>(__fmul_rn(to_f(m), t));
}

// ---------------------------------------------------------------------------
// The vector loop: V elements (16 bytes) a step, the buffers in shared
// memory as kBufs arrays of C values of T.

template <int FORM, bool BWD>
struct Shape {
  static constexpr int kIn = BWD || FORM != kA ? 2 : 1;   // input tensors
  static constexpr int kBufs = BWD ? (FORM == kC ? 2 : 1)
                                   : (FORM == kC ? 4 : 2);
};

// Every thread: the buffers rounded to T into shared memory.
template <typename T, int NB>
__device__ __forceinline__ void stage_bufs(T* dst,
                                           const float* const* src, int C) {
#pragma unroll
  for (int k = 0; k < NB; ++k)
    for (int i = threadIdx.x; i < C; i += kThreads)
      dst[k * C + i] = from_f<T>(__ldg(src[k] + i));
}

// The V elements of buffer k at channel ch (a multiple of V), as floats.
template <typename T, int V>
__device__ __forceinline__ void buf_vec(const T* bufs, int k, int C,
                                        int ch, float (&out)[V]) {
  const Vec<T, V> p =
      *reinterpret_cast<const Vec<T, V>*>(bufs + k * C + ch);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(p.v[j]);
}

// (a, b) each rounded to bf16, as floats, by one conversion
// (cvt.rn.bf16x2.f32: each half as __float2bfloat16_rn rounds it).
__device__ __forceinline__ void rnd2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const unsigned u = *reinterpret_cast<const unsigned*>(&h);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

// Two floats that bf16 holds exactly (so no rounding), as a bf16 pair.
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ float relu_f(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// The forward of one vector at channel ch: y from x (and z). In bf16 the
// elements go in pairs, each rounding of a pair one conversion, and the
// relu's output, which bf16 holds exactly, is packed without one: the
// same bits as fwd_one's.
template <typename T, int V, int FORM>
__device__ __forceinline__ Vec<T, V> fwd_vec(const Vec<T, V>& xv,
                                             const Vec<T, V>& zv,
                                             const T* bufs, int C,
                                             int ch) {
  float s[V], b[V], t[V], c[V];
  buf_vec<T, V>(bufs, 0, C, ch, s);
  buf_vec<T, V>(bufs, 1, C, ch, b);
  if constexpr (FORM == kC) {
    buf_vec<T, V>(bufs, 2, C, ch, t);
    buf_vec<T, V>(bufs, 3, C, ch, c);
  }
  Vec<T, V> yv;
  if constexpr (sizeof(T) == 2) {
    unsigned* out = reinterpret_cast<unsigned*>(&yv);
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      float v0 = __fmul_rn(to_f(xv.v[j]), s[j]);
      float v1 = __fmul_rn(to_f(xv.v[j + 1]), s[j + 1]);
      rnd2(v0, v1);
      v0 = __fadd_rn(v0, b[j]);
      v1 = __fadd_rn(v1, b[j + 1]);
      rnd2(v0, v1);
      if constexpr (FORM == kB) {
        v0 = __fadd_rn(v0, to_f(zv.v[j]));
        v1 = __fadd_rn(v1, to_f(zv.v[j + 1]));
        rnd2(v0, v1);
      }
      if constexpr (FORM == kC) {
        float w0 = __fmul_rn(to_f(zv.v[j]), t[j]);
        float w1 = __fmul_rn(to_f(zv.v[j + 1]), t[j + 1]);
        rnd2(w0, w1);
        w0 = __fadd_rn(w0, c[j]);
        w1 = __fadd_rn(w1, c[j + 1]);
        rnd2(w0, w1);
        v0 = __fadd_rn(v0, w0);
        v1 = __fadd_rn(v1, w1);
        rnd2(v0, v1);
      }
      out[j / 2] = pack2(relu_f(v0), relu_f(v1));
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      yv.v[j] = fwd_one<T, FORM>(xv.v[j], FORM == kA ? xv.v[j] : zv.v[j],
                                 s[j], b[j], FORM == kC ? t[j] : 0.f,
                                 FORM == kC ? c[j] : 0.f);
  }
  return yv;
}

// The backward of one vector at channel ch: gx (and gz) from g and y; in
// bf16 a pair's products rounded by one conversion.
template <typename T, int V, int FORM>
__device__ __forceinline__ void bwd_vec(const Vec<T, V>& gv,
                                        const Vec<T, V>& yv,
                                        const T* bufs, int C, int ch,
                                        Vec<T, V>& xo,
                                        Vec<T, V>& zo) {
  float s[V], t[V];
  buf_vec<T, V>(bufs, 0, C, ch, s);
  if constexpr (FORM == kC) buf_vec<T, V>(bufs, 1, C, ch, t);
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(&xo);
    __nv_bfloat162* zp = reinterpret_cast<__nv_bfloat162*>(&zo);
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const T m0 = to_f(yv.v[j]) <= 0.0f ? from_f<T>(0.0f) : gv.v[j];
      const T m1 = to_f(yv.v[j + 1]) <= 0.0f ? from_f<T>(0.0f) : gv.v[j + 1];
      xp[j / 2] = __floats2bfloat162_rn(__fmul_rn(to_f(m0), s[j]),
                                        __fmul_rn(to_f(m1), s[j + 1]));
      if constexpr (FORM == kB) {
        zo.v[j] = m0;
        zo.v[j + 1] = m1;
      }
      if constexpr (FORM == kC)
        zp[j / 2] = __floats2bfloat162_rn(__fmul_rn(to_f(m0), t[j]),
                                          __fmul_rn(to_f(m1), t[j + 1]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      bwd_one<T, FORM>(gv.v[j], yv.v[j], s[j], FORM == kC ? t[j] : 0.f,
                       xo.v[j], zo.v[j]);
  }
}

// The pointers of a call: in[0..1] the inputs (x, z forward; g, y
// backward), out[0..1] the outputs (y forward; gx, gz backward, gz null
// where not wanted), bufs the float32 buffers (s, b, t, c forward; s, t
// backward).
struct Args {
  const void* in[2];
  void* out[2];
  const float* bufs[4];
  int64_t n;                     // elements of each tensor
  int C;
};

// A vector's channel: its first element's index mod C (a mask where C
// is a power of two, as every C of the trunk is).
__device__ __forceinline__ int channel(int64_t e, int C, bool pow2,
                                       bool narrow) {
  if (pow2) return (int)(e & (C - 1));
  return narrow ? (int)((unsigned)e % (unsigned)C) : (int)(e % C);
}

template <typename T, int V, int FORM, bool BWD>
__device__ __forceinline__ void vec_step(const Args& a, const T* bufs,
                                         int64_t i, int ch,
                                         const Vec<T, V>& i0,
                                         const Vec<T, V>& i1) {
  using P = Vec<T, V>;
  if constexpr (BWD) {
    P xo, zo;
    bwd_vec<T, V, FORM>(i0, i1, bufs, a.C, ch, xo, zo);
    reinterpret_cast<P*>(a.out[0])[i] = xo;
    if constexpr (FORM != kA) {
      if (a.out[1]) reinterpret_cast<P*>(a.out[1])[i] = zo;
    }
  } else {
    reinterpret_cast<P*>(a.out[0])[i] = fwd_vec<T, V, FORM>(i0, i1, bufs,
                                                            a.C, ch);
  }
}

template <typename P>
__device__ __forceinline__ P load_stream(const void* base, int64_t i) {
  static_assert(sizeof(P) == 16, "a 16-byte vector");
  const uint4 r = __ldcs(reinterpret_cast<const uint4*>(base) + i);
  return *reinterpret_cast<const P*>(&r);
}

// The vector loop (the note at the top). A thread's first loads go out
// before the buffers are staged.
template <typename T, int V, int FORM, bool BWD>
__device__ __forceinline__ void vec_body(const Args& a) {
  using S = Shape<FORM, BWD>;
  using P = Vec<T, V>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  const int64_t nvec = a.n / V;
  const bool narrow = a.n <= (int64_t)UINT32_MAX;
  const bool pow2 = (a.C & (a.C - 1)) == 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads * kUnroll;
  P v0[kUnroll], v1[kUnroll];
  auto load = [&](int64_t i0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < nvec) {
        v0[u] = load_stream<P>(a.in[0], i);
        if constexpr (S::kIn == 2) v1[u] = load_stream<P>(a.in[1], i);
      }
    }
  };
  int64_t i0 = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  load(i0);
  stage_bufs<T, S::kBufs>(bufs, a.bufs, a.C);
  __syncthreads();
  for (; i0 < nvec; i0 += stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < nvec)
        vec_step<T, V, FORM, BWD>(a, bufs, i,
                                  channel(i * V, a.C, pow2, narrow),
                                  v0[u], S::kIn == 2 ? v1[u] : v0[u]);
    }
    if (i0 + stride < nvec) load(i0 + stride);
  }
}

// ---------------------------------------------------------------------------
// One element a step, the buffers read from global memory: any C.

template <typename T, int FORM, bool BWD>
__device__ __forceinline__ void scalar_body(const Args& a) {
  const T* in0 = static_cast<const T*>(a.in[0]);
  const T* in1 = static_cast<const T*>(a.in[1]);
  T* out0 = static_cast<T*>(a.out[0]);
  T* out1 = static_cast<T*>(a.out[1]);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += stride) {
    const int ch = (int)(i % a.C);
    auto buf = [&](int k) { return rnd<T>(__ldg(a.bufs[k] + ch)); };
    if constexpr (BWD) {
      T gx, gz;
      bwd_one<T, FORM>(in0[i], in1[i], buf(0), FORM == kC ? buf(1) : 0.f,
                       gx, gz);
      out0[i] = gx;
      if (FORM != kA && out1) out1[i] = gz;
    } else {
      out0[i] = fwd_one<T, FORM>(in0[i], FORM == kA ? in0[i] : in1[i],
                                 buf(0), buf(1), FORM == kC ? buf(2) : 0.f,
                                 FORM == kC ? buf(3) : 0.f);
    }
  }
}

// The kernels, by direction and loop (their names tell the profiler's
// lines apart).
template <typename T, int V, int FORM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    epilogue_fwd_vec(const Args a) {
  vec_body<T, V, FORM, false>(a);
}
template <typename T, int V, int FORM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    epilogue_bwd_vec(const Args a) {
  vec_body<T, V, FORM, true>(a);
}
template <typename T, int FORM>
__global__ void __launch_bounds__(kThreads)
    epilogue_fwd_scalar(const Args a) {
  scalar_body<T, FORM, false>(a);
}
template <typename T, int FORM>
__global__ void __launch_bounds__(kThreads)
    epilogue_bwd_scalar(const Args a) {
  scalar_body<T, FORM, true>(a);
}

// ---------------------------------------------------------------------------
// Launch.

int sm_count(int dev) {
  static int n[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return 1;
  if (n[dev] == 0) {
    int m = 0;
    if (cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || m < 1)
      return 1;
    n[dev] = m;
  }
  return n[dev];
}

template <typename T, int V, int FORM, bool BWD>
int launch_vec(const Args& a, cudaStream_t stream) {
  using S = Shape<FORM, BWD>;
  void (*kernel)(const Args);
  if constexpr (BWD)
    kernel = epilogue_bwd_vec<T, V, FORM>;
  else
    kernel = epilogue_fwd_vec<T, V, FORM>;
  // as many chunks a block as keep the buffers' staging (read from L2)
  // under a quarter of the inputs' bytes
  const int64_t work = (a.n / V + kThreads * kUnroll - 1) /
                       (kThreads * kUnroll);
  const int64_t chunk = (int64_t)kThreads * kUnroll * 16 * S::kIn;
  const int64_t iters = (4 * S::kBufs * (int64_t)a.C * 4 + chunk - 1) / chunk;
  kernel<<<(int)((work + iters - 1) / iters), kThreads,
           S::kBufs * a.C * (int)sizeof(T), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int FORM, bool BWD>
int launch_scalar(const Args& a, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (a.n + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sm_count(dev) * kMaxBlocksPerSm;
  void (*kernel)(const Args);
  if constexpr (BWD)
    kernel = epilogue_bwd_scalar<T, FORM>;
  else
    kernel = epilogue_fwd_scalar<T, FORM>;
  kernel<<<(int)(want < most ? want : most), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int FORM, bool BWD>
int launch_form(const Args& a, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  using S = Shape<FORM, BWD>;
  if (a.C % V == 0 &&
      (int64_t)S::kBufs * a.C * (int64_t)sizeof(T) <= kParamBytes)
    return launch_vec<T, V, FORM, BWD>(a, stream);
  return launch_scalar<T, FORM, BWD>(a, stream);
}

template <typename T, bool BWD>
int launch(const Args& a, int form, cudaStream_t stream) {
  if (form == kA) return launch_form<T, kA, BWD>(a, stream);
  if (form == kB) return launch_form<T, kB, BWD>(a, stream);
  return launch_form<T, kC, BWD>(a, stream);
}

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// code: the form (0 A, 1 B, 2 C) in bits 0-1, 1 in bit 2 for bfloat16
// (else float32).
bool decode(int code, int& form, bool& bf16) {
  form = code & 3;
  bf16 = (code >> 2) & 1;
  return form <= kC && (code >> 3) == 0;
}

}  // namespace

// x, z, y: (N, C, H, W) channels-last, n = N*C*H*W elements, 16-byte
// aligned, in the current device's memory; s, b, t, c: (C,) float32. Form A
// takes x, s, b; B also z; C also z, t, c (`code` above). Launches on
// `stream` of the current device. Returns a cudaError_t (0 = launched).
extern "C" int dtt_conv_epilogue(const void* x, const void* z, void* y,
                                 const void* s, const void* b, const void* t,
                                 const void* c, int64_t n, int C, int code,
                                 void* stream) {
  int form;
  bool bf16;
  if (!decode(code, form, bf16) || n < 1 || C < 1 || n % C || !x ||
      !s || !b || !y || (form != kA && !z) || (form == kC && (!t || !c)) ||
      !aligned(x) || !aligned(z) || !aligned(y))
    return (int)cudaErrorInvalidValue;
  const Args a{{x, z},
               {y, nullptr},
               {static_cast<const float*>(s), static_cast<const float*>(b),
                static_cast<const float*>(t), static_cast<const float*>(c)},
               n,
               C};
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, false>(a, form, st)
              : launch<float, false>(a, form, st);
}

// g, y, gx, gz: like x; s, t: like s, t above (t for form C only); gz null
// or, for forms B and C, the shortcut's gradient. Returns a cudaError_t (0 =
// launched).
extern "C" int dtt_conv_epilogue_bwd(const void* g, const void* y, void* gx,
                                     void* gz, const void* s, const void* t,
                                     int64_t n, int C, int code,
                                     void* stream) {
  int form;
  bool bf16;
  if (!decode(code, form, bf16) || n < 1 || C < 1 || n % C || !g ||
      !y || !s || !gx || (form == kA && gz) || (form == kC && !t) ||
      !aligned(g) || !aligned(y) || !aligned(gx) || !aligned(gz))
    return (int)cudaErrorInvalidValue;
  const Args a{{g, y},
               {gx, gz},
               {static_cast<const float*>(s), static_cast<const float*>(t),
                nullptr, nullptr},
               n,
               C};
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(a, form, st)
              : launch<float, true>(a, form, st);
}
