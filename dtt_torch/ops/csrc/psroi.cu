// Position-sensitive RoI pooling for Hopper (sm_90a), plain C interface for
// ctypes: the direct bin sums and their backward, and the bin sums and bin
// means off a summed-area table (dtt_psroi_sat, dtt_psroi_sat_mean, below).
//
// Forward (dtt_psroi_direct). Replaces the TPU kernel _psroi_direct_kernel
// (dtt/ops/psroi.py:382), which contracted 0/1 row and column interval
// indicators against each (frame, bin) slab on the MXU. Here each sum is
// read off the NHWC map directly:
//
//   sums[b, n, ph, pw, d] = sum_{hs <= y < he} sum_{ws <= x < we}
//                           M[b, y, x, (ph*k + pw)*D + d]
//
// with integer bounds (B, N, k) made outside the kernel, accumulated and
// written in f32; the wrapper divides by the area and zeroes empty bins.
//
// Bound: a bin holds ~1-35 pixels (8 on average at the video path's
// RoIs), so the work is many short sums of a D-channel run per pixel; the
// card's memory rate bounds the distinct 32-byte sectors the bins touch.
// What kept the first kernel (one thread per output) from that rate was
// instruction throughput and latency: each thread did three 64-bit and
// four 32-bit divisions and then waited on one 2-byte load at a time.
// Design: one thread per V channels of one bin (V up to 16 bytes where D
// and the map allow: D = 8 in bf16 is one 16-byte load a pixel, D = 4 one
// 8-byte load; odd D reads 2-byte scalars, a warp's 32 channels of a pixel
// still one coalesced run), in the order (frame, RoI, bin, channels), so
// the threads in flight read neighbouring bins of one frame (in L2). The
// divisions by k*k*D/V, D/V, k and N are a multiply and a shift each; the
// bin's pixels are walked in row order by adds alone; a thread starts 8
// loads (4 vectors of 8 or 16 bytes) before it adds them in pixel order,
// and only the last batch of a bin checks its end, so a bin of up to 8
// pixels costs one round trip to memory. A warp whose 32 channel vectors
// straddle two bins (D = 43) runs the longer bin's loop; the bins of one
// row differ by at most a column, and a bin-per-warp layout measured
// slower, since its idle lanes cost more than the straddle.
//
// Backward (dtt_psroi_direct_bwd). Replaces the TPU kernel
// _psroi_direct_bwd_kernel (dtt/ops/psroi.py:479), which expanded ghat
// along x with a 0/1 selection matmul, masked it with the column indicator
// and contracted the RoI axis against the row indicator on the MXU. Here,
// per output element,
//
//   dmaps[b, y, x, (ph*k + pw)*D + d] = sum_n 1[hs <= y < he] 1[ws <= x < we]
//                                       * ghat[b, n, ph, pw, d]
//
// with ghat = g / area (0 for empty bins) made outside the kernel, summed in
// f32 in RoI order and written in the maps' dtype; every element is
// written, zeros included.
//
// Bound: each output is written once and ghat read once, so the memory rate
// bounds it, but only if the few RoIs that touch an output are found
// cheaply and the index work per output stays small: one bin row of one
// output row holds ~20 of 330 RoIs, and one RoI's bin only a few of its
// columns. Design: one block per (frame, output row y, tile of columns,
// bin row ph) owns the kD = k*D channels of that bin row at each of its
// pixels. Per chunk of 256 RoIs all warps list, in RoI order (ballot plus
// a block prefix sum), the RoIs whose bin row ph holds y, each listing
// thread also storing its RoI's k bin columns clipped to the tile. Each
// thread owns one channel c of the row (and, where kD is small, a segment
// of the tile's columns), so every thread has work whatever D is: it walks
// the list, loads ghat[n, ph, c] only for the RoIs whose bin column meets
// its columns (eight loads in flight) and adds it over those columns of an
// f32 tile in shared memory. Each element is summed by one thread in RoI
// order, with no atomics, so the result does not depend on the order
// blocks run in. Then a warp per pixel rounds the pixel's run of kD
// outputs to the maps' dtype and writes it with 16-byte stores where whole
// aligned 16 bytes of the run lie, scalar stores at its two ends. RoIs are
// taken in chunks, so N has no limit; the tile holds at least one pixel's
// kD channels in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Lets `kernel` take `bytes` (> 48 KB) of dynamic shared memory.
template <typename K>
int allow_smem(K* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The current device's SM count.
int sm_count() {
  int dev = 0, n = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// --- forward ---

// bf16 pairs of a 32-bit word as f32 (exact)
__device__ __forceinline__ void unpack2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// V consecutive channels at p (aligned to V elements) as f32, one load
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(t.x, v); unpack2(t.y, v + 2); unpack2(t.z, v + 4);
    unpack2(t.w, v + 6);
  } else if constexpr (V == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(t.x, v); unpack2(t.y, v + 2);
  } else if constexpr (V == 2) {
    unpack2(__ldg(reinterpret_cast<const unsigned int*>(p)), v);
  } else {
    v[0] = __uint_as_float(
        (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Division of 0 <= n < 2^31 by a divisor fixed at launch, as a multiply
// and a shift (Granlund and Montgomery): q = (umulhi(n, m) + n) >> l.
struct Div {
  uint32_t m;
  int l;
};

Div make_div(int d) {
  int l = 0;
  while ((1u << l) < (uint32_t)d) ++l;
  const uint64_t m = (((uint64_t)1 << 32) * (((uint64_t)1 << l) - d)) / d + 1;
  return {(uint32_t)m, l};
}

__device__ __forceinline__ int operator/(int n, Div d) {
  return (int)(((uint64_t)__umulhi((uint32_t)n, d.m) + (uint32_t)n) >> d.l);
}

// A thread's place in its bin's pixels, walked in row order: one column
// on, or back to x0 one row down. Offsets are unsigned, so the walk past
// the last pixel may wrap without a load.
struct Walk {
  int x, x1, x0;
  uint32_t off, step, wrap;
  __device__ __forceinline__ void next() {
    off += step;
    if (++x == x1) { x = x0; off += wrap; }
  }
};

// Adds U pixels of the walk (the first `left` of them where kTail) to acc:
// all U loads are in flight before the first add, and the adds run in pixel
// order.
template <int U, int V, bool kTail, typename T>
__device__ __forceinline__ void add_pixels(const T* p, int left, Walk& w,
                                           float (&acc)[V]) {
  float v[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!kTail || u < left) {
      load_vec<V>(p + w.off, v[u]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[u][e] = 0.f;
    }
    w.next();
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += v[u][e];
}

// One thread per V channels of one bin: thread i is the (frame*N + RoI,
// bin, channel vector) of i in that order, so a warp reads 32 consecutive
// vectors of a pixel, the runs of one bin or of two neighbours.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
psroi_direct_kernel(const T* __restrict__ maps, const int* __restrict__ hs,
                    const int* __restrict__ he, const int* __restrict__ ws,
                    const int* __restrict__ we, float* __restrict__ sums,
                    int total, Div per_roi, Div per_bin, Div per_row,
                    Div per_frame, int H, int W, int k, int D) {
  constexpr int U = V >= 4 ? 4 : 8;          // loads a thread at a time
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int nv = D / V, C = k * k * D;
  const int bn = i / per_roi, r = i - bn * (k * k * nv);
  const int bin = r / per_bin, c = (r - bin * nv) * V;
  const int ph = bin / per_row, pw = bin - ph * k;
  const int64_t rb = (int64_t)bn * k;
  // bounds from roi_bounds lie in [0, H] x [0, W]; clamp anyway so a bad
  // bound can never read outside the map
  const int y0 = min(max(__ldg(hs + rb + ph), 0), H);
  const int y1 = min(max(__ldg(he + rb + ph), 0), H);
  const int x0 = min(max(__ldg(ws + rb + pw), 0), W);
  const int x1 = min(max(__ldg(we + rb + pw), 0), W);
  const int bw = max(x1 - x0, 0);
  const int area = bw * max(y1 - y0, 0);
  const T* p = maps + (int64_t)(bn / per_frame) * H * W * C + bin * D + c;
  Walk w{x0, x1, x0, (uint32_t)(y0 * W + x0) * C, (uint32_t)C,
         (uint32_t)(W - bw) * C};
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  int j = 0;
  for (; j + U <= area; j += U) add_pixels<U, V, false>(p, U, w, acc);
  if (j < area) add_pixels<U, V, true>(p, area - j, w, acc);
  store_vec<V>(sums + (int64_t)i * V, acc);
}

// Channels a thread reads with one load: the widest of 16 bytes, 8, 4 (or
// one element) that divides D and to which the map and the sums are
// aligned, so every pixel's run of a bin starts aligned.
template <typename T>
int vec_width(const void* maps, const void* sums, int D) {
  for (int v = 16 / (int)sizeof(T); v > 1; v >>= 1)
    if (D % v == 0 && (uintptr_t)maps % (v * sizeof(T)) == 0
        && (uintptr_t)sums % (v * sizeof(float)) == 0)
      return v;
  return 1;
}

template <typename T, int V>
int launch_fwd(const void* maps, const int* hs, const int* he, const int* ws,
               const int* we, float* sums, int64_t nbins, int N, int H,
               int W, int k, int D, cudaStream_t stream) {
  const int64_t total = nbins * (D / V);
  psroi_direct_kernel<T, V><<<(unsigned)((total + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(
      static_cast<const T*>(maps), hs, he, ws, we, sums, (int)total,
      make_div(k * k * (D / V)), make_div(D / V), make_div(k), make_div(N), H,
      W, k, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* maps, const int* hs, const int* he, const int* ws,
           const int* we, float* sums, int B, int N, int H, int W, int k,
           int D, cudaStream_t stream) {
  const int64_t nbins = (int64_t)B * N * k * k;
  if (k < 1 || D < 1 || N < 0 || nbins * D >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (nbins == 0) return (int)cudaSuccess;
  switch (vec_width<T>(maps, sums, D)) {
    case 8: return launch_fwd<T, sizeof(T) == 2 ? 8 : 1>(
                maps, hs, he, ws, we, sums, nbins, N, H, W, k, D, stream);
    case 4: return launch_fwd<T, 4>(maps, hs, he, ws, we, sums, nbins, N, H,
                                    W, k, D, stream);
    case 2: return launch_fwd<T, 2>(maps, hs, he, ws, we, sums, nbins, N, H,
                                    W, k, D, stream);
    default: return launch_fwd<T, 1>(maps, hs, he, ws, we, sums, nbins, N, H,
                                     W, k, D, stream);
  }
}

// --- backward ---

constexpr int kRoiChunk = kThreads;  // RoIs listed per pass: one a thread
constexpr int kTileFloats = 8192;    // the f32 tile: 32 KB, at least 1 pixel
constexpr int kLoads = 8;            // ghat loads a thread keeps in flight

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of one block of tx pixels: the f32 tile (tx x kD), the
// warps' counts and a chunk's RoI list (index and k packed bin columns).
size_t bwd_smem(int tx, int kD, int k) {
  return round16((size_t)tx * kD * 4)
         + 4 * (kThreads / 32 + (size_t)kRoiChunk * (1 + k));
}

// 16 bytes of T from 16 / sizeof(T) floats, rounded to nearest even
__device__ __forceinline__ uint4 pack16(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 pack16(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Block: columns [tx0, tx0 + tx) of output row y, bin row ph of frame b
// (blockIdx.z = b * k + ph): per pixel the kD channels of that bin row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
psroi_direct_bwd_kernel(const float* __restrict__ ghat,
                        const int* __restrict__ hs,
                        const int* __restrict__ he,
                        const int* __restrict__ ws,
                        const int* __restrict__ we,
                        T* __restrict__ dmaps, int N, int H, int W, int k,
                        int D, int tx) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  constexpr int E = 16 / sizeof(T);                  // elements in 16 bytes
  const int kD = k * D, C = k * kD;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int b = blockIdx.z / k, ph = blockIdx.z - b * k, y = blockIdx.y;
  const int tx0 = blockIdx.x * tx, nx = min(tx, W - tx0), tx1 = tx0 + nx;
  float* tile = reinterpret_cast<float*>(smem_raw);  // [nx][kD]
  int* s_warp = reinterpret_cast<int*>(smem_raw + round16((size_t)tx * kD * 4));
  int* s_n = s_warp + kThreads / 32;                 // listed RoIs
  int* s_col = s_n + kRoiChunk;                      // [entry][pw] x0 | x1 << 16
  for (int i = tid; i < nx * kD; i += nthreads) tile[i] = 0.f;

  // threads: (channel c of the bin row, column segment s); S segments
  // where kD < nthreads
  const int S = max(1, nthreads / kD);
  const int seg = (nx + S - 1) / S;
  const int64_t bn0 = (int64_t)b * N;
  for (int n0 = 0; n0 < N; n0 += kRoiChunk) {
    // 1. list the chunk's RoIs whose bin row ph holds y, in RoI order, with
    // their k bin columns clipped to the tile, in tile coordinates
    const int n = n0 + tid;
    bool hit = false;
    if (n < N) {
      const int64_t r = (bn0 + n) * k + ph;
      hit = __ldg(hs + r) <= y && y < __ldg(he + r);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u)), count = 0;
    for (int w2 = 0; w2 < nwarps; ++w2) {
      if (w2 < warp) pos += s_warp[w2];
      count += s_warp[w2];
    }
    if (hit) {
      s_n[pos] = n;
      const int64_t r = (bn0 + n) * k;
      for (int pw = 0; pw < k; ++pw) {
        const int a = max(__ldg(ws + r + pw), tx0);
        const int z = min(__ldg(we + r + pw), tx1);
        s_col[pos * k + pw] = a < z ? (a - tx0) | ((z - tx0) << 16) : 0;
      }
    }
    __syncthreads();
    // 2. each (c, s) adds ghat[n, ph, c] over its columns of each listed
    // RoI's bin that meets them, in list order, kLoads loads in flight
    for (int t = tid; t < kD * S; t += nthreads) {
      const int c = t % kD, s = t / kD;
      const int lo = s * seg, hi = min(nx, lo + seg);
      const int pw = c / D;
      const float* g = ghat + bn0 * C + ph * kD + c;
      for (int j = 0; j < count; j += kLoads) {
        float v[kLoads];
        int a[kLoads], z[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          a[u] = 0; z[u] = 0; v[u] = 0.f;
          if (j + u < count) {
            const int col = s_col[(j + u) * k + pw];
            a[u] = max(col & 0xffff, lo);
            z[u] = min(col >> 16, hi);
            if (a[u] < z[u]) v[u] = __ldg(g + (int64_t)s_n[j + u] * C);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          for (int x = a[u]; x < z[u]; ++x) tile[x * kD + c] += v[u];
      }
    }
    __syncthreads();    // the lists are rebuilt for the next chunk
  }
  __syncthreads();      // (with no RoI, the zeroed tile)
  // 3. warp w writes pixels w, w + nwarps, ...: each pixel's run of kD
  // outputs (C apart) rounded to T, in 16-byte stores where whole aligned
  // 16 bytes of the run lie, scalars at its two ends
  T* dst = dmaps + (((int64_t)b * H + y) * W + tx0) * C + ph * kD;
  for (int r = warp; r < nx; r += nwarps) {
    T* d = dst + (int64_t)r * C;
    const float* f = tile + r * kD;
    const int head = min(kD, (int)((16 - ((uintptr_t)d & 15)) & 15) / (int)sizeof(T));
    const int nvec = (kD - head) / E, tail = head + nvec * E;
    for (int j = lane; j < nvec; j += 32) {
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = f[head + j * E + e];
      *reinterpret_cast<uint4*>(d + head + j * E) = pack16(v, T());
    }
    for (int j = lane; j < head; j += 32) store(d + j, f[j]);
    for (int j = tail + lane; j < kD; j += 32) store(d + j, f[j]);
  }
}

template <typename T>
int launch_bwd(const float* ghat, const int* hs, const int* he, const int* ws,
               const int* we, void* dmaps, int B, int N, int H, int W, int k,
               int D, cudaStream_t stream) {
  if (k < 1 || D < 1 || N < 0 || H > 65535 || (int64_t)B * k > 65535)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W == 0) return (int)cudaSuccess;
  const int kD = k * D;
  // tiles of at most kTileFloats, and enough blocks for two an SM
  int tx = std::max(1, kTileFloats / kD);
  int ntiles = (W + tx - 1) / tx;
  const int64_t rows = (int64_t)B * k * H, want = 2 * (int64_t)sm_count();
  if (ntiles * rows < want)
    ntiles = (int)std::min((int64_t)W, (want + rows - 1) / rows);
  tx = (W + ntiles - 1) / ntiles;
  ntiles = (W + tx - 1) / tx;
  const size_t smem = bwd_smem(tx, kD, k);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int err = allow_smem(psroi_direct_bwd_kernel<T>, smem);
    if (err) return err;
  }
  psroi_direct_bwd_kernel<T><<<dim3(ntiles, H, B * k), kThreads, smem,
                               stream>>>(
      ghat, hs, he, ws, we, static_cast<T*>(dmaps), N, H, W, k, D, tx);
  return (int)cudaGetLastError();
}

// SAT pools (dtt_psroi_sat, dtt_psroi_sat_mean). dtt_psroi_sat replaces
// the TPU kernel _psroi_mm_kernel_b (dtt/ops/psroi.py:311), which
// contracted one-hot +-1 row and column difference indicators against each
// (frame, bin) slab of the summed-area table on the MXU at HIGHEST
// precision (dense matmul work over almost all zeros, done to avoid the
// TPU's slow gathers), and, at B = 1, the per-frame _psroi_mm_kernel
// (dtt/ops/psroi.py:226), the same body without the frame axis. On Hopper
// the same value is four loads per output:
//
//   sums[b, n, ph, pw, d] = (S[he, we] - S[hs, we]) - (S[he, ws] - S[hs, ws])
//
// with S = SAT[b, :, :, (ph*k + pw)*D + d], in the row-first order the
// indicator form evaluates (rows give t1[x] = S[he, x] - S[hs, x], then the
// columns t1[we] - t1[ws]). A one-hot contraction adds only exact zeros
// beside its two nonzero terms, so the plain einsum form gives the same
// bits on the same table. Its mean mode divides each sum by the bin's area
// with __fdiv_rn, empty bins 0: the bits of the division the pool does
// outside the TPU kernel (bin_means).
//
// dtt_psroi_sat_mean replaces the TPU kernel _psroi_kernel
// (dtt/ops/psroi.py:586), which kept one bin's SAT slab in VMEM, read the
// RoIs' bounds from SMEM and walked the RoIs one by one: the corners
// combined as ((S11 - S01) - S10) + S00, divided by the area inside the
// kernel, empty bins 0. Here with __fsub_rn/__fadd_rn and __fdiv_rn, so
// the result equals the plain gather form to the bit. Nothing may contract
// or reorder these operations (no --use_fast_math).
//
// Bound: 4 f32 corner reads and one f32 write per output, so the memory
// rate bounds both: a pair batch (4 frames x 300 RoIs x 2107 channels)
// reads ~29 MB of distinct corners off a 90.7 MB table (past the 50 MB
// L2) and writes 10 MB; one frame's three maps (D = 31, 8, 4) ~10 MB all
// told. What kept the first kernel (a thread per output) from that rate:
// three 64-bit and three 32-bit divisions and four bound loads per output,
// scalar loads where D allows 16 bytes, and at one frame the host's time
// per launch (a launch per map).
// Design: a block per (frame, R RoIs) of one member of a group of up to 4
// (table, bounds, output) members, so one launch pools all of a frame's
// maps; R RoIs fill a block's 256 threads where one RoI's k*k*D/V vectors
// do not. The block first turns each of its R*k*k bins' clamped bounds into
// the four corner offsets (the bin's channel base included) and its area,
// in shared memory; then thread j of the block's contiguous run of outputs
// is the bin j / (D/V) (one multiply and shift) and the channel vector
// j % (D/V), V = 4, 2 or 1 channels as D and the pointers allow (D = 8 and
// 4 read 16 bytes a corner). Offsets inside a frame are 32-bit; a thread
// issues the 4 corner loads of 4/V outputs (16 floats) before its first
// subtraction, so the V = 1 and V = 4 bodies of the one kernel need alike
// few registers (40) and 6 blocks fit an SM.
constexpr int kSatMaxMembers = 4;
constexpr int kSatMaxBins = 1024;  // bins a block stages: R*k*k (k <= 32)
constexpr int kSatThreads = 256;
constexpr int kSatLoads = 16;      // floats a thread loads at once
constexpr int kSatMinBlocks = 6;   // resident blocks an SM (42 registers)
constexpr int kSatArgs = 12;       // int64 arguments per member

enum SatMode { kSums = 0, kSumMeans = 1, kGatherMeans = 2 };

struct SatMember {
  const float* sat;   // (B, H+1, W+1, k*k*D)
  const int* hs;      // (B, N, k) each
  const int* he;
  const int* ws;
  const int* we;
  float* out;         // (B, N, k, k, D)
  int N, H, W, k, D;
  int V;              // channels a thread loads at once
  int R;              // RoIs a block
  int groups;         // blocks a frame: ceil(N / R)
  int first;          // the member's first block
  Div per_vec;        // j -> bin: division by D / V
  Div per_frame;      // block -> frame: division by groups
};

struct SatGroup {
  SatMember m[kSatMaxMembers];
  int count;
  int bins;           // the most bins a block stages: R*k*k
};

template <int kMode, int V>
__device__ __forceinline__ void sat_block(const SatMember& m, int blk,
                                          int bins) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  int4* s_off = reinterpret_cast<int4*>(smem_raw);             // [bins]
  float* s_area = reinterpret_cast<float*>(smem_raw + 16 * bins);
  const int k = m.k, kk = k * k, D = m.D, H = m.H, W = m.W;
  const int W1 = W + 1, C = kk * D, dv = D / V;
  const int frame = blk / m.per_frame, n0 = (blk - frame * m.groups) * m.R;
  const int nr = min(m.R, m.N - n0);
  const int64_t bn0 = (int64_t)frame * m.N + n0;
  // 1. each bin's corner offsets S11, S01, S10, S00 and area; bounds from
  // roi_bounds lie in [0, H] x [0, W]: clamp anyway so a bad bound can
  // never read outside the table
  for (int t = threadIdx.x; t < nr * kk; t += kSatThreads) {
    const int r = t / kk, bin = t - r * kk;
    const int ph = bin / k, pw = bin - ph * k;
    const int64_t rb = (bn0 + r) * k;
    const int y0 = min(max(__ldg(m.hs + rb + ph), 0), H);
    const int y1 = min(max(__ldg(m.he + rb + ph), 0), H);
    const int x0 = min(max(__ldg(m.ws + rb + pw), 0), W);
    const int x1 = min(max(__ldg(m.we + rb + pw), 0), W);
    const int c = bin * D;
    s_off[t] = make_int4((y1 * W1 + x1) * C + c, (y0 * W1 + x1) * C + c,
                         (y1 * W1 + x0) * C + c, (y0 * W1 + x0) * C + c);
    if (kMode != kSums) s_area[t] = (float)(max(y1 - y0, 0) * max(x1 - x0, 0));
  }
  __syncthreads();
  // 2. the block's nr*C outputs are one contiguous run; V channels a thread
  const float* sat = m.sat + (int64_t)frame * (H + 1) * W1 * C;
  float* out = m.out + bn0 * C;
  const int total = nr * kk * dv;
  constexpr int U = kSatLoads / (4 * V);   // outputs a thread loads at once
  for (int j0 = threadIdx.x; j0 < total; j0 += U * kSatThreads) {
    float v[U][4][V];
    int bin[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * kSatThreads;
      bin[u] = 0;
      if (j < total) {
        const int t = j / m.per_vec;
        const int4 o = s_off[t];
        const float* p = sat + (j - t * dv) * V;
        load_vec<V>(p + o.x, v[u][0]);
        load_vec<V>(p + o.y, v[u][1]);
        load_vec<V>(p + o.z, v[u][2]);
        load_vec<V>(p + o.w, v[u][3]);
        bin[u] = t;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * kSatThreads;
      if (j >= total) break;
      float r[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float s11 = v[u][0][e], s01 = v[u][1][e];
        const float s10 = v[u][2][e], s00 = v[u][3][e];
        r[e] = kMode == kGatherMeans
                   ? __fadd_rn(__fsub_rn(__fsub_rn(s11, s01), s10), s00)
                   : __fsub_rn(__fsub_rn(s11, s01), __fsub_rn(s10, s00));
      }
      if (kMode != kSums) {
        const float area = s_area[bin[u]];
#pragma unroll
        for (int e = 0; e < V; ++e)
          r[e] = area > 0.f ? __fdiv_rn(r[e], area) : 0.f;
      }
      store_vec<V>(out + (int64_t)j * V, r);
    }
  }
}

// Block b belongs to the last member whose first block is <= b; the
// group's members sit in kernel parameter space (uniform reads).
template <int kMode>
__global__ void __launch_bounds__(kSatThreads, kSatMinBlocks)
psroi_sat_kernel(const __grid_constant__ SatGroup g) {
  int i = 0;
  while (i + 1 < g.count && (int)blockIdx.x >= g.m[i + 1].first) ++i;
  const SatMember& m = g.m[i];
  const int blk = (int)blockIdx.x - m.first;
  switch (m.V) {
    case 4: sat_block<kMode, 4>(m, blk, g.bins); break;
    case 2: sat_block<kMode, 2>(m, blk, g.bins); break;
    default: sat_block<kMode, 1>(m, blk, g.bins); break;
  }
}

// Channels a thread reads with one load: 4, 2 or 1 floats, the widest that
// divides D and to which the table and the output are aligned, so every
// bin's run of D channels starts aligned.
int sat_vec_width(const void* sat, const void* out, int D) {
  for (int v = 4; v > 1; v >>= 1)
    if (D % v == 0 && (uintptr_t)sat % (4 * v) == 0
        && (uintptr_t)out % (4 * v) == 0)
      return v;
  return 1;
}

// args: per member sat, hs, he, ws, we, out (pointers), B, N, H, W, k, D.
template <int kMode>
int launch_sat(const int64_t* args, int count, int device, void* stream) {
  if (count < 1 || count > kSatMaxMembers) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  SatGroup g{};
  g.count = count;
  int64_t blocks = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t* a = args + i * kSatArgs;
    SatMember& m = g.m[i];
    const int64_t B = a[6], N = a[7], H = a[8], W = a[9], k = a[10], D = a[11];
    if (B < 0 || N < 0 || H < 0 || W < 0 || k < 1 || k * k > kSatMaxBins
        || D < 1 || (H + 1) * (W + 1) * k * k * D >= ((int64_t)1 << 31))
      return (int)cudaErrorInvalidValue;
    m.sat = reinterpret_cast<const float*>(a[0]);
    m.hs = reinterpret_cast<const int*>(a[1]);
    m.he = reinterpret_cast<const int*>(a[2]);
    m.ws = reinterpret_cast<const int*>(a[3]);
    m.we = reinterpret_cast<const int*>(a[4]);
    m.out = reinterpret_cast<float*>(a[5]);
    m.N = (int)N; m.H = (int)H; m.W = (int)W; m.k = (int)k; m.D = (int)D;
    m.V = sat_vec_width(m.sat, m.out, m.D);
    const int per_roi = (int)(k * k) * (m.D / m.V);
    m.R = (int)std::max<int64_t>(1, std::min<int64_t>(
        std::min<int64_t>(kSatThreads / per_roi, kSatMaxBins / (k * k)), N));
    m.groups = (int)((N + m.R - 1) / m.R);
    m.first = (int)blocks;
    m.per_vec = make_div(m.D / m.V);
    m.per_frame = make_div(std::max(m.groups, 1));
    g.bins = std::max(g.bins, m.R * m.k * m.k);
    blocks += B * m.groups;
    if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)g.bins * (kMode == kSums ? 16 : 20);
  psroi_sat_kernel<kMode><<<(unsigned)blocks, kSatThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// args: `count` (1 to 4) members of 12 int64 each: the pointers sat
// (B, H+1, W+1, k*k*D) float32, hs, he, ws, we (B, N, k) int32 and out
// (B, N, k, k, D) float32, all contiguous, then B, N, H, W, k, D; k <= 32
// and (H+1)*(W+1)*k*k*D < 2^31. One launch for all members. mean: 0 = the
// bin sums, 1 = the sums divided by the bins' areas (0 for empty bins).
// Returns a cudaError_t (0 = launched).
extern "C" int dtt_psroi_sat(const int64_t* args, int count, int mean,
                             int device, void* stream) {
  if (mean == 0) return launch_sat<kSums>(args, count, device, stream);
  if (mean == 1) return launch_sat<kSumMeans>(args, count, device, stream);
  return (int)cudaErrorInvalidValue;
}

// The same members; out: the bin means of the gather form, 0 for empty
// bins. Returns a cudaError_t (0 = launched).
extern "C" int dtt_psroi_sat_mean(const int64_t* args, int count, int device,
                                  void* stream) {
  return launch_sat<kGatherMeans>(args, count, device, stream);
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
// (0 = float32, 1 = bfloat16), every element written. k <= 32, and one
// pixel's k*k*D channels in f32 and in `dtype` fit a block's shared memory.
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
