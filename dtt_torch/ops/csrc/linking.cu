// Tube linking for Hopper (sm_90a), plain C interface for ctypes: dtt's
// repeated-Viterbi linking and rescoring of every class of a snippet in one
// launch (dtt_link_tubes).
//
// Replaces the device program that dtt leaves to XLA: link_tubes
// (dtt/eval/linking.py:80), a lax.scan over `max_tubes` tubes, each a
// Viterbi that is a forward lax.scan over the frames and a reverse one for
// the backtrack, vmapped over the classes by link_all_classes (:135); there
// is no Pallas kernel. In eager PyTorch (link_all_classes_plain in
// dtt_torch/eval/linking.py) each frame step is several launches, ~3,500
// for a 16-frame snippet at 20 tubes; here the whole program stays on the
// card.
//
// What it computes, per class, as dtt and the plain form do. A detection is
// live while it is valid and not claimed by an earlier tube. Each of the
// `max_tubes` iterations (all of them run, as in dtt):
//   * p = the score of a live slot; a frame with no live slot exposes slot
//     0 as a virtual skip (p = 0); every other slot has p = -1e9 (kNeg);
//   * v_0[i] = 0 where slot i of frame 0 is live or virtual, else kNeg; for
//     t = 0 .. T-2, v_{t+1}[j] = max_i v_t[i] + link(i, j), the first
//     maximum, with link = (p_t[i] + p_{t+1}[j]) + w * IoU(tracked_t[i],
//     box_{t+1}[j]) where slot j of frame t+1 is live or virtual, else kNeg;
//   * the path ends at the first argmax of v_{T-1} and is walked back by
//     the backpointers; its mean score is v_{T-1}[end] / max(T - 1, 1); the
//     tube is ok iff some slot was live and the mean is > -5e8;
//   * its claimed slots are the path's live ones; the boost is the mean of
//     the k largest of the T frames' claimed scores (-inf where a frame
//     claims none; non-finite ones count 0), k = ceil(count / 2)
//     (mean_top_half), count (mean) or 1 (max), at least 1; if the tube is
//     ok, each claimed slot is rescored to max(rescored, boost) and claimed.
//
// Exactness: the IoU is elementwise_iou's (dtt/core/boxes.py, +1 widths) in
// its operation order with __fadd_rn, __fsub_rn, __fmul_rn and __fdiv_rn,
// the link and the candidate in the plain form's order, the mean by
// __fdiv_rn: nvcc would otherwise contract a product and a sum into an FMA
// and move a decision. det_idx, tube_valid, tube_score and det_in_tube then
// equal the plain form's bit for bit. Only the boost's sum is taken in
// another order (in double, then rounded), so rescored agrees to float32
// roundoff.
//
// Design: a thread block per class. The forward pass gives each slot j of
// frame t+1 to a warp (warps stride over j, so any N works) and the slots i
// of frame t to its lanes (stride 32); a shuffle reduction takes the first
// maximum. v is double-buffered with one block barrier a frame, which also
// ORs whether the frame after next has a live slot (its virtual slot). One
// thread walks the backpointers; a thread per frame ranks its claimed score
// among the T for the boost; a thread per frame claims. About T + 8 block
// barriers a tube.
//
// Bound: the inputs are read once and the outputs written once (42 bytes a
// slot, 13 + 8T a tube), ~0.14 us at the card's memory rate for 30
// classes of 16 frames of 20 slots. The work the function needs is the
// IoU and its weight, ~16 float operations a pair (i, j) of consecutive
// frames, once a class (no tube changes it), and the link and candidate,
// ~4 a pair a tube: ~0.26 us of the float32 rate there at 20 tubes. This
// kernel recomputes the IoU for every tube, work the bound does not count.
// What sets the time is the chain of dependent steps: a block barrier a
// frame, a T-step backtrack and a few barriers a tube, `max_tubes` tubes,
// in 30 blocks on 132 SMs.
//
// NaN: the argmax is jnp.argmax's, which dtt uses: a NaN ranks above every
// number and the first NaN wins, so every backpointer and every path slot
// lies in [0, N). For T > 1 a live NaN score makes every path's score NaN
// and so every tube not ok (at T = 1 a tube claims one slot), so where a
// NaN claimed score would rank in the boost never matters.
//
// Layout (link_layout in dtt_torch/eval/linking.py names it, from the
// same kSmemLimit and kStaticSmem): v (2N floats), the claimed scores (T
// floats) and the backpointers ((T-1) N int32) take shared memory in that
// order while they fit a block's 227 KB beside the static 1 KB; the rest sits in a scratch buffer of the
// wrapper's, one slice a class (at N = 20 the backpointers from T = 2,755
// on). Each array is 16-byte aligned. The kernel allocates nothing and
// writes every output.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr float kNeg = -1e9f;      // dtt's _NEG
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // a block's shared memory (227 KB)
constexpr int kStaticSmem = 1024;  // bytes link_layout leaves for Shared
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float4* boxes;
  const float4* tracked;
  const float* scores;
  const uint8_t* valid;
  int64_t* det_idx;
  uint8_t* tube_valid;
  float* tube_score;
  float* rescored;
  uint8_t* in_tube;
  unsigned char* scratch;          // null, or `stride` bytes a class
  int64_t stride;
  int T, N, K, boost, n_shared;
  float w;
};

struct Shared {
  float red_v[32];                 // block reductions: a value a warp
  int red_i[32];
  double red_d[32];
  float score;                     // the path's end: its value and slot
  int end;
  int ok, count;
};
static_assert(sizeof(Shared) <= kStaticSmem, "link_layout reserves 1 KB");

// The bytes of v, the claimed scores and the backpointers, each padded to
// 16 bytes.
__host__ __device__ inline int64_t pad16(int64_t b) { return (b + 15) & ~15; }
__host__ __device__ inline void array_bytes(int t, int n, int64_t* b) {
  b[0] = pad16(8 * (int64_t)n);
  b[1] = pad16(4 * (int64_t)t);
  b[2] = pad16(4 * (int64_t)(t - 1) * n);
}

__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// box_area of dtt/core/boxes.py: max(x2 - x1 + 1, 0) * max(y2 - y1 + 1, 0)
__device__ __forceinline__ float box_area(float4 b) {
  const float w = clamp0(__fadd_rn(__fsub_rn(b.z, b.x), 1.f));
  const float h = clamp0(__fadd_rn(__fsub_rn(b.w, b.y), 1.f));
  return __fmul_rn(w, h);
}

// elementwise_iou(a, b) of dtt/core/boxes.py, in its operation order
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float ix = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f);
  const float iy = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f);
  const float inter = __fmul_rn(clamp0(ix), clamp0(iy));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// (v, i) replaced by (u, k) iff u ranks above v, or ties it at a lower
// index: the first maximum, as jnp.argmax and the plain form take it, a
// NaN above every number. A total order, so any reduction tree agrees.
__device__ __forceinline__ void take_first_max(float& v, int& i, float u,
                                               int k) {
  const bool un = isnan(u), vn = isnan(v);
  const bool above = un ? !vn : !vn && u > v;
  const bool tie = un ? vn : u == v;
  if (above || (tie && k < i)) {
    v = u;
    i = k;
  }
}

__device__ __forceinline__ void warp_first_max(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1)
    take_first_max(v, i, __shfl_xor_sync(kFull, v, off),
                   __shfl_xor_sync(kFull, i, off));
}

// The first maximum over the block's (v, i); every thread gets it in
// sh.score, sh.end. Two barriers.
__device__ void block_first_max(float v, int i, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_first_max(v, i);
  if (lane == 0) {
    sh.red_v[warp] = v;
    sh.red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (int)(blockDim.x >> 5);
    v = in ? sh.red_v[lane] : -INFINITY;
    i = in ? sh.red_i[lane] : INT_MAX;
    warp_first_max(v, i);
    if (lane == 0) {
      sh.score = v;
      sh.end = i;
    }
  }
  __syncthreads();
}

// The block's sum of x, in a fixed order; every thread gets it. Two
// barriers.
__device__ double block_sum(double x, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  if (lane == 0) sh.red_d[warp] = x;
  __syncthreads();
  double s = 0.0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += sh.red_d[k];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kMaxThreads) link_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int T = a.T, N = a.N, K = a.K;
  const int64_t c = blockIdx.x, tn = (int64_t)T * N;
  const float4* boxes = a.boxes + c * tn;
  const float4* tracked = a.tracked + c * tn;
  const float* scores = a.scores + c * tn;
  const uint8_t* valid = a.valid + c * tn;
  int64_t* det_idx = a.det_idx + c * K * T;
  float* rescored = a.rescored + c * tn;
  uint8_t* in_tube = a.in_tube + c * tn;

  // v (two buffers), the claimed scores, the backpointers: the first
  // n_shared of them in shared memory, the rest in this class's scratch
  unsigned char* ptr[3];
  {
    int64_t bytes[3], on_chip = 0, off_chip = 0;
    array_bytes(T, N, bytes);
    unsigned char* mine = a.scratch ? a.scratch + c * a.stride : nullptr;
    for (int k = 0; k < 3; ++k) {
      if (k < a.n_shared) {
        ptr[k] = smem + on_chip;
        on_chip += bytes[k];
      } else {
        ptr[k] = mine + off_chip;
        off_chip += bytes[k];
      }
    }
  }
  float* v_a = reinterpret_cast<float*>(ptr[0]);
  float* v_b = v_a + N;
  float* claimed = reinterpret_cast<float*>(ptr[1]);
  int* back = reinterpret_cast<int*>(ptr[2]);

  for (int64_t e = tid; e < tn; e += nthreads) {
    rescored[e] = scores[e];
    in_tube[e] = 0;
  }
  __syncthreads();
  auto live = [&](int t, int j) {
    const int64_t e = (int64_t)t * N + j;
    return valid[e] && !in_tube[e];
  };
  // whether a slot of frame t that this thread looks at is live
  auto frame_live = [&](int t) {
    bool any = false;
    for (int j = tid; j < N; j += nthreads) any |= live(t, j);
    return any;
  };

  for (int k = 0; k < K; ++k) {
    // 1. Forward: v_0, then a frame a barrier. live_t / live_n: frames t
    //    and t+1 have a live slot (else slot 0 is virtual).
    bool live_t = __syncthreads_or(frame_live(0));
    for (int j = tid; j < N; j += nthreads)
      v_a[j] = (live(0, j) || (!live_t && j == 0)) ? 0.f : kNeg;
    bool any_left = live_t;
    bool live_n = __syncthreads_or(T > 1 && frame_live(1));
    float* vp = v_a;
    float* vn = v_b;
    for (int t = 0; t + 1 < T; ++t) {
      const float* sc_t = scores + (int64_t)t * N;
      const float* sc_n = sc_t + N;
      const float4* trk_t = tracked + (int64_t)t * N;
      for (int j = warp; j < N; j += nwarps) {
        const bool lj = live(t + 1, j);
        const bool eff = lj || (!live_n && j == 0);
        const float pc = lj ? sc_n[j] : 0.f;
        const float4 b = boxes[(int64_t)(t + 1) * N + j];
        const float area_b = box_area(b);
        float best = -INFINITY;
        int arg = INT_MAX;
        for (int i = lane; i < N; i += 32) {
          float link = kNeg;
          if (eff) {
            const float pp = live(t, i) ? sc_t[i]
                             : (!live_t && i == 0) ? 0.f
                                                   : kNeg;
            const float4 q = trk_t[i];
            link = __fadd_rn(__fadd_rn(pp, pc),
                             __fmul_rn(a.w, iou(q, box_area(q), b, area_b)));
          }
          take_first_max(best, arg, __fadd_rn(vp[i], link), i);
        }
        warp_first_max(best, arg);
        if (lane == 0) {
          vn[j] = best;
          back[(int64_t)t * N + j] = arg;
        }
      }
      any_left |= live_n;
      live_t = live_n;
      live_n = __syncthreads_or(t + 2 < T && frame_live(t + 2));
      float* swap = vp;
      vp = vn;
      vn = swap;
    }

    // 2. The path's end, its mean score, the backtrack.
    float best = -INFINITY;
    int arg = INT_MAX;
    for (int j = tid; j < N; j += nthreads) take_first_max(best, arg, vp[j], j);
    block_first_max(best, arg, sh);
    int64_t* path = det_idx + (int64_t)k * T;
    if (tid == 0) {
      const float mean = __fdiv_rn(sh.score, (float)(T > 1 ? T - 1 : 1));
      const bool ok = any_left && mean > kNeg / 2;
      a.tube_valid[c * K + k] = ok;
      a.tube_score[c * K + k] = mean;
      sh.ok = ok;
      sh.count = 0;
      int j = sh.end;
      for (int t = T - 1; t > 0; --t) {
        path[t] = j;
        j = back[(int64_t)(t - 1) * N + j];
      }
      path[0] = j;
    }
    __syncthreads();

    // 3. The boost: the mean of the k_stat largest claimed scores.
    int mine = 0;
    for (int t = tid; t < T; t += nthreads) {
      const int j = (int)path[t];
      const bool cl = live(t, j);
      claimed[t] = cl ? scores[(int64_t)t * N + j] : -INFINITY;
      mine += cl;
    }
    if (mine) atomicAdd(&sh.count, mine);
    __syncthreads();
    const int count = sh.count;
    const int k_stat = a.boost == 0   ? max((count + 1) / 2, 1)
                       : a.boost == 1 ? max(count, 1)
                                      : 1;
    double part = 0.0;
    for (int t = tid; t < T; t += nthreads) {
      const float x = claimed[t];
      if (x == -INFINITY) continue;      // adds 0 wherever it ranks
      int rank = 0;                      // its place in a stable sort
      for (int s = 0; s < T && rank < k_stat; ++s) {
        const float y = claimed[s];
        rank += y > x || (y == x && s < t);
      }
      if (rank < k_stat && isfinite(x)) part += x;
    }
    const float boost =
        __fdiv_rn((float)block_sum(part, sh), (float)k_stat);

    // 4. Claim.
    if (sh.ok) {
      for (int t = tid; t < T; t += nthreads) {
        const int j = (int)path[t];
        if (live(t, j)) {
          const int64_t e = (int64_t)t * N + j;
          const float r = rescored[e];
          rescored[e] = (isnan(r) || r > boost) ? r : boost;
          in_tube[e] = 1;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// boxes, tracked: (C, T, N, 4) float32; scores: (C, T, N) float32; valid:
// (C, T, N) bytes 0/1; det_idx: (C, K, T) int64; tube_valid: (C, K) bytes;
// tube_score: (C, K) float32; rescored: (C, T, N) float32; in_tube: (C, T,
// N) bytes. T, N, K >= 1. `boost`: 0 mean_top_half, 1 mean, 2 max. `smem`
// (dynamic shared bytes a block), `n_shared` (how many of v, the claimed
// scores and the backpointers sit in shared memory), `stride` and
// `scratch` come from link_layout: with n_shared = 3 `scratch` may be
// null, otherwise the rest sits in `scratch`, `stride` bytes a class.
// Returns a cudaError_t (0 = launched).
extern "C" int dtt_link_tubes(const void* boxes, const void* tracked,
                              const void* scores, const void* valid,
                              void* det_idx, void* tube_valid,
                              void* tube_score, void* rescored, void* in_tube,
                              int C, int T, int N, int K,
                              float link_iou_weight, int boost, int smem,
                              int n_shared, int64_t stride, void* scratch,
                              int device, void* stream) {
  if (C < 1 || T < 1 || N < 1 || K < 1 || boost < 0 || boost > 2 ||
      n_shared < 0 || n_shared > 3)
    return (int)cudaErrorInvalidValue;
  int64_t bytes[3], on_chip = 0, off_chip = 0;
  array_bytes(T, N, bytes);
  for (int k = 0; k < 3; ++k) (k < n_shared ? on_chip : off_chip) += bytes[k];
  if (smem < on_chip || on_chip + kStaticSmem > kSmemLimit ||
      (off_chip && (!scratch || stride < off_chip || stride % 16)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = 32 * (int64_t)N;
  const int threads = want >= kMaxThreads ? kMaxThreads : (int)want;
  // past 48 KB with the static part only by this opt-in
  err = cudaFuncSetAttribute(link_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.boxes = static_cast<const float4*>(boxes);
  a.tracked = static_cast<const float4*>(tracked);
  a.scores = static_cast<const float*>(scores);
  a.valid = static_cast<const uint8_t*>(valid);
  a.det_idx = static_cast<int64_t*>(det_idx);
  a.tube_valid = static_cast<uint8_t*>(tube_valid);
  a.tube_score = static_cast<float*>(tube_score);
  a.rescored = static_cast<float*>(rescored);
  a.in_tube = static_cast<uint8_t*>(in_tube);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.stride = stride;
  a.T = T;
  a.N = N;
  a.K = K;
  a.boost = boost;
  a.n_shared = n_shared;
  a.w = link_iou_weight;
  link_kernel<<<C, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
