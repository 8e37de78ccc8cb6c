// Greedy NMS for Hopper (sm_90a), plain C interface for ctypes: the whole
// multi-select loop of one problem in one thread block, every problem of a
// batch in one launch (dtt_nms_select).
//
// Replaces the device loop that dtt leaves to XLA: nms_padded_fast
// (dtt/ops/nms.py:75), a lax.while_loop with no Pallas kernel. Each step
// takes the `select_block` best live scores, resolves them among
// themselves greedily, commits the survivors to the next output slots and
// masks every box a survivor overlaps; the loop ends when `max_outputs`
// slots are filled or no live score is left. These are the decisions of
// the one-at-a-time greedy loop (nms_padded, dtt/ops/nms.py:28), so both
// of the port's forms launch this kernel on the card. In eager PyTorch a
// data-dependent loop needs a host read each step; here it never leaves
// the card.
//
// Decisions, as in dtt (and in the port's plain forms):
//   * scores are float32; invalid inputs are masked to -1e10;
//   * a selection is live iff its score > score_threshold, strictly;
//   * a box is suppressed iff IoU(kept, box) > iou_threshold, strictly,
//     with Caffe's +1 widths and the arithmetic of dtt/core/boxes.py:29-55
//     (each operation rounded on its own: no FMA contraction, which would
//     move a value at the threshold);
//   * a committed box is always retired (score -1e10), even at threshold
//     >= 1; a suppressed box is set to -1e10 too;
//   * ties go to the lower index, as lax.top_k and argmax break them;
//   * a NaN score ends the loop before its first step, as argmax and max
//     take NaN as the largest value and NaN > threshold is false.
//
// Bound: the inputs are read once and the outputs written once (16 + 4
// (+ 1) bytes an input box, 9 bytes a slot), so the card's memory rate
// bounds it at a few microseconds; the real cost is the chain of dependent
// steps, each a few block-wide reductions long. Design: one thread block
// per problem (one SM each; a batch's problems run side by side), its
// scores in shared memory (4 bytes a box, up to kMaxK boxes), its boxes
// read from device memory (L2 after the first step). Each thread owns the
// boxes tid, tid + T, ... and keeps the best (score, index) among them.
// A step picks up to min(select_block, 32) candidates by repeated
// block-wide arg-max reductions (only the picked box's owner rescans its
// boxes; a picked box is parked at -inf for the rest of the pick), then
// one warp resolves them: lane j holds candidate j's IoU row against the
// earlier candidates as a 32-bit mask, and the survivors follow in order,
// one shuffle each. The kept ones take the next output slots until the
// budget is full; then every thread masks its boxes against the kept ones
// and rescans its best. A wider select_block gives the same decisions,
// so it is taken 32 candidates a step. The kernel allocates nothing and
// writes every output slot (0 and false past the last kept box) and the
// number of steps it ran.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr float kNeg = -1e10f;     // dtt's _NEG: masked and retired boxes
constexpr int kMaxK = 49152;       // boxes a problem: 192 KB of scores
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// box_area of dtt/core/boxes.py:29: max(x2 - x1 + 1, 0) * max(y2 - y1 + 1, 0)
__device__ __forceinline__ float box_area(float4 b) {
  const float w = clamp0(__fadd_rn(__fsub_rn(b.z, b.x), 1.f));
  const float h = clamp0(__fadd_rn(__fsub_rn(b.w, b.y), 1.f));
  return __fmul_rn(w, h);
}

// elementwise_iou of dtt/core/boxes.py:48 with a = the kept box
__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b,
                                         float area_b) {
  const float ix = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f);
  const float iy = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f);
  const float inter = __fmul_rn(clamp0(ix), clamp0(iy));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// (v, i) better than (w, j): the larger score, then the lower index
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off; off >>= 1) {
    const float w = __shfl_down_sync(kFull, v, off);
    const int j = __shfl_down_sync(kFull, i, off);
    if (better(w, j, v, i)) { v = w; i = j; }
  }
}

struct Shared {
  float red_v[33];      // per-warp bests, then the block's at [32]
  int red_i[33];
  int cand[32];         // this step's candidates, best first
  float4 kbox[32];      // the kept ones' boxes and areas
  float karea[32];
  int kidx[32];
  int nkept;
  int count;            // output slots filled so far
};

// The block's best (score, index) of the threads' (v, i); every thread
// gets it. Two barriers.
__device__ __forceinline__ void block_argmax(float& v, int& i, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) { sh.red_v[warp] = v; sh.red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sh.red_v[lane] : -INFINITY;
    i = lane < nw ? sh.red_i[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) { sh.red_v[32] = v; sh.red_i[32] = i; }
  }
  __syncthreads();
  v = sh.red_v[32];
  i = sh.red_i[32];
}

// The best (score, index) among this thread's boxes tid, tid + T, ...
__device__ __forceinline__ void local_best(const float* s, int K, float& v,
                                           int& i) {
  v = -INFINITY;
  i = INT_MAX;
  for (int e = threadIdx.x; e < K; e += blockDim.x)
    if (s[e] > v) { v = s[e]; i = e; }
}

__global__ void __launch_bounds__(kMaxThreads)
nms_select_kernel(const float4* __restrict__ boxes,
                  const float* __restrict__ scores,
                  const uint8_t* __restrict__ valid,
                  int64_t* __restrict__ keep_idx,
                  uint8_t* __restrict__ keep_valid, int* __restrict__ steps,
                  int K, int M, int block, float iou_thr, float score_thr) {
  extern __shared__ float s[];     // K scores
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x;
  const int64_t p = blockIdx.x;
  boxes += p * K;
  scores += p * K;
  if (valid) valid += p * K;
  keep_idx += p * M;
  keep_valid += p * M;

  int nan = 0;
  for (int e = tid; e < K; e += T) {
    const float v = (valid && !valid[e]) ? kNeg : scores[e];
    s[e] = v;
    nan |= isnan(v);
  }
  if (tid == 0) sh.count = 0;
  // the barrier also publishes the scores and the count
  const bool stop = __syncthreads_or(nan);

  float bv;
  int bi;
  local_best(s, K, bv, bi);
  int nstep = 0;
  while (!stop) {
    // 1. pick up to `block` live candidates, best first
    int n = 0;
    while (n < block) {
      float v = bv;
      int i = bi;
      block_argmax(v, i, sh);
      if (!(v > score_thr)) break;            // no live score is left
      if (tid == 0) sh.cand[n] = i;
      if (i % T == tid) {                     // park it for this pick
        s[i] = -INFINITY;
        local_best(s, K, bv, bi);
      }
      ++n;
    }
    if (n == 0) break;
    ++nstep;
    __syncthreads();                          // sh.cand
    // 2. one warp resolves them in order and commits the survivors
    if (warp == 0) {
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      float ab = 0.f;
      int ci = 0;
      if (lane < n) {
        ci = sh.cand[lane];
        b = boxes[ci];
        ab = box_area(b);
        sh.kbox[lane] = b;
        sh.karea[lane] = ab;
      }
      __syncwarp();
      unsigned row = 0;                       // bit j: IoU(cand j, mine) > thr
      for (int j = 0; j < lane && j < n; ++j)
        if (box_iou(sh.kbox[j], sh.karea[j], b, ab) > iou_thr) row |= 1u << j;
      unsigned kept = 0;
      for (int j = 0; j < n; ++j)
        if ((__shfl_sync(kFull, row, j) & kept) == 0) kept |= 1u << j;
      const int count = sh.count;
      const unsigned below = (1u << lane) - 1u;
      const int pos = count + __popc(kept & below);
      const bool mine = lane < n && ((kept >> lane) & 1u) && pos < M;
      if (mine) {
        keep_idx[pos] = ci;
        keep_valid[pos] = 1;
      }
      const unsigned commit = __ballot_sync(kFull, mine);
      __syncwarp();
      if (mine) {                             // compact the kept boxes
        const int r = __popc(commit & below);
        sh.kidx[r] = ci;
        sh.kbox[r] = b;
        sh.karea[r] = ab;
      }
      if (lane == 0) {
        sh.nkept = __popc(commit);
        sh.count = count + __popc(commit);
      }
    }
    __syncthreads();                          // sh.kbox, nkept, count
    if (sh.count >= M) break;                 // the budget is full
    // 3. retire the kept boxes, mask what they overlap, rescan
    const int nk = sh.nkept;
    for (int r = 0; r < nk; ++r)
      if (sh.kidx[r] % T == tid) s[sh.kidx[r]] = kNeg;
    bv = -INFINITY;
    bi = INT_MAX;
    for (int e = tid; e < K; e += T) {
      float v = s[e];
      if (v != kNeg) {
        const float4 b = boxes[e];
        const float ab = box_area(b);
        for (int r = 0; r < nk; ++r)
          if (box_iou(sh.kbox[r], sh.karea[r], b, ab) > iou_thr) {
            v = kNeg;
            s[e] = v;
            break;
          }
      }
      if (v > bv) { bv = v; bi = e; }
    }
  }
  // every slot past the last kept box: index 0, not valid
  const int count = sh.count;
  for (int i = count + tid; i < M; i += T) {
    keep_idx[i] = 0;
    keep_valid[i] = 0;
  }
  if (tid == 0) steps[p] = nstep;
}

}  // namespace

// The largest K the kernel takes (its scores fill shared memory).
extern "C" int dtt_nms_max_boxes() { return kMaxK; }

// boxes: (P, K, 4) float32; scores: (P, K) float32; valid: (P, K) bytes
// 0/1 or null; keep_idx: (P, M) int64; keep_valid: (P, M) bytes; steps:
// (P,) int32, the dependent steps each problem ran. 1 <= K <= kMaxK,
// M >= 1, select_block >= 1 (taken 32 at a time past 32). Returns a
// cudaError_t (0 = launched).
extern "C" int dtt_nms_select(const void* boxes, const void* scores,
                              const void* valid, void* keep_idx,
                              void* keep_valid, void* steps, int P, int K,
                              int M, int select_block, float iou_threshold,
                              float score_threshold, int device,
                              void* stream) {
  if (P < 1 || K < 1 || K > kMaxK || M < 1 || select_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = K >= kMaxThreads ? kMaxThreads : ((K + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)K;
  // past 48 KB with the static part only by this opt-in
  err = cudaFuncSetAttribute(nms_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int block = select_block < 32 ? select_block : 32;
  nms_select_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<int64_t*>(keep_idx),
      static_cast<uint8_t*>(keep_valid), static_cast<int*>(steps), K, M, block,
      iou_threshold, score_threshold);
  return (int)cudaGetLastError();
}
