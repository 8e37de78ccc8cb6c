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
//     move a value at the threshold); boxes that do not meet (ix <= 0 or
//     iy <= 0) have IoU exactly 0 there, so they skip the division;
//   * a committed box is always retired (score -1e10), even at threshold
//     >= 1; a suppressed box is set to -1e10 too;
//   * ties go to the lower index, as lax.top_k and argmax break them;
//     +0.0 ranks above -0.0 in the total order of lax.top_k
//     (nms_padded_fast) and ties it in the order of argmax (nms_padded):
//     the caller picks the order;
//   * a NaN score ends the loop before its first step, as argmax and max
//     take NaN as the largest value and NaN > threshold is false.
//
// Bound: the inputs are read once and the outputs written once (16 + 4
// (+ 1) bytes an input box, 9 bytes a slot), a few microseconds at the
// card's memory rate. What sets the time is the chain of dependent steps
// (10 for 300 of 6,000 proposals), so the design makes a step short: a
// constant number of block barriers, no search over the scores, and IoU
// tests only where the walk goes.
//
//   1. Order once. The block compacts its live boxes (bit words by ballot,
//      a block scan of their counts), keyed by (score descending, index
//      ascending) as unique 64-bit keys, checks whether they are already
//      in order (the proposal layer sorts its scores first) and otherwise
//      sorts them by a bitonic network (block barriers only where a
//      compare-exchange crosses warps). Then the boxes and their areas are
//      copied in that order, and an alive bit is set for each position.
//   2. Walk. A live box's score never changes until it dies, so greedy NMS
//      in this order is a walk: a step's candidates are the next `w` alive
//      positions after a cursor, which one warp finds by popcounts and a
//      warp scan over the alive words. The same warp resolves them (lane j
//      holds candidate j's IoU row against the earlier ones as 32 bits;
//      the survivors follow in order, one shuffle each), commits them to
//      the next slots until the budget is full and advances the cursor;
//      then the whole block clears the alive bits of every later position
//      that a kept box overlaps, a warp a 32-position word (words with no
//      alive bit are skipped). Two block barriers a step.
//   3. Below -1e10. With score_threshold < -1e10 a retired or suppressed
//      box (score -1e10) is live again, ranked by index among the masked
//      ones and above every score under -1e10 (dtt selects it again). The
//      walk then has a third bit set, the -1e10 "tier" by box index: the
//      candidates come from the alive positions above -1e10, then the
//      tier, then the alive positions between the threshold and -1e10; a
//      box that dies joins the tier, and every box outside it is masked.
//
// Layout by K (nms_layout in dtt_torch/ops/nms.py names it): the sorted
// boxes (16 bytes), areas (4) and indices (4), 24 bytes a box, sit in
// shared memory while they and the bit words fit the 227 KB of a block
// (K <= 9,472: 146,640 bytes at K = 6,000); past that they sit in a
// scratch buffer that the wrapper allocates (24 bytes a box a problem) and
// only the bit words stay in shared memory. The sort keys (8 bytes a box
// up to the next power of two) share the boxes' and areas' bytes, which
// are filled only after the sort. The kernel allocates nothing, writes
// every output slot (0 and false past the last kept box) and the number of
// steps it ran.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNeg = -1e10f;     // dtt's _NEG: masked and retired boxes
constexpr int kMaxK = 49152;       // boxes a problem
constexpr int kMaxThreads = 1024;
constexpr int kWidth = 32;         // candidates a step: one warp's lanes
constexpr int kStaticSmem = 1024;  // bytes nms_layout leaves for Shared
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float4* boxes;
  const float* scores;
  const uint8_t* valid;
  int64_t* keep_idx;
  uint8_t* keep_valid;
  int* steps;
  unsigned char* scratch;          // null, or `stride` bytes a problem
  int64_t stride;
  int K, M, width;
  float iou_thr, score_thr;
  bool total;                      // +0.0 above -0.0, else they tie
};

struct Shared {
  int red[33];                     // block scan: warp sums, then the total
  int cand[kWidth];                // a step's candidates: position, or ~box
  float4 kbox[kWidth];             // candidates' boxes, then the kept ones'
  float karea[kWidth];
  int n_a, n_c;                    // alive positions above -1e10, below it
  int cursor, ncand, nkept, count;
};
static_assert(sizeof(Shared) <= kStaticSmem, "nms_layout reserves 1 KB");

// The bytes of the sorted boxes, areas and indices, and of the bit words
// (alive, tier, word prefix), for K boxes.
__host__ __device__ constexpr int64_t staged_bytes(int k) {
  return 24 * (int64_t)((k + 31) / 32 * 32);
}
__host__ __device__ constexpr int64_t bit_bytes(int k) {
  return 12 * (int64_t)((k + 31) / 32);
}

__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// box_area of dtt/core/boxes.py:29: max(x2 - x1 + 1, 0) * max(y2 - y1 + 1, 0)
__device__ __forceinline__ float box_area(float4 b) {
  const float w = clamp0(__fadd_rn(__fsub_rn(b.z, b.x), 1.f));
  const float h = clamp0(__fadd_rn(__fsub_rn(b.w, b.y), 1.f));
  return __fmul_rn(w, h);
}

// elementwise_iou of dtt/core/boxes.py:48 with a = the kept box, > thr
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float thr) {
  const float ix = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f);
  const float iy = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f);
  // apart: the intersection is +-0 and so is dtt's IoU, whatever the union
  if (ix <= 0.f || iy <= 0.f) return 0.f > thr;
  const float inter = __fmul_rn(ix, iy);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > thr;
}

// Ascending order of the keys = score descending, then index ascending;
// without `total`, -0.0 ties +0.0.
__device__ __forceinline__ uint64_t sort_key(float s, int e, bool total) {
  uint32_t u = __float_as_uint(total || s != 0.f ? s : 0.f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);     // increases with s
  return ((uint64_t)~u << 32) | (uint32_t)e;
}

// The exclusive prefix of x over the block's threads; `total` gets the
// sum. Two barriers.
__device__ int block_exclusive_scan(int x, int& total, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh.red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < (int)(blockDim.x >> 5) ? sh.red[lane] : 0;
    int s = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    sh.red[lane] = s - v;
    if (lane == 31) sh.red[32] = s;
  }
  __syncthreads();
  total = sh.red[32];
  return sh.red[warp] + incl - x;
}

// Sorts keys[0, n) ascending, in place (shared or scratch memory); room
// for the next power of two. A warp's compare-exchanges stay inside its
// own 64 keys while the distance is <= 32, so only the others need a
// block barrier.
__device__ void bitonic_sort(uint64_t* keys, int n) {
  int len = 1;
  while (len < n) len <<= 1;
  for (int i = n + threadIdx.x; i < len; i += blockDim.x) keys[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < len / 2; i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const uint64_t x = keys[lo], y = keys[lo + j];
        if ((x > y) == ((lo & k) == 0)) {
          keys[lo] = y;
          keys[lo + j] = x;
        }
      }
      if (j >= 64 || j == 1) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
}

// One warp: appends to cand[found..width) the set bits of bits[lo, hi) in
// order (as positions, or as ~index for the tier) and returns the new
// count.
__device__ int collect(const unsigned* bits, int lo, int hi, int found,
                       int width, bool tier, int* cand) {
  const int lane = threadIdx.x & 31;
  if (lo >= hi) return found;
  const int wlo = lo >> 5, whi = (hi - 1) >> 5;
  for (int w0 = wlo; w0 <= whi && found < width; w0 += 32) {
    const int w = w0 + lane;
    unsigned x = 0;
    if (w <= whi) {
      x = bits[w];
      if (w == wlo) x &= kFull << (lo & 31);
      if (w == whi && (hi & 31)) x &= kFull >> (32 - (hi & 31));
    }
    const int c = __popc(x);
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    for (int r = found + incl - c; x && r < width; ++r) {
      const int v = 32 * w + __ffs(x) - 1;
      x &= x - 1;
      cand[r] = tier ? ~v : v;
    }
    found = min(width, found + __shfl_sync(kFull, incl, 31));
  }
  return found;
}

template <bool kInShared>
__global__ void __launch_bounds__(kMaxThreads) nms_walk_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;
  const int K = a.K, M = a.M, width = a.width;
  const int kp = (K + 31) & ~31, nw = kp >> 5;
  const float iou_thr = a.iou_thr, thr = a.score_thr;
  const bool exotic = thr < kNeg;      // masked boxes are live again
  const float above = exotic ? kNeg : thr;
  const int64_t p = blockIdx.x;
  unsigned char* base = kInShared ? smem : a.scratch + p * a.stride;
  float4* sbox = reinterpret_cast<float4*>(base);
  float* sarea = reinterpret_cast<float*>(base + 16 * (size_t)kp);
  int* order = reinterpret_cast<int*>(base + 20 * (size_t)kp);
  uint64_t* keys = reinterpret_cast<uint64_t*>(base);   // before sbox
  unsigned* alive = reinterpret_cast<unsigned*>(
      smem + (kInShared ? staged_bytes(K) : 0));
  unsigned* tier = alive + nw;
  int* wpre = reinterpret_cast<int*>(tier + nw);
  const float4* boxes = a.boxes + p * K;
  const float* scores = a.scores + p * K;
  const uint8_t* valid = a.valid ? a.valid + p * K : nullptr;
  int64_t* keep_idx = a.keep_idx + p * M;
  uint8_t* keep_valid = a.keep_valid + p * M;
  auto score = [&](int e) {
    return (valid && !valid[e]) ? kNeg : scores[e];
  };

  if (tid == 0) {
    sh.n_a = sh.n_c = sh.cursor = sh.count = 0;
  }
  __syncthreads();
  // 1. Which boxes to order (the live ones; below -1e10 every box that is
  //    not at -1e10, as any of them may come back), as bit words by index;
  //    the tier; the counts above and below -1e10; NaN.
  int nan = 0;
  for (int e0 = 32 * warp; e0 < kp; e0 += T) {
    const int e = e0 + lane;
    const float v = e < K ? score(e) : 0.f;
    nan |= e < K && isnan(v);
    const bool in = e < K && (exotic ? v != kNeg : v > thr);
    const unsigned ws = __ballot_sync(kFull, in);
    const unsigned wt = __ballot_sync(kFull, e < K && v == kNeg);
    const unsigned wa = __ballot_sync(kFull, e < K && v > above);
    const unsigned wc = __ballot_sync(kFull, e < K && exotic && v < kNeg &&
                                                 v > thr);
    if (lane == 0) {
      alive[e0 >> 5] = ws;
      tier[e0 >> 5] = wt;
      if (wa) atomicAdd(&sh.n_a, __popc(wa));
      if (wc) atomicAdd(&sh.n_c, __popc(wc));
    }
  }
  int nstep = 0;
  if (!__syncthreads_or(nan)) {
    // 2. Compact them in index order: a word's first slot is the prefix of
    //    the popcounts before it.
    const int per = (nw + T - 1) / T, w0 = tid * per;
    const int w1 = min(w0 + per, nw);
    int c = 0;
    for (int w = w0; w < w1; ++w) c += __popc(alive[w]);
    int n;
    int run = block_exclusive_scan(c, n, sh);
    for (int w = w0; w < w1; ++w) {
      wpre[w] = run;
      run += __popc(alive[w]);
    }
    __syncthreads();
    for (int e = tid; e < K; e += T) {
      const unsigned word = alive[e >> 5];
      if ((word >> (e & 31)) & 1u)
        keys[wpre[e >> 5] + __popc(word & ((1u << (e & 31)) - 1u))] =
            sort_key(score(e), e, a.total);
    }
    __syncthreads();
    // 3. Sort unless they are in order already.
    bool unsorted = false;
    for (int q = tid; q + 1 < n; q += T) unsorted |= keys[q] > keys[q + 1];
    if (__syncthreads_or(unsorted)) bitonic_sort(keys, n);
    for (int q = tid; q < n; q += T) order[q] = (int)(uint32_t)keys[q];
    __syncthreads();
    // 4. Boxes and areas in that order (over the keys); every position
    //    alive.
    for (int q = tid; q < n; q += T) {
      const float4 b = boxes[order[q]];
      sbox[q] = b;
      sarea[q] = box_area(b);
    }
    for (int w = tid; w < nw; w += T)
      alive[w] = 32 * w + 32 <= n ? kFull
                 : 32 * w < n     ? kFull >> (32 - (n & 31))
                                  : 0u;
    __syncthreads();
    const int n_a = sh.n_a, n_c = sh.n_c;

    // 5. The walk: two block barriers a step.
    for (;;) {
      if (warp == 0) {
        // the next `width` alive positions from the cursor (then, below
        // -1e10, the tier by index and the positions under -1e10)
        int found = collect(alive, sh.cursor, n_a, 0, width, false, sh.cand);
        __syncwarp();
        const int cursor = found == width ? sh.cand[width - 1] + 1 : n_a;
        if (exotic && found < width) {
          found = collect(tier, 0, K, found, width, true, sh.cand);
          found = collect(alive, n_a, n_a + n_c, found, width, false,
                          sh.cand);
        }
        __syncwarp();
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        float ab = 0.f;
        int v = 0, e = 0;
        if (lane < found) {
          v = sh.cand[lane];
          if (v >= 0) {
            e = order[v];
            b = sbox[v];
            ab = sarea[v];
          } else {
            e = ~v;
            b = boxes[e];
            ab = box_area(b);
          }
          sh.kbox[lane] = b;
          sh.karea[lane] = ab;
        }
        __syncwarp();
        unsigned row = 0;                     // bit j: cand j overlaps mine
        for (int j = 0; j < lane && j < found; ++j)
          if (overlaps(sh.kbox[j], sh.karea[j], b, ab, iou_thr))
            row |= 1u << j;
        unsigned kept = 0;
        for (int j = 0; j < found; ++j)
          if ((__shfl_sync(kFull, row, j) & kept) == 0) kept |= 1u << j;
        const int count = sh.count;
        const unsigned below = (1u << lane) - 1u;
        const int pos = count + __popc(kept & below);
        const bool mine = lane < found && ((kept >> lane) & 1u) && pos < M;
        if (mine) {
          keep_idx[pos] = e;
          keep_valid[pos] = 1;
        }
        const unsigned commit = __ballot_sync(kFull, mine);
        // every candidate ends at -1e10: kept (retired) or suppressed by a
        // kept one; its position dies, and below -1e10 it joins the tier
        if (lane < found && v >= 0) {
          atomicAnd(&alive[v >> 5], ~(1u << (v & 31)));
          if (exotic) atomicOr(&tier[e >> 5], 1u << (e & 31));
        }
        __syncwarp();
        if (mine) {                           // compact the kept boxes
          const int r = __popc(commit & below);
          sh.kbox[r] = b;
          sh.karea[r] = ab;
        }
        if (lane == 0) {
          sh.cursor = cursor;
          sh.ncand = found;
          sh.nkept = __popc(commit);
          sh.count = count + __popc(commit);
        }
      }
      __syncthreads();                        // candidates, kept, count
      if (sh.ncand == 0) break;               // no live score is left
      ++nstep;
      if (sh.count >= M) break;               // the budget is full
      // mask the later alive positions that a kept box overlaps (below
      // -1e10 every box outside the tier; a dead one joins it)
      const int lo = exotic ? 0 : sh.cursor, hi = n;
      const int nk = sh.nkept;
      for (int w = (lo >> 5) + warp; 32 * w < hi; w += nwarps) {
        const unsigned word = alive[w];
        if (!word) continue;
        const int q = 32 * w + lane;
        bool kill = false;
        if ((word >> lane) & 1u) {
          const float4 b = sbox[q];
          const float ab = sarea[q];
          for (int r = 0; r < nk && !kill; ++r)
            kill = overlaps(sh.kbox[r], sh.karea[r], b, ab, iou_thr);
        }
        const unsigned dead = __ballot_sync(kFull, kill);
        if (lane == 0 && dead) alive[w] = word & ~dead;
        if (exotic && kill) {
          const int e = order[q];
          atomicOr(&tier[e >> 5], 1u << (e & 31));
        }
      }
      __syncthreads();                        // the alive bits
    }
  }
  // every slot past the last kept box: index 0, not valid
  const int count = sh.count;
  for (int i = count + tid; i < M; i += T) {
    keep_idx[i] = 0;
    keep_valid[i] = 0;
  }
  if (tid == 0) a.steps[p] = nstep;
}

}  // namespace

// The largest K the kernel takes.
extern "C" int dtt_nms_max_boxes() { return kMaxK; }

// boxes: (P, K, 4) float32; scores: (P, K) float32; valid: (P, K) bytes
// 0/1 or null; keep_idx: (P, M) int64; keep_valid: (P, M) bytes; steps:
// (P,) int32, the dependent steps each problem ran. 1 <= K <= kMaxK,
// M >= 1, select_block >= 1 (taken 32 at a time past 32). `total_order`
// 1 ranks +0.0 above -0.0 (nms_padded_fast's lax.top_k), 0 ties them
// (nms_padded's argmax). `smem` (dynamic
// shared bytes a block), `stride` and `scratch` come from nms_layout: with
// `scratch` null the sorted boxes sit in shared memory, otherwise in
// `scratch`, `stride` bytes a problem. Returns a cudaError_t (0 =
// launched).
extern "C" int dtt_nms_select(const void* boxes, const void* scores,
                              const void* valid, void* keep_idx,
                              void* keep_valid, void* steps, int P, int K,
                              int M, int select_block, float iou_threshold,
                              float score_threshold, int total_order,
                              int smem, int64_t stride, void* scratch,
                              int device, void* stream) {
  if (P < 1 || K < 1 || K > kMaxK || M < 1 || select_block < 1)
    return (int)cudaErrorInvalidValue;
  const bool ok = scratch ? stride >= staged_bytes(K) && stride % 16 == 0 &&
                                smem >= bit_bytes(K)
                          : smem >= staged_bytes(K) + bit_bytes(K);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = K >= kMaxThreads ? kMaxThreads : ((K + 31) / 32) * 32;
  void (*kernel)(Args) =
      scratch ? nms_walk_kernel<false> : nms_walk_kernel<true>;
  // past 48 KB with the static part only by this opt-in
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.boxes = static_cast<const float4*>(boxes);
  a.scores = static_cast<const float*>(scores);
  a.valid = static_cast<const uint8_t*>(valid);
  a.keep_idx = static_cast<int64_t*>(keep_idx);
  a.keep_valid = static_cast<uint8_t*>(keep_valid);
  a.steps = static_cast<int*>(steps);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.stride = stride;
  a.K = K;
  a.M = M;
  a.width = select_block < kWidth ? select_block : kWidth;
  a.iou_thr = iou_threshold;
  a.score_thr = score_threshold;
  a.total = total_order != 0;
  kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
