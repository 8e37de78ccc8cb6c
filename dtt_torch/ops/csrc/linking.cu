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
//     maximum, with link = (p_t[i] + p_{t+1}[j]) + W_t[i][j] where slot j of
//     frame t+1 is live or virtual, else kNeg, and W_t[i][j] = w *
//     IoU(tracked_t[i], box_{t+1}[j]);
//   * the path ends at the first argmax of v_{T-1} and is walked back by
//     the backpointers; its mean score is v_{T-1}[end] / max(T - 1, 1); the
//     tube is ok iff some slot was live and the mean is > -5e8;
//   * if the tube is ok it claims the path's live slots; the boost is the
//     mean of the k largest of the T frames' claimed scores (-inf where a
//     frame claims none; non-finite ones count 0), k = ceil(count / 2)
//     (mean_top_half), count (mean) or 1 (max), at least 1; each claimed
//     slot is rescored to max(score, boost).
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
// Bound: the inputs are read once and the outputs written once (42 bytes a
// slot, 13 + 8T a tube), ~0.14 us at the card's memory rate for 30
// classes of 16 frames of 20 slots; the work is the IoU and its weight once
// a pair (i, j) of consecutive frames a class and the link and candidate
// once a pair a tube, ~0.26 us of the float32 rate there at 20 tubes. What
// the card cannot avoid is the chain: tubes claim in turn and, within a
// tube, the frames are a max-plus recurrence, so a class is K (T - 1)
// dependent frame steps and K T dependent backtrack steps. Each frame step
// is N candidates a slot, ranked in turn by one warp: about 5 instructions
// a candidate, ~500 SM cycles a step at N = 20 (tools/link_split_torch.py).
//
// Design: a block of kThreads a class.
//   1. Staging, every warp: p (a live slot's score, kNeg, 0 at slot 0 of a
//      frame with no live slot), the live slots as bit words (a ballot a
//      word of 32 slots a frame), rescored = score and det_in_tube = 0 out;
//      then W_t[j][i] = w IoU(tracked_t[i], box_{t+1}[j]) once a class (no
//      tube changes it) and the plain form's link_t[j][i] = eff_{t+1}[j] ?
//      (p_t[i] + p_{t+1}[j]) + W_t[j][i] : kNeg, i fastest, rows of a
//      stride of 4 (mod 8) floats, so that a lane reads four i of its row j
//      in one 16-byte load and eight lanes' loads fall in distinct banks.
//      A block vote decides whether the class is tame (every valid score
//      and W within +-kTame): then no candidate can be infinite or NaN,
//      and one compare ranks it (the exact rule on every class took
//      12-16% longer at T = 8, 16 and 300; PERF.md §6, PR 15).
//   2. The tubes in turn, two block barriers a tube and none a frame. Warp
//      0 alone links tube k: lane j reads v_t[i] (broadcast) and
//      link_t[j][i] four i at a time and keeps the first maximum of v_t[i] +
//      link_t[j][i] in four accumulators joined in index order (a later i
//      wins only strictly above); a tame class needs one compare and two
//      selects a candidate, any other the exact rule (a NaN above every
//      number, the first NaN, as jnp.argmax) and a mask of the padding.
//      Lanes stride over j past 32 slots. v of the next frame goes to a
//      second buffer, one __syncwarp a frame; byte backpointers where N <=
//      kNarrowBack. The path's end is one REDUX max over order keys and one
//      REDUX min over slots, the backtrack runs on lane 0, the claim on
//      lanes striding over the frames: it clears the live bits, sets p,
//      marks det_idx as ~slot and leaves the claimed slots in `path`.
//      Meanwhile another warp boosts tube k-1 (each slot is claimed at most
//      once and its boost needs only its own tube's claims): it ranks the
//      claimed scores (a score a lane to 32, else a radix select on order
//      keys, a NaN below every number, as in a stable descending sort's
//      top k it never displaces one), sums the top k in double, restores
//      det_idx and rescores. After the barrier every warp relinks what
//      tube k claimed: rows and columns of the two frame pairs around each
//      claimed slot, from p, the live words and W, in the same operations.
// One warp a tube was kept: two or four warps over parts of i, joined a
// frame by a named barrier and an exchange of partial maxima, lost at T =
// 16 (the join cost ~200 cycles a frame) though they won ~10% at T = 300
// (PERF.md §6).
//
// NaN: a NaN ranks above every number and the first NaN wins, so every
// backpointer and every path slot lies in [0, N). For T > 1 a live NaN
// score makes every path's score NaN and so every tube not ok (at T = 1 a
// tube claims one slot), so where a NaN claimed score would rank in the
// boost never matters.
//
// Layout (link_layout in dtt_torch/eval/linking.py names it, from the same
// sizes: dtt_link_array_bytes): W and the links ((T-1) frames of N rows
// each), the claimed scores (a score and a slot a frame, a warp), p (T
// frames of N rounded up to 4), the backpointers ((T-1) N, a byte each to
// kNarrowBack slots, else int32), the live words (T ceil(N/32)), the path
// (T, as the backpointers), v (two frames) and, where the links sit in
// scratch, a ring of kRing of their frames with an mbarrier each, each
// padded to 16 bytes. They leave shared memory in that order until the
// rest fits a block's 227 KB beside kStaticSmem: W (read only when
// relinking) first, the links next (through the ring they cost the chain
// a wait a frame), while what the chain reads most often stays (v every
// candidate, the backpointers in the backtrack's dependent loads). Those
// that leave sit in a scratch buffer of the wrapper's, one slice a class
// (at N = 20 W leaves from T = 69 on, the links from T = 128). Where the
// links sit in scratch, lane 0 copies link frame t+kRing-1 into the ring
// by one bulk copy (TMA) while the warp links frame t, and the warp waits
// on the frame's mbarrier (if the ring does not fit either, as at N =
// 300, the chain reads the links from scratch). Reading them from scratch
// at N = 20 too, four i a load one quad ahead, took 23% longer than the
// ring at T = 300 and 72% at T = 1,400, and with frame t+1 prefetched to
// L1 30% and 39% (PERF.md §6, PR 15), so the ring stays. The kernel
// allocates nothing and writes every output.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr float kNeg = -1e9f;      // dtt's _NEG
constexpr int kThreads = 512;      // a block: every warp stages and boosts
constexpr int kWarps = kThreads / 32;
constexpr int kNarrowBack = 255;   // slots up to which backpointers are bytes
                                   // (255 marks a frame no tube claimed)
constexpr int kSlotBytes = 8;      // v's bytes a slot (two frames)
constexpr int kArrays = 9;
constexpr int kRing = 4;           // link frames a ring holds
// a class is tame when every valid score and w IoU is within +-kTame and
// T <= kTameFrames: then every link is within 3 kTame + 1e9 and |v| <
// kTameFrames (3 kTame + 1e9) < FLT_MAX, so no candidate is infinite or
// NaN
constexpr float kTame = 1e30f;
constexpr int kTameFrames = 100000;
constexpr int kSmemLimit = 232448;  // a block's shared memory (227 KB)
constexpr int kStaticSmem = 0;     // bytes link_layout leaves for statics
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnclaimed = -1;     // as a backpointer: all ones

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
  int T, N, K, boost, n_shared, ring;
  float w;
};

__host__ __device__ inline int64_t pad16(int64_t b) { return (b + 15) & ~15; }
__host__ __device__ inline int back_bytes(int n) {
  return n <= kNarrowBack ? 1 : 4;
}
// the slots of v and p rounded up to 4, for 16-byte loads
__host__ __device__ inline int slots4(int n) { return (n + 3) & ~3; }
// a link frame's row stride: >= N, 4 (mod 8) floats, so that 8 lanes'
// 16-byte loads of 8 rows fall in distinct banks
__host__ __device__ inline int row_stride(int n) { return slots4(n) | 4; }
// a link frame's floats
__host__ __device__ inline int64_t frame_floats(int n) {
  return (int64_t)n * row_stride(n);
}

// The bytes of each working array, in the order they leave shared memory;
// the ring (its frames, then an mbarrier a frame) only where the links sit
// in scratch (`ring`).
__host__ __device__ inline void array_bytes(int t, int n, int ring,
                                            int64_t* b) {
  const int64_t t1 = t - 1, bb = back_bytes(n), fs = frame_floats(n);
  b[0] = 4 * t1 * fs;                                 // link weights
  b[1] = 4 * t1 * fs;                                 // links
  b[2] = pad16(8 * (int64_t)kWarps * t);              // claimed scores
  b[3] = 4 * (int64_t)t * slots4(n);                  // p
  b[4] = pad16(bb * t1 * n);                          // backpointers
  b[5] = pad16(4 * (int64_t)t * ((n + 31) / 32));     // live words
  b[6] = pad16(bb * t);                               // path
  b[7] = (int64_t)kSlotBytes * slots4(n);             // v
  b[8] = ring ? 4 * kRing * fs + pad16(8 * kRing) : 0;  // link ring
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
// kExact false: neither is NaN.
template <bool kExact = true>
__device__ __forceinline__ void take_first_max(float& v, int& i, float u,
                                               int k) {
  bool take;
  if (kExact) {
    const bool un = isnan(u), vn = isnan(v);
    const bool above = un ? !vn : !vn && u > v;
    const bool tie = un ? vn : u == v;
    take = above | (tie & (k < i));
  } else {
    take = (u > v) | ((u == v) & (k < i));
  }
  v = take ? u : v;
  i = take ? k : i;
}

// take_first_max where k is above every index (v, i) has seen: u wins only
// strictly above v (a NaN v stays; a NaN u beats a number); kExact false:
// neither is NaN.
template <bool kExact>
__device__ __forceinline__ void take_later(float& v, int& i, float u, int k,
                                           bool in = true) {
  const bool take = kExact ? in & !(u <= v) & (v == v) : u > v;
  v = take ? u : v;
  i = take ? k : i;
}

// An unsigned key in the order take_first_max ranks floats (+0 for -0, a
// NaN above every number); `nan_low`: a NaN below every number instead.
__device__ __forceinline__ unsigned order_key(float x, bool nan_low = false) {
  if (isnan(x)) return nan_low ? 0x007fffffu : 0xffffffffu;  // as -inf
  const unsigned b = __float_as_uint(x == 0.f ? 0.f : x);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The first maximum of slot j's candidates v_t[i] + link_t[j][i] over i
// in [0, n4) (n rounded up to 4), four at a time by 16-byte loads of v_t
// and link_t's row j, each quad's loads issued before the quad ahead of it
// is ranked, in four accumulators joined in index order. kExact: NaN
// candidates and masked padding slots (>= n); else no candidate is NaN or
// infinite (the class is tame) and a padding slot's (v = -inf, link = 0)
// never wins.
template <bool kExact>
__device__ __forceinline__ void best_link(const float* v, const float* lrow,
                                          int n, int n4, float& best,
                                          int& arg) {
  float bv[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int bi[4] = {0, 1, 2, 3};                  // = their first candidates
  float4 v4 = *reinterpret_cast<const float4*>(v);
  float4 l4 = *reinterpret_cast<const float4*>(lrow);
  for (int i = 0; i < n4; i += 4) {
    const int ahead = min(i + 4, n4 - 4);    // the last quad again
    const float4 v4n = *reinterpret_cast<const float4*>(v + ahead);
    const float4 l4n = *reinterpret_cast<const float4*>(lrow + ahead);
    take_later<kExact>(bv[0], bi[0], __fadd_rn(v4.x, l4.x), i, i < n);
    take_later<kExact>(bv[1], bi[1], __fadd_rn(v4.y, l4.y), i + 1, i + 1 < n);
    take_later<kExact>(bv[2], bi[2], __fadd_rn(v4.z, l4.z), i + 2, i + 2 < n);
    take_later<kExact>(bv[3], bi[3], __fadd_rn(v4.w, l4.w), i + 3, i + 3 < n);
    v4 = v4n;
    l4 = l4n;
  }
  take_first_max<kExact>(bv[0], bi[0], bv[1], bi[1]);
  take_first_max<kExact>(bv[2], bi[2], bv[3], bi[3]);
  take_first_max<kExact>(bv[0], bi[0], bv[2], bi[2]);
  best = bv[0];
  arg = bi[0];
}

// The first maximum over the warp's (v, i), each lane's i ascending and
// distinct across lanes; every lane gets it.
__device__ __forceinline__ void warp_first_max(float& v, int& i) {
  const unsigned top = __reduce_max_sync(kFull, order_key(v));
  i = (int)__reduce_min_sync(kFull, order_key(v) == top ? (unsigned)i
                                                        : 0xffffffffu);
  v = __shfl_sync(kFull, v, i & 31);
}

__device__ __forceinline__ bool frame_live(const unsigned* live, int t,
                                           int nw) {
  unsigned any = 0;
#pragma unroll 1
  for (int w = 0; w < nw; ++w) any |= live[(int64_t)t * nw + w];
  return any != 0;
}

// The links' ring: kRing frames in shared memory, each filled from scratch
// by one bulk copy (TMA) that completes on the frame's mbarrier.
struct Ring {
  float* frames;                   // null: the links are read where they sit
  uint64_t* bars;
  int64_t fs;                      // a link frame's floats
  unsigned phases;                 // the parity each slot waits for next
};

__device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < kRing; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        smem_u32(r.bars + s)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Lane 0: link frame f into its slot, if there is a frame f. The slot's
// last frame has been read (a barrier of the readers came between).
__device__ __forceinline__ void ring_load(const Ring& r, const float* L,
                                          int f, int frames, int lane) {
  if (lane != 0 || f >= frames) return;
  const unsigned bar = smem_u32(r.bars + f % kRing);
  const unsigned bytes = static_cast<unsigned>(4 * r.fs);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(r.frames + (f % kRing) * r.fs)),
      "l"(__cvta_generic_to_global(L + f * r.fs)), "r"(bytes), "r"(bar)
      : "memory");
}

// Every lane: wait for frame f's copy; its slot in the ring.
__device__ __forceinline__ const float* ring_wait(Ring& r, int f) {
  const int s = f % kRing;
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}" ::"r"(smem_u32(r.bars + s)),
      "r"((r.phases >> s) & 1u)
      : "memory");
  r.phases ^= 1u << s;
  return r.frames + s * r.fs;
}

// A class's working arrays, where link_kernel placed them.
template <typename Back>
struct Work {
  const float* W;                  // w IoU, as the links
  float* link;                     // link_t[j][i], frames of N rows of S
  float* p;                        // p_t[i], frames of N4
  Back* back;
  unsigned* live;
  Back* path;
  float* v;                        // v of frames t and t+1
  Ring ring;
};

// link_t[j][i] as the plain form has it: (p_t[i] + p_{t+1}[j]) + W_t[j][i]
// where slot j of frame t+1 is live or virtual (its frame has no live slot
// and j = 0), else kNeg; 0 in the padding (i >= N).
template <typename Back>
__device__ __forceinline__ float link_value(const Args& a, const Work<Back>& m,
                                            int t, int j, int i) {
  const int N = a.N, N4 = slots4(N), NW = (N + 31) >> 5;
  if (i >= N) return 0.f;
  const unsigned* words = m.live + (int64_t)(t + 1) * NW;
  const bool eff = (words[j >> 5] >> (j & 31)) & 1 ||
                   (j == 0 && !frame_live(m.live, t + 1, NW));
  return eff ? __fadd_rn(__fadd_rn(m.p[(int64_t)t * N4 + i],
                                   m.p[(int64_t)(t + 1) * N4 + j]),
                         m.W[t * frame_floats(N) + (int64_t)j * row_stride(N) +
                             i])
             : kNeg;
}

// Tube k of a class on warp 0: the forward pass over the links, the path's
// end, its mean, the backtrack and the claim, which clears the live bits,
// sets p (kNeg, or 0 at slot 0 of a frame it empties), marks det_idx as
// ~slot and leaves in `path` the slot each frame gave the tube, or
// kUnclaimed. kExact: the class is not tame (a NaN or an infinity may
// arise), every candidate is ranked by the exact rule.
template <typename Back, bool kExact>
__device__ __forceinline__ void link_tube(const Args& a, Work<Back>& m,
                                          int64_t c, int k, int lane) {
  const int T = a.T, N = a.N, K = a.K, NW = (N + 31) >> 5;
  const int N4 = slots4(N), S = row_stride(N);
  const int64_t fs = frame_floats(N);
  const bool ring = m.ring.frames != nullptr;
  if (ring)                                  // the first frames on the way
    for (int f = 0; f < kRing - 1; ++f)
      ring_load(m.ring, m.link, f, T - 1, lane);
  unsigned any = 0;                          // a live slot anywhere
  for (int q = lane; q < T * NW; q += 32) any |= m.live[q];
  const bool any_left = __any_sync(kFull, any != 0);
  const bool live_0 = frame_live(m.live, 0, NW);
  for (int j = lane; j < N4; j += 32) {      // v_0 (padding: -inf, twice)
    const bool eff =
        j < N && ((m.live[j >> 5] >> (j & 31)) & 1 || (!live_0 && j == 0));
    const float v0 = j < N ? (eff ? 0.f : kNeg) : -INFINITY;
    m.v[j] = v0;
    m.v[N4 + j] = v0;
  }
  __syncwarp();
  for (int t = 0; t + 1 < T; ++t) {
    const float* cv = m.v + N4 * (t & 1);            // v_t
    float* nv = m.v + N4 * ((t + 1) & 1);            // v_t+1
    if (ring) ring_load(m.ring, m.link, t + kRing - 1, T - 1, lane);
    const float* lt = ring ? ring_wait(m.ring, t) : m.link + t * fs;
    for (int j0 = 0; j0 < N; j0 += 32) {
      const int j = j0 + lane;
      float best;
      int arg;
      best_link<kExact>(cv, lt + (int64_t)min(j, N - 1) * S, N, N4, best,
                        arg);
      if (j < N) {
        nv[j] = best;
        m.back[(int64_t)t * N + j] = (Back)arg;
      }
    }
    __syncwarp();
  }
  const float* fin = m.v + N4 * ((T - 1) & 1);
  float best = -INFINITY;
  int arg = INT_MAX;
  for (int j = lane; j < N; j += 32) take_first_max(best, arg, fin[j], j);
  warp_first_max(best, arg);
  const float mean = __fdiv_rn(best, (float)(T > 1 ? T - 1 : 1));
  const bool ok = any_left && mean > kNeg / 2;
  if (lane == 0) {
    a.tube_valid[c * K + k] = ok;
    a.tube_score[c * K + k] = mean;
    int j = arg;
    m.path[T - 1] = (Back)j;
    for (int t = T - 1; t > 0; --t) {
      j = m.back[(int64_t)(t - 1) * N + j];
      m.path[t - 1] = (Back)j;
    }
  }
  __syncwarp();
  int64_t* row = a.det_idx + (c * K + k) * T;
  for (int t = lane; t < T; t += 32) {
    const int j = m.path[t];
    unsigned* word = m.live + (int64_t)t * NW + (j >> 5);
    const unsigned bit = 1u << (j & 31);
    const bool cl = ok && (*word & bit);
    if (cl) {
      *word &= ~bit;
      m.p[(int64_t)t * N4 + j] = kNeg;
      if (!frame_live(m.live, t, NW)) m.p[(int64_t)t * N4] = 0.f;
    }
    row[t] = cl ? ~(int64_t)j : (int64_t)j;          // ~slot: claimed
    m.path[t] = cl ? (Back)j : (Back)kUnclaimed;
  }
  __syncwarp();
}

// The links a tube's claims changed, on every warp: a frame t with a claim
// changes row j of pair t-1 (slot j of frame t no longer live) and column
// j of pair t (its p), and where frame t empties, row 0 of pair t-1 and
// column 0 of pair t (slot 0 virtual). Writers of one link compute it from
// the same state, so they write the same bits.
template <typename Back>
__device__ __forceinline__ void relink(const Args& a, Work<Back>& m, int warp,
                                       int lane) {
  const int T = a.T, N = a.N, NW = (N + 31) >> 5, S = row_stride(N);
  const int64_t fs = frame_floats(N);
  for (int t = warp; t < T; t += kWarps) {
    const Back claimed = m.path[t];
    if (claimed == (Back)kUnclaimed) continue;
    const int slots[2] = {(int)claimed, 0};
    const int lines = frame_live(m.live, t, NW) || claimed == 0 ? 1 : 2;
    for (int s = 0; s < lines; ++s) {
      for (int x = lane; x < N; x += 32) {
        if (t > 0)                           // row slots[s] of pair t-1
          m.link[(t - 1) * fs + (int64_t)slots[s] * S + x] =
              link_value(a, m, t - 1, slots[s], x);
        if (t + 1 < T)                       // column slots[s] of pair t
          m.link[t * fs + (int64_t)x * S + slots[s]] =
              link_value(a, m, t, x, slots[s]);
      }
    }
  }
}

// A lane's share of the sum of the k largest of the `count` scores in cv
// (a non-finite one adds 0): the k-th largest found by a radix select on
// order keys (32 ballot counts; a NaN below every number: as in a stable
// descending sort's top k it never displaces one), then those above it and
// as many at it as are left over.
__device__ double top_sum(const float* cv, int count, int k, int lane) {
  unsigned kth = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned trial = kth | (1u << bit);
    unsigned n_at = 0;
    for (int q = lane; q < count; q += 32)
      n_at += order_key(cv[q], true) >= trial;
    if (__reduce_add_sync(kFull, n_at) >= (unsigned)k) kth = trial;
  }
  double part = 0.0;                          // a non-finite one adds 0
  unsigned above = 0;
  for (int q = lane; q < count; q += 32) {
    const float x = cv[q];
    if (order_key(x, true) > kth) {
      ++above;
      if (isfinite(x)) part += x;
    }
  }
  above = __reduce_add_sync(kFull, above);
  const float at = key_value(kth);
  if (lane == 0 && isfinite(at)) part += (double)(k - (int)above) * at;
  return part;
}

// The boost of tube k and the rescoring of its claims, on one warp: its
// claimed scores compacted and ranked (a score a lane up to 32, as a
// stable descending sort places them; past that top_sum), the top k
// summed in double in a fixed order, det_idx restored.
__device__ void boost_tube(const Args& a, int64_t c, int k, float* cv,
                           unsigned* ce, int lane) {
  const int T = a.T, N = a.N;
  const int64_t tn = (int64_t)T * N;
  const float* scores = a.scores + c * tn;
  int64_t* row = a.det_idx + (c * a.K + k) * T;
  int count = 0;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const int64_t code = t < T ? row[t] : 0;
    const bool cl = code < 0;
    const unsigned bal = __ballot_sync(kFull, cl);
    if (cl) {
      const int j = (int)~code;
      const int pos = count + __popc(bal & ((1u << lane) - 1));
      const unsigned e = (unsigned)t * (unsigned)N + (unsigned)j;
      row[t] = j;
      cv[pos] = __ldg(scores + e);
      ce[pos] = e;
    }
    count += __popc(bal);
  }
  if (count == 0) return;
  __syncwarp();
  const int k_stat = a.boost == 0   ? (count + 1) / 2
                     : a.boost == 1 ? count
                                    : 1;
  double part = 0.0;                          // a non-finite one adds 0
  if (count <= 32) {                          // a score a lane, ranked
    const float x = lane < count ? cv[lane] : -INFINITY;
    int rank = 0;                             // its place in a stable sort
    for (int s = 0; s < count; ++s) {
      const float y = __shfl_sync(kFull, x, s);
      rank += (y > x) | ((y == x) & (s < lane));
    }
    if (lane < count && isfinite(x) && rank < k_stat) part = x;
  } else {
    part = top_sum(cv, count, k_stat, lane);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  part = __shfl_sync(kFull, part, 0);
  const float boost = __fdiv_rn((float)part, (float)k_stat);
  float* rescored = a.rescored + c * tn;
  uint8_t* in_tube = a.in_tube + c * tn;
  for (int q = lane; q < count; q += 32) {
    const float r = cv[q];
    rescored[ce[q]] = (isnan(r) || r > boost) ? r : boost;
    in_tube[ce[q]] = 1;
  }
  __syncwarp();
}

// the warp that boosts tube k (never warp 0, the chain's)
__device__ __forceinline__ int boost_warp(int k) {
  return 1 + k % (kWarps - 1);
}

// Back the backpointers' type; kShared: every array in shared memory (else
// the links, at least, sit in scratch).
template <typename Back, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) link_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, N = a.N, K = a.K, NW = (N + 31) >> 5;
  const int N4 = slots4(N), S = row_stride(N);
  const int64_t c = blockIdx.x, tn = (int64_t)T * N, fs = frame_floats(N);
  const float4* boxes = a.boxes + c * tn;
  const float4* tracked = a.tracked + c * tn;
  const float* scores = a.scores + c * tn;
  const uint8_t* valid = a.valid + c * tn;

  // the arrays that left shared memory sit in this class's scratch slice
  unsigned char* ptr[kArrays];
  {
    int64_t bytes[kArrays], on_chip = 0, off_chip = 0;
    array_bytes(T, N, a.ring, bytes);
    unsigned char* own = a.scratch ? a.scratch + c * a.stride : nullptr;
    for (int k = 0; k < kArrays; ++k) {
      if (kShared || k >= kArrays - a.n_shared) {
        ptr[k] = smem + on_chip;
        on_chip += bytes[k];
      } else {
        ptr[k] = own + off_chip;
        off_chip += bytes[k];
      }
    }
  }
  float* W = reinterpret_cast<float*>(ptr[0]);
  float* claimed = reinterpret_cast<float*>(ptr[2]);
  float* frames = reinterpret_cast<float*>(ptr[8]);
  Work<Back> m = {W,
                  reinterpret_cast<float*>(ptr[1]),
                  reinterpret_cast<float*>(ptr[3]),
                  reinterpret_cast<Back*>(ptr[4]),
                  reinterpret_cast<unsigned*>(ptr[5]),
                  reinterpret_cast<Back*>(ptr[6]),
                  reinterpret_cast<float*>(ptr[7]),
                  {!kShared && a.ring ? frames : nullptr,
                   reinterpret_cast<uint64_t*>(frames + kRing * fs), fs, 0u}};

  // 1. Staging, a frame a warp: p (a live slot's score, kNeg, 0 at slot 0
  //    of a frame with none live, 0 in the padding), the live words, and
  //    rescored = score, det_in_tube = 0 out; then the links.
  for (int64_t b = 128 * tid; b < 16 * tn; b += 128 * kThreads) {
    asm volatile("prefetch.L2 [%0];" ::"l"(
        reinterpret_cast<const char*>(boxes) + b));
    asm volatile("prefetch.L2 [%0];" ::"l"(
        reinterpret_cast<const char*>(tracked) + b));
  }
  bool tame = T <= kTameFrames;        // no NaN or infinity can arise
  for (int t = warp; t < T; t += kWarps) {
    bool any = false;
    for (int j0 = 0; j0 < N4; j0 += 32) {
      const int j = j0 + lane;
      const int64_t e = (int64_t)t * N + j;
      const bool in = j < N;
      const bool v = in && __ldg(valid + e);
      const float s = in ? __ldg(scores + e) : 0.f;
      const unsigned bits = __ballot_sync(kFull, v);
      if (lane == 0) m.live[(int64_t)t * NW + (j0 >> 5)] = bits;
      any |= bits != 0;
      if (in) {
        a.rescored[c * tn + e] = s;
        a.in_tube[c * tn + e] = 0;
      }
      if (j < N4) m.p[(int64_t)t * N4 + j] = v ? s : in ? kNeg : 0.f;
      tame &= !v || fabsf(s) <= kTame;
    }
    __syncwarp();
    if (!any && lane == 0) m.p[(int64_t)t * N4] = 0.f;
  }
  __syncthreads();
  // W_t[j][i] = w IoU(tracked_t[i], box_{t+1}[j]) and link_t[j][i], a
  // warp a row (t, j) and 32 of its i, four rows in flight
  const int nch = (S + 31) / 32, items = (T - 1) * N * nch;
  for (int it0 = warp; it0 < items; it0 += 4 * kWarps) {
    float4 b[4], q[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int it = min(it0 + u * kWarps, items - 1);
      const int r = it / nch, i = (it - r * nch) * 32 + lane;
      const int t = r / N, j = r - t * N;
      b[u] = __ldg(boxes + (int64_t)(t + 1) * N + j);
      q[u] = __ldg(tracked + (int64_t)t * N + min(i, N - 1));
      at[u] = i < S && it0 + u * kWarps < items ? t * fs + j * S + i : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (at[u] < 0) continue;
      const int t = at[u] / fs, j = (at[u] - t * fs) / S;
      const int i = at[u] - t * fs - j * S;
      const float x = i < N ? __fmul_rn(a.w, iou(q[u], box_area(q[u]), b[u],
                                                 box_area(b[u])))
                            : 0.f;          // the padding
      W[at[u]] = x;
      tame &= fabsf(x) <= kTame;
      m.link[at[u]] = link_value(a, m, t, j, i);
    }
  }
  if (!kShared) asm volatile("fence.proxy.async.global;" ::: "memory");
  tame = __syncthreads_and(tame);

  // 2. The tubes, in turn: warp 0 links tube k while another warp boosts
  //    tube k-1; then every warp relinks what tube k claimed.
  if (warp == 0 && m.ring.frames && lane == 0) ring_init(m.ring);
  float* cv = claimed + (int64_t)2 * T * warp;        // claimed scores
  unsigned* ce = reinterpret_cast<unsigned*>(cv + T);  // and their slots
  for (int k = 0; k < K; ++k) {
    if (warp == 0) {
      __syncwarp();
      if (tame)
        link_tube<Back, false>(a, m, c, k, lane);
      else
        link_tube<Back, true>(a, m, c, k, lane);
    } else if (k > 0 && warp == boost_warp(k - 1)) {
      boost_tube(a, c, k - 1, cv, ce, lane);
    }
    __syncthreads();
    if (k + 1 < K) {
      relink(a, m, warp, lane);
      if (!kShared) asm volatile("fence.proxy.async.global;" ::: "memory");
      __syncthreads();
    }
  }
  if (warp == boost_warp(K - 1)) boost_tube(a, c, K - 1, cv, ce, lane);
}

using Kernel = void (*)(Args);

}  // namespace

// boxes, tracked: (C, T, N, 4) float32; scores: (C, T, N) float32; valid:
// (C, T, N) bytes 0/1; det_idx: (C, K, T) int64; tube_valid: (C, K) bytes;
// tube_score: (C, K) float32; rescored: (C, T, N) float32; in_tube: (C, T,
// N) bytes. T, N, K >= 1, T N and the links of a class < 2^31 each.
// `boost`: 0 mean_top_half, 1 mean, 2 max. `smem` (dynamic shared bytes a
// block), `n_shared` (how many of the arrays, from the last, sit in shared
// memory), `ring` (the links reach the chain through a ring in shared
// memory), `stride` and `scratch` come from link_layout: with every array
// shared `scratch` may be null, otherwise the rest sits in `scratch`,
// `stride` bytes a class. Returns a cudaError_t (0 = launched).
extern "C" int dtt_link_tubes(const void* boxes, const void* tracked,
                              const void* scores, const void* valid,
                              void* det_idx, void* tube_valid,
                              void* tube_score, void* rescored, void* in_tube,
                              int C, int T, int N, int K,
                              float link_iou_weight, int boost, int smem,
                              int n_shared, int ring, int64_t stride,
                              void* scratch, int device, void* stream) {
  if (C < 1 || T < 1 || N < 1 || K < 1 || boost < 0 || boost > 2 ||
      n_shared < 0 || n_shared > kArrays || (int64_t)T * N >= INT_MAX ||
      (int64_t)T * frame_floats(N) >= INT_MAX ||
      (ring && (n_shared < 1 || n_shared == kArrays)))
    return (int)cudaErrorInvalidValue;
  int64_t bytes[kArrays], on_chip = 0, off_chip = 0;
  array_bytes(T, N, ring, bytes);
  for (int k = 0; k < kArrays; ++k)
    (k >= kArrays - n_shared ? on_chip : off_chip) += bytes[k];
  if (smem < on_chip || on_chip + kStaticSmem > kSmemLimit ||
      (off_chip && (!scratch || stride < off_chip || stride % 16)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool shared = n_shared == kArrays;
  const Kernel kernel =
      N <= kNarrowBack
          ? (shared ? link_kernel<uint8_t, true> : link_kernel<uint8_t, false>)
          : (shared ? link_kernel<int32_t, true>
                    : link_kernel<int32_t, false>);
  // past 48 KB only by this opt-in
  err = cudaFuncSetAttribute(kernel,
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
  a.ring = ring;
  a.w = link_iou_weight;
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The bytes of each of dtt_link_tubes's working arrays for T frames of N
// slots, with the links' ring or without (`ring`), into out[0 ..
// kArrays), in the order they leave shared memory: link_layout plans with
// the same sizes. Returns kArrays, or -1 for T or N < 1.
extern "C" int dtt_link_array_bytes(int T, int N, int ring, int64_t* out) {
  if (T < 1 || N < 1) return -1;
  array_bytes(T, N, ring, out);
  return kArrays;
}
