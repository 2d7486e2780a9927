// Grid-Potts colour-phase kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of lp_mp_tpu/ops/pallas_grid.py:
//   grid_phase_kernel<false, .>  <- _phase_kernel_v2 (:161, wrapper phase_update_v2; K2),
//                                   and the v1 _phase_kernel (:72, K5: phase_update_v1 in
//                                   ops/grid_kernels.py decodes its parameters and launches K2)
//   grid_round_kernel<NR, false> <- _round_kernel_v2 (:303, wrapper round_update_v2; K1)
//   grid_phase_kernel<true, .>   <- _phase_kernel_sharded (:443, wrapper phase_update_sharded; K4)
//   grid_round_kernel<NR, true>  <- _round_kernel_sharded (:536, wrapper round_update_sharded; K3)
//
// Dense layout, float32, labels outermost (see ops/grid_kernels.py):
//   u [L,H,W]; hm1/hm2 [L,H,W-1], the two slots of h-edge (r,c)-(r,c+1),
//   owned by (r,c) and (r,c+1); vm1/vm2 [L,H-1,W], the slots of v-edge
//   (r,c)-(r+1,c), owned by (r,c) and (r+1,c); hc [H,W-1]; vc [H-1,W].
//   Black cells have (r+c) even (colour 1), red cells odd (colour 2).
// Every slot has one owner cell, so a thread that updates a cell writes
// that cell's u and its 2-4 own slots, and every output element is written
// exactly once.  Outputs go to separate buffers (out of place).
//
// Sharded layout (one shard of parallel/grid.py): a window of n rows, global
// rows [row0, row0 + n) of an H-row grid, with every slot stored at its
// owner's row: u, hm1, hm2 as above; vm1 [L,n,W] row r holds the slot of the
// edge below r; vm2 [L,n,W] row r holds the slot of the edge above r; hc
// [n,W-1]; vc [n,W] row r is the cost of the edge below r.  Rows [-kSlab, 0)
// and [n, n + kSlab) come from two slabs of kSlab rows per label, the
// neighbour shards' boundary rows (copies, or views with their own label
// stride).  Global rows >= H are inert: they hold zeros, have no edges, and
// the kernels write zeros there, as they do into slots of absent edges.  The
// geometry (colour, degree, which edges exist) comes from the global row,
// never from the window's bounds.
//
// Both layouts go through the same kernel bodies: a `Grid` names each
// array's rows, and `row<kSharded>` finds window row r of an array (the dense
// vm2 is read with a shift of one row, since its row r-1 holds the slot that
// cell r owns).  So the sharded kernels round exactly like the dense ones,
// and a shard's result equals the matching rows of the dense result.
//
// What bounds them on the H100: device-memory bandwidth.  A phase reads and
// writes the five state arrays, and where a colour receives it also reads the
// two cost arrays: 167.86 MB at 1000x1000, L=4 (50.1 us at 3.35 TB/s), and
// 159.87 MB (47.7 us) for a phase in which nothing receives.  It does a few
// dozen flops per cell and label, far below the card's flop-per-byte balance.
//
// grid_phase_kernel: one colour phase, colours and `leave` taken at run time,
// one template for the dense grid (K2, K5) and a shard's window (K4), so a
// shard rounds exactly like the dense grid.  What held its first version
// (one thread per cell in 32 x 8 blocks) in the phases that receive to 49 %
// of the bound (K2, 102 us) and 30 % (K4, 169 us; phase_bench.py of this
// package on the H100), and what this design does about each:
//  - Half the lanes of every warp idled: colours alternate along a row, so
//    one lane in two took the receive branch.  Now a thread updates a
//    horizontal pair of cells, one of each colour, and every lane of a warp
//    does the same work.
//  - A runtime loop over the labels, with the receiving cell's min statistics
//    in a pass of their own: each label's loads waited for the last, and each
//    "other" slot was read twice.  Now, for L <= kPhaseRegLabels, the label
//    count is a template parameter: every value of the pair, the receiving
//    cell's four "other" slots included, is loaded before the first use (one
//    round trip to memory), the statistics come from registers, and the
//    compiled code has no loop and few branches (at L=4 with 8-byte pairs,
//    1095 instructions and 22 branches for K2, 1183 and 32 for K4, against
//    1409 and 61, 1916 and 97 before; cuobjdump -sass in phase_bench.py).
//    Other L take a generic path: statistics pass, then a label at a time;
//    no limit on L.
//  - Scalar 4-byte accesses only.  Now u, vm1 and vm2 move as 8-byte pairs
//    where W is even (rows of W floats stay 8-byte aligned); hm1, hm2 and
//    the costs, rows of W - 1 floats, stay scalar.
//  - K4 cost 40 % more than K2 on the same bytes: it used 96 registers
//    against K2's 64 (ptxas), so half the warps per SM (16 against 32 in
//    blocks of 256 threads), because the window-or-slab choice made for
//    every row pointer kept each pointer's label stride in registers.  Now a
//    thread's own row is always addressed in the window with the launch's
//    strides; only rows r - 1 and r + 1 (the receiving cell's vertical
//    neighbours and the cost above) may come from a slab.  K4 now uses 104
//    registers at L=4 against K2's 110 (ptxas): 16 warps per SM for both, in
//    blocks of 32 pairs x 4 rows.
// Tried and slower on the same card, and not kept: shared memory for the
// vertical neighbours' slots plus warp shuffles for the horizontal ones (more
// registers and a barrier); register caps below K2's count (spills); 8-row
// and 16-row blocks; streaming stores.  Every phase of K2 and K4 moves its
// bytes at 2.5-2.6 TB/s: K2's send-only phase, which reads no cost, is
// about 1 us faster than its phases that receive, not the 2.4 us its bytes
// would give.
//
// grid_round_kernel: NR full anisotropic rounds (red phase, black phase,
// repeated) in one launch, so the bytes per iteration fall by 2*NR.  A block
// writes a T_r x T_c tile of cells and loads it with a halo of P = 2*NR
// cells on every side (S_r x S_c = (T_r + 2P) x (T_c + 2P)) into shared
// memory, every edge slot at the cell that owns it, with the costs of each
// cell's right and lower edge.  It runs the P phases in place there with one
// __syncthreads() after each (in one phase only cells of one colour update,
// and no two of them share an edge, so in-place is race-free), then writes
// the T_r x T_c cells.  A cell's phase-k update reads its neighbours' slots
// from phase k-1, so phase k only updates the cells within P - k of the
// written tile: the ones the written tile still depends on; cells on the
// true grid edge lose nothing (missing edges do not exist).  In a shard,
// rows beyond the slabs load as absent: they lie more than P <= kSlab rows
// from the window, so nothing read from them reaches it.
// What bounds it: the 167.86 MB a launch must move at 1000x1000, L=4 (50.1
// us at 3.35 TB/s).  It does not reach that bound.  Against what held the
// first version (16 x 16 tiles) to 21 % of it:
//  - Tiles sized by the arithmetic: a cell costs (5L + 2) * 4 bytes (88 at
//    L=4) and two blocks share an SM's 228 KB.  Default at L=4, NR=2: T =
//    12 x 56, S = 20 x 64, 113 KB: 1.90x the written cells loaded and 1.32x
//    updated (the phases shrink), against 2.25x for both before.  The tile
//    narrows to 24 or 8 columns as L grows and takes one block per SM where
//    two do not fit (L = 32: T = 14 x 8); L above kMaxRoundLabels is
//    refused.  Tile origins sit on multiples of 4 columns.
//  - Copies by cp.async (cp_async.cuh) straight into shared memory, all in
//    flight together, with zero fill for absent cells and edges, and the
//    row bookkeeping done once per row for all labels; costs staged once.
//  - Colour-split planes: the cells of one colour in a tile row are
//    consecutive floats, and their neighbours sit at the same offsets in
//    the other colour's half, 16 banks away: no bank conflicts in the phases
//    or the write-out.  One thread per cell of a colour in a tile row (640
//    threads at L=4), streaming stores.
// On the H100 (round_tile_sweep.py) the copies are bound by requests in
// flight (4-byte copies: hm1, hm2 and hc rows have W - 1 floats, so their
// rows are not 16-byte aligned) and the phases by latency; the two blocks of
// an SM run in step, so neither hides the other.  Tried and slower: a
// persistent block per SM with two tile buffers; bulk copies (TMA) into
// padded rows plus an in-place rearrangement into colour order; two warp
// groups with their own buffers, one tile apart.
// Rounding: the products that feed an add go through __fmul_rn, which the
// compiler never contracts into an FMA, so both kernels round like the plain
// torch ops, one IEEE operation at a time.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kMaxRoundLabels = 32;
constexpr int kSlab = 4;  // slab rows per side; covers the round kernel's halo P <= 4
constexpr float kBig = 3e38f;
// Round kernel tiles.  An SM has 228 KB of shared memory and keeps 1 KB per
// block; a block may take 227 KB.
constexpr size_t kRoundSmemTwoBlocks = (228 * 1024 - 2 * 1024) / 2;
constexpr size_t kRoundSmemOneBlock = 227 * 1024;
constexpr int kRoundMaxThreads = 640;  // one thread per cell of a colour in a tile row
constexpr int kRoundWidths[3] = {56, 24, 8};  // columns written, multiples of 4 (16 bytes)
constexpr int kRoundMinRows = 4;

// One input array's rows, addressed by window row r.
struct Rows {
  const float* win;  // element (l, r, c) at win[l * ls + (r - shift) * width + c]
  const float* top;  // sharded: rows [-kSlab, 0), kSlab rows of `width` floats per label
  const float* bot;  // sharded: rows [n, n + kSlab)
  long ls;           // label stride of win
  long tls, bls;     // label strides of top and bot (slabs may be views of a neighbour)
  int width;
  int shift;         // 1 for the dense vm2, else 0
};

struct OutRows {
  float* p;  // element (l, r, c) at p[l * ls + (r - shift) * width + c]
  long ls;
  int width;
  int shift;
};

struct Grid {
  Rows u, hm1, hm2, vm1, vm2, hc, vc;  // vm2 row r: the slot of edge (r-1, r) owned by r
  OutRows u_o, hm1_o, hm2_o, vm1_o, vm2_o;
  int L, n, row0, H, W;  // window rows [0, n) are global rows [row0, row0 + n)
};

struct RowPtr {
  const float* p;  // the row's column 0 at label 0
  long ls;         // label stride
};

// Whether window row r can be read: the window itself, and in a shard the slabs.
template <bool kSharded>
__device__ __forceinline__ bool readable(const Grid& g, int r) {
  return kSharded ? (r >= -kSlab && r < g.n + kSlab) : (r >= 0 && r < g.n);
}

template <bool kSharded>
__device__ __forceinline__ RowPtr row(const Rows& a, int n, int r) {
  if (kSharded) {
    if (r < 0) return {a.top + (long)(r + kSlab) * a.width, a.tls};
    if (r >= n) return {a.bot + (long)(r - n) * a.width, a.bls};
  }
  return {a.win + (long)(r - a.shift) * a.width, a.ls};
}

__device__ __forceinline__ float* out_at(const OutRows& o, int l, int r, int c) {
  return o.p + l * o.ls + (long)(r - o.shift) * o.width + c;
}

// Min statistics of a Potts edge's "other" slot over the labels, in one
// pass: the min m and the value min_except takes at the min's positions (the
// second smallest value, or m itself when the min occurs twice:
// pallas_grid.py:52-61).
struct MinExcept {
  float m, s;
};

__device__ __forceinline__ MinExcept min_except_stats(const float* other, long stride, int L) {
  float m = other[0], s = kBig;
  for (int l = 1; l < L; ++l) {
    const float v = other[l * stride];
    s = fminf(s, fmaxf(m, v));
    m = fminf(m, v);
  }
  return {m, s};
}

// Potts marginal toward `own`'s side for one label (factors/potts.py):
// own + min(other, min_except(other) + cost); own + other when L == 1.
__device__ __forceinline__ float potts_marg(float own, float other, MinExcept st, float cost,
                                            int L) {
  if (L == 1) return own + other;
  const float me = (other == st.m) ? st.s : st.m;
  return own + fminf(other, me + cost);
}

// ---------------------------------------------------------------------------
// phase kernel
// ---------------------------------------------------------------------------
constexpr int kPhasePairs = 32;     // column pairs of a block row: one warp
constexpr int kPhaseRows = 4;       // block rows
constexpr int kPhaseRegLabels = 4;  // label counts up to this run with all in registers
// u, vm1 and vm2 (arrays 0, 3, 4) with 8-byte pair accesses (kVec)
constexpr unsigned kVecArrays = 1u | 8u | 16u;

__device__ __forceinline__ RowPtr win_row(const Rows& a, int r) {
  return {a.win + (long)(r - a.shift) * a.width, a.ls};
}

__device__ __forceinline__ float* out_row(const OutRows& o, int r) {
  return o.p + (long)(r - o.shift) * o.width;
}

// One cell's update for one label: own = {u, right, left, down, up slot},
// oth and st the "other" slots of its four edges and their min statistics
// (read only when it receives), ex which edges exist.  Same order of adds as
// the plain version (right, left, down, up).
__device__ __forceinline__ void phase_cell(const float (&own)[5], bool recv, const bool (&ex)[4],
                                           const float (&oth)[4], const MinExcept (&st)[4],
                                           const float (&cost)[4], float omega, float keep,
                                           int L, float (&out)[5]) {
  float uu = own[0];
  float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (recv) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ex[e]) {
        m[e] = potts_marg(own[1 + e], oth[e], st[e], cost[e], L);
        uu += m[e];
      }
    }
  }
  const float d = __fmul_rn(uu, omega);
  out[0] = uu * keep;
#pragma unroll
  for (int e = 0; e < 4; ++e) out[1 + e] = (own[1 + e] - m[e]) + d;
}

// A thread updates a horizontal pair of cells, A = (r, c0) and B = (r, c0 + 1)
// with c0 even: one of each colour, so every lane of a warp (32 pairs of one
// row) takes the same path, and a warp's loads and stores cover 64
// consecutive floats of a row.  With kL > 0 labels (exactly L) every value
// of the pair is loaded into registers before the first use: one round trip
// to memory per thread, no loop and no branch.  kL == 0 takes any L: the
// receiving cell's min statistics in a pass of their own, then one label at
// a time.
template <bool kSharded, int kL, bool kVec>
__global__ void __launch_bounds__(kPhasePairs* kPhaseRows)
    grid_phase_kernel(const Grid g, int recv_color, int send_color, float leave) {
  const int c0 = 2 * (blockIdx.x * kPhasePairs + threadIdx.x), c1 = c0 + 1;
  const int r = blockIdx.y * kPhaseRows + threadIdx.y;
  const int L = kL > 0 ? kL : g.L, H = g.H, W = g.W, n = g.n;
  if (r >= n || c0 >= W) return;
  const int gr = g.row0 + r;                   // global row
  const bool live = !kSharded || gr < H;       // an inert row writes zeros, reads nothing
  const bool hasB = c1 < W;
  const bool rightA = hasB, leftA = c0 > 0, rightB = c1 < W - 1;
  const bool down = live && gr < H - 1, up = live && gr > 0;
  const int colorA = (gr & 1) ? 2 : 1, colorB = 3 - colorA;  // c0 is even
  const bool recvA = live && recv_color == colorA, recvB = live && hasB && recv_color == colorB;
  const bool recv = recvA || recvB;
  const bool exA[4] = {rightA, leftA, down, up}, exB[4] = {rightB, true, down, up};
  const float degA = (float)rightA + (float)leftA + (float)down + (float)up;
  const float degB = (float)rightB + 1.0f + (float)down + (float)up;
  const float omegaA = (live && send_color == colorA) ? 1.0f / fmaxf(degA + leave, 1.0f) : 0.0f;
  const float omegaB = (live && send_color == colorB) ? 1.0f / fmaxf(degB + leave, 1.0f) : 0.0f;
  const float keepA = 1.0f - __fmul_rn(omegaA, degA), keepB = 1.0f - __fmul_rn(omegaB, degB);

  // The pair's own slots, from its own row (always in the window; the label
  // strides are the launch's): u, hm1 (A's right edge, then B's), hm2 (A's
  // left edge, then B's), vm1 (edges below), vm2 (edges above).
  const float* const src[5] = {win_row(g.u, r).p + c0, win_row(g.hm1, r).p + c0,
                               win_row(g.hm2, r).p + c0 - 1, win_row(g.vm1, r).p + c0,
                               win_row(g.vm2, r).p + c0};
  const long sls[5] = {g.u.ls, g.hm1.ls, g.hm2.ls, g.vm1.ls, g.vm2.ls};
  const bool okA[5] = {live, live && rightA, live && leftA, down, up};
  const bool okB[5] = {live && hasB, live && rightB, live && hasB, down && hasB, up && hasB};
  float* const dst[5] = {out_row(g.u_o, r) + c0, out_row(g.hm1_o, r) + c0,
                         out_row(g.hm2_o, r) + c0 - 1, out_row(g.vm1_o, r) + c0,
                         out_row(g.vm2_o, r) + c0};
  const long dls[5] = {g.u_o.ls, g.hm1_o.ls, g.hm2_o.ls, g.vm1_o.ls, g.vm2_o.ls};
  // stores: every slot the pair owns; a shard stores 0 in the slot of an absent vertical edge
  const bool stA[5] = {true, rightA, leftA, down || kSharded, up || kSharded};
  const bool stB[5] = {hasB, rightB, hasB, (down || kSharded) && hasB, (up || kSharded) && hasB};

  // The receiving cell R: its column, its costs and where its "other" slots
  // lie: the inner horizontal one is the pair's own, the outer one is hm1 at
  // c0 - 1 (for A) or hm2 at c1 (for B), the vertical ones are vm2 one row
  // below and vm1 one row above (rows that may lie in a slab).
  const int cR = recvA ? c0 : c1;
  const bool rightR = recvA ? rightA : rightB, leftR = recvA ? leftA : true;
  const bool outerR = recv && (recvA ? leftA : rightB);
  float cost[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // right, left, down, up
  RowPtr xo{src[0], 0}, vdn{src[0], 0}, vup{src[0], 0};
  if (recv) {
    const float* hcr = win_row(g.hc, r).p;
    if (rightR) cost[0] = __ldg(hcr + cR);
    if (leftR) cost[1] = __ldg(hcr + cR - 1);
    if (down) cost[2] = __ldg(win_row(g.vc, r).p + cR);
    if (up) cost[3] = __ldg(row<kSharded>(g.vc, n, r - 1).p + cR);
    xo = recvA ? RowPtr{src[1] - 1, g.hm1.ls} : RowPtr{src[2] + 2, g.hm2.ls};
    if (down) vdn = row<kSharded>(g.vm2, n, r + 1);
    if (up) vup = row<kSharded>(g.vm1, n, r - 1);
    vdn.p += cR;
    vup.p += cR;
  }
  const bool dnR = recv && down, upR = recv && up;

  // one label: the pair's own slots and R's others (inner from the own ones)
  auto load = [&](int l, float (&a)[5], float (&b)[5], float (&o)[4]) {
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (kVec && ((kVecArrays >> k) & 1)) {  // okB[k] == okA[k] here: W is even
        const float2 v = okA[k] ? __ldg(reinterpret_cast<const float2*>(src[k] + l * sls[k]))
                                : make_float2(0.0f, 0.0f);
        a[k] = v.x;
        b[k] = v.y;
      } else {
        a[k] = okA[k] ? __ldg(src[k] + l * sls[k]) : 0.0f;
        b[k] = okB[k] ? __ldg(src[k] + l * sls[k] + 1) : 0.0f;
      }
    }
    const float x = outerR ? __ldg(xo.p + l * xo.ls) : 0.0f;
    o[0] = recvA ? b[2] : x;  // hm2 at cR
    o[1] = recvA ? x : a[1];  // hm1 at cR - 1
    o[2] = dnR ? __ldg(vdn.p + l * vdn.ls) : 0.0f;
    o[3] = upR ? __ldg(vup.p + l * vup.ls) : 0.0f;
  };
  auto update = [&](int l, const float (&a)[5], const float (&b)[5], const float (&o)[4],
                    const MinExcept (&st)[4]) {
    float outA[5], outB[5];
    phase_cell(a, recvA, exA, o, st, cost, omegaA, keepA, L, outA);
    phase_cell(b, recvB, exB, o, st, cost, omegaB, keepB, L, outB);
#pragma unroll
    for (int k = 0; k < 5; ++k) {  // (a shard's slot of an absent vertical edge gets 0)
      float* const p = dst[k] + l * dls[k];
      const float va = (k >= 3 && !exA[k - 1]) ? 0.0f : outA[k];
      const float vb = (k >= 3 && !exB[k - 1]) ? 0.0f : outB[k];
      if (kVec && ((kVecArrays >> k) & 1)) {  // stB[k] == stA[k] here
        if (stA[k]) *reinterpret_cast<float2*>(p) = make_float2(va, vb);
      } else {
        if (stA[k]) p[0] = va;
        if (stB[k]) p[1] = vb;
      }
    }
  };

  MinExcept st[4] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  if constexpr (kL > 0) {
    float a[kL][5], b[kL][5], o[kL][4];
#pragma unroll
    for (int l = 0; l < kL; ++l) load(l, a[l], b[l], o[l]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // min statistics in label order
      st[e] = {o[0][e], kBig};
#pragma unroll
      for (int l = 1; l < kL; ++l) {
        st[e].s = fminf(st[e].s, fmaxf(st[e].m, o[l][e]));
        st[e].m = fminf(st[e].m, o[l][e]);
      }
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) update(l, a[l], b[l], o[l], st);
  } else {
    if (recv) {
      if (rightR) st[0] = min_except_stats(recvA ? src[2] + 1 : xo.p, g.hm2.ls, L);
      if (leftR) st[1] = min_except_stats(recvA ? xo.p : src[1], g.hm1.ls, L);
      if (down) st[2] = min_except_stats(vdn.p, vdn.ls, L);
      if (up) st[3] = min_except_stats(vup.p, vup.ls, L);
    }
    for (int l = 0; l < L; ++l) {
      float a[5], b[5], o[4];
      load(l, a, b, o);
      update(l, a, b, o, st);
    }
  }
}

// ---------------------------------------------------------------------------
// round kernel
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int round_halo(int nr) { return 2 * nr; }

// A round launch's tile: T_r x T_c cells written, S_r x S_c cells loaded (a
// halo of P = 2 * NR on every side), blocks of (S_c / 2) x rb threads.
struct RoundTile {
  int tr, tc;   // rows and columns written
  int sr, sc;   // rows and columns loaded
  int hw;       // cells of one colour in a tile row: S_c / 2, the block's x extent
  int rb;       // thread rows, the block's y extent
  int hp;       // floats of one colour half-plane: S_r * hw, padded to 16 mod 32
  size_t smem;  // dynamic shared memory: (5 L + 2) planes of 2 * hp floats
};

RoundTile make_round_tile(int L, int nr, int tr, int tc) {
  const int p = round_halo(nr);
  RoundTile t;
  t.tr = tr;
  t.tc = tc;
  t.sr = tr + 2 * p;
  t.sc = tc + 2 * p;
  t.hw = t.sc / 2;
  const int max_rb = t.hw < kRoundMaxThreads ? kRoundMaxThreads / t.hw : 1;
  const int passes = (t.sr + max_rb - 1) / max_rb;
  t.rb = (t.sr + passes - 1) / passes;
  const int base = t.sr * t.hw;
  t.hp = base + ((16 - base % 32) + 32) % 32;  // the two halves 16 banks apart
  t.smem = (5 * (size_t)L + 2) * 2 * t.hp * sizeof(float);
  return t;
}

bool round_tile_ok(const RoundTile& t) {
  return t.tr >= 1 && t.tc >= 2 && t.tc % 2 == 0 && t.hw * t.rb <= kRoundMaxThreads &&
         t.smem <= kRoundSmemOneBlock;
}

// The default tile: the widest column count of kRoundWidths whose tile, with
// as many rows as fit, writes at least kRoundMinRows rows in the shared
// memory of two blocks per SM, else of one.
RoundTile round_tile(int L, int nr) {
  const size_t budgets[2] = {kRoundSmemTwoBlocks, kRoundSmemOneBlock};
  for (const size_t budget : budgets) {
    for (const int tc : kRoundWidths) {
      int tr = 0;
      while (make_round_tile(L, nr, tr + 1, tc).smem <= budget) ++tr;
      if (tr >= kRoundMinRows) return make_round_tile(L, nr, tr, tc);
    }
  }
  return make_round_tile(L, nr, 1, kRoundWidths[2]);  // not reached for L <= kMaxRoundLabels
}

// Asynchronous copies of one array's tile rows into its colour-split planes:
// tile cell (i, j) at plane + ((i + j) & 1) * hp + i * hw + j / 2.  Column c
// of a tile row reads source column c + c_off where c_lo <= c < c_hi; `edge`
// keeps only the rows with an edge below (1) or above (2).  Everything else,
// and every row that does not exist or cannot be read, is 0.  A thread copies
// the columns tx and tx + hw of its rows, every label of a row in turn.
template <bool kSharded>
__device__ __forceinline__ void load_array(float* dst, const Rows& a, int labels, const Grid& g,
                                           const RoundTile& t, int R0, int C0, int c_lo,
                                           int c_hi, int c_off, int edge) {
  const int plane = 2 * t.hp;
  const int j0 = threadIdx.x, j1 = threadIdx.x + t.hw;
  const int c0 = C0 + j0, c1 = C0 + j1;
  const bool col0 = c0 >= c_lo && c0 < c_hi, col1 = c1 >= c_lo && c1 < c_hi;
  for (int i = threadIdx.y; i < t.sr; i += blockDim.y) {
    const int r = R0 + i, gr = g.row0 + r;
    const bool row_ok = gr >= 0 && gr < g.H && readable<kSharded>(g, r) &&
                        (edge != 1 || gr < g.H - 1) && (edge != 2 || gr > 0);
    const bool ok0 = row_ok && col0, ok1 = row_ok && col1;
    const float* s0 = g.u.win;  // any valid address: nothing is read where !ok
    const float* s1 = g.u.win;
    long ls = 0;
    if (row_ok) {
      const RowPtr rp = row<kSharded>(a, g.n, r);
      if (ok0) s0 = rp.p + c_off + c0;
      if (ok1) s1 = rp.p + c_off + c1;
      ls = rp.ls;
    }
    const long ls0 = ok0 ? ls : 0, ls1 = ok1 ? ls : 0;
    float* d0 = dst + ((i + j0) & 1) * t.hp + i * t.hw + (j0 >> 1);
    float* d1 = dst + ((i + j1) & 1) * t.hp + i * t.hw + (j1 >> 1);
    for (int l = 0; l < labels; ++l) {
      cp_async_f32(d0 + l * plane, s0 + l * ls0, ok0);
      cp_async_f32(d1 + l * plane, s1 + l * ls1, ok1);
    }
  }
}

template <int NR, bool kSharded>
__global__ void __launch_bounds__(kRoundMaxThreads, 2) grid_round_kernel(const Grid g,
                                                                         const RoundTile t) {
  constexpr int P = round_halo(NR);
  static_assert(P <= kSlab, "the slabs cover the round kernel's halo");
  const int L = g.L, H = g.H, W = g.W, n = g.n;
  const int HW = t.hw, PL = 2 * t.hp;  // PL: floats per label plane
  const int tx = threadIdx.x, ty = threadIdx.y, RB = blockDim.y;
  extern __shared__ float smem[];
  // every slot at its owner cell
  float* s_u = smem;
  float* s_a = s_u + L * PL;  // own slot of the edge to the right: hm1 (r, c)
  float* s_b = s_a + L * PL;  // own slot of the edge to the left: hm2 (r, c - 1)
  float* s_d = s_b + L * PL;  // own slot of the edge below: vm1 (r, c)
  float* s_t = s_d + L * PL;  // own slot of the edge above: vm2 (r - 1, c) in the dense layout
  float* s_hc = s_t + L * PL;  // cost of the edge to the right
  float* s_vc = s_hc + PL;     // cost of the edge below

  // tile origin in window coordinates (may lie outside: those cells are absent)
  const int R0 = blockIdx.y * t.tr - P, C0 = blockIdx.x * t.tc - P;
  load_array<kSharded>(s_u, g.u, L, g, t, R0, C0, 0, W, 0, 0);
  load_array<kSharded>(s_a, g.hm1, L, g, t, R0, C0, 0, W - 1, 0, 0);
  load_array<kSharded>(s_b, g.hm2, L, g, t, R0, C0, 1, W, -1, 0);
  load_array<kSharded>(s_d, g.vm1, L, g, t, R0, C0, 0, W, 0, 1);
  load_array<kSharded>(s_t, g.vm2, L, g, t, R0, C0, 0, W, 0, 2);
  load_array<kSharded>(s_hc, g.hc, 1, g, t, R0, C0, 0, W - 1, 0, 0);
  load_array<kSharded>(s_vc, g.vc, 1, g, t, R0, C0, 0, W, 0, 1);
  cp_async_wait_all();
  __syncthreads();

  // Phase k (1..P) updates the cells of one colour within P - k of the
  // written tile: the ones the written tile still depends on.  Those cells
  // are one colour half-plane, so a thread row reads and writes consecutive
  // floats, and their neighbours lie in the other half at the same offsets.
  const int shift = (g.row0 + R0 + C0) & 1;  // global parity of local cell (0, 0)
#pragma unroll 1
  for (int k = 1; k <= P; ++k) {
    const int q = (k & 1) ^ shift;  // half-plane that updates: red (odd r + c) first
    const int own0 = q * t.hp, oth0 = (q ^ 1) * t.hp;
    for (int i = k + ty; i < t.sr - k; i += RB) {
      const int b = (q ^ i) & 1;
      const int j = 2 * tx + b;
      const int r = R0 + i, gr = g.row0 + r, c = C0 + j;
      if (j < k || j >= t.sc - k || gr < 0 || gr >= H || c < 0 || c >= W ||
          !readable<kSharded>(g, r)) {
        continue;
      }
      const bool right = c < W - 1, left = c > 0, down = gr < H - 1, up = gr > 0;
      const float deg = (float)right + (float)left + (float)down + (float)up;
      const float omega = 1.0f / fmaxf(deg, 1.0f);
      const float keep = 1.0f - __fmul_rn(omega, deg);
      const int own = own0 + i * HW + tx;
      const int nr = oth0 + i * HW + tx + b;  // cell (i, j + 1); (i, j - 1) is nr - 1
      const int nd = oth0 + (i + 1) * HW + tx, nu = oth0 + (i - 1) * HW + tx;
      MinExcept st_r{0.0f, 0.0f}, st_l{0.0f, 0.0f}, st_d{0.0f, 0.0f}, st_u{0.0f, 0.0f};
      if (right) st_r = min_except_stats(s_b + nr, PL, L);
      if (left) st_l = min_except_stats(s_a + nr - 1, PL, L);
      if (down) st_d = min_except_stats(s_t + nd, PL, L);
      if (up) st_u = min_except_stats(s_d + nu, PL, L);
      const float cr = right ? s_hc[own] : 0.0f, cl = left ? s_hc[nr - 1] : 0.0f;
      const float cd = down ? s_vc[own] : 0.0f, cu = up ? s_vc[nu] : 0.0f;
      float *pu = s_u + own, *pa = s_a + own, *pb = s_b + own, *pd = s_d + own, *pt = s_t + own;
      const float *qr = s_b + nr, *ql = s_a + nr - 1, *qd = s_t + nd, *qu = s_d + nu;
#pragma unroll 4
      for (int l = 0; l < L; ++l) {
        const int o = l * PL;
        const float own_r = pa[o], own_l = pb[o], own_d = pd[o], own_u = pt[o];
        float uu = pu[o];
        float mr = 0.0f, ml = 0.0f, md = 0.0f, mu = 0.0f;
        // same order of adds as the plain version
        if (right) { mr = potts_marg(own_r, qr[o], st_r, cr, L); uu += mr; }
        if (left) { ml = potts_marg(own_l, ql[o], st_l, cl, L); uu += ml; }
        if (down) { md = potts_marg(own_d, qd[o], st_d, cd, L); uu += md; }
        if (up) { mu = potts_marg(own_u, qu[o], st_u, cu, L); uu += mu; }
        const float d = __fmul_rn(uu, omega);
        pu[o] = uu * keep;
        if (right) pa[o] = (own_r - mr) + d;
        if (left) pb[o] = (own_l - ml) + d;
        if (down) pd[o] = (own_d - md) + d;
        if (up) pt[o] = (own_u - mu) + d;
      }
    }
    __syncthreads();
  }

  // write the tile: each cell's u and own slots (zeros for an inert row and
  // for slots of absent edges in a shard)
  for (int i = P + ty; i < P + t.tr; i += RB) {
    const int r = R0 + i, gr = g.row0 + r;
    if (r >= n) break;
    const bool live = !kSharded || gr < H;
    const bool down = live && gr < H - 1, up = live && gr > 0;
    for (int j = P + tx; j < P + t.tc; j += HW) {
      const int c = C0 + j;
      if (c >= W) break;
      const bool right = c < W - 1, left = c > 0;
      float* ou = out_at(g.u_o, 0, r, c);
      float* oh1 = right ? out_at(g.hm1_o, 0, r, c) : nullptr;
      float* oh2 = left ? out_at(g.hm2_o, 0, r, c - 1) : nullptr;
      float* ov1 = (down || kSharded) ? out_at(g.vm1_o, 0, r, c) : nullptr;
      float* ov2 = (up || kSharded) ? out_at(g.vm2_o, 0, r, c) : nullptr;
      const int o0 = ((i + j) & 1) * t.hp + i * HW + (j >> 1);
      for (int l = 0; l < L; ++l) {
        const int o = l * PL + o0;
        __stcs(ou + l * g.u_o.ls, live ? s_u[o] : 0.0f);  // streaming: not read again here
        if (right) __stcs(oh1 + l * g.hm1_o.ls, live ? s_a[o] : 0.0f);
        if (left) __stcs(oh2 + l * g.hm2_o.ls, live ? s_b[o] : 0.0f);
        if (down || kSharded) __stcs(ov1 + l * g.vm1_o.ls, down ? s_d[o] : 0.0f);
        if (up || kSharded) __stcs(ov2 + l * g.vm2_o.ls, up ? s_t[o] : 0.0f);
      }
    }
  }
}

template <bool kSharded, int kL, bool kVec>
cudaError_t launch_phase_labels(const Grid& g, int recv_color, int send_color, float leave,
                                cudaStream_t stream) {
  const int pairs = (g.W + 1) / 2;
  const dim3 block(kPhasePairs, kPhaseRows);
  const dim3 grid((pairs + kPhasePairs - 1) / kPhasePairs, (g.n + kPhaseRows - 1) / kPhaseRows);
  grid_phase_kernel<kSharded, kL, kVec><<<grid, block, 0, stream>>>(g, recv_color, send_color,
                                                                   leave);
  return cudaGetLastError();
}

// Whether the pairs of u, vm1 and vm2 (both cells, every row and label) sit
// on 8-byte boundaries in the window and the outputs: W even, even label
// strides, 8-byte aligned arrays.
bool pairs_aligned(const Grid& g) {
  if (g.W % 2) return false;
  const Rows* in[3] = {&g.u, &g.vm1, &g.vm2};
  const OutRows* out[3] = {&g.u_o, &g.vm1_o, &g.vm2_o};
  for (int k = 0; k < 3; ++k) {
    if ((reinterpret_cast<uintptr_t>(in[k]->win) & 7) || (in[k]->ls & 1) ||
        (reinterpret_cast<uintptr_t>(out[k]->p) & 7) || (out[k]->ls & 1)) {
      return false;
    }
  }
  return true;
}

template <bool kSharded, int kL>
cudaError_t launch_phase_vec(const Grid& g, int recv_color, int send_color, float leave,
                             cudaStream_t stream) {
  if (pairs_aligned(g)) {
    return launch_phase_labels<kSharded, kL, true>(g, recv_color, send_color, leave, stream);
  }
  return launch_phase_labels<kSharded, kL, false>(g, recv_color, send_color, leave, stream);
}

template <bool kSharded>
cudaError_t launch_phase(const Grid& g, int recv_color, int send_color, float leave,
                         cudaStream_t stream) {
  static_assert(kPhaseRegLabels == 4, "one instantiation per label count in registers");
  switch (g.L) {
    case 1: return launch_phase_vec<kSharded, 1>(g, recv_color, send_color, leave, stream);
    case 2: return launch_phase_vec<kSharded, 2>(g, recv_color, send_color, leave, stream);
    case 3: return launch_phase_vec<kSharded, 3>(g, recv_color, send_color, leave, stream);
    case 4: return launch_phase_vec<kSharded, 4>(g, recv_color, send_color, leave, stream);
    default:
      return launch_phase_labels<kSharded, 0, false>(g, recv_color, send_color, leave, stream);
  }
}

// Devices whose round-kernel attributes are remembered below; a device of a
// higher ordinal sets them at every launch.
constexpr int kMaxDevices = 64;

// The kernel's attributes are set per device at the first launch that needs
// more dynamic shared memory than any before, and remembered: a launch under
// CUDA stream capture (a graph of the port's capture.py, set up by an eager
// warm-up launch) then makes no runtime call but the launch itself.
template <int NR, bool kSharded>
cudaError_t launch_round(const Grid& g, const RoundTile& t, cudaStream_t stream) {
  static std::atomic<long long> smem_set[kMaxDevices];   // zero before the first launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  long long have = known ? smem_set[dev].load() : 0;
  if (have < (long long)t.smem) {
    err = cudaFuncSetAttribute(grid_round_kernel<NR, kSharded>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(grid_round_kernel<NR, kSharded>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    while (known && have < (long long)t.smem &&
           !smem_set[dev].compare_exchange_weak(have, (long long)t.smem)) {
    }
  }
  const dim3 grid((g.W + t.tc - 1) / t.tc, (g.n + t.tr - 1) / t.tr);
  grid_round_kernel<NR, kSharded><<<grid, dim3(t.hw, t.rb), t.smem, stream>>>(g, t);
  return cudaGetLastError();
}

// The tile of a launch: tile_rows x tile_cols when both are positive (for a
// tile sweep), else the default of round_tile.
bool pick_round_tile(int L, int n_rounds, int tile_rows, int tile_cols, RoundTile* t) {
  if (n_rounds != 1 && n_rounds != 2) return false;
  *t = (tile_rows > 0 && tile_cols > 0) ? make_round_tile(L, n_rounds, tile_rows, tile_cols)
                                         : round_tile(L, n_rounds);
  return round_tile_ok(*t);
}

template <bool kSharded>
cudaError_t launch_round_nr(const Grid& g, int n_rounds, int tile_rows, int tile_cols,
                            cudaStream_t stream) {
  RoundTile t;
  if (!pick_round_tile(g.L, n_rounds, tile_rows, tile_cols, &t)) return cudaErrorInvalidValue;
  if (n_rounds == 1) return launch_round<1, kSharded>(g, t, stream);
  return launch_round<2, kSharded>(g, t, stream);
}

Rows dense_rows(const float* p, long ls, int width, int shift) {
  return {p, nullptr, nullptr, ls, 0, 0, width, shift};
}

OutRows out_rows(float* p, long ls, int width, int shift) { return {p, ls, width, shift}; }

// The dense grid as a window of H rows at row 0.
Grid dense_grid(const float* u, const float* hm1, const float* hm2, const float* vm1,
                const float* vm2, const float* hc, const float* vc, float* u_o, float* hm1_o,
                float* hm2_o, float* vm1_o, float* vm2_o, int L, int H, int W) {
  const long su = (long)H * W, sh = (long)H * (W - 1), sv = (long)(H - 1) * W;
  Grid g;
  g.u = dense_rows(u, su, W, 0);
  g.hm1 = dense_rows(hm1, sh, W - 1, 0);
  g.hm2 = dense_rows(hm2, sh, W - 1, 0);
  g.vm1 = dense_rows(vm1, sv, W, 0);
  g.vm2 = dense_rows(vm2, sv, W, 1);
  g.hc = dense_rows(hc, 0, W - 1, 0);
  g.vc = dense_rows(vc, 0, W, 0);
  g.u_o = out_rows(u_o, su, W, 0);
  g.hm1_o = out_rows(hm1_o, sh, W - 1, 0);
  g.hm2_o = out_rows(hm2_o, sh, W - 1, 0);
  g.vm1_o = out_rows(vm1_o, sv, W, 0);
  g.vm2_o = out_rows(vm2_o, sv, W, 1);
  g.L = L;
  g.n = H;
  g.row0 = 0;
  g.H = H;
  g.W = W;
  return g;
}

// A shard's window.  ptrs: for u, hm1, hm2, vm1, vm2, hc, vc in turn the
// window, top slab and bottom slab (21 pointers), then the five outputs;
// slab_ls: the label strides of the 14 slabs in the same order (rows within
// a slab are contiguous).
Grid shard_grid(void* const* ptrs, const long long* slab_ls, int L, int n, int W, int row0,
                int H) {
  const int widths[7] = {W, W - 1, W - 1, W, W, W - 1, W};
  Rows in[7];
  for (int a = 0; a < 7; ++a) {
    in[a] = {static_cast<const float*>(ptrs[3 * a]), static_cast<const float*>(ptrs[3 * a + 1]),
             static_cast<const float*>(ptrs[3 * a + 2]), (long)n * widths[a],
             (long)slab_ls[2 * a], (long)slab_ls[2 * a + 1], widths[a], 0};
  }
  OutRows out[5];
  for (int a = 0; a < 5; ++a) {
    out[a] = out_rows(static_cast<float*>(ptrs[21 + a]), (long)n * widths[a], widths[a], 0);
  }
  Grid g;
  g.u = in[0];
  g.hm1 = in[1];
  g.hm2 = in[2];
  g.vm1 = in[3];
  g.vm2 = in[4];
  g.hc = in[5];
  g.vc = in[6];
  g.u_o = out[0];
  g.hm1_o = out[1];
  g.hm2_o = out[2];
  g.vm1_o = out[3];
  g.vm2_o = out[4];
  g.L = L;
  g.n = n;
  g.row0 = row0;
  g.H = H;
  g.W = W;
  return g;
}

}  // namespace

extern "C" {

const char* lpmp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lpmp_grid_phase_update(const float* u, const float* hm1, const float* hm2, const float* vm1,
                           const float* vm2, const float* hc, const float* vc, float* u_o,
                           float* hm1_o, float* hm2_o, float* vm1_o, float* vm2_o, int L, int H,
                           int W, int recv_color, int send_color, float leave, int device,
                           void* stream) {
  if (L < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Grid g = dense_grid(u, hm1, hm2, vm1, vm2, hc, vc, u_o, hm1_o, hm2_o, vm1_o, vm2_o, L,
                            H, W);
  return launch_phase<false>(g, recv_color, send_color, leave,
                             static_cast<cudaStream_t>(stream));
}

int lpmp_grid_round_update(const float* u, const float* hm1, const float* hm2, const float* vm1,
                           const float* vm2, const float* hc, const float* vc, float* u_o,
                           float* hm1_o, float* hm2_o, float* vm1_o, float* vm2_o, int L, int H,
                           int W, int n_rounds, int tile_rows, int tile_cols, int device,
                           void* stream) {
  if (L < 1 || L > kMaxRoundLabels || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Grid g = dense_grid(u, hm1, hm2, vm1, vm2, hc, vc, u_o, hm1_o, hm2_o, vm1_o, vm2_o, L,
                            H, W);
  return launch_round_nr<false>(g, n_rounds, tile_rows, tile_cols,
                                static_cast<cudaStream_t>(stream));
}

// The round kernel's tile for L labels and n_rounds (tile_rows, tile_cols as
// for a launch): out = {T_r, T_c, S_r, S_c, threads, shared bytes}.
int lpmp_grid_round_tile(int L, int n_rounds, int tile_rows, int tile_cols, long long* out) {
  RoundTile t;
  if (L < 1 || L > kMaxRoundLabels || !pick_round_tile(L, n_rounds, tile_rows, tile_cols, &t)) {
    return cudaErrorInvalidValue;
  }
  const long long v[6] = {t.tr, t.tc, t.sr, t.sc, (long long)t.hw * t.rb, (long long)t.smem};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
  return cudaSuccess;
}

int lpmp_grid_phase_update_sharded(void* const* ptrs, const long long* slab_ls, int L, int n,
                                   int W, int row0, int H, int recv_color, int send_color,
                                   float leave, int device, void* stream) {
  if (L < 1 || n < 1 || W < 1 || row0 < 0 || H < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_phase<true>(shard_grid(ptrs, slab_ls, L, n, W, row0, H), recv_color,
                            send_color, leave,
                            static_cast<cudaStream_t>(stream));
}

int lpmp_grid_round_update_sharded(void* const* ptrs, const long long* slab_ls, int L, int n,
                                   int W, int row0, int H, int n_rounds, int tile_rows,
                                   int tile_cols, int device, void* stream) {
  if (L < 1 || L > kMaxRoundLabels || n < 1 || W < 1 || row0 < 0 || H < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_round_nr<true>(shard_grid(ptrs, slab_ls, L, n, W, row0, H), n_rounds,
                               tile_rows, tile_cols, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
