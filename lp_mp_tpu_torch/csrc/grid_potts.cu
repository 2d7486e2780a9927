// Grid-Potts colour-phase kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of lp_mp_tpu/ops/pallas_grid.py:
//   grid_phase_kernel<false, .>  <- _phase_kernel_v2 (:161, wrapper phase_update_v2; K2),
//                                   and the v1 _phase_kernel (:72, K5: phase_update_v1 in
//                                   ops/grid_kernels.py decodes its parameters and launches K2)
//   grid_round_kernel<NR, false> <- _round_kernel_v2 (:303, wrapper round_update_v2; K1)
//   grid_phase_kernel<true, .>   <- _phase_kernel_sharded (:443, wrapper phase_update_sharded; K4)
//   grid_round_kernel<NR, true>  <- _round_kernel_sharded (:536, wrapper round_update_sharded; K3)
// and, replacing no Pallas kernel, the grid model's primal rounding (the JAX
// package rounds with jnp ops, lp_mp_tpu/models/grid_potts.py:297-317):
//   grid_round_primal_kernel     a phase that also writes labels (round_phase_update)
//   grid_primal_cost_kernel,     the labelling's cost in float64 (primal_cost)
//   grid_primal_sum_kernel
// and, replacing no Pallas kernel either (the JAX bound is jnp ops,
// lp_mp_tpu/models/grid_potts.py, lower_bound):
//   grid_bound_kernel            the dual bound in float64 (lower_bound), its
//                                partials folded by grid_primal_sum_kernel
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
// repeated) in one launch, so the bytes per iteration fall by 2*NR.  Every
// written cell needs the cells within P = 2*NR of it; each phase updates one
// colour in place (no two cells of a colour share an edge), and phase k only
// updates the cells within P - k of the written ones (cells on the true grid
// edge lose nothing: missing edges do not exist).  In a shard, rows beyond
// the slabs load as absent: they lie more than P <= kSlab rows from the
// window, so nothing read from them reaches it.
// What bounds it: the 167.86 MB a launch must move at 1000x1000, L=4 (50.1
// us at 3.35 TB/s).  What held its earlier tile design (a block loads a T_r
// x T_c tile with a halo of P on all four sides into shared memory, waits,
// runs the P phases, then stores) to 158 us, 32 % of the bound:
//  - The halo on four sides: at L=4 a cell costs (5L + 2) * 4 = 88 bytes of
//    shared memory, so two blocks per SM held 20 x 64 loaded cells for 12 x
//    56 written, 1.90x the written cells.
//  - The blocks ran in step: each block loaded everything, waited, computed,
//    stored, so for most of a launch an SM waited on memory or computed,
//    never both; the copies were bound by the requests in flight and the
//    phases by latency.
// This design streams instead.  A block owns one segment of one
// column strip: it writes T_r rows x T_c columns and loads the strip's S_c =
// T_c + 2P columns of the segment's T_r + 2P rows, top to bottom, kRoundBand
// rows (a band) a step, into a ring of rows in shared memory.  Inside a
// segment there is no vertical halo.  At step s band s has landed; phase k
// (1..P) updates band s - 2k + 1 and band s - 2P, final since step s - 1,
// is stored.  The phases run at once on bands two apart, so phase k writes
// a band whose neighbours no other phase writes in that step, and reads
// them as phase k - 1 left them the step before; one barrier a step keeps
// the in-place updates race-free.  Bands s - 2P .. s are live; the copies of
// the next `ahead` bands (cp.async groups, one a step) stay in flight into
// the rest of the ring while the phases run.  Each written cell gets the
// arithmetic the tile gave it, in the same order of adds: the result is
// bit-equal to the plain version at every geometry.
//  - Warps by role: the first P * S_c / 2 threads run the phases (one cell
//    of a colour a band row each, one warp per phase at S_c = 64) and store
//    hm1 and hm2; as many more issue the copies and store u, vm1 and vm2, so
//    the memory instructions and the phase arithmetic run side by side on
//    the SM.  On the H100 (1000x1000, L=4, graph replay) the same kernel with
//    every thread doing everything took 157 us; with the producers doing
//    every copy and store, 123-130; with the split above, 108.
//  - 16-byte copies (kWide): rows of u, vm1, vm2 and vc are W floats, 16-byte
//    aligned when W is a multiple of 4, so those arrays move as 16-byte
//    cp.async chunks into planes in natural column order and leave as
//    16-byte streaming stores; the phases read those planes at a stride of
//    two floats (a two-way bank conflict).  Rows of hm1, hm2 and hc are W - 1
//    floats (a stride of 3996 bytes at W = 1000), not a multiple of 16, so no
//    TMA tensor map can describe them and 16-byte copies would straddle
//    rows: they keep one float a copy, into colour-split planes (the cells
//    of one colour in a row consecutive, the other colour 16 banks away, so
//    neither the phases nor the copies nor the stores conflict on banks).
//    Other widths, and one round a launch (the strips' loaded columns then
//    start on odd multiples of 2), take the colour-split planes and one
//    float a copy for every array.  A store's value comes from shared memory
//    before any store is issued: the store's asm would keep a later shared
//    load from moving ahead of it.
// Geometry (pick_round_tile), from L, the window's rows and columns and
// the card's shared memory: S_c the widest of 64, 32, 16 whose ring of 2P +
// 1 + 1 bands fits two blocks per SM (else one), then as many bands in
// flight as fit, up to kRoundMaxAhead; T_r splits the rows so that strips x
// segments fill one wave, at least kRoundMinRows.  At 1000x1000, L=4, NR=2:
// T_c = 56 (64 loaded), 18 strips; a ring of 17 rows of 64 cells (9 live, 8
// in flight), 98,560 B, two blocks per SM; T_r = 72, 14 segments, 252
// blocks in one wave of 264; 256 threads a block.  Loaded cells fall from
// 1.90x to 64/56 x 80/72 = 1.27x the written cells; neighbouring strips
// share their halo columns through L2.  For L <= kPhaseRegLabels a cell's
// update loads every value of its labels into registers first (K2's
// arithmetic); other L take one label at a time.
// Tried and slower (H100, 1000x1000, L=4, graph replay, against 108 us in
// the same calls): bands of two rows a step 111 us; three blocks per SM 114
// (K3 3 us faster); the consumers issuing the copies of hm1, hm2 and hc
// too 126; four bands in flight in place of eight, the same.  Against the
// kernel before the stores were split (115-117 us): strips of 120 or 88
// columns 139-165; plain loads through registers in place of cp.async 257;
// no division for omega, no gain.  There, without the phases the copies and
// stores alone took 94 us, without the copies 84, without the stores 82;
// the copies alone 54 (the 16-byte ones 47), the stores alone 57 (u, vm1,
// vm2 37), the phases alone 60.
// Tried with the tile design, and slower, all keeping the whole-tile shape:
// a persistent block per SM with two tile buffers; bulk copies (TMA) into
// padded rows plus an in-place rearrangement into colour order; two warp
// groups with their own buffers, one tile apart.
// grid_round_primal_kernel: one colour phase of the primal rounding
// (MpRoundingSolver semantics: GridPottsModel._round_impl), four launches a
// rounding.  It is grid_phase_kernel's body with one more compile-time flag,
// a label output: every cell of recv_color or send_color also writes the
// argmin of its post-receive cost uu into an int32 [H, W] buffer (the first
// minimum, or the first NaN, as torch.argmin picks), and every other cell
// leaves its label as it was, so after the mode's four phases the buffer
// holds the plain labelling.  It takes from K2 everything: the pair of
// cells a thread, the all-in-registers path for L <= kPhaseRegLabels with
// the generic label loop beside it, the 8-byte pairs, and the state out of
// place, bit-equal to phase_update_ref.  The argmin runs on the uu values
// the body already holds, so a phase that receives moves K2's 167.86 MB
// plus the labels of the colour it updates, 2 MB (4 MB in 32-byte sectors),
// at 1000x1000, L=4: 50.7 us at 3.35 TB/s; 72 us on the H100 (phase_bench.py),
// 8 us more than K2 on the same phase.  grid_phase_kernel itself calls the
// body with the flag off, whose branch adds nothing: K2, K4 and K5 compile
// to the code they had (same SASS and registers).
// grid_primal_cost_kernel then reads the final state once: per cell its
// label, its u and own slots at that label and its right and lower
// neighbours' labels, the other slot of those two edges at the neighbour's
// label and their costs, summed in float64, one partial per block, folded
// in a fixed tree order; grid_primal_sum_kernel (one block) folds the
// partials the same way, so a state gives the same cost bit for bit on
// every replay, with no atomics.  Its bytes at 1000x1000, L=4: the labels
// (4 MB, each read by three cells, mostly from cache), the costs (8 MB) and
// one label's value of each of the five state arrays (20 MB), but each
// 4-byte value picked out of a 32-byte sector of its label plane, so up to
// the five arrays' 80 MB in sectors: 32-92 MB, 10-27 us at 3.35 TB/s; 39 us
// for both kernels on the H100, so it moves its sectors at about 2.4 TB/s.
// grid_bound_kernel: the dual bound, GridPottsModel._lower_bound_impl's
// (ops/grid_kernels.lower_bound_ref): per cell the min over the labels of u,
// per edge the Potts pair-min of its two slots and its cost, each term
// computed in float32 operation for operation as the plain ops do and summed
// in float64.  What bounds it: bytes.  It must read the state and the costs
// once, 87.93 MB at 1000x1000, L=4 (16.00 MB of u, 4 x 15.984 of slots, 2 x
// 3.996 of costs): 26.2 us at 3.35 TB/s, with a few flops per value.  The
// plain ops took about 460 us: some 30 launches, each writing or reading a
// 4-16 MB intermediate, about 1 GB in all.  This design reads each array
// once, in its own flat index space (cells, horizontal edges, vertical
// edges), with no intermediate: a thread takes a quad of each space at the
// same index, and for L <= 4 (the label count a template parameter, as in
// K2) issues every load of its three quads before the first use, so one
// round trip to memory serves a step; the planes move as 16-byte loads where
// a space's length is a multiple of 4 and its arrays 16-byte aligned (all
// three at 1000x1000), else as 4-byte loads; other L take one label at a
// time.  The per-thread float64 sums go to one partial per block through
// block_sum, and grid_primal_sum_kernel folds the partials, both in a fixed
// order and with no atomics: a state gives the same bound bit for bit on
// every replay, within 1e-12 of the plain float64 sums, which add the same
// float32 terms in another order.  NaN propagates as torch.amin does
// (nan_min, never fminf).  On the H100 (phase_bench.py, graph replay) both
// kernels take 62-63 us a bound, 42 % of the bound, against 480 us for the
// plain ops.  At L=4 the kernel takes 154 registers (ptxas), so an SM holds
// one block of 256 threads and the 977 blocks run in 7.4 waves; each wave's
// round trip to memory and block reduction, with nothing else on the SM, is
// the likely remaining cost (not measured).
// Rounding: the products that feed an add go through __fmul_rn, which the
// compiler never contracts into an FMA, so both kernels round like the plain
// torch ops, one IEEE operation at a time.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kMaxRoundLabels = 32;
constexpr int kSlab = 4;  // slab rows per side; covers the round kernel's halo P <= 4
constexpr float kBig = 3e38f;
// Round kernel geometry.  kRoundBand rows are a band, the rows a phase
// takes a step; a strip loads one of kRoundLoadedWidths columns (the widest
// that fits, T_c + 2P); at most kRoundMaxAhead bands are in flight.
constexpr int kRoundMaxThreads = 512;  // 2 P * S_c / 2
constexpr int kRoundLoadedWidths[3] = {64, 32, 16};
constexpr int kRoundBand = 1;
constexpr int kRoundMaxAhead = 8;  // cp_async_wait_pending takes up to 7 pending
constexpr int kRoundMinRows = 8;   // rows a segment writes, at least (the default)

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
// Returns the post-receive cost uu.
__device__ __forceinline__ float phase_cell(const float (&own)[5], bool recv, const bool (&ex)[4],
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
  return uu;
}

// One step of an argmin over the labels in order, as torch.argmin picks: the
// first NaN, else the first minimum.
__device__ __forceinline__ void argmin_step(float v, int l, float& best, int& x) {
  if (l == 0 || (!isnan(best) && (isnan(v) || v < best))) {
    best = v;
    x = l;
  }
}

// A thread updates a horizontal pair of cells, A = (r, c0) and B = (r, c0 + 1)
// with c0 even: one of each colour, so every lane of a warp (32 pairs of one
// row) takes the same path, and a warp's loads and stores cover 64
// consecutive floats of a row.  With kL > 0 labels (exactly L) every value
// of the pair is loaded into registers before the first use: one round trip
// to memory per thread, no loop and no branch.  kL == 0 takes any L: the
// receiving cell's min statistics in a pass of their own, then one label at
// a time.  With kLabelsOut (dense only) each cell of recv_color or
// send_color also writes the argmin of its uu into labels [H, W].
template <bool kSharded, int kL, bool kVec, bool kLabelsOut>
__device__ __forceinline__ void phase_body(const Grid& g, int recv_color, int send_color,
                                           float leave, int* labels) {
  static_assert(!(kSharded && kLabelsOut), "labels are written on the dense grid only");
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
  float bestA = 0.0f, bestB = 0.0f;  // kLabelsOut: the argmin so far of A's and B's uu
  int xA = 0, xB = 0;
  auto update = [&](int l, const float (&a)[5], const float (&b)[5], const float (&o)[4],
                    const MinExcept (&st)[4]) {
    float outA[5], outB[5];
    const float uuA = phase_cell(a, recvA, exA, o, st, cost, omegaA, keepA, L, outA);
    const float uuB = phase_cell(b, recvB, exB, o, st, cost, omegaB, keepB, L, outB);
    if constexpr (kLabelsOut) {
      argmin_step(uuA, l, bestA, xA);
      argmin_step(uuB, l, bestB, xB);
    }
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
  if constexpr (kLabelsOut) {  // the cells this phase updates, as _round_impl's mask has them
    int* const x = labels + (long)r * W + c0;
    if (recv_color == colorA || send_color == colorA) x[0] = xA;
    if (hasB && (recv_color == colorB || send_color == colorB)) x[1] = xB;
  }
}

template <bool kSharded, int kL, bool kVec>
__global__ void __launch_bounds__(kPhasePairs* kPhaseRows)
    grid_phase_kernel(const Grid g, int recv_color, int send_color, float leave) {
  phase_body<kSharded, kL, kVec, false>(g, recv_color, send_color, leave, nullptr);
}

template <int kL, bool kVec>
__global__ void __launch_bounds__(kPhasePairs* kPhaseRows)
    grid_round_primal_kernel(const Grid g, int recv_color, int send_color, float leave,
                             int* labels) {
  phase_body<false, kL, kVec, true>(g, recv_color, send_color, leave, labels);
}

// ---------------------------------------------------------------------------
// the rounding's cost pass
// ---------------------------------------------------------------------------
constexpr int kCostThreads = 256;

// Sums v over a block's threads in a fixed tree order; thread 0 gets the sum.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double part[kCostThreads];
  part[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = kCostThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  return part[0];
}

// The cost of the labelling x of the dense grid, in float64, one partial
// per block: per cell u[x] and, for its right and lower edge, its own slot
// at x, the neighbour's slot at the neighbour's label and the Potts cost
// where the labels differ.  A label outside [0, L) makes the cost NaN.
__global__ void __launch_bounds__(kCostThreads)
    grid_primal_cost_kernel(const Grid g, const int* x, double* partials) {
  const int L = g.L, H = g.H, W = g.W;
  const long cells = (long)H * W, sh = (long)H * (W - 1), sv = (long)(H - 1) * W;
  const float *u = g.u.win, *hm1 = g.hm1.win, *hm2 = g.hm2.win, *vm1 = g.vm1.win;
  const float *vm2 = g.vm2.win, *hc = g.hc.win, *vc = g.vc.win;
  double acc = 0.0;
  for (long i = (long)blockIdx.x * kCostThreads + threadIdx.x; i < cells;
       i += (long)gridDim.x * kCostThreads) {
    const int r = (int)(i / W), c = (int)(i - (long)r * W);
    const bool right = c < W - 1, down = r < H - 1;
    const int xi = __ldg(x + i);
    const int xr = right ? __ldg(x + i + 1) : xi, xb = down ? __ldg(x + i + W) : xi;
    if ((unsigned)xi >= (unsigned)L || (unsigned)xr >= (unsigned)L ||
        (unsigned)xb >= (unsigned)L) {
      acc = nan("");
      continue;
    }
    acc += (double)__ldg(u + xi * cells + i);
    if (right) {
      const long e = (long)r * (W - 1) + c;
      acc += (double)__ldg(hm1 + xi * sh + e);
      acc += (double)__ldg(hm2 + xr * sh + e);
      if (xi != xr) acc += (double)__ldg(hc + e);
    }
    if (down) {
      acc += (double)__ldg(vm1 + xi * sv + i);
      acc += (double)__ldg(vm2 + xb * sv + i);
      if (xi != xb) acc += (double)__ldg(vc + i);
    }
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kCostThreads)
    grid_primal_sum_kernel(const double* partials, int n, double* out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kCostThreads) acc += partials[i];
  const double s = block_sum(acc);
  if (threadIdx.x == 0) *out = s;
}

// ---------------------------------------------------------------------------
// the dual bound
// ---------------------------------------------------------------------------
constexpr float kFltMax = 3.40282347e38f;  // torch.finfo(float32).max: two_min's mask

// min(a, b) that is NaN where either is, as torch.amin and torch.minimum
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || isnan(a)) ? a : b; }

// ops/reductions.two_min of one slot over the labels, in one pass: the min a,
// the first label i that takes it, and s, the min over the other labels
// starting from kFltMax (two_min masks label i with the dtype's max)
struct TwoMin {
  float a, s;
  int i;
};

// _potts_min_pair's statistics of one edge: diag = min over l of m1 + m2, and
// two_min of m1 and of m2
struct PairStats {
  float diag;
  TwoMin t1, t2;
};

__device__ __forceinline__ void two_min_step(TwoMin& t, float v, int l) {
  if (l == 0) {
    t = {v, kFltMax, 0};
  } else if (v < t.a) {
    t.s = nan_min(t.s, t.a);
    t.a = v;
    t.i = l;
  } else {
    t.s = nan_min(t.s, v);
  }
}

__device__ __forceinline__ void pair_step(PairStats& p, float x1, float x2, int l) {
  const float d = x1 + x2;
  p.diag = l == 0 ? d : nan_min(p.diag, d);
  two_min_step(p.t1, x1, l);
  two_min_step(p.t2, x2, l);
}

// min over (x1, x2) of m1[x1] + m2[x2] + cost * [x1 != x2], operation for
// operation as _potts_min_pair: min(diag, off) with off = (i1 != i2 ? a1 + a2
// : min(a1 + s2, s1 + a2)) + cost; diag alone for L == 1
__device__ __forceinline__ float pair_min(const PairStats& p, float cost, int L) {
  if (L == 1) return p.diag;
  const float off = (p.t1.i != p.t2.i ? p.t1.a + p.t2.a
                                      : nan_min(p.t1.a + p.t2.s, p.t1.s + p.t2.a)) + cost;
  return nan_min(p.diag, off);
}

// Elements [i, i + 4) of a plane of n floats at p where `ok`: one 16-byte
// load where `wide` (n a multiple of 4 and p 16-byte aligned, so i + 4 <= n),
// else a 4-byte load of each element below n; zeros elsewhere (never summed).
__device__ __forceinline__ void load_quad(const float* p, long i, long n, bool ok, bool wide,
                                          float (&x)[4]) {
  if (wide) {
    const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(p + i))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = (ok && i + k < n) ? __ldg(p + i + k) : 0.0f;
  }
}

// The three index spaces of the bound: cells (u), horizontal edges (hm1, hm2,
// hc) and vertical edges (vm1, vm2, vc), each with its length and whether its
// planes take 16-byte loads.
struct BoundTerms {
  const float *u, *m1[2], *m2[2], *c[2];  // [0]: horizontal edges, [1]: vertical
  long n[3];                              // cells, horizontal edges, vertical edges
  unsigned wide;                          // bit t: term t takes 16-byte loads
};

// The bound's float64 sum over one quad [i, i + 4) of each index space: per
// cell the min over the labels of u, per edge pair_min, added in the order
// cell, horizontal edge, vertical edge of each k.  With kL > 0 labels
// (exactly L) every value of the quads is loaded before the first use; kL ==
// 0 takes any L, one label at a time.
template <int kL>
__device__ __forceinline__ double bound_quad(const BoundTerms& b, long i, int L) {
  bool ok[3], wide[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    ok[t] = i < b.n[t];
    wide[t] = (b.wide >> t) & 1;
  }
  float cmin[4];
  PairStats st[2][4];
  float cost[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) load_quad(b.c[e], i, b.n[1 + e], ok[1 + e], wide[1 + e], cost[e]);
  auto step = [&](int l, const float (&x)[4], const float (&y1)[2][4], const float (&y2)[2][4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cmin[k] = l == 0 ? x[k] : nan_min(cmin[k], x[k]);
#pragma unroll
      for (int e = 0; e < 2; ++e) pair_step(st[e][k], y1[e][k], y2[e][k], l);
    }
  };
  if constexpr (kL > 0) {
    float x[kL][4], y1[kL][2][4], y2[kL][2][4];
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      load_quad(b.u + l * b.n[0], i, b.n[0], ok[0], wide[0], x[l]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        load_quad(b.m1[e] + l * b.n[1 + e], i, b.n[1 + e], ok[1 + e], wide[1 + e], y1[l][e]);
        load_quad(b.m2[e] + l * b.n[1 + e], i, b.n[1 + e], ok[1 + e], wide[1 + e], y2[l][e]);
      }
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) step(l, x[l], y1[l], y2[l]);
  } else {
    for (int l = 0; l < L; ++l) {
      float x[4], y1[2][4], y2[2][4];
      load_quad(b.u + l * b.n[0], i, b.n[0], ok[0], wide[0], x);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        load_quad(b.m1[e] + l * b.n[1 + e], i, b.n[1 + e], ok[1 + e], wide[1 + e], y1[e]);
        load_quad(b.m2[e] + l * b.n[1 + e], i, b.n[1 + e], ok[1 + e], wide[1 + e], y2[e]);
      }
      step(l, x, y1, y2);
    }
  }
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i + k < b.n[0]) acc += (double)cmin[k];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (i + k < b.n[1 + e]) acc += (double)pair_min(st[e][k], cost[e][k], L);
    }
  }
  return acc;
}

// The dual bound of the dense grid in float64, one partial per block: a
// thread takes a quad of cells, of horizontal edges and of vertical edges a
// step, the three quads at the same index i, with a grid-stride loop over
// the cells (the longest of the three spaces).  No name of the pattern
// grid_round_kernel<.., false or grid_phase_kernel<false: the benchmark's
// roofline readers match K1 and K2 by those.
template <int kL>
__global__ void __launch_bounds__(kCostThreads)
    grid_bound_kernel(const BoundTerms b, int L, double* partials) {
  double acc = 0.0;
  for (long i = 4 * ((long)blockIdx.x * kCostThreads + threadIdx.x); i < b.n[0];
       i += 4L * gridDim.x * kCostThreads) {
    acc += bound_quad<kL>(b, i, L);
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// round kernel
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int round_halo(int nr) { return 2 * nr; }

// A round launch's geometry.  Each block owns one segment of one column strip:
// it writes T_r x T_c cells and streams the T_r + 2P rows of its S_c = T_c +
// 2P loaded columns (a halo of P = 2 * NR on every side) from top to bottom,
// kRoundBand rows a step, through a ring of rows in shared memory.
struct RoundTile {
  int tr, tc;   // rows of a segment and columns of a strip written (R, T_c)
  int sr, sc;   // rows streamed and columns loaded: R + 2P, T_c + 2P
  int hw;       // cells of one colour in a loaded row: S_c / 2
  int ahead;    // bands in flight while the phases run
  int ring;     // rows of the ring: (2P + 1 + ahead) bands
  int threads;  // 2 P * hw: a column of a phase each (kRoundBand cells), as many producers
  int hp;       // floats of one colour half-plane: ring * hw, padded to 16 mod 32
  int per_sm;   // blocks per SM the ring was sized for
  size_t smem;  // dynamic shared memory: (5 L + 2) planes of 2 * hp floats
};

RoundTile make_round_tile(int L, int nr, int tr, int tc, int ahead, int per_sm) {
  const int p = round_halo(nr);
  RoundTile t;
  t.tr = tr;
  t.tc = tc;
  t.sr = tr + 2 * p;
  t.sc = tc + 2 * p;
  t.hw = t.sc / 2;
  t.ahead = ahead;
  t.ring = (2 * p + 1 + ahead) * kRoundBand;
  t.threads = 2 * p * t.hw;
  const int base = t.ring * t.hw;
  t.hp = base + ((16 - base % 32) + 32) % 32;  // the two halves 16 banks apart
  t.per_sm = per_sm;
  t.smem = (5 * (size_t)L + 2) * 2 * t.hp * sizeof(float);
  return t;
}

// What the card offers a round launch (queried once per device).
struct Card {
  int sms;         // streaming multiprocessors
  int smem_sm;     // shared memory of an SM
  int smem_block;  // the most a block may take
  int reserved;    // what the runtime keeps of an SM's shared memory per block
};

constexpr int kMaxDevices = 64;

cudaError_t card_of(int dev, Card* c) {
  static std::atomic<int> known[kMaxDevices][4];  // 0 before the first query
  const bool cached = dev >= 0 && dev < kMaxDevices;
  const cudaDeviceAttr attr[4] = {cudaDevAttrMultiProcessorCount,
                                  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  cudaDevAttrReservedSharedMemoryPerBlock};
  int v[4];
  for (int k = 0; k < 4; ++k) {
    v[k] = cached ? known[dev][k].load() : 0;
    if (v[k] == 0) {
      const cudaError_t err = cudaDeviceGetAttribute(&v[k], attr[k], dev);
      if (err != cudaSuccess) return err;
      if (cached) known[dev][k].store(v[k]);
    }
  }
  *c = {v[0], v[1], v[2], v[3]};
  return cudaSuccess;
}

bool round_tile_ok(const RoundTile& t, const Card& card) {
  return t.tr >= 1 && t.tc >= 2 && t.tc % 2 == 0 && t.threads <= kRoundMaxThreads &&
         t.ahead >= 1 && t.ahead <= kRoundMaxAhead && t.smem <= (size_t)card.smem_block;
}

// The geometry of a launch over n window rows of W columns: T_r = tile_rows
// and T_c = tile_cols where positive (for a sweep), else the kernel's own.
// Its own T_c is the widest of kRoundLoadedWidths less the halo whose ring,
// with at least one band in flight, fits the shared memory of two blocks per
// SM (else of one); the ring then takes as many bands in flight as fit, up
// to kRoundMaxAhead.  Its own T_r splits the rows so that the strips times
// the segments fill one wave of blocks, with at least kRoundMinRows rows.
bool pick_round_tile(int L, int n_rounds, int n, int W, int tile_rows, int tile_cols,
                     const Card& card, RoundTile* t) {
  if (n_rounds != 1 && n_rounds != 2) return false;
  const int p = round_halo(n_rounds);
  for (int per_sm = 2; per_sm >= 1; --per_sm) {
    const long budget = std::min((long)card.smem_sm / per_sm - card.reserved,
                                 (long)card.smem_block);
    for (const int sc : kRoundLoadedWidths) {
      const int tc = tile_cols > 0 ? tile_cols : sc - 2 * p;
      if (tc < 2) continue;
      int ahead = kRoundMaxAhead;
      while (ahead >= 1 && (long)make_round_tile(L, n_rounds, 1, tc, ahead, per_sm).smem > budget) {
        --ahead;
      }
      if (ahead < 1) {
        if (tile_cols > 0) break;  // a forced width: try one block per SM
        continue;
      }
      int tr = tile_rows;
      if (tr <= 0) {
        const int strips = (W + tc - 1) / tc;
        const int segments = std::max(1, per_sm * card.sms / strips);
        tr = std::max(kRoundMinRows, (n + segments - 1) / segments);
      }
      *t = make_round_tile(L, n_rounds, tr, tc, ahead, per_sm);
      return round_tile_ok(*t, card);
    }
  }
  return false;
}

// Where one cell's values lie in their planes: its own (u and the slots of
// its right, left, lower and upper edges: hm1, hm2, vm1, vm2), the other
// slot of each edge (hm2 of the right neighbour, hm1 of the left, vm2 of the
// lower, vm1 of the upper) and the edges' costs.
struct CellAt {
  int u, a, b, d, t;
  int qr, ql, qd, qu;
  int cr, cl, cd, cu;
};

// One cell's phase update in shared memory, its values at `at` in label
// plane 0 (PL floats a plane).  With kL > 0 labels (exactly L) every value
// is loaded into registers before the first use; kL == 0 takes any L, the
// neighbours' min statistics in a pass of their own, then one label at a
// time.  Same arithmetic and order of adds either way.
template <int kL>
__device__ __forceinline__ void round_cell(float* s_u, float* s_a, float* s_b, float* s_d,
                                           float* s_t, const float* s_hc, const float* s_vc,
                                           int PL, int L, const CellAt& at, bool right, bool left,
                                           bool down, bool up, float omega, float keep) {
  const float cr = right ? s_hc[at.cr] : 0.0f, cl = left ? s_hc[at.cl] : 0.0f;
  const float cd = down ? s_vc[at.cd] : 0.0f, cu = up ? s_vc[at.cu] : 0.0f;
  if constexpr (kL > 0) {
    // every load lies in the ring (the phase's rows and columns shrink), so
    // the slots of absent edges are read too, and not used
    float uu[kL], ow[kL][4], ot[kL][4];
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const int o = l * PL;
      uu[l] = s_u[at.u + o];
      ow[l][0] = s_a[at.a + o];
      ow[l][1] = s_b[at.b + o];
      ow[l][2] = s_d[at.d + o];
      ow[l][3] = s_t[at.t + o];
      ot[l][0] = s_b[at.qr + o];
      ot[l][1] = s_a[at.ql + o];
      ot[l][2] = s_t[at.qd + o];
      ot[l][3] = s_d[at.qu + o];
    }
    const bool ex[4] = {right, left, down, up};
    const float cost[4] = {cr, cl, cd, cu};
    MinExcept st[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // min_except_stats, in label order
      st[e] = {ot[0][e], kBig};
#pragma unroll
      for (int l = 1; l < kL; ++l) {
        st[e].s = fminf(st[e].s, fmaxf(st[e].m, ot[l][e]));
        st[e].m = fminf(st[e].m, ot[l][e]);
      }
    }
    float* const slot[4] = {s_a + at.a, s_b + at.b, s_d + at.d, s_t + at.t};
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const int o = l * PL;
      float v = uu[l];
      float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // same order of adds as the plain version
        if (ex[e]) {
          m[e] = potts_marg(ow[l][e], ot[l][e], st[e], cost[e], kL);
          v += m[e];
        }
      }
      const float d = __fmul_rn(v, omega);
      s_u[at.u + o] = v * keep;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ex[e]) slot[e][o] = (ow[l][e] - m[e]) + d;
      }
    }
  } else {
    MinExcept st_r{0.0f, 0.0f}, st_l{0.0f, 0.0f}, st_d{0.0f, 0.0f}, st_u{0.0f, 0.0f};
    if (right) st_r = min_except_stats(s_b + at.qr, PL, L);
    if (left) st_l = min_except_stats(s_a + at.ql, PL, L);
    if (down) st_d = min_except_stats(s_t + at.qd, PL, L);
    if (up) st_u = min_except_stats(s_d + at.qu, PL, L);
    float *pu = s_u + at.u, *pa = s_a + at.a, *pb = s_b + at.b, *pd = s_d + at.d, *pt = s_t + at.t;
    const float *qr = s_b + at.qr, *ql = s_a + at.ql, *qd = s_t + at.qd, *qu = s_d + at.qu;
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
}

__device__ __forceinline__ int ring_next(int slot, int ring) {
  slot += kRoundBand;
  return slot >= ring ? slot - ring : slot;
}

// The ring row of streamed row i (any sign).
__device__ __forceinline__ int ring_row(int i, int ring) { return ((i % ring) + ring) % ring; }

// kWide (NR = 2, L <= kPhaseRegLabels, W a multiple of 4, the W-wide
// arrays and their label strides 16-byte aligned): u, vm1, vm2 and vc (rows
// of W floats) move as 16-byte copies into planes in natural column order
// and leave as 16-byte stores; hm1, hm2 and hc (rows of W - 1 floats, not
// 16-byte aligned) keep one float a copy into colour-split planes.  Else
// every array takes the colour-split planes and one float a copy.
template <int NR, bool kSharded, int kL, bool kWide>
__global__ void __launch_bounds__(kRoundMaxThreads) grid_round_kernel(const Grid g,
                                                                      const RoundTile t) {
  constexpr int P = round_halo(NR);
  constexpr int B = kRoundBand;
  constexpr int kGroups = P / 2;  // producer groups of S_c threads
  static_assert(P <= kSlab, "the slabs cover the round kernel's halo");
  static_assert(P % 2 == 0, "a whole number of S_c-thread groups");
  static_assert(!kWide || (kL > 0 && P % 4 == 0), "16-byte columns need P a multiple of 4");
  // 16-byte items a producer takes a band row: copies of the 3L + 1 W-wide
  // planes' S_c / 4 chunks, stores of the 3L state planes' T_c / 4 chunks
  constexpr int kWideItems = kWide ? (3 * kL + 1 + 2 * P - 1) / (2 * P) : 0;
  const int L = kL > 0 ? kL : g.L, H = g.H, W = g.W, n = g.n;
  const int HW = t.hw, SC = t.sc, PL = 2 * t.hp, NB = t.ring;
  extern __shared__ float smem[];
  // every slot at its owner cell
  float* s_u = smem;
  float* s_a = s_u + L * PL;  // own slot of the edge to the right: hm1 (r, c)
  float* s_b = s_a + L * PL;  // own slot of the edge to the left: hm2 (r, c - 1)
  float* s_d = s_b + L * PL;  // own slot of the edge below: vm1 (r, c)
  float* s_t = s_d + L * PL;  // own slot of the edge above: vm2 (r - 1, c) in the dense layout
  float* s_hc = s_t + L * PL;  // cost of the edge to the right
  float* s_vc = s_hc + PL;     // cost of the edge below

  // segment origin in window coordinates (may lie outside: those cells are
  // absent); the segment's written rows rw, its streamed rows sr, in bands
  const int R0 = blockIdx.y * t.tr - P, C0 = blockIdx.x * t.tc - P;
  const int rw = min(t.tr, n - (R0 + P));
  const int sr = rw + 2 * P, bands = (sr + B - 1) / B;
  const int shift = (g.row0 + R0 + C0) & 1;  // global parity of streamed cell (0, 0)
  const int consumers = P * HW;              // the first threads run the phases
  const bool producer = (int)threadIdx.x >= consumers;
  const int tid = producer ? threadIdx.x - consumers : threadIdx.x;

  // Producers: copies and stores, thread column lc of S_c in group lg.
  const int lc = tid % SC, lg = tid / SC;
  const int cl = C0 + lc;
  const bool in_w = cl >= 0 && cl < W, in_w1 = in_w && cl < W - 1, in_w2 = in_w && cl >= 1;
  // kWide: this producer's 16-byte items, the same every band row.  Copy
  // item k: array wa (0 u, 3 vm1, 4 vm2, 6 vc), label wl, plane offset wo of
  // its chunk in ring row 0, first column wc; store item k: array xa, label
  // xl, plane offset xo in ring row 0, output column xc.
  int wa[kWideItems > 0 ? kWideItems : 1], wl[kWideItems > 0 ? kWideItems : 1];
  int wo[kWideItems > 0 ? kWideItems : 1], wc[kWideItems > 0 ? kWideItems : 1];
  int xa[kWideItems > 0 ? kWideItems : 1], xl[kWideItems > 0 ? kWideItems : 1];
  int xo[kWideItems > 0 ? kWideItems : 1], xc[kWideItems > 0 ? kWideItems : 1];
  if constexpr (kWide) {
    const int nq = SC / 4, nx = t.tc / 4;
#pragma unroll
    for (int k = 0; k < kWideItems; ++k) {
      const int item = tid + k * consumers;
      const int pw = item / nq, q = item % nq;  // plane of the 3L + 1, chunk
      wa[k] = pw >= 3 * kL + 1 ? -1 : pw == 3 * kL ? 6 : pw < kL ? 0 : pw < 2 * kL ? 3 : 4;
      wl[k] = pw == 3 * kL ? 0 : pw % kL;
      wo[k] = wa[k] < 0 ? 0
                        : (wa[k] == 6 ? (int)(s_vc - smem) : wa[k] * kL * PL) + wl[k] * PL + 4 * q;
      wc[k] = C0 + 4 * q;
      const int px = item / nx, qx = item % nx;  // plane of the 3L, chunk
      xa[k] = px >= 3 * kL ? -1 : px < kL ? 0 : px < 2 * kL ? 3 : 4;
      xl[k] = px % kL;
      xo[k] = xa[k] < 0 ? 0 : xa[k] * kL * PL + xl[k] * PL + P + 4 * qx;
      xc[k] = C0 + P + 4 * qx;
    }
  }
  auto load_band = [&](int band, int slot0) {
    if (band >= bands) return;
#pragma unroll
    for (int rr = 0; rr < B; ++rr) {
      const int i = band * B + rr;
      if (i >= sr) continue;
      const int r = R0 + i, gr = g.row0 + r;
      const bool row_ok = gr >= 0 && gr < H && readable<kSharded>(g, r);
      const bool dn_ok = row_ok && gr < H - 1, up_ok = row_ok && gr > 0;
      // colour-split planes: streamed cell (i, j) at ((i + j) & 1) * hp + ring
      // row * hw + j / 2; a cell that does not exist, or whose row cannot be
      // read, is 0
      const int d = ((i + lc) & 1) * t.hp + (slot0 + rr) * HW + (lc >> 1);
#pragma unroll
      for (int a = 0; a < 7; ++a) {
        // kWide: the W-wide arrays below; the others round robin over the groups
        const int nth = kWide ? (a == 1 ? 0 : a == 2 ? 1 : 2) : a;
        if ((kWide && (a == 0 || a == 3 || a == 4 || a == 6)) || (nth * B + rr) % kGroups != lg) {
          continue;
        }
        // (array, its plane, labels, row flag, columns that exist, source column offset)
        const Rows& src = a == 0 ? g.u : a == 1 ? g.hm1 : a == 2 ? g.hm2 : a == 3 ? g.vm1
                        : a == 4 ? g.vm2 : a == 5 ? g.hc : g.vc;
        float* const plane = a < 5 ? s_u + a * L * PL : a == 5 ? s_hc : s_vc;
        const bool ok = (a == 3 || a == 6 ? dn_ok : a == 4 ? up_ok : row_ok) &&
                        (a == 1 || a == 5 ? in_w1 : a == 2 ? in_w2 : in_w);
        const float* p = g.u.win;  // any valid address: nothing is read where !ok
        long ls = 0;
        if (ok) {
          const RowPtr rp = row<kSharded>(src, n, r);
          p = rp.p + cl - (a == 2);
          ls = rp.ls;
        }
        for (int l = 0; l < (a < 5 ? L : 1); ++l) cp_async_f32(plane + d + l * PL, p + l * ls, ok);
      }
      if constexpr (kWide) {
        const int ro = (slot0 + rr) * SC;
#pragma unroll
        for (int k = 0; k < kWideItems; ++k) {
          if (wa[k] < 0) continue;
          const Rows& src = wa[k] == 0 ? g.u : wa[k] == 3 ? g.vm1 : wa[k] == 4 ? g.vm2 : g.vc;
          const bool ok = (wa[k] == 0 ? row_ok : wa[k] == 4 ? up_ok : dn_ok) && wc[k] >= 0 &&
                          wc[k] < W;  // a chunk lies all inside or all outside
          const float* p = g.u.win;
          if (ok) {
            const RowPtr rp = row<kSharded>(src, n, r);
            p = rp.p + wl[k] * rp.ls + wc[k];
          }
          cp_async_16(smem + wo[k] + ro, p, ok);
        }
      }
    }
  };
  // write a final band: each cell's u and own slots (zeros for an inert row
  // and for slots of absent edges in a shard); the producers store u, vm1
  // and vm2 (uvm), the consumers, beside their phase, hm1 and hm2
  const int js = P + lc, cs = C0 + js;
  const bool st_col = lc < t.tc && cs < W, right = cs < W - 1, left = cs > 0;
  auto store_band = [&](int band, int slot0, bool uvm) {
    if (band < 0) return;
#pragma unroll
    for (int rr = 0; rr < B; ++rr) {
      const int i = band * B + rr;
      if (i < P || i >= P + rw) continue;
      const int r = R0 + i, gr = g.row0 + r;
      const bool live = !kSharded || gr < H;
      const bool down = live && gr < H - 1, up = live && gr > 0;
      if constexpr (kWide) {  // u, vm1, vm2 from their natural planes, 4 columns a store
        const int ro = (slot0 + rr) * SC;
        float4 v[kWideItems];
#pragma unroll
        for (int k = 0; k < kWideItems; ++k) {
          const bool keep = xa[k] == 3 ? down : xa[k] == 4 ? up : live;  // else the slot gets 0
          const bool mine = uvm && xa[k] >= 0 && xc[k] < W;
          v[k] = mine && keep ? *reinterpret_cast<const float4*>(smem + xo[k] + ro)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int k = 0; k < kWideItems; ++k) {
          const bool has = xa[k] == 0 || (xa[k] == 3 && (down || kSharded)) ||
                           (xa[k] == 4 && (up || kSharded));
          if (!uvm || xa[k] < 0 || xc[k] >= W || !has) continue;
          const OutRows& o = xa[k] == 0 ? g.u_o : xa[k] == 3 ? g.vm1_o : g.vm2_o;
          __stcs(reinterpret_cast<float4*>(out_at(o, xl[k], r, xc[k])), v[k]);
        }
      }
      if (!st_col || (kWide && uvm)) continue;
      const int o0 = ((i + js) & 1) * t.hp + (slot0 + rr) * HW + (js >> 1);
      // every value first, then the stores: a store's asm keeps every shared
      // load after it from moving ahead
      float v[5][kL > 0 ? kL : 1];
      float* dst[5];
      bool has[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        const OutRows& o = a == 0 ? g.u_o : a == 1 ? g.hm1_o : a == 2 ? g.hm2_o
                         : a == 3 ? g.vm1_o : g.vm2_o;
        has[a] = (a == 1 || a == 2) != uvm &&  // the arrays this role stores
                 (a == 0 || (a == 1 && right) || (a == 2 && left) ||
                  (a == 3 && (down || kSharded)) || (a == 4 && (up || kSharded)));
        dst[a] = has[a] ? out_at(o, 0, r, cs - (a == 2)) : nullptr;
      }
      if constexpr (kL > 0) {
#pragma unroll
        for (int a = 0; a < 5; ++a) {
          const bool keep = a == 3 ? down : a == 4 ? up : live;  // else the slot gets 0
          const float* const sv = s_u + a * L * PL + o0;
#pragma unroll
          for (int l = 0; l < kL; ++l) {
            const bool mine = has[a] && ((a * B + rr) * kL + l) % kGroups == lg;
            v[a][l] = mine && keep ? sv[l * PL] : 0.0f;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        if (!has[a]) continue;
        const long ls = a == 0 ? g.u_o.ls : a == 1 ? g.hm1_o.ls : a == 2 ? g.hm2_o.ls
                      : a == 3 ? g.vm1_o.ls : g.vm2_o.ls;
        const bool keep = a == 3 ? down : a == 4 ? up : live;
        const float* const sv = s_u + a * L * PL + o0;
        for (int l = 0; l < L; ++l) {  // streaming stores: not read again here
          if (((a * B + rr) * L + l) % kGroups != lg) continue;
          float val;
          if constexpr (kL > 0) {
            val = v[a][l];
          } else {
            val = keep ? sv[l * PL] : 0.0f;
          }
          __stcs(dst[a] + l * ls, val);
        }
      }
    }
  };

  // Consumers: phase k (1..P), cell x of a colour in each row of a band.
  // Phase k updates the cells of one colour (a colour half-plane: a
  // thread row reads and writes consecutive floats, and their neighbours lie
  // in the other half at the same offsets) within P - k of the written
  // cells: the ones those cells still depend on.
  const int k = tid / HW + 1, x = tid % HW;
  const int q = (k & 1) ^ shift;  // half-plane that updates: red (odd r + c) first
  const int own0 = q * t.hp, oth0 = (q ^ 1) * t.hp;
  auto phase_row = [&](int i, int slot) {
    if (i < k || i >= sr - k) return;
    const int b = (q ^ i) & 1;
    const int j = 2 * x + b;
    const int r = R0 + i, gr = g.row0 + r, c = C0 + j;
    if (j < k || j >= SC - k || gr < 0 || gr >= H || c < 0 || c >= W ||
        !readable<kSharded>(g, r)) {
      return;
    }
    const bool right = c < W - 1, left = c > 0, down = gr < H - 1, up = gr > 0;
    const float deg = (float)right + (float)left + (float)down + (float)up;
    const float omega = 1.0f / fmaxf(deg, 1.0f);
    const float keep = 1.0f - __fmul_rn(omega, deg);
    const int su = slot == 0 ? NB - 1 : slot - 1, sd = slot == NB - 1 ? 0 : slot + 1;
    const int own = own0 + slot * HW + x;
    const int nr = oth0 + slot * HW + x + b;  // cell (i, j + 1); (i, j - 1) is nr - 1
    CellAt at;
    at.a = at.b = at.cr = own;
    at.qr = nr;
    at.ql = at.cl = nr - 1;
    if constexpr (kWide) {  // u, vm1, vm2, vc in natural column order
      at.u = at.d = at.t = at.cd = slot * SC + j;
      at.qd = sd * SC + j;
      at.qu = at.cu = su * SC + j;
    } else {
      at.u = at.d = at.t = at.cd = own;
      at.qd = oth0 + sd * HW + x;
      at.qu = at.cu = oth0 + su * HW + x;
    }
    round_cell<kL>(s_u, s_a, s_b, s_d, s_t, s_hc, s_vc, PL, L, at, right, left, down, up, omega,
                   keep);
  };
  auto phase = [&](int band, int slot0) {
    if (band < 0 || band >= bands) return;
#pragma unroll
    for (int rb = 0; rb < B; ++rb) phase_row(band * B + rb, slot0 + rb);
  };

  // The pipeline.  At step s band s has landed; phase k updates band s - 2k +
  // 1, all phases at once: phase k writes one band and reads that band's
  // neighbours, which no other phase writes in the step (the bands two
  // apart), and reads them at the phase k - 1 the step before left them in;
  // band s - 2P, final since the step before, is stored (u, vm1, vm2 by the
  // producers, hm1, hm2 by the consumers), and the producers issue the copies
  // of band s + ahead.  Bands s - 2P .. s are live, and the copies of the
  // next `ahead` bands are in flight into the rest of the ring.  One barrier
  // a step.
  if (producer) {
    for (int band = 0; band < t.ahead; ++band) {
      load_band(band, band * B);
      cp_async_commit();
    }
  }
  int ld_slot = ring_row(t.ahead * B, NB), st_slot = ring_row(-2 * P * B, NB);
  int ph_slot = ring_row((1 - 2 * k) * B, NB);
  const int steps = bands + 2 * P;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if (producer) cp_async_wait_pending(t.ahead - 1);  // band s has landed (this thread's copies)
    __syncthreads();  // ... every producer's, and step s - 1 is over
    if (producer) {
      load_band(s + t.ahead, ld_slot);
      cp_async_commit();
      store_band(s - 2 * P, st_slot, true);
      ld_slot = ring_next(ld_slot, NB);
    } else {
      phase(s - 2 * k + 1, ph_slot);
      store_band(s - 2 * P, st_slot, false);
      ph_slot = ring_next(ph_slot, NB);
    }
    st_slot = ring_next(st_slot, NB);
  }
}

// A phase launch; with kLabelsOut the rounding's phase, which writes labels.
template <bool kSharded, int kL, bool kVec, bool kLabelsOut>
cudaError_t launch_phase_labels(const Grid& g, int recv_color, int send_color, float leave,
                                int* labels, cudaStream_t stream) {
  const int pairs = (g.W + 1) / 2;
  const dim3 block(kPhasePairs, kPhaseRows);
  const dim3 grid((pairs + kPhasePairs - 1) / kPhasePairs, (g.n + kPhaseRows - 1) / kPhaseRows);
  if constexpr (kLabelsOut) {
    grid_round_primal_kernel<kL, kVec><<<grid, block, 0, stream>>>(g, recv_color, send_color,
                                                                   leave, labels);
  } else {
    grid_phase_kernel<kSharded, kL, kVec><<<grid, block, 0, stream>>>(g, recv_color, send_color,
                                                                     leave);
  }
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

template <bool kSharded, int kL, bool kLabelsOut>
cudaError_t launch_phase_vec(const Grid& g, int recv_color, int send_color, float leave,
                             int* labels, cudaStream_t stream) {
  if (pairs_aligned(g)) {
    return launch_phase_labels<kSharded, kL, true, kLabelsOut>(g, recv_color, send_color, leave,
                                                               labels, stream);
  }
  return launch_phase_labels<kSharded, kL, false, kLabelsOut>(g, recv_color, send_color, leave,
                                                              labels, stream);
}

template <bool kSharded, bool kLabelsOut = false>
cudaError_t launch_phase(const Grid& g, int recv_color, int send_color, float leave,
                         cudaStream_t stream, int* labels = nullptr) {
  static_assert(kPhaseRegLabels == 4, "one instantiation per label count in registers");
  switch (g.L) {
    case 1:
      return launch_phase_vec<kSharded, 1, kLabelsOut>(g, recv_color, send_color, leave,
                                                        labels, stream);
    case 2:
      return launch_phase_vec<kSharded, 2, kLabelsOut>(g, recv_color, send_color, leave,
                                                        labels, stream);
    case 3:
      return launch_phase_vec<kSharded, 3, kLabelsOut>(g, recv_color, send_color, leave,
                                                        labels, stream);
    case 4:
      return launch_phase_vec<kSharded, 4, kLabelsOut>(g, recv_color, send_color, leave,
                                                        labels, stream);
    default:
      return launch_phase_labels<kSharded, 0, false, kLabelsOut>(g, recv_color, send_color, leave,
                                                                 labels, stream);
  }
}

// The kernel's attributes are set per device at the first launch that needs
// more dynamic shared memory than any before, and remembered: a launch under
// CUDA stream capture (a graph of the port's capture.py, set up by an eager
// warm-up launch) then makes no runtime call but the launch itself.  With g
// null, *blocks gets the blocks an SM holds at this geometry instead.
template <int NR, bool kSharded, int kL, bool kWide>
cudaError_t round_op(const Grid* g, const RoundTile& t, cudaStream_t stream, int* blocks) {
  static std::atomic<long long> smem_set[kMaxDevices];   // zero before the first launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  long long have = known ? smem_set[dev].load() : 0;
  if (have < (long long)t.smem) {
    err = cudaFuncSetAttribute(grid_round_kernel<NR, kSharded, kL, kWide>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(grid_round_kernel<NR, kSharded, kL, kWide>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    while (known && have < (long long)t.smem &&
           !smem_set[dev].compare_exchange_weak(have, (long long)t.smem)) {
    }
  }
  if (g == nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, grid_round_kernel<NR, kSharded, kL, kWide>, t.threads, t.smem);
  }
  const dim3 grid((g->W + t.tc - 1) / t.tc, (g->n + t.tr - 1) / t.tr);
  grid_round_kernel<NR, kSharded, kL, kWide><<<grid, t.threads, t.smem, stream>>>(*g, t);
  return cudaGetLastError();
}

bool aligned16(const void* p, long ls) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ls % 4 == 0;
}

// Whether the W-wide arrays move 16 bytes at a time (kWide): two rounds
// (the strips' loaded columns start on multiples of 4), T_c and W multiples
// of 4, and u, vm1, vm2, vc (windows, and in a shard their slabs) and the
// outputs of the first three 16-byte aligned, with label strides of whole
// 16-byte units.
template <bool kSharded>
bool round_wide(const Grid& g, const RoundTile& t, int n_rounds) {
  if (n_rounds != 2 || g.L > kPhaseRegLabels || t.tc % 4 || g.W % 4) return false;
  const Rows* in[4] = {&g.u, &g.vm1, &g.vm2, &g.vc};
  for (const Rows* a : in) {
    if (!aligned16(a->win, a->ls)) return false;
    if (kSharded && !(aligned16(a->top, a->tls) && aligned16(a->bot, a->bls))) return false;
  }
  const OutRows* out[3] = {&g.u_o, &g.vm1_o, &g.vm2_o};
  for (const OutRows* o : out) {
    if (!aligned16(o->p, o->ls)) return false;
  }
  return true;
}

// round_op with the label count L as a template argument where L <=
// kPhaseRegLabels (the all-in-registers cell update), else 0; kWide where
// round_wide allows it.
template <int NR, bool kSharded>
cudaError_t round_op_labels(const Grid& g, const RoundTile& t, cudaStream_t stream, int* blocks,
                            bool launch) {
  static_assert(kPhaseRegLabels == 4, "one instantiation per label count in registers");
  const Grid* gp = launch ? &g : nullptr;
  if constexpr (NR == 2) {
    if (round_wide<kSharded>(g, t, NR)) {
      switch (g.L) {
        case 1: return round_op<NR, kSharded, 1, true>(gp, t, stream, blocks);
        case 2: return round_op<NR, kSharded, 2, true>(gp, t, stream, blocks);
        case 3: return round_op<NR, kSharded, 3, true>(gp, t, stream, blocks);
        default: return round_op<NR, kSharded, 4, true>(gp, t, stream, blocks);
      }
    }
  }
  switch (g.L) {
    case 1: return round_op<NR, kSharded, 1, false>(gp, t, stream, blocks);
    case 2: return round_op<NR, kSharded, 2, false>(gp, t, stream, blocks);
    case 3: return round_op<NR, kSharded, 3, false>(gp, t, stream, blocks);
    case 4: return round_op<NR, kSharded, 4, false>(gp, t, stream, blocks);
    default: return round_op<NR, kSharded, 0, false>(gp, t, stream, blocks);
  }
}

// A launch (launch true) or the occupancy query (blocks) of the round kernel
// that takes g's window at geometry t.
template <bool kSharded>
cudaError_t round_op_nr(int n_rounds, const Grid& g, const RoundTile& t, cudaStream_t stream,
                        int* blocks, bool launch) {
  if (n_rounds == 1) return round_op_labels<1, kSharded>(g, t, stream, blocks, launch);
  return round_op_labels<2, kSharded>(g, t, stream, blocks, launch);
}

// A round launch over the window of g, at the geometry of pick_round_tile.
template <bool kSharded>
cudaError_t launch_round_nr(const Grid& g, int n_rounds, int tile_rows, int tile_cols,
                            int device, cudaStream_t stream) {
  Card card;
  cudaError_t err = card_of(device, &card);
  if (err != cudaSuccess) return err;
  RoundTile t;
  if (!pick_round_tile(g.L, n_rounds, g.n, g.W, tile_rows, tile_cols, card, &t)) {
    return cudaErrorInvalidValue;
  }
  return round_op_nr<kSharded>(n_rounds, g, t, stream, nullptr, true);
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

// A rounding phase: lpmp_grid_phase_update's arguments, plus labels, the
// int32 [H, W] labelling that the cells of recv_color and send_color write.
int lpmp_grid_round_phase_update(const float* u, const float* hm1, const float* hm2,
                                 const float* vm1, const float* vm2, const float* hc,
                                 const float* vc, float* u_o, float* hm1_o, float* hm2_o,
                                 float* vm1_o, float* vm2_o, int* labels, int L, int H, int W,
                                 int recv_color, int send_color, float leave, int device,
                                 void* stream) {
  if (L < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Grid g = dense_grid(u, hm1, hm2, vm1, vm2, hc, vc, u_o, hm1_o, hm2_o, vm1_o, vm2_o, L,
                            H, W);
  return launch_phase<false, true>(g, recv_color, send_color, leave,
                                   static_cast<cudaStream_t>(stream), labels);
}

// The cost of the labelling labels (int32 [H, W]) on the dense state, in
// float64: work[1 .. n_work) takes one partial per block of the first
// kernel (n_work - 1 blocks), work[0] their sum.
int lpmp_grid_primal_cost(const float* u, const float* hm1, const float* hm2, const float* vm1,
                          const float* vm2, const float* hc, const float* vc, const int* labels,
                          double* work, int n_work, int L, int H, int W, int device,
                          void* stream) {
  if (L < 1 || H < 1 || W < 1 || n_work < 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Grid g = dense_grid(u, hm1, hm2, vm1, vm2, hc, vc, nullptr, nullptr, nullptr, nullptr,
                            nullptr, L, H, W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  grid_primal_cost_kernel<<<n_work - 1, kCostThreads, 0, s>>>(g, labels, work + 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grid_primal_sum_kernel<<<1, kCostThreads, 0, s>>>(work + 1, n_work - 1, work);
  return cudaGetLastError();
}

// The dual bound of the dense state in float64: work[1 .. n_work) takes one
// partial per block of grid_bound_kernel (n_work - 1 blocks), work[0] their
// sum, folded by grid_primal_sum_kernel.
int lpmp_grid_lower_bound(const float* u, const float* hm1, const float* hm2, const float* vm1,
                          const float* vm2, const float* hc, const float* vc, double* work,
                          int n_work, int L, int H, int W, int device, void* stream) {
  if (L < 1 || H < 1 || W < 1 || n_work < 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BoundTerms b{u, {hm1, vm1}, {hm2, vm2}, {hc, vc},
               {(long)H * W, (long)H * (W - 1), (long)(H - 1) * W}, 0u};
  const float* const planes[3][3] = {{u, u, u}, {hm1, hm2, hc}, {vm1, vm2, vc}};
  for (int t = 0; t < 3; ++t) {
    bool wide = b.n[t] % 4 == 0;
    for (const float* p : planes[t]) wide = wide && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    b.wide |= (unsigned)wide << t;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n_work - 1;
  switch (L) {
    case 1: grid_bound_kernel<1><<<blocks, kCostThreads, 0, s>>>(b, L, work + 1); break;
    case 2: grid_bound_kernel<2><<<blocks, kCostThreads, 0, s>>>(b, L, work + 1); break;
    case 3: grid_bound_kernel<3><<<blocks, kCostThreads, 0, s>>>(b, L, work + 1); break;
    case 4: grid_bound_kernel<4><<<blocks, kCostThreads, 0, s>>>(b, L, work + 1); break;
    default: grid_bound_kernel<0><<<blocks, kCostThreads, 0, s>>>(b, L, work + 1); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grid_primal_sum_kernel<<<1, kCostThreads, 0, s>>>(work + 1, blocks, work);
  return cudaGetLastError();
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
  return launch_round_nr<false>(g, n_rounds, tile_rows, tile_cols, device,
                                static_cast<cudaStream_t>(stream));
}

// The round kernel's geometry on `device` for L labels, n_rounds and a
// window of n rows of W columns (tile_rows, tile_cols as for a launch;
// `sharded` picks the kernel of a shard's window): out = {T_r, T_c, S_r,
// S_c, band rows, bands ahead, ring rows, threads, shared bytes, blocks per
// SM the ring was sized for, blocks per SM the card holds, strips,
// segments, waves, whether the W-wide arrays move 16 bytes at a time}.
int lpmp_grid_round_tile(int L, int n_rounds, int n, int W, int tile_rows, int tile_cols,
                         int sharded, int device, long long* out) {
  if (L < 1 || L > kMaxRoundLabels || n < 1 || W < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Card card;
  err = card_of(device, &card);
  if (err != cudaSuccess) return err;
  RoundTile t;
  if (!pick_round_tile(L, n_rounds, n, W, tile_rows, tile_cols, card, &t)) {
    return cudaErrorInvalidValue;
  }
  // a dense window of aligned arrays stands for the launch's (a shard's
  // windows and slabs keep the dense alignment where W is a multiple of 4)
  float* const any = reinterpret_cast<float*>(256);
  const Grid g = dense_grid(any, any, any, any, any, any, any, any, any, any, any, any, L, n, W);
  const bool wide = sharded ? round_wide<true>(g, t, n_rounds) : round_wide<false>(g, t, n_rounds);
  int blocks = 0;
  err = sharded ? round_op_nr<true>(n_rounds, g, t, nullptr, &blocks, false)
                : round_op_nr<false>(n_rounds, g, t, nullptr, &blocks, false);
  if (err != cudaSuccess) return err;
  const long long strips = (W + t.tc - 1) / t.tc, segments = (n + t.tr - 1) / t.tr;
  const long long wave = (long long)std::max(blocks, 1) * card.sms;
  const long long v[15] = {t.tr, t.tc, t.sr, t.sc, kRoundBand, t.ahead, t.ring, t.threads,
                           (long long)t.smem, t.per_sm, blocks, strips, segments,
                           (strips * segments + wave - 1) / wave, wide};
  for (int k = 0; k < 15; ++k) out[k] = v[k];
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
                               tile_rows, tile_cols, device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
