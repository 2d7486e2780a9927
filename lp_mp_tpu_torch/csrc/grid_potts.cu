// Grid-Potts colour-phase kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of lp_mp_tpu/ops/pallas_grid.py:
//   grid_phase_kernel<false>  <- _phase_kernel_v2 (:161, wrapper phase_update_v2);
//                                same math as the v1 _phase_kernel (:72)
//   grid_round_kernel<NR, false> <- _round_kernel_v2 (:303, wrapper round_update_v2)
//   grid_phase_kernel<true>   <- _phase_kernel_sharded (:443, wrapper phase_update_sharded)
//   grid_round_kernel<NR, true>  <- _round_kernel_sharded (:536, wrapper round_update_sharded)
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
// the kernels write zeros there, as they do into slots of absent edges.  The geometry (colour, degree, which edges exist) comes
// from the global row, never from the window's bounds.
//
// Both layouts go through the same kernel bodies: a `Grid` names each
// array's rows, and `row<kSharded>` finds window row r of an array (the dense
// vm2 is read with a shift of one row, since its row r-1 holds the slot that
// cell r owns).  So the sharded kernels round exactly like the dense ones,
// and a shard's result equals the matching rows of the dense result.
//
// What bounds them on the H100: device-memory bandwidth.  A phase reads and
// writes the five state arrays and reads the two cost arrays (about 168 MB
// per phase at 1000x1000, L=4) and does a few dozen flops per cell and
// label, far below the card's flop-per-byte balance.
//
// grid_phase_kernel: one thread per cell, labels in a register loop, colours
// and `leave` taken at run time.  Two passes over each incident edge's
// "other" slot: one for its min and min-except, one for the update, which
// the L1 cache serves.
//
// grid_round_kernel: NR full anisotropic rounds (red phase, black phase,
// repeated) in one launch, so the bytes per iteration fall by 2*NR.  A
// block owns a T x T tile of cells and loads the tile plus a halo of
// P = 2*NR cells on every side (S = T + 2P per side) into shared memory,
// with the edge slots of those cells.  It runs the P phases in place there
// with __syncthreads() between them (in one phase only cells of one colour
// update, and no two of them share an edge, so in-place is race-free), then
// writes only the centre.  The valid region shrinks by one ring per phase:
// a cell's phase-k update reads its neighbours' slots from phase k-1, so the
// halo cells go stale from the outside in, and after P phases the centre is
// still exact.  Cells on the true grid edge lose nothing (missing edges do
// not exist).  In a shard, rows beyond the slabs are loaded as absent: they
// lie more than P <= kSlab rows from the window, so their staleness never
// reaches it.  Costs are read through the read-only cache.
// Tile: T = 16 while the tile's shared memory, 5*L*S*S*4 bytes, stays within
// 96 KB (two blocks per SM), else T = 8; L above kMaxRoundLabels is refused.
// At L=4: NR=2 gives S=24, 46 KB and 2.25x recomputed cells (S*S / T*T);
// NR=1 gives S=20, 32 KB and 1.56x.  The centre's loads and stores of
// neighbouring tiles overlap only in the halo, which mostly hits L2.
// Rounding: the products that feed an add go through __fmul_rn, which the
// compiler never contracts into an FMA, so both kernels round like the plain
// torch ops, one IEEE operation at a time.
// Correct first: no cp.async/TMA staging yet, and the tile is not tuned.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRoundLabels = 32;
constexpr int kRoundSmemBudget = 96 * 1024;
constexpr int kSlab = 4;  // slab rows per side; covers the round kernel's halo P <= 4
constexpr float kBig = 3e38f;

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

__device__ __forceinline__ float at(RowPtr p, int l, int c) { return __ldg(p.p + l * p.ls + c); }

__device__ __forceinline__ float* out_at(const OutRows& o, int l, int r, int c) {
  return o.p + l * o.ls + (long)(r - o.shift) * o.width + c;
}

// Min statistics of a Potts edge's "other" slot over the labels: the min m
// and the value min_except takes at the min's positions (the second min, or
// m itself when the min occurs twice: pallas_grid.py:52-61).
struct MinExcept {
  float m, s;
};

__device__ __forceinline__ MinExcept min_except_stats(const float* other, long stride, int L) {
  float m = other[0];
  for (int l = 1; l < L; ++l) m = fminf(m, other[l * stride]);
  int cnt = 0;
  float s = kBig;
  for (int l = 0; l < L; ++l) {
    const float v = other[l * stride];
    if (v == m) {
      ++cnt;
    } else {
      s = fminf(s, v);
    }
  }
  return {m, cnt > 1 ? m : s};
}

// Potts marginal toward `own`'s side for one label (factors/potts.py):
// own + min(other, min_except(other) + cost); own + other when L == 1.
__device__ __forceinline__ float potts_marg(float own, float other, MinExcept st, float cost,
                                            int L) {
  if (L == 1) return own + other;
  const float me = (other == st.m) ? st.s : st.m;
  return own + fminf(other, me + cost);
}

// Zeros into every slot a window cell owns (sharded: an inert row).
__device__ __forceinline__ void write_zero_cell(const Grid& g, int r, int c) {
  for (int l = 0; l < g.L; ++l) {
    *out_at(g.u_o, l, r, c) = 0.0f;
    if (c < g.W - 1) *out_at(g.hm1_o, l, r, c) = 0.0f;
    if (c > 0) *out_at(g.hm2_o, l, r, c - 1) = 0.0f;
    *out_at(g.vm1_o, l, r, c) = 0.0f;
    *out_at(g.vm2_o, l, r, c) = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// phase kernel
// ---------------------------------------------------------------------------
template <bool kSharded>
__global__ void grid_phase_kernel(const Grid g, int recv_color, int send_color, float leave) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int L = g.L, H = g.H, W = g.W, n = g.n;
  if (r >= n || c >= W) return;
  const int gr = g.row0 + r;  // global row
  if (kSharded && gr >= H) {
    write_zero_cell(g, r, c);
    return;
  }
  const int color = ((gr + c) & 1) ? 2 : 1;
  const bool recv = recv_color == color;
  const bool right = c < W - 1, left = c > 0, down = gr < H - 1, up = gr > 0;
  const float deg = (float)right + (float)left + (float)down + (float)up;
  const float omega = (send_color == color) ? 1.0f / fmaxf(deg + leave, 1.0f) : 0.0f;

  const RowPtr ur = row<kSharded>(g.u, n, r), h1 = row<kSharded>(g.hm1, n, r),
               h2 = row<kSharded>(g.hm2, n, r), v1 = row<kSharded>(g.vm1, n, r);
  RowPtr v2_dn{nullptr, 0}, v2_own{nullptr, 0}, v1_up{nullptr, 0};
  if (down) v2_dn = row<kSharded>(g.vm2, n, r + 1);  // edge below, slot of the cell below
  if (up) {
    v2_own = row<kSharded>(g.vm2, n, r);     // edge above, own slot
    v1_up = row<kSharded>(g.vm1, n, r - 1);  // edge above, slot of the cell above
  }
  const float cr = right ? at(row<kSharded>(g.hc, n, r), 0, c) : 0.0f;
  const float cl = left ? at(row<kSharded>(g.hc, n, r), 0, c - 1) : 0.0f;
  const float cd = down ? at(row<kSharded>(g.vc, n, r), 0, c) : 0.0f;
  const float cu = up ? at(row<kSharded>(g.vc, n, r - 1), 0, c) : 0.0f;

  MinExcept st_r{0.0f, 0.0f}, st_l{0.0f, 0.0f}, st_d{0.0f, 0.0f}, st_u{0.0f, 0.0f};
  if (recv) {
    if (right) st_r = min_except_stats(h2.p + c, h2.ls, L);
    if (left) st_l = min_except_stats(h1.p + c - 1, h1.ls, L);
    if (down) st_d = min_except_stats(v2_dn.p + c, v2_dn.ls, L);
    if (up) st_u = min_except_stats(v1_up.p + c, v1_up.ls, L);
  }
  for (int l = 0; l < L; ++l) {
    float uu = at(ur, l, c);
    float own_r = 0.0f, own_l = 0.0f, own_d = 0.0f, own_u = 0.0f;
    float mr = 0.0f, ml = 0.0f, md = 0.0f, mu = 0.0f;
    if (right) own_r = at(h1, l, c);
    if (left) own_l = at(h2, l, c - 1);
    if (down) own_d = at(v1, l, c);
    if (up) own_u = at(v2_own, l, c);
    if (recv) {  // same order of adds as the plain version
      if (right) { mr = potts_marg(own_r, at(h2, l, c), st_r, cr, L); uu += mr; }
      if (left) { ml = potts_marg(own_l, at(h1, l, c - 1), st_l, cl, L); uu += ml; }
      if (down) { md = potts_marg(own_d, at(v2_dn, l, c), st_d, cd, L); uu += md; }
      if (up) { mu = potts_marg(own_u, at(v1_up, l, c), st_u, cu, L); uu += mu; }
    }
    const float d = __fmul_rn(uu, omega);
    *out_at(g.u_o, l, r, c) = uu * (1.0f - __fmul_rn(omega, deg));
    if (right) *out_at(g.hm1_o, l, r, c) = (own_r - mr) + d;
    if (left) *out_at(g.hm2_o, l, r, c - 1) = (own_l - ml) + d;
    if (down) {
      *out_at(g.vm1_o, l, r, c) = (own_d - md) + d;
    } else if (kSharded) {
      *out_at(g.vm1_o, l, r, c) = 0.0f;
    }
    if (up) {
      *out_at(g.vm2_o, l, r, c) = (own_u - mu) + d;
    } else if (kSharded) {
      *out_at(g.vm2_o, l, r, c) = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// round kernel
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int round_halo(int nr) { return 2 * nr; }

inline int round_tile(int L, int nr) {
  const int p = round_halo(nr);
  const int s16 = 16 + 2 * p;
  return 5L * L * s16 * s16 * 4 <= kRoundSmemBudget ? 16 : 8;
}

inline size_t round_smem_bytes(int L, int nr, int T) {
  const size_t S = T + 2 * round_halo(nr);
  return 5 * (size_t)L * S * S * sizeof(float);
}

template <int NR, bool kSharded>
__global__ void grid_round_kernel(const Grid g, int T) {
  constexpr int P = round_halo(NR);
  static_assert(P <= kSlab, "the slabs cover the round kernel's halo");
  const int L = g.L, H = g.H, W = g.W, n = g.n;
  const int S = T + 2 * P;  // even: T and P are
  const int plane = S * S;
  extern __shared__ float smem[];
  float* s_u = smem;
  float* s_h1 = s_u + L * plane;
  float* s_h2 = s_h1 + L * plane;
  float* s_v1 = s_h2 + L * plane;
  float* s_v2 = s_v1 + L * plane;

  // tile origin in window coordinates (may lie outside: those cells are absent)
  const int R0 = blockIdx.y * T - P, C0 = blockIdx.x * T - P;

  // load cells and edge slots; smem edge (i,j) is the grid edge leaving cell
  // (R0+i, C0+j) to the right (h) or downwards (v)
  // (one thread per tile position, labels in the inner loop, so each row
  // lookup serves all L labels)
  for (int k = threadIdx.x; k < plane; k += blockDim.x) {
    const int i = k / S, j = k - i * S;
    const int r = R0 + i, c = C0 + j, gr = g.row0 + r;
    const bool in_r = gr >= 0 && gr < H && readable<kSharded>(g, r), in_c = c >= 0 && c < W;
    const bool cell = in_r && in_c, he = in_r && c >= 0 && c < W - 1;
    const bool ve = cell && gr < H - 1, ve2 = ve && readable<kSharded>(g, r + 1);
    const RowPtr none{nullptr, 0};
    const RowPtr pu = cell ? row<kSharded>(g.u, n, r) : none;
    const RowPtr ph1 = he ? row<kSharded>(g.hm1, n, r) : none;
    const RowPtr ph2 = he ? row<kSharded>(g.hm2, n, r) : none;
    const RowPtr pv1 = ve ? row<kSharded>(g.vm1, n, r) : none;
    const RowPtr pv2 = ve2 ? row<kSharded>(g.vm2, n, r + 1) : none;
    for (int l = 0; l < L; ++l) {
      const int o = l * plane + k;
      s_u[o] = cell ? at(pu, l, c) : 0.0f;
      s_h1[o] = he ? at(ph1, l, c) : 0.0f;
      s_h2[o] = he ? at(ph2, l, c) : 0.0f;
      s_v1[o] = ve ? at(pv1, l, c) : 0.0f;
      s_v2[o] = ve2 ? at(pv2, l, c) : 0.0f;
    }
  }
  __syncthreads();

  const int half = S / 2;
#pragma unroll 1
  for (int ph = 0; ph < P; ++ph) {
    const int parity = (ph & 1) ? 0 : 1;  // red (odd r+c) first, then black
    for (int k = threadIdx.x; k < S * half; k += blockDim.x) {
      const int i = k / half;
      const int j0 = 2 * (k - i * half);
      const int r = R0 + i, gr = g.row0 + r;
      const int j = j0 + ((parity ^ (gr + C0)) & 1);  // (gr + C0 + j) % 2 == parity
      const int c = C0 + j;
      if (gr < 0 || gr >= H || c < 0 || c >= W || !readable<kSharded>(g, r)) continue;
      const int s = i * S + j;
      // edges present in the tile; a tile-border cell that misses one is
      // stale after this phase, which the halo absorbs
      const bool right = c < W - 1, left = c > 0 && j > 0;
      const bool down = gr < H - 1, up = gr > 0 && i > 0 && readable<kSharded>(g, r - 1);
      const float deg =
          (float)(c < W - 1) + (float)(c > 0) + (float)(gr < H - 1) + (float)(gr > 0);
      const float omega = 1.0f / fmaxf(deg, 1.0f);
      const float cr = right ? at(row<kSharded>(g.hc, n, r), 0, c) : 0.0f;
      const float cl = left ? at(row<kSharded>(g.hc, n, r), 0, c - 1) : 0.0f;
      const float cd = down ? at(row<kSharded>(g.vc, n, r), 0, c) : 0.0f;
      const float cu = up ? at(row<kSharded>(g.vc, n, r - 1), 0, c) : 0.0f;
      MinExcept st_r{0.0f, 0.0f}, st_l{0.0f, 0.0f}, st_d{0.0f, 0.0f}, st_u{0.0f, 0.0f};
      if (right) st_r = min_except_stats(s_h2 + s, plane, L);
      if (left) st_l = min_except_stats(s_h1 + s - 1, plane, L);
      if (down) st_d = min_except_stats(s_v2 + s, plane, L);
      if (up) st_u = min_except_stats(s_v1 + s - S, plane, L);
      for (int l = 0; l < L; ++l) {
        const int o = l * plane + s;
        float uu = s_u[o];
        float mr = 0.0f, ml = 0.0f, md = 0.0f, mu = 0.0f;
        if (right) { mr = potts_marg(s_h1[o], s_h2[o], st_r, cr, L); uu += mr; }
        if (left) { ml = potts_marg(s_h2[o - 1], s_h1[o - 1], st_l, cl, L); uu += ml; }
        if (down) { md = potts_marg(s_v1[o], s_v2[o], st_d, cd, L); uu += md; }
        if (up) { mu = potts_marg(s_v2[o - S], s_v1[o - S], st_u, cu, L); uu += mu; }
        const float d = __fmul_rn(uu, omega);
        s_u[o] = uu * (1.0f - __fmul_rn(omega, deg));
        if (right) s_h1[o] = (s_h1[o] - mr) + d;
        if (left) s_h2[o - 1] = (s_h2[o - 1] - ml) + d;
        if (down) s_v1[o] = (s_v1[o] - md) + d;
        if (up) s_v2[o - S] = (s_v2[o - S] - mu) + d;
      }
    }
    __syncthreads();
  }

  // write the centre: each cell's u and own slots (zeros for an inert row
  // and for slots of absent edges in a shard)
  const int tt = T * T;
  for (int k = threadIdx.x; k < tt; k += blockDim.x) {
    const int i = k / T + P, j = k % T + P;
    const int r = R0 + i, c = C0 + j, gr = g.row0 + r;
    if (r >= n || c >= W) continue;
    const bool live = !kSharded || gr < H;
    const bool right = c < W - 1, left = c > 0;
    const bool down = live && gr < H - 1, up = live && gr > 0;
    float* ou = out_at(g.u_o, 0, r, c);
    float* oh1 = right ? out_at(g.hm1_o, 0, r, c) : nullptr;
    float* oh2 = left ? out_at(g.hm2_o, 0, r, c - 1) : nullptr;
    float* ov1 = (down || kSharded) ? out_at(g.vm1_o, 0, r, c) : nullptr;
    float* ov2 = (up || kSharded) ? out_at(g.vm2_o, 0, r, c) : nullptr;
    const int s = i * S + j;
    for (int l = 0; l < L; ++l) {
      const int o = l * plane + s;
      ou[l * g.u_o.ls] = live ? s_u[o] : 0.0f;
      if (right) oh1[l * g.hm1_o.ls] = live ? s_h1[o] : 0.0f;
      if (left) oh2[l * g.hm2_o.ls] = live ? s_h2[o - 1] : 0.0f;
      if (down || kSharded) ov1[l * g.vm1_o.ls] = down ? s_v1[o] : 0.0f;
      if (up || kSharded) ov2[l * g.vm2_o.ls] = up ? s_v2[o - S] : 0.0f;
    }
  }
}

template <bool kSharded>
cudaError_t launch_phase(const Grid& g, int recv_color, int send_color, float leave,
                         cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((g.W + block.x - 1) / block.x, (g.n + block.y - 1) / block.y);
  grid_phase_kernel<kSharded><<<grid, block, 0, stream>>>(g, recv_color, send_color, leave);
  return cudaGetLastError();
}

template <int NR, bool kSharded>
cudaError_t launch_round(const Grid& g, cudaStream_t stream) {
  const int T = round_tile(g.L, NR);
  const int S = T + 2 * round_halo(NR);
  const size_t smem = round_smem_bytes(g.L, NR, T);
  cudaError_t err = cudaFuncSetAttribute(grid_round_kernel<NR, kSharded>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = ((S * S / 2 + 31) / 32) * 32;  // one thread per active cell
  const dim3 grid((g.W + T - 1) / T, (g.n + T - 1) / T);
  grid_round_kernel<NR, kSharded><<<grid, threads, smem, stream>>>(g, T);
  return cudaGetLastError();
}

template <bool kSharded>
cudaError_t launch_round_nr(const Grid& g, int n_rounds, cudaStream_t stream) {
  if (n_rounds == 1) return launch_round<1, kSharded>(g, stream);
  if (n_rounds == 2) return launch_round<2, kSharded>(g, stream);
  return cudaErrorInvalidValue;
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
                           int W, int n_rounds, int device, void* stream) {
  if (L < 1 || L > kMaxRoundLabels || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Grid g = dense_grid(u, hm1, hm2, vm1, vm2, hc, vc, u_o, hm1_o, hm2_o, vm1_o, vm2_o, L,
                            H, W);
  return launch_round_nr<false>(g, n_rounds, static_cast<cudaStream_t>(stream));
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
                                   int W, int row0, int H, int n_rounds, int device,
                                   void* stream) {
  if (L < 1 || L > kMaxRoundLabels || n < 1 || W < 1 || row0 < 0 || H < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_round_nr<true>(shard_grid(ptrs, slab_ls, L, n, W, row0, H), n_rounds,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
