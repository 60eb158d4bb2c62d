// Grid-folded tree histograms: node x feature x bin sums of per-row
// statistics for G tree-growing instances over one shared binned matrix,
// or over one binned matrix per group of instances.
//
// Replaces the TPU kernels of transmogrifai_tpu/models/kernels.py
// histogram_pallas_grid: _hist_db_kernel (pallas_call at :612, the
// double-buffered manual-DMA variant) and _hist_grid_kernel
// (pallas_call at :649, the BlockSpec row-block grid; also reached
// through histogram_pallas). Both build a (rows, d*B) bins one-hot and
// a node-masked (rows, G*m*S) stats matrix in VMEM and contract them on
// the MXU, accumulating row blocks in a resident VMEM output block.
//
// What it computes (the same function, not the same blocks):
//
//   out[g, node, s, j, b] = sum_i r(stats[g, i, s])
//                           * [pos[g, i] == node] * [bins[i, j] == b]
//
// bins (Gbins, n, d) int32, stats (G, n, S) f32, pos (G, n) int32, out
// (G, m, S, d, B) f32 — the (G, m*S, d*B) layout with column j*B + b
// that grow_tree_grid reads, written straight out (no unscramble).
// Instance g reads bins slot g / (G / Gbins): Gbins = 1 is one shared
// matrix (the grid-folded path); Gbins = G gives each instance its own
// (the per-instance path, the vmapped histogram_pallas of the JAX
// package); a forest's T trees of one item share its slot (Gbins =
// G / T). r() rounds a stat to bf16 when `bf16` is set and is the
// identity otherwise; accumulation is f32, or under `accum_bf16` (the
// JAX package's TM_HIST_ACCUM_BF16) f32 within a run and bf16 across a
// node's runs (see (5)). A row whose node lies outside [0, m),
// or whose bin lies outside [0, B), adds nothing (the one-hot
// formulation's all-zero row). A non-finite stat (NaN, or inf: 0 * inf
// is NaN) turns every bin of its node, feature and stat into NaN, since
// the one-hot's zeros multiply it; the plain version's one-hot matmul
// spreads it further, into every node.
//
// What bounds it on an H100. One call must move every input once plus
// the output (~101 MB at the histogram capture shape G=16 n=200k d=28
// B=32 S=5 m=8), so the bound is bytes: ~30 us at 3.35 TB/s. As a
// scatter-add (the earlier design: a lane per feature adding each row's
// S stats into its shared-memory cells) it is G*n*d*S dependent
// read-modify-writes (448 M there), and a warp's 21 KB slab held an SM
// to ~10 warps, too few to hide that chain: 0.55 ms. The TPU's one-hot
// GEMM feeds the matrix unit instead, G*m*S*d*B*n multiply-adds (229
// GFLOP there, mostly zeros). This design takes the GEMM to the tensor
// cores, but per node: once the rows are grouped by node, only the
// node's own rows meet its one-hot, and a 16-row k-step costs d *
// ceil(B/16) * ceil(S/8) mma of m16n8k16 (11.2 M mma, 45.9 GFLOP at the
// capture shape, S padded to 8). On an H100 80GB HBM3 at 700 W the pass
// takes ~0.45 ms there (PERF.md): about 17 instructions an mma (four
// one-hot compares, the fragments' loads and builds), issued on ~57% of
// the SMs' cycles, bound it; neither the tensor cores nor the gathers
// do (taking either away saves little).
//
// The design, deterministic by construction:
//
// * Rows are first grouped by node, per instance: a stable counting
//   sort (count per (node, row chunk), one exclusive scan, then each
//   chunk's rows ranked in row order with warp match masks) writes a
//   permutation of each instance's rows, node by node, rows in their
//   original order inside a node.
// * The bins are packed once per launch: for each group of 32 bins, a
//   byte a bin relative to the group (255 outside it), rows padded to
//   16 bytes — a quarter of the int32 row's bytes to gather.
// * The histogram pass takes one block per (instance g, node, run of R
//   consecutive rows of that node, chunk of 32 features, group of 32
//   bins, group of 8 stats); for B <= 32 and S <= 8 (every tree family)
//   a single group of each. A warp owns 4 features of the chunk. Per
//   16-row k-step and feature it issues mma.sync m16n8k16 (bf16 in, f32
//   accumulate) with the operands' roles swapped from the TPU's, so the
//   padding is small:
//     A (16 x 16) the one-hot: rows are 16 bins of the feature, columns
//       the k-step's 16 rows, built in registers and never stored: a
//       byte permute and a logic op turn two rows' packed bins v into
//       the bf16x2 word 0x4300 | v (a distinct normal number for every
//       byte), and one bf16x2 compare (HSET2) against 0x4300 | c gives
//       1.0 where a row's bin is c. A bin outside the group (255) never
//       matches;
//     B (16 x 8) the stats: the same 16 rows, the group's 8 stats,
//       rounded to bf16 in registers, shared by every feature and bin
//       tile of the k-step; zeros past S and for rows past the run
//       (written into shared memory, so the row's bins may be anything);
//     D (16 x 8) f32, in registers: 4 features x 2 bin tiles x 8
//       floats a thread.
//   The block gathers kTileRows rows at a time into shared memory with
//   cp.async (row indices kAhead tiles ahead of the rows, the rows
//   kStages - 1 tiles ahead of the tile it multiplies; copies in flight
//   hold no registers, so two blocks fit an SM) and multiplies each
//   tile where it landed, one barrier a tile. A tile's k-steps chain in
//   the mma accumulator (which may round toward zero), then join a
//   running f32 sum (round to nearest), so no rounding chain is longer
//   than a tile.
// * Exact mode (f32 operands) splits each stat into three bf16 terms,
//   hi + mid + lo, exactly (3 x 8 significand bits cover f32's 24, for
//   normal values below bf16's largest), and accumulates the three
//   products with the 0/1 one-hot: integer stats stay exact in any
//   order of addition, so exact mode is bitwise the plain version's on
//   them; other stats differ by f32 rounding only.
// * Each block writes its run's partial histogram; a last pass sums a
//   node's runs in run order (zeros for an empty node). The order of
//   every sum is fixed (k-steps in row order, then tiles, then runs),
//   R and the row chunks depend on n alone, and each instance's sort
//   and runs on its own pos, so an instance's histogram is bitwise the
//   same alone or inside any batch, and a re-run gives bitwise the
//   same result (float atomics from several warps into one cell would
//   break both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kTileRows = 128;    // rows a histogram block stages at a time
constexpr int kFeatBlock = 32;    // features of a block (a chunk)
constexpr int kFeatWarp = 4;      // features of a warp
constexpr int kWarpsMax = kFeatBlock / kFeatWarp;
constexpr int kBinGroup = 32;     // bins of a block: two 16-bin A tiles
constexpr int kStatGroup = 8;     // stats of a block: one 8-column B tile

// Workspace of int32 words, per instance g (offsets in words):
//   base  [G][m][nch]  counts, then (in place) each (node, chunk)'s
//                      first slot in perm
//   seg   [G][m][2]    a node's first slot in perm and its row count
//   items [G][m+1]     a node's first run; items[g][m] = runs of g
//   perm  [G][n]       rows of g grouped by node, row order inside
// then, from a 16-byte boundary, one plane per bins slot:
//   packed [Gbins][nbg][n][dpad]  per group of kBinGroup bins, each bin as a
//                      byte relative to the group (0..31), 255 for a
//                      bin outside the group or outside [0, B) and for
//                      the padding; rows padded to dpad, a multiple of
//                      16 bytes
struct Workspace {
  int32_t* base;
  int32_t* seg;
  int32_t* items;
  int32_t* perm;
  uint8_t* packed;
};

inline long long perm_end(int G, int n, int m, int nch) {
  const long long w = (long long)G * m * nch + 2LL * G * m +
                      (long long)G * (m + 1) + (long long)G * n;
  return (w + 3) / 4 * 4;
}

inline long long ws_words(int G, int n, int m, int nch, long long packed) {
  return perm_end(G, n, m, nch) + (packed + 3) / 4;
}

inline Workspace carve(int32_t* w, int G, int n, int m, int nch) {
  Workspace s;
  s.base = w;
  s.seg = s.base + (long long)G * m * nch;
  s.items = s.seg + 2LL * G * m;
  s.perm = s.items + (long long)G * (m + 1);
  s.packed = reinterpret_cast<uint8_t*>(w + perm_end(G, n, m, nch));
  return s;
}

// (0) the bins packed into `packed` (see Workspace): a quarter of the
// int32 row's bytes for the histogram pass to gather (one 32-byte
// sector a row at d <= 32), already relative to the bin group; each
// bins slot in its own planes.
__global__ void tree_hist_pack_bins(const int32_t* __restrict__ bins,
                                    uint8_t* __restrict__ packed, int n,
                                    int d, int dpad, int B, int nbg,
                                    int gbins) {
  const long long plane = (long long)n * dpad;
  const long long count = plane * nbg * gbins;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       x < count; x += stride) {
    const long long sb = x / plane;           // slot * nbg + bin group
    const int slot = (int)(sb / nbg);
    const int bg = (int)(sb - (long long)slot * nbg);
    const long long y = x - sb * plane;
    const long long r = y / dpad;
    const int j = (int)(y - r * dpad);
    const int v = j < d ? bins[((long long)slot * n + r) * d + j] : -1;
    const int rel = v - bg * kBinGroup;
    packed[x] = (unsigned)v < (unsigned)B && (unsigned)rel < kBinGroup
                    ? (uint8_t)rel : (uint8_t)255;
  }
}

// (1) rows of each node in chunk c of instance g. Block (g, c).
__global__ void tree_hist_sort_count(const int32_t* __restrict__ pos,
                                     int32_t* __restrict__ base, int n, int m,
                                     int nch, int chunk_rows) {
  extern __shared__ int32_t cnt[];
  const int g = blockIdx.x / nch;
  const int c = blockIdx.x % nch;
  for (int e = threadIdx.x; e < m; e += blockDim.x) cnt[e] = 0;
  __syncthreads();
  const long long r0 = (long long)c * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int32_t* pg = pos + (long long)g * n;
  for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const int node = pg[i];
    if ((unsigned)node < (unsigned)m) atomicAdd(&cnt[node], 1);
  }
  __syncthreads();
  int32_t* bg = base + (long long)g * m * nch;
  for (int e = threadIdx.x; e < m; e += blockDim.x)
    bg[(long long)e * nch + c] = cnt[e];
}

// Exclusive scan of one int per thread over the block (blockDim a
// multiple of 32, at most 1024); *total gets the sum. Integer sums, so
// the order of the adds does not matter.
__device__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sums,
                                        int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    const int32_t s = lane < nw ? warp_sums[lane] : 0;
    int32_t xs = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, xs, o);
      if (lane >= o) xs += y;
    }
    if (lane < nw) warp_sums[lane] = xs - s;
    if (lane == 31) *total = xs;
  }
  __syncthreads();
  const int32_t out = warp_sums[w] + x - v;
  __syncthreads();  // warp_sums and *total may be reused after this
  return out;
}

// (2) exclusive scan of g's counts in (node, chunk) order, in place; a
// node's first slot and row count; its first run of R rows. Block g.
__global__ void tree_hist_sort_scan(int32_t* __restrict__ base,
                                    int32_t* __restrict__ seg,
                                    int32_t* __restrict__ items, int m, int nch,
                                    int R) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t total_s;
  const int g = blockIdx.x;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long L = (long long)m * nch;
  int32_t* bg = base + (long long)g * L;
  // each thread scans a contiguous range of the (node, chunk) counts
  const long long per = (L + T - 1) / T;
  const long long a = min(L, (long long)t * per);
  const long long b = min(L, a + per);
  int32_t local = 0;
  for (long long e = a; e < b; ++e) local += bg[e];
  int32_t run = block_exclusive_scan(local, warp_sums, &total_s);
  const int32_t total = total_s;  // read before the next scan rewrites it
  for (long long e = a; e < b; ++e) {
    const int32_t v = bg[e];
    bg[e] = run;
    run += v;
  }
  __syncthreads();  // every first slot is written
  int32_t* sg = seg + 2LL * g * m;
  int32_t* ig = items + (long long)g * (m + 1);
  int32_t carry = 0;
  for (int node0 = 0; node0 < m; node0 += T) {
    const int node = node0 + t;
    int32_t runs = 0;
    if (node < m) {
      const int32_t start = bg[(long long)node * nch];
      const int32_t end =
          node + 1 < m ? bg[(long long)(node + 1) * nch] : total;
      sg[2 * node] = start;
      sg[2 * node + 1] = end - start;
      runs = (end - start + R - 1) / R;
    }
    const int32_t first = block_exclusive_scan(runs, warp_sums, &total_s);
    if (node < m) ig[node] = carry + first;
    carry += total_s;
    __syncthreads();  // total_s is read by every thread before reuse
  }
  if (t == 0) ig[m] = carry;
}

// (3) stable scatter of chunk c of instance g: one warp walks the
// chunk's rows in order, 32 at a time; lanes on one node rank among
// themselves with a match mask and take consecutive slots. Block (g, c)
// of 32 threads.
__global__ void tree_hist_sort_scatter(const int32_t* __restrict__ pos,
                                       const int32_t* __restrict__ base,
                                       int32_t* __restrict__ perm, int n, int m,
                                       int nch, int chunk_rows) {
  extern __shared__ int32_t next[];
  const int g = blockIdx.x / nch;
  const int c = blockIdx.x % nch;
  const int lane = threadIdx.x;
  const int32_t* bg = base + (long long)g * m * nch;
  for (int e = lane; e < m; e += 32) next[e] = bg[(long long)e * nch + c];
  __syncwarp();
  const long long r0 = (long long)c * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int32_t* pg = pos + (long long)g * n;
  int32_t* out = perm + (long long)g * n;
  const unsigned below = (1u << lane) - 1u;
  for (long long i0 = r0; i0 < r1; i0 += 32) {
    const long long i = i0 + lane;
    const int node = i < r1 ? pg[i] : -1;
    const bool ok = (unsigned)node < (unsigned)m;
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? node : -1);
    const int rank = __popc(peers & below);
    int slot = 0;
    if (ok) slot = next[node] + rank;
    __syncwarp();
    if (ok) {
      out[slot] = (int32_t)i;
      if (rank == 0) next[node] += __popc(peers);
    }
    __syncwarp();
  }
}

// (4) the histogram pass: a one-hot GEMM on the tensor cores. Block
// (g, run, feature chunk, bin group, stat group), kWarpsMax warps at
// most; see the design note.
//
// Rows move in tiles of kTileRows through two kinds of shared buffer,
// both filled with cp.async and read by the warps as they landed:
//   idx[kIdxSlots][r]   the tile's row indices (perm), or -1 past the
//                       run, kAhead tiles before its data
//   raw[kStages]        the tile's packed bins (bytes, [r][48]: 32 of
//                       the chunk's features, 16-byte copies; 48 bytes
//                       a row put a fragment's four rows in four banks)
//                       and stats (f32, [r][12]: the group's 8, zeros
//                       past the group and for rows past the run; 12
//                       words a row, likewise)
// A tile is in flight while the kStages - 1 tiles before it are
// multiplied; its copies hold no registers, and a thread builds its
// fragments from the tile as it landed.
//
// The A fragment (one-hot) from bytes: for two rows' bins v0, v1 of a
// feature, the word 0x4300 | v0, 0x4300 | v1 (low half first) is a
// bf16x2 pair, a distinct normal number for each byte value, so one
// bf16x2 equality compare (HSET2) against 0x4300 | c in both halves
// gives 1.0 where the row's bin is c and 0.0 elsewhere. A row's four
// features are one 32-bit word of the raw tile; a byte permute picks
// one feature of two rows into the low bytes of the two halves.
constexpr int kIdxSlots = 8;
constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;
constexpr int kBinRowBytes = 48;
constexpr int kStatRowWords = 12;

struct Raw {
  uint8_t bins[kTileRows][kBinRowBytes];
  float stats[kTileRows][kStatRowWords];
};

struct Smem {
  Raw raw[kStages];
  int32_t idx[kIdxSlots][kTileRows];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `n` of this thread's committed groups are pending
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(n) : "memory");
}

// Two A elements: 1.0 where a row's bin (a half of `w`) equals the
// bin the half of `c` names, else 0.0 (bf16, one compare per half).
__device__ __forceinline__ uint32_t onehot2(uint32_t w, uint32_t c) {
  __nv_bfloat162 r = __heq2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                            *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&r);
}

// D += A B for one 16x16 one-hot A, one 16x8 stats B, f32 D in place.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16x2 of two f32 values, `lo` in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// One feature's A operand words for two row pairs: byte `i` of rows
// (a0, a1) and of rows (b0, b1) as 0x4300 | v halves.
__device__ __forceinline__ void onehot_rows(int i, uint32_t a0, uint32_t a1,
                                            uint32_t b0, uint32_t b1,
                                            uint32_t& wa, uint32_t& wb) {
  const unsigned sel = ((4 + i) << 8) | i;
  wa = (__byte_perm(a0, a1, sel) & 0x00ff00ffu) | 0x43004300u;
  wb = (__byte_perm(b0, b1, sel) & 0x00ff00ffu) | 0x43004300u;
}

template <bool kExact>
__global__ void __launch_bounds__(kWarpsMax * kWarp, 2)
tree_hist_mma(const uint8_t* __restrict__ packed,
              const float* __restrict__ stats,
              const int32_t* __restrict__ perm,
              const int32_t* __restrict__ seg,
              const int32_t* __restrict__ items,
              float* __restrict__ partial, int n, int d, int dpad, int S,
              int m, int B, int R, int nchunks, int nbg, int nsg,
              int runs_cap, int per_slot) {
  constexpr int kPieces = kExact ? 3 : 1;
  static_assert(kAhead + 1 <= kIdxSlots, "idx slots");
  __shared__ __align__(16) Smem sm;
  long long x = blockIdx.x;
  const int grp = (int)(x % (nbg * nsg));
  x /= nbg * nsg;
  const int c = (int)(x % nchunks);
  x /= nchunks;
  const int run = (int)(x % runs_cap);
  const int g = (int)(x / runs_cap);
  const int32_t* ig = items + (long long)g * (m + 1);
  if (run >= ig[m]) return;
  // the node whose runs hold `run`: the last node with ig[node] <= run
  int lo = 0, hi = m - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ig[mid] <= run) lo = mid; else hi = mid - 1;
  }
  const int k = run - ig[lo];
  const int32_t* sg = seg + 2LL * g * m;
  const int first = sg[2 * lo] + k * R;
  const int rows = min(R, sg[2 * lo + 1] - k * R);

  const int bgi = grp / nsg;
  const int j0 = c * kFeatBlock;
  const int fc = min(kFeatBlock, d - j0);
  const int fv = (fc + 15) / 16;            // 16-byte copies a row
  const int b0 = bgi * kBinGroup;
  const int nbt = (min(kBinGroup, B - b0) + 15) >> 4;   // 1 or 2 tiles
  const int s0 = (grp % nsg) * kStatGroup;
  const int sc = min(kStatGroup, S - s0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;                 // the fragments' group
  const int tq = lane & 3;                  // thread in group
  const int32_t* pr = perm + (long long)g * n + first;
  const float* sgs = stats + (long long)g * n * S + s0;
  const uint8_t* pj =
      packed + ((long long)(g / per_slot) * nbg + bgi) * n * dpad + j0;
  const int nt = (rows + kTileRows - 1) / kTileRows;
  const int wf0 = warp * kFeatWarp;         // the warp's features, in
  const int nf = min(kFeatWarp, fc - wf0);  // one word of a raw row

  // tile t's row indices into idx[t % kIdxSlots]
  auto issue_idx = [&](int t) {
    if (t < nt) {
      for (int e = tid; e < kTileRows; e += nthr) {
        const int r = t * kTileRows + e;
        int32_t* dst = &sm.idx[t % kIdxSlots][e];
        if (r < rows) cp_async4(dst, pr + r); else *dst = -1;
      }
    }
    cp_commit();
  };
  // tile t's bins and stats into raw[t % kStages] (its idx has landed)
  auto issue_data = [&](int t) {
    if (t < nt) {
      Raw& rw = sm.raw[t % kStages];
      const int32_t* ix = sm.idx[t % kIdxSlots];
      for (int e = tid; e < kTileRows * 2; e += nthr) {
        const int r = e >> 1, v = e & 1;
        const int row = ix[r];
        if (v < fv && row >= 0)
          cp_async16(&rw.bins[r][16 * v], pj + (long long)row * dpad + 16 * v);
      }
      for (int e = tid; e < kTileRows * kStatGroup; e += nthr) {
        const int r = e >> 3, s = e & 7;
        const int row = ix[r];
        if (s < sc) {   // a row past the run adds zeros (its bins: any)
          if (row >= 0)
            cp_async4(&rw.stats[r][s], sgs + (long long)row * S + s);
          else
            rw.stats[r][s] = 0.0f;
        }
      }
    }
    cp_commit();
  };

  // this thread's A rows are bins c and c + 8 of tiles 0 and 1, as the
  // 0x4300 | c pattern in both halves
  uint32_t clo[2], chi[2];
#pragma unroll
  for (int bt = 0; bt < 2; ++bt) {
    clo[bt] = 0x43004300u | ((bt * 16 + gq) * 0x00010001u);
    chi[bt] = 0x43004300u | ((bt * 16 + gq + 8) * 0x00010001u);
  }
  float tot[kFeatWarp][2][4];
#pragma unroll
  for (int i = 0; i < kFeatWarp; ++i)
#pragma unroll
    for (int bt = 0; bt < 2; ++bt)
#pragma unroll
      for (int v = 0; v < 4; ++v) tot[i][bt][v] = 0.0f;

  // Each tile t commits idx(t + kStages - 1 + kAhead), then data(t +
  // kStages - 1). At the top of tile t the 2 (kStages - 2) groups after
  // data(t) may still be pending; idx(t + kStages - 1) is older.
  // stat columns past the group are zeros in every stage, for good
  for (int e = tid; e < kStages * kTileRows * kStatGroup; e += nthr)
    if ((e & 7) >= sc)
      sm.raw[e / (kTileRows * kStatGroup)].stats[(e >> 3) % kTileRows][e & 7] =
          0.0f;
  for (int i = 0; i < kAhead; ++i) issue_idx(i);
  cp_wait<0>();
  __syncthreads();
  for (int u = 0; u < kStages - 1; ++u) {
    issue_idx(u + kAhead);
    issue_data(u);
  }
  for (int t = 0; t < nt; ++t) {
    cp_wait<2 * (kStages - 2)>();  // data(t), idx(t + kStages - 1) landed
    __syncthreads();               // ... for every thread; and tile t - 1
                                   // is multiplied, so its stage is free
    issue_idx(t + kStages - 1 + kAhead);
    issue_data(t + kStages - 1);
    if (nf <= 0) continue;
    const Raw& rw = sm.raw[t % kStages];
    // a tile's products chain in the tensor cores' accumulator, then
    // join the running f32 sum: a chain of kTileRows / 16 k-steps (x
    // pieces). kAll: the warp has all its features and both bin tiles.
    auto multiply = [&](auto all) {
      constexpr bool kAll = decltype(all)::value;
      float acc[kFeatWarp][2][4];
#pragma unroll
      for (int i = 0; i < kFeatWarp; ++i)
#pragma unroll
        for (int bt = 0; bt < 2; ++bt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][bt][v] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kTileRows / 16; ++ks) {
        const int r0 = ks * 16 + 2 * tq;    // rows r0, r0+1, r0+8, r0+9
        // B: stat gq of the four rows (zeros past the group or the run)
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = rw.stats[r0 + (q & 1) + (q >> 1) * 8][gq];
        uint32_t bf[kPieces][2];
        bf[0][0] = bf16x2(v[0], v[1]);
        bf[0][1] = bf16x2(v[2], v[3]);
        if (kExact) {   // v = hi + mid + lo exactly (normal f32 v)
          float r1[4], r2[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t w = bf[0][q >> 1];
            const float h = (q & 1) ? bf16_hi(w) : bf16_lo(w);
            r1[q] = isfinite(h) ? v[q] - h : 0.0f;
          }
          bf[1 % kPieces][0] = bf16x2(r1[0], r1[1]);
          bf[1 % kPieces][1] = bf16x2(r1[2], r1[3]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t w = bf[1 % kPieces][q >> 1];
            r2[q] = r1[q] - ((q & 1) ? bf16_hi(w) : bf16_lo(w));
          }
          bf[2 % kPieces][0] = bf16x2(r2[0], r2[1]);
          bf[2 % kPieces][1] = bf16x2(r2[2], r2[3]);
        }
        // A: the warp's features of the four rows, in one word of each
        const int wo = wf0 & ~3;
        const uint32_t x0 =
            *reinterpret_cast<const uint32_t*>(&rw.bins[r0][wo]);
        const uint32_t x1 =
            *reinterpret_cast<const uint32_t*>(&rw.bins[r0 + 1][wo]);
        const uint32_t x2 =
            *reinterpret_cast<const uint32_t*>(&rw.bins[r0 + 8][wo]);
        const uint32_t x3 =
            *reinterpret_cast<const uint32_t*>(&rw.bins[r0 + 9][wo]);
#pragma unroll
        for (int i = 0; i < kFeatWarp; ++i) {
          if (!kAll && i >= nf) break;
          uint32_t wa, wb;
          onehot_rows((wf0 & 3) + i, x0, x1, x2, x3, wa, wb);
#pragma unroll
          for (int bt = 0; bt < 2; ++bt) {
            if (!kAll && bt >= nbt) break;
            const uint32_t a0 = onehot2(wa, clo[bt]);
            const uint32_t a1 = onehot2(wa, chi[bt]);
            const uint32_t a2 = onehot2(wb, clo[bt]);
            const uint32_t a3 = onehot2(wb, chi[bt]);
#pragma unroll
            for (int p = 0; p < kPieces; ++p)
              mma_bf16(acc[i][bt], a0, a1, a2, a3, bf[p][0], bf[p][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kFeatWarp; ++i) {
        if (!kAll && i >= nf) break;
#pragma unroll
        for (int bt = 0; bt < 2; ++bt) {
          if (!kAll && bt >= nbt) break;
#pragma unroll
          for (int v = 0; v < 4; ++v) tot[i][bt][v] += acc[i][bt][v];
        }
      }
    };
    if (nf == kFeatWarp && nbt == 2)
      multiply(std::true_type{});
    else
      multiply(std::false_type{});
  }
  cp_wait<0>();          // nothing left in flight at exit
  // partial (g, run, s, j0 + f, b): D row gq (+ 8) is bin b0 + 16 bt +
  // gq (+ 8), D column 2 tq (+ 1) is stat s0 + 2 tq (+ 1)
  float* o = partial + ((long long)g * runs_cap + run) * S * d * B;
#pragma unroll
  for (int i = 0; i < kFeatWarp; ++i) {
    if (i >= nf) break;
    const int f = j0 + wf0 + i;
#pragma unroll
    for (int bt = 0; bt < 2; ++bt) {
      if (bt >= nbt) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int b = b0 + bt * 16 + gq + (v >= 2 ? 8 : 0);
        const int s = s0 + 2 * tq + (v & 1);
        if (b < B && s < S)
          o[((long long)s * d + f) * B + b] = tot[i][bt][v];
      }
    }
  }
}

// bf16 round to nearest even of an f32 value, back in f32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// (5) out[g, node, e] = sum over the node's runs, in run order. Under
// kAccumBf16 each run's partial is rounded to bf16 and the running sum
// kept in bf16 (each add rounded to bf16): the JAX package's bf16
// cross-block partial sums and resident output block. The result is
// written as f32 either way.
template <bool kAccumBf16>
__global__ void tree_hist_reduce(const float* __restrict__ partial,
                                 const int32_t* __restrict__ items,
                                 float* __restrict__ out, int G, int m,
                                 long long SDB, int runs_cap) {
  const long long count = (long long)G * m * SDB;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       x < count; x += stride) {
    const long long gn = x / SDB;
    const long long e = x % SDB;
    const int g = (int)(gn / m);
    const int node = (int)(gn % m);
    const int32_t* ig = items + (long long)g * (m + 1);
    const int r0 = ig[node];
    const int r1 = ig[node + 1];
    const float* p = partial + ((long long)g * runs_cap) * SDB + e;
    float acc = 0.0f;
    for (int r = r0; r < r1; ++r) {
      if (kAccumBf16)
        acc = round_bf16(acc + round_bf16(p[(long long)r * SDB]));
      else
        acc += p[(long long)r * SDB];
    }
    out[x] = acc;
  }
}

// blocks of 256 threads for a grid-stride pass over `count` items, at
// most `cap` (each item is one thread's alone, so any cap gives the
// same bits)
constexpr long long kGridCap = 132LL * 16;

unsigned grid_for(long long count, long long cap = kGridCap) {
  long long blocks = (count + 255) / 256;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, as a CUstream handle)
// and returns the first CUDA error of its launches: 0 on success. The
// wrapper allocates the scratch: `work`, `work_words` int32 words (the
// Workspace layout), and `partial`, `partial_floats` floats (G *
// runs_cap * S*d*B, runs_cap >= ceil(n/R) + m: the most runs an
// instance can need); too little of either is an invalid value. `bins`
// holds `gbins` slots of (n, d); gbins must divide G. `bf16`: bf16
// operands (the stats rounded once); else f32 operands, each stat split
// into three bf16 terms. `accum_bf16`: bf16 sums across a node's runs
// (see (5)). The launch choices, none changing a bit
// of the result: `chunk_rows`, the rows a sort block ranks (the sort
// is stable, so the chunks cannot reorder a node's rows), and
// `reduce_blocks`, the cap on the last pass's grid (0 is 132 x 16).
// Allocates nothing and does not synchronise.
extern "C" int tm_tree_histogram(const int32_t* bins, const float* stats,
                                 const int32_t* pos, float* out,
                                 int32_t* work, long long work_words,
                                 float* partial, long long partial_floats,
                                 int n, int d, int G, int S, int m, int B,
                                 int bf16, int R, int chunk_rows,
                                 int runs_cap, int reduce_blocks, int gbins,
                                 int accum_bf16, void* stream) {
  if (G <= 0 || d <= 0) return 0;
  const long long reduce_cap = reduce_blocks > 0 ? reduce_blocks : kGridCap;
  if (R <= 0 || chunk_rows <= 0 || S <= 0 || m <= 0 || B <= 0 || n < 0 ||
      runs_cap < (n + R - 1) / R + m || (long long)m * 4 > 48 * 1024 ||
      gbins <= 0 || G % gbins != 0)
    return (int)cudaErrorInvalidValue;
  const int nch = n > 0 ? (n + chunk_rows - 1) / chunk_rows : 1;
  const int nchunks = (d + kFeatBlock - 1) / kFeatBlock;
  const int nbg = (B + kBinGroup - 1) / kBinGroup;
  const int nsg = (S + kStatGroup - 1) / kStatGroup;
  // the bins packed per bin group, rows padded to 16 bytes
  const int dpad = (d + 15) / 16 * 16;
  const long long packed_bytes = (long long)gbins * nbg * n * dpad;
  if (work_words < ws_words(G, n, m, nch, packed_bytes) ||
      partial_floats < (long long)G * runs_cap * S * d * B)
    return (int)cudaErrorInvalidValue;
  // warps of a block: a warp per kFeatWarp features of the widest chunk,
  // two at least
  const int warps = max(2, (min(d, kFeatBlock) + kFeatWarp - 1) / kFeatWarp);
  const long long blocks = (long long)G * runs_cap * nchunks * nbg * nsg;
  if (blocks > 0x7fffffffLL || (long long)G * nch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Workspace w = carve(work, G, n, m, nch);

  const size_t node_smem = (size_t)m * sizeof(int32_t);
  tree_hist_sort_count<<<(unsigned)(G * nch), 256, node_smem, st>>>(
      pos, w.base, n, m, nch, chunk_rows);
  tree_hist_sort_scan<<<(unsigned)G, 1024, 0, st>>>(w.base, w.seg, w.items,
                                                    m, nch, R);
  tree_hist_sort_scatter<<<(unsigned)(G * nch), 32, node_smem, st>>>(
      pos, w.base, w.perm, n, m, nch, chunk_rows);
  tree_hist_pack_bins<<<grid_for(packed_bytes), 256, 0, st>>>(
      bins, w.packed, n, d, dpad, B, nbg, gbins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = bf16 ? tree_hist_mma<false> : tree_hist_mma<true>;
  kernel<<<(unsigned)blocks, warps * kWarp, 0, st>>>(
      w.packed, stats, w.perm, w.seg, w.items, partial, n, d, dpad, S, m, B,
      R, nchunks, nbg, nsg, runs_cap, G / gbins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long SDB = (long long)S * d * B;
  auto reduce = accum_bf16 ? tree_hist_reduce<true>
                           : tree_hist_reduce<false>;
  reduce<<<grid_for((long long)G * m * SDB, reduce_cap), 256, 0, st>>>(
      partial, w.items, out, G, m, SDB, runs_cap);
  return (int)cudaGetLastError();
}

extern "C" const char* tm_tree_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
