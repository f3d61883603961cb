// Device code shared by the prediction kernels (ens_acc.cu, post_scores.cu):
// one sample's genotype masks, each haplotype slot's record, and the walk
// over allele cells that sums f_i f_j 1e-5^(D_ij - dmin) per cell.
//
// Distance. A haplotype is 4 x 32-bit words (L = MAXNUM_SNP = 128). With
// obs0/1/2 the sample's g==0/1/2 bit masks (three warp ballots over the int8
// codes; codes >= 3, missing or padded, are in no mask and add 0),
//   D_ij = a_i + a_j + popc(~(h_i ^ h_j) & obs1)
//        = a_i + a_j + nhet - popc((h_i & obs1) ^ (h_j & obs1)),
// a_i = popc(h_i & obs0) + popc(~h_i & obs2), nhet = popc(obs1). A word
// of obs1 that is 0 adds nothing, so each slot keeps only the NW words in
// which the sample has a heterozygous code, already masked, and the walk is
// compiled once per NW in 0..4 (NW is uniform over the group): a pair costs
// NW xor/popc, not 4. This is the reference's masked XOR-popcount distance,
// exact in integers.
//
// Cells. The valid haplotypes come grouped by allele (the wrappers pack them
// so), so allele cell (a, b), a <= b, is the rectangle of two contiguous
// slot ranges, or a triangle when a == b. Its value in the ordered-pair
// convention is
//   X(a,b) = sum over i in a, j in b of f_i f_j pen_ij   (a < b)
//   X(a,a) = sum over i, j in a of f_i f_j pen_ij        (i == j once)
// with pen_ij = 1e-5^(D_ij - dmin) read from the penalty table. dmin is the
// minimum over all cells, unknown until every cell is walked, so one pass
// sums each cell against its OWN running minimum dc (an online rescale: when
// a smaller D appears, the sums so far are multiplied by 1e-5^(dc - D)) and
// returns (dc, s). The caller scales s by 1e-5^(dc - dmin) once dmin is
// known. Exact in real arithmetic; in float32 the extra roundings are a few
// ulp, and a rescale that falls into float32's denormal range only touches
// terms 1e-40 below the cell's largest.
//
// Groups. One (classifier, sample) is worked on by a group of G threads:
// a whole block (G = 256: the scoring kernel, and the ensemble kernel's
// pair-run kernel, which uses the masks, records and distance here but
// walks pairs, not cells) or one warp (G = 32: the ensemble kernel for
// large classifiers). Every function below takes the thread's rank in its
// group and the group's Scratch; the caller syncs the group between phases
// (group_sync).
//
// Work split, fixed, so that two runs are bitwise equal (no float atomics),
// and so that two cells of the same content are summed alike wherever they
// sit (an exact tie between them stays exact):
//  * A cell of fewer than kSplit pairs belongs to one thread: rank t takes
//    cells t, t + G, ... of the packed upper triangle, so a warp's lanes
//    mostly share the row allele a and hold consecutive b. Each walks
//    allele b's slots (rows) against allele a's (columns) in tiles of R x C
//    pairs (each kernel picks R and C); the columns are the same for those
//    lanes, so the column loop has one length and its shared loads are
//    broadcasts.
//  * A cell of kSplit pairs or more (it has a side of at least kBig slots)
//    belongs to one warp: lanes take rows of the longer side in a stride of
//    32 and walk the other side in step (the column loads are broadcasts),
//    then a fixed xor-shuffle tree combines the lanes' (dc, s). Large cells
//    are dealt to the group's warps in a fixed round robin.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace pair_cells {

constexpr int kL = 128;               // SNP slots per classifier
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPenLen = 2 * kL + 1;   // the penalty table's entries, D - dmin
constexpr int kNone = 2 * kL;         // a cell's dc before its first pair
constexpr int kMasked = 400;          // row base of a padding row: D > kNone
constexpr int kTabLen = 1024;         // the table in shared memory, 0 past
                                      // kPenLen (a padding pair's D - dc)
constexpr int kSplit = 1024;          // pairs from which a cell takes a warp
constexpr int kBig = 32;              // such a cell has a side of >= kBig

// first linear index of row i in the packed upper triangle (diagonal
// included) of an m x m matrix
__device__ __forceinline__ int tri_start(int i, int m) {
  return i * m - (i * (i - 1)) / 2;
}

__device__ __forceinline__ int tri_row(int p, int m) {
  int lo = 0, hi = m - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tri_start(mid, m) <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// (a, b) moved `step` cells on in the packed upper triangle; a == A past it
__device__ __forceinline__ void tri_advance(int& a, int& b, int step, int A) {
  int off = b - a + step;
  while (a < A && off >= A - a) {
    off -= A - a;
    ++a;
  }
  b = a + off;
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if (G == 32) __syncwarp(); else __syncthreads();
}

// A group's scratch, in shared memory.
template <int G>
struct Scratch {
  unsigned obs[3][4];    // g==0/1/2 masks, word w of each
  int red_i[G / 32 + 1];  // per-warp values of the group's reductions
  float red_f[G / 32];
  float red_v[G / 32];
  int red_k[G / 32];
};

// The penalty table into shared memory: pen_tab's kPenLen entries, 0 after;
// by the block's threads (tid of nthreads).
__device__ __forceinline__ void load_table(const float* __restrict__ pen_tab,
                                           float* tab, int tid,
                                           int nthreads) {
  for (int k = tid; k < kTabLen; k += nthreads)
    tab[k] = k < kPenLen ? pen_tab[k] : 0.f;
}

// One sample's masks from its kL codes g: warp w of the group ballots the
// codes of 32-SNP words w, w + G/32, ...
template <int G>
__device__ __forceinline__ void ballot_masks(const int8_t* __restrict__ g,
                                             int rank, Scratch<G>& sc) {
  const int lane = rank & 31;
  for (int w = rank >> 5; w < kL / 32; w += G / 32) {
    const int code = g[32 * w + lane];
    const unsigned b0 = __ballot_sync(kFull, code == 0);
    const unsigned b1 = __ballot_sync(kFull, code == 1);
    const unsigned b2 = __ballot_sync(kFull, code == 2);
    if (lane == 0) {
      sc.obs[0][w] = b0;
      sc.obs[1][w] = b1;
      sc.obs[2][w] = b2;
    }
  }
}

// Every valid slot's record, after the masks are visible: rec[i] = {het
// word 0, het word 1, a_i, f_i's bits}, ext[i] = {het words 2, 3} (each a
// word in which the sample has a heterozygous code, masked to those codes,
// first word first, 0 past NW); ao[a] = the first slot of allele >= a
// (ao[A] = m); and, if al is given, al[i] = slot i's allele. hb, freq,
// allele point at the classifier's first slot.
template <int G>
__device__ __forceinline__ void pack_slots(const uint4* __restrict__ hb,
                                           const float* __restrict__ freq,
                                           const int* __restrict__ allele,
                                           int m, int A, int rank,
                                           const Scratch<G>& sc, uint4* rec,
                                           uint2* ext, int* ao,
                                           unsigned short* al = nullptr) {
  const uint4 o0 = make_uint4(sc.obs[0][0], sc.obs[0][1], sc.obs[0][2],
                              sc.obs[0][3]);
  const uint4 o1 = make_uint4(sc.obs[1][0], sc.obs[1][1], sc.obs[1][2],
                              sc.obs[1][3]);
  const uint4 o2 = make_uint4(sc.obs[2][0], sc.obs[2][1], sc.obs[2][2],
                              sc.obs[2][3]);
  for (int i = rank; i < m; i += G) {
    const uint4 h = hb[i];
    const int ai = __popc(h.x & o0.x) + __popc(h.y & o0.y)
                 + __popc(h.z & o0.z) + __popc(h.w & o0.w)
                 + __popc(~h.x & o2.x) + __popc(~h.y & o2.y)
                 + __popc(~h.z & o2.z) + __popc(~h.w & o2.w);
    unsigned w0 = 0, w1 = 0, w2 = 0, w3 = 0;
    auto push = [&](unsigned hw, unsigned ow) {
      if (ow) {
        w3 = w2;
        w2 = w1;
        w1 = w0;
        w0 = hw & ow;
      }
    };
    push(h.w, o1.w);
    push(h.z, o1.z);
    push(h.y, o1.y);
    push(h.x, o1.x);
    rec[i] = make_uint4(w0, w1, (unsigned)ai, __float_as_uint(freq[i]));
    ext[i] = make_uint2(w2, w3);
    // slot i starts the alleles in (allele[i-1], allele[i]]; the last slot
    // also ends the ones after it
    const int al_i = allele[i];
    const int prev = i > 0 ? allele[i - 1] : -1;
    for (int a = prev + 1; a <= al_i; ++a) ao[a] = i;
    if (i == m - 1)
      for (int a = al_i + 1; a <= A; ++a) ao[a] = m;
    if (al) al[i] = (unsigned short)al_i;
  }
  if (m == 0)
    for (int a = rank; a <= A; a += G) ao[a] = 0;
}

// The sample's heterozygous words and codes.
template <int G>
__device__ __forceinline__ int het_words(const Scratch<G>& sc) {
  return (sc.obs[1][0] != 0) + (sc.obs[1][1] != 0) + (sc.obs[1][2] != 0)
       + (sc.obs[1][3] != 0);
}

template <int G>
__device__ __forceinline__ int het_codes(const Scratch<G>& sc) {
  return __popc(sc.obs[1][0]) + __popc(sc.obs[1][1]) + __popc(sc.obs[1][2])
       + __popc(sc.obs[1][3]);
}

// popc((h_i & obs1) ^ (h_j & obs1)) over the NW heterozygous words
template <int NW>
__device__ __forceinline__ int het_popc(uint4 ri, uint2 ei, uint4 rj,
                                        uint2 ej) {
  int p = 0;
  if (NW > 0) p += __popc(ri.x ^ rj.x);
  if (NW > 1) p += __popc(ri.y ^ rj.y);
  if (NW > 2) p += __popc(ei.x ^ ej.x);
  if (NW > 3) p += __popc(ei.y ^ ej.y);
  return p;
}

// The group's minimum of v, returned to every thread of it (syncs a block
// group).
template <int G>
__device__ __forceinline__ int group_min(int v, int rank, Scratch<G>& sc) {
  for (int off = 16; off; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  if (G == 32) return v;
  if ((rank & 31) == 0) sc.red_i[rank >> 5] = v;
  __syncthreads();
  if (rank == 0) {
    int r = sc.red_i[0];
    for (int w = 1; w < G / 32; ++w) r = min(r, sc.red_i[w]);
    sc.red_i[G / 32] = r;
  }
  __syncthreads();
  return sc.red_i[G / 32];
}

struct Cells {
  const uint4* rec;
  const uint2* ext;
  const float* tab;
  const int* ao;
  const short* pa;  // the alleles walked, in order (null: 0..A-1)
  const int* ps;    // their first slots, n + 1 entries (ao when pa is null)
  int n;            // how many: cells are the n(n+1)/2 pairs of them
  int A;
  int nhet;
};
// Rows r0, r0 + rstep, ... < r1 against columns q0..q1-1 in tiles of R
// rows (in registers) by C columns; (dc, s) carried in and out. A tile's
// R x C distances are independent, and the running minimum is checked once
// a tile, so the shared loads and popcounts of a tile overlap (a check per
// pair would chain every pair's table read to the one before). A padding
// row or column of a tile has base kMasked: its D exceeds every real dc,
// its pen is 0 and its frequency 0.
template <int NW, int R, int C>
__device__ __forceinline__ void walk_rect(const Cells& cx, int r0, int r1,
                                          int rstep, int q0, int q1, int& dc,
                                          float& s) {
  const uint4* rec = cx.rec;
  const uint2* ext = cx.ext;
  const float* tab = cx.tab;
  for (int r = r0; r < r1; r += R * rstep) {
    uint4 ri[R];
    uint2 ei[R];
    int bi[R];
    float fi[R], row[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = r + u * rstep;
      const bool ok = i < r1;
      ri[u] = ok ? rec[i] : make_uint4(0u, 0u, 0u, 0u);
      ei[u] = (NW > 2 && ok) ? ext[i] : make_uint2(0u, 0u);
      bi[u] = ok ? (int)ri[u].z + cx.nhet : kMasked;
      fi[u] = ok ? __uint_as_float(ri[u].w) : 0.f;
      row[u] = 0.f;
    }
    for (int q = q0; q < q1; q += C) {
      uint4 rj[C];
      uint2 ej[C];
#pragma unroll
      for (int v = 0; v < C; ++v) {
        const bool ok = q + v < q1;
        rj[v] = ok ? rec[q + v] : make_uint4(0u, 0u, (unsigned)kMasked, 0u);
        ej[v] = (NW > 2 && ok) ? ext[q + v] : make_uint2(0u, 0u);
      }
      int d[R][C];
      int dm = INT_MAX;
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int v = 0; v < C; ++v) {
          d[u][v] = bi[u] + (int)rj[v].z
                  - het_popc<NW>(ri[u], ei[u], rj[v], ej[v]);
          dm = min(dm, d[u][v]);
        }
      if (dm < dc) {
        const float down = tab[dc - dm];
#pragma unroll
        for (int u = 0; u < R; ++u) row[u] *= down;
        s *= down;
        dc = dm;
      }
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int v = 0; v < C; ++v)
          row[u] += __uint_as_float(rj[v].w) * tab[d[u][v] - dc];
    }
#pragma unroll
    for (int u = 0; u < R; ++u) s += fi[u] * row[u];
  }
}

// The triangle of rows r0, r0 + rstep, ... < r1 against the columns j >= i
// of the same range (which ends at r1): i == j once at half weight, i < j
// once; the caller doubles the cell.
template <int NW>
__device__ __forceinline__ void walk_tri(const Cells& cx, int r0, int r1,
                                         int rstep, int& dc, float& s) {
  const uint4* rec = cx.rec;
  const uint2* ext = cx.ext;
  const float* tab = cx.tab;
  for (int i = r0; i < r1; i += rstep) {
    const uint4 ri = rec[i];
    const uint2 ei = NW > 2 ? ext[i] : make_uint2(0u, 0u);
    const int bi = (int)ri.z + cx.nhet;
    const float fi = __uint_as_float(ri.w);
    const int dii = bi + (int)ri.z;
    if (dii < dc) {
      s *= tab[dc - dii];
      dc = dii;
    }
    float row = 0.5f * fi * tab[dii - dc];
    for (int j = i + 1; j < r1; ++j) {
      const uint4 rj = rec[j];
      const uint2 ej = NW > 2 ? ext[j] : make_uint2(0u, 0u);
      const int d = bi + (int)rj.z - het_popc<NW>(ri, ei, rj, ej);
      if (d < dc) {
        const float down = tab[dc - d];
        row *= down;
        s *= down;
        dc = d;
      }
      row += __uint_as_float(rj.w) * tab[d - dc];
    }
    s += fi * row;
  }
}

// (dc, s) + (d2, s2) of one cell, both relative to their own minimum: the
// sum relative to the smaller. Products and sum rounded separately, so the
// result does not depend on the operands' order.
__device__ __forceinline__ void combine(const float* tab, int& dc, float& s,
                                        int d2, float s2) {
  const int d = min(dc, d2);
  s = __fadd_rn(__fmul_rn(s, tab[dc - d]), __fmul_rn(s2, tab[d2 - d]));
  dc = d;
}

// Combines the lanes' (dc, s) in a fixed xor tree; every lane ends with the
// warp's.
__device__ __forceinline__ void warp_combine(const float* tab, int& dc,
                                             float& s) {
  for (int off = 16; off; off >>= 1) {
    const int od = __shfl_xor_sync(kFull, dc, off);
    const float os = __shfl_xor_sync(kFull, s, off);
    combine(tab, dc, s, od, os);
  }
}

__device__ __forceinline__ int cell_pairs(const int* ao, int a, int b) {
  return (ao[a + 1] - ao[a]) * (ao[b + 1] - ao[b]);
}

// Walks every cell (a, b), a <= b both among the walked alleles, once,
// calling sink(a, b, k, dc, s) with k its packed index in the A x A upper
// triangle and s in the ordered-pair convention (X above, relative to dc);
// returns the least dc this thread saw (kNone if none).
template <int G, int NW, int R, int C, class Sink>
__device__ __forceinline__ int walk_cells_nw(const Cells& cx, int rank,
                                             Sink& sink) {
  const int A = cx.A, n = cx.n, ncell = n * (n + 1) / 2;
  const int* ao = cx.ao;
  const int lane = rank & 31, warp = rank >> 5;
  int mind = kNone;
  // Thread cells: rank t takes cells t, t + G, ... of the walked
  // alleles' triangle, so a warp's lanes mostly share the row allele a and
  // hold consecutive b. Rows are b's slots (R at a time), columns a's: the
  // column loop has the same length and reads the same slot in every such
  // lane (a broadcast).
  if (rank < ncell) {
    int u = tri_row(rank, n);
    int v = u + (rank - tri_start(u, n));
    for (; u < n; tri_advance(u, v, G, n)) {
      const int a = cx.pa ? cx.pa[u] : u, b = cx.pa ? cx.pa[v] : v;
      const int i0 = cx.ps[u], i1 = cx.ps[u + 1];
      const int j0 = cx.ps[v], j1 = cx.ps[v + 1];
      if ((i1 - i0) * (j1 - j0) >= kSplit) continue;
      int dc = kNone;
      float s = 0.f;
      if (a == b) {
        walk_tri<NW>(cx, i0, i1, 1, dc, s);
        s *= 2.f;
      } else {
        walk_rect<NW, R, C>(cx, j0, j1, 1, i0, i1, dc, s);
      }
      sink(a, b, tri_start(a, A) + (b - a), dc, s);
      mind = min(mind, dc);
    }
  }
  // Large cells: each touches an allele x of >= kBig slots. Every warp
  // scans the alleles for such x in order and numbers the candidates (x, y),
  // y = 0..A-1, as x's rank * A + y; warp w takes those = w mod G/32.
  // (x, y) is taken under x unless y is such an allele too and y < x. Lanes
  // take rows of the longer side in a stride of 32.
  int rank_base = 0;
  for (int base = 0; base < A; base += 32) {
    const int xa = base + lane;
    unsigned bal =
        __ballot_sync(kFull, xa < A && ao[xa + 1] - ao[xa] >= kBig);
    while (bal) {
      const int x = base + __ffs(bal) - 1;
      bal &= bal - 1;
      constexpr int W = G / 32;
      for (int y = (warp - rank_base % W + W) % W; y < A; y += W) {
        if (y < x && ao[y + 1] - ao[y] >= kBig) continue;
        const int a = min(x, y), b = max(x, y);
        if (cell_pairs(ao, a, b) < kSplit) continue;
        int dc = kNone;
        float s = 0.f;
        const int i0 = ao[a], i1 = ao[a + 1], j0 = ao[b], j1 = ao[b + 1];
        if (a == b)
          walk_tri<NW>(cx, i0 + lane, i1, 32, dc, s);
        else if (i1 - i0 >= j1 - j0)
          walk_rect<NW, 1, C>(cx, i0 + lane, i1, 32, j0, j1, dc, s);
        else
          walk_rect<NW, 1, C>(cx, j0 + lane, j1, 32, i0, i1, dc, s);
        warp_combine(cx.tab, dc, s);
        if (a == b) s *= 2.f;
        if (lane == 0) sink(a, b, tri_start(a, A) + (b - a), dc, s);
        mind = min(mind, dc);
      }
      rank_base += A;
    }
  }
  return mind;
}

// walk_cells_nw at the group's NW; returns the group's dmin = min over the
// cells of dc (kNone without pairs) and syncs the group, so that every
// sink's write is visible after it.
template <int G, int R, int C, class Sink>
__device__ __forceinline__ int walk_cells(const Cells& cx, int nw, int rank,
                                          Scratch<G>& sc, Sink& sink) {
  int mind;
  switch (nw) {
    case 0: mind = walk_cells_nw<G, 0, R, C>(cx, rank, sink); break;
    case 1: mind = walk_cells_nw<G, 1, R, C>(cx, rank, sink); break;
    case 2: mind = walk_cells_nw<G, 2, R, C>(cx, rank, sink); break;
    case 3: mind = walk_cells_nw<G, 3, R, C>(cx, rank, sink); break;
    default: mind = walk_cells_nw<G, 4, R, C>(cx, rank, sink); break;
  }
  mind = group_min<G>(mind, rank, sc);
  group_sync<G>();
  return mind;
}

// The alleles with slots, in order, into pa and their first slots into ps
// (ps[count] = m), by one warp: lanes ballot over 32 alleles at a time.
// Returns their count. The caller syncs before reading pa or ps.
__device__ __forceinline__ int present_alleles(const int* ao, int A, int m,
                                               short* pa, int* ps, int lane) {
  int cnt = 0;
  for (int base = 0; base < A; base += 32) {
    const int a = base + lane;
    const bool here = a < A && ao[a + 1] > ao[a];
    const unsigned bal = __ballot_sync(kFull, here);
    if (here) {
      const int at = cnt + __popc(bal & ((1u << lane) - 1));
      pa[at] = (short)a;
      ps[at] = ao[a];
    }
    cnt += __popc(bal);
  }
  if (lane == 0) ps[cnt] = m;
  return cnt;
}

}  // namespace pair_cells
