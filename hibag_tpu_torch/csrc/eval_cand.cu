// Candidate evaluation (OOB accuracy count and in-bag -2 log-likelihood) for
// all candidate SNPs of K classifiers, NVIDIA Hopper (sm_90a).
//
// Replaces hibag_tpu/ops/train_step_pallas.py::_eval_kernel (entry
// evaluate_candidates_pallas). For classifier k, sample n and candidate c:
//   D_ij    distance of haplotype pair (i, j) to the sample's genotypes at
//           the selected SNPs, over haplotypes with fA > 0 or fB > 0 for some
//           candidate ("ok"); dmin = min D; pen_ij = 1e-5^(D_ij - dmin)
//   S_c[a,b] = sum over ordered ok pairs (i in allele a, j in allele b) of
//           pen_ij (pd0 fA_i fA_j + pd1 (fA_i fB_j + fB_i fA_j) + pd2 fB_i fB_j)
// with pd_m = 1e-5^delta(g_c, m) the new SNP's penalty for bit sum m. Then
// total = sum S, the true pair's score S[a1,a2] * (1 or 2), the first
// row-major maximum of S * (2 - I) as the best guess, the
// CHLATypeList::Compare count gated by oob and total > 0, and
// -2 B log(max(post, 1e-37)), as hibag_tpu/models/em.py::evaluate_candidates.
// Denormals: hibag_tpu's sums run under XLA's flush of float32 denormals, so
// this source alone is compiled with -ftz=true (ops/_build.py SOURCE_FLAGS):
// every float32 operation here flushes denormal operands and results to 0
// (a penalty of distance 8 or 9 above dmin, a product or partial sum below
// FLT_MIN). A total or true-pair score below FLT_MIN counts as 0 as well,
// as the plain version reads it.
//
// What bounds it on the H100: float work, C * m^2 / 2 pair-candidate terms
// per (k, n) for m ok haplotypes at 2 FMAs each (the TPU kernel's own
// factorisation, train_step_pallas.py:480-497); device-memory traffic is
// small (128 code bytes per sample, the classifier's haplotypes and
// frequencies once per block).
//
// What the design does about it:
//  * One distance and one penalty per pair and group of 4 candidates. For a
//    row slot i (allele a) and a column allele b, a thread sums
//      rA_c = sum_j pen_ij fA_cj,  rB_c = sum_j pen_ij fB_cj   (j in b)
//    for the 4 candidates c of its group (one float4 of fA and one of fB
//    per column), then folds the row (row_terms):
//      T_ci = gA_ci rA_c + gB_ci rB_c,
//      gA = pd0 fA_i + pd1 fB_i,  gB = pd1 fA_i + pd2 fB_i.
//    S_c[a,b] = 2 * sum over i in a of T_ci (the cell holds S + S^T); on
//    the diagonal cell j runs over i <= j only, (i, i) at half weight, so
//    the doubled sum is the full square of a (ordered pairs). A row is
//    dealt to a thread as (row, group), consecutive threads on consecutive
//    rows of one group, so a warp reads the same column record and
//    frequencies (broadcasts).
//  * Records from pair_cells.cuh: the sample's masks by ballots, each slot's
//    heterozygous words only (pack_slots), the distance over NW of them
//    (het_popc<NW>, NW dispatched per sample). dmin exact by one distance
//    pass before the fold, so each penalty is the table's tab[D - dmin],
//    bitwise the plain version's.
//  * Two paths, chosen by shape (ops/train_step.py::eval_plan, from M, A
//    and C alone):
//    - phases (plan 1), where the candidates' frequencies, a [slot][
//      candidate] row scratch and the cell grids of all A(A+1)/2 cells fit
//      shared memory beside the slot records (every A=14 shape up to 256
//      slots): one phase per column allele b, whose rows are the slots of
//      alleles <= b (slots are sorted by allele); each row writes its T to
//      the scratch, and after a sync one thread per (cell (a, b),
//      candidate) adds its rows in slot order into the grid, which the
//      finish reads whole.
//    - tiles (plans 0 and -1), everywhere else: the cells in packed order
//      (tri_start(a, A) + b - a), tile_cells(Cp) at a time (24 KB of
//      values; 288 cells at C=17), each made whole by one
//      thread for one group of 4 candidates (the groups of a cell on
//      neighbouring threads): the rows of a kRows at a time (the rest 2
//      and 1 at a time) against b's columns (each column's record and
//      frequencies read once for them),
//      their T added to the cell's sum in registers in slot order, 2 s
//      written to the tile's [candidate][cell] values in shared memory. A
//      cell of kBigPairs pairs or more (rows enough for a warp's lanes)
//      takes a warp instead, so that no thread walks it alone: (row,
//      group) to lanes as in the phase path, 32 rows' T into the warp's
//      buffer, then each lane adds one candidate's in slot order. The finish then consumes the tile:
//      lane l of a candidate's warp takes the cells q = l (mod 32) in
//      increasing q, so its running total, first maximum and true-pair
//      value are those of the whole-grid finish bit for bit. A tile whose
//      cells all lack rows or columns holds only zeros, which change no sum
//      and no maximum that matters (the best guess counts only where the
//      total is above 0), so it is skipped. No phases, no grid, no row
//      scratch and nothing per block in device memory; the frequencies are
//      read from device memory (L1). Where not even the slot records fit
//      (24 bytes a slot, past about 9,000 slots), they go to the block's
//      device scratch (plan -1).
//    Both paths do the same arithmetic in the same order.
//  * A block owns one classifier and a run of samples: the penalty table
//    (and under plan 1 the frequencies) are loaded once for the run.
//  * Determinism: one writer per (sample, candidate, cell), in a fixed
//    order; no float atomics. A candidate's arithmetic is the same wherever
//    it sits in a group or a float4 (explicitly rounded products and sums),
//    so two identical candidates give bitwise-equal results. The
//    per-sample results go to [K, C, N] and a second kernel adds them in
//    sample order.
//  * Ties: the best guess is the smallest packed upper-triangle index among
//    equal maxima, which is the first row-major maximum of the full grid.
// Limits: H <= 46,340 haplotype slots (the slot-pair triangle is indexed in
// int32), C <= 64 candidates, A by the allele offsets in shared memory.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

#include "launch_marks.cuh"
#include "pair_cells.cuh"

namespace {

using pair_cells::het_popc;
using pair_cells::kL;
using pair_cells::kPenLen;
using pair_cells::tri_row;
using pair_cells::tri_start;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTab = 260;            // kPenLen entries, padded to 16 bytes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBytes = 24 * 1024;  // a tile's cell values
constexpr int kBigPairs = 256;  // pairs from which a cell takes a warp
constexpr int kRows = 4;        // rows a thread walks together

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// cells a tile of the tiled path holds at Cp candidates (padded to 4): a
// multiple of 32, at most 1,024
__host__ __device__ inline int tile_cells(int Cp) {
  const int t = (kTileBytes / (4 * Cp)) & ~31;
  return t < 1024 ? t : 1024;
}

// Plans: the path, and where the frequencies and the slot records are
// (ops/train_step.py::eval_plan).
constexpr int kPlanShared = 1;    // phases, all in shared memory
constexpr int kPlanTiled = 0;     // tiles, records in shared memory
constexpr int kPlanRecords = -1;  // tiles, records in device memory

// a lane's finish of one candidate over the cells it has taken
struct __align__(16) Fin {
  float t, bv, tq;
  int bk;
};

// The dynamic shared memory's layout, in bytes from its start.
struct Layout {
  long long pd, ao, rec, ext, fq, contrib, grid, cell, val, fin, wbuf, end;
  // Cp: the candidates padded to 4
  __host__ __device__ Layout(int M, int A, int Cp, int plan) {
    const bool shared = plan == kPlanShared, tiled = !shared;
    const long long ncell = (long long)A * (A + 1) / 2;
    pd = kTab * 4;                                // float [3][Cp]
    ao = pd + 3LL * Cp * 4;                       // int [A + 1]
    rec = ao + round4(A + 1) * 4LL;               // uint4 [M]
    ext = rec + (plan >= kPlanTiled ? 16LL * M : 0);  // uint2 [M]
    fq = ext + (plan >= kPlanTiled ? 8LL * M : 0);    // float4 [M][Cp/4][2]
    contrib = fq + (shared ? 8LL * M * Cp : 0);   // float [M][Cp]
    grid = contrib + (shared ? 4LL * M * Cp : 0); // float [Cp][ncell]
    const long long T = tiled ? tile_cells(Cp) : 0;
    cell = grid + (shared ? 4LL * Cp * ncell : 0);  // int4 [T]
    val = cell + 16LL * T;                        // float [Cp][T]
    fin = val + 4LL * Cp * T;                     // Fin [Cp][32]
    wbuf = fin + (tiled ? 16LL * Cp * 32 : 0);    // float [kWarps][32][Cp]
    end = wbuf + (tiled ? 4LL * kWarps * 32 * Cp : 0);
  }
};

// Floats of a block's device scratch under plan -1: the slot records as
// uint4 [M] and uint2 [M].
__host__ __device__ inline long long block_scratch(int M) { return 6LL * M; }

struct Args {
  const uint4* hb;       // [K, H] ok slots first, sorted by allele
  const int* al;         // [K, H] their alleles
  const int* nok;        // [K] ok slots
  const float4* fq;      // [K, H, NG, 2] fA, fB of candidates 4g..4g+3
  const int8_t* gcand;   // [K, C, N]
  const int8_t* geno;    // [K, N, kL]
  const int* a1;         // [N]
  const int* a2;
  const uint8_t* oob;    // [K, N]
  const float* bw;       // [K, N]
  const float* pen_tab;  // [kPenLen]
  int* accp;             // [K, C, N]
  float* llp;
  float* gscratch;       // per block block_scratch(M) floats, or null
  int H, N, C, A, M, NG, S, plan;  // NG = Cp / 4 groups of 4 candidates
};

// Where a block's frequencies, records and buffers are.
struct Block {
  const float* tab;
  const float* pd;       // [3][Cp]
  const int* ao;
  const uint4* rec;
  const uint2* ext;
  const float4* fq;      // column j, group g: fq[2 (j * NG + g)], fA then fB
  float* contrib;        // plan 1
  float* grid;
  int4* cell;            // the tiled path: a tile's cells' slot ranges
  float* val;            // the tile's cells, [Cp][tile_cells(Cp)]
  Fin* fin;              // [Cp][32]
  float* wbuf;           // a warp's T of 32 rows, [32][Cp] each
  int m, ncell;
};

// -dmin over the upper triangle of ok pairs (D less the sample's
// heterozygous count, which dmin's shift cancels), to every thread
template <int NW>
__device__ __forceinline__ int sample_base(const Block& x,
                                           pair_cells::Scratch<kThreads>& sc) {
  const int tid = threadIdx.x, m = x.m;
  const uint4* rec = x.rec;
  const uint2* ext = x.ext;
  int dm = INT_MAX;
  const int npair = m * (m + 1) / 2;
  const int per = (npair + kThreads - 1) / kThreads;
  const int p0 = min(tid * per, npair), p1 = min(p0 + per, npair);
  if (p0 < p1) {
    int i = tri_row(p0, m);
    int j = i + (p0 - tri_start(i, m));
    uint4 ri = rec[i];
    uint2 ei = NW > 2 ? ext[i] : make_uint2(0u, 0u);
    for (int q = p0; q < p1; ++q) {
      const uint4 rj = rec[j];
      const uint2 ej = NW > 2 ? ext[j] : make_uint2(0u, 0u);
      dm = min(dm, (int)ri.z + (int)rj.z - het_popc<NW>(ri, ei, rj, ej));
      if (++j == m) {
        j = ++i;
        if (i < m) {
          ri = rec[i];
          if (NW > 2) ei = ext[i];
        }
      }
    }
  }
  return -pair_cells::group_min<kThreads>(dm, tid, sc);
}

// T of row slot i against the column slots jb..je-1 (allele b) for the 4
// candidates of group g; the diagonal cell where i >= jb. base = -dmin.
template <int NW>
__device__ __forceinline__ float4 row_terms(const Block& x, int ngl, int i,
                                            int jb, int je, int g,
                                            int base) {
  const uint4* rec = x.rec;
  const uint2* ext = x.ext;
  const float* tab = x.tab;
  const int Cp = 4 * ngl;
  const uint4 ri = rec[i];
  const uint2 ei = NW > 2 ? ext[i] : make_uint2(0u, 0u);
  const int bi = (int)ri.z + base;
  float rA[4] = {0.f, 0.f, 0.f, 0.f}, rB[4] = {0.f, 0.f, 0.f, 0.f};
  int j = jb;
  if (i >= jb) {  // the diagonal cell: (i, i) at half weight, then j > i
    const float h = __fmul_rn(
        0.5f, tab[bi + (int)ri.z - het_popc<NW>(ri, ei, ri, ei)]);
    const float4* col = x.fq + 2 * ((size_t)i * ngl + g);
    const float4 fa = col[0], fb = col[1];
    rA[0] = __fmul_rn(h, fa.x);
    rA[1] = __fmul_rn(h, fa.y);
    rA[2] = __fmul_rn(h, fa.z);
    rA[3] = __fmul_rn(h, fa.w);
    rB[0] = __fmul_rn(h, fb.x);
    rB[1] = __fmul_rn(h, fb.y);
    rB[2] = __fmul_rn(h, fb.z);
    rB[3] = __fmul_rn(h, fb.w);
    j = i + 1;
  }
  const float4* col = x.fq + 2 * ((size_t)j * ngl + g);
  for (; j < je; ++j, col += 2 * ngl) {
    const uint4 rj = rec[j];
    const uint2 ej = NW > 2 ? ext[j] : make_uint2(0u, 0u);
    const float pen = tab[bi + (int)rj.z - het_popc<NW>(ri, ei, rj, ej)];
    const float4 fa = col[0], fb = col[1];
    rA[0] = __fmaf_rn(pen, fa.x, rA[0]);
    rA[1] = __fmaf_rn(pen, fa.y, rA[1]);
    rA[2] = __fmaf_rn(pen, fa.z, rA[2]);
    rA[3] = __fmaf_rn(pen, fa.w, rA[3]);
    rB[0] = __fmaf_rn(pen, fb.x, rB[0]);
    rB[1] = __fmaf_rn(pen, fb.y, rB[1]);
    rB[2] = __fmaf_rn(pen, fb.z, rB[2]);
    rB[3] = __fmaf_rn(pen, fb.w, rB[3]);
  }
  const float4* row = x.fq + 2 * ((size_t)i * ngl + g);
  const float4 fa = row[0], fb = row[1];
  const float fai[4] = {fa.x, fa.y, fa.z, fa.w};
  const float fbi[4] = {fb.x, fb.y, fb.z, fb.w};
  float t[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 4 * g + q;
    const float pd0 = x.pd[c], pd1 = x.pd[Cp + c], pd2 = x.pd[2 * Cp + c];
    const float gA = __fmaf_rn(pd1, fbi[q], __fmul_rn(pd0, fai[q]));
    const float gB = __fmaf_rn(pd2, fbi[q], __fmul_rn(pd1, fai[q]));
    t[q] = __fmaf_rn(gB, rB[q], __fmul_rn(gA, rA[q]));
  }
  return make_float4(t[0], t[1], t[2], t[3]);
}

// rows_sum: row_terms' arithmetic for R rows of cell cr = (first, end slot
// of a, of b) from r0, their T added to s in slot order. The R rows walk
// the columns together, so that each column's record and frequencies are
// read once for them; on the diagonal cell (a == b) a row skips the
// columns before its own and takes (i, i) at half weight, h fA rounded
// once as fma(h, fA, 0). (row_terms stays apart for the phase path and
// the warp mode: these per-column diagonal tests slow a single row.)
template <int NW, int R>
__device__ __forceinline__ void rows_sum(const Block& x, int ngl, int4 cr,
                                         int r0, int g, int base,
                                         float s[4]) {
  const uint4* rec = x.rec;
  const uint2* ext = x.ext;
  const float* tab = x.tab;
  const bool diag = cr.x == cr.z;  // a == b: the rows are the columns
  uint4 ri[R];
  uint2 ei[R];
  int bi[R];
  float rA[R][4], rB[R][4];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    ri[u] = rec[r0 + u];
    ei[u] = NW > 2 ? ext[r0 + u] : make_uint2(0u, 0u);
    bi[u] = (int)ri[u].z + base;
#pragma unroll
    for (int q = 0; q < 4; ++q) rA[u][q] = rB[u][q] = 0.f;
  }
  const int j0 = diag ? r0 : cr.z;
  const float4* col = x.fq + 2 * ((size_t)j0 * ngl + g);
  for (int j = j0; j < cr.w; ++j, col += 2 * ngl) {
    const uint4 rj = rec[j];
    const uint2 ej = NW > 2 ? ext[j] : make_uint2(0u, 0u);
    const float4 fa = col[0], fb = col[1];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (diag && j < r0 + u) continue;
      float pen = tab[bi[u] + (int)rj.z - het_popc<NW>(ri[u], ei[u], rj, ej)];
      if (diag && j == r0 + u) pen = __fmul_rn(0.5f, pen);
      rA[u][0] = __fmaf_rn(pen, fa.x, rA[u][0]);
      rA[u][1] = __fmaf_rn(pen, fa.y, rA[u][1]);
      rA[u][2] = __fmaf_rn(pen, fa.z, rA[u][2]);
      rA[u][3] = __fmaf_rn(pen, fa.w, rA[u][3]);
      rB[u][0] = __fmaf_rn(pen, fb.x, rB[u][0]);
      rB[u][1] = __fmaf_rn(pen, fb.y, rB[u][1]);
      rB[u][2] = __fmaf_rn(pen, fb.z, rB[u][2]);
      rB[u][3] = __fmaf_rn(pen, fb.w, rB[u][3]);
    }
  }
  const float4 pd0 = reinterpret_cast<const float4*>(x.pd)[g];
  const float4 pd1 = reinterpret_cast<const float4*>(x.pd)[ngl + g];
  const float4 pd2 = reinterpret_cast<const float4*>(x.pd)[2 * ngl + g];
  const float p0[4] = {pd0.x, pd0.y, pd0.z, pd0.w};
  const float p1[4] = {pd1.x, pd1.y, pd1.z, pd1.w};
  const float p2[4] = {pd2.x, pd2.y, pd2.z, pd2.w};
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const float4* row = x.fq + 2 * ((size_t)(r0 + u) * ngl + g);
    const float4 fa = row[0], fb = row[1];
    const float fai[4] = {fa.x, fa.y, fa.z, fa.w};
    const float fbi[4] = {fb.x, fb.y, fb.z, fb.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float gA = __fmaf_rn(p1[q], fbi[q], __fmul_rn(p0[q], fai[q]));
      const float gB = __fmaf_rn(p2[q], fbi[q], __fmul_rn(p1[q], fai[q]));
      s[q] = __fadd_rn(
          s[q], __fmaf_rn(gB, rB[u][q], __fmul_rn(gA, rA[u][q])));
    }
  }
}

// The sum in slot order of T over the rows of cell cr for group g: rows
// kRows at a time, the rest 2 and 1 at a time.
template <int NW>
__device__ __forceinline__ float4 cell_sum(const Block& x, int ngl, int4 cr,
                                           int g, int base) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int r0 = cr.x;
  for (; r0 + kRows <= cr.y; r0 += kRows)
    rows_sum<NW, kRows>(x, ngl, cr, r0, g, base, s);
  if (r0 + 2 <= cr.y) {
    rows_sum<NW, 2>(x, ngl, cr, r0, g, base, s);
    r0 += 2;
  }
  if (r0 < cr.y) rows_sum<NW, 1>(x, ngl, cr, r0, g, base, s);
  return make_float4(s[0], s[1], s[2], s[3]);
}

// Whether the tiled path gives cell cr a warp: rows enough for the warp's
// lanes (one per row and group) and kBigPairs pairs or more.
__device__ __forceinline__ bool big_cell(int4 cr, int ngl) {
  const int na = cr.y - cr.x;
  return na * ngl >= 32 && na * (cr.w - cr.z) >= kBigPairs;
}

// Cell cr, tile cell t, made by one warp: 32 rows at a time, (row, group)
// to lanes, consecutive lanes on consecutive rows of one group (the same
// columns: broadcasts), each T (row_terms) into the warp's buffer; then
// lane c adds candidate c's T in slot order to its running sum.
template <int NW>
__device__ __forceinline__ void warp_cell(const Block& x, int ngl, int4 cr,
                                          int t, int kTile, int base) {
  const int lane = threadIdx.x & 31, Cp = 4 * ngl;
  float* buf = x.wbuf + (threadIdx.x >> 5) * 32 * Cp;
  float s0 = 0.f, s1 = 0.f;  // candidates lane and lane + 32
  for (int r0 = cr.x; r0 < cr.y; r0 += 32) {
    const int nr = min(32, cr.y - r0);
    for (int u = lane; u < nr * ngl; u += 32) {
      const int g = u / nr, r = u - g * nr;
      *reinterpret_cast<float4*>(buf + r * Cp + 4 * g) =
          row_terms<NW>(x, ngl, r0 + r, cr.z, cr.w, g, base);
    }
    __syncwarp();
    for (int r = 0; r < nr; ++r) {
      if (lane < Cp) s0 = __fadd_rn(s0, buf[r * Cp + lane]);
      if (lane + 32 < Cp) s1 = __fadd_rn(s1, buf[r * Cp + lane + 32]);
    }
    __syncwarp();
  }
  if (lane < Cp) x.val[lane * kTile + t] = 2.f * s0;
  if (lane + 32 < Cp) x.val[(lane + 32) * kTile + t] = 2.f * s1;
}

// The phase path: the cell grids of one sample, after its masks, records
// and penalties are in shared memory.
template <int NW>
__device__ __forceinline__ void fold_sample(const Args& p, const Block& x,
                                            pair_cells::Scratch<kThreads>& sc) {
  const int tid = threadIdx.x;
  const int A = p.A, ngl = p.NG, Cp = 4 * p.NG;
  const int base = sample_base<NW>(x, sc);  // D - dmin = a_i + a_j - popc + base
  for (int b = 0; b < A; ++b) {
    const int jb = x.ao[b], je = x.ao[b + 1];
    if (jb < je) {
      const int rows = je;  // the slots of alleles <= b
      for (int u = tid; u < rows * ngl; u += kThreads) {
        const int g = u / rows, i = u - g * rows;
        *reinterpret_cast<float4*>(x.contrib + (size_t)i * Cp + 4 * g) =
            row_terms<NW>(x, ngl, i, jb, je, g, base);
      }
    }
    __syncthreads();
    // cells (a, b), a <= b: the rows of a in slot order
    for (int v = tid; v < (b + 1) * Cp; v += kThreads) {
      const int a = v / Cp, c = v - a * Cp;
      float s = 0.f;
      if (jb < je)
        for (int i = x.ao[a]; i < x.ao[a + 1]; ++i)
          s = __fadd_rn(s, x.contrib[(size_t)i * Cp + c]);
      x.grid[(size_t)c * x.ncell + tri_start(a, A) + (b - a)] = 2.f * s;
    }
    __syncthreads();
  }
}

// Writes candidate c's results from its total t, best cell bk and true-pair
// value tq: the Compare count and -2 B log post.
__device__ __forceinline__ void write_result(const Args& p, int k, int n,
                                             int c, float t, int bk,
                                             float tq) {
  const int A = p.A, a1 = p.a1[n], a2 = p.a2[n];
  const int g1 = tri_row(bk, A);
  const int g2 = g1 + (bk - tri_start(g1, A));
  // CHLATypeList::Compare (src/LibHLA.cpp:911-924)
  const bool m1 = (g1 == a1) || (g1 == a2);
  const int t1u = (m1 && g1 == a1) ? -1 : a1;
  const int t2u = (m1 && g1 != a1 && g1 == a2) ? -1 : a2;
  const bool m2 = (g2 == t1u) || (g2 == t2u);
  const int cnt = (int)m1 + (int)m2;
  // sums below FLT_MIN count as 0, as under XLA's denormal flush
  const float total = t >= FLT_MIN ? t : 0.f;
  tq = tq >= FLT_MIN ? tq : 0.f;
  const float post = tq / fmaxf(total, 1e-37f);
  const size_t o = ((size_t)k * p.C + c) * p.N + n;
  const bool is_oob = p.oob[(size_t)k * p.N + n] != 0;
  p.accp[o] = (is_oob && total > 0.f) ? cnt : 0;
  p.llp[o] = -2.f * p.bw[(size_t)k * p.N + n] * logf(fmaxf(post, 1e-37f));
}

// The lanes' (total, first maximum) of one candidate combined in a fixed
// xor tree; every lane ends with the warp's.
__device__ __forceinline__ void combine_lanes(float& t, float& bv, int& bk) {
  for (int off = 16; off; off >>= 1) {
    t = __fadd_rn(t, __shfl_xor_sync(kFull, t, off));
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int ok = __shfl_xor_sync(kFull, bk, off);
    if (ov > bv || (ov == bv && ok < bk)) { bv = ov; bk = ok; }
  }
}

// The phase path's finish, per candidate: total, first maximum and true
// pair from the whole grid.
__device__ __forceinline__ void finish_sample(const Args& p, const Block& x,
                                              int k, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncell = x.ncell;
  const int true_cell = tri_start(p.a1[n], p.A) + (p.a2[n] - p.a1[n]);
  for (int c = warp; c < p.C; c += kWarps) {
    const float* gq = x.grid + (size_t)c * ncell;
    float t = 0.f, bv = -1.f;
    int bk = INT_MAX;
    for (int q = lane; q < ncell; q += 32) {
      const float v = gq[q];
      t = __fadd_rn(t, v);
      if (v > bv) { bv = v; bk = q; }
    }
    combine_lanes(t, bv, bk);
    if (lane == 0) write_result(p, k, n, c, t, bk, gq[true_cell]);
  }
}

// The tiled path: one sample's cells made tile by tile and consumed by the
// finish, after its masks, records and penalties are in shared memory.
template <int NW>
__device__ __forceinline__ void tile_sample(const Args& p, const Block& x,
                                            pair_cells::Scratch<kThreads>& sc,
                                            int k, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int A = p.A, C = p.C, ngl = p.NG, Cp = 4 * p.NG;
  const int ncell = x.ncell, kTile = tile_cells(Cp);
  const int true_cell = tri_start(p.a1[n], A) + (p.a2[n] - p.a1[n]);
  const int base = sample_base<NW>(x, sc);
  for (int c = warp; c < C; c += kWarps)
    x.fin[c * 32 + lane] = Fin{0.f, -1.f, 0.f, INT_MAX};
  for (int q0 = 0; q0 < ncell; q0 += kTile) {
    // the tile's cells (a, b): a's slots (the rows) and b's, both empty
    // where either allele has none
    bool any = false;
    for (int t = tid; t < kTile; t += kThreads) {
      int4 cr = make_int4(0, 0, 0, 0);
      if (q0 + t < ncell) {
        const int a = tri_row(q0 + t, A), b = a + (q0 + t - tri_start(a, A));
        cr = make_int4(x.ao[a], x.ao[a + 1], x.ao[b], x.ao[b + 1]);
        if (cr.x == cr.y || cr.z == cr.w) cr = make_int4(0, 0, 0, 0);
      }
      any |= cr.x < cr.y;
      x.cell[t] = cr;
    }
    if (!__syncthreads_or(any)) continue;
    // big cells a warp each, in turn over the warps in tile order
    for (int t0 = 0, rank = 0; t0 < kTile; t0 += 32) {
      unsigned big = __ballot_sync(kFull, big_cell(x.cell[t0 + lane], ngl));
      for (; big; big &= big - 1, ++rank)
        if (rank % kWarps == warp) {
          const int t = t0 + __ffs(big) - 1;
          warp_cell<NW>(x, ngl, x.cell[t], t, kTile, base);
        }
    }
    // the others (cell, group) to threads, groups of a cell on neighbouring
    // threads
    for (int u = tid; u < kTile * ngl; u += kThreads) {
      const int t = u / ngl, g = u - t * ngl;
      const int4 cr = x.cell[t];
      if (big_cell(cr, ngl)) continue;
      const float4 s = cr.x < cr.y ? cell_sum<NW>(x, ngl, cr, g, base)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      x.val[(4 * g) * kTile + t] = 2.f * s.x;
      x.val[(4 * g + 1) * kTile + t] = 2.f * s.y;
      x.val[(4 * g + 2) * kTile + t] = 2.f * s.z;
      x.val[(4 * g + 3) * kTile + t] = 2.f * s.w;
    }
    __syncthreads();
    // lane l takes the tile's cells q = l (mod 32) in increasing q
    for (int c = warp; c < C; c += kWarps) {
      Fin f = x.fin[c * 32 + lane];
      for (int t = lane; t < kTile && q0 + t < ncell; t += 32) {
        const float v = x.val[c * kTile + t];
        f.t = __fadd_rn(f.t, v);
        if (v > f.bv) { f.bv = v; f.bk = q0 + t; }
        if (q0 + t == true_cell) f.tq = v;
      }
      x.fin[c * 32 + lane] = f;
    }
    __syncthreads();  // before the next tile's cells replace these
  }
  for (int c = warp; c < C; c += kWarps) {
    const Fin f = x.fin[c * 32 + lane];
    float t = f.t, bv = f.bv;
    int bk = f.bk;
    const float tq = __shfl_sync(kFull, f.tq, true_cell & 31);
    combine_lanes(t, bv, bk);
    // no cell above 0: the total is 0 and the best guess counts nowhere
    if (lane == 0) write_result(p, k, n, c, t, bv < 0.f ? 0 : bk, tq);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, kShared ? 1 : 2)
    eval_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ pair_cells::Scratch<kThreads> sc;
  const Layout L(p.M, p.A, 4 * p.NG, p.plan);
  float* tab = reinterpret_cast<float*>(smem);
  float* pd = reinterpret_cast<float*>(smem + L.pd);
  int* ao = reinterpret_cast<int*>(smem + L.ao);

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const int A = p.A, C = p.C, N = p.N, Cp = 4 * p.NG;
  const int m = p.nok[k];
  const float4* fqk = p.fq + (size_t)k * p.H * p.NG * 2;

  uint4* rec;
  uint2* ext;
  Block x;
  x.tab = tab;
  x.pd = pd;
  x.ao = ao;
  x.m = m;
  x.ncell = A * (A + 1) / 2;
  if constexpr (kShared) {
    float4* fqs = reinterpret_cast<float4*>(smem + L.fq);
    x.contrib = reinterpret_cast<float*>(smem + L.contrib);
    x.grid = reinterpret_cast<float*>(smem + L.grid);
    x.fq = fqs;
    for (int u = tid; u < m * 2 * p.NG; u += kThreads) fqs[u] = fqk[u];
  } else {
    x.fq = fqk;
    x.cell = reinterpret_cast<int4*>(smem + L.cell);
    x.val = reinterpret_cast<float*>(smem + L.val);
    x.fin = reinterpret_cast<Fin*>(smem + L.fin);
    x.wbuf = reinterpret_cast<float*>(smem + L.wbuf);
  }
  if (p.plan == kPlanRecords) {  // 16-byte aligned: M is 4k
    rec = reinterpret_cast<uint4*>(
        p.gscratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x)
                         * (size_t)block_scratch(p.M));
    ext = reinterpret_cast<uint2*>(rec + p.M);
  } else {
    rec = reinterpret_cast<uint4*>(smem + L.rec);
    ext = reinterpret_cast<uint2*>(smem + L.ext);
  }
  x.rec = rec;
  x.ext = ext;

  for (int i = tid; i < kTab; i += kThreads)
    tab[i] = i < kPenLen ? p.pen_tab[i] : 0.f;
  const int n0 = blockIdx.x * p.S, n1 = min(N, n0 + p.S);
  for (int n = n0; n < n1; ++n) {
    __syncthreads();  // the loads, or the previous sample's finish, are done
    pair_cells::ballot_masks<kThreads>(p.geno + ((size_t)k * N + n) * kL,
                                       tid, sc);
    for (int c = tid; c < Cp; c += kThreads) {
      const int g = c < C ? p.gcand[((size_t)k * C + c) * N + n] : 3;
      // delta(g, s) for s = 0, 1, 2: g=0 -> s, g=1 -> |s-1|, g=2 -> 2-s,
      // NA -> 0
      const int d0 = g == 0 ? 0 : g == 1 ? 1 : g == 2 ? 2 : 0;
      const int d1 = g == 1 ? 0 : (g == 0 || g == 2) ? 1 : 0;
      const int d2 = g == 0 ? 2 : g == 1 ? 1 : 0;
      pd[c] = tab[d0];
      pd[Cp + c] = tab[d1];
      pd[2 * Cp + c] = tab[d2];
    }
    __syncthreads();
    // the record's frequency field is not read here
    pair_cells::pack_slots<kThreads>(
        p.hb + (size_t)k * p.H, reinterpret_cast<const float*>(fqk),
        p.al + (size_t)k * p.H, m, A, tid, sc, rec, ext, ao);
    __syncthreads();
    const int nw = pair_cells::het_words<kThreads>(sc);
    if constexpr (kShared) {
      switch (nw) {
        case 0: fold_sample<0>(p, x, sc); break;
        case 1: fold_sample<1>(p, x, sc); break;
        case 2: fold_sample<2>(p, x, sc); break;
        case 3: fold_sample<3>(p, x, sc); break;
        default: fold_sample<4>(p, x, sc); break;
      }
      finish_sample(p, x, k, n);
    } else {
      switch (nw) {
        case 0: tile_sample<0>(p, x, sc, k, n); break;
        case 1: tile_sample<1>(p, x, sc, k, n); break;
        case 2: tile_sample<2>(p, x, sc, k, n); break;
        case 3: tile_sample<3>(p, x, sc, k, n); break;
        default: tile_sample<4>(p, x, sc, k, n); break;
      }
    }
  }
}

// acc[k,c] = sum_n accp[k,c,n]; ll[k,c] = sum_n llp[k,c,n], in sample order
__global__ void eval_finish_kernel(const int* __restrict__ accp,
                                   const float* __restrict__ llp,
                                   int* __restrict__ acc, float* __restrict__ ll,
                                   int KC, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= KC) return;
  int a = 0;
  float l = 0.f;
  for (int n = 0; n < N; ++n) {
    a += accp[(size_t)i * N + n];
    l += llp[(size_t)i * N + n];
  }
  acc[i] = a;
  ll[i] = l;
}

template <bool kShared>
cudaError_t launch(const Args& p, dim3 grid, size_t smem, cudaStream_t st,
                   void* ev0) {
  cudaError_t err = cudaFuncSetAttribute(
      eval_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // the tiled path's blocks two to an SM: the most shared memory
  if (!kShared
      && (err = cudaFuncSetAttribute(
              eval_kernel<kShared>,
              cudaFuncAttributePreferredSharedMemoryCarveout,
              (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  if ((err = launch_mark(ev0, st)) != cudaSuccess) return err;
  eval_kernel<kShared><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory for M slots (a multiple of 4), A alleles
// and C candidates under `plan` (1, 0 or -1, see kPlanShared).
extern "C" long long hibag_eval_smem(int M, int A, int C, int plan) {
  return Layout(M, A, round4(C), plan).end;
}

// hb: int32 [K,H,4] ok slots first, sorted by allele; al: int32 [K,H] their
// alleles; nok: int32 [K] ok slots; fq: f32 [K,H,NG,2,4] (fA then fB of
// candidates 4g..4g+3, 0 past C); gcand: int8 [K,C,N]; geno: int8 [K,N,128];
// a1, a2: int32 [N] (a1 <= a2); oob: uint8 [K,N]; B: f32 [K,N]; pen_tab: f32
// [257]; accp: int32 [K,C,N], llp: f32 [K,C,N] scratch; gscratch: per block
// 4 * block_scratch(M) bytes under plan -1 (else null;
// ops/train_step.py::eval_scratch_bytes);
// acc: int32 [K,C]; ll: f32 [K,C]; ev0, ev1: launch marks or null. A block
// takes S samples of one classifier; M >= max nok, a multiple of 4.
extern "C" int hibag_eval_cand(const void* hb, const void* al, const void* nok,
                               const void* fq, const void* gcand,
                               const void* geno, const void* a1,
                               const void* a2, const void* oob, const void* B,
                               const void* pen_tab, void* accp, void* llp,
                               void* gscratch, void* acc, void* ll,
                               int K, int H, int N, int C, int A, int M, int S,
                               int plan, void* stream, void* ev0, void* ev1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M % 4 || S < 1 || H > 46340 || plan < kPlanRecords
      || plan > kPlanShared || (plan == kPlanRecords && !gscratch))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.hb = static_cast<const uint4*>(hb);
  p.al = static_cast<const int*>(al);
  p.nok = static_cast<const int*>(nok);
  p.fq = static_cast<const float4*>(fq);
  p.gcand = static_cast<const int8_t*>(gcand);
  p.geno = static_cast<const int8_t*>(geno);
  p.a1 = static_cast<const int*>(a1);
  p.a2 = static_cast<const int*>(a2);
  p.oob = static_cast<const uint8_t*>(oob);
  p.bw = static_cast<const float*>(B);
  p.pen_tab = static_cast<const float*>(pen_tab);
  p.accp = static_cast<int*>(accp);
  p.llp = static_cast<float*>(llp);
  p.gscratch = static_cast<float*>(gscratch);
  p.H = H;
  p.N = N;
  p.C = C;
  p.A = A;
  p.M = M;
  p.NG = (C + 3) / 4;
  p.S = S;
  p.plan = plan;
  const size_t smem = (size_t)hibag_eval_smem(M, A, C, plan);
  const dim3 grid((N + S - 1) / S, K);
  cudaError_t err = plan == kPlanShared
                        ? launch<true>(p, grid, smem, st, ev0)
                        : launch<false>(p, grid, smem, st, ev0);
  if (err != cudaSuccess) return (int)err;
  const int KC = K * C;
  eval_finish_kernel<<<(KC + 255) / 256, 256, 0, st>>>(
      static_cast<const int*>(accp), static_cast<const float*>(llp),
      static_cast<int*>(acc), static_cast<float*>(ll), KC, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_mark(ev1, st);
}
