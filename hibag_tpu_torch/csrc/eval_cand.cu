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
//    per column, read from shared memory), then folds the row:
//      T_ci = gA_ci rA_c + gB_ci rB_c,
//      gA = pd0 fA_i + pd1 fB_i,  gB = pd1 fA_i + pd2 fB_i.
//    S_c[a,b] = 2 * sum over i in a of T_ci (the cell holds S + S^T); on
//    the diagonal cell j runs over i <= j only, (i, i) at half weight, so
//    the doubled sum is the full square of a (ordered pairs).
//  * Phases by column allele b: the rows are the slots of alleles <= b
//    (slots are sorted by allele), dealt to threads as (row, group) with
//    consecutive threads on consecutive rows of one group, so a warp reads
//    the same column record and frequencies (broadcasts). Each row writes
//    its T to a [slot][candidate] scratch; after a sync one thread per
//    (cell (a, b), candidate) adds its rows in slot order.
//  * Records from pair_cells.cuh: the sample's masks by ballots, each slot's
//    heterozygous words only (pack_slots), the distance over NW of them
//    (het_popc<NW>, NW dispatched per sample). dmin exact by one distance
//    pass before the fold, so each penalty is the table's tab[D - dmin],
//    bitwise the plain version's.
//  * A block owns one classifier and a run of samples: the penalty table and
//    the candidates' frequencies ([slot][candidate]) are loaded once for the
//    run, with the row scratch and the cell grids beside them in shared
//    memory (plan 1). Where they do not fit, the frequencies are read from
//    device memory (L1) and the scratch and grids sit in a device scratch
//    (plan 0); where not even the slot records fit (24 bytes a slot, past
//    about 9,000 slots), the records go to the block's device scratch too
//    (plan -1). The three plans do the same arithmetic in the same order.
//  * Determinism: one writer per (sample, candidate, cell), in a fixed
//    order; no float atomics. A candidate's arithmetic is the same wherever
//    it sits in a group or a float4 (explicitly rounded products and sums),
//    so two identical candidates give bitwise-equal results. The
//    per-sample results go to [K, C, N] and a second kernel adds them in
//    sample order.
//  * Ties: the best guess is the smallest packed upper-triangle index among
//    equal maxima, which is the first row-major maximum of the full grid.
// Limits: H <= 46,340 haplotype slots (the slot-pair triangle is indexed in
// int32), C <= 64 candidates; A and H otherwise by the device scratch.

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

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Plans: where the frequencies, the row scratch, the cell grids and the slot
// records are (ops/train_step.py::eval_plan).
constexpr int kPlanShared = 1;    // all in shared memory
constexpr int kPlanDevice = 0;    // records in shared memory, the rest not
constexpr int kPlanRecords = -1;  // nothing but the table and pd in shared

// The dynamic shared memory's layout, in bytes from its start.
struct Layout {
  long long pd, ao, rec, ext, fq, contrib, grid, end;
  // Cp: the candidates padded to 4
  __host__ __device__ Layout(int M, int A, int Cp, int plan) {
    const bool shared = plan == kPlanShared;
    const long long ncell = (long long)A * (A + 1) / 2;
    pd = kTab * 4;                                // float [3][Cp]
    ao = pd + 3LL * Cp * 4;                       // int [A + 1]
    rec = ao + round4(A + 1) * 4LL;               // uint4 [M]
    ext = rec + (plan >= kPlanDevice ? 16LL * M : 0);  // uint2 [M]
    fq = ext + (plan >= kPlanDevice ? 8LL * M : 0);    // float4 [M][Cp/4][2]
    contrib = fq + (shared ? 8LL * M * Cp : 0);   // float [M][Cp]
    grid = contrib + (shared ? 4LL * M * Cp : 0); // float [Cp][ncell]
    end = grid + (shared ? 4LL * Cp * ncell : 0);
  }
};

// Floats of a block's device scratch in plans 0 and -1: the row scratch and
// the cell grids, then (plan -1) the slot records as uint4 [M] and uint2 [M].
__host__ __device__ inline long long block_scratch(int M, int A, int Cp,
                                                   int plan) {
  return (long long)Cp * M + (long long)Cp * A * (A + 1) / 2
       + (plan == kPlanRecords ? 6LL * M : 0);
}

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
  float* gscratch;       // per block block_scratch(...) floats, or null
  int H, N, C, A, M, NG, S, plan;  // NG = Cp / 4 groups of 4 candidates
};

// Where a block's frequencies and scratch are.
struct Block {
  const float* tab;
  const float* pd;       // [3][Cp]
  const int* ao;
  const uint4* rec;
  const uint2* ext;
  const float4* fq;      // column j, group g: fq[2 (j * NG + g)], fA then fB
  float* contrib;
  float* grid;
  int m, ncell;
};

// Cell grids of one sample, after its masks, records and penalties are in
// shared memory.
template <int NW>
__device__ __forceinline__ void fold_sample(const Args& p, const Block& x,
                                            pair_cells::Scratch<kThreads>& sc) {
  const int tid = threadIdx.x;
  const int m = x.m, A = p.A, ngl = p.NG, Cp = 4 * p.NG;
  const uint4* rec = x.rec;
  const uint2* ext = x.ext;
  const float* tab = x.tab;

  // dmin over the upper triangle of ok pairs, in equal contiguous runs; D
  // less the sample's heterozygous count (which dmin's shift cancels)
  int dm = INT_MAX;
  {
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
  }
  dm = pair_cells::group_min<kThreads>(dm, tid, sc);
  const int base = -dm;  // D - dmin = a_i + a_j - popc + base

  for (int b = 0; b < A; ++b) {
    const int jb = x.ao[b], je = x.ao[b + 1];
    if (jb < je) {
      const int rows = je;  // the slots of alleles <= b
      for (int u = tid; u < rows * ngl; u += kThreads) {
        const int g = u / rows, i = u - g * rows;
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
          const float pen =
              tab[bi + (int)rj.z - het_popc<NW>(ri, ei, rj, ej)];
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
        *reinterpret_cast<float4*>(x.contrib + (size_t)i * Cp + 4 * g) =
            make_float4(t[0], t[1], t[2], t[3]);
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

// per candidate: total, first maximum, true pair, Compare, -2 B log post
__device__ __forceinline__ void finish_sample(const Args& p, const Block& x,
                                              int k, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int A = p.A, ncell = x.ncell;
  const int a1 = p.a1[n], a2 = p.a2[n];
  const bool is_oob = p.oob[(size_t)k * p.N + n] != 0;
  const float bw = p.bw[(size_t)k * p.N + n];
  const int true_cell = tri_start(a1, A) + (a2 - a1);
  for (int c = warp; c < p.C; c += kWarps) {
    const float* gq = x.grid + (size_t)c * ncell;
    float t = 0.f, bv = -1.f;
    int bk = INT_MAX;
    for (int q = lane; q < ncell; q += 32) {
      const float v = gq[q];
      t = __fadd_rn(t, v);
      if (v > bv) { bv = v; bk = q; }
    }
    for (int off = 16; off; off >>= 1) {
      t = __fadd_rn(t, __shfl_xor_sync(kFull, t, off));
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int ok = __shfl_xor_sync(kFull, bk, off);
      if (ov > bv || (ov == bv && ok < bk)) { bv = ov; bk = ok; }
    }
    if (lane == 0) {
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
      const float tq = gq[true_cell] >= FLT_MIN ? gq[true_cell] : 0.f;
      const float post = tq / fmaxf(total, 1e-37f);
      const size_t o = ((size_t)k * p.C + c) * p.N + n;
      p.accp[o] = (is_oob && total > 0.f) ? cnt : 0;
      p.llp[o] = -2.f * bw * logf(fmaxf(post, 1e-37f));
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) eval_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ pair_cells::Scratch<kThreads> sc;
  const Layout L(p.M, p.A, 4 * p.NG, p.plan);
  float* tab = reinterpret_cast<float*>(smem);
  float* pd = reinterpret_cast<float*>(smem + L.pd);
  int* ao = reinterpret_cast<int*>(smem + L.ao);
  float4* fqs = reinterpret_cast<float4*>(smem + L.fq);

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const int A = p.A, C = p.C, N = p.N, Cp = 4 * p.NG;
  const int ncell = A * (A + 1) / 2;
  const int m = p.nok[k];
  const float4* fqk = p.fq + (size_t)k * p.H * p.NG * 2;

  uint4* rec;
  uint2* ext;
  Block x;
  x.tab = tab;
  x.pd = pd;
  x.ao = ao;
  x.m = m;
  x.ncell = ncell;
  if (kShared) {
    x.contrib = reinterpret_cast<float*>(smem + L.contrib);
    x.grid = reinterpret_cast<float*>(smem + L.grid);
    x.fq = fqs;
    for (int u = tid; u < m * 2 * p.NG; u += kThreads) fqs[u] = fqk[u];
  } else {
    x.contrib = p.gscratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x)
                                 * (size_t)block_scratch(p.M, A, Cp, p.plan);
    x.grid = x.contrib + (size_t)p.M * Cp;
    x.fq = fqk;
  }
  if (p.plan == kPlanRecords) {  // 16-byte aligned: Cp and M are 4k
    rec = reinterpret_cast<uint4*>(x.grid + (size_t)Cp * ncell);
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
    switch (pair_cells::het_words<kThreads>(sc)) {
      case 0: fold_sample<0>(p, x, sc); break;
      case 1: fold_sample<1>(p, x, sc); break;
      case 2: fold_sample<2>(p, x, sc); break;
      case 3: fold_sample<3>(p, x, sc); break;
      default: fold_sample<4>(p, x, sc); break;
    }
    finish_sample(p, x, k, n);
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
// a1, a2: int32 [N]; oob: uint8 [K,N]; B: f32 [K,N]; pen_tab: f32 [257];
// accp: int32 [K,C,N], llp: f32 [K,C,N] scratch; gscratch: per block
// 4 * block_scratch(M, A, Cp, plan) bytes under plans 0 and -1 (else null;
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
      || plan > kPlanShared || (plan != kPlanShared && !gscratch))
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
