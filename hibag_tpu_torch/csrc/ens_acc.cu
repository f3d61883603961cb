// Accumulating ensemble posterior kernel for NVIDIA Hopper (sm_90a).
//
// Replaces hibag_tpu/ops/scoring_pallas.py::_kernel_ens_acc (entry
// ensemble_accumulate_pallas). For every sample n and every classifier c it
// computes the distance D_ij of each pair of valid haplotypes to the
// sample's genotypes, dmin = min D, pen_ij = 1e-5^(D_ij - dmin), the
// unordered allele-pair scores Q[a,b] = sum over haplotype pairs with
// alleles {a,b} of f_i f_j pen_ij (both orders), total = sum Q, and adds
// w * Q / max(total, 1e-30) into ens[n] -- or, under majority voting, one
// vote [w > 0] for the first row-major maximum of Q. dmin and total are
// written per (c, n).
//
// What bounds it on the H100: integer ALU and popcount work over the
// C * N * m(m+1)/2 haplotype pairs (m = valid haplotypes of a classifier),
// one popcount per pair and 32-SNP word in which the sample has a
// heterozygous code, plus a table read and an fma. Device-memory traffic is
// small: per (c, n) 128 bytes of genotype codes plus the classifier's m * 28
// bytes, which every block of the same classifier reads from L2. In
// practice the bound is far away: a classifier's work for one sample is
// small, so the time goes to the latency of each sample's chain of
// dependent steps, and the design is about how many independent chains the
// SMs hold and how short each is.
//
// Two kernels, both deterministic (one writer per sum, fixed orders, no
// float atomics: two runs are bitwise equal), both summing the ensemble in
// classifier order as the TPU's sequential grid does, and both taking their
// distances from pair_cells.cuh (popcounts only over the words with a
// heterozygous code):
//  * ens_acc_pairs_kernel, for classifiers whose row-by-allele table fits
//    in shared memory (pairs_smem <= kPairsMaxSmem: the published models'
//    widths). Their cells hold about three pairs each, so it walks pairs,
//    not cells: one block per sample, equal runs of the row-major pairs per
//    thread, a pass for dmin and a pass writing each (row, allele) segment's
//    sum, then a thread per cell folds its rows (see below).
//  * ens_acc_kernel, for larger classifiers: one warp per sample walking
//    the cells of pair_cells.cuh (a thread per small cell, a warp per large
//    one, each summed against its own running minimum), twice: once for
//    dmin, total and the best cell, once adding the cells' Q into the
//    sample's ensemble row, which lives in the output (device memory) so
//    that a sample needs little shared memory.
// Limits: H <= 1024 stored haplotype slots and A <= 128 alleles.

#include "launch_marks.cuh"
#include "pair_cells.cuh"

namespace {

using namespace pair_cells;

// ens_acc_kernel: a warp per sample, up to 4 a block as shared memory allows
constexpr int kG = 32;
constexpr int kMaxThreads = 128;
constexpr int kMaxGroups = kMaxThreads / kG;
// a thread cell's tile, rows by columns
constexpr int kRowsEns = 2, kColsEns = 4;

// Walk one: each cell's Q = X * 1e-5^(dc - dmin) (doubled off the
// diagonal) is not kept; the thread keeps its running total of Q and its
// first maximum of Q, both relative to a running minimum.
struct TotalSink {
  const float* tab;
  int A;
  int td = kNone;      // total: sum of Q relative to td
  float tt = 0.f;
  int bd = kNone;      // best: Q = bx relative to bd, at cell bk = a A + b
  float bx = -1.f;
  int bk = INT_MAX;
  __device__ void operator()(int a, int b, int, int dc, float x) {
    const float q = a != b ? 2.f * x : x;
    combine(tab, td, tt, dc, q);
    take_best(dc, q, a * A + b);
  }
  // whether Q = q relative to dc at cell k beats the best so far: larger,
  // or as large at a smaller (earlier row-major) k
  __device__ void take_best(int dc, float q, int k) {
    const int d = min(dc, bd);
    const float v = q * tab[dc - d], w = bx < 0.f ? -1.f : bx * tab[bd - d];
    if (v > w || (v == w && k < bk)) {
      bd = dc;
      bx = q;
      bk = k;
    }
  }
};

// Walk two (probability voting): the same cells again, each adding
// scale * Q into the sample's ensemble row (device memory, row-major A x A,
// upper triangle; one writer per cell).
struct EnsSink {
  const float* tab;
  float* row;
  int A, dmin;
  float scale;
  __device__ void operator()(int a, int b, int, int dc, float x) const {
    const float q = x * tab[dc - dmin];
    row[a * A + b] += (a != b ? 2.f * q : q) * scale;
  }
};

// The warp's total (combined in a fixed order) and best, from each lane's
// TotalSink, returned to every lane.
__device__ __forceinline__ void warp_total_best(TotalSink& k_) {
  for (int off = 16; off; off >>= 1) {
    const int od = __shfl_xor_sync(kFull, k_.td, off);
    const float ot = __shfl_xor_sync(kFull, k_.tt, off);
    combine(k_.tab, k_.td, k_.tt, od, ot);
    const int bd = __shfl_xor_sync(kFull, k_.bd, off);
    const float bx = __shfl_xor_sync(kFull, k_.bx, off);
    const int bk = __shfl_xor_sync(kFull, k_.bk, off);
    if (bx >= 0.f) k_.take_best(bd, bx, bk);
  }
}

// A sample's share of dynamic shared memory, 16-byte aligned.
__host__ __device__ inline size_t sample_bytes(int H, int A) {
  const size_t b = (size_t)H * (sizeof(uint4) + sizeof(uint2))
                 + (size_t)(A + 1) * sizeof(int)        // ao
                 + (size_t)(A + 1) * sizeof(int)        // ps
                 + (size_t)A * sizeof(short);           // pa
  return (b + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kMaxThreads)
ens_acc_kernel(const uint4* __restrict__ hb, const float* __restrict__ freq,
               const int* __restrict__ allele, const int* __restrict__ nh,
               const int8_t* __restrict__ g, const float* __restrict__ wgt,
               const float* __restrict__ pen_tab, float* __restrict__ ens,
               float* __restrict__ dmin_out, float* __restrict__ total_out,
               int C, int H, int N, int A, int majority) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch<kG> scr[kMaxGroups];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  float* tab = reinterpret_cast<float*>(smem);          // [kTabLen], shared
  load_table(pen_tab, tab, threadIdx.x, blockDim.x);
  __syncthreads();  // the last block-wide sync: warps go their own way

  const int n = blockIdx.x * (blockDim.x / kG) + grp;
  if (n >= N) return;
  unsigned char* mine = smem + kTabLen * sizeof(float)
                      + (size_t)grp * sample_bytes(H, A);
  uint4* rec = reinterpret_cast<uint4*>(mine);          // [H] slot records
  uint2* ext = reinterpret_cast<uint2*>(rec + H);       // [H]
  int* ao = reinterpret_cast<int*>(ext + H);            // [A + 1]
  int* ps = ao + A + 1;                                 // [A + 1]
  short* pa = reinterpret_cast<short*>(ps + A + 1);     // [A]
  Scratch<kG>& sc = scr[grp];
  // the ensemble row, accumulated in its upper triangle in place
  float* row = ens + (size_t)n * A * A;

  for (int k = lane; k < A * A; k += kG) row[k] = 0.f;
  for (int c = 0; c < C; ++c) {
    const int m = min(max(nh[c], 0), H);
    const float w = wgt[(size_t)c * N + n];
    __syncwarp();  // the previous classifier is done with shared memory
    ballot_masks<kG>(g + ((size_t)c * N + n) * kL, lane, sc);
    __syncwarp();
    pack_slots<kG>(hb + (size_t)c * H, freq + (size_t)c * H,
                   allele + (size_t)c * H, m, A, lane, sc, rec, ext, ao);
    __syncwarp();
    // only the alleles with slots: the cells of the others hold no pairs
    const int np = present_alleles(ao, A, m, pa, ps, lane);
    __syncwarp();
    const Cells cx{rec, ext, tab, ao, pa, ps, np, A, het_codes(sc)};
    const int nw = het_words(sc);
    TotalSink tot{tab, A};
    const int dmin = walk_cells<kG, kRowsEns, kColsEns>(cx, nw, lane, sc, tot);
    // total = sum Q relative to dmin; best = first row-major maximum of Q
    warp_total_best(tot);
    if (lane == 0) {
      dmin_out[(size_t)c * N + n] = (float)dmin;
      total_out[(size_t)c * N + n] = tot.tt;
    }
    if (majority) {
      if (lane == 0 && w > 0.f) row[tot.bk] += 1.f;
    } else {
      EnsSink ensk{tab, row, A, dmin, w / fmaxf(tot.tt, 1e-30f)};
      walk_cells<kG, kRowsEns, kColsEns>(cx, nw, lane, sc, ensk);
    }
  }
  __syncwarp();

  // the lower triangle mirrors the upper
  for (int idx = lane; idx < A * A; idx += kG) {
    const int a = idx / A, b = idx - a * A;
    if (a > b) row[idx] = row[b * A + a];
  }
}

// ---------------------------------------------------------------------------
// The pair-run kernel, for classifiers small enough that a row-by-allele
// table of segment sums fits in shared memory (the published models' widths:
// tens to about a hundred haplotypes over tens of alleles, most alleles with
// one or two). There the cells hold about three pairs each, so any per-cell
// walk spends its time on cell overhead; this kernel walks pairs.
//
// One block of kPT threads owns one sample and loops over the classifiers.
// A classifier's unordered pairs (i <= j), in row-major order, are cut into
// equal contiguous runs, one per thread. Pass one: each thread's minimum D
// over its run; the block's minimum is dmin. Pass two: row i's pairs whose
// column j has allele b form the segment (i, b); each segment belongs to
// the thread whose run holds its first pair, which writes
//   U[i][b] = sum over j in the segment of f_j 1e-5^(D_ij - dmin)
// (j == i at half weight) to shared memory. Then a thread per cell (a, b)
// folds Q(a,b) = 2 sum over i in a of f_i U[i][b] in slot order. A segment
// and a cell are each summed by one thread in a fixed order, wherever they
// sit: two runs are bitwise equal and two cells of the same content tie
// exactly. Two passes, not one: the second recomputes the distances (one
// or two popcounts a pair here), and was measured faster than one pass
// keeping each segment's running minimum (PERF.md), whose extra
// table of minima costs a resident block per SM.
constexpr int kPT = 256;
constexpr int kPW = kPT / 32;
// shared memory above which the pair-run kernel is not used
constexpr size_t kPairsMaxSmem = 96 * 1024;

__host__ __device__ inline size_t pairs_smem(int H, int A) {
  const size_t ntri = (size_t)A * (A + 1) / 2;
  return kTabLen * sizeof(float) + (size_t)H * (sizeof(uint4) + sizeof(uint2))
       + (size_t)H * A * sizeof(float) + 2 * ntri * sizeof(float)
       + (size_t)(A + 1) * sizeof(int) + ntri * sizeof(unsigned)
       + (size_t)H * (sizeof(unsigned) + sizeof(unsigned short)) + 16;
}

// The row i and column j of pair p of the row-major upper triangle of m
// slots.
__device__ __forceinline__ void pair_at(int p, int m, int& i, int& j) {
  i = tri_row(p, m);
  j = i + (p - tri_start(i, m));
}

template <int NW>
__device__ __forceinline__ int run_min(const uint4* rec, const uint2* ext,
                                       int nhet, int m, int p0, int p1) {
  int dm = kNone;
  if (p0 >= p1) return dm;
  int i, j;
  pair_at(p0, m, i, j);
  uint4 ri = rec[i];
  uint2 ei = NW > 2 ? ext[i] : make_uint2(0u, 0u);
  int bi = (int)ri.z + nhet;
  for (int p = p0; p < p1; ++p) {
    const uint4 rj = rec[j];
    const uint2 ej = NW > 2 ? ext[j] : make_uint2(0u, 0u);
    dm = min(dm, bi + (int)rj.z - het_popc<NW>(ri, ei, rj, ej));
    if (++j == m) {
      j = ++i;
      if (i < m) {
        ri = rec[i];
        ei = NW > 2 ? ext[i] : make_uint2(0u, 0u);
        bi = (int)ri.z + nhet;
      }
    }
  }
  return dm;
}

// U[i A + b] for the segments (i, b) whose first pair lies in [p0, p1),
// in one flat loop over their pairs (a segment end is a short branch), so
// that the lanes of a warp stay in step whatever the segments' lengths.
// sae[j] = allele of slot j << 16 | the end of that allele's slots.
template <int NW>
__device__ __forceinline__ void run_sums(const uint4* rec, const uint2* ext,
                                         const float* tab,
                                         const unsigned* sae, int nhet,
                                         int m, int A, int dmin, int p0,
                                         int p1, float* U) {
  if (p0 >= p1) return;
  int i, j;
  pair_at(p0, m, i, j);
  unsigned se = sae[j];
  int p = p0;
  if (j > i && (sae[j - 1] >> 16) == (se >> 16)) {
    // p0 is inside a segment begun before the run: skip to the next
    const int e = (int)(se & 0xffffu);
    p += e - j;
    j = e;
    if (j == m) j = ++i;
    if (p >= p1) return;
    se = sae[j];
  }
  int b = (int)(se >> 16), e = (int)(se & 0xffffu);
  uint4 ri = rec[i];
  uint2 ei = NW > 2 ? ext[i] : make_uint2(0u, 0u);
  int bi = (int)ri.z + nhet;
  float sum = 0.f;
  for (;;) {
    const uint4 rj = rec[j];
    const uint2 ej = NW > 2 ? ext[j] : make_uint2(0u, 0u);
    const int d = bi + (int)rj.z - het_popc<NW>(ri, ei, rj, ej);
    const float v = __uint_as_float(rj.w) * tab[d - dmin];
    sum += j == i ? 0.5f * v : v;
    ++p;
    if (++j == e) {
      U[(size_t)i * A + b] = sum;
      sum = 0.f;
      if (p >= p1) break;
      if (j == m) {
        j = ++i;
        ri = rec[i];
        ei = NW > 2 ? ext[i] : make_uint2(0u, 0u);
        bi = (int)ri.z + nhet;
      }
      se = sae[j];
      b = (int)(se >> 16);
      e = (int)(se & 0xffffu);
    }
  }
}

__global__ void __launch_bounds__(kPT)
ens_acc_pairs_kernel(const uint4* __restrict__ hb,
                     const float* __restrict__ freq,
                     const int* __restrict__ allele,
                     const int* __restrict__ nh, const int8_t* __restrict__ g,
                     const float* __restrict__ wgt,
                     const float* __restrict__ pen_tab,
                     float* __restrict__ ens, float* __restrict__ dmin_out,
                     float* __restrict__ total_out, int C, int H, int N,
                     int A, int majority) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch<kPT> sc;
  __shared__ int s_best;
  __shared__ float s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x;
  const int ntri = A * (A + 1) / 2;
  float* tab = reinterpret_cast<float*>(smem);          // [kTabLen]
  uint4* rec = reinterpret_cast<uint4*>(tab + kTabLen); // [H]
  uint2* ext = reinterpret_cast<uint2*>(rec + H);       // [H]
  float* U = reinterpret_cast<float*>(ext + H);         // [H][A]
  float* su = U + (size_t)H * A;                        // [ntri] Q of c
  float* es = su + ntri;                                // [ntri] ensemble row
  int* ao = reinterpret_cast<int*>(es + ntri);          // [A + 1]
  unsigned* cab = reinterpret_cast<unsigned*>(ao + A + 1);  // [ntri] cells
  unsigned* sae = cab + ntri;                           // [H] segment ends
  unsigned short* al =
      reinterpret_cast<unsigned short*>(sae + H);       // [H] slot alleles

  load_table(pen_tab, tab, tid, kPT);
  for (int k = tid; k < ntri; k += kPT) es[k] = 0.f;
  // cell k's alleles (a << 16 | b), for the sweeps over the cells
  if (tid < ntri) {
    int a = tri_row(tid, A), b = a + (tid - tri_start(a, A));
    for (int k = tid; a < A; k += kPT, tri_advance(a, b, kPT, A))
      cab[k] = (unsigned)a << 16 | (unsigned)b;
  }
  for (int c = 0; c < C; ++c) {
    const int m = min(max(nh[c], 0), H);
    const float w = wgt[(size_t)c * N + n];
    __syncthreads();  // the previous classifier is done with shared memory
    ballot_masks<kPT>(g + ((size_t)c * N + n) * kL, tid, sc);
    __syncthreads();
    pack_slots<kPT>(hb + (size_t)c * H, freq + (size_t)c * H,
                    allele + (size_t)c * H, m, A, tid, sc, rec, ext, ao, al);
    __syncthreads();
    const int nw = het_words(sc), nhet = het_codes(sc);
    for (int j = tid; j < m; j += kPT)  // read in pass two, after a sync
      sae[j] = (unsigned)al[j] << 16 | (unsigned)ao[al[j] + 1];
    const int P = m * (m + 1) / 2, per = (P + kPT - 1) / kPT;
    const int p0 = min(tid * per, P), p1 = min(p0 + per, P);
    int mind;
    switch (nw) {
      case 0: mind = run_min<0>(rec, ext, nhet, m, p0, p1); break;
      case 1: mind = run_min<1>(rec, ext, nhet, m, p0, p1); break;
      case 2: mind = run_min<2>(rec, ext, nhet, m, p0, p1); break;
      case 3: mind = run_min<3>(rec, ext, nhet, m, p0, p1); break;
      default: mind = run_min<4>(rec, ext, nhet, m, p0, p1);
    }
    const int dmin = group_min<kPT>(mind, tid, sc);
    switch (nw) {
      case 0: run_sums<0>(rec, ext, tab, sae, nhet, m, A, dmin, p0, p1, U); break;
      case 1: run_sums<1>(rec, ext, tab, sae, nhet, m, A, dmin, p0, p1, U); break;
      case 2: run_sums<2>(rec, ext, tab, sae, nhet, m, A, dmin, p0, p1, U); break;
      case 3: run_sums<3>(rec, ext, tab, sae, nhet, m, A, dmin, p0, p1, U); break;
      default: run_sums<4>(rec, ext, tab, sae, nhet, m, A, dmin, p0, p1, U);
    }
    __syncthreads();

    // Q of the cells with pairs (the others are 0 and add nothing); total
    // = sum Q; best = first row-major maximum of Q
    float t = 0.f, bv = -1.f;
    int bk = INT_MAX;
    for (int k = tid; k < ntri; k += kPT) {
      const int a = (int)(cab[k] >> 16), b = (int)(cab[k] & 0xffffu);
      float q = 0.f;
      if (ao[b + 1] > ao[b]) {
        float x = 0.f;
        for (int i = ao[a]; i < ao[a + 1]; ++i)
          x += __uint_as_float(rec[i].w) * U[(size_t)i * A + b];
        q = 2.f * x;
      }
      su[k] = q;
      t += q;
      if (q > bv) { bv = q; bk = k; }
    }
    for (int off = 16; off; off >>= 1) {
      t += __shfl_xor_sync(kFull, t, off);
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int ok = __shfl_xor_sync(kFull, bk, off);
      if (ov > bv || (ov == bv && ok < bk)) { bv = ov; bk = ok; }
    }
    if (lane == 0) { sc.red_f[warp] = t; sc.red_v[warp] = bv; sc.red_k[warp] = bk; }
    __syncthreads();
    if (tid == 0) {
      float tt = sc.red_f[0], vv = sc.red_v[0];
      int kk = sc.red_k[0];
      for (int i = 1; i < kPW; ++i) {
        tt += sc.red_f[i];
        if (sc.red_v[i] > vv || (sc.red_v[i] == vv && sc.red_k[i] < kk)) {
          vv = sc.red_v[i];
          kk = sc.red_k[i];
        }
      }
      s_total = tt;
      s_best = kk;
      dmin_out[(size_t)c * N + n] = (float)dmin;
      total_out[(size_t)c * N + n] = tt;
    }
    __syncthreads();
    if (majority) {
      if (tid == 0 && w > 0.f) es[s_best] += 1.f;
    } else {
      const float scale = w / fmaxf(s_total, 1e-30f);
      for (int k = tid; k < ntri; k += kPT) es[k] += su[k] * scale;
    }
  }
  __syncthreads();

  // write the symmetric full A x A row
  float* out = ens + (size_t)n * A * A;
  for (int idx = tid; idx < A * A; idx += kPT) {
    const int a = idx / A, b = idx - a * A;
    out[idx] = es[a <= b ? tri_start(a, A) + (b - a) : tri_start(b, A) + (a - b)];
  }
}

}  // namespace

extern "C" int hibag_ens_acc(const void* hb, const void* freq,
                             const void* allele, const void* nh, const void* g,
                             const void* wgt, const void* pen_tab, void* ens,
                             void* dmin, void* total, int C, int H, int N,
                             int A, int majority, void* stream, void* ev0,
                             void* ev1) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const size_t psmem = pairs_smem(H, A);
  if (psmem <= kPairsMaxSmem) {
    err = cudaFuncSetAttribute(ens_acc_pairs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)psmem);
    if (err != cudaSuccess) return (int)err;
    if ((err = launch_mark(ev0, st)) != cudaSuccess) return (int)err;
    ens_acc_pairs_kernel<<<N, kPT, psmem, st>>>(
        static_cast<const uint4*>(hb), static_cast<const float*>(freq),
        static_cast<const int*>(allele), static_cast<const int*>(nh),
        static_cast<const int8_t*>(g), static_cast<const float*>(wgt),
        static_cast<const float*>(pen_tab), static_cast<float*>(ens),
        static_cast<float*>(dmin), static_cast<float*>(total), C, H, N, A,
        majority);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return (int)launch_mark(ev1, st);
  }
  // as many samples a block as fit in the opt-in shared memory (227 KiB)
  const size_t per = sample_bytes(H, A), fixed = kTabLen * sizeof(float);
  int groups = kMaxGroups;
  while (groups > 1 && fixed + groups * per > 232448) --groups;
  const size_t smem = fixed + groups * per;
  err = cudaFuncSetAttribute(
      ens_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_mark(ev0, st)) != cudaSuccess) return (int)err;
  ens_acc_kernel<<<(N + groups - 1) / groups, kG * groups, smem, st>>>(
      static_cast<const uint4*>(hb), static_cast<const float*>(freq),
      static_cast<const int*>(allele), static_cast<const int*>(nh),
      static_cast<const int8_t*>(g), static_cast<const float*>(wgt),
      static_cast<const float*>(pen_tab), static_cast<float*>(ens),
      static_cast<float*>(dmin), static_cast<float*>(total), C, H, N, A,
      majority);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_mark(ev1, st);
}

extern "C" const char* hibag_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
