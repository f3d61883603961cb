// Per-classifier posterior scores for NVIDIA Hopper (sm_90a).
//
// Replaces hibag_tpu/ops/scoring_pallas.py::_kernel (entry
// posterior_scores_pallas, one classifier per launch) and ::_kernel_ens
// (entry ensemble_scores_pallas, C classifiers per launch): both compute the
// same function, so one kernel serves them. For classifier c and sample n it
// computes the distance D_ij of every pair of valid haplotypes to the
// sample's genotypes, dmin = min D, pen_ij = 1e-5^(D_ij - dmin), and
//   S[a,b] = sum over ORDERED pairs (i, j), allele_i = a, allele_j = b, of
//            f_i f_j pen_ij                       (= W^T pen W, symmetric)
//   total  = sum of S over the full A x A matrix
// and, in its two modes:
//  * S mode (post_scores_kernel): writes S [C,N,A,A], dmin [C,N]
//    (integer-valued) and total [C,N]; nothing is accumulated across
//    classifiers.
//  * fold mode (post_scores_fold_kernel), the scan prediction engine's
//    probability vote: writes dmin and total and adds
//      sum over c of (w[c,n] / total[c,n]) * Q_c[n]
//    into ens [N,A,A], Q_c the unordered convention of S (off-diagonal
//    cells doubled, the diagonal kept). S never reaches device memory.
//
// What bounds it on the H100: popcount issue, one popcount per unordered
// pair and 32-SNP word in which the sample has a heterozygous code, over the
// C * N * m(m+1)/2 pairs (m = valid haplotypes of a classifier; 16 popc per
// clock per SM), with a table read and an fma per pair beside it. In S mode
// device-memory traffic adds the S output, C * N * A^2 * 4 bytes, written
// twice (the sweep writes each cell and its mirror, one uncoalesced store a
// cell); the fold mode moves ens [N,A,A] once a launch instead.
//
// What the design does about it (the distance, the one-pass cell sums and
// the work split are pair_cells.cuh's, shared by both modes):
//  * One distance pass. Each allele cell (a <= b) is summed against its own
//    running minimum dc and kept with dc beside it. Once the block's dmin =
//    min dc is known, a sweep scales each cell by 1e-5^(dc - dmin) and sums
//    total. S mode keeps the cells in S itself (dc in shared memory for
//    A <= kDcSharedMaxA, else in a device scratch the wrapper allocates)
//    and its sweep writes S[a,b] and S[b,a], so S is exactly symmetric.
//  * The fold mode: one block takes one sample and loops over the launch's
//    classifiers in index order. Its shared memory holds only what the
//    walk reads (the slot records, the table, the allele starts); each
//    cell's value, dc and running sum sit in a device scratch of the
//    block's own (10 bytes a cell). So it fits wherever the S mode does,
//    and four blocks (at 64 registers) share an SM at the wide locus.
//    After a classifier's sweep a second sweep adds its weighted unordered
//    cells into the sample's running sum, one writer a cell; the sum is
//    added into ens[n] row by row, coalesced. The first sweep and the total
//    are the S mode's, so dmin and total are bitwise its own.
//  * Popcounts only over the words with a heterozygous code (nothing else
//    of a pair's distance varies with the pair).
//  * A small cell belongs to one thread, a large one to a warp; each cell
//    has one writer and sums its pairs in a fixed order, and total is
//    reduced per thread, warp and block in a fixed order; the fold sums the
//    classifiers in index order. No float atomics: two runs are bitwise
//    equal.
//  * The slot records (24 bytes a slot) sit in shared memory where they fit
//    (S mode: to about 9,000 slots; fold mode: while four blocks still fit
//    an SM, to about 2,200 slots at 160 alleles); else in a device scratch
//    of the block's own, and a block then takes samples n, n + gridDim.x,
//    ... so that the scratch is sized by the blocks, not the samples
//    (ops/post_scores.py::scores_plan, fold_plan). Both routes do the same
//    arithmetic in the same order.
// Limits: H <= 46,340 stored haplotype slots (a cell's pair count is an
// int32), A <= 1024 alleles.

#include "launch_marks.cuh"
#include "pair_cells.cuh"

namespace {

using namespace pair_cells;

// the cells' dc sit in shared memory up to this many alleles (32 KiB)
constexpr int kDcSharedMaxA = 180;
// a thread cell's tile, rows by columns: the wide models' alleles hold up
// to about 20 haplotypes a classifier
constexpr int kRowsScan = 4, kColsScan = 4;

// cell (a, b)'s pass-one result: X(a,b) relative to dc in S[a,b], dc aside
struct OutSink {
  float* out;
  unsigned short* dcs;
  int A;
  __device__ void operator()(int a, int b, int k, int dc, float s) const {
    out[(size_t)a * A + b] = s;
    dcs[k] = (unsigned short)dc;
  }
};

constexpr int kThreads = 256;  // one block of threads per (classifier, sample)
constexpr int kWarps = kThreads / 32;

// kDeviceRecords: the slot records in the block's device scratch, and the
// block takes samples n, n + gridDim.x, ...; else in shared memory, one
// sample a block (the same body, with no loop).
template <bool kDeviceRecords>
__global__ void __launch_bounds__(kThreads)
post_scores_kernel(const uint4* __restrict__ hb, const float* __restrict__ freq,
                   const int* __restrict__ allele, const int* __restrict__ nh,
                   const int8_t* __restrict__ g,
                   const float* __restrict__ pen_tab, float* S,
                   float* __restrict__ dmin_out, float* __restrict__ total_out,
                   unsigned short* dc_scratch, uint4* rec_scratch, int H,
                   int N, int A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = kDeviceRecords ? 0 : H;                // records here
  uint4* rec = reinterpret_cast<uint4*>(smem);          // [hs] slot records
  uint2* ext = reinterpret_cast<uint2*>(rec + hs);      // [hs]
  float* tab = reinterpret_cast<float*>(ext + hs);      // [kTabLen]
  int* ao = reinterpret_cast<int*>(tab + kTabLen);      // [A + 1]

  __shared__ Scratch<kThreads> sc;

  const int c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = min(max(nh[c], 0), H);
  const size_t hoff = (size_t)c * H;
  const int ntri = A * (A + 1) / 2;
  if (kDeviceRecords) {
    // uint4 [H], then uint2 [H] padded to whole uint4s
    rec = rec_scratch
        + ((size_t)c * gridDim.x + blockIdx.x) * (size_t)(H + (H + 1) / 2);
    ext = reinterpret_cast<uint2*>(rec + H);
  }
  load_table(pen_tab, tab, tid, kThreads);

  auto one_sample = [&](int n) {
    unsigned short* dcs =
        A <= kDcSharedMaxA ? reinterpret_cast<unsigned short*>(ao + A + 1)
                           : dc_scratch + ((size_t)c * N + n) * ntri;
    ballot_masks<kThreads>(g + ((size_t)c * N + n) * kL, tid, sc);
    __syncthreads();
    pack_slots<kThreads>(hb + hoff, freq + hoff, allele + hoff, m, A, tid, sc,
                         rec, ext, ao);
    __syncthreads();

    float* out = S + ((size_t)c * N + n) * A * A;
    const Cells cx{rec, ext, tab, ao, nullptr, ao, A, A, het_codes(sc)};
    OutSink sink{out, dcs, A};
    // walk_cells ends in a block sync: every cell's S[a,b] and dc are
    // visible after it
    const int dmin = walk_cells<kThreads, kRowsScan, kColsScan>(
        cx, het_words(sc), tid, sc, sink);

    float t = 0.f;
    if (tid < ntri) {
      int a = tri_row(tid, A), b = a + (tid - tri_start(a, A));
      for (int k = tid; a < A; k += kThreads, tri_advance(a, b, kThreads, A)) {
        const float v = ao[a + 1] > ao[a] && ao[b + 1] > ao[b]
                            ? out[(size_t)a * A + b] * tab[dcs[k] - dmin]
                            : 0.f;
        out[(size_t)a * A + b] = v;
        out[(size_t)b * A + a] = v;
        t += (a == b) ? v : 2.f * v;
      }
    }
    for (int off = 16; off; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
    if (lane == 0) sc.red_f[warp] = t;
    __syncthreads();
    if (tid == 0) {
      float tt = sc.red_f[0];
      for (int w = 1; w < kWarps; ++w) tt += sc.red_f[w];
      dmin_out[(size_t)c * N + n] = (float)dmin;
      total_out[(size_t)c * N + n] = tt;
    }
  };

  if (kDeviceRecords) {
    for (int n = blockIdx.x; n < N; n += gridDim.x) {
      __syncthreads();  // the table, or the previous sample's reads, are done
      one_sample(n);
    }
  } else {
    one_sample(blockIdx.x);  // its first sync orders load_table's writes
  }
}

// cell (a, b)'s pass-one result in the fold's packed triangle: X(a,b)
// relative to dc, and dc
struct TriSink {
  float* xs;
  unsigned short* dcs;
  __device__ void operator()(int, int, int k, int dc, float s) const {
    xs[k] = s;
    dcs[k] = (unsigned short)dc;
  }
};

// blocks of the fold mode an SM holds (its launch bounds: 64 registers a
// thread), where its shared memory leaves room (ops/post_scores.py::
// FOLD_SMEM_BYTES)
constexpr int kFoldBlocksPerSm = 4;

// Floats of the fold mode's device scratch a block: the cells' values and
// the sample's running sum (A(A+1)/2 floats each), then the cells' dc
// (A(A+1)/2 unsigned shorts, padded to whole floats).
__host__ __device__ inline size_t fold_scratch_floats(int A) {
  const size_t ntri = (size_t)A * (A + 1) / 2;
  return 2 * ntri + (ntri + 1) / 2;
}

// The fold mode: block b takes samples n = b, b + gridDim.x, ... and, for
// each, classifiers 0..C-1 in turn. kDeviceRecords: the slot records in the
// block's device scratch, else in shared memory. Shared memory holds what
// the walk reads (records, table, allele starts); every cell's value,
// running minimum and running sum sit in the block's device scratch. So
// four blocks fit an SM at the wide locus: with the cells'
// minima in shared memory three, 5% slower a call; with their values there
// too, two, 14% slower (H100, 160 alleles, 1,197 slots).
template <bool kDeviceRecords>
__global__ void __launch_bounds__(kThreads, kFoldBlocksPerSm)
post_scores_fold_kernel(const uint4* __restrict__ hb,
                        const float* __restrict__ freq,
                        const int* __restrict__ allele,
                        const int* __restrict__ nh,
                        const int8_t* __restrict__ g,
                        const float* __restrict__ wgt,
                        const float* __restrict__ pen_tab, float* ens,
                        float* __restrict__ dmin_out,
                        float* __restrict__ total_out, float* scratch,
                        uint4* rec_scratch, int C, int H, int N, int A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntri = A * (A + 1) / 2;
  const int hs = kDeviceRecords ? 0 : H;                // records here
  uint4* rec = reinterpret_cast<uint4*>(smem);          // [hs] slot records
  uint2* ext = reinterpret_cast<uint2*>(rec + hs);      // [hs]
  float* tab = reinterpret_cast<float*>(ext + hs);      // [kTabLen]
  int* ao = reinterpret_cast<int*>(tab + kTabLen);      // [A + 1]

  __shared__ Scratch<kThreads> sc;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (kDeviceRecords) {
    // uint4 [H], then uint2 [H] padded to whole uint4s
    rec = rec_scratch + (size_t)blockIdx.x * (H + (H + 1) / 2);
    ext = reinterpret_cast<uint2*>(rec + H);
  }
  // the cells, the sample's running sum and the cells' dc, packed upper
  // triangles
  float* xs = scratch + blockIdx.x * fold_scratch_floats(A);
  float* acc = xs + ntri;
  unsigned short* dcs = reinterpret_cast<unsigned short*>(acc + ntri);
  load_table(pen_tab, tab, tid, kThreads);

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    for (int c = 0; c < C; ++c) {
      // the table, or the previous classifier's (or sample's) reads, done
      __syncthreads();
      const int m = min(max(nh[c], 0), H);
      const size_t hoff = (size_t)c * H;
      ballot_masks<kThreads>(g + ((size_t)c * N + n) * kL, tid, sc);
      __syncthreads();
      pack_slots<kThreads>(hb + hoff, freq + hoff, allele + hoff, m, A, tid,
                           sc, rec, ext, ao);
      __syncthreads();
      const Cells cx{rec, ext, tab, ao, nullptr, ao, A, A, het_codes(sc)};
      TriSink sink{xs, dcs};
      // walk_cells ends in a block sync: every cell's X and dc are visible
      const int dmin = walk_cells<kThreads, kRowsScan, kColsScan>(
          cx, het_words(sc), tid, sc, sink);

      // the S mode's sweep and total; each thread keeps its cells' scaled
      // values in place for the second sweep, which takes the same cells
      float t = 0.f;
      if (tid < ntri) {
        int a = tri_row(tid, A), b = a + (tid - tri_start(a, A));
        for (int k = tid; a < A; k += kThreads, tri_advance(a, b, kThreads, A)) {
          const float v = ao[a + 1] > ao[a] && ao[b + 1] > ao[b]
                              ? xs[k] * tab[dcs[k] - dmin]
                              : 0.f;
          xs[k] = v;
          t += (a == b) ? v : 2.f * v;
        }
      }
      for (int off = 16; off; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
      if (lane == 0) sc.red_f[warp] = t;
      __syncthreads();
      float tt = sc.red_f[0];
      for (int w = 1; w < kWarps; ++w) tt += sc.red_f[w];
      if (tid == 0) {
        dmin_out[(size_t)c * N + n] = (float)dmin;
        total_out[(size_t)c * N + n] = tt;
      }
      // Q = S * (2 - eye), then Q * (w / max(total, 1e-30)), each rounded
      // as the plain fold rounds it (no fused multiply-add), added to the
      // running sum in classifier order
      const float scale = wgt[(size_t)c * N + n] / fmaxf(tt, 1e-30f);
      if (tid < ntri) {
        int a = tri_row(tid, A), b = a + (tid - tri_start(a, A));
        for (int k = tid; a < A; k += kThreads, tri_advance(a, b, kThreads, A)) {
          const float v = xs[k];
          const float q = __fmul_rn((a == b) ? v : 2.f * v, scale);
          const float s = c == 0 ? q : __fadd_rn(acc[k], q);
          if (c < C - 1) acc[k] = s; else xs[k] = s;
        }
      }
    }
    __syncthreads();  // xs holds the sample's sum over the classifiers
    float* e = ens + (size_t)n * A * A;
    for (int a = warp; a < A; a += kWarps)
      for (int b = lane; b < A; b += 32) {
        const int lo = min(a, b), hi = max(a, b);
        e[(size_t)a * A + b] += xs[tri_start(lo, A) + (hi - lo)];
      }
  }
}

// H is the slots whose records sit in shared memory (0 if none do)
size_t smem_bytes(int H, int A) {
  const size_t ntri = (size_t)A * (A + 1) / 2;
  return (size_t)H * (sizeof(uint4) + sizeof(uint2)) + kTabLen * sizeof(float)
       + (size_t)(A + 1) * sizeof(int)
       + (A <= kDcSharedMaxA ? ntri * sizeof(unsigned short) : 0);
}

// the fold mode's: records, table and allele starts
size_t fold_smem_bytes(int H, int A) {
  return (size_t)H * (sizeof(uint4) + sizeof(uint2)) + kTabLen * sizeof(float)
       + (size_t)(A + 1) * sizeof(int);
}

template <class K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Bytes of dynamic shared memory at H slots and A alleles, with the slot
// records in shared memory (records != 0) or in device memory.
extern "C" long long hibag_post_scores_smem(int H, int A, int records) {
  return (long long)smem_bytes(records ? H : 0, A);
}

// The same for the fold mode.
extern "C" long long hibag_post_scores_fold_smem(int H, int A, int records) {
  return (long long)fold_smem_bytes(records ? H : 0, A);
}

// Bytes of the fold mode's device scratch a block at A alleles.
extern "C" long long hibag_post_scores_fold_scratch(int A) {
  return (long long)(fold_scratch_floats(A) * sizeof(float));
}

// Blocks of a mode (fold != 0: the fold mode) that one SM holds at once at
// H slots and A alleles, records in shared memory or not; 0 where a block
// does not fit, or -1 on an error.
extern "C" int hibag_post_scores_blocks_per_sm(int fold, int H, int A,
                                               int records) {
  const size_t smem = fold ? fold_smem_bytes(records ? H : 0, A)
                           : smem_bytes(records ? H : 0, A);
  const void* fn;
  cudaError_t err;
  if (fold) {
    auto k = records ? post_scores_fold_kernel<false>
                     : post_scores_fold_kernel<true>;
    err = set_smem(k, smem);
    fn = reinterpret_cast<const void*>(k);
  } else {
    auto k = records ? post_scores_kernel<false> : post_scores_kernel<true>;
    err = set_smem(k, smem);
    fn = reinterpret_cast<const void*>(k);
  }
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                        smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err == cudaErrorInvalidValue ? 0 : -1;
  }
  return blocks;
}

// Bytes of device scratch the kernel needs per (classifier, sample) at A
// alleles: the cells' dc when they do not fit in shared memory, else 0.
extern "C" long long hibag_post_scores_scratch(int A) {
  return A <= kDcSharedMaxA
             ? 0
             : (long long)A * (A + 1) / 2 * (long long)sizeof(unsigned short);
}

// hb: int32 [C,H,4], per classifier its nh[c] valid haplotypes first,
// grouped by allele in increasing order; freq: f32 [C,H]; allele: int32
// [C,H] in [0, A); nh: int32 [C]; g: int8 [C,N,128] genotype codes gathered
// to each classifier's SNP slots (3 = missing or padded); pen_tab: f32
// [257]; S: f32 [C,N,A,A]; dmin, total: f32 [C,N]; dc_scratch: C * N *
// hibag_post_scores_scratch(A) bytes (may be null when that is 0);
// rec_scratch: null (the records in shared memory, NB = N) or C * NB * 16 *
// (H + ceil(H / 2)) bytes, 16-byte aligned, for NB blocks a classifier
// (1 <= NB <= N).
extern "C" int hibag_post_scores(const void* hb, const void* freq,
                                 const void* allele, const void* nh,
                                 const void* g, const void* pen_tab, void* S,
                                 void* dmin, void* total, void* dc_scratch,
                                 void* rec_scratch, int C, int H, int N,
                                 int A, int NB, void* stream, void* ev0,
                                 void* ev1) {
  if (H > 46340 || NB < 1 || NB > N || (!rec_scratch && NB != N))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rec_scratch ? 0 : H, A);
  auto kernel = rec_scratch ? post_scores_kernel<true>
                            : post_scores_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = launch_mark(ev0, st)) != cudaSuccess) return (int)err;
  kernel<<<dim3(NB, C), kThreads, smem, st>>>(
      static_cast<const uint4*>(hb), static_cast<const float*>(freq),
      static_cast<const int*>(allele), static_cast<const int*>(nh),
      static_cast<const int8_t*>(g), static_cast<const float*>(pen_tab),
      static_cast<float*>(S), static_cast<float*>(dmin),
      static_cast<float*>(total), static_cast<unsigned short*>(dc_scratch),
      static_cast<uint4*>(rec_scratch), H, N, A);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_mark(ev1, st);
}

// The fold mode. hb, freq, allele, nh, g and pen_tab as hibag_post_scores;
// wgt: f32 [C,N] classifier weights; ens: f32 [N,A,A], added to; dmin,
// total: f32 [C,N]; scratch: NB * hibag_post_scores_fold_scratch(A) bytes,
// 4-byte aligned; rec_scratch: null (the records in shared memory) or
// NB * 16 * (H + ceil(H / 2)) bytes, 16-byte aligned; NB blocks
// (1 <= NB <= N) take samples n, n + NB, ...
extern "C" int hibag_post_scores_fold(const void* hb, const void* freq,
                                      const void* allele, const void* nh,
                                      const void* g, const void* wgt,
                                      const void* pen_tab, void* ens,
                                      void* dmin, void* total, void* scratch,
                                      void* rec_scratch, int C, int H, int N,
                                      int A, int NB, void* stream, void* ev0,
                                      void* ev1) {
  if (H > 46340 || NB < 1 || NB > N || !scratch)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fold_smem_bytes(rec_scratch ? 0 : H, A);
  auto kernel = rec_scratch ? post_scores_fold_kernel<true>
                            : post_scores_fold_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = launch_mark(ev0, st)) != cudaSuccess) return (int)err;
  kernel<<<NB, kThreads, smem, st>>>(
      static_cast<const uint4*>(hb), static_cast<const float*>(freq),
      static_cast<const int*>(allele), static_cast<const int*>(nh),
      static_cast<const int8_t*>(g), static_cast<const float*>(wgt),
      static_cast<const float*>(pen_tab), static_cast<float*>(ens),
      static_cast<float*>(dmin), static_cast<float*>(total),
      static_cast<float*>(scratch), static_cast<uint4*>(rec_scratch), C, H,
      N, A);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_mark(ev1, st);
}
