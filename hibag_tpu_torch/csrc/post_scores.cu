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
// writing S [C,N,A,A], dmin [C,N] (integer-valued) and total [C,N]. Nothing
// is accumulated across classifiers.
//
// What bounds it on the H100: popcount issue, one popcount per unordered
// pair and 32-SNP word in which the sample has a heterozygous code, over the
// C * N * m(m+1)/2 pairs (m = valid haplotypes of a classifier; 16 popc per
// clock per SM), with a table read and an fma per pair beside it.
// Device-memory traffic is the S output, C * N * A^2 * 4 bytes, small beside
// the pair work (m^2 / 2 pairs against A^2 output cells, m >> A).
//
// What the design does about it (the distance, the one-pass cell sums and
// the work split are pair_cells.cuh's):
//  * One distance pass. Each allele cell (a <= b) is summed against its own
//    running minimum dc and written to S[a,b] with dc kept beside it (in
//    shared memory for A <= kDcSharedMaxA, else in a device scratch the
//    wrapper allocates). Once the block's dmin = min dc is known, a sweep
//    scales each cell by 1e-5^(dc - dmin) and writes S[a,b] and S[b,a]
//    itself, so S is exactly symmetric.
//  * Popcounts only over the words with a heterozygous code (nothing else
//    of a pair's distance varies with the pair).
//  * A small cell belongs to one thread, a large one to a warp; each cell
//    has one writer and sums its pairs in a fixed order, and total is
//    reduced per thread, warp and block in a fixed order. No float atomics:
//    two runs are bitwise equal.
//  * The slot records (24 bytes a slot) sit in shared memory where they fit
//    (to about 9,000 slots); else in a device scratch of the block's own,
//    and a block then takes samples n, n + gridDim.x, ... so that the
//    scratch is sized by the blocks, not the samples (ops/post_scores.py::
//    scores_plan). Both routes do the same arithmetic in the same order.
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

// H is the slots whose records sit in shared memory (0 if none do)
size_t smem_bytes(int H, int A) {
  const size_t ntri = (size_t)A * (A + 1) / 2;
  return (size_t)H * (sizeof(uint4) + sizeof(uint2)) + kTabLen * sizeof(float)
       + (size_t)(A + 1) * sizeof(int)
       + (A <= kDcSharedMaxA ? ntri * sizeof(unsigned short) : 0);
}

}  // namespace

// Bytes of dynamic shared memory at H slots and A alleles, with the slot
// records in shared memory (records != 0) or in device memory.
extern "C" long long hibag_post_scores_smem(int H, int A, int records) {
  return (long long)smem_bytes(records ? H : 0, A);
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
