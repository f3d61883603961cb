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
// What bounds it on the H100: popcount issue. Each pair's distance is 4
// xor/and/popc word operations, done once for dmin and once for the sums,
// over the C * N * m(m+1)/2 unordered pairs (m = valid haplotypes of a
// classifier; 16 popc per clock per SM). Device-memory traffic is the
// S output, C * N * A^2 * 4 bytes, which is small beside the pair work
// (m^2 / 2 pairs against A^2 output cells, m >> A).
//
// What the design does about it:
//  * A haplotype is 4 x 32-bit words (L = MAXNUM_SNP = 128). With obs0/1/2
//    the sample's g==0/1/2 bit masks, D_ij = a_i + a_j +
//    popc(~(h_i ^ h_j) & obs1), a_i = popc(h_i & obs0) + popc(~h_i & obs2):
//    the reference's masked XOR-popcount distance, exact in integers. Codes
//    >= 3 (missing or padded slots) are in no mask and add 0. Only valid
//    slots are stored (nh[c] of them), so padded slots enter neither dmin
//    nor S.
//  * D - dmin is an integer in [0, 2L], so pen is read from the 257-entry
//    table; no expf per pair. Pairs whose penalty underflows to 0 add
//    nothing and are skipped.
//  * One block owns one (classifier, sample). The valid haplotypes come
//    grouped by allele (the wrapper packs them so), so the cell (a, b),
//    a <= b, is the rectangle of two contiguous ranges. One thread owns one
//    cell and adds its pairs in a fixed order (row sums, then weighted by
//    f_i, as W^T (pen W) does), writing S[a,b] and S[b,a] itself: no
//    float atomics, and two runs are bitwise equal. A diagonal cell walks
//    its triangle, each pair i < j counted twice.
//  * Load imbalance: allele frequencies fall off with rank, so the first
//    alleles' cells hold most pairs and their threads set the block's pace.
//    Accepted here; a later kernel may split large cells over a warp.
//  * S is written to device memory, not staged in shared memory, so A is
//    bounded by the output's size only.
// Limits: H <= 4096 stored haplotype slots (their words, frequencies and
// a_i live in shared memory: 24 bytes each), A <= 1024 alleles.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kL = 128;               // SNP slots per classifier
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPenLen = 2 * kL + 1;   // D - dmin in [0, 2L]
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ int pair_dist(uint4 hi, uint4 hj, int ai, int aj,
                                         uint4 o1) {
  return ai + aj + __popc(~(hi.x ^ hj.x) & o1.x) + __popc(~(hi.y ^ hj.y) & o1.y)
       + __popc(~(hi.z ^ hj.z) & o1.z) + __popc(~(hi.w ^ hj.w) & o1.w);
}

__global__ void __launch_bounds__(kThreads)
post_scores_kernel(const uint4* __restrict__ hb, const float* __restrict__ freq,
                   const int* __restrict__ allele, const int* __restrict__ nh,
                   const int8_t* __restrict__ g,
                   const float* __restrict__ pen_tab, float* __restrict__ S,
                   float* __restrict__ dmin_out, float* __restrict__ total_out,
                   int H, int N, int A) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* hs = reinterpret_cast<uint4*>(smem);          // [H] haplotype words
  float* fs = reinterpret_cast<float*>(hs + H);        // [H] frequencies
  int* ah = reinterpret_cast<int*>(fs + H);            // [H] a_i
  int* ao = ah + H;                                    // [A + 1] allele starts
  float* tab = reinterpret_cast<float*>(ao + A + 1);   // [kPenLen]

  __shared__ unsigned obs[3][4];
  __shared__ int red_i[kWarps];
  __shared__ float red_f[kWarps];
  __shared__ int s_dmin;

  const int n = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = min(max(nh[c], 0), H);
  const size_t hoff = (size_t)c * H;

  for (int i = tid; i < m; i += kThreads) {
    hs[i] = hb[hoff + i];
    fs[i] = freq[hoff + i];
    // ao[a] = first slot of allele >= a: slot i starts the alleles in
    // (allele[i-1], allele[i]]; the last slot also ends the ones after it
    const int al = allele[hoff + i];
    const int prev = i > 0 ? allele[hoff + i - 1] : -1;
    for (int a = prev + 1; a <= al; ++a) ao[a] = i;
    if (i == m - 1)
      for (int a = al + 1; a <= A; ++a) ao[a] = m;
  }
  if (m == 0)
    for (int a = tid; a <= A; a += kThreads) ao[a] = 0;
  for (int k = tid; k < kPenLen; k += kThreads) tab[k] = pen_tab[k];
  if (tid < kL) {  // warps 0..3: one code per lane, one mask word per warp
    const int code = g[((size_t)c * N + n) * kL + tid];
    const unsigned b0 = __ballot_sync(kFull, code == 0);
    const unsigned b1 = __ballot_sync(kFull, code == 1);
    const unsigned b2 = __ballot_sync(kFull, code == 2);
    if (lane == 0) {
      obs[0][warp] = b0;
      obs[1][warp] = b1;
      obs[2][warp] = b2;
    }
  }
  __syncthreads();
  const uint4 o0 = make_uint4(obs[0][0], obs[0][1], obs[0][2], obs[0][3]);
  const uint4 o1 = make_uint4(obs[1][0], obs[1][1], obs[1][2], obs[1][3]);
  const uint4 o2 = make_uint4(obs[2][0], obs[2][1], obs[2][2], obs[2][3]);
  for (int i = tid; i < m; i += kThreads) {
    const uint4 h = hs[i];
    ah[i] = __popc(h.x & o0.x) + __popc(h.y & o0.y) + __popc(h.z & o0.z)
          + __popc(h.w & o0.w) + __popc(~h.x & o2.x) + __popc(~h.y & o2.y)
          + __popc(~h.z & o2.z) + __popc(~h.w & o2.w);
  }
  __syncthreads();

  // pass 1: dmin over the upper triangle of pairs, in equal contiguous runs
  {
    const int npair = m * (m + 1) / 2;
    const int per = (npair + kThreads - 1) / kThreads;
    const int p0 = min(tid * per, npair), p1 = min(p0 + per, npair);
    int dm = INT_MAX;
    if (p0 < p1) {
      int i = tri_row(p0, m);
      int j = i + (p0 - tri_start(i, m));
      uint4 hi = hs[i];
      int ai = ah[i];
      for (int p = p0; p < p1; ++p) {
        dm = min(dm, pair_dist(hi, hs[j], ai, ah[j], o1));
        if (++j == m) {
          j = ++i;
          if (i < m) { hi = hs[i]; ai = ah[i]; }
        }
      }
    }
    for (int off = 16; off; off >>= 1)
      dm = min(dm, __shfl_xor_sync(kFull, dm, off));
    if (lane == 0) red_i[warp] = dm;
    __syncthreads();
    if (tid == 0) {
      int v = red_i[0];
      for (int w = 1; w < kWarps; ++w) v = min(v, red_i[w]);
      s_dmin = v;
    }
    __syncthreads();
  }
  const int dmin = s_dmin;

  // pass 2: one thread per upper-triangle cell (a <= b), fixed order
  float* out = S + ((size_t)c * N + n) * A * A;
  const int ncell = A * (A + 1) / 2;
  float t = 0.f;
  for (int cell = tid; cell < ncell; cell += kThreads) {
    const int a = tri_row(cell, A);
    const int b = a + (cell - tri_start(a, A));
    const int ie = ao[a + 1], jb = ao[b], je = ao[b + 1];
    float s = 0.f;
    for (int i = ao[a]; i < ie; ++i) {
      const uint4 hi = hs[i];
      const int ai = ah[i];
      float row = 0.f;
      if (a == b) {
        row = 0.5f * fs[i] * tab[pair_dist(hi, hi, ai, ai, o1) - dmin];
      }
      for (int j = (a == b ? i + 1 : jb); j < je; ++j) {
        const float pen = tab[pair_dist(hi, hs[j], ai, ah[j], o1) - dmin];
        if (pen == 0.f) continue;
        row += fs[j] * pen;
      }
      s += fs[i] * row;
    }
    if (a == b) s *= 2.f;  // each pair i < j in both orders, i == j once
    out[(size_t)a * A + b] = s;
    out[(size_t)b * A + a] = s;
    t += (a == b) ? s : 2.f * s;
  }
  for (int off = 16; off; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  if (lane == 0) red_f[warp] = t;
  __syncthreads();
  if (tid == 0) {
    float tt = red_f[0];
    for (int w = 1; w < kWarps; ++w) tt += red_f[w];
    dmin_out[(size_t)c * N + n] = (float)dmin;
    total_out[(size_t)c * N + n] = tt;
  }
}

}  // namespace

// hb: int32 [C,H,4], per classifier its nh[c] valid haplotypes first,
// grouped by allele in increasing order; freq: f32 [C,H]; allele: int32
// [C,H] in [0, A); nh: int32 [C]; g: int8 [C,N,128] genotype codes gathered
// to each classifier's SNP slots (3 = missing or padded); pen_tab: f32
// [257]; S: f32 [C,N,A,A]; dmin, total: f32 [C,N].
extern "C" int hibag_post_scores(const void* hb, const void* freq,
                                 const void* allele, const void* nh,
                                 const void* g, const void* pen_tab, void* S,
                                 void* dmin, void* total, int C, int H, int N,
                                 int A, void* stream) {
  const size_t smem = (size_t)H * (sizeof(uint4) + sizeof(float) + sizeof(int))
                    + (size_t)(A + 1) * sizeof(int) + kPenLen * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      post_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  post_scores_kernel<<<dim3(N, C), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(hb), static_cast<const float*>(freq),
      static_cast<const int*>(allele), static_cast<const int*>(nh),
      static_cast<const int8_t*>(g), static_cast<const float*>(pen_tab),
      static_cast<float*>(S), static_cast<float*>(dmin),
      static_cast<float*>(total), H, N, A);
  return (int)cudaGetLastError();
}
