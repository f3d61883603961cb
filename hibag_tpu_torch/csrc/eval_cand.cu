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
//
// What bounds it on the H100: integer and float ALU work, about
// C * m^2 / 2 pair terms per (k, n) for m ok haplotypes; device-memory
// traffic is small (128 code bytes per sample, the classifier's haplotypes
// and frequencies from L2).
//
// What the design does about it:
//  * No allele-expanded contraction. The TPU kernel multiplies
//    [2*A*Cp, H] x [H, H] per sample on the MXU; here each pair's penalty
//    is folded into its candidate's (allele_i, allele_j) cell directly,
//    about H^2 * C terms. Pairs whose penalty underflows to 0 are skipped.
//  * Distances by XOR/AND/popcount on haplotypes packed to 4 x u32 (L = 128)
//    as in ens_acc.cu; D - dmin is an integer in [0, 256], so pen comes from
//    the 257-entry table.
//  * The trainer keeps haplotypes by frequency, not by allele. The wrapper
//    passes the ok haplotypes sorted by allele with the block offsets, so a
//    cell (a <= b) is two contiguous ranges.
//  * Determinism: one thread owns one (candidate, cell) and adds its pairs
//    in a fixed order into a private shared-memory slot: no atomics. The
//    per-sample results go to [K, C, N] and a second kernel adds them in
//    sample order.
//  * The A x A grids of a group of candidates live in shared memory (the
//    upper triangle); when all C do not fit, the block loops over groups.
//  * Ties: the best guess is the smallest packed upper-triangle index among
//    equal maxima, which is the first row-major maximum of the full grid.
// Limits: H <= 4096 haplotype slots, A <= 128 alleles, C <= 64 candidates.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kL = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPenLen = 2 * kL + 1;
constexpr int kMaxC = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int tri_start(int i, int m) {
  return i * m - (i * (i - 1)) / 2;
}

// row of linear index p in the packed upper triangle (diagonal included) of
// an m x m matrix
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
eval_kernel(const uint4* __restrict__ hb, const float* __restrict__ fA,
            const float* __restrict__ fB, const int* __restrict__ aoff,
            const int8_t* __restrict__ gcand, const int8_t* __restrict__ geno,
            const int* __restrict__ a1v, const int* __restrict__ a2v,
            const uint8_t* __restrict__ oob, const float* __restrict__ Bw,
            const float* __restrict__ pen_tab, int* __restrict__ accp,
            float* __restrict__ llp, int H, int N, int C, int A, int Cg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncell = A * (A + 1) / 2;
  uint4* hs = reinterpret_cast<uint4*>(smem);            // [H]
  int* ah = reinterpret_cast<int*>(hs + H);              // [H]
  int* ao = ah + H;                                      // [A + 1]
  float* tab = reinterpret_cast<float*>(ao + A + 1);     // [kPenLen]
  float* grid = tab + kPenLen;                           // [Cg][ncell]

  __shared__ unsigned obs[3][4];
  __shared__ int red_i[kWarps];
  __shared__ int s_dmin;
  __shared__ float pd_s[kMaxC][3];

  const int n = blockIdx.x, k = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* aok = aoff + (size_t)k * (A + 1);
  const int m = aok[A];                      // ok haplotypes, stored first
  const float* fAk = fA + (size_t)k * C * H;
  const float* fBk = fB + (size_t)k * C * H;

  for (int i = tid; i < m; i += kThreads) hs[i] = hb[(size_t)k * H + i];
  for (int i = tid; i <= A; i += kThreads) ao[i] = aok[i];
  for (int i = tid; i < kPenLen; i += kThreads) tab[i] = pen_tab[i];
  if (tid < kL) {
    const int code = geno[((size_t)k * N + n) * kL + tid];
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
  for (int c = tid; c < C; c += kThreads) {
    const int g = gcand[((size_t)k * C + c) * N + n];
    // delta(g, s) for s = 0, 1, 2: g=0 -> s, g=1 -> |s-1|, g=2 -> 2-s, NA -> 0
    const int d0 = g == 0 ? 0 : g == 1 ? 1 : g == 2 ? 2 : 0;
    const int d1 = g == 1 ? 0 : (g == 0 || g == 2) ? 1 : 0;
    const int d2 = g == 0 ? 2 : g == 1 ? 1 : 0;
    pd_s[c][0] = tab[d0];
    pd_s[c][1] = tab[d1];
    pd_s[c][2] = tab[d2];
  }
  __syncthreads();

  // dmin over the upper triangle of ok pairs, in equal contiguous runs
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

  const int a1 = a1v[n], a2 = a2v[n];
  const bool is_oob = oob[(size_t)k * N + n] != 0;
  const float bw = Bw[(size_t)k * N + n];
  const int true_cell = tri_start(a1, A) + (a2 - a1);

  for (int c0 = 0; c0 < C; c0 += Cg) {
    const int cg = min(Cg, C - c0);
    for (int u = tid; u < cg * ncell; u += kThreads) {
      const int cl = u / ncell, cell = u - cl * ncell;
      const int c = c0 + cl;
      const int a = tri_row(cell, A);
      const int b = a + (cell - tri_start(a, A));
      const float pd0 = pd_s[c][0], pd1 = pd_s[c][1], pd2 = pd_s[c][2];
      const float* fa = fAk + (size_t)c * H;
      const float* fb = fBk + (size_t)c * H;
      const int ie = ao[a + 1], jb = ao[b], je = ao[b + 1];
      float sum = 0.f;
      for (int i = ao[a]; i < ie; ++i) {
        const uint4 hi = hs[i];
        const int ai = ah[i];
        const float fai = fa[i], fbi = fb[i];
        for (int j = (a == b ? i : jb); j < je; ++j) {
          const float pen = tab[pair_dist(hi, hs[j], ai, ah[j], o1) - dmin];
          if (pen == 0.f) continue;
          const float faj = fa[j], fbj = fb[j];
          const float v = pen * (pd0 * fai * faj + pd1 * (fai * fbj + fbi * faj)
                                 + pd2 * fbi * fbj);
          sum += (j == i) ? v : 2.f * v;
        }
      }
      grid[u] = sum;
    }
    __syncthreads();

    // per candidate: total, first maximum, true pair, Compare, -2 B log post
    for (int cl = warp; cl < cg; cl += kWarps) {
      const float* gq = grid + (size_t)cl * ncell;
      float t = 0.f, bv = -1.f;
      int bk = INT_MAX;
      for (int q = lane; q < ncell; q += 32) {
        const float v = gq[q];
        t += v;
        if (v > bv) { bv = v; bk = q; }
      }
      for (int off = 16; off; off >>= 1) {
        t += __shfl_xor_sync(kFull, t, off);
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int ok = __shfl_xor_sync(kFull, bk, off);
        if (ov > bv || (ov == bv && ok < bk)) { bv = ov; bk = ok; }
      }
      if (lane == 0) {
        const int c = c0 + cl;
        const int g1 = tri_row(bk, A);
        const int g2 = g1 + (bk - tri_start(g1, A));
        // CHLATypeList::Compare (src/LibHLA.cpp:911-924)
        const bool m1 = (g1 == a1) || (g1 == a2);
        const int t1u = (m1 && g1 == a1) ? -1 : a1;
        const int t2u = (m1 && g1 != a1 && g1 == a2) ? -1 : a2;
        const bool m2 = (g2 == t1u) || (g2 == t2u);
        const int cnt = (int)m1 + (int)m2;
        const float post = gq[true_cell] / fmaxf(t, 1e-37f);
        const size_t o = ((size_t)k * C + c) * N + n;
        accp[o] = (is_oob && t > 0.f) ? cnt : 0;
        llp[o] = -2.f * bw * logf(fmaxf(post, 1e-37f));
      }
    }
    __syncthreads();
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

}  // namespace

// Bytes of dynamic shared memory for H slots, A alleles and Cg grids.
extern "C" long long hibag_eval_smem(int H, int A, int Cg) {
  return (long long)H * (sizeof(uint4) + sizeof(int))
       + (long long)(A + 1) * sizeof(int) + kPenLen * sizeof(float)
       + (long long)Cg * (A * (A + 1) / 2) * sizeof(float);
}

// hb: int32 [K,H,4] ok haplotypes first, sorted by allele; fA, fB: f32
// [K,C,H] in the same order; aoff: int32 [K,A+1] allele block starts (aoff[A]
// = ok count); gcand: int8 [K,C,N]; geno: int8 [K,N,128]; a1, a2: int32 [N];
// oob: uint8 [K,N]; B: f32 [K,N]; pen_tab: f32 [257]; accp: int32 [K,C,N],
// llp: f32 [K,C,N] scratch; acc: int32 [K,C]; ll: f32 [K,C].
extern "C" int hibag_eval_cand(const void* hb, const void* fA, const void* fB,
                               const void* aoff, const void* gcand,
                               const void* geno, const void* a1,
                               const void* a2, const void* oob, const void* B,
                               const void* pen_tab, void* accp, void* llp,
                               void* acc, void* ll, int K, int H, int N, int C,
                               int A, int Cg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)hibag_eval_smem(H, A, Cg);
  cudaError_t err = cudaFuncSetAttribute(
      eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  eval_kernel<<<dim3(N, K), kThreads, smem, st>>>(
      static_cast<const uint4*>(hb), static_cast<const float*>(fA),
      static_cast<const float*>(fB), static_cast<const int*>(aoff),
      static_cast<const int8_t*>(gcand), static_cast<const int8_t*>(geno),
      static_cast<const int*>(a1), static_cast<const int*>(a2),
      static_cast<const uint8_t*>(oob), static_cast<const float*>(B),
      static_cast<const float*>(pen_tab), static_cast<int*>(accp),
      static_cast<float*>(llp), H, N, C, A, Cg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int KC = K * C;
  eval_finish_kernel<<<(KC + 255) / 256, 256, 0, st>>>(
      static_cast<const int*>(accp), static_cast<const float*>(llp),
      static_cast<int*>(acc), static_cast<float*>(ll), KC, N);
  return (int)cudaGetLastError();
}
