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
// What bounds it on the H100: integer ALU and popcount work. It makes two
// passes (one for dmin, one for the sums) over the C * N * m(m+1)/2
// haplotype pairs (m = valid haplotypes of a classifier), each pair 4
// xor/and/popc word operations, plus a table read and an fma in the second. Device-memory traffic is small: per (c, n) 128 bytes of
// genotype codes plus the classifier's m * 28 bytes, which every block of
// the same classifier reads from L2.
//
// What the design does about it:
//  * A haplotype is 4 x 32-bit words (L = MAXNUM_SNP = 128). With obs0/1/2
//    the sample's g==0/1/2 bit masks, D_ij = a_i + a_j +
//    popc(~(h_i ^ h_j) & obs1), a_i = popc(h_i & obs0) + popc(~h_i & obs2):
//    the reference's masked XOR-popcount distance, exact in integers. The
//    masks are built with three warp ballots over the int8 codes; codes >= 3
//    (missing) are in no mask and add 0.
//  * D - dmin is an integer in [0, 2L], so pen is read from the 257-entry
//    table (constants.penalty_table, as float32); no expf per pair.
//  * The upper triangle of pairs (diagonal included) is cut into equal
//    contiguous runs, one per thread, so every thread does the same work
//    whatever the haplotype count. Only valid haplotypes are stored, first
//    and grouped by allele (the wrapper packs them so), so a run adds into
//    one Q cell for long stretches and flushes with one shared-memory
//    atomicAdd when the allele pair changes. These float atomics make the
//    last bits of Q and total vary from run to run; dmin is exact.
//  * One block owns one sample and loops over the classifiers in order,
//    adding into its ensemble row in shared memory: no atomics across
//    classifiers, and the ensemble sum is taken in classifier order as the
//    TPU's sequential grid takes it.
// Limits: H <= 1024 stored haplotype slots and A <= 128 alleles (the packed
// upper triangles of Q and of the ensemble row live in shared memory).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kL = 128;               // SNP slots per classifier
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPenLen = 2 * kL + 1;   // D - dmin in [0, 2L]
constexpr unsigned kFull = 0xffffffffu;

// packed row-major upper triangle (a <= b) of an A x A matrix
__device__ __forceinline__ int tri_index(int a, int b, int A) {
  return a * A - (a * (a - 1)) / 2 + (b - a);
}

// first linear index of row i in the upper triangle of an m x m matrix
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
ens_acc_kernel(const uint4* __restrict__ hb, const float* __restrict__ freq,
               const int* __restrict__ allele, const int* __restrict__ nh,
               const int8_t* __restrict__ g, const float* __restrict__ wgt,
               const float* __restrict__ pen_tab, float* __restrict__ ens,
               float* __restrict__ dmin_out, float* __restrict__ total_out,
               int C, int H, int N, int A, int majority) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* hs = reinterpret_cast<uint4*>(smem);          // [H] haplotype words
  float* fs = reinterpret_cast<float*>(hs + H);        // [H] frequencies
  int* as = reinterpret_cast<int*>(fs + H);            // [H] alleles
  int* ah = as + H;                                    // [H] a_i
  float* tab = reinterpret_cast<float*>(ah + H);       // [kPenLen]
  const int ntri = A * (A + 1) / 2;
  float* su = tab + kPenLen;                           // [ntri] Q of c
  float* es = su + ntri;                               // [ntri] ensemble row

  __shared__ unsigned obs[3][4];
  __shared__ int red_i[kWarps];
  __shared__ float red_f[kWarps];
  __shared__ float red_v[kWarps];
  __shared__ int s_dmin, s_best;
  __shared__ float s_total;

  const int n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < ntri; k += kThreads) es[k] = 0.f;
  for (int k = tid; k < kPenLen; k += kThreads) tab[k] = pen_tab[k];

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // the previous classifier is done with shared memory
    const int m = min(max(nh[c], 0), H);
    for (int i = tid; i < m; i += kThreads) {
      hs[i] = hb[(size_t)c * H + i];
      fs[i] = freq[(size_t)c * H + i];
      as[i] = allele[(size_t)c * H + i];
    }
    for (int k = tid; k < ntri; k += kThreads) su[k] = 0.f;
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

    // this thread's run [p0, p1) of the upper triangle of pairs
    const int npair = m * (m + 1) / 2;
    const int per = (npair + kThreads - 1) / kThreads;
    const int p0 = min(tid * per, npair), p1 = min(p0 + per, npair);
    const int i0 = p0 < p1 ? tri_row(p0, m) : 0;
    const int j0 = p0 < p1 ? i0 + (p0 - tri_start(i0, m)) : 0;

    // pass 1: minimum distance
    int dm = INT_MAX;
    if (p0 < p1) {
      int i = i0, j = j0;
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
    const int dmin = s_dmin;

    // pass 2: Q, one atomic flush per change of allele pair
    if (p0 < p1) {
      int i = i0, j = j0;
      uint4 hi = hs[i];
      int ai = ah[i], ali = as[i];
      float fi = fs[i];
      int key = -1;
      float run = 0.f;
      for (int p = p0; p < p1; ++p) {
        const int d = pair_dist(hi, hs[j], ai, ah[j], o1);
        const int alj = as[j];
        const int k = ali <= alj ? tri_index(ali, alj, A)
                                 : tri_index(alj, ali, A);
        if (k != key) {
          if (key >= 0) atomicAdd(&su[key], run);
          key = k;
          run = 0.f;
        }
        const float v = fi * fs[j] * tab[d - dmin];
        run += (j == i) ? v : 2.f * v;
        if (++j == m) {
          j = ++i;
          if (i < m) { hi = hs[i]; ai = ah[i]; ali = as[i]; fi = fs[i]; }
        }
      }
      if (key >= 0) atomicAdd(&su[key], run);
    }
    __syncthreads();

    // total = sum Q; best = first row-major maximum of Q
    float t = 0.f, bv = -1.f;
    int bk = INT_MAX;
    for (int k = tid; k < ntri; k += kThreads) {
      const float s = su[k];
      t += s;
      if (s > bv) { bv = s; bk = k; }
    }
    for (int off = 16; off; off >>= 1) {
      t += __shfl_xor_sync(kFull, t, off);
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int ok = __shfl_xor_sync(kFull, bk, off);
      if (ov > bv || (ov == bv && ok < bk)) { bv = ov; bk = ok; }
    }
    if (lane == 0) { red_f[warp] = t; red_v[warp] = bv; red_i[warp] = bk; }
    __syncthreads();
    if (tid == 0) {
      float tt = red_f[0], vv = red_v[0];
      int kk = red_i[0];
      for (int w = 1; w < kWarps; ++w) {
        tt += red_f[w];
        if (red_v[w] > vv || (red_v[w] == vv && red_i[w] < kk)) {
          vv = red_v[w];
          kk = red_i[w];
        }
      }
      s_total = tt;
      s_best = kk;
      dmin_out[(size_t)c * N + n] = (float)dmin;
      total_out[(size_t)c * N + n] = tt;
    }
    __syncthreads();
    const float w = wgt[(size_t)c * N + n];
    if (majority) {
      if (tid == 0 && w > 0.f) es[s_best] += 1.f;
    } else {
      const float scale = w / fmaxf(s_total, 1e-30f);
      for (int k = tid; k < ntri; k += kThreads) es[k] += su[k] * scale;
    }
  }
  __syncthreads();

  // write the symmetric full A x A row
  float* out = ens + (size_t)n * A * A;
  for (int idx = tid; idx < A * A; idx += kThreads) {
    const int a = idx / A, b = idx - a * A;
    out[idx] = es[a <= b ? tri_index(a, b, A) : tri_index(b, a, A)];
  }
}

}  // namespace

extern "C" int hibag_ens_acc(const void* hb, const void* freq,
                             const void* allele, const void* nh, const void* g,
                             const void* wgt, const void* pen_tab, void* ens,
                             void* dmin, void* total, int C, int H, int N,
                             int A, int majority, void* stream) {
  const size_t smem = (size_t)H * (sizeof(uint4) + sizeof(float) + 2 * sizeof(int))
                    + kPenLen * sizeof(float)
                    + 2 * (size_t)(A * (A + 1) / 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ens_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ens_acc_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(hb), static_cast<const float*>(freq),
      static_cast<const int*>(allele), static_cast<const int*>(nh),
      static_cast<const int8_t*>(g), static_cast<const float*>(wgt),
      static_cast<const float*>(pen_tab), static_cast<float*>(ens),
      static_cast<float*>(dmin), static_cast<float*>(total), C, H, N, A,
      majority);
  return (int)cudaGetLastError();
}

extern "C" const char* hibag_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
