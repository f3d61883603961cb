// EM E+M step for all candidate SNPs of K classifiers, NVIDIA Hopper (sm_90a).
//
// Replaces hibag_tpu/ops/train_step_pallas.py::_em_kernel (int8 pair mask,
// entry em_estep_pallas) and ::_em_kernel_packed (bit-packed mask, entry
// em_estep_pallas_packed). For classifier k, candidate c and in-bag sample s
// with matched-pair mask M_s (symmetric, {0,1}) it computes
//   tX[c,h]  = sum_j M_s[h,j] fX[c,j]                      (X = A, B)
//   sXY[c]   = sum_h fX[c,h] tY[c,h]
//   psum[c]  = m00 s00 + m01 s01 + m01 s10 + m11 s11       (m: genotype selectors)
//   w        = B_s / max(psum, 1e-37)
//   dfA[c,h] = fA[c,h] sum_s (w m00 tA + w m01 tB) / total_n
//   dfB[c,h] = fB[c,h] sum_s (w m01 tA + w m11 tB) / total_n
//   dll[c]   = sum_s B_s log(max(psum, 1e-37))
// as hibag_tpu/models/em.py::_em_estep_chunk does.
//
// What bounds it on the H100: the mask stream. Every EM iteration reads the
// whole mask, S*H*H bytes per classifier as int8 (67 MB at S = 1,024,
// H = 256) or S*H*H/8 packed; the arithmetic is small, because the matched
// pairs of a sample are its minimum-distance pairs within two allele
// blocks, a handful of the H*H.
//
// What the design does about it:
//  * The mask is read once per sample in 32-column words, coalesced (two
//    16-byte loads per int8 word, one 4-byte load per packed word; bit i of
//    a word is column 32w + i in both layouts, the packed one being
//    _pack_mask's natural order). That pass only marks the rows with a set
//    bit; the rows are then compacted in increasing h.
//  * The sums walk the set bits of the active rows (__ffs), so the work is
//    O(pairs * C), not O(H^2 * C), and the repeated reads of an active row
//    hit L1. Rows with no set bit and samples with B = 0 contribute exact
//    zeros and are skipped.
//  * Determinism: no float atomics. Thread t works for candidate t % C on
//    rows r = t / C (mod 256 / C); its s-sum partials are added in a fixed
//    order, and each (c, h) of a block's accumulator has one writer per
//    sample. A block (k, g) owns samples [g*chunk, (g+1)*chunk) and its own
//    slice of the partial buffer; a second kernel adds the G slices in
//    order g = 0..G-1. G depends on S only.
//  * K is a grid dimension: each classifier has its own mask, fA/fB, B.
//  * Exactly C candidates: no candidate padding.
// Limits: H a multiple of 32, H <= 4096, 1 <= C <= 64.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <bool kPacked>
__device__ __forceinline__ unsigned load_word(const uint8_t* row, int w) {
  if (kPacked) {
    return *reinterpret_cast<const unsigned*>(row + 4 * w);
  }
  const uint4* p = reinterpret_cast<const uint4*>(row + 32 * w);
  const uint4 a = p[0], b = p[1];
  const unsigned v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned out = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const unsigned x = v[q];
    out |= ((x & 0x000000ffu) ? 1u : 0u) << (4 * q);
    out |= ((x & 0x0000ff00u) ? 1u : 0u) << (4 * q + 1);
    out |= ((x & 0x00ff0000u) ? 1u : 0u) << (4 * q + 2);
    out |= ((x & 0xff000000u) ? 1u : 0u) << (4 * q + 3);
  }
  return out;
}

// tA = sum of fa[j], tB = sum of fb[j] over the set columns j of one row,
// in increasing j
template <bool kPacked>
__device__ __forceinline__ void row_sums(const uint8_t* row, int W,
                                         const float* __restrict__ fa,
                                         const float* __restrict__ fb,
                                         float& tA, float& tB) {
  tA = 0.f;
  tB = 0.f;
  for (int w = 0; w < W; ++w) {
    unsigned m = load_word<kPacked>(row, w);
    while (m) {
      const int j = 32 * w + __ffs(m) - 1;
      m &= m - 1;
      tA += __ldg(fa + j);
      tB += __ldg(fb + j);
    }
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
em_estep_kernel(const uint8_t* __restrict__ mask, const float* __restrict__ fA,
                const float* __restrict__ fB, const int8_t* __restrict__ gc,
                const float* __restrict__ Bw, float* __restrict__ part,
                float* __restrict__ dllp, int S, int H, int C, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* act = reinterpret_cast<int*>(smem);                 // [H]
  unsigned char* active = smem + sizeof(int) * H;          // [H]
  __shared__ float red[4][kThreads];
  __shared__ int s_off[kThreads];
  __shared__ int s_nact;
  __shared__ float s_w[3][64];
  __shared__ float s_dll[64];

  const int g = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int chunk = (S + G - 1) / G;
  const int s0 = min(S, g * chunk), s1 = min(S, s0 + chunk);
  const int W = H / 32;
  const size_t row_bytes = kPacked ? H / 8 : H;
  const size_t CH = (size_t)C * H;
  float* pA = part + (size_t)(k * G + g) * 2 * CH;       // [C][H]
  float* pB = pA + CH;                                   // [C][H]
  const float* fAk = fA + (size_t)k * CH;
  const float* fBk = fB + (size_t)k * CH;
  const int P = kThreads / C;        // row parts per candidate (>= 4)
  const int c = tid % C, p = tid / C;
  const bool worker = p < P;
  const float* fac = fAk + (size_t)c * H;
  const float* fbc = fBk + (size_t)c * H;

  for (size_t i = tid; i < 2 * CH; i += kThreads) pA[i] = 0.f;
  if (tid < C) s_dll[tid] = 0.f;
  __syncthreads();

  for (int s = s0; s < s1; ++s) {
    const float b = Bw[(size_t)k * S + s];
    if (b == 0.f) continue;   // the same for every thread of the block
    const uint8_t* ms = mask + ((size_t)k * S + s) * H * row_bytes;

    // rows with a set bit
    for (int h = tid; h < H; h += kThreads) active[h] = 0;
    __syncthreads();
    for (int idx = tid; idx < H * W; idx += kThreads) {
      const int h = idx / W, w = idx - h * W;
      if (load_word<kPacked>(ms + h * row_bytes, w)) active[h] = 1;
    }
    __syncthreads();

    // compact them in increasing h: thread t counts rows [t*per, (t+1)*per)
    const int per = (H + kThreads - 1) / kThreads;
    const int h0 = min(H, tid * per), h1 = min(H, h0 + per);
    int cnt = 0;
    for (int h = h0; h < h1; ++h) cnt += active[h];
    s_off[tid] = cnt;
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int t = 0; t < kThreads; ++t) {
        const int v = s_off[t];
        s_off[t] = run;
        run += v;
      }
      s_nact = run;
    }
    __syncthreads();
    {
      int o = s_off[tid];
      for (int h = h0; h < h1; ++h)
        if (active[h]) act[o++] = h;
    }
    __syncthreads();
    const int nact = s_nact;

    // s-sums: this thread's share of candidate c's active rows
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
    if (worker) {
      for (int r = p; r < nact; r += P) {
        const int h = act[r];
        float tA, tB;
        row_sums<kPacked>(ms + h * row_bytes, W, fac, fbc, tA, tB);
        const float fa = fac[h], fb = fbc[h];
        a00 += fa * tA;
        a01 += fa * tB;
        a10 += fb * tA;
        a11 += fb * tB;
      }
    }
    red[0][tid] = a00;
    red[1][tid] = a01;
    red[2][tid] = a10;
    red[3][tid] = a11;
    __syncthreads();
    if (tid < C) {
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
      for (int q = 0; q < P; ++q) {
        const int t = q * C + tid;
        s00 += red[0][t];
        s01 += red[1][t];
        s10 += red[2][t];
        s11 += red[3][t];
      }
      const int code = gc[((size_t)k * C + tid) * S + s];
      const bool na = code < 0 || code > 2;
      const float m00 = (code == 0 || na) ? 1.f : 0.f;
      const float m01 = (code == 1 || na) ? 1.f : 0.f;
      const float m11 = (code == 2 || na) ? 1.f : 0.f;
      const float psum = m00 * s00 + m01 * s01 + m01 * s10 + m11 * s11;
      const float ps = fmaxf(psum, 1e-37f);
      const float wgt = b / ps;
      s_w[0][tid] = wgt * m00;
      s_w[1][tid] = wgt * m01;
      s_w[2][tid] = wgt * m11;
      s_dll[tid] += b * logf(ps);
    }
    __syncthreads();

    // accumulate w-weighted t into this block's partial sums
    if (worker) {
      const float w00 = s_w[0][c], w01 = s_w[1][c], w11 = s_w[2][c];
      for (int r = p; r < nact; r += P) {
        const int h = act[r];
        float tA, tB;
        row_sums<kPacked>(ms + h * row_bytes, W, fac, fbc, tA, tB);
        pA[(size_t)c * H + h] += w00 * tA + w01 * tB;
        pB[(size_t)c * H + h] += w01 * tA + w11 * tB;
      }
    }
    __syncthreads();
  }
  if (tid < C) dllp[((size_t)k * G + g) * C + tid] = s_dll[tid];
}

// dfX = fX * (sum over g of the partials) / total_n; dll = sum of partials
__global__ void em_finish_kernel(const float* __restrict__ part,
                                 const float* __restrict__ dllp,
                                 const float* __restrict__ fA,
                                 const float* __restrict__ fB,
                                 float* __restrict__ dfA,
                                 float* __restrict__ dfB,
                                 float* __restrict__ dll, int K, int C, int H,
                                 int G, float total_n) {
  const size_t CH = (size_t)C * H;
  const size_t n = (size_t)K * CH;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const size_t k = i / CH, ch = i - k * CH;
    const float* pk = part + k * G * 2 * CH + ch;
    float a = 0.f, b = 0.f;
    for (int g = 0; g < G; ++g) {
      a += pk[(size_t)g * 2 * CH];
      b += pk[(size_t)g * 2 * CH + CH];
    }
    dfA[i] = fA[i] * a / total_n;
    dfB[i] = fB[i] * b / total_n;
  }
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (size_t)K * C; i += stride) {
    const size_t k = i / C, c = i - k * C;
    float v = 0.f;
    for (int g = 0; g < G; ++g) v += dllp[(k * G + g) * C + c];
    dll[i] = v;
  }
}

}  // namespace

// mask: int8 [K,S,H,H] (packed = 0) or uint8 [K,S,H,H/8] (packed = 1);
// fA, fB: f32 [K,C,H]; gc: int8 [K,C,S]; B: f32 [K,S];
// part: f32 [K,G,2,C,H] and dllp: f32 [K,G,C] scratch;
// dfA, dfB: f32 [K,C,H]; dll: f32 [K,C].
extern "C" int hibag_em_estep(const void* mask, const void* fA, const void* fB,
                              const void* gc, const void* B, void* part,
                              void* dllp, void* dfA, void* dfB, void* dll,
                              int K, int S, int H, int C, int G, int packed,
                              float total_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)H * (sizeof(int) + 1);
  const dim3 grid(G, K);
  if (packed) {
    em_estep_kernel<true><<<grid, kThreads, smem, st>>>(
        static_cast<const uint8_t*>(mask), static_cast<const float*>(fA),
        static_cast<const float*>(fB), static_cast<const int8_t*>(gc),
        static_cast<const float*>(B), static_cast<float*>(part),
        static_cast<float*>(dllp), S, H, C, G);
  } else {
    em_estep_kernel<false><<<grid, kThreads, smem, st>>>(
        static_cast<const uint8_t*>(mask), static_cast<const float*>(fA),
        static_cast<const float*>(fB), static_cast<const int8_t*>(gc),
        static_cast<const float*>(B), static_cast<float*>(part),
        static_cast<float*>(dllp), S, H, C, G);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)K * C * H;
  const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  em_finish_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(dllp),
      static_cast<const float*>(fA), static_cast<const float*>(fB),
      static_cast<float*>(dfA), static_cast<float*>(dfB),
      static_cast<float*>(dll), K, C, H, G, total_n);
  return (int)cudaGetLastError();
}
