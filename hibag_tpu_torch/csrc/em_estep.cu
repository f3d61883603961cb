// EM E+M step for all candidate SNPs of K classifiers, NVIDIA Hopper (sm_90a).
//
// Replaces hibag_tpu/ops/train_step_pallas.py::_em_kernel (int8 pair mask,
// entry em_estep_pallas; em_estep_kernel here) and ::_em_kernel_packed
// (bit-packed mask, entry em_estep_pallas_packed; em_packed_kernel here).
// For classifier k, candidate c and in-bag sample s with matched-pair mask
// M_s (symmetric, {0,1}) both compute
//   tX[c,h]  = sum_j M_s[h,j] fX[c,j]                      (X = A, B)
//   sXY[c]   = sum_h fX[c,h] tY[c,h]
//   psum[c]  = m00 s00 + m01 s01 + m01 s10 + m11 s11       (m: genotype selectors)
//   w        = B_s / max(psum, 1e-37)
//   dfA[c,h] = fA[c,h] sum_s (w m00 tA + w m01 tB) / total_n
//   dfB[c,h] = fB[c,h] sum_s (w m01 tA + w m11 tB) / total_n
//   dll[c]   = sum_s B_s log(max(psum, 1e-37))
// as hibag_tpu/models/em.py::_em_estep_chunk does.
//
// What bounds both on the H100: the mask stream. Every EM iteration reads
// the whole mask, S*H*H bytes per classifier as int8 (67 MB at K = 8,
// S = 1,024, H = 256) or S*H*H/8 packed (8.4 MB); the arithmetic is small,
// because the matched pairs of a sample are its minimum-distance pairs
// within two allele blocks, a handful of the H*H.
//
// The int8 kernel (em_estep_kernel):
//  * The mask is read once per sample in 32-column words, coalesced (two
//    16-byte loads per word). That pass only marks the rows with a set bit;
//    the rows are then compacted in increasing h.
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
//
// The bit-packed kernel (em_packed_kernel). Its bytes are an eighth of the
// int8 mask's, so a design that walks a block's samples one after another
// (a barrier chain and a serial row compaction per sample, rows re-read 2C
// times) is held by that chain, not by the bytes. Here:
//  * A warp per sample, a batch of kPkWarps samples per block at once. The
//    warp reads the sample's packed rows coalesced, 16 bytes a lane, a few
//    loads in flight; a ballot skips all-zero stretches, a shuffle prefix
//    of the lanes' __popc counts ranks each lane's set bits, and the set
//    pairs (h, j) go
//    once into the warp's list in shared memory in increasing (h, j), the
//    active rows into a bitmask. No barrier and no serial scan per sample.
//  * Lanes take candidates (two a lane at C > 32). Each lane walks the list
//    once, summing tA and tB per row and folding each row into its own
//    candidate's s-sums, then computes psum, w and the dll term: no
//    cross-thread reduction. The frequencies sit in shared memory as
//    [j][c] pairs, so the lanes of a column read one stretch.
//  * A sample with more pairs than the list holds (an all-missing sample,
//    or any sample at an early growth step with few SNPs, matches whole
//    allele blocks) is taken by the whole block after the batch's lists:
//    its active rows are compacted, summed kRowChunk rows at a time by all
//    threads (a row and candidate each) from the mask in device memory,
//    and folded by a thread a candidate in increasing h. The order of sums
//    is the list's, so results do not depend on the list's size, and one
//    warp never walks thousands of pairs while the block waits.
//  * After a barrier, the batch's contributions are added sample by sample
//    in order: for a listed sample, thread (c, p) adds the rows
//    h = p (mod 256 / C) of candidate c; a sample taken by the block is
//    added by all threads, a row and candidate each, between barriers. One
//    writer and a fixed order for each (c, h), no float atomics. The
//    accumulator [2][C][H] is in shared memory where it and the frequencies
//    fit, else in the block's slice of the partial buffer (the same sums,
//    bitwise). Two barriers per batch, none per listed sample.
//  * Contributions go only to active rows. A block writes back only the
//    rows its samples touched, with a row bitmask per block; the finish
//    kernel reads only those rows of the G slices, in order g = 0..G-1.
//  * A block owns R samples of one classifier; G = ceil(S / R) and R depend
//    on S only (ops/train_step.py::em_packed_plan), so a classifier's sums
//    do not depend on the batch K it is trained in. All products and sums
//    are explicitly rounded (no contraction that could differ between the
//    list and the block-wide row sums).
//  * K is a grid dimension: each classifier has its own mask, fA/fB, B.
//  * Exactly C candidates: no candidate padding.
// Limits: H a multiple of 32, H <= 65,536 (the row and pair lists hold slot
// indices in 16 bits; the shared memory of both kernels grows with H: the
// int8 kernel's row list and flags 3 bytes a slot, the packed kernel's row
// bitmasks and row list; past 48 KB it is asked for), 1 <= C <= 64.

#include <cuda_runtime.h>
#include <cstdint>

#include "launch_marks.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned load_word(const uint8_t* row, int w) {
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
__device__ __forceinline__ void row_sums(const uint8_t* row, int W,
                                         const float* __restrict__ fa,
                                         const float* __restrict__ fb,
                                         float& tA, float& tB) {
  tA = 0.f;
  tB = 0.f;
  for (int w = 0; w < W; ++w) {
    unsigned m = load_word(row, w);
    while (m) {
      const int j = 32 * w + __ffs(m) - 1;
      m &= m - 1;
      tA += __ldg(fa + j);
      tB += __ldg(fb + j);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
em_estep_kernel(const uint8_t* __restrict__ mask, const float* __restrict__ fA,
                const float* __restrict__ fB, const int8_t* __restrict__ gc,
                const float* __restrict__ Bw, float* __restrict__ part,
                float* __restrict__ dllp, int S, int H, int C, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* act = reinterpret_cast<unsigned short*>(smem);  // [H]
  unsigned char* active = smem + sizeof(unsigned short) * H;      // [H]
  __shared__ float red[4][kThreads];
  __shared__ int s_off[kThreads];
  __shared__ int s_nact;
  __shared__ float s_w[3][64];
  __shared__ float s_dll[64];

  const int g = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int chunk = (S + G - 1) / G;
  const int s0 = min(S, g * chunk), s1 = min(S, s0 + chunk);
  const int W = H / 32;
  const size_t row_bytes = H;
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
      if (load_word(ms + (size_t)h * row_bytes, w)) active[h] = 1;
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
        if (active[h]) act[o++] = (unsigned short)h;
    }
    __syncthreads();
    const int nact = s_nact;

    // s-sums: this thread's share of candidate c's active rows
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
    if (worker) {
      for (int r = p; r < nact; r += P) {
        const int h = act[r];
        float tA, tB;
        row_sums(ms + (size_t)h * row_bytes, W, fac, fbc, tA, tB);
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
        row_sums(ms + (size_t)h * row_bytes, W, fac, fbc, tA, tB);
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

// ---------------------------------------------------------------------------
// bit-packed mask
// ---------------------------------------------------------------------------

constexpr int kPkWarps = 8;
constexpr int kPkThreads = 32 * kPkWarps;
constexpr unsigned kFull = 0xffffffffu;
// 16-byte mask loads a lane keeps in flight, and slices the finish kernel
// reads at once
constexpr int kPkLoads = 8;
constexpr int kFinishLoads = 8;
// how a batch takes a sample: not at all (B = 0 or past the run), by its
// warp from the warp's pair list, or by the whole block walking the active
// rows in device memory (more pairs than the list holds)
constexpr int kSkip = 0, kList = 1, kRows = 2;
// rows of such a sample summed at once (all threads, a row and candidate
// each) before a thread a candidate folds them
constexpr int kRowChunk = 32;

// The dynamic shared memory's layout, in bytes from its start. With
// `shared` the frequencies and the accumulator are here too.
struct PkLayout {
  size_t fs, acc, rt, sw, dll, rm, bm, meta, list, hl, rs, end;
  __host__ __device__ PkLayout(int H, int C, int lcap, bool shared) {
    const size_t CH = (size_t)C * H, W32 = H / 32;
    fs = 0;                                     // float2 [H][C]: fA, fB
    acc = fs + (shared ? 8 * CH : 0);           // float [2][C][H]
    rt = acc + (shared ? 8 * CH : 0);           // float2 [kRowChunk][C]
    sw = rt + 8 * kRowChunk * (size_t)C;        // float [warp][4][C]
    dll = sw + 16 * (size_t)kPkWarps * C;       // float [C]
    rm = dll + 4 * (size_t)C;                   // unsigned [warp][W32]
    bm = rm + 4 * (size_t)kPkWarps * W32;       // unsigned [W32]
    meta = bm + 4 * W32;                        // int [warp][2] + [1]
    list = meta + 4 * (2 * (size_t)kPkWarps + 1);  // unsigned [warp][lcap]
    hl = list + 4 * (size_t)kPkWarps * lcap;    // uint16 [H]: active rows
    rs = hl + 2 * (size_t)H;                    // uint16 [warp][lcap + 1]
    end = rs + 2 * (size_t)kPkWarps * (lcap + 1);
  }
};

struct PkArgs {
  const unsigned* mask;  // [K, S, H, H/32] words: bit i of word w = column 32w+i
  const float* fA;       // [K, C, H]
  const float* fB;
  const int8_t* gc;      // [K, C, S]
  const float* bw;       // [K, S]
  float* part;           // [K, G, 2, C, H], touched rows only
  float* dllp;           // [K, G, C]
  unsigned* tmask;       // [K, G, H/32] touched rows
  int S, H, C, G, R, lcap;
};

// Candidate c's fA and fB of slot j: from shared memory ([j][c]) or from
// device memory ([c][j]).
template <bool kShared>
struct Freq {
  const float2* fs;
  const float* fa;
  const float* fb;
  int C, H;
  __device__ __forceinline__ float2 at(int c, int j) const {
    if (kShared) return fs[(size_t)j * C + c];
    return make_float2(__ldg(fa + (size_t)c * H + j),
                       __ldg(fb + (size_t)c * H + j));
  }
};

// tA, tB of candidate c over the set columns of one mask row (in device
// or shared memory), in increasing j (4 words in flight)
template <bool kShared>
__device__ __forceinline__ float2 mask_row_sums(const unsigned* row, int W32,
                                                const Freq<kShared>& f, int c) {
  float tA = 0.f, tB = 0.f;
  for (int w0 = 0; w0 < W32; w0 += 4) {
    unsigned m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) m[u] = w0 + u < W32 ? row[w0 + u] : 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      for (unsigned b = m[u]; b; b &= b - 1) {
        const float2 v = f.at(c, 32 * (w0 + u) + __ffs(b) - 1);
        tA = __fadd_rn(tA, v.x);
        tB = __fadd_rn(tB, v.y);
      }
  }
  return make_float2(tA, tB);
}

// row h's sums t = (tA, tB) into the s-sums x (s00, s01, s10, s11), with
// fh = (fA, fB) of slot h
__device__ __forceinline__ void fold_row(float* x, float2 fh, float2 t) {
  x[0] = __fmaf_rn(fh.x, t.x, x[0]);
  x[1] = __fmaf_rn(fh.x, t.y, x[1]);
  x[2] = __fmaf_rn(fh.y, t.x, x[2]);
  x[3] = __fmaf_rn(fh.y, t.y, x[3]);
}

// candidate c's weights w00, w01, w11 and dll term from its s-sums x, the
// sample's count b and the candidate's genotype code, into sv [4][C]
__device__ __forceinline__ void sample_weights(const float* x, float b,
                                               int code, float* sv, int C,
                                               int c) {
  const bool na = code < 0 || code > 2;
  const float m00 = (code == 0 || na) ? 1.f : 0.f;
  const float m01 = (code == 1 || na) ? 1.f : 0.f;
  const float m11 = (code == 2 || na) ? 1.f : 0.f;
  const float psum = __fmaf_rn(
      m11, x[3], __fmaf_rn(m01, x[2], __fmaf_rn(m01, x[1], __fmul_rn(m00, x[0]))));
  const float ps = fmaxf(psum, 1e-37f);
  const float wgt = __fdiv_rn(b, ps);
  sv[c] = __fmul_rn(wgt, m00);
  sv[C + c] = __fmul_rn(wgt, m01);
  sv[2 * C + c] = __fmul_rn(wgt, m11);
  sv[3 * C + c] = __fmul_rn(b, logf(ps));
}

// Warp 0: the active rows of row bitmask rmx in increasing h into hl, and
// their count into *n (the caller syncs before reading either).
__device__ __forceinline__ void compact_rows(const unsigned* rmx, int W32,
                                             unsigned short* hl, int* n,
                                             int lane) {
  int base = 0;
  for (int i0 = 0; i0 < W32; i0 += 32) {
    const int i = i0 + lane;
    const unsigned bits = i < W32 ? rmx[i] : 0u;
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    int pos = base + incl - cnt;
    for (unsigned r = bits; r; r &= r - 1)
      hl[pos++] = (unsigned short)(32 * i + __ffs(r) - 1);
    base += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) *n = base;
}

// One warp: the rows of sample mask `ms` with a set bit into the bitmask
// `rmw`, and its set pairs (h, j) as h << 16 | j into `list` in increasing
// (h, j) while they fit `lcap`. Returns the pair count, or -1 when the
// pairs do not fit (the caller then walks the rows).
__device__ int extract_pairs(const unsigned* __restrict__ ms, int H, int W32,
                             int lcap, unsigned* rmw, unsigned* list,
                             int lane) {
  for (int i = lane; i < W32; i += 32) rmw[i] = 0u;
  __syncwarp();
  const uint4* q4 = reinterpret_cast<const uint4*>(ms);
  const int nq = H * W32 / 4;  // 16-byte loads: 4 words each
  int total = 0;
  bool fits = true;
  for (int q0 = 0; q0 < nq; q0 += kPkLoads * 32) {
    uint4 v[kPkLoads];
#pragma unroll
    for (int u = 0; u < kPkLoads; ++u) {
      const int q = q0 + 32 * u + lane;
      v[u] = q < nq ? __ldg(q4 + q) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kPkLoads; ++u) {
      const unsigned wd[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      const int cnt = __popc(wd[0]) + __popc(wd[1]) + __popc(wd[2])
                      + __popc(wd[3]);
      if (!__ballot_sync(kFull, cnt != 0)) continue;
      // rank: an inclusive prefix of the lanes' set-bit counts
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      const int below = incl - cnt;
      const int step = __shfl_sync(kFull, incl, 31);
      fits = fits && total + step <= lcap;
      if (cnt) {
        const int q = q0 + 32 * u + lane;
        int pos = total + below;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned m = wd[i];
          if (!m) continue;
          const int word = 4 * q + i, h = word / W32;
          const unsigned col = 32u * (unsigned)(word - h * W32);
          atomicOr(rmw + (h >> 5), 1u << (h & 31));
          if (fits)
            for (; m; m &= m - 1)
              list[pos++] = (unsigned)h << 16 | (col + __ffs(m) - 1);
        }
      }
      total += step;
    }
  }
  __syncwarp();
  return fits ? total : -1;
}

template <bool kShared>
__global__ void __launch_bounds__(kPkThreads) em_packed_kernel(PkArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, C = p.C, S = p.S, W32 = H / 32, lcap = p.lcap;
  const PkLayout L(H, C, lcap, kShared);
  float2* fs = reinterpret_cast<float2*>(smem + L.fs);
  float2* rt = reinterpret_cast<float2*>(smem + L.rt);
  unsigned short* hl = reinterpret_cast<unsigned short*>(smem + L.hl);
  float* sw = reinterpret_cast<float*>(smem + L.sw);
  float* sdll = reinterpret_cast<float*>(smem + L.dll);
  unsigned* rm = reinterpret_cast<unsigned*>(smem + L.rm);
  unsigned* bm = reinterpret_cast<unsigned*>(smem + L.bm);
  int* meta = reinterpret_cast<int*>(smem + L.meta);
  int* nhl = meta + 2 * kPkWarps;  // rows in hl
  unsigned* lists = reinterpret_cast<unsigned*>(smem + L.list);
  unsigned short* rss = reinterpret_cast<unsigned short*>(smem + L.rs);

  const int g = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int CH = C * H;
  const float* fAk = p.fA + (size_t)k * CH;
  const float* fBk = p.fB + (size_t)k * CH;
  float* slice = p.part + ((size_t)k * p.G + g) * 2 * CH;
  float* acc = kShared ? reinterpret_cast<float*>(smem + L.acc) : slice;
  const size_t sample_words = (size_t)H * W32;
  const unsigned* mk = p.mask + (size_t)k * S * sample_words;
  const int s0 = g * p.R, s1 = min(S, s0 + p.R);

  for (int i = tid; i < 2 * CH; i += kPkThreads) acc[i] = 0.f;
  if (kShared)
    for (int i = tid; i < CH; i += kPkThreads) {
      const int c = i / H, j = i - c * H;
      fs[(size_t)j * C + c] = make_float2(fAk[i], fBk[i]);
    }
  for (int i = tid; i < W32; i += kPkThreads) bm[i] = 0u;
  for (int i = tid; i < C; i += kPkThreads) sdll[i] = 0.f;
  const Freq<kShared> f{fs, fAk, fBk, C, H};
  __syncthreads();

  unsigned* rmw = rm + (size_t)wid * W32;
  unsigned* list = lists + (size_t)wid * lcap;
  unsigned short* rs = rss + (size_t)wid * (lcap + 1);
  float* sww = sw + (size_t)wid * 4 * C;
  const bool two = C > 32;
  const int c0 = min(lane, C - 1), c1 = min(lane + 32, C - 1);
  const int P = kPkThreads / C;  // row parts per candidate in the adding
  const int pc = tid % C, pp = tid / C;

  for (int sb = s0; sb < s1; sb += kPkWarps) {
    // -- phase 1: warp wid takes sample sb + wid
    const int s = sb + wid;
    const float b = s < s1 ? p.bw[(size_t)k * S + s] : 0.f;
    int mode = kSkip, nr = 0;
    if (b != 0.f) {
      const unsigned* ms = mk + (size_t)s * sample_words;
      const int npair = extract_pairs(ms, H, W32, lcap, rmw, list, lane);
      if (npair < 0) {
        mode = kRows;
      } else {
        mode = kList;
        float x[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float2 t0 = make_float2(0.f, 0.f), t1 = t0;
        int cur = -1;
        for (int e = 0; e <= npair; ++e) {
          const unsigned v = e < npair ? list[e] : 0xffffffffu;
          const int h = (int)(v >> 16);
          if (h != cur) {
            if (cur >= 0) {
              fold_row(x[0], f.at(c0, cur), t0);
              if (two) fold_row(x[1], f.at(c1, cur), t1);
            }
            if (e == npair) break;
            cur = h;
            t0 = t1 = make_float2(0.f, 0.f);
            if (lane == 0) rs[nr] = (unsigned short)e;
            ++nr;
          }
          const int j = (int)(v & 0xffffu);
          const float2 v0 = f.at(c0, j);
          t0 = make_float2(__fadd_rn(t0.x, v0.x), __fadd_rn(t0.y, v0.y));
          if (two) {
            const float2 v1 = f.at(c1, j);
            t1 = make_float2(__fadd_rn(t1.x, v1.x), __fadd_rn(t1.y, v1.y));
          }
        }
        if (lane == 0) rs[nr] = (unsigned short)npair;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t;
          if (c < C)
            sample_weights(x[t], b, p.gc[((size_t)k * C + c) * S + s], sww, C,
                           c);
        }
      }
    }
    if (lane == 0) {
      meta[2 * wid] = mode;
      meta[2 * wid + 1] = nr;
    }
    __syncthreads();

    // -- samples with more pairs than a list holds, in order, by the whole
    // block: their active rows compacted (warp 0), then kRowChunk rows at a
    // time summed by all threads (a row and candidate each) into rt, and
    // folded by a thread a candidate in increasing h (the list's order)
    bool rows_pass = false;
    for (int w = 0; w < kPkWarps; ++w) {
      if (meta[2 * w] != kRows) continue;
      rows_pass = true;
      const int sr = sb + w;
      const unsigned* ms = mk + (size_t)sr * sample_words;
      if (wid == 0) compact_rows(rm + (size_t)w * W32, W32, hl, nhl, lane);
      __syncthreads();
      const int nrow = *nhl;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r0 = 0; r0 < nrow; r0 += kRowChunk) {
        const int nr_ = min(kRowChunk, nrow - r0);
        for (int it = tid; it < nr_ * C; it += kPkThreads) {
          const int r = it / C, c = it - r * C;
          rt[it] = mask_row_sums(ms + (size_t)hl[r0 + r] * W32, W32, f, c);
        }
        __syncthreads();
        if (tid < C)
          for (int r = 0; r < nr_; ++r)
            fold_row(x, f.at(tid, hl[r0 + r]), rt[r * C + tid]);
        __syncthreads();
      }
      if (tid < C)
        sample_weights(x, p.bw[(size_t)k * S + sr],
                       p.gc[((size_t)k * C + tid) * S + sr],
                       sw + (size_t)w * 4 * C, C, tid);
    }
    if (rows_pass) __syncthreads();

    // -- phase 2: the batch's samples in order. A listed sample: thread
    // (pc, pp) adds rows h = pp (mod P) of candidate pc. A sample taken by
    // the block: all threads, a row and candidate each, between barriers.
    for (int w = 0; w < kPkWarps; ++w) {
      const int md = meta[2 * w];
      if (md == kSkip) continue;
      const float* sv = sw + (size_t)w * 4 * C;
      // (c, h) += contribution of row sums t, with candidate c's weights
      auto put = [&](int c, int h, float2 t) {
        float* a = acc + (size_t)c * H + h;
        const float w00 = sv[c], w01 = sv[C + c], w11 = sv[2 * C + c];
        a[0] = __fadd_rn(a[0], __fmaf_rn(w01, t.y, __fmul_rn(w00, t.x)));
        a[CH] = __fadd_rn(a[CH], __fmaf_rn(w11, t.y, __fmul_rn(w01, t.x)));
      };
      if (md == kRows) {
        const unsigned* ms = mk + (size_t)(sb + w) * sample_words;
        __syncthreads();  // the samples before it are added
        if (wid == 0) compact_rows(rm + (size_t)w * W32, W32, hl, nhl, lane);
        __syncthreads();
        const int nrow = *nhl;
        for (int it = tid; it < nrow * C; it += kPkThreads) {
          const int r = it / C, c = it - r * C;
          put(c, hl[r], mask_row_sums(ms + (size_t)hl[r] * W32, W32, f, c));
        }
        __syncthreads();
      } else if (pp < P) {
        const unsigned* lw = lists + (size_t)w * lcap;
        const unsigned short* rw = rss + (size_t)w * (lcap + 1);
        const int nrw = meta[2 * w + 1];
        for (int r = 0; r < nrw; ++r) {
          const int e0 = rw[r], e1 = rw[r + 1];
          const int h = (int)(lw[e0] >> 16);
          if (h % P != pp) continue;
          float2 t = make_float2(0.f, 0.f);
          for (int e = e0; e < e1; ++e) {
            const float2 v = f.at(pc, (int)(lw[e] & 0xffffu));
            t = make_float2(__fadd_rn(t.x, v.x), __fadd_rn(t.y, v.y));
          }
          put(pc, h, t);
        }
      }
      if (pp == 0) sdll[pc] = __fadd_rn(sdll[pc], sv[3 * C + pc]);
    }
    // the block's touched rows
    for (int i = tid; i < W32; i += kPkThreads) {
      unsigned u = bm[i];
      for (int w = 0; w < kPkWarps; ++w)
        if (meta[2 * w] != kSkip) u |= rm[(size_t)w * W32 + i];
      bm[i] = u;
    }
    __syncthreads();  // before the next batch rewrites lists, rows, weights
  }

  unsigned* tm = p.tmask + ((size_t)k * p.G + g) * W32;
  for (int i = tid; i < W32; i += kPkThreads) tm[i] = bm[i];
  if (kShared)
    for (int i = tid; i < 2 * CH; i += kPkThreads) {
      const int h = i % H;
      if ((bm[h >> 5] >> (h & 31)) & 1u) slice[i] = acc[i];
    }
  for (int c = tid; c < C; c += kPkThreads)
    p.dllp[((size_t)k * p.G + g) * C + c] = sdll[c];
}

// dfX = fX * (sum over the slices g that touched row h, in order) /
// total_n; dll = sum of the slices' partials
__global__ void em_packed_finish_kernel(
    const float* __restrict__ part, const float* __restrict__ dllp,
    const unsigned* __restrict__ tmask, const float* __restrict__ fA,
    const float* __restrict__ fB, float* __restrict__ dfA,
    float* __restrict__ dfB, float* __restrict__ dll, int K, int C, int H,
    int G, float total_n) {
  const size_t CH = (size_t)C * H;
  const size_t n = (size_t)K * CH;
  const int W32 = H / 32;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const size_t k = i / CH, ch = i - k * CH;
    const int h = (int)(ch % H);
    const float* pk = part + k * G * 2 * CH + ch;
    const unsigned* tk = tmask + k * G * W32 + (h >> 5);
    const unsigned bit = 1u << (h & 31);
    float a = 0.f, b = 0.f;
    // kFinishLoads slices at a time: their loads are independent
    for (int g0 = 0; g0 < G; g0 += kFinishLoads) {
      bool on[kFinishLoads];
      float va[kFinishLoads], vb[kFinishLoads];
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u)
        on[u] = g0 + u < G && (tk[(size_t)(g0 + u) * W32] & bit);
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u) {
        const size_t o = (size_t)(g0 + u) * 2 * CH;
        va[u] = on[u] ? pk[o] : 0.f;
        vb[u] = on[u] ? pk[o + CH] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u)
        if (on[u]) {
          a = __fadd_rn(a, va[u]);
          b = __fadd_rn(b, vb[u]);
        }
    }
    dfA[i] = fA[i] * a / total_n;
    dfB[i] = fB[i] * b / total_n;
  }
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (size_t)K * C; i += stride) {
    const size_t k = i / C, c = i - k * C;
    float v = 0.f;
    for (int g = 0; g < G; ++g) v = __fadd_rn(v, dllp[(k * G + g) * C + c]);
    dll[i] = v;
  }
}

template <bool kShared>
cudaError_t launch_packed(const PkArgs& p, int K, size_t smem,
                          cudaStream_t st, void* ev0) {
  cudaError_t err = cudaFuncSetAttribute(
      em_packed_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = launch_mark(ev0, st)) != cudaSuccess) return err;
  em_packed_kernel<kShared><<<dim3(p.G, K), kPkThreads, smem, st>>>(p);
  return cudaGetLastError();
}

int finish_blocks(size_t n) {
  return (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
}

}  // namespace

// mask: int8 [K,S,H,H]; fA, fB: f32 [K,C,H]; gc: int8 [K,C,S]; B: f32 [K,S];
// part: f32 [K,G,2,C,H] and dllp: f32 [K,G,C] scratch;
// dfA, dfB: f32 [K,C,H]; dll: f32 [K,C]; ev0, ev1: launch marks or null
// (launch_marks.cuh).
extern "C" int hibag_em_estep(const void* mask, const void* fA, const void* fB,
                              const void* gc, const void* B, void* part,
                              void* dllp, void* dfA, void* dfB, void* dll,
                              int K, int S, int H, int C, int G,
                              float total_n, void* stream, void* ev0,
                              void* ev1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 32 || H > 65536 || C < 1 || C > 64)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)H * (sizeof(unsigned short) + 1);
  cudaError_t err;
  if (smem > 48 * 1024) {  // past the default, asked for (H > 16,384)
    err = cudaFuncSetAttribute(em_estep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(G, K);
  if ((err = launch_mark(ev0, st)) != cudaSuccess) return (int)err;
  em_estep_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(mask), static_cast<const float*>(fA),
      static_cast<const float*>(fB), static_cast<const int8_t*>(gc),
      static_cast<const float*>(B), static_cast<float*>(part),
      static_cast<float*>(dllp), S, H, C, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  em_finish_kernel<<<finish_blocks((size_t)K * C * H), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(dllp),
      static_cast<const float*>(fA), static_cast<const float*>(fB),
      static_cast<float*>(dfA), static_cast<float*>(dfB),
      static_cast<float*>(dll), K, C, H, G, total_n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_mark(ev1, st);
}

// Bytes of dynamic shared memory of the packed kernel at H slots, C
// candidates and a pair list of lcap entries a warp, with the frequencies
// and the accumulator in shared memory or not.
extern "C" long long hibag_em_packed_smem(int H, int C, int lcap,
                                          int shared) {
  return (long long)PkLayout(H, C, lcap, shared != 0).end;
}

// mask: uint8 [K,S,H,H/8] (bit b of byte i = column 8i + b), 16-byte
// aligned; fA, fB: f32 [K,C,H]; gc: int8 [K,C,S]; B: f32 [K,S]; part: f32
// [K,G,2,C,H], dllp: f32 [K,G,C] and tmask: int32 [K,G,H/32] scratch (no
// zeroing needed); dfA, dfB: f32 [K,C,H]; dll: f32 [K,C]. Block (g, k)
// takes samples [g*R, (g+1)*R) of classifier k; lcap pairs a warp's list;
// ev0, ev1: launch marks or null.
extern "C" int hibag_em_packed(const void* mask, const void* fA,
                               const void* fB, const void* gc, const void* B,
                               void* part, void* dllp, void* tmask, void* dfA,
                               void* dfB, void* dll, int K, int S, int H,
                               int C, int G, int R, int lcap, int shared,
                               float total_n, void* stream, void* ev0,
                               void* ev1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 32 || H > 65536 || C < 1 || C > 64 || R < 1 || lcap < 0
      || lcap > 65535 || (size_t)G * R < (size_t)S)
    return (int)cudaErrorInvalidValue;
  PkArgs p;
  p.mask = static_cast<const unsigned*>(mask);
  p.fA = static_cast<const float*>(fA);
  p.fB = static_cast<const float*>(fB);
  p.gc = static_cast<const int8_t*>(gc);
  p.bw = static_cast<const float*>(B);
  p.part = static_cast<float*>(part);
  p.dllp = static_cast<float*>(dllp);
  p.tmask = static_cast<unsigned*>(tmask);
  p.S = S;
  p.H = H;
  p.C = C;
  p.G = G;
  p.R = R;
  p.lcap = lcap;
  const size_t smem = (size_t)hibag_em_packed_smem(H, C, lcap, shared);
  cudaError_t err = shared ? launch_packed<true>(p, K, smem, st, ev0)
                           : launch_packed<false>(p, K, smem, st, ev0);
  if (err != cudaSuccess) return (int)err;
  em_packed_finish_kernel<<<finish_blocks((size_t)K * C * H), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(dllp),
      static_cast<const unsigned*>(tmask), static_cast<const float*>(fA),
      static_cast<const float*>(fB), static_cast<float*>(dfA),
      static_cast<float*>(dfB), static_cast<float*>(dll), K, C, H, G,
      total_n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_mark(ev1, st);
}
