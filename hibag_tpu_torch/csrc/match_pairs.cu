// Matched-pair masks of the EM (the minimum-distance pairs of each sample
// within its two allele blocks) for K classifiers, NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: hibag_tpu matches pairs in jnp
// (hibag_tpu/models/em.py:88 match_pairs, :139 match_pairs_packed), which
// XLA fuses. The port's plain version (models/em.py::match_pairs,
// engine="torch") loops over classifiers and sample chunks, some 35 small
// PyTorch operations a chunk (a float32 GEMM for the distances, where,
// amin, ==, &): at the training cell's step (K = 8, S = 1,000, H = 256)
// 128 chunks, thousands of launches of a few microseconds with the card
// idle between them. This kernel writes the whole mask in one launch.
//
// What it computes, for classifier k and sample s with alleles a1 <= a2:
// ok1 = the valid slots of allele a1, ok2 = those of a2; with the masked
// XOR-popcount distance of csrc/pair_cells.cuh (obs0/1/2 the sample's
// g==0/1/2 bits from ballots over its codes; codes >= 3 add 0)
//   D_ij = a_i + a_j + nhet - popc((h_i & obs1) ^ (h_j & obs1)),
//   a_i  = popc(h_i & obs0) + popc(~h_i & obs2),  nhet = popc(obs1),
// dmin = min of D over ok1 x ok2, and
//   M[i][j] = 1 iff ((i in ok1 and j in ok2) or (i in ok2 and j in ok1))
//                   and D_ij == dmin,
// all zeros when either block is empty. The plain version's float32 D is
// the same small integer, so the masks are equal bitwise.
//
// What bounds it on the H100: the write. The mask is K*n*H*H bytes as int8
// (524 MB at K = 8, n = 1,000, H = 256: 0.157 ms at 3.35 TB/s) or an
// eighth of that bit-packed, and almost all of it is zeros: a sample's set
// entries are its minimum pairs, a handful. So the mask is written as
// zeros at the rate of plain 16-byte stores, neighbouring threads on
// neighbouring addresses, and the set entries are scattered over them:
//  * match_kernel, a block per (classifier, sample). Where the sample's
//    slab of the mask (H*H bytes, or H*H/8) is at most kFillSlab, the block
//    first stores its slab as zeros itself, and the stores drain while the
//    block works on; past that, match_zero_kernel stores the whole mask as
//    zeros over the whole card first (a few samples of a wide classifier
//    would otherwise leave most SMs idle).
//  * The block marks the sample's ok1 and ok2 slots in two bitmaps (warp
//    ballots over the slots), builds member records (x, a, slot) in shared
//    memory, kCap slots of each list at a time, and takes dmin over the
//    block pairs only: no popcount outside the blocks. The integer minimum
//    is order-free, so the result is bitwise repeatable.
//  * Then the same pairs again: where D == dmin it sets M[i][j] and M[j][i]
//    (int8: a byte store of 1; packed: an atomicOr of the bit into its
//    32-bit word, bit b of word w being column 32w + b, which on the
//    little-endian card is _pack_mask's order: bit b of byte i is column
//    8i + b). A barrier orders the block's zero stores before its own set
//    entries.
// Limits: H a multiple of 32 up to 65,536 (a sample's bitmaps sit in
// shared memory), K up to 65,535 (a grid dimension).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "launch_marks.cuh"

namespace {

constexpr int kL = 128;              // SNP slots per classifier
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 65536;
constexpr int kCap = 512;            // slots of a list range in shared memory
constexpr int kNoPair = INT_MAX;     // dmin of an empty block
constexpr size_t kFillSlab = 256 * 1024;  // slabs a block stores as zeros

// One sample's g==0/1/2 bits, word w of each.
struct Obs {
  unsigned m[3][4];
};

// Member records of one range of each list: x = h & obs1, a, the slot.
struct Lists {
  uint4 x[2][kCap];
  int a[2][kCap];
  int slot[2][kCap];
};

// The sample's masks from its kL codes g: warp w < 4 ballots word w.
__device__ __forceinline__ void ballot_obs(const int8_t* __restrict__ g,
                                           Obs& obs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kL / 32) {
    const int code = g[32 * warp + lane];
    const unsigned b0 = __ballot_sync(kFull, code == 0);
    const unsigned b1 = __ballot_sync(kFull, code == 1);
    const unsigned b2 = __ballot_sync(kFull, code == 2);
    if (lane == 0) {
      obs.m[0][warp] = b0;
      obs.m[1][warp] = b1;
      obs.m[2][warp] = b2;
    }
  }
}

__device__ __forceinline__ int het_count(const Obs& o) {
  return __popc(o.m[1][0]) + __popc(o.m[1][1]) + __popc(o.m[1][2])
         + __popc(o.m[1][3]);
}

// Slot h's record against the sample: x = h & obs1 and the return value
// a = popc(h & obs0) + popc(~h & obs2).
__device__ __forceinline__ int slot_record(const uint4 h, const Obs& o,
                                           uint4& x) {
  x = make_uint4(h.x & o.m[1][0], h.y & o.m[1][1], h.z & o.m[1][2],
                 h.w & o.m[1][3]);
  return __popc(h.x & o.m[0][0]) + __popc(~h.x & o.m[2][0])
         + __popc(h.y & o.m[0][1]) + __popc(~h.y & o.m[2][1])
         + __popc(h.z & o.m[0][2]) + __popc(~h.z & o.m[2][2])
         + __popc(h.w & o.m[0][3]) + __popc(~h.w & o.m[2][3]);
}

__device__ __forceinline__ int het_xor(const uint4 x, const uint4 y) {
  return __popc(x.x ^ y.x) + __popc(x.y ^ y.y) + __popc(x.z ^ y.z)
         + __popc(x.w ^ y.w);
}

// The records of list l's members (bitmap bm, shared) among slots
// [r, r + kCap), compacted in slot order; returns their count (the same in
// every thread).
__device__ __forceinline__ int build_list(const unsigned* bm, int r, int H,
                                          const uint4* __restrict__ hbk,
                                          const Obs& o, Lists& L, int l) {
  const int end = min(r + kCap, H);
  const int w0 = r >> 5, w1 = end >> 5;
  int c = 0;
  for (int w = w0; w < w1; ++w) c += __popc(bm[w]);
  if (!c) return 0;
  for (int j = r + (int)threadIdx.x; j < end; j += kThreads) {
    const unsigned word = bm[j >> 5];
    if ((word >> (j & 31)) & 1u) {
      int pos = __popc(word & ((1u << (j & 31)) - 1u));
      for (int w = w0; w < (j >> 5); ++w) pos += __popc(bm[w]);
      L.a[l][pos] = slot_record(hbk[j], o, L.x[l][pos]);
      L.slot[l][pos] = j;
    }
  }
  return c;
}

// f(i, j) for every pair of list-1 record i and list-2 record j, over all
// ranges of both lists (barriers around each range pair, reached by the
// whole block).
template <class F>
__device__ __forceinline__ void walk_pairs(const unsigned* bm1,
                                           const unsigned* bm2, int H,
                                           const uint4* __restrict__ hbk,
                                           const Obs& o, Lists& L, F f) {
  for (int r1 = 0; r1 < H; r1 += kCap) {
    const int n1 = build_list(bm1, r1, H, hbk, o, L, 0);
    if (!n1) continue;
    for (int r2 = 0; r2 < H; r2 += kCap) {
      const int n2 = build_list(bm2, r2, H, hbk, o, L, 1);
      if (!n2) continue;
      __syncthreads();
      for (int p = threadIdx.x; p < n1 * n2; p += kThreads) {
        const int i = p / n2;
        f(i, p - i * n2);
      }
      __syncthreads();  // before either list is written again
    }
  }
}

// Stores n16 16-byte zeros at p, the block's threads on neighbouring ones.
__device__ __forceinline__ void store_zeros(uint4* __restrict__ p,
                                            size_t n16, size_t t,
                                            size_t stride) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (size_t q = t; q < n16; q += stride) p[q] = zero;
}

// The whole mask as zeros, grid-stride.
__global__ void __launch_bounds__(256)
match_zero_kernel(uint4* __restrict__ out, size_t n16) {
  store_zeros(out, n16, (size_t)blockIdx.x * blockDim.x + threadIdx.x,
              (size_t)gridDim.x * blockDim.x);
}

// hb: [K][H] uint4, a slot's 128 bits (ops/train_step.py::pack_bits);
// valid: [K][H] bytes 0/1; allele: [K][H]; geno: int8 [K][S][kL]; a1, a2:
// [S]; out: the mask, int8 [K][n][H][H] or (packed) uint8 [K][n][H][H/8],
// 16-byte aligned, all zeros already unless `fill`. Block (s, k) takes
// sample lo + s of classifier k. Dynamic shared memory: the two bitmaps,
// 2 * H / 32 words.
__global__ void __launch_bounds__(kThreads)
match_kernel(const uint4* __restrict__ hb, const uint8_t* __restrict__ valid,
             const int* __restrict__ allele,
             const int8_t* __restrict__ geno, const int* __restrict__ a1,
             const int* __restrict__ a2, int S, int H, int lo, int n,
             int packed, int fill, uint8_t* __restrict__ out) {
  extern __shared__ unsigned sbm[];  // ok1's H/32 words, then ok2's
  __shared__ Obs sobs;
  __shared__ Lists L;
  __shared__ int total[2];
  __shared__ int red[kWarps];
  const int k = blockIdx.y, s = blockIdx.x;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int W = H >> 5;
  const size_t ks = (size_t)k * n + s;
  const size_t row_bytes = packed ? (size_t)(H >> 3) : (size_t)H;
  uint8_t* slab = out + ks * H * row_bytes;
  if (fill)
    store_zeros(reinterpret_cast<uint4*>(slab), (H * row_bytes) >> 4, t,
                kThreads);
  if (t < 2) total[t] = 0;
  ballot_obs(geno + ((size_t)k * S + lo + s) * kL, sobs);
  __syncthreads();

  const int A1 = a1[lo + s], A2 = a2[lo + s];
  const uint8_t* vk = valid + (size_t)k * H;
  const int* ak = allele + (size_t)k * H;
  for (int w = warp; w < W; w += kWarps) {
    const int j = 32 * w + lane;
    const bool ok = vk[j] != 0;
    const int al = ak[j];
    const unsigned b1 = __ballot_sync(kFull, ok && al == A1);
    const unsigned b2 = __ballot_sync(kFull, ok && al == A2);
    if (lane == 0) {
      sbm[w] = b1;
      sbm[W + w] = b2;
      if (b1) atomicAdd(&total[0], __popc(b1));
      if (b2) atomicAdd(&total[1], __popc(b2));
    }
  }
  __syncthreads();
  if (!total[0] || !total[1]) return;  // an empty block: no entry is set

  const Obs o = sobs;
  const int nhet = het_count(o);
  const uint4* hbk = hb + (size_t)k * H;
  const unsigned *bm1 = sbm, *bm2 = sbm + W;
  const auto dist = [&](int i, int j) {
    return L.a[0][i] + L.a[1][j] + nhet - het_xor(L.x[0][i], L.x[1][j]);
  };
  int best = kNoPair;
  walk_pairs(bm1, bm2, H, hbk, o, L,
             [&](int i, int j) { best = min(best, dist(i, j)); });
  for (int off = 16; off; off >>= 1)
    best = min(best, __shfl_xor_sync(kFull, best, off));
  if (lane == 0) red[warp] = best;
  __syncthreads();
  int dm = red[0];
  for (int w = 1; w < kWarps; ++w) dm = min(dm, red[w]);

  walk_pairs(bm1, bm2, H, hbk, o, L, [&](int i, int j) {
    if (dist(i, j) != dm) return;
    const int si = L.slot[0][i], sj = L.slot[1][j];
    if (packed) {
      unsigned* words = reinterpret_cast<unsigned*>(slab);
      atomicOr(words + (size_t)si * (H >> 5) + (sj >> 5), 1u << (sj & 31));
      atomicOr(words + (size_t)sj * (H >> 5) + (si >> 5), 1u << (si & 31));
    } else {
      slab[(size_t)si * H + sj] = 1;
      slab[(size_t)sj * H + si] = 1;
    }
  });
}

}  // namespace

// hb: int32 [K,H,4] packed bits; valid: bool [K,H]; allele: int32 [K,H];
// geno: int8 [K,S,128]; a1, a2: int32 [S]; out: the mask of samples
// lo..lo+n-1, int8 [K,n,H,H] or (packed != 0) uint8 [K,n,H,H/8], 16-byte
// aligned, every byte written here; ev0, ev1: launch marks or null.
extern "C" int hibag_match_pairs(const void* hb, const void* valid,
                                 const void* allele, const void* geno,
                                 const void* a1, const void* a2, void* out,
                                 int K, int S, int H, int lo, int n,
                                 int packed, void* stream, void* ev0,
                                 void* ev1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % 32 || H < 32 || H > kMaxH || K < 1 || K > 65535 || n < 1
      || lo < 0 || lo + n > S)
    return (int)cudaErrorInvalidValue;
  const size_t slab = (size_t)H * (packed ? H / 8 : H);
  const int fill = slab <= kFillSlab;
  cudaError_t err;
  if ((err = launch_mark(ev0, st)) != cudaSuccess) return (int)err;
  if (!fill) {
    const size_t n16 = (size_t)K * n * slab / 16;
    const size_t blocks = (n16 + 255) / 256;
    match_zero_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16),
                        256, 0, st>>>(static_cast<uint4*>(out), n16);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  match_kernel<<<dim3(n, K), kThreads, 2 * (H / 32) * sizeof(unsigned),
                 st>>>(
      static_cast<const uint4*>(hb), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(allele), static_cast<const int8_t*>(geno),
      static_cast<const int*>(a1), static_cast<const int*>(a2), S, H, lo, n,
      packed, fill, static_cast<uint8_t*>(out));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_mark(ev1, st);
}
