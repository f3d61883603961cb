"""Plain reference of HLA prediction: HIBAG's ensemble posterior, best guess,
its probability and the matching proportion, in plain PyTorch.

It reads the model and the cohort as the benchmark made them (numpy arrays
from portbench/gen/synthetic.py), aligns the cohort to the model's SNPs by
position itself, and computes in the precision asked (float64 by default),
a block of samples and one classifier at a time. Semantics (HIBAG's
src/LibHLA.cpp:2317-2482 and R/HIBAG.R:470-818), for classifier c and
sample n:

* the distance of a haplotype pair (i, j) is the sum over c's SNPs with a
  call g of b_i + b_j (g = 0), |b_i + b_j - 1| (g = 1) or 2 - b_i - b_j
  (g = 2); missing calls add nothing;
* S[a, b] = sum over ordered pairs with alleles (a, b) of f_i f_j
  1e-5^(d_ij - dmin), dmin the least distance; total = sum of S;
* the classifier's weight w is the share of c's SNP weight (the number of
  classifiers using each SNP) that n has called;
* the posterior of the unordered pair {a, b} is sum_c w_c Q_c / total_c
  over sum_c w_c, Q = S with the off-diagonal doubled;
* the best guess is the first largest cell of the upper triangle in
  row-major order, its probability that cell; the matching is
  sum_c w_c total_c 1e-5^dmin_c over sum_c w_c.

Nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_MIN_RARE_FREQ = math.log(1e-5)


def align(model_pos, data_pos, data_geno):
    """codes [N, P_model] uint8: the cohort data_geno [P_data, N] taken to
    the model's SNPs by position (every SNP of the benchmark's data has the
    same allele pair as the model's, so no strand or allele switch
    arises); a model SNP absent from the data is missing (3)."""
    where = {int(p): i for i, p in enumerate(data_pos)}
    src = np.array([where.get(int(p), -1) for p in model_pos])
    codes = np.full((data_geno.shape[1], len(model_pos)), 3, dtype=np.uint8)
    ok = src >= 0
    codes[:, ok] = data_geno[src[ok]].T
    return codes


def pair_distance(bits, geno):
    """[n, H, H] distances (exact small integers, float64) between the
    haplotype pairs of bits [H, s] {0,1} and each sample's calls geno
    [n, s] {0,1,2,3}."""
    b = bits.to(torch.float64)
    g0 = (geno == 0).to(torch.float64)
    g1 = (geno == 1).to(torch.float64)
    g2 = (geno == 2).to(torch.float64)
    const = (g1 + 2 * g2).sum(-1)                       # [n]
    v = (g0 - g1 - g2) @ b.T                            # [n, H]
    cross = torch.einsum("il,nl,jl->nij", b, g1, b)     # [n, H, H]
    return const[:, None, None] + v[:, :, None] + v[:, None, :] + 2 * cross


def classifier_scores(bits, freq, allele, geno, n_alleles, dtype):
    """(S [n, A, A] ordered-pair scores with 1e-5^dmin factored out, dmin
    [n], total [n]) of one classifier: bits [H, s], freq [H] (> 0),
    allele [H], geno [n, s]. Products and sums in `dtype`."""
    D = pair_distance(bits, geno)
    dmin = D.amin(dim=(1, 2))
    pen = torch.exp(LOG_MIN_RARE_FREQ * (D - dmin[:, None, None])).to(dtype)
    W = (torch.nn.functional.one_hot(allele.long(), n_alleles).to(dtype)
         * freq.to(dtype)[:, None])                     # [H, A]
    S = torch.einsum("ha,nhj,jb->nab", W, pen, W)
    return S, dmin, S.sum(dim=(1, 2))


def _block_rows(n_hap_max: int) -> int:
    """Samples per block, so that a block's [n, H, H] tensors stay near
    1 GiB in float64."""
    return max(1, min(1024, (1 << 30) // (8 * 4 * n_hap_max ** 2 + 1)))


def predict(model, codes, device, dtype=torch.float64) -> dict:
    """The ensemble prediction of the samples `codes` [N, P_model] (aligned,
    uint8) by `model` (gen/synthetic.py's dict). Returns float64 numpy
    arrays: ``post`` [N, A(A+1)/2] (upper-triangle cells, row-major),
    ``best`` [N] (cell index, -1 where no call), ``prob`` [N] and
    ``matching`` [N]."""
    cls = model["classifiers"]
    A = len(model["alleles"])
    P = len(model["snp_position"])
    weight = np.zeros(P)
    for c in cls:
        weight[c["snp_index"]] += 1
    iu, ju = np.triu_indices(A)
    iu_t = torch.from_numpy(iu).to(device)
    ju_t = torch.from_numpy(ju).to(device)
    eye2 = 2.0 - torch.eye(A, dtype=dtype, device=device)
    N = codes.shape[0]
    step = _block_rows(max(len(c["hap_freq"]) for c in cls))
    out = {k: [] for k in ("post", "prob", "matching", "best")}
    tensors = [(torch.from_numpy(c["hap_bits"]).to(device),
                torch.from_numpy(c["hap_freq"]).to(device),
                torch.from_numpy(c["hap_allele"]).to(device),
                torch.from_numpy(c["snp_index"].astype(np.int64)).to(device),
                torch.from_numpy(weight[c["snp_index"]]).to(device, dtype))
               for c in cls]
    for lo in range(0, N, step):
        g_all = torch.from_numpy(codes[lo:lo + step]).to(device)
        n = g_all.shape[0]
        ens = torch.zeros((n, A, A), dtype=dtype, device=device)
        wsum = torch.zeros(n, dtype=dtype, device=device)
        msum = torch.zeros(n, dtype=torch.float64, device=device)
        for bits, freq, allele, sidx, sw in tensors:
            g = g_all[:, sidx]
            w = ((g != 3).to(dtype) @ sw) / sw.sum()
            S, dmin, total = classifier_scores(bits, freq, allele, g, A,
                                               dtype)
            ens += w[:, None, None] * S * eye2 / total[:, None, None]
            wsum += w
            msum += (w.to(torch.float64) * total.to(torch.float64)
                     * torch.exp(LOG_MIN_RARE_FREQ * dmin))
        ens = ens / wsum[:, None, None]
        tri = ens[:, iu_t, ju_t]
        best = tri.argmax(dim=1)
        prob = tri.gather(1, best[:, None])[:, 0]
        ok = (prob > 0) & (wsum > 0)
        out["post"].append(tri.double().cpu())
        out["prob"].append(torch.where(ok, prob, 0).double().cpu())
        out["best"].append(torch.where(ok, best, -1).cpu())
        out["matching"].append((msum / wsum.double()).cpu())
    return {k: torch.cat(v).numpy() for k, v in out.items()}
