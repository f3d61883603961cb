"""Genotype–haplotype scoring in plain PyTorch (counterpart of
hibag_tpu/ops/scoring.py).

For a biallelic SNP with genotype g ∈ {0,1,2,NA} and the bits (b1, b2) of a
candidate haplotype pair, the reference's masked-XOR-popcount distance adds
b1+b2 for g=0, |b1+b2−1| for g=1, 2−b1−b2 for g=2 and 0 when missing. Summed
over SNPs, one sample's distance matrix is

    D = alpha + v·1ᵀ + 1·vᵀ + 2 · (H ∘ m1) Hᵀ

with alpha = Σ[g==1] + 2·Σ[g==2], u = [g==0] − [g==1] − [g==2], v = H u,
m1 = [g==1]. All terms are small integers, so the float32 matmuls are exact
(with TF32 off, see device.resolve_device).

The posterior over ordered allele pairs is S[A,B] = W[:,A]ᵀ·pen·W[:,B] with
W[h,A] = freq_h·[allele_h == A] and pen = exp(λ·(D − dmin)), λ = log 1e-5;
the per-sample minimum distance is factored out of the exponent and returned.

These are the plain versions the port's kernels are held against; they make
[N, H, H] intermediates and are meant for small blocks, the CPU and tests.
"""

from __future__ import annotations

import torch

from ..constants import LOG_MIN_RARE_FREQ

BIG = 1e9  # sentinel distance for invalid haplotype slots


def geno_coefficients(geno_codes: torch.Tensor, dtype=torch.float32):
    """(alpha [...], u [..., L], m1 [..., L]) in `dtype` from genotype codes
    [..., L] with values {0,1,2,3=missing}; padded SNP slots must be 3."""
    g = geno_codes
    is0 = g == 0
    is1 = g == 1
    is2 = g == 2
    u = is0.to(dtype) - is1.to(dtype) - is2.to(dtype)
    m1 = is1.to(dtype)
    alpha = is1.sum(-1).to(dtype) + 2.0 * is2.sum(-1).to(dtype)
    return alpha, u, m1


def pair_distance(hap_bits: torch.Tensor, geno_codes: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """D [N, H, H] (exact small integers) between all haplotype pairs of
    hap_bits [H, L] {0,1} and each sample of geno_codes [N, L]."""
    Hb = hap_bits.to(compute_dtype)
    alpha, u, m1 = geno_coefficients(geno_codes, compute_dtype)
    v = u @ Hb.T                                        # [N, H]
    cross = (Hb[None, :, :] * m1[:, None, :]) @ Hb.T    # [N, H, H]
    return alpha[:, None, None] + v[:, :, None] + v[:, None, :] + 2.0 * cross


def posterior_scores(hap_bits, hap_freq, hap_allele, geno_codes, n_alleles,
                     f64=False):
    """Posterior scores over ordered allele pairs for samples geno_codes
    [N, L] against ONE classifier: hap_bits [H, L], hap_freq [H] (0 for
    padded slots), hap_allele [H].

    Returns dict with S [N, A, A] (exp(λ·dmin) factor removed), dmin [N]
    (minimum distance over valid pairs) and total [N] = Σ S. `f64` computes
    the penalties and contractions in float64, as hibag_tpu does.
    """
    acc = torch.float64 if f64 else torch.float32
    D = pair_distance(hap_bits, geno_codes)
    valid = hap_freq > 0
    pair_ok = valid[:, None] & valid[None, :]
    Dm = torch.where(pair_ok[None], D, BIG)
    dmin = Dm.amin(dim=(1, 2))
    # the exponent is formed in float32 and widened, as in hibag_tpu
    pen = torch.exp((LOG_MIN_RARE_FREQ * (Dm - dmin[:, None, None])).to(acc))
    pen = torch.where(pair_ok[None], pen, 0.0)
    W = (torch.nn.functional.one_hot(hap_allele.long(), n_alleles).to(acc)
         * hap_freq[:, None].to(acc))                   # [H, A]
    S = W.T @ (pen @ W)                                 # [N, A, A]
    return {"S": S, "dmin": dmin, "total": S.sum(dim=(1, 2))}


def unordered_from_S(S: torch.Tensor) -> torch.Tensor:
    """Symmetric ordered-pair scores → unordered-pair convention
    (off-diagonal doubled, diagonal kept), still a full symmetric matrix."""
    A = S.shape[-1]
    eye = torch.eye(A, dtype=S.dtype, device=S.device)
    return S * (2.0 - eye)


def majority_hits(Q: torch.Tensor) -> torch.Tensor:
    """One-hot [n, A, A] of each sample's first row-major maximum of Q
    [n, A, A] (one classifier's vote), marked at both mirrors of the pair."""
    n, A = Q.shape[0], Q.shape[-1]
    b = Q.reshape(n, A * A).argmax(dim=1)
    hit = torch.zeros((n, A * A), dtype=Q.dtype, device=Q.device)
    hit.scatter_(1, b[:, None], 1.0)
    hit.scatter_(1, ((b % A) * A + b // A)[:, None], 1.0)
    return hit.reshape(n, A, A)
