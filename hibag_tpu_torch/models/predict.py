"""Ensemble HLA-type prediction in PyTorch (counterpart of
hibag_tpu/models/predict.py, single device).

Per classifier c and sample n (reference semantics, src/LibHLA.cpp:2317-2482):
  * classifier weight w[n,c] = Σ snp_weight over c's non-missing SNPs in n,
    normalized by Σ snp_weight over all c's SNPs
  * ensemble prob = Σ_c w·posterior / Σ_c w                (vote="prob")
  * majority vote: one-hot of per-classifier best guess, weight 1
  * matching[n] = Σ_c w·normalizer / Σ_c w
  * dosage[A] = 2·P[A,A] + Σ_{B≠A} P{A,B}

Two engines:
  * "auto" (the default): all classifiers of a sample block in one call of
    ops.ens_acc.ensemble_accumulate — the CUDA kernel on a card, its plain
    PyTorch version on the CPU;
  * "scan": a loop over classifiers through ops.scoring.posterior_scores,
    which `dtype=np.float64` selects as the reference-precision path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..constants import GENO_MISSING, LOG_MIN_RARE_FREQ, MAXNUM_SNP
from ..device import resolve_device
from ..ops.ens_acc import PackedHaplotypes, ensemble_accumulate
from ..ops.scoring import (majority_hits, posterior_scores,
                            unordered_from_S)
from .convert import ensemble_from_packed
from .model import AttrBagModel, IdCache


def _log_match(w, total, dmin):
    """log(w · total · exp(λ·dmin)), −inf where the classifier has no
    weight."""
    lm = torch.log(w.clamp_min(1e-30)) + torch.log(total) \
        + LOG_MIN_RARE_FREQ * dmin
    return torch.where(w > 0, lm, -torch.inf)


def _one_classifier_fn(geno_codes, snp_weight, n_alleles, vote, acc_dt):
    """Per-classifier prediction closure of the scan engine.

    Returns a function (bits, freq, allele, sidx) ->
    (contrib [n,A,A], wadd [n], log_match [n], w [n]).
    """
    f64 = acc_dt == torch.float64

    def one_classifier(bits, freq, allele, sidx):
        in_cls = sidx >= 0
        safe = sidx.clamp_min(0).long()
        g = torch.where(in_cls[None, :], geno_codes[:, safe],
                        GENO_MISSING).to(torch.int8)            # [n, L]
        wsnp = snp_weight[safe] * in_cls                        # [L]
        nonmiss = g != GENO_MISSING
        w = ((nonmiss * wsnp[None, :]).sum(-1).to(acc_dt)
             / wsnp.sum().clamp_min(1).to(acc_dt))              # [n]
        res = posterior_scores(bits, freq, allele, g, n_alleles, f64=f64)
        Q = unordered_from_S(res["S"])
        total = res["total"]
        log_match = _log_match(w, total, res["dmin"])
        if vote == "prob":
            contrib = Q * (w / total.clamp_min(1e-30))[:, None, None]
            wadd = w
        else:
            contrib = majority_hits(Q) * (w > 0)[:, None, None]
            wadd = (w > 0).to(acc_dt)
        return contrib, wadd, log_match, w

    return one_classifier


def _predict_block(hap_bits, hap_freq, hap_allele, snp_index, snp_weight,
                   geno_codes, n_alleles, vote="prob", f64=False):
    """One block of samples against the whole ensemble, classifier by
    classifier (the scan engine).

    hap_bits [C,Hm,L]; hap_freq [C,Hm]; hap_allele [C,Hm]; snp_index [C,L];
    snp_weight [P]; geno_codes [n,P] uint8. Returns ens [n,A,A]
    (weight-normalized, symmetric unordered convention), wsum [n],
    log_match [C,n], w [C,n].
    """
    n, A = geno_codes.shape[0], n_alleles
    acc_dt = torch.float64 if f64 else torch.float32
    one_classifier = _one_classifier_fn(geno_codes, snp_weight, A, vote,
                                        acc_dt)
    ens = torch.zeros((n, A, A), dtype=acc_dt, device=geno_codes.device)
    wsum = torch.zeros((n,), dtype=acc_dt, device=geno_codes.device)
    log_match, ws = [], []
    for c in range(hap_bits.shape[0]):
        contrib, wadd, lm, w = one_classifier(hap_bits[c], hap_freq[c],
                                              hap_allele[c], snp_index[c])
        ens += contrib
        wsum += wadd
        log_match.append(lm)
        ws.append(w)
    ens = ens / wsum.clamp_min(1e-30)[:, None, None]
    return ens, wsum, torch.stack(log_match), torch.stack(ws)


#: device tensors per PackedEnsemble, one entry per device (weak: dies with
#: the pack)
_PREP_CACHE = IdCache()


def _prepare_ensemble(packed, device) -> PackedHaplotypes:
    """The ensemble in the kernel's layout on `device`, built once per
    (PackedEnsemble, device) so repeated predict() calls skip the packing
    and the host-to-device copy. Raises ValueError for a model the kernel
    does not take."""
    per_dev = _PREP_CACHE.get(packed)
    if per_dev is None:
        per_dev = {}
        _PREP_CACHE.set(packed, per_dev)
    hap = per_dev.get(device)
    if hap is None:
        hap = ensemble_from_packed(packed, device)
        per_dev[device] = hap
    return hap


def _gather_codes(snp_index, snp_weight, geno_codes):
    """Codes gathered to each classifier's SNP slots, g int8 [C, n, L]
    (3 = missing or padded slot), and the classifier weights w float32
    [C, n], both contiguous."""
    C, L = snp_index.shape
    n = geno_codes.shape[0]
    in_cls = snp_index >= 0                                     # [C, L]
    safe = snp_index.clamp_min(0).long()
    g = geno_codes[:, safe.reshape(-1)].reshape(n, C, L).permute(1, 0, 2)
    g = torch.where(in_cls[:, None, :], g, GENO_MISSING).to(torch.int8)
    wsnp = snp_weight[safe] * in_cls                            # [C, L]
    nonmiss = g != GENO_MISSING
    w = ((nonmiss * wsnp[:, None, :]).sum(-1).to(torch.float32)
         / wsnp.sum(-1, keepdim=True).clamp_min(1).to(torch.float32))
    return g.contiguous(), w.contiguous()


def _ens_core(hap: PackedHaplotypes, snp_index, snp_weight, geno_codes,
              n_alleles, vote="prob"):
    """(ens_raw [n,A,A] — weighted posterior sum over the classifiers —
    log_match [C,n], w [C,n]) through ensemble_accumulate."""
    g, w = _gather_codes(snp_index, snp_weight, geno_codes)
    ens, dmin, total = ensemble_accumulate(hap, g, w, n_alleles,
                                           majority=vote == "majority")
    return ens, _log_match(w, total, dmin), w


def _ens_wsum(w, vote):
    """Ensemble normalizer: classifier weights for probability voting, one
    vote per contributing classifier for majority voting."""
    return w.sum(0) if vote == "prob" else (w > 0).to(w.dtype).sum(0)


def _predict_block_ens(hap, snp_index, snp_weight, geno_codes, n_alleles,
                       vote="prob"):
    """Whole-ensemble prediction for one sample block through the ensemble
    kernel. Same returns as _predict_block."""
    ens, log_match, w = _ens_core(hap, snp_index, snp_weight, geno_codes,
                                  n_alleles, vote)
    wsum = _ens_wsum(w, vote)
    ens = ens / wsum.clamp_min(1e-30)[:, None, None]
    return ens, wsum, log_match, w


def _pack_cols(ens, wsum, lse, wssum, response):
    """Block outputs as ONE buffer, so each block makes one device-to-host
    copy.

    response=False: [n, A*A+3] — full posterior matrix + (wsum, lse, wssum).
    response=True: [n, A+5] — per-allele dosage, the argmax flat index over
    the upper triangle, its probability, and the three matching stats. The
    lower triangle masks to -1 (< any probability) and argmax takes the
    first occurrence, as np.triu_indices order does on the host."""
    n = wsum.shape[0]
    dt = ens.dtype
    if response:
        A = ens.shape[1]
        mask = torch.ones((A, A), dtype=torch.bool, device=ens.device).triu()
        flat = torch.where(mask[None], ens, -1.0).reshape(n, A * A)
        best = flat.argmax(dim=1)
        maxp = flat.gather(1, best[:, None])[:, 0]
        dosage = ens.sum(dim=2) + ens.diagonal(dim1=1, dim2=2)
        head = [dosage, best[:, None].to(dt), maxp[:, None]]
    else:
        head = [ens.reshape(n, -1)]
    return torch.cat(head + [wsum[:, None].to(dt), lse[:, None].to(dt),
                             wssum[:, None].to(dt)], dim=1)


def _pack_stats(ens, wsum, log_match, w, response=False):
    """Matching reduction (log-sum-exp over classifiers, exact for
    likelihoods below the float32 range) + _pack_cols."""
    m = log_match.amax(dim=0)
    fin = torch.isfinite(m)
    safe_m = torch.where(fin, m, 0.0)
    s = torch.exp(log_match - safe_m[None, :]).sum(dim=0)
    lse = torch.where(fin, safe_m + torch.log(s), -torch.inf)
    return _pack_cols(ens, wsum, lse, w.sum(dim=0), response)


def _default_block(N, C, A, Hm, device) -> int:
    """Samples per block from the device's memory: an eighth of the card's
    memory (256 MiB on the CPU) over a per-sample bound of the block's
    intermediates — gathered codes and weights [C, n, L], the [n, A, A]
    posteriors and the plain versions' [n, H, H] distance tensors."""
    per_sample = C * (8 * MAXNUM_SNP + 24) + 16 * A * A + 32 * Hm * Hm
    if device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory // 8
    else:
        budget = 1 << 28
    return max(1, min(N, budget // per_sample))


@dataclass
class PredictionResult:
    """Prediction output (hlaAlleleClass equivalent, value df + extras)."""

    sample_id: np.ndarray
    allele1: np.ndarray            # object [N] best-guess allele strings
    allele2: np.ndarray
    prob: np.ndarray               # [N] posterior of the best guess
    matching: np.ndarray           # [N] matching proportion
    dosage: Optional[np.ndarray] = None      # [A, N]
    postprob: Optional[np.ndarray] = None    # [A(A+1)/2, N] triangular
    hla_alleles: Optional[list] = None
    locus: str = ""
    match_info: Optional[dict] = None

    def accuracy_vs(self, true1, true2) -> float:
        """Per-allele accuracy (0/0.5/1 per sample, averaged)."""
        hits = []
        for a1, a2, t1, t2 in zip(self.allele1, self.allele2, true1, true2):
            if a1 is None or t1 is None:
                continue
            hits.append(_pair_match(a1, a2, t1, t2) / 2.0)
        return float(np.mean(hits)) if hits else float("nan")


def _pair_match(a1, a2, t1, t2) -> int:
    """#matched alleles between unordered pairs (CHLATypeList::Compare,
    reference src/LibHLA.cpp:910-924)."""
    best = 0
    for x, y in ((a1, a2), (a2, a1)):
        s = int(x == t1) + int(y == t2)
        best = max(best, s)
    return best


def predict(model: AttrBagModel, data, vote: str = "prob",
            match_type: str = "Position", same_strand: bool = False,
            block: Optional[int] = None, with_dosage: bool = True,
            with_prob: bool = False, hap_bucket: int = 64,
            engine: str = "auto", type: Optional[str] = None,
            dtype=np.float32, device="cuda", mesh=None, devices=None,
            verbose: bool = False) -> PredictionResult:
    """Impute HLA types for `data` (SNPGenoData or pre-aligned code matrix
    [N, P_model]) on `device` (default "cuda"; raises when there is no card).

    Equivalent of hlaPredict (reference R/HIBAG.R:470-818).

    type: reference-style output selector ("response+dosage" [default],
    "response", "prob", "response+prob") overriding with_dosage/with_prob.
    engine: "auto" (the ensemble kernel; its plain version on the CPU) or
    "scan" (classifier loop in plain PyTorch).
    A model the kernel does not take raises ValueError naming the limit.
    block: samples per block (default: from the device's memory).
    dtype: np.float64 selects the reference-precision scan engine.
    mesh / devices: multi-device prediction is not ported yet and raises
    NotImplementedError.
    """
    if mesh is not None or devices is not None:
        raise NotImplementedError("multi-device prediction (mesh=/devices=) "
                                  "is not ported to hibag_tpu_torch yet")
    if type is not None:
        if type not in ("response+dosage", "response", "prob",
                        "response+prob"):
            raise ValueError(f"unknown type {type!r}")
        with_dosage = type == "response+dosage"
        with_prob = type in ("prob", "response+prob")
    if vote not in ("prob", "majority"):
        raise ValueError(f"unknown vote {vote!r}")
    if engine not in ("auto", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    f64 = np.dtype(dtype) == np.float64
    use_kernel = engine == "auto" and not f64
    dev = resolve_device(device)
    from ..data.geno import SNPGenoData, align_to_model

    if isinstance(data, SNPGenoData):
        codes, info = align_to_model(model, data, match_type=match_type,
                                     same_strand=same_strand)
        sample_id = data.sample_id
        if info["missing_fraction"] > 0.5:
            import warnings
            warnings.warn(
                f"More than 50% of model SNPs are missing in the target "
                f"({info['missing_fraction']:.1%}) — imputation may be unreliable.")
    else:
        codes = np.asarray(data, dtype=np.uint8)
        sample_id = np.arange(codes.shape[0]).astype(object)
        info = None

    packed = model.pack(hap_bucket=hap_bucket,
                        dtype=np.float64 if f64 else np.float32)
    N = codes.shape[0]
    A = model.n_alleles
    C = model.n_classifiers
    if use_kernel:
        hap = _prepare_ensemble(packed, dev)
    else:
        hb, hf, ha = (torch.from_numpy(x).to(dev) for x in (
            packed.hap_bits, packed.hap_freq, packed.hap_allele))
    si = torch.from_numpy(packed.snp_index).to(dev)
    sw = torch.from_numpy(packed.snp_weight.astype(np.int32)).to(dev)
    if block is None:
        block = _default_block(N, C, A, packed.hap_bits.shape[1], dev)
    block = max(1, min(block, N))

    response = not with_prob
    if response:
        dosage_all = np.zeros((N, A), dtype=np.float64)
        best_all = np.zeros(N, dtype=np.int64)
        maxp_all = np.zeros(N, dtype=np.float64)
    else:
        ens_all = np.zeros((N, A, A), dtype=np.float64)
    match_all = np.zeros(N, dtype=np.float64)
    wsum_all = np.zeros(N, dtype=np.float64)
    from ..utils.progress import Progress
    prog = Progress(N, info="Predicting", enabled=verbose)

    # the cohort is copied to the device once; blocks are slices of it
    geno_all = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    for start in range(0, N, block):
        g = geno_all[start:start + block]
        if use_kernel:
            out = _predict_block_ens(hap, si, sw, g, A, vote)
        else:
            out = _predict_block(hb, hf, ha, si, sw, g, A, vote, f64)
        buf = _pack_stats(*out, response=response).to(
            "cpu", torch.float64).numpy()
        n_eff = buf.shape[0]
        # _pack_cols layout: head (dosage[A] + best + maxp, or ens[A*A])
        # then the three stats columns
        head = A + 2 if response else A * A
        wsum, lse, wssum = buf[:, head], buf[:, head + 1], buf[:, head + 2]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            matching = np.where(wssum > 0, np.exp(lse) / wssum, np.nan)
        sl = slice(start, start + n_eff)
        if response:
            dosage_all[sl] = buf[:, :A]
            best_all[sl] = buf[:, A].astype(np.int64)
            maxp_all[sl] = buf[:, A + 1]
        else:
            ens_all[sl] = buf[:, :A * A].reshape(-1, A, A)
        match_all[sl] = matching
        wsum_all[sl] = wsum
        prog.forward(n_eff)

    # --- host-side finalization ------------------------------------------
    alleles = np.asarray(model.hla_alleles, dtype=object)
    if response:
        a1 = alleles[best_all // A].copy()
        a2 = alleles[best_all % A].copy()
        maxp = maxp_all
    else:
        iu, ju = np.triu_indices(A)
        tri = ens_all[:, iu, ju]                              # [N, A(A+1)/2]
        best = tri.argmax(axis=1)
        maxp = tri[np.arange(N), best]
        a1 = alleles[iu[best]].copy()
        a2 = alleles[ju[best]].copy()
    bad = (maxp <= 0) | (wsum_all <= 0)
    a1[bad] = None
    a2[bad] = None
    maxp = np.where(bad, 0.0, maxp)

    dosage = None
    if with_dosage:
        # dosage[A] = 2*P[A,A] + sum_{B != A} P{A,B}
        dosage = dosage_all.T if response else \
            (ens_all.sum(axis=2) + np.einsum("naa->na", ens_all)).T  # [A, N]

    return PredictionResult(
        sample_id=sample_id,
        allele1=a1, allele2=a2, prob=maxp, matching=match_all,
        dosage=dosage,
        postprob=tri.T if with_prob else None,
        hla_alleles=list(alleles), locus=model.locus, match_info=info,
    )
