"""Ensemble training entry points: the fused-mode subset of
hibag_tpu/models/train.py (hlaAttrBagging / hlaParallelAttrBagging,
reference R/HIBAG.R:48-451).

`train_parallel(..., mode="fused")` builds the training context (sample
intersection, SNP filtering, allele factorisation), trains the classifiers
in batches through models/train_fused.py on one device, and, with
``with_matching``, predicts the training samples through the ensemble
kernel. The host trainer (``mode="host"``, ROADMAP item 1.6) is not ported.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..constants import GENO_MISSING
from ..data.allele import unique_alleles
from ..device import resolve_device
from .model import AttrBagModel


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _shape_bucket(n: int, lo: int = 64) -> int:
    """Next bucket >= n from {64, 96, 128, 192, 256, 384, ...} (powers of two
    and their 1.5x midpoints; multiples of 8192 above 16,384), as
    hibag_tpu pads: the same padded shapes give the same sums."""
    if n > 16384:
        return _round_up(n, 8192)
    b = lo
    while b < n:
        b = b + b // 2 if (b & (b - 1)) == 0 else (b // 3) * 4
    return b


@dataclass
class TrainingContext:
    """One locus's training data, with its padded tensors on `device`.

    Samples and SNPs are padded to shape buckets (as hibag_tpu pads them):
    padded samples are all-missing (code 3) with bootstrap weight 0, and
    padded SNP columns start outside the candidate pool.
    """

    geno: np.ndarray          # [N, P] codes {0,1,2,3}
    a1: np.ndarray            # [N] int32 allele index, a1 <= a2
    a2: np.ndarray            # [N]
    n_alleles: int
    snp_id: np.ndarray
    snp_position: np.ndarray
    snp_allele: np.ndarray
    sample_id: np.ndarray
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.n_samp, self.n_snp = self.geno.shape
        self.n_samp_pad = _shape_bucket(self.n_samp)
        self.n_snp_pad = _shape_bucket(self.n_snp)
        pad = self.n_samp_pad - self.n_samp
        self.geno_pad = np.pad(self.geno,
                               ((0, pad), (0, self.n_snp_pad - self.n_snp)),
                               constant_values=GENO_MISSING)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device)
        self.geno_t = t(self.geno_pad.astype(np.int8))
        self.a1_t = t(np.pad(self.a1, (0, pad)).astype(np.int32))
        self.a2_t = t(np.pad(self.a2, (0, pad)).astype(np.int32))

    def pad_B(self, B: np.ndarray) -> np.ndarray:
        return np.pad(B, (0, self.n_samp_pad - self.n_samp))


@dataclass
class _HaploState:
    """A compact haplotype list (allele-grouped)."""

    bits: np.ndarray     # [H, n_snp] uint8
    freq: np.ndarray     # [H] float64
    allele: np.ndarray   # [H] int32


def _init_haplotype(ctx: TrainingContext, B: np.ndarray) -> _HaploState:
    """One frequency-weighted haplotype per observed allele
    (_InitHaplotype, src/LibHLA.cpp:1880-1914)."""
    counts = np.zeros(ctx.n_alleles, dtype=np.int64)
    np.add.at(counts, ctx.a1, B)
    np.add.at(counts, ctx.a2, B)
    total = counts.sum()
    sel = np.nonzero(counts > 0)[0]
    return _HaploState(bits=np.zeros((len(sel), 0), dtype=np.uint8),
                       freq=counts[sel] * (1.0 / total),
                       allele=sel.astype(np.int32))


def make_training_context(hla_table, geno_data, na_rm: bool = True,
                          mono_rm: bool = True, maf: float = float("nan"),
                          device="cuda") -> tuple:
    """Sample intersection, SNP filtering and allele factorisation
    (hlaAttrBagging preamble, R/HIBAG.R:77-174).

    Returns (TrainingContext, allele list, kept-SNP mask)."""
    geno_pos = {s: i for i, s in enumerate(geno_data.sample_id)}
    keep = [i for i, s in enumerate(hla_table.sample_id) if s in geno_pos]
    if na_rm:
        keep = [i for i in keep if hla_table.allele1[i] is not None
                and hla_table.allele2[i] is not None]
    if not keep:
        raise ValueError("no common samples between HLA table and genotypes")
    samp_ids = hla_table.sample_id[keep]
    h1 = hla_table.allele1[keep]
    h2 = hla_table.allele2[keep]
    gcols = np.array([geno_pos[s] for s in samp_ids])
    geno = geno_data.genotype[:, gcols].T.copy()   # [N, P]

    g = geno.astype(np.float64)
    miss = g >= GENO_MISSING
    with np.errstate(invalid="ignore"):
        f = np.where(miss, 0, g).sum(0) / np.maximum(2.0 * (~miss).sum(0), 1)
    mf = np.minimum(f, 1 - f)
    mf[~np.isfinite(mf)] = 0
    snp_keep = np.ones(geno.shape[1], dtype=bool)
    if mono_rm:
        snp_keep &= mf > 0
    if np.isfinite(maf):
        snp_keep &= mf >= maf
    geno = geno[:, snp_keep]

    alleles = unique_alleles(np.concatenate([h1, h2]))
    aidx = {a: i for i, a in enumerate(alleles)}
    a1 = np.array([aidx[a] for a in h1], dtype=np.int32)
    a2 = np.array([aidx[a] for a in h2], dtype=np.int32)
    a1, a2 = np.minimum(a1, a2), np.maximum(a1, a2)
    ctx = TrainingContext(
        geno=geno.astype(np.int8), a1=a1, a2=a2, n_alleles=len(alleles),
        snp_id=geno_data.snp_id[snp_keep],
        snp_position=geno_data.snp_position[snp_keep],
        snp_allele=geno_data.snp_allele[snp_keep],
        sample_id=samp_ids, device=resolve_device(device))
    return ctx, alleles, snp_keep


def _resolve_mtry(mtry, n_snp: int) -> int:
    """mtry resolution (R/HIBAG.R:180-208)."""
    if isinstance(mtry, str):
        if mtry == "sqrt":
            m = int(np.ceil(np.sqrt(n_snp)))
        elif mtry == "all":
            m = n_snp
        elif mtry == "one":
            m = 1
        else:
            raise ValueError(f"invalid mtry {mtry!r}")
    else:
        m = float(mtry)
        if not np.isfinite(m):
            m = int(np.ceil(np.sqrt(n_snp)))
        else:
            if 0 < m < 1:
                m = n_snp * m
            m = min(int(np.ceil(m)), n_snp)
    return max(int(m), 1)


def _partial_model(ctx, alleles, hla_table, geno_data, classifiers):
    g = ctx.geno.astype(np.float64)
    miss = g >= GENO_MISSING
    with np.errstate(invalid="ignore"):
        afreq = (np.where(miss, 0, g).sum(0)
                 / np.maximum(2.0 * (~miss).sum(0), 1))
    hla_freq = np.zeros(len(alleles))
    for a in (ctx.a1, ctx.a2):
        np.add.at(hla_freq, a, 1)
    hla_freq /= max(hla_freq.sum(), 1)
    return AttrBagModel(
        locus=hla_table.locus,
        snp_id=ctx.snp_id, snp_position=ctx.snp_position,
        snp_allele=ctx.snp_allele, snp_allele_freq=afreq,
        hla_alleles=list(alleles), hla_freq=hla_freq,
        assembly=geno_data.assembly, sample_id=ctx.sample_id,
        classifiers=list(classifiers))


def train_parallel(hla_table, geno_data, n_classifiers: int = 100,
                   mtry="sqrt", prune: bool = True, seed: int = 100,
                   batch: Optional[int] = None, na_rm: bool = True,
                   mono_rm: bool = True, maf: float = float("nan"),
                   verbose: bool = True, with_matching: bool = True,
                   auto_save: Optional[str] = None,
                   first_id: int = 0, mode: str = "fused", hcap: int = 256,
                   max_steps: int = 256, on_overflow: str = "warn",
                   seg_steps: Optional[int] = None,
                   freeze_max_batch: Optional[int] = None,
                   resume: bool = False, engine=None, device="cuda",
                   mask_budget: Optional[int] = None) -> AttrBagModel:
    """Ensemble training (hlaParallelAttrBagging), fused mode, on `device`
    ("cuda" by default, which raises without a card; "cpu" runs the kernels'
    plain versions).

    Trains `n_classifiers` in batches of `batch` (default 8) with
    models.train_fused.train_fused_batch; classifier j of the ensemble has
    the id first_id + j, which fixes its bootstrap and its candidate draws,
    so batching does not change the result. With `auto_save` the partial
    model is written after every batch; with `resume` and an existing
    `auto_save` file training continues from it. ``mode`` "fused" and
    "auto" train fused; "host" raises NotImplementedError. ``engine``
    "torch" runs the plain versions of the kernels on any device
    (train_fused.resolve_engine). The other arguments are hibag_tpu's.
    """
    if mode == "host":
        raise NotImplementedError(
            "mode='host' (the host-loop trainer with the R RNG stream) is not "
            "ported yet: ROADMAP item 1.6; use mode='fused'")
    if mode not in ("fused", "auto"):
        raise ValueError(f"unknown mode {mode!r}")
    from .train_fused import train_fused_batch

    ctx, alleles, _ = make_training_context(
        hla_table, geno_data, na_rm=na_rm, mono_rm=mono_rm, maf=maf,
        device=device)
    m = _resolve_mtry(mtry, ctx.n_snp)
    batch = batch or 8

    classifiers: list = []
    k0 = first_id
    if resume and auto_save and os.path.exists(auto_save):
        classifiers = list(AttrBagModel.load(auto_save).classifiers)[
            :n_classifiers]
        k0 = first_id + len(classifiers)
    while len(classifiers) < n_classifiers:
        kb = min(batch, n_classifiers - len(classifiers))
        t0 = time.time()
        cls = train_fused_batch(ctx, kb, seed=seed, mtry=m, prune=prune,
                                hcap=hcap, first_id=k0, max_steps=max_steps,
                                seg_steps=seg_steps, on_overflow=on_overflow,
                                freeze_max_batch=freeze_max_batch,
                                engine=engine, mask_budget=mask_budget)
        classifiers.extend(cls)
        k0 += kb
        if verbose:
            oob = np.mean([c.oob_accuracy for c in cls])
            print(f"-- #{len(classifiers)}, batch of {kb} in "
                  f"{time.time() - t0:.2f}s, avg oob acc: {oob * 100:.2f}%")
        if auto_save:
            _partial_model(ctx, alleles, hla_table, geno_data,
                           classifiers).save(auto_save)

    model = _partial_model(ctx, alleles, hla_table, geno_data, classifiers)
    if with_matching:
        from .predict import predict
        pd = predict(model, geno_data, match_type="Pos+Allele",
                     device=ctx.device)
        model.matching = pd.matching
        if auto_save:
            model.save(auto_save)
    return model
