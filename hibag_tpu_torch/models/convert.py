"""State carried across from hibag_tpu into the port's device tensors.

* Ensemble weights (ops.ens_acc.PackedHaplotypes). Two routes give the same
  tensors: from a PackedEnsemble (built from a model that either package
  loaded from the shared ``.npz`` format), or from the numpy copies of
  hibag_tpu's own prepared ensemble tensors
  (hibag_tpu.models.predict._prepare_ensemble: hb, W, valid). One
  classifier's posterior_scores_pallas inputs take the second route at C = 1.
* A fused growth state (models.train_fused.GrowState) from the numpy copies
  of hibag_tpu's GrowState and its threefry keys, so that growth started in
  one package can go on in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ens_acc import PackedHaplotypes, pack_haplotypes
from .train_fused import GrowState


def ensemble_from_packed(packed, device) -> PackedHaplotypes:
    """From a PackedEnsemble's hap_bits [C, Hm, L], hap_freq [C, Hm] and
    hap_allele [C, Hm]."""
    return pack_haplotypes(packed.hap_bits, packed.hap_freq, packed.hap_allele,
                           packed.n_alleles, device)


def ensemble_from_jax_prepared(hb, W, valid, device) -> PackedHaplotypes:
    """From np.asarray of hibag_tpu's prepared tensors: hb f32 [C, Hp, L],
    W f32 [C, Hp, Ac] = freq ⊙ one-hot(allele), valid f32 [C, Hp, 1]."""
    W = np.asarray(W, dtype=np.float32)
    valid = np.asarray(valid)[..., 0] > 0
    # one non-zero entry per real row: its sum is the frequency exactly
    freq = np.where(valid, W.sum(axis=-1), 0.0)
    allele = W.argmax(axis=-1)
    return pack_haplotypes(np.asarray(hb), freq, allele, W.shape[-1], device)


def classifier_from_jax_prepared(hb, W, valid, device) -> PackedHaplotypes:
    """One classifier (C = 1) from np.asarray of posterior_scores_pallas'
    inputs: hb f32 [Hp, L], W f32 [Hp, Ap], valid f32 [Hp]."""
    return ensemble_from_jax_prepared(np.asarray(hb)[None], np.asarray(W)[None],
                                      np.asarray(valid)[None, :, None], device)


def grow_state_from_jax(state, device) -> GrowState:
    """From hibag_tpu's train_fused.GrowState, or any object with its fields
    as arrays (np.asarray is applied to each): bits f32 [K, Hc, L], freq f32
    [K, Hc], allele i32 [K, Hc], geno_sel i8 [K, N, L], n_snp i32 [K],
    snp_order i32 [K, L], pool bool [K, P], gmax_acc i32 [K], gmin_loss f32
    [K], done bool [K], key u32 [K, 2] (threefry key words), overflow i32
    [K], n_step i32 [K], steps i32 []. The port keeps n_snp, snp_order and
    the key words as int64."""
    dev = torch.device(device)
    get = lambda name, dt=None: torch.from_numpy(np.ascontiguousarray(
        np.asarray(getattr(state, name), dtype=dt))).to(dev)
    return GrowState(
        bits=get("bits", np.float32), freq=get("freq", np.float32),
        allele=get("allele", np.int32), geno_sel=get("geno_sel", np.int8),
        n_snp=get("n_snp", np.int64), snp_order=get("snp_order", np.int64),
        pool=get("pool", bool), gmax_acc=get("gmax_acc", np.int32),
        gmin_loss=get("gmin_loss", np.float32), done=get("done", bool),
        key=get("key", np.int64), overflow=get("overflow", np.int32),
        n_step=get("n_step", np.int32), steps=int(np.asarray(state.steps)))
