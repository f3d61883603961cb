"""Ensemble weights carried across from hibag_tpu into the port's device
tensors (ops.ens_acc.PackedHaplotypes).

Two routes give the same tensors: from a PackedEnsemble (built from a model
that either package loaded from the shared ``.npz`` format), or from the
numpy copies of hibag_tpu's own prepared ensemble tensors
(hibag_tpu.models.predict._prepare_ensemble: hb, W, valid).
"""

from __future__ import annotations

import numpy as np

from ..ops.ens_acc import PackedHaplotypes, pack_haplotypes


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
