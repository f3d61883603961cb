"""Faults planted under the timed path, for the tests that see ``correct``
come out false and for the calibration runs that read the limits' upper
ends. Each returns a stand-in for the program's entry point.

Prediction (in place of ``hibag_tpu_torch.predict``):

* ``unchanged``: every call returns the first call's answers, as a step
  that leaves its state unchanged;
* ``half``: each chunk's second half is left out, its answers taken from
  the first half's;
* ``altered``: answers altered where they are produced: in each call,
  every 16th sample's first allele replaced by the next allele.

Training (in place of ``hibag_tpu_torch.train_parallel``):

* ``unchanged``: every growth step returns its state unchanged (the
  classifiers keep no SNP);
* ``half``: each classifier's bootstrap leaves out the second half of the
  samples and counts the first half twice;
* ``altered``: each trained classifier's haplotype frequencies are moved
  one haplotype along;
* ``stop``: the search stops after its first SNP (no later step takes a
  candidate);
* ``worst``: past its first SNP, each accepted step takes the candidate
  with the fewest OOB counts instead of the best.
"""

from __future__ import annotations

import contextlib
from dataclasses import replace

import numpy as np

PREDICT = ("unchanged", "half", "altered")
TRAIN = ("unchanged", "half", "altered", "stop", "worst")


def predict(name):
    import hibag_tpu_torch as ht

    first = []

    def run(model, data, **kw):
        if name == "half":
            n = data.genotype.shape[1]
            h = (n + 1) // 2
            part = type(data)(
                genotype=data.genotype[:, :h], sample_id=data.sample_id[:h],
                snp_id=data.snp_id, snp_position=data.snp_position,
                snp_allele=data.snp_allele, assembly=data.assembly)
            res = ht.predict(model, part, **kw)
            idx = np.arange(n) % h
            return replace(res, allele1=res.allele1[idx],
                           allele2=res.allele2[idx], prob=res.prob[idx],
                           matching=res.matching[idx])
        res = ht.predict(model, data, **kw)
        if name == "unchanged":
            if not first:
                first.append(res)
            n = len(res.prob)
            old = first[0]
            idx = np.arange(n) % len(old.prob)
            return replace(res, allele1=old.allele1[idx],
                           allele2=old.allele2[idx], prob=old.prob[idx],
                           matching=old.matching[idx])
        if name == "altered":
            a1 = res.allele1.copy()
            names = model.hla_alleles
            for r in range(0, len(a1), 16):
                a1[r] = names[(names.index(a1[r]) + 1) % len(names)] \
                    if a1[r] is not None else names[0]
            return replace(res, allele1=a1)
        raise ValueError(name)
    return run


@contextlib.contextmanager
def _patched(mod, attr, value):
    old = getattr(mod, attr)
    setattr(mod, attr, value)
    try:
        yield
    finally:
        setattr(mod, attr, old)


def train(name):
    import hibag_tpu_torch as ht
    from hibag_tpu_torch.models import train_fused
    from hibag_tpu_torch.utils import rng as rng_mod

    def still(st, *a, **k):
        import torch
        return replace(st, done=torch.ones_like(st.done), steps=st.steps + 1)

    orig_counts = rng_mod.RRng.bootstrap_counts

    def half_counts(self, n):
        b = orig_counts(self, n)
        h = n // 2
        return np.concatenate([2 * b[:h], np.zeros(n - h, b.dtype)])

    decide = train_fused._decide

    def stop(cand_ok, acc_c, loss_c, gmax_acc, gmin_loss, prune):
        import torch
        min_i, max_acc, min_loss, kill = decide(cand_ok, acc_c, loss_c,
                                                gmax_acc, gmin_loss, prune)
        past = gmax_acc > 0
        return (torch.where(past, -1, min_i),
                torch.where(past, gmax_acc, max_acc),
                torch.where(past, gmin_loss, min_loss), kill)

    def worst(cand_ok, acc_c, loss_c, gmax_acc, gmin_loss, prune):
        import torch
        min_i, max_acc, min_loss, kill = decide(cand_ok, acc_c, loss_c,
                                                gmax_acc, gmin_loss, prune)
        low = torch.where(cand_ok, acc_c, torch.iinfo(torch.int32).max)
        pick = low.argmin(dim=1).to(min_i.dtype)
        past = (gmax_acc > 0) & (min_i >= 0)
        return torch.where(past, pick, min_i), max_acc, min_loss, kill

    def run(*a, **kw):
        if name in ("stop", "worst"):
            with _patched(train_fused, "_decide",
                          stop if name == "stop" else worst):
                return ht.train_parallel(*a, **kw)
        if name == "unchanged":
            with _patched(train_fused, "_step", still):
                return ht.train_parallel(*a, **kw)
        if name == "half":
            with _patched(rng_mod.RRng, "bootstrap_counts", half_counts):
                return ht.train_parallel(*a, **kw)
        if name == "altered":
            model = ht.train_parallel(*a, **kw)
            for c in model.classifiers:
                c.hap_freq = np.roll(c.hap_freq, 1)
            return model
        raise ValueError(name)
    return run


KINDS = {"predict": predict, "train": train}
