"""Classifier training, batch after batch: a typed panel (the
configuration's, from its ``panel_seed``); each call is the mix's entry
point (``hibag_tpu_torch.train_parallel``) with the mix's ``call``
arguments on one block of ``call["n_classifiers"]`` consecutive
classifier ids, the blocks cutting ids 0 to ``ids`` - 1 of one model
(trained from ``train_seed``), taken in an order drawn from the run's
seed and round again. The work of a block is set by its classifiers' greedy
paths, which differ by a factor two between blocks, so every seed trains
the same blocks, in its own order; the seed also draws which of the
window's classifiers the reference checks. Set-up trains one block of
other ids (``warm_id`` on)."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..drive import entry, sub_seed
from ..gen import synthetic as syn


class Driver:
    kind = "train"

    def __init__(self, cfg, mix, seed, device, program=None, chips=1):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.program = program
        self.chips = chips
        self.calls = []
        self.train_seed = mix["train_seed"]
        k = mix["call"]["n_classifiers"]
        rng = np.random.default_rng(sub_seed(seed, 4))
        self.order = rng.permutation(np.arange(0, mix["ids"], k))

    def make_inputs(self):
        p = self.cfg["panel"]
        self.panel = syn.synthetic_panel(
            p["panel_seed"], p["n_samples"], p["n_snp"],
            p["n_alleles"], p["max_variants"], p["mutation"],
            self.cfg["missing"], p["recombination"])

    def setup(self):
        from hibag_tpu_torch.data.allele import HLATypeTable
        from hibag_tpu_torch.data.geno import SNPGenoData

        self.make_inputs()
        pn = self.panel
        N, P = pn["geno"].shape[1], pn["geno"].shape[0]
        names = np.array(pn["alleles"], dtype=object)
        ids = np.array([f"s{i}" for i in range(N)], dtype=object)
        self.table = HLATypeTable.from_alleles(
            ids, names[pn["a1"]], names[pn["a2"]], locus="A")
        self.gdata = SNPGenoData(
            genotype=pn["geno"], sample_id=ids,
            snp_id=np.array([f"rs{i}" for i in range(P)], dtype=object),
            snp_position=pn["snp_position"],
            snp_allele=np.array(["A/G"] * P, dtype=object), assembly="hg19")
        if self.program is None:
            self.program = entry(self.mix)
        self.call(self.mix["warm_id"])
        self.sync()

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def call(self, first_id):
        model = self.program(self.table, self.gdata, seed=self.train_seed,
                             first_id=int(first_id), device=self.device,
                             **self.mix["call"])
        return model.classifiers

    def window(self, seconds, span=None):
        t_start = time.perf_counter()
        while True:
            first = int(self.order[len(self.calls) % len(self.order)])
            t0 = time.perf_counter()
            out = (self.call(first) if span is None
                   else span("batch", self.call, first))
            self.sync()
            t1 = time.perf_counter()
            self.calls.append((t0, t1, first, out))
            if t1 - t_start >= seconds:
                return t_start, t1

    def stretch(self, n, span):
        """`n` more batches (the set-up's ids), for the profiler."""
        for _ in range(n):
            span("batch", self.call, self.mix["warm_id"])
        self.sync()
        return []

    def end_to_end(self, t_start, t_end, calls, profile=None):
        n = sum(len(c[3]) for c in calls)
        return {"train_classifiers_s": n / (t_end - t_start)}

    def stats(self, calls):
        return {"batches": len(calls),
                "classifiers": sum(len(c[3]) for c in calls),
                "first_ids": [c[2] for c in calls]}

    def context(self, ctx, calls, stretch):
        ctx.trained = [(c.hap_allele, c.hap_bits) for call in calls
                       for c in call[3]]
        ctx.mtry = self.mix["call"]["mtry"]
        ctx.n_samples = self.panel["geno"].shape[1]

    def release(self):
        self.table = self.gdata = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, n):
        """(id, classifier) of `n` classifiers of the window drawn from the
        seed, the one with the most SNPs among them."""
        every = list({c[2] + k: cl for c in self.calls
                      for k, cl in enumerate(c[3])}.items())
        rng = np.random.default_rng(sub_seed(self.seed, 3))
        pick = set(rng.choice(len(every), min(n, len(every)) - 1,
                              replace=False).tolist())
        pick.add(int(np.argmax([cl.n_snp for _, cl in every])))
        return [every[k] for k in sorted(pick)]

    def check(self, n, judge, control_dtype=None):
        from ..reference import train as ref

        d = ref.training_data(self.panel, self.device)
        mtry = self.mix["call"]["mtry"]
        max_steps = self.mix["call"]["max_steps"]
        rows = []
        for cid, cl in self.sample(n):
            if control_dtype is not None:
                order, bits, freq, allele, acc, B = ref.train_one(
                    d, self.train_seed, cid, mtry, control_dtype, max_steps)
                n_oob = int((B == 0).sum())
                cl = _Trained(
                    snp_index=np.array(order), hap_bits=bits.cpu().numpy(),
                    hap_freq=freq.double().cpu().numpy(),
                    hap_allele=allele.cpu().numpy(),
                    bootstrap_count=B.cpu().numpy(),
                    oob_accuracy=0.5 * acc / max(n_oob, 1))
            rows.append(judge.train_one(ref, d, self.train_seed, cid, mtry,
                                        max_steps, cl))
        return judge.train(rows)


class _Trained:
    """A trained classifier's fields as the control gives them."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
