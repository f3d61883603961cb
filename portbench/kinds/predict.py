"""Cohort imputation in chunks: a cohort drawn from the seed is cut in
set-up into chunks whose sizes the mix lists (``chunks``, taken in turn
until the cohort is used up; the last chunk takes what is left); each
call is the mix's entry point (``hibag_tpu_torch.predict``) on the next
chunk, in turn, with the mix's ``call`` arguments. Set-up warms each chunk
size once."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..drive import entry, sub_seed
from ..gen import synthetic as syn


def cut(n, sizes):
    """(lo, hi) of the chunks of `n` samples cut in turn at `sizes`."""
    out, lo, k = [], 0, 0
    while lo < n:
        hi = min(lo + int(sizes[k % len(sizes)]), n)
        out.append((lo, hi))
        lo, k = hi, k + 1
    return out


class Driver:
    kind = "predict"

    def __init__(self, cfg, mix, seed, device, program=None, chips=1):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.program = program
        self.chips = chips
        self.calls = []

    # -- set-up ------------------------------------------------------------
    def make_inputs(self):
        m = self.cfg["model"]
        self.model, pool = syn.synthetic_model(
            sub_seed(self.seed, 1), m["n_classifiers"], m["n_snp"],
            m["n_alleles"], m["snp_range"], m["hap_range"],
            m["max_variants"], m["mutation"], m["shape_seed"])
        self.geno, _, _ = syn.synthetic_cohort(
            pool, self.mix["cohort"], sub_seed(self.seed, 2),
            self.cfg["missing"])
        self.bounds = cut(self.mix["cohort"], self.mix["chunks"])

    def setup(self):
        from hibag_tpu_torch.data.geno import SNPGenoData
        from hibag_tpu_torch.models.model import AttrBagModel, Classifier

        self.make_inputs()
        m = self.model
        P = len(m["snp_position"])
        snp_id = np.array([f"rs{i}" for i in range(P)], dtype=object)
        snp_allele = np.array(["A/G"] * P, dtype=object)
        self.port_model = AttrBagModel(
            locus="A", snp_id=snp_id, snp_position=m["snp_position"],
            snp_allele=snp_allele, hla_alleles=list(m["alleles"]),
            classifiers=[Classifier(**c) for c in m["classifiers"]],
            snp_allele_freq=m["snp_allele_freq"], hla_freq=m["hla_freq"],
            assembly="hg19")
        ids = np.array([f"s{i}" for i in range(self.mix["cohort"])],
                       dtype=object)
        self.chunks = [SNPGenoData(
            genotype=np.ascontiguousarray(self.geno[:, lo:hi]),
            sample_id=ids[lo:hi], snp_id=snp_id,
            snp_position=m["snp_position"], snp_allele=snp_allele,
            assembly="hg19") for lo, hi in self.bounds]
        self.alleles = {a: i for i, a in enumerate(m["alleles"])}
        if self.program is None:
            self.program = entry(self.mix)
        for size in sorted({hi - lo for lo, hi in self.bounds}):
            i = next(k for k, (lo, hi) in enumerate(self.bounds)
                     if hi - lo == size)
            self.call(i)
        self.sync()

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    # -- calls -------------------------------------------------------------
    def call(self, i):
        """One call on chunk i: (a1, a2, prob, matching)."""
        res = self.program(self.port_model, self.chunks[i],
                           device=self.device, **self.mix.get("call", {}))
        return res.allele1, res.allele2, res.prob, res.matching

    def window(self, seconds, span=None):
        """Calls in turn until `seconds` have passed; the window ends when
        its last call has returned."""
        k = len(self.calls)
        t_start = time.perf_counter()
        while True:
            i = k % len(self.chunks)
            t0 = time.perf_counter()
            out = self.call(i) if span is None else span("call", self.call, i)
            t1 = time.perf_counter()
            self.calls.append((t0, t1, i, out))
            k += 1
            if t1 - t_start >= seconds:
                return t_start, t1

    def stretch(self, n, span):
        """`n` more calls after the window's, for the profiler: returns the
        chunks they took."""
        first = len(self.calls)
        done = [(first + k) % len(self.chunks) for k in range(n)]
        for i in done:
            span("call", self.call, i)
        self.sync()
        return done

    def end_to_end(self, t_start, t_end, calls, profile=None):
        """The window's metrics; with ``profile``, the window traced on
        the device, also the card's busy time over the window's samples."""
        ms = [1e3 * (t1 - t0) for t0, t1, _, _ in calls]
        n = sum(len(c[3][2]) for c in calls)
        out = {"predict_samples_s": n / (t_end - t_start),
               "predict_call_p95_ms": float(np.percentile(ms, 95))}
        if profile is not None and profile["busy_s"] > 0:
            out["predict_device_us_per_sample"] = 1e6 * profile["busy_s"] / n
        return out

    def stats(self, calls):
        return {"calls": len(calls),
                "samples": sum(len(c[3][2]) for c in calls)}

    def context(self, ctx, calls, stretch):
        """What the per-layer readers need besides spans and the profile."""
        ctx.profile_chunks = stretch
        ctx.work = self.work(range(len(self.bounds)))
        ctx.n_alleles = len(self.model["alleles"])
        ctx.n_snp = len(self.model["snp_position"])

    def work(self, chunk_ids):
        """Per chunk in `chunk_ids`: the ensemble's valid haplotypes nh [C]
        and het_words [C, N] of the chunk's aligned codes."""
        from ..reference.predict import align
        from ..work.bounds import het_words

        m = self.model
        C = len(m["classifiers"])
        si = np.full((C, 128), -1, dtype=np.int64)
        for c, cl in enumerate(m["classifiers"]):
            si[c, :len(cl["snp_index"])] = cl["snp_index"]
        si = torch.from_numpy(si).to(self.device)
        nh = np.array([len(c["hap_freq"]) for c in m["classifiers"]])
        out = {}
        for i in sorted(set(chunk_ids)):
            lo, hi = self.bounds[i]
            codes = align(m["snp_position"], m["snp_position"],
                          self.geno[:, lo:hi])
            out[i] = (nh, het_words(torch.from_numpy(codes).to(self.device),
                                    si).cpu().numpy())
        return out

    def release(self):
        """Drop the program's state before the reference runs."""
        self.port_model = self.chunks = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness -------------------------------------------------------
    def sample(self, n):
        """(cohort index, call, row) of `n` answers of the window drawn from
        the seed."""
        rng = np.random.default_rng(sub_seed(self.seed, 3))
        k = rng.integers(0, len(self.calls), n)
        out = []
        for c in k:
            i = self.calls[c][2]
            lo, hi = self.bounds[i]
            r = int(rng.integers(0, hi - lo))
            out.append((lo + r, int(c), r))
        return out

    def answers(self, picks):
        """The program's answers at `picks`: best cell index (-1 none),
        prob, matching."""
        A = len(self.model["alleles"])
        best, prob, match = [], [], []
        for _, c, r in picks:
            a1, a2, p, mt = self.calls[c][3]
            if a1[r] is None:
                best.append(-1)
            else:
                x, y = sorted((self.alleles[a1[r]], self.alleles[a2[r]]))
                best.append(x * A - x * (x - 1) // 2 + (y - x))
            prob.append(p[r])
            match.append(mt[r])
        return np.array(best), np.array(prob), np.array(match)

    def check(self, n, judge, control_dtype=None):
        """Numbers compared with the reference on `n` answers drawn from the
        seed; with ``control_dtype``, the reference in that precision takes
        the program's place (the control)."""
        from ..reference import predict as ref

        picks = self.sample(n)
        rows = np.array([p[0] for p in picks])
        m = self.model
        codes = ref.align(m["snp_position"], m["snp_position"],
                          self.geno[:, rows])
        want = ref.predict(m, codes, self.device)
        if control_dtype is None:
            got = self.answers(picks)
        else:
            c = ref.predict(m, codes, self.device, dtype=control_dtype)
            got = (c["best"], c["prob"], c["matching"])
        return judge.predict(want, *got)
