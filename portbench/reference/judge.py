"""The comparison that decides ``correct``: the numbers compared between the
program's answers and the plain reference's, each held to its limit
(portbench/limits/<workload>.json).

Prediction, over the answers drawn from the window:

* ``answer_gap``: how far the program's answer lies from the reference's:
  the gap by which the reference's posterior of the program's call lies
  below the reference's best (0 where the calls agree; an answer with no
  call counts the whole best), plus the gap between the program's
  probability of its call and the reference's posterior of that call;
* ``matching_gap``: the widest gap between the logs of the program's
  matching proportion and the reference's.

Training, over the classifiers drawn from the window:

* ``bootstrap_diff``: samples whose bootstrap count differs from R's
  stream redrawn (exact);
* ``freq_l1``: the L1 distance between the program's haplotype
  frequencies and those the reference gets by growing the classifier along
  the program's own SNPs, over the haplotypes at 0.001 or more on either
  side (a haplotype only one side has counts whole), the least over the
  lists grown where float32 rounding could stop an EM one iteration apart
  (reference/train.py::replay). Rare haplotypes are left out: where a
  rare pair's two versions tie to float32 rounding, the merge keeps
  either (PERF.md);
* ``oob_gap``: OOB counts by which the program's OOB accuracy lies outside
  the range the reference finds for the program's classifier as given
  (the evaluation stage by itself; a sample whose two best calls tie
  within 1e-4 counts either);
* ``search_gap``: the whole greedy search replayed along the program's
  path (reference/train.py::search_gap): at every step the step's
  candidates redrawn, scored in float64 on the program's list so far, and
  what the program did (take a candidate, or none) held to the search's
  rules: OOB counts by which a candidate was surely better (or surely
  improved the best where the program took none), plus 1,000 times the
  relative excess of the pick's in-bag -2 log-likelihood over a candidate
  that ties it, or over the stop rule's threshold (0 where the program did
  what the search does; 1,000 where it took a SNP no draw offered).

``launch_gap`` (portbench/run.py): kernel launches of the window outside
the range per call that the mix states (exact).

Every number is a maximum over the answers compared; a number that is not
finite fails. ``freq_l1_all``, the same L1 over every haplotype, is a
reading for PERF.md and is compared with nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: haplotypes at this frequency or more count in freq_l1
COMMON = 1e-3


def predict(want, best, prob, matching) -> dict:
    post, rbest = want["post"], want["best"]
    gap = 0.0
    for i in range(len(best)):
        top = post[i, rbest[i]] if rbest[i] >= 0 else 0.0
        mine = post[i, best[i]] if best[i] >= 0 else 0.0
        gap = max(gap, top - mine + abs(float(prob[i]) - mine))
    with np.errstate(divide="ignore", invalid="ignore"):
        gaps = np.abs(np.log(np.asarray(matching, dtype=np.float64))
                      - np.log(want["matching"]))
    mgap = float(np.max(gaps)) if len(best) else 0.0
    return {"answer_gap": float(gap),
            "matching_gap": mgap if math.isfinite(mgap) else math.inf}


def train_one(ref, d, seed, cid, mtry, max_steps, cl) -> dict:
    """The numbers of one trained classifier `cl` (id `cid`)."""
    N, P = d.geno.shape
    B = ref.bootstrap(seed, cid, N)
    got_b = np.asarray(cl.bootstrap_count)
    boot = int((got_b != B).sum()) if got_b.shape == B.shape else N
    order = [int(x) for x in cl.snp_index]
    if any(not 0 <= x < P for x in order) or len(set(order)) < len(order):
        return {"bootstrap_diff": boot, "freq_l1": math.inf,
                "oob_gap": math.inf, "search_gap": ref.NOT_DRAWN,
                "freq_l1_all": math.inf}
    dev = d.geno.device
    Bt = torch.from_numpy(B).to(dev)
    got = {(int(a),) + tuple(np.asarray(b).tolist()): float(f) for a, b, f
           in zip(cl.hap_allele, cl.hap_bits, cl.hap_freq)}
    l1 = l1_all = math.inf
    kept = ref.prefixes(cl.hap_allele, cl.hap_bits)
    for bits, freq, allele in ref.replay(d, Bt, order, kept):
        want = {(int(a),) + tuple(b.tolist()): float(f) for a, b, f in zip(
            allele.cpu(), bits.cpu(), freq.cpu())}
        gaps = [(abs(want.get(k, 0.0) - got.get(k, 0.0)),
                 max(want.get(k, 0.0), got.get(k, 0.0)))
                for k in set(want) | set(got)]
        l1 = min(l1, sum(g for g, top in gaps if top >= COMMON))
        l1_all = min(l1_all, sum(g for g, _ in gaps))
    n_oob = int((B == 0).sum())
    lo, hi = ref.oob_counts(
        d, Bt, order,
        torch.from_numpy(np.asarray(cl.hap_bits, dtype=np.uint8)).to(dev),
        torch.from_numpy(np.asarray(cl.hap_freq, dtype=np.float64)).to(dev),
        torch.from_numpy(np.asarray(cl.hap_allele)).to(dev))
    mine = float(cl.oob_accuracy) * 2 * max(n_oob, 1)
    oob = max(0.0, lo - mine, mine - hi)
    search = ref.search_gap(d, seed, cid, mtry, order, max_steps, kept)
    return {"bootstrap_diff": boot, "freq_l1": float(l1),
            "oob_gap": float(oob), "search_gap": float(search),
            "freq_l1_all": float(l1_all)}


def train(rows) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def launches(counts, calls, expect) -> float:
    """``launch_gap``: the launches of each kernel in `counts` outside
    `calls` times the per-call range [least, most] (most None: no upper
    end) that `expect` gives it, summed (exact)."""
    gap = 0
    for name, (least, most) in expect.items():
        n = counts[name]
        gap += max(0, least * calls - n)
        if most is not None:
            gap += max(0, n - most * calls)
    return float(gap)


def decide(numbers: dict, limits: dict):
    """(correct, checks): every number at or below its limit; checks maps
    each name to its number and limit, in the limits' order."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        good = math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
