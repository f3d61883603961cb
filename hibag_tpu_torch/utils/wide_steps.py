"""Where the evaluation kernel and its plain version part on a wide locus:
one CUDA card, the checkout in the current directory.

    python3 -m hibag_tpu_torch.utils.wide_steps [K]

Run from the root of a checkout (it imports that checkout's
`chip_smoke.py`). Trains K (default 4) classifiers of `chip_smoke`'s wide
panel (1,000 samples x 266 SNPs, 160 alleles) with
`train_parallel(mode="host")` on the kernels, then holds each greedy step's
evaluation kernel against its plain version on the same inputs (the
kernels' converged, erased frequencies). For every count that differs it
finds the samples whose counts differ (the kernel's count of one sample is
one launch over copies of the classifier, copy i counting only sample i)
and prints each with its `oob`, weight and true pair, the plain version's
total, true-pair score and two best allele cells in float32, and the same
sums in float64 from the same float32 inputs, the gap between the two
cells in float32 ulps, and whether the kernel's count is that of the plain
version's second cell.
"""

import os
import sys

import numpy as np
import torch


def _cells(det, a1, a2, oob, A):
    """From a plain evaluation's detail [N, 6] (models.em.evaluate_candidates
    with `detail`): each sample's count (gated by oob and a total of at least
    FLT_MIN) for its best cell, for its second cell, and the two cells as
    (g1, g2) pairs."""
    from hibag_tpu_torch.models.em import compare_count

    starts = torch.tensor([g * A - g * (g - 1) // 2 for g in range(A)],
                          device=det.device)
    ok = oob & (det[:, 0] >= torch.finfo(torch.float32).tiny)
    out = []
    for col in (3, 5):
        k = det[:, col].long()
        g1 = torch.searchsorted(starts, k, right=True) - 1
        g2 = g1 + k - starts[g1]
        cnt = compare_count(g1, g2, a1.long(), a2.long())
        out.append((torch.where(ok, cnt, 0), g1, g2))
    return out


def kernel_counts(ev, k, c):
    """The evaluation kernel's count of each sample [N] for classifier k's
    candidate c on the evaluation arguments `ev`: one launch over one copy
    of the classifier for each out-of-bag sample, copy i counting only
    sample i. Their sum must be the batch's own count. On CPU tensors the
    plain version counts in the kernel's place."""
    from hibag_tpu_torch.models import em
    from hibag_tpu_torch.ops import train_step as ts

    bits, allele, fA, fB, g_cand, geno_sel, a1, a2, is_oob, B, A = ev
    rows = is_oob[k].nonzero()[:, 0]
    n, N = len(rows), is_oob.shape[1]
    rep = lambda x: x[k:k + 1].expand(n, *x.shape[1:]).contiguous()
    one = torch.zeros((n, N), dtype=torch.bool, device=is_oob.device)
    one[torch.arange(n, device=rows.device), rows] = True
    evaluate = (ts.evaluate_candidates_kernel if fA.is_cuda
                else em.evaluate_candidates)
    acc, _ = evaluate(
        rep(bits), rep(allele), rep(fA[:, c:c + 1]), rep(fB[:, c:c + 1]),
        rep(g_cand[:, c:c + 1]), rep(geno_sel), a1, a2, one, rep(B), A)
    out = torch.zeros(N, dtype=torch.int32, device=acc.device)
    out[rows] = acc[:, 0]
    return out


def main(argv):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hibag_tpu_torch import train_parallel
    from hibag_tpu_torch.models import em
    from hibag_tpu_torch.models import train as train_mod
    from hibag_tpu_torch.ops import train_step as ts
    from hibag_tpu_torch.utils.synthetic import (PANEL_RECOMBINATION,
                                                 synthetic_panel)

    K = int(argv[1]) if len(argv) > 1 else 4
    _, card = cs.phase_device()
    cs.phase_build()
    seed, n, p, a = cs.WIDE_PANEL
    (table, geno), _ = synthetic_panel(seed, n, p, a,
                                       recombination=PANEL_RECOMBINATION)
    steps = []
    restore = cs._record_steps(train_mod, "grow_step", steps)
    try:
        train_parallel(table, geno, n_classifiers=K, batch=K, seed=100,
                       mtry=17, verbose=False, with_matching=False,
                       mode="host", device="cuda")
    finally:
        restore()
    diffs = 0
    for i, (args, _, out) in enumerate(steps):
        (bits, _, allele, geno_sel, B, is_oob, g_cand, _, a1, a2, A) = \
            args[:11]
        ev = (bits, allele, out[0], out[1], g_cand, geno_sel, a1, a2, is_oob,
              B, A)
        acc, _ = ts.evaluate_candidates_kernel(*ev)
        acc_p, _ = em.evaluate_candidates(*ev)
        if not torch.equal(acc, out[2]):
            raise AssertionError(f"step {i}: the kernel's counts differ from "
                                 "the training's own")
        one = lambda x, kk: x[kk:kk + 1]
        for k, c in (acc != acc_p).nonzero().tolist():
            diffs += 1
            ck = kernel_counts(ev, k, c)
            if int(ck.sum()) != int(acc[k, c]):
                raise AssertionError(f"step {i}: per-sample counts sum to "
                                     f"{int(ck.sum())}, not {int(acc[k, c])}")
            sub = [one(x, k) if torch.is_tensor(x) and x.dim() > 1 else x
                   for x in ev]
            d32 = em.evaluate_candidates(*sub, detail=True)[2][0, c]
            sub64 = list(sub)
            for j in (2, 3, 9):
                sub64[j] = sub[j].double()
            d64 = em.evaluate_candidates(*sub64, detail=True)[2][0, c]
            (cp, g1, g2), (cs2, h1, h2) = _cells(d32, a1, a2, is_oob[k], A)
            rows = (ck != cp).nonzero()[:, 0].tolist()
            print(f"[wide-steps] step {i} classifier {k} candidate {c}: "
                  f"kernel {int(acc[k, c])}, plain {int(acc_p[k, c])}, "
                  f"H={bits.shape[1]}, {len(rows)} differing samples")
            for r in rows:
                x, y = d32[r].tolist(), d64[r].tolist()
                ulp = float(np.spacing(np.float32(max(y[2], y[4]))))
                print(f"  sample {r} oob {bool(is_oob[k, r])} B "
                      f"{float(B[k, r])} true ({int(a1[r])}, {int(a2[r])}); "
                      f"kernel count {int(ck[r])}; plain float32 total "
                      f"{x[0]!r} tq {x[1]!r} best ({int(g1[r])}, "
                      f"{int(g2[r])}) {x[2]!r} count {int(cp[r])}, second "
                      f"({int(h1[r])}, {int(h2[r])}) {x[4]!r} count "
                      f"{int(cs2[r])}; float64 best [{int(y[3])}] {y[2]!r} "
                      f"second [{int(y[5])}] {y[4]!r}, gap "
                      f"{abs(y[2] - y[4]) / ulp:.3f} float32 ulp; kernel "
                      f"count is the second cell's: {int(ck[r]) == int(cs2[r])}")
    print(f"[wide-steps] {len(steps)} steps, K={K}: {diffs} counts differ "
          f"between the evaluation kernel and its plain version on the same "
          f"inputs | {card}")


if __name__ == "__main__":
    sys.exit(main(sys.argv))
