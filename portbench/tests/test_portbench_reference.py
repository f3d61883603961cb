"""The plain reference on tiny models against brute force, its frozen
copies against the program's originals, and its training replay against
the program on the CPU."""

import itertools
import math

import numpy as np
import pytest
import torch

from portbench.gen import rrng, synthetic, threefry
from portbench.reference import predict as rp
from portbench.reference import train as rt

Q = 1e-5


def dist(g, b1, b2):
    s = int(b1) + int(b2)
    return {0: s, 1: abs(s - 1), 2: 2 - s}.get(int(g), 0)


def brute_predict(model, codes):
    cls = model["classifiers"]
    A = len(model["alleles"])
    weight = np.zeros(len(model["snp_position"]))
    for c in cls:
        weight[c["snp_index"]] += 1
    out = []
    for g in codes:
        ens = np.zeros((A, A))
        wsum = msum = 0.0
        for c in cls:
            gs = g[c["snp_index"]]
            sw = weight[c["snp_index"]]
            w = sw[gs != 3].sum() / sw.sum()
            H = len(c["hap_freq"])
            D = np.array([[sum(dist(gs[l], c["hap_bits"][i, l],
                                    c["hap_bits"][j, l])
                               for l in range(len(gs)) if gs[l] != 3)
                           for j in range(H)] for i in range(H)])
            dmin = D.min()
            S = np.zeros((A, A))
            for i, j in itertools.product(range(H), range(H)):
                S[c["hap_allele"][i], c["hap_allele"][j]] += (
                    c["hap_freq"][i] * c["hap_freq"][j] * Q ** (D[i, j] - dmin))
            total = S.sum()
            Qm = S * (2 - np.eye(A))
            ens += w * Qm / total
            wsum += w
            msum += w * total * Q ** dmin
        ens /= wsum
        iu, ju = np.triu_indices(A)
        tri = ens[iu, ju]
        out.append((int(tri.argmax()), tri.max(), msum / wsum, tri))
    return out


def tiny_model(seed=3):
    return synthetic.synthetic_model(seed, 3, 12, 4, (3, 6), (3, 7), 2, 0.1,
                                     shape_seed=1)


def test_predict_against_brute_force():
    model, pool = tiny_model()
    geno, _, _ = synthetic.synthetic_cohort(pool, 6, 9, missing=0.2)
    codes = rp.align(model["snp_position"], model["snp_position"], geno)
    got = rp.predict(model, codes, "cpu")
    for k, (best, prob, match, tri) in enumerate(brute_predict(model, codes)):
        assert got["best"][k] == best
        assert got["prob"][k] == pytest.approx(prob, rel=1e-12)
        assert got["matching"][k] == pytest.approx(match, rel=1e-12)
        np.testing.assert_allclose(got["post"][k], tri, rtol=1e-12,
                                   atol=1e-300)


def test_align_by_position():
    pos = np.array([10, 20, 30])
    data_pos = np.array([30, 5, 10])
    geno = np.array([[2, 2], [1, 1], [0, 1]], dtype=np.uint8)   # [P, N]
    codes = rp.align(pos, data_pos, geno)
    assert codes.tolist() == [[0, 3, 2], [1, 3, 2]]


def tiny_data(n=24, seed=4):
    panel = synthetic.synthetic_panel(seed, n, 6, 3, 2, 0.1, 0.1, 0.0)
    return rt.training_data(panel, "cpu")


def brute_match(bits, allele, geno_sel, a1, a2):
    out = set()
    H = bits.shape[0]
    for s in range(geno_sel.shape[0]):
        cand = [(i, j) for i in range(H) for j in range(H)
                if {int(allele[i]), int(allele[j])} == {int(a1[s]), int(a2[s])}
                and (int(allele[i]), int(allele[j])) in
                ((int(a1[s]), int(a2[s])), (int(a2[s]), int(a1[s])))]
        if not cand:
            continue
        d = {p: sum(dist(geno_sel[s, l], bits[p[0], l], bits[p[1], l])
                    for l in range(geno_sel.shape[1]) if geno_sel[s, l] != 3)
             for p in cand}
        m = min(d.values())
        out |= {(s, i, j) for (i, j), v in d.items() if v == m}
    return out


def test_match_and_em_step_against_brute_force():
    d = tiny_data()
    N = d.geno.shape[0]
    B = torch.from_numpy(rt.bootstrap(11, 2, N))
    bits, freq, allele = rt.init_list(d, B, torch.float64)
    # grow once along SNP 0 so that the list has SNPs to match on
    g0 = d.geno[:, 0][None]
    _, af = rt.candidates_ok(g0, B)
    tri = rt.match(bits, allele, d.geno[:, :0], d.a1, d.a2)
    fa, fb = rt.em(freq, tri, B, g0, af, float(N), torch.float64)
    bits, freq, allele = rt.grow(bits, freq, allele, fa[0], fb[0])
    sel = d.geno[:, :1]
    tri = rt.match(bits, allele, sel, d.a1, d.a2)
    want = brute_match(bits.numpy(), allele.numpy(), sel.numpy(),
                       d.a1.numpy(), d.a2.numpy())
    assert set(zip(*[t.tolist() for t in tri])) == want
    g1 = d.geno[:, 1][None]
    _, af = rt.candidates_ok(g1, B)
    step, fA, fB = rt._em_start(freq, tri, B, g1, af, float(N),
                                torch.float64)
    nA, nB, ll = step(fA, fB)
    # brute force: each sample's pairs of the doubled list that agree
    # with its call of the new SNP
    fA, fB = fA[0].numpy(), fB[0].numpy()
    eA, eB, el = np.zeros_like(fA), np.zeros_like(fB), 0.0
    g = g1[0].numpy()
    for s in range(N):
        pairs = [(i, j) for (t, i, j) in want if t == s]
        terms = []
        for i, j in pairs:
            for x, y in itertools.product((0, 1), (0, 1)):
                if g[s] != 3 and x + y != g[s]:
                    continue
                fi = fA[i] if x == 0 else fB[i]
                fj = fA[j] if y == 0 else fB[j]
                terms.append((i, x, fi * fj))
        psum = max(sum(t[2] for t in terms), 1e-37)
        el += float(B[s]) * math.log(psum)
        for i, x, v in terms:
            (eA if x == 0 else eB)[i] += float(B[s]) * v / psum
    np.testing.assert_allclose(nA[0].numpy(), eA / N, rtol=1e-10)
    np.testing.assert_allclose(nB[0].numpy(), eB / N, rtol=1e-10)
    assert float(ll[0]) == pytest.approx(el, rel=1e-12)


def test_evaluate_against_brute_force():
    d = tiny_data(30, seed=6)
    N = d.geno.shape[0]
    A = d.n_alleles
    B = torch.from_numpy(rt.bootstrap(5, 1, N))
    lists = rt.replay(d, B, [0, 2])
    bits, freq, allele = lists[0]
    order = [0, 2]
    lo, hi = rt.oob_counts(d, B, order, bits, freq, allele, ties=0.0)
    assert lo == hi
    acc = lo
    geno = d.geno[:, order].numpy()
    a1, a2 = d.a1.numpy(), d.a2.numpy()
    H = len(freq)
    want = 0
    for s in np.flatnonzero(B.numpy() == 0):
        D = np.array([[sum(dist(geno[s, l], bits[i, l], bits[j, l])
                           for l in range(2) if geno[s, l] != 3)
                       for j in range(H)] for i in range(H)], dtype=float)
        S = np.zeros((A, A))
        for i, j in itertools.product(range(H), range(H)):
            S[allele[i], allele[j]] += freq[i] * freq[j] * Q ** D[i, j]
        V = S * (2 - np.eye(A))
        b = int(V.argmax())
        g1, g2 = sorted((b // A, b % A))
        t = [a1[s], a2[s]]
        hit = 0
        for x in (g1, g2):
            if x in t:
                t.remove(x)
                hit += 1
        want += hit
    assert acc == want


def test_frozen_copies_equal_the_programs():
    from hibag_tpu_torch.utils import rng as port_rng
    from hibag_tpu_torch.utils import threefry as port_tf

    for s in (1, 12345, 2**31 - 2):
        assert np.array_equal(rrng.RRng(s).bootstrap_counts(50),
                              port_rng.RRng(s).bootstrap_counts(50))
    keys = torch.tensor([[0, 7], [0, 2**31 + 5]], dtype=torch.int64)
    pool = torch.rand((2, 40), generator=torch.Generator().manual_seed(0)) > 0.3
    assert torch.equal(threefry.draw_top_k(threefry.split(keys)[:, 1], pool, 6),
                       port_tf.draw_top_k(port_tf.split(keys)[:, 1], pool, 6))


def test_replay_and_search_agree_with_the_program():
    """The program's fused trainer on the CPU (plain versions), held
    against the reference's replay, OOB count and whole search."""
    import hibag_tpu_torch as ht
    from hibag_tpu_torch.data.allele import HLATypeTable
    from hibag_tpu_torch.data.geno import SNPGenoData

    panel = synthetic.synthetic_panel(5, 160, 40, 6, 3, 0.02, 0.02, 0.5)
    N, P = 160, 40
    names = np.array(panel["alleles"], dtype=object)
    ids = np.array([f"s{i}" for i in range(N)], dtype=object)
    table = HLATypeTable.from_alleles(ids, names[panel["a1"]],
                                      names[panel["a2"]], locus="A")
    geno = SNPGenoData(
        genotype=panel["geno"], sample_id=ids,
        snp_id=np.array([f"rs{i}" for i in range(P)], dtype=object),
        snp_position=panel["snp_position"],
        snp_allele=np.array(["A/G"] * P, dtype=object), assembly="hg19")
    m = ht.train_parallel(table, geno, n_classifiers=2, batch=2, seed=77,
                          mtry=5, mode="fused", hcap=64,
                          on_overflow="freeze", device="cpu", verbose=False,
                          with_matching=False, first_id=4)
    d = rt.training_data(panel, "cpu")
    for k, c in enumerate(m.classifiers):
        cid = 4 + k
        B = rt.bootstrap(77, cid, N)
        assert np.array_equal(B, c.bootstrap_count)
        Bt = torch.from_numpy(B)
        order = [int(x) for x in c.snp_index]
        got = {(int(a),) + tuple(b.tolist()): f for a, b, f in
               zip(c.hap_allele, c.hap_bits, c.hap_freq)}
        l1 = min(sum(abs(dict(zip(
            [(int(a),) + tuple(b.tolist()) for a, b in zip(al, bi)],
            fr.tolist())).get(x, 0.0) - got.get(x, 0.0)) for x in got)
            for bi, fr, al in rt.replay(d, Bt, order))
        assert l1 < 1e-5
        lo, hi = rt.oob_counts(d, Bt, order, torch.from_numpy(c.hap_bits),
                               torch.from_numpy(c.hap_freq),
                               torch.from_numpy(c.hap_allele))
        assert lo <= round(c.oob_accuracy * 2 * int((B == 0).sum())) <= hi
        kept = rt.prefixes(c.hap_allele, c.hap_bits)
        assert rt.search_gap(d, 77, cid, 5, order, 256, kept) == 0.0
        # the same path cut after its first SNP, or with a later SNP
        # swapped for one the search did not take, is not
        assert rt.search_gap(d, 77, cid, 5, order[:1], 256, kept) > 1.0
        other = next(x for x in range(P) if x not in order)
        assert rt.search_gap(d, 77, cid, 5, order[:2] + [other], 256,
                             kept) > 1.0


def test_draws_decide_a_maybe_snp_when_a_draw_reaches_it():
    rank = np.array([5, 2, 7, 0, 1, 3, 4, 6])
    pool = frozenset({0, 1, 2, 3})
    # SNP 5 may be in the pool and ranks first: drawn both ways
    got = rt._draws(rank, pool, frozenset({5, 6}), 2)
    assert [(c, i) for c, i, _, _ in got] == [([5, 2], [True, True]),
                                              ([2, 0], [True, True])]
    assert got[0][3] == got[1][3] == frozenset({6})   # 6 not reached
    # short of the pool: the rest in ascending index, outside the pool
    got = rt._draws(rank, frozenset({4}), frozenset(), 3)
    assert got == [([4, 0, 1], [True, False, False], frozenset({4}),
                    frozenset())]


def test_launch_gap():
    from portbench.reference import judge

    expect = {"ens_acc": [1, None], "post_scores": [0, 0]}
    assert judge.launches({"ens_acc": 30, "post_scores": 0}, 28, expect) == 0
    assert judge.launches({"ens_acc": 0, "post_scores": 0}, 28, expect) == 28
    assert judge.launches({"ens_acc": 28, "post_scores": 3}, 28, expect) == 3
