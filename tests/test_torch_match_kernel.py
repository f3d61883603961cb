"""The pair-matching kernel (ops/match.py, csrc/match_pairs.cu).

On the CPU: the wrapper's checks, a numpy model of the kernel's arithmetic
(popcount distances over ballot masks, the two slot bitmaps, dmin over the
block pairs, the rows it writes, packed words stored little-endian) against
the plain version models/em.py::match_pairs(engine="torch"), and the
bound portbench/work/match_bounds.py counts at the training
cell's shapes. On a card: the kernel bitwise against the plain version, and
a fused training that matches through it alone.

Imports neither jax nor hibag_tpu, so that on a machine with a card and no
jax it runs as

    python -m pytest tests/test_torch_match_kernel.py -m gpu --noconftest -q

Without a card the tests marked gpu skip.
"""

import numpy as np
import pytest
import torch

from hibag_tpu_torch.models import em
from hibag_tpu_torch.ops import match
from hibag_tpu_torch.ops import train_step as ts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hibag_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _case(seed, K, S, H, A=14, n_slots=None, n_sel=24, same=False,
          missing=(), absent=()):
    """Matching inputs as numpy arrays: K classifiers of H slots, the first
    `n_slots` valid (the rest padding past the live slots) with alleles not
    grouped; samples carrying two of a classifier's first 16 haplotypes, 5%
    of codes missing. `same`: every sample homozygous (a1 == a2); samples
    in `missing` all-missing (every block pair ties); samples in `absent`
    carry an allele no slot has (an empty block)."""
    rng = np.random.default_rng(seed)
    n_slots = H - H // 8 if n_slots is None else n_slots
    bits = np.zeros((K, H, 128), np.float32)
    bits[:, :, :n_sel] = rng.integers(0, 2, (K, H, n_sel))
    valid = np.zeros((K, H), bool)
    valid[:, :n_slots] = True
    allele = rng.integers(0, A, (K, H)).astype(np.int32)
    allele[:, :16] = allele[0, :16]
    pair = rng.integers(0, 16, (2, S))
    if same:
        pair[1] = pair[0]
    geno = np.full((K, S, 128), 3, np.int8)
    geno[:, :, :n_sel] = (bits[:, pair[0], :n_sel]
                          + bits[:, pair[1], :n_sel]).astype(np.int8)
    geno[:, :, :n_sel][rng.random((K, S, n_sel)) < 0.05] = 3
    a12 = np.sort(allele[0][pair], 0).astype(np.int32)
    for s in missing:
        geno[:, s] = 3
    for s in absent:
        a12[1, s] = A + 1
    return dict(bits=bits, valid=valid, allele=allele, geno=geno, a1=a12[0],
                a2=a12[1])


def _args(c, dev="cpu"):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return tuple(t(c[n]) for n in ("bits", "valid", "allele", "geno", "a1",
                                   "a2"))


def _kernel_args(c, dev="cpu"):
    bits, valid, allele, geno, a1, a2 = _args(c, dev)
    return ts.pack_bits(bits), valid, allele, geno, a1, a2


# ---------------------------------------------------------------------------
# the CPU: the kernel's arithmetic and layout, modelled in numpy
# ---------------------------------------------------------------------------

def _popc(x):
    return np.bitwise_count(x).astype(np.int64)


def _words(m):
    """[..., 32 w] {0,1} -> uint32 [..., w]: bit b of word w is entry
    32w + b, as a warp ballot gives it."""
    m = m.reshape(*m.shape[:-1], m.shape[-1] // 32, 32).astype(np.uint64)
    return (m << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _words_le(mask):
    """uint8 {0,1} [..., H] -> uint8 [..., H // 8]: the kernel's 32-column
    words stored little-endian."""
    return _words(mask).astype("<u4").view(np.uint8)


def _kernel_model(c, lo, hi, packed):
    """csrc/match_pairs.cu in numpy: the slots' words from pack_bits, the
    sample's ballot masks, D = a_i + a_j + nhet - popc(x_i ^ x_j), the two
    slot bitmaps, dmin over ok1 x ok2 only, and the rows."""
    hb = ts.pack_bits(torch.from_numpy(c["bits"])).numpy().view(np.uint32)
    K, H = c["valid"].shape
    out = np.zeros((K, hi - lo, H, H), np.uint8)
    for k in range(K):
        for s in range(lo, hi):
            g = c["geno"][k, s]
            o0, o1, o2 = (_words(g == v) for v in (0, 1, 2))
            x = hb[k] & o1
            a = (_popc(hb[k] & o0) + _popc(~hb[k] & o2)).sum(-1)
            D = (a[:, None] + a[None, :] + _popc(o1).sum()
                 - _popc(x[:, None, :] ^ x[None, :, :]).sum(-1))
            ok = c["valid"][k] & (c["allele"][k] == c["a1"][s])
            ok2 = c["valid"][k] & (c["allele"][k] == c["a2"][s])
            if not (ok.any() and ok2.any()):
                continue
            dmin = D[np.ix_(ok, ok2)].min()
            rows = (ok[:, None] & ok2[None, :]) | (ok2[:, None] & ok[None, :])
            out[k, s - lo] = rows & (D == dmin)
    return _words_le(out) if packed else out


MODEL_CASES = {
    "two samples chunks": dict(seed=0, K=2, S=300, H=64),
    "empty block": dict(seed=1, K=2, S=24, H=96, absent=(3, 7)),
    "a1 == a2": dict(seed=2, K=2, S=24, H=64, same=True),
    "all missing": dict(seed=3, K=1, S=16, H=64, missing=(0, 5)),
    "padded slots": dict(seed=4, K=2, S=20, H=128, n_slots=40),
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_kernel_model_equals_plain_version(name):
    c = _case(**MODEL_CASES[name])
    S = c["geno"].shape[1]
    lo, hi = (3, S - 2)
    plain = em.match_pairs(*_args(c), lo, hi, engine="torch").numpy()
    model = _kernel_model(c, lo, hi, packed=False)
    np.testing.assert_array_equal(model, plain.astype(np.uint8))
    np.testing.assert_array_equal(
        _kernel_model(c, 0, S, packed=True),
        em.match_pairs_packed(*_args(c), engine="torch").numpy())
    if name == "all missing":
        # every pair of the blocks ties at D = 0
        assert model[0, 0].sum() > 1


def test_ballot_words_are_pack_mask_bytes():
    mask = torch.from_numpy(np.random.default_rng(5).random((3, 7, 96))
                            < 0.3)
    np.testing.assert_array_equal(_words_le(mask.numpy().astype(np.uint8)),
                                  em._pack_mask(mask).numpy())


BAD = {
    "cpu tensors": (lambda a: a, "CUDA tensors only"),
    "hb float": (lambda a: (a[0].float(), *a[1:]), "hb must be int32"),
    "valid uint8": (lambda a: (a[0], a[1].to(torch.uint8), *a[2:]),
                    "valid must be bool"),
    "allele int64": (lambda a: (*a[:2], a[2].long(), *a[3:]),
                     "allele must be int32"),
    "geno int32": (lambda a: (*a[:3], a[3].int(), *a[4:]),
                   "geno_sel must be int8"),
    "a1 int64": (lambda a: (*a[:4], a[4].long(), a[5]),
                 "a1 and a2 must be int32"),
    "H not a multiple of 32": (lambda a: (a[0][:, :40].contiguous(),
                                          a[1][:, :40].contiguous(),
                                          a[2][:, :40].contiguous(), *a[3:]),
                               "multiples of"),
    "geno of 64 SNPs": (lambda a: (*a[:3], a[3][..., :64].contiguous(),
                                   *a[4:]), "geno_sel must be int8"),
    "a2 short": (lambda a: (*a[:5], a[5][:-1].contiguous()),
                 "a1 and a2 must be int32"),
}


@pytest.mark.parametrize("what", list(BAD))
def test_wrapper_raises(what):
    change, msg = BAD[what]
    args = change(_kernel_args(_case(6, 2, 10, 64)))
    with pytest.raises(ValueError, match=msg):
        match.match_pairs_kernel(*args)


def test_wrapper_raises_on_a_range_past_the_samples():
    with pytest.raises(ValueError, match="outside"):
        match.match_pairs_kernel(*_kernel_args(_case(6, 2, 10, 64)), 4, 11)


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        em.match_pairs(*_args(_case(6, 1, 4, 32)), engine="jnp")


def test_match_bounds_at_the_cell_shapes():
    from portbench.work import match_bounds, peaks

    int8 = match_bounds.match_bytes(8, 1000, 256, False)
    packed = match_bounds.match_bytes(8, 1000, 512, True)
    assert int8 == 524_288_000 + 16 * 8 * 256 + 128 * 8 * 1000
    assert packed == 262_144_000 + 16 * 8 * 512 + 128 * 8 * 1000
    rec = {"name": "match_pairs", "dims": {"K": 8, "n": 1000, "Hp": 256,
                                           "mode": "int8"}}
    assert match_bounds.launch_seconds(rec) == int8 / peaks.MEM_BYTES_PER_S


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

CARD_CASES = {
    "cell int8": dict(seed=10, K=8, S=1000, H=256),
    "cell packed": dict(seed=11, K=8, S=1000, H=512),
    "wide": dict(seed=12, K=1, S=12, H=4160, A=160),
    "empty block": dict(seed=13, K=3, S=64, H=96, absent=(0, 9, 63)),
    "a1 == a2": dict(seed=14, K=3, S=64, H=128, same=True),
    "all missing": dict(seed=15, K=2, S=40, H=64, missing=(0, 1, 39)),
    "padded slots": dict(seed=16, K=2, S=50, H=256, n_slots=200),
}


def _range(name, S):
    return (5, S - 3) if name in ("cell int8", "padded slots") else (0, S)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_equals_plain_version(cuda, name):
    """Bitwise: int8 against the plain mask's int8, packed against its
    _pack_mask, on a sub-range of samples where the case says so; twice."""
    c = _case(**CARD_CASES[name])
    args = _args(c, cuda)
    S = c["geno"].shape[1]
    lo, hi = _range(name, S)
    before = dict(match.LAUNCHES)
    got = em.match_pairs(*args, lo, hi, engine="cuda")
    again = em.match_pairs(*args, lo, hi, engine="cuda")
    pk = em.match_pairs_packed(*args, engine="cuda")
    torch.cuda.synchronize()
    assert match.LAUNCHES["match_pairs"] == before["match_pairs"] + 2
    assert match.LAUNCHES["match_pairs_packed"] \
        == before["match_pairs_packed"] + 1
    assert got.dtype == torch.int8 and pk.dtype == torch.uint8
    assert torch.equal(got, again)
    want = em.match_pairs(*args, lo, hi, engine="torch")
    assert torch.equal(got, want.to(torch.int8))
    assert torch.equal(pk, em.match_pairs_packed(*args, engine="torch"))
    assert bool(want.any())


@pytest.mark.gpu
def test_fused_training_matches_through_the_kernel(cuda, monkeypatch):
    """A fused batch on the card: one matching launch per E-step set-up
    (int8 tier; packed on a freeze resume), and the plain chunk never
    runs."""
    from hibag_tpu_torch import train_parallel
    from hibag_tpu_torch.utils.synthetic import synthetic_panel

    (table, geno), _ = synthetic_panel(2, 200, 80, 8, n_held_out=60)
    setups, chunks = [], []
    make, chunk = em._make_estep, em._match_chunk

    def counted(*a, **k):
        setups.append(1)
        return make(*a, **k)

    def plain(*a, **k):
        chunks.append(1)
        return chunk(*a, **k)

    monkeypatch.setattr(em, "_make_estep", counted)
    monkeypatch.setattr(em, "_match_chunk", plain)
    before = dict(match.LAUNCHES)
    train_parallel(table, geno, n_classifiers=4, batch=4, seed=1,
                   verbose=False, hcap=24, max_steps=60,
                   on_overflow="freeze", with_matching=False, device="cuda",
                   mode="fused")
    launched = sum(match.LAUNCHES[k] - before[k] for k in before)
    assert setups and launched == len(setups)
    assert match.LAUNCHES["match_pairs"] > before["match_pairs"]
    assert not chunks
