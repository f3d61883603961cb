"""The port's post-training surface (models/publish.py, models/introspect.py,
eval/compare.py, data/misc.py) against hibag_tpu's, on a model the port
trains on a synthetic panel and hibag_tpu loads from the shared .npz
format, on the CPU."""

import os

import numpy as np
import pytest
import torch

import hibag_tpu
import hibag_tpu_torch
from hibag_tpu_torch.utils.synthetic import synthetic_panel
from tests.test_torch_train import _jax_data

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4-classifier model trained by the port (host mode) on 120 typed
    samples, the same model loaded by hibag_tpu, the training and the 40
    held-out samples in both packages' containers, and the port's
    predictions of the held-out samples."""
    (table, geno), (htable, hgeno) = synthetic_panel(3, 120, 60, 6,
                                                     n_held_out=40)
    model = hibag_tpu_torch.train_parallel(
        table, geno, n_classifiers=4, seed=7, verbose=False, mode="host",
        device="cpu")
    path = str(tmp_path_factory.mktemp("model") / "m.npz")
    model.save(path)
    jmodel = hibag_tpu.AttrBagModel.load(path)
    pred = hibag_tpu_torch.predict(model, hgeno, device="cpu",
                                   with_prob=True)
    return dict(model=model, jmodel=jmodel, path=path,
                train=(table, geno), jtrain=_jax_data(table, geno),
                held=(htable, hgeno), jheld=_jax_data(htable, hgeno),
                pred=pred)


def _assert_equal_values(a, b):
    """Equal nested results: dicts and dataclasses field by field, float
    arrays with NaN equal to NaN."""
    if hasattr(a, "__dataclass_fields__"):
        a, b = vars(a), vars(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_equal_values(a[k], b[k])
        return
    if isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_values(x, y)
        return
    x, y = np.asarray(a), np.asarray(b)
    if x.dtype.kind == "f" or y.dtype.kind == "f":
        np.testing.assert_array_equal(x.astype(float), y.astype(float))
    else:
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(allele_limit="model", call_threshold=0.5, output_individual=True),
    dict(max_resolution="1-field", match_threshold=0.0)])
def test_compare_alleles(trained, kw):
    htable, _ = trained["held"]
    jtable, _ = trained["jheld"]
    pred = trained["pred"]
    limit = kw.pop("allele_limit", None)
    got = hibag_tpu_torch.hlaCompareAllele(
        htable, pred, allele_limit=trained["model"] if limit else None, **kw)
    want = hibag_tpu.compare_alleles(
        jtable, pred, allele_limit=trained["jmodel"] if limit else None,
        **kw)
    _assert_equal_values(got, want)
    assert got.overall["acc.haplo"] > 0.9


def test_confusion_em():
    from hibag_tpu.eval.compare import confusion_em as jconf
    from hibag_tpu_torch.eval.compare import confusion_em

    rng = np.random.default_rng(2)
    init = rng.integers(0, 5, (6, 5)).astype(float)
    wrong = [tuple(int(x) for x in rng.integers(0, 5, 4)) for _ in range(7)]
    np.testing.assert_array_equal(confusion_em(5, init, wrong),
                                  jconf(5, init, wrong))


@pytest.mark.parametrize("rm_unused_snp", [True, False])
def test_publish(trained, rm_unused_snp):
    kw = dict(platform="synthetic array", information="test panel",
              rm_unused_snp=rm_unused_snp)
    got = hibag_tpu_torch.hlaPublish(trained["model"], **kw)
    want = hibag_tpu.publish(trained["jmodel"], **kw)
    assert got.sample_id is None and got.appendix == want.appendix
    for name in ("snp_id", "snp_position", "snp_allele", "snp_allele_freq"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    for a, b in zip(got.classifiers, want.classifiers):
        np.testing.assert_array_equal(a.snp_index, b.snp_index)
        assert a.bootstrap_count is None
    assert (got.n_snp < trained["model"].n_snp) == rm_unused_snp
    # the published model predicts what the trained one does
    _, hgeno = trained["held"]
    res = hibag_tpu_torch.predict(got, hgeno, device="cpu")
    np.testing.assert_array_equal(res.allele1, trained["pred"].allele1)
    np.testing.assert_array_equal(res.allele2, trained["pred"].allele2)


def test_pred_merge(trained):
    model = trained["model"]
    _, hgeno = trained["held"]
    parts = [hibag_tpu_torch.predict(model.subset_classifiers(n), hgeno,
                                     device="cpu", with_prob=True)
             for n in (2, 4)]
    for kw in (dict(), dict(weight=[1.0, 3.0], use_matching=False,
                            ret_postprob=True)):
        got = hibag_tpu_torch.hlaPredMerge(parts, **kw)
        want = hibag_tpu.pred_merge(parts, **kw)
        _assert_equal_values(got, want)


def test_model_files(trained, tmp_path):
    first = str(tmp_path / "a.npz")
    trained["model"].subset_classifiers(1).save(first)
    pattern = [trained["path"], str(tmp_path / "a*.npz"),
               str(tmp_path / "none*.npz")]
    got = hibag_tpu_torch.hlaModelFiles(pattern)
    want = hibag_tpu.model_files(pattern)
    assert got.n_classifiers == want.n_classifiers == 5
    for a, b in zip(got.classifiers, want.classifiers):
        np.testing.assert_array_equal(a.hap_freq, b.hap_freq)
    with pytest.raises(FileNotFoundError):
        hibag_tpu_torch.model_files(pattern, ignore_missing=False)


def test_out_of_bag(trained):
    """Each classifier predicts its own out-of-bag samples (on the CPU
    through the ensemble kernel's plain version, at C = 1)."""
    table, geno = trained["train"]
    jtable, jgeno = trained["jtrain"]
    got = hibag_tpu_torch.hlaOutOfBag(trained["model"], table, geno,
                                      device="cpu")
    want = hibag_tpu.out_of_bag(trained["jmodel"], jtable, jgeno)
    _assert_equal_values(got, want)
    assert got["overall"]["acc.haplo"] > 0.8
    with pytest.raises(ValueError, match="sample IDs"):
        hibag_tpu_torch.out_of_bag(hibag_tpu_torch.publish(trained["model"]),
                                   table, geno, device="cpu")


def test_summarize_and_allele_distance(trained):
    _assert_equal_values(hibag_tpu_torch.summarize(trained["model"]),
                         hibag_tpu.summarize(trained["jmodel"]))
    _assert_equal_values(hibag_tpu_torch.hlaDistance(trained["model"]),
                         hibag_tpu.allele_distance(trained["jmodel"]))


def test_geno_ld_and_ld_matrix(trained):
    table, geno = trained["train"]
    jtable, jgeno = trained["jtrain"]
    _assert_equal_values(hibag_tpu_torch.hlaGenoLD(table, geno),
                         hibag_tpu.geno_ld(jtable, jgeno))
    codes = geno.genotype[:5].T[:, 0]
    _assert_equal_values(hibag_tpu_torch.geno_ld(table, codes),
                         hibag_tpu.geno_ld(jtable, codes))
    _assert_equal_values(hibag_tpu_torch.hlaLDMatrix(geno, maf=0.05),
                         hibag_tpu.ld_matrix(jgeno, maf=0.05))


def test_data_misc(trained):
    table, geno = trained["train"]
    jtable, jgeno = trained["jtrain"]
    model, jmodel = trained["model"], trained["jmodel"]
    a1 = ["A/G", "A/G", "C/T", "A/C", "N/A", "G/T", "bad"]
    a2 = ["G/A", "T/C", "G/A", "A/C", "A/N", "C/A", "A/G"]
    np.testing.assert_array_equal(hibag_tpu_torch.hlaCheckAllele(a1, a2),
                                  hibag_tpu.check_allele(a1, a2))
    sub = geno.subset(snp_mask=np.arange(geno.n_snp) % 3 != 0)
    jsub = jgeno.subset(snp_mask=np.arange(jgeno.n_snp) % 3 != 0)
    _assert_equal_values(hibag_tpu_torch.hlaCheckSNPs(model, sub),
                         hibag_tpu.check_snps(jmodel, jsub))
    _assert_equal_values(
        hibag_tpu_torch.check_snps(model, sub.snp_key("Position")),
        hibag_tpu.check_snps(jmodel, jsub.snp_key("Position")))
    limit = model.hla_alleles[:4]
    for kw in (dict(), dict(allele_limit=limit),
               dict(allele_limit=model, max_resolution="1-field")):
        jkw = dict(kw, allele_limit=jmodel) if kw.get(
            "allele_limit") is model else kw
        np.testing.assert_array_equal(
            hibag_tpu_torch.hlaSampleAllele(table, **kw),
            hibag_tpu.sample_alleles(jtable, **jkw))
    assert hibag_tpu_torch.summary_geno(geno) == hibag_tpu.data.misc \
        .summary_geno(jgeno)
    assert hibag_tpu_torch.summary_table(table) == hibag_tpu.data.misc \
        .summary_table(jtable)
    assert hibag_tpu_torch.summary_model(model) == hibag_tpu.data.misc \
        .summary_model(jmodel)
