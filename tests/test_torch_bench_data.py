"""The port's benchmark datasets (hibag_tpu_torch.utils.bench_data) held
against hibag_tpu.utils.bench_data on one seeded synthetic panel: the
functions take their data as arguments, and both packages must build the
same arrays exactly. `load_ceu` reads the HIBAG package's bundled panel,
which the repository does not hold, so only its refusal is tested."""

import numpy as np
import pytest

import hibag_tpu
from hibag_tpu.data.allele import HLATypeTable as JHLATypeTable
from hibag_tpu.utils import bench_data as ref
from hibag_tpu_torch.utils import bench_data as port
from hibag_tpu_torch.utils.synthetic import (PANEL_RECOMBINATION,
                                             synthetic_panel)


@pytest.fixture(scope="module")
def panel():
    """A typed panel of 150 samples over 1,200 SNPs around HLA-A (hg19)
    in both packages' containers."""
    (table, geno), _ = synthetic_panel(1, 150, 1200, 12,
                                       recombination=PANEL_RECOMBINATION)
    jgeno = hibag_tpu.SNPGenoData(
        genotype=geno.genotype, sample_id=geno.sample_id,
        snp_id=geno.snp_id, snp_position=geno.snp_position,
        snp_allele=geno.snp_allele, assembly=geno.assembly)
    jtable = JHLATypeTable.from_alleles(
        table.sample_id, table.allele1, table.allele2, locus=table.locus,
        assembly="hg19")
    return (table, geno), (jtable, jgeno)


def _same_geno(a, b):
    for f in ("genotype", "sample_id", "snp_id", "snp_position",
              "snp_allele"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.assembly == b.assembly


def test_headline_1000snp_matches(panel):
    (_, geno), (_, jgeno) = panel
    got, want = port.headline_1000snp(geno), ref.headline_1000snp(jgeno)
    assert got.n_snp == 1000
    _same_geno(got, want)


@pytest.mark.parametrize("n_samples,seed", [(1000, 0), (60, 3)])
def test_midscale_1000x266_matches(panel, n_samples, seed):
    """The flank filter, the resampled samples and their alleles equal
    hibag_tpu's."""
    (table, geno), (jtable, jgeno) = panel
    hla, g = port.midscale_1000x266(table, geno, n_samples, seed)
    jhla, jg = ref.midscale_1000x266(jtable, jgeno, n_samples, seed)
    assert g.n_samp == n_samples and 0 < g.n_snp < 1200
    _same_geno(g, jg)
    for f in ("sample_id", "allele1", "allele2"):
        np.testing.assert_array_equal(getattr(hla, f), getattr(jhla, f))
    assert (hla.locus, hla.assembly) == (jhla.locus, jhla.assembly)


def test_load_ceu_needs_the_data_dir(monkeypatch, tmp_path):
    """Without data_dir or HIBAG_REF_DATA load_ceu raises; with a
    directory that lacks the panel it raises as the reader does."""
    monkeypatch.delenv(port.REF_DATA_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match=port.REF_DATA_ENV):
        port.load_ceu()
    monkeypatch.setenv(port.REF_DATA_ENV, str(tmp_path))
    with pytest.raises(OSError):
        port.load_ceu()
