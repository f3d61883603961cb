"""hibag_tpu_torch — HLA genotype imputation by attribute bagging, in
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of hibag_tpu (JAX/Pallas on a TPU) to PyTorch and CUDA on an H100.
It imports torch and numpy and never jax; hibag_tpu stays the reference the
port is tested against. Ported so far, on one device: ensemble prediction
(`predict`, `hlaPredict`; engines "auto", "pallas" and "jnp"); classifier
training, fused (`train_parallel`, `hlaParallelAttrBagging`) and on the
host loop with the R RNG stream (`train`, `hlaAttrBagging`,
``train_parallel(mode="host")``); the post-training surface (`out_of_bag`,
`publish`, `pred_merge`, `model_files`, `compare_alleles`, `summarize`,
`allele_distance`, `geno_ld`, `ld_matrix`, the `data.misc` checks and
summaries); the model containers and the shared ``.npz`` model format; the
files: PLINK ``.bed`` (`read_bed`, `write_ped`), VCF in (`read_vcf`) and
out (`write_vcf`, BGZF ``.vcf.gz``), GDS (`read_gds`), R ``.RData``/``.rds``
(`read_rdata`, `read_rds`, `r_to_py`, `save_rdata`, `model_to_robj`); the
genotype helpers (`switch_strand`, `combine_geno`); `report`, the
association tests (`assoc_test`, `aa_assoc_test`, `format_assoc`) and the
matplotlib plots; the amino-acid conversion (`convert_table`,
`hlaConvSequence`, `conv_sequence`, `AASeqTable`, `format_residue_table`);
the benchmark datasets (`utils.bench_data`); the CLI, ``python -m
hibag_tpu_torch impute|train|convert|summary|report``
(hibag_tpu_torch/cli.py); and many devices and processes: ``predict(mesh=,
devices=)`` and ``train_parallel(mesh=)`` split the classifiers over a list
of devices (`parallel.mesh.ensemble_mesh`), and `train_distributed`,
`train_dynamic` and `parallel.mesh.predict_distributed` run over processes
(torch.distributed, gloo).
"""

__version__ = "0.1.0"

from .constants import MAXNUM_SNP, MIN_RARE_FREQ
from .data.allele import (HLATypeTable, allele_digit, flanking_snps,
                          loci_info, sort_alleles, split_alleles,
                          unique_alleles)
from .data.geno import (SNPGenoData, align_to_model, combine_geno,
                        switch_strand)
from .data.misc import (check_allele, check_snps, sample_alleles,
                        summary_geno, summary_model, summary_table)
from .eval.assoc import aa_assoc_test, assoc_test, format_assoc
from .eval.compare import compare_alleles
from .eval.plots import (plot_call_rate, plot_call_threshold,
                         plot_ld_heatmap, plot_matching, plot_model)
from .eval.report import report
from .io.bed import read_bed, write_ped
from .io.gds import read_gds
from .io.rdata import r_to_py, read_rdata, read_rds
from .io.vcf import write_vcf
from .io.vcf_in import read_vcf
from .models.introspect import allele_distance, geno_ld, ld_matrix, summarize
from .models.model import AttrBagModel, Classifier, PackedEnsemble
from .models.predict import PredictionResult, predict
from .models.publish import (model_files, model_to_robj, out_of_bag,
                             pred_merge, publish, save_rdata)
from .models.train import (train, train_distributed, train_dynamic,
                           train_parallel)
from .seq.aa import (AASeqTable, conv_sequence, convert_table,
                     format_residue_table)
from .utils.rng import RRng

# R-API compatibility aliases (hla* names from the reference's NAMESPACE,
# as hibag_tpu/__init__.py names them)
hlaAttrBagging = train
hlaParallelAttrBagging = train_parallel
hlaPredict = predict
hlaPredMerge = pred_merge
hlaCompareAllele = compare_alleles


def hlaAssocTest(obj, y, **kwargs):
    """Dispatch on input type like the reference's S3 generic: allele
    tables run per-allele tests; amino-acid tables (with `start_position`
    and `reference`, as hibag_tpu's AASeqTable) run per-position tests."""
    if hasattr(obj, "start_position") and hasattr(obj, "reference"):
        return aa_assoc_test(obj, y, **kwargs)
    return assoc_test(obj, y, **kwargs)


hlaAllele = HLATypeTable.from_alleles
hlaAlleleDigit = allele_digit
hlaUniqueAllele = unique_alleles
hlaSplitAllele = split_alleles
hlaFlankingSNP = flanking_snps
hlaLociInfo = loci_info
hlaBED2Geno = read_bed
hlaGeno2PED = write_ped
hlaAlleleToVCF = write_vcf
hlaVCF2Geno = read_vcf
hlaGDS2Geno = read_gds
hlaGenoCombine = combine_geno
hlaGenoSwitchStrand = switch_strand
hlaPublish = publish
hlaModelFiles = model_files
hlaOutOfBag = out_of_bag
hlaDistance = allele_distance
hlaGenoLD = geno_ld
hlaLDMatrix = ld_matrix
hlaConvSequence = convert_table
hlaReport = report
hlaCheckAllele = check_allele
hlaCheckSNPs = check_snps
hlaSampleAllele = sample_alleles


def hlaReportPlot(pred=None, truth=None, model=None, fig="matching",
                  **kwargs):
    """Dispatch to the matplotlib diagnostic plots (hlaReportPlot,
    R/DataUtilities.R:2429)."""
    if fig == "matching":
        return plot_matching(pred=pred, model=model, **kwargs)
    if fig == "call.rate":
        return plot_call_rate(pred, truth, **kwargs)
    if fig == "call.threshold":
        return plot_call_threshold(pred, truth, **kwargs)
    raise ValueError(f"unknown fig {fig!r}")


def hlaCombineAllele(h1: HLATypeTable, h2: HLATypeTable) -> HLATypeTable:
    """Concatenate two HLA type tables with disjoint sample sets
    (reference R/DataUtilities.R:1287-1316)."""
    return h1.combine(h2)


def hlaSetKernelTarget(cpu: str = "max"):
    """Compatibility shim for the reference's SIMD-target selector
    (R/HIBAG.R hlaSetKernelTarget, src/HIBAG.cpp kernel dispatch).

    The CUDA kernels are compiled for the card, so there is nothing to
    switch; returns the torch device's description (the card's name from
    torch.cuda.get_device_name, or "cpu" without one) the way the
    reference returns the chosen CPU flags."""
    import torch
    if torch.cuda.is_available():
        return {"target": cpu, "backend": "cuda",
                "device": torch.cuda.get_device_name()}
    return {"target": cpu, "backend": "cpu", "device": "cpu"}


def hlaMakeSNPGeno(genotype, sample_id, snp_id, snp_position, A_allele,
                   B_allele, assembly="auto"):
    """hlaMakeSNPGeno equivalent (R/DataUtilities.R:252)."""
    import numpy as _np
    allele = _np.array([f"{a}/{b}" for a, b in zip(A_allele, B_allele)],
                       dtype=object)
    return SNPGenoData(genotype=genotype, sample_id=sample_id, snp_id=snp_id,
                       snp_position=snp_position, snp_allele=allele,
                       assembly=assembly)


def hlaSNPID(obj, match_type="Position"):
    return obj.snp_key(match_type)


def hlaGenoAFreq(g):
    return g.allele_freq()


def hlaGenoMFreq(g):
    return g.maf()


def hlaGenoMRate(g):
    return g.missing_rate_snp()


def hlaGenoMRate_Samp(g):
    return g.missing_rate_samp()


def hlaGenoSubset(g, snp_sel=None, samp_sel=None):
    return g.subset(snp_mask=snp_sel, samp_mask=samp_sel)


def hlaGenoSubsetFlank(g, locus="any", flank_bp=500_000, assembly="hg19",
                       pos_mid=None):
    """Subset genotypes to the flanking region of a locus
    (hlaGenoSubsetFlank, R/DataUtilities.R:360)."""
    import numpy as _np
    ids = flanking_snps(g.snp_id, g.snp_position, locus, flank_bp,
                        assembly, pos_mid)
    return g.subset(snp_mask=_np.isin(g.snp_id.astype(str), ids.astype(str)))


def hlaAlleleSubset(t, samp_sel):
    return t.subset(samp_sel)


def hlaClose(model):
    """No-op: models are plain data, not native handles (reference
    hlaClose frees a C++ model slot, R/HIBAG.R:458)."""
    return None


def hlaModelToObj(model: AttrBagModel) -> dict:
    """Serialize to the reference's hlaAttrBagObj schema (plain dict)."""
    return model.to_hibag_obj()


def hlaModelFromObj(obj: dict, locus=None) -> AttrBagModel:
    """Rebuild a model from an hlaAttrBagObj-schema dict (or one decoded
    from an R .RData file via read_rdata + r_to_py)."""
    return AttrBagModel.from_hibag_obj(obj, locus=locus)


def hlaCombineModelObj(a: AttrBagModel, b: AttrBagModel) -> AttrBagModel:
    return a.combine(b)


def hlaSubModelObj(model: AttrBagModel, n: int) -> AttrBagModel:
    return model.subset_classifiers(n)
