"""hibag_tpu_torch — HLA genotype imputation by attribute bagging, in
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of hibag_tpu (JAX/Pallas on a TPU) to PyTorch and CUDA on an H100.
It imports torch and numpy and never jax; hibag_tpu stays the reference the
port is tested against. Ported so far, on one device: ensemble prediction
(`predict`, `hlaPredict`); classifier training, fused (`train_parallel`,
`hlaParallelAttrBagging`) and on the host loop with the R RNG stream
(`train`, `hlaAttrBagging`, ``train_parallel(mode="host")``); the
post-training surface (`out_of_bag`, `publish`, `pred_merge`,
`model_files`, `compare_alleles`, `summarize`, `allele_distance`,
`geno_ld`, `ld_matrix`, the `data.misc` checks and summaries); the model
containers and the shared ``.npz`` model format.
"""

__version__ = "0.1.0"

from .constants import MAXNUM_SNP, MIN_RARE_FREQ
from .data.allele import HLATypeTable
from .data.geno import SNPGenoData, align_to_model
from .data.misc import (check_allele, check_snps, sample_alleles,
                        summary_geno, summary_model, summary_table)
from .eval.compare import compare_alleles
from .models.introspect import allele_distance, geno_ld, ld_matrix, summarize
from .models.model import AttrBagModel, Classifier, PackedEnsemble
from .models.predict import PredictionResult, predict
from .models.publish import model_files, out_of_bag, pred_merge, publish
from .models.train import train, train_parallel
from .utils.rng import RRng

# R-API compatibility aliases (hla* names from the reference's NAMESPACE)
hlaAttrBagging = train
hlaParallelAttrBagging = train_parallel
hlaPredict = predict
hlaPredMerge = pred_merge
hlaCompareAllele = compare_alleles
hlaPublish = publish
hlaModelFiles = model_files
hlaOutOfBag = out_of_bag
hlaDistance = allele_distance
hlaGenoLD = geno_ld
hlaLDMatrix = ld_matrix
hlaCheckAllele = check_allele
hlaCheckSNPs = check_snps
hlaSampleAllele = sample_alleles


def hlaModelFromObj(obj: dict, locus=None) -> AttrBagModel:
    """Rebuild a model from an hlaAttrBagObj-schema dict (or one decoded
    from an R .RData file)."""
    return AttrBagModel.from_hibag_obj(obj, locus=locus)
