"""hibag_tpu_torch — HLA genotype imputation by attribute bagging, in
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of hibag_tpu (JAX/Pallas on a TPU) to PyTorch and CUDA on an H100.
It imports torch and numpy and never jax; hibag_tpu stays the reference the
port is tested against. Ported so far: ensemble prediction on one device
(`predict`, `hlaPredict`) and fused classifier training on one device
(`train_parallel`, `hlaParallelAttrBagging`), with the model containers and
the shared ``.npz`` model format.
"""

__version__ = "0.1.0"

from .constants import MAXNUM_SNP, MIN_RARE_FREQ
from .data.allele import HLATypeTable
from .data.geno import SNPGenoData, align_to_model
from .models.model import AttrBagModel, Classifier, PackedEnsemble
from .models.predict import PredictionResult, predict
from .models.train import train_parallel

# R-API compatibility aliases (hla* names from the reference's NAMESPACE)
hlaPredict = predict
hlaParallelAttrBagging = train_parallel


def hlaModelFromObj(obj: dict, locus=None) -> AttrBagModel:
    """Rebuild a model from an hlaAttrBagObj-schema dict (or one decoded
    from an R .RData file)."""
    return AttrBagModel.from_hibag_obj(obj, locus=locus)
