"""Ensemble parallelism over a list of devices and over processes
(counterpart of hibag_tpu/parallel/mesh.py).

The reference scales out by training whole classifiers in independent R
worker processes and concatenating them (hlaParallelAttrBagging +
.DynamicClusterCall, reference R/HIBAG.R:293-451, R/DataUtilities.R:124-213),
and by splitting samples across workers for prediction (R/HIBAG.R:764-807).

Here a mesh is an ordered list of torch devices with the axis name "ens". A
shard is a contiguous range of classifiers on one of them: the ranges are
those of torch.tensor_split, so their sizes differ by at most one, and empty
ones are dropped, so no classifier slot is ever padded. Each shard computes
exactly what the whole batch computes for its classifiers, through the same
kernels; the partial results are combined on ``mesh.devices[0]`` in mesh
order, in float32 and without atomics, so two runs are bitwise equal. A
device may repeat (``["cuda:0", "cuda:0"]``, ``["cpu", "cpu"]``): the split
and the combine then run on one device.

A mesh's devices are all cards or all the CPU. Shards on cards run
concurrently, one host thread each (the kernels' ctypes calls release the
GIL, but the host loops between launches take turns on it). On the CPU
they run one after another in the calling thread: torch's CPU ops already
use the intra-op thread pool, and the CPU evaluation's denormal flush
(models/em.py::flush_denormals) sets the process's thread count for its
duration.

Processes exchange pickled host objects through torch.distributed's gloo
backend (not NCCL: two ranks may share one card).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class EnsembleMesh:
    """An ordered list of devices that the classifier axis is split over."""

    devices: tuple                 # resolved torch.devices; may repeat
    axis_names: tuple = ("ens",)

    @property
    def size(self) -> int:
        return len(self.devices)


def ensemble_mesh(devices=None, name: str = "ens") -> EnsembleMesh:
    """A mesh over `devices` ("cuda:0", "cpu", torch.device, ...; a device
    may repeat; all cards or all the CPU, so every shard runs one engine);
    None means every CUDA device, and raises without one."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)) \
            or not hasattr(devices, "__iter__"):
        raise TypeError(f"a mesh is an EnsembleMesh or a list of devices, "
                        f"not {devices!r}")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh's devices are all cards or all the CPU, "
                         f"not {[str(d) for d in devices]}")
    return EnsembleMesh(tuple(resolve_device(d) for d in devices), (name,))


def as_mesh(mesh) -> Optional[EnsembleMesh]:
    """`mesh` as an EnsembleMesh: None stays None, a list of devices builds
    one."""
    if mesh is None or isinstance(mesh, EnsembleMesh):
        return mesh
    return ensemble_mesh(mesh)


def shard_bounds(mesh: EnsembleMesh, n: int) -> list:
    """[(device, lo, hi)] of the non-empty shards of n classifiers: the
    ranges of torch.tensor_split(range(n), mesh.size), the i-th on
    mesh.devices[i]."""
    parts = torch.tensor_split(torch.arange(n), mesh.size)
    return [(dev, int(p[0]), int(p[-1]) + 1)
            for dev, p in zip(mesh.devices, parts) if len(p)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _put(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.contiguous().to(device)


def shard_ensemble(mesh: EnsembleMesh, tree) -> list:
    """One copy of `tree` (a tuple, list or dict of classifier-major arrays
    or tensors, axis 0 = classifier) per non-empty shard, each leaf's rows
    lo..hi-1 on the shard's device."""
    mesh = as_mesh(mesh)
    leaves = _leaves(tree)
    n = int(leaves[0].shape[0])
    if any(int(x.shape[0]) != n for x in leaves):
        raise ValueError("every leaf needs the same leading (classifier) axis")
    return [_tree_map(lambda x: _put(x[lo:hi], dev), tree)
            for dev, lo, hi in shard_bounds(mesh, n)]


def replicate(mesh: EnsembleMesh, tree) -> list:
    """One copy of `tree` per mesh device, in mesh order; a repeated device
    gets the same tensors, uploaded once."""
    mesh = as_mesh(mesh)
    copies: dict = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = _tree_map(lambda x: _put(x, dev), tree)
    return [copies[dev] for dev in mesh.devices]


def run_shards(devices, fns) -> list:
    """[fn() for fn in fns], shard i's on devices[i]: concurrently, one
    thread each, on cards; in turn in this thread on the CPU. A shard's
    exception propagates once every shard has ended."""
    if len(fns) < 2 or torch.device(devices[0]).type != "cuda":
        return [fn() for fn in fns]
    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
    return [f.result() for f in futures]


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def _group():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> tuple:
    """Join the process group (gloo over TCP at `coordinator`, "host:port")
    and return (process_index, process_count).

    The reference scales across machines with R PSOCK clusters and a job
    farm (.DynamicClusterCall, R/DataUtilities.R:124-213). Without a
    coordinator: the existing group's rank and size, else (0, 1). A second
    call in one process reuses the group (and raises if it names another
    rank or size)."""
    import torch.distributed as dist

    if coordinator is not None and _group() is None:
        if num_processes is None or process_id is None:
            raise ValueError("distributed_init(coordinator=...) needs "
                             "num_processes and process_id")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes),
                                rank=int(process_id))
    g = _group()
    rank, world = (g.get_rank(), g.get_world_size()) if g else (0, 1)
    if coordinator is not None and (
            (num_processes is not None and int(num_processes) != world)
            or (process_id is not None and int(process_id) != rank)):
        raise ValueError(f"this process is already rank {rank} of {world}")
    return rank, world


def _index_count(process_index, process_count) -> tuple:
    g = _group()
    pi = (g.get_rank() if g else 0) if process_index is None \
        else process_index
    pc = (g.get_world_size() if g else 1) if process_count is None \
        else process_count
    return pi, pc


def classifier_range(n_classifiers: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> range:
    """This process's contiguous share of the ensemble (every process
    derives the same partition, so per-classifier RNG seeds stay stable
    whatever the topology)."""
    pi, pc = _index_count(process_index, process_count)
    per = (n_classifiers + pc - 1) // pc
    lo = pi * per
    return range(lo, min(lo + per, n_classifiers))


def sample_range(n_samples: int, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> range:
    """This process's contiguous sample share for distributed prediction."""
    pi, pc = _index_count(process_index, process_count)
    per = (n_samples + pc - 1) // pc
    lo = pi * per
    return range(lo, min(lo + per, n_samples))


def process_device(device="cuda", process_index: Optional[int] = None):
    """The device of this process: "cuda" without an index names card
    process_index % device_count (each process on its node's cards, with
    ranks numbered node by node); any other device is resolved as given.
    Raises where there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        pi, _ = _index_count(process_index, None)
        dev = torch.device("cuda", pi % torch.cuda.device_count())
    return resolve_device(dev)


def allgather_pickled(obj) -> list:
    """Every process's `obj` (any picklable host object), in rank order
    (torch.distributed.all_gather_object). Single process: [obj]."""
    g = _group()
    if g is None:
        return [obj]
    out = [None] * g.get_world_size()
    g.all_gather_object(out, obj)
    return out


def gather_classifiers(local_model, n_classifiers: int):
    """The whole ensemble on every process: each process's classifiers,
    gathered in rank order (the reference's master-side combine,
    hlaCombineModelObj). Single process: `local_model`."""
    if _group() is None or _group().get_world_size() == 1:
        return local_model
    from ..models.model import AttrBagModel

    chunks = allgather_pickled(local_model.to_hibag_obj()["classifiers"])
    obj = local_model.to_hibag_obj()
    obj["classifiers"] = [c for chunk in chunks for c in chunk][:n_classifiers]
    merged = AttrBagModel.from_hibag_obj(obj, locus=local_model.locus)
    merged.sample_id = local_model.sample_id
    return merged


def predict_distributed(model, data, coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None, **kwargs):
    """Prediction over processes: each imputes its contiguous share of the
    samples of `data` (an SNPGenoData) on its own device (`process_device`
    of kwargs' ``device``, default "cuda"), the results are gathered, and
    every process returns the whole cohort's PredictionResult: the
    reference's hlaPredict(cl=) worker split and merge (R/HIBAG.R:764-807).
    Single process: predict(). kwargs go to predict()."""
    from ..models.predict import PredictionResult, predict

    pi, pc = distributed_init(coordinator, num_processes, process_id)
    kwargs["device"] = process_device(kwargs.get("device", "cuda"), pi)
    if pc == 1:
        return predict(model, data, **kwargs)
    rng = sample_range(len(data.sample_id), pi, pc)
    local = predict(model, data.subset(samp_mask=np.asarray(rng, dtype=int)),
                    **kwargs)
    parts = allgather_pickled({
        "sample_id": local.sample_id, "allele1": local.allele1,
        "allele2": local.allele2, "prob": local.prob,
        "matching": local.matching, "dosage": local.dosage,
        "postprob": local.postprob})

    def cat(key, axis=0):
        vals = [p[key] for p in parts]
        if any(v is None for v in vals):
            return None
        return np.concatenate(vals, axis=axis)

    return PredictionResult(
        sample_id=cat("sample_id"), allele1=cat("allele1"),
        allele2=cat("allele2"), prob=cat("prob"), matching=cat("matching"),
        dosage=cat("dosage", axis=1), postprob=cat("postprob", axis=1),
        hla_alleles=local.hla_alleles, locus=local.locus,
        match_info=local.match_info)


# ---------------------------------------------------------------------------
# sharded ensemble posterior
# ---------------------------------------------------------------------------

def sharded_predict(mesh: EnsembleMesh, shards: list, replicas: list,
                    n_alleles: int) -> tuple:
    """Ensemble posterior with the classifiers split over `mesh`.

    shards: shard_ensemble(mesh, (hap_bits [C,Hm,L], hap_freq [C,Hm],
    hap_allele [C,Hm], snp_index [C,L])); replicas: replicate(mesh,
    (snp_weight [P], geno_codes [N,P])). Each shard scores its classifiers
    with the scoring kernel (ops/post_scores.py::ensemble_scores on a card,
    its plain version on the CPU), SCAN_CCHUNK at a time; the weighted
    posteriors and weights are summed over the shards in mesh order
    (models/predict.py::_predict_block_mesh, the scan engine). Returns (ens [N,A,A] weight-normalised, wsum [N]) on mesh.devices[0].
    """
    from ..models.predict import _predict_block_mesh
    from ..ops.ens_acc import pack_haplotypes

    mesh = as_mesh(mesh)
    blocks = []
    for dev, (bits, freq, allele, sidx) in zip(mesh.devices, shards):
        blocks.append((dev, pack_haplotypes(
            bits.cpu().numpy(), freq.cpu().numpy(), allele.cpu().numpy(),
            n_alleles, dev), sidx))
    sw = {dev: rep[0] for dev, rep in zip(mesh.devices, replicas)}
    geno = {dev: rep[1] for dev, rep in zip(mesh.devices, replicas)}
    ens, wsum, _, _ = _predict_block_mesh(blocks, sw, geno, n_alleles,
                                          "prob", use_ens=False)
    return ens, wsum
