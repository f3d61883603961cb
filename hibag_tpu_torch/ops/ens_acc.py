"""Accumulating ensemble posterior: the wrapper of the hand-written CUDA
kernel csrc/ens_acc.cu, and its plain PyTorch version.

Counterpart of hibag_tpu/ops/scoring_pallas.py::ensemble_accumulate_pallas
(with pick_nb and ens_kernel_supported, whose roles `fits` and
`check_limits` take).
For samples n and classifiers c it returns

    ens [N, A, A] = Σ_c wgt[c,n] · Q_c[n] / max(total[c,n], 1e-30)

in the symmetric unordered convention (Q = S with the off-diagonal doubled),
or under `majority` the one-hot vote [wgt > 0] for each classifier's first
row-major maximum of Q, at both mirrors; plus dmin [C, N] and total [C, N].

On a CUDA tensor `ensemble_accumulate` launches the kernel or raises. On a
CPU tensor it runs `ensemble_accumulate_ref`, the same math in torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import MAXNUM_SNP, penalty_table
from ._build import launch, same_device
from .scoring import majority_hits, posterior_scores, unordered_from_S

#: most haplotype slots per classifier the kernel takes
MAX_H = 1024
#: most alleles the kernel takes (two packed A x A triangles in shared memory)
MAX_A = 128

#: kernel launches made by `ensemble_accumulate`; never the plain version's
#: (with tracing on, each launch is also recorded: utils/trace.py::launch)
LAUNCHES = 0


@dataclass(frozen=True)
class PackedHaplotypes:
    """One ensemble's haplotypes in the kernel's layout, on one device.

    Per classifier the valid haplotypes (frequency > 0) come first, grouped
    by allele in a stable order; slots from nh[c] on are padding with
    frequency 0.
    """

    hb: torch.Tensor      # int32 [C, H, 4]: bit l of SNP slot l in word l // 32
    freq: torch.Tensor    # float32 [C, H]
    allele: torch.Tensor  # int32 [C, H]
    nh: torch.Tensor      # int32 [C]: valid slots

    @property
    def n_classifiers(self) -> int:
        return int(self.hb.shape[0])

    @property
    def n_slots(self) -> int:
        return int(self.hb.shape[1])

    def subset(self, c0: int, c1: int) -> "PackedHaplotypes":
        """Classifiers c0..c1-1, as contiguous views."""
        return PackedHaplotypes(hb=self.hb[c0:c1], freq=self.freq[c0:c1],
                                allele=self.allele[c0:c1], nh=self.nh[c0:c1])


def fits(n_slots: int, n_alleles: int) -> bool:
    """Whether the kernel takes classifiers of `n_slots` haplotypes and
    `n_alleles` alleles (predict() sends other models to the scan engine)."""
    return n_slots <= MAX_H and 1 <= n_alleles <= MAX_A


def check_limits(n_slots: int, n_alleles: int) -> None:
    """Raise ValueError for a shape the kernel does not take (not `fits`)."""
    if not fits(n_slots, n_alleles):
        raise ValueError(f"{n_slots} haplotypes per classifier and {n_alleles} "
                         f"alleles: the ensemble kernel takes at most "
                         f"MAX_H={MAX_H} haplotypes and 1..MAX_A={MAX_A} "
                         "alleles")


def pack_haplotypes(bits, freq, allele, n_alleles: int,
                    device) -> PackedHaplotypes:
    """PackedHaplotypes from numpy bits [C, Hs, L] {0,1}, freq [C, Hs] (<= 0
    for padded slots) and allele [C, Hs]. The layout is shared by the
    ensemble kernel and the scoring kernel (ops/post_scores.py); each
    kernel's wrapper checks its own limits on the slot and allele counts."""
    bits = np.asarray(bits)
    freq = np.asarray(freq, dtype=np.float32)
    allele = np.asarray(allele).astype(np.int64)
    C, _, L = bits.shape
    if L != MAXNUM_SNP:
        raise ValueError(f"haplotypes have {L} SNP slots, expected {MAXNUM_SNP}")
    valid = freq > 0
    nh = valid.sum(axis=1)
    if C == 0 or (nh == 0).any():
        raise ValueError("every classifier needs a haplotype of positive "
                         "frequency")
    if ((allele < 0) | (allele >= n_alleles))[valid].any():
        raise ValueError(f"haplotype allele index outside [0, {n_alleles})")
    H = int(nh.max())
    order = np.argsort(np.where(valid, allele, n_alleles), axis=1,
                       kind="stable")[:, :H]
    keep = np.take_along_axis(valid, order, 1)
    b = np.take_along_axis(bits, order[..., None], 1).astype(np.uint8)
    words = np.packbits(b, axis=-1, bitorder="little").view("<u4")

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return PackedHaplotypes(
        hb=t(words.view(np.int32)),
        freq=t(np.where(keep, np.take_along_axis(freq, order, 1), 0.0)
               .astype(np.float32)),
        allele=t(np.where(keep, np.take_along_axis(allele, order, 1), 0)
                 .astype(np.int32)),
        nh=t(nh.astype(np.int32)))


def unpack_bits(hb: torch.Tensor) -> torch.Tensor:
    """int32 [..., 4] haplotype words → float32 [..., 128] {0,1} bits."""
    shifts = torch.arange(32, device=hb.device, dtype=torch.int32)
    bits = (hb[..., None] >> shifts) & 1
    return bits.reshape(*hb.shape[:-1], 4 * 32).to(torch.float32)


def check_inputs(hap: PackedHaplotypes, g: torch.Tensor) -> None:
    """Raise ValueError unless hap's tensors and the codes g int8 [C, N, 128]
    have the layout the kernels take, contiguous and on one device."""
    C, H = hap.n_classifiers, hap.n_slots
    if tuple(hap.hb.shape) != (C, H, 4) or hap.hb.dtype != torch.int32:
        raise ValueError("hb must be int32 [C, H, 4]")
    if (tuple(hap.freq.shape) != (C, H) or hap.freq.dtype != torch.float32
            or tuple(hap.allele.shape) != (C, H)
            or hap.allele.dtype != torch.int32
            or tuple(hap.nh.shape) != (C,) or hap.nh.dtype != torch.int32):
        raise ValueError("freq f32 [C, H], allele int32 [C, H] and nh int32 "
                         "[C] expected")
    if g.dtype != torch.int8 or g.dim() != 3 or g.shape[0] != C \
            or g.shape[2] != MAXNUM_SNP:
        raise ValueError(f"g must be int8 [C={C}, N, {MAXNUM_SNP}], got "
                         f"{g.dtype} {tuple(g.shape)}")
    same_device(g, hap.hb, hap.freq, hap.allele, hap.nh)


def _check(hap: PackedHaplotypes, g, wgt, n_alleles):
    check_limits(hap.n_slots, n_alleles)
    check_inputs(hap, g)
    C = hap.n_classifiers
    if wgt.dtype != torch.float32 or tuple(wgt.shape) != (C, g.shape[1]):
        raise ValueError(f"wgt must be float32 [{C}, {g.shape[1]}]")
    same_device(g, wgt)


_PEN_TABLE: dict = {}


def _pen_table(device) -> torch.Tensor:
    tab = _PEN_TABLE.get(device)
    if tab is None:
        tab = torch.from_numpy(penalty_table(np.float32)).to(device)
        _PEN_TABLE[device] = tab
    return tab


def ensemble_accumulate(hap: PackedHaplotypes, g: torch.Tensor,
                        wgt: torch.Tensor, n_alleles: int,
                        majority: bool = False):
    """(ens [N, A, A], dmin [C, N], total [C, N]) for genotype codes g int8
    [C, N, 128] gathered to each classifier's SNP slots (3 = missing or
    padded) and classifier weights wgt float32 [C, N]."""
    _check(hap, g, wgt, n_alleles)
    if g.device.type == "cpu":
        return ensemble_accumulate_ref(hap, g, wgt, n_alleles, majority)
    C, N, A = hap.n_classifiers, int(g.shape[1]), n_alleles
    dev = g.device
    ens = torch.empty((N, A, A), dtype=torch.float32, device=dev)
    dmin = torch.empty((C, N), dtype=torch.float32, device=dev)
    total = torch.empty((C, N), dtype=torch.float32, device=dev)
    if N == 0:
        return ens, dmin, total
    launch("hibag_ens_acc", "ens_acc",
           {"C": C, "N": N, "H": hap.n_slots, "A": A}, dev, hap.hb, hap.freq,
           hap.allele, hap.nh, g, wgt, _pen_table(dev), ens, dmin, total, C,
           hap.n_slots, N, A, int(majority), tally=(globals(), "LAUNCHES"))
    return ens, dmin, total


def ensemble_accumulate_ref(hap: PackedHaplotypes, g: torch.Tensor,
                            wgt: torch.Tensor, n_alleles: int,
                            majority: bool = False):
    """Plain PyTorch version of `ensemble_accumulate`, one classifier at a
    time through ops.scoring.posterior_scores. Same inputs and outputs."""
    C, N, A = hap.n_classifiers, int(g.shape[1]), n_alleles
    bits = unpack_bits(hap.hb)
    ens = torch.zeros((N, A, A), dtype=torch.float32, device=g.device)
    dmin = torch.empty((C, N), dtype=torch.float32, device=g.device)
    total = torch.empty((C, N), dtype=torch.float32, device=g.device)
    for c in range(C):
        res = posterior_scores(bits[c], hap.freq[c], hap.allele[c], g[c], A)
        Q = unordered_from_S(res["S"])
        w = wgt[c]
        if majority:
            contrib = majority_hits(Q) * (w > 0)[:, None, None]
        else:
            contrib = Q * (w / res["total"].clamp_min(1e-30))[:, None, None]
        ens += contrib
        dmin[c] = res["dmin"]
        total[c] = res["total"]
    return ens, dmin, total
