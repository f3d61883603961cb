"""Bytes of one launch of the pair-matching kernel, from the launch's own
inputs alone, whatever implements it.

Over the dims of a ``match_pairs`` / ``match_pairs_packed`` launch record
(``hibag_tpu_torch/ops/match.py``: K classifiers, n samples, Hp slots, the
output mode): the mask written, K * n * Hp * Hp bytes as int8 or an eighth
of that bit-packed; the slots' bits read, 16 bytes a slot (128 SNPs); the
samples' selected codes read, 128 bytes a sample and classifier. The
distances (a few hundred pairs a sample, inside its two allele blocks) are
left out: the write bounds the launch.
"""

from __future__ import annotations

from .peaks import least_seconds

#: SNP slots of a classifier (HIBAG's MAXNUM_SNP)
SLOTS = 128
MATCH_KERNELS = ("match_pairs", "match_pairs_packed")


def match_bytes(K, n, Hp, packed: bool) -> float:
    """Bytes in and out of one matching launch of K classifiers, n samples
    and Hp slots."""
    mask = K * n * Hp * Hp // (8 if packed else 1)
    return float(mask + SLOTS // 8 * K * Hp + SLOTS * K * n)


def launch_seconds(rec) -> float:
    """The least time the card needs for the launch record `rec` (a dict of
    name and dims, as ``trace.snapshot()`` gives it): its bytes over the
    memory rate."""
    d = rec["dims"]
    nbytes = match_bytes(d["K"], d["n"], d["Hp"], d["mode"] == "packed")
    return least_seconds(nbytes, 0.0, 0.0, 1.0)
