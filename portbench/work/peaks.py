"""The card's peak rates that rooflines and MFU shares are taken against.

Published figures of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit): 3.35 TB/s of HBM3 and
67 TFLOP/s in float32 outside the tensor cores. The 32-bit population
count has no published peak: it is derived as the SM count times 16
popcounts per clock per SM (CUDA C++ Programming Guide, arithmetic
instruction throughput, compute capability 9.0) times the card's highest
SM clock as ``nvidia-smi`` reads it (``clocks.max.sm``), 1,980 MHz on an
H100 SXM: 4.1818e12 popcounts/s over its 132 SMs.
"""

from __future__ import annotations

import subprocess

MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
POPC_PER_CLOCK_SM = 16


def popc_rate(device_index: int = 0) -> float:
    """Popcounts per second of the card `device_index`: its SM count x
    POPC_PER_CLOCK_SM x nvidia-smi's clocks.max.sm."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    clk_mhz = float(out.splitlines()[device_index])
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * POPC_PER_CLOCK_SM * clk_mhz * 1e6


def least_seconds(nbytes: float, popc: float, flops: float,
                  popc_per_s: float) -> float:
    """The least time the card could take for this work: the larger of the
    bytes over the memory rate and the operations over their peak rates."""
    return max(nbytes / MEM_BYTES_PER_S, popc / popc_per_s,
               flops / F32_FLOP_PER_S)
