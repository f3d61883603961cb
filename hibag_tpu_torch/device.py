"""Device selection for the PyTorch port.

The device is always named by the caller. Asking for ``"cuda"`` on a
machine without a usable card raises; nothing falls back to the CPU, so a
run that was meant for the card can never quietly time the host instead.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` ("cuda", "cuda:1", "cpu" or a torch.device) as a concrete
    torch.device.

    Also turns TF32 off for float32 matmuls and convolutions: TF32 keeps 10
    mantissa bits, and the plain reference versions of the kernels must run
    in full float32 to be held against the kernels and against hibag_tpu.
    """
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False (no CUDA card or a CPU-only torch build)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
