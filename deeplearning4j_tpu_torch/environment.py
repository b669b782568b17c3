"""Where the port runs, and what card it runs on.

Counterpart of ``deeplearning4j_tpu/environment.py``. The port's entry
points run on the CUDA card unless the caller asks for the CPU with
``device="cpu"``; with no card and no such request they raise rather
than carry on quietly on the CPU.
"""
from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def default_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless ``device`` says otherwise; raises when the device
    asked for (or the default ``cuda``) is not there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_info() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
