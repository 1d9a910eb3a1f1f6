"""The card a run measures on: the check that it is there, its record for
the result line, and the peaks every roofline and mfu is taken against."""

from __future__ import annotations

import shutil
import subprocess
import sys

# NVIDIA H100 SXM data sheet, dense rates: TF32 on the tensor cores and HBM3
# bandwidth. Every roofline and mfu of the benchmark is a share of these,
# whatever the card's power limit (recorded beside them).
PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12


class NoCard(RuntimeError):
    """The run asked for more cards than the machine has."""


def require_cards(n: int):
    """The torch module, once at least ``n`` CUDA devices are visible. A
    measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark runs only "
                     "on an NVIDIA GPU")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards, torch sees "
                     f"{torch.cuda.device_count()}")
    return torch


def power_limit_w():
    """The card's power limit in watts as nvidia-smi reads it, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        print(f"nvidia-smi: {exc}", file=sys.stderr)
        return None
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def record(n_cards: int, peak_bytes: int, power_w=None) -> dict:
    """The result line's ``device``: platform, the card's name, the cards
    used and the peak memory of the fullest."""
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n_cards,
           "memory_peak_bytes": int(peak_bytes)}
    if power_w is not None:
        rec["power_limit_w"] = power_w
    return rec


def sync(dev):
    """Wait for the card (nothing to wait for on the CPU of a test)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
