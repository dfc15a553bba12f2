"""The card a measurement ran on: its SKU, its name and power limit as
``nvidia-smi`` gives them, and the published peak rates that bounds and
shares of the peak are taken against (NVIDIA data sheets, dense rates, at
the full power limit). ``chip_smoke.py`` and the measurement entry points
(``simulate_2048_tpu_torch.scripts``) read them here, so the two cannot drift.
"""

from __future__ import annotations

import subprocess

# FP32 (CUDA cores, no tensor cores) and dense bf16 tensor-core peaks in TFLOP/s, HBM in TB/s, by SKU.
FP32_TFLOPS = {"H100 SXM": 67.0, "H100 NVL": 60.0, "H100 PCIe": 51.0, "H200": 67.0}
BF16_TFLOPS = {"H100 SXM": 989.0, "H100 NVL": 835.0, "H100 PCIe": 756.0, "H200": 989.0}
HBM_TBPS = {"H100 SXM": 3.35, "H100 NVL": 3.9, "H100 PCIe": 2.0, "H200": 4.8}


def sku(name: str) -> str:
    """The key of the peak tables for a card named ``name`` (``torch.cuda.get_device_name``)."""
    for key in ("H100 NVL", "H100 PCIe", "H200"):
        if all(word in name for word in key.split()):
            return key
    return "H100 SXM"


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else f"nvidia-smi failed: {smi.stderr.strip()}"


def power_limit_w() -> float | None:
    """The card's power limit in watts as ``nvidia-smi`` reports it, None when it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
        )  # fmt: skip
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
