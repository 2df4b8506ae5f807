"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 67 TFLOP/s in float32 outside the tensor cores and
3.35 TB/s of HBM3. A card set below 700 W runs slower under load, so the
harness records the power limit beside every roofline share.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak_of(kind: str) -> Optional[dict]:
    """The peaks of the card called ``kind``; None for an unknown card."""
    return PEAKS.get(kind)
