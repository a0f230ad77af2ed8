"""Published peaks of the cards the benchmark runs on (NVIDIA data sheets,
dense rates at the full power limit): HBM bytes a second. A share of a
roofline is stated against these, with the card's power limit beside it.
"""

from __future__ import annotations

# longest name first: "H100 NVL" and "H100 PCIe" before the SXM "H100"
BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
               ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


def bytes_per_s(card: str) -> float:
    """The HBM peak of the card named ``card`` (``torch.cuda.get_device_name``)."""
    for key, bw in BYTES_PER_S:
        if key in card:
            return bw
    raise KeyError(f"no published peak for {card!r}")
