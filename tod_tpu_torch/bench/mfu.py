"""Peak rates for MFU, by NVIDIA card and dtype (counterpart of the JAX
package's ``bench/mfu.py``, whose table holds TPUs).

The rates are NVIDIA's data-sheet peaks for dense tensor-core work, without
sparsity.  They assume the card's full power limit (700 W for the H100
SXM); a card set below it runs slower under load, so whoever reports a
share of these peaks reports the card's power limit beside it
(``nvidia-smi --query-gpu=power.limit``).  Matching is most specific key
first, on ``torch.cuda.get_device_name``; an unknown name gives ``None``
(MFU unknown, never wrong).
"""

from __future__ import annotations

# (match substring, bf16 peak FLOP/s, int8 peak OP/s); first hit wins, so
# the more specific keys come first
_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 80gb hbm3", 989e12, 1979e12),  # H100 SXM5, as torch names it
    ("h100 sxm", 989e12, 1979e12),
    ("h100 pcie", 756e12, 1513e12),
)


def peak_flops(device_name: str, dtype: str = "bf16") -> float | None:
    """Peak FLOP/s (int8: OP/s) of the card named ``device_name``, else None."""
    name = device_name.lower()
    for key, bf16, int8 in _PEAKS:
        if key in name:
            return int8 if dtype == "int8" else bf16
    return None
