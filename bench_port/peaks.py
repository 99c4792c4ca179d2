"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the full
700 W power limit: HBM3 3.35 TB/s; float32 outside the tensor cores 67
TFLOP/s; TF32 495 TFLOP/s; bfloat16 and float16 989 TFLOP/s; fp8 1,979
TFLOP/s.  A card that is not in the table is refused: a share of a
guessed peak means nothing.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_s": 3.35e12,
        "float32": 67e12,
        "tf32": 495e12,
        "bfloat16": 989e12,
        "float16": 989e12,
        "fp8": 1979e12,
    },
}


def peaks(card: str) -> dict:
    if card not in PEAKS:
        raise SystemExit(f"no published peaks for the card {card!r}: add "
                         "its data sheet's figures to bench_port/peaks.py")
    return PEAKS[card]


def compute_peak(card: str, config: dict) -> float:
    """The dense FLOP/s of the configuration's compute precision: its
    ``compute_dtype``, or TF32 for float32 when the configuration allows
    TF32 in cuDNN."""
    table = peaks(card)
    dtype = config["compute_dtype"]
    if dtype == "float32" and config["cudnn_allow_tf32"]:
        return table["tf32"]
    return table[dtype]


def kernel_bound_s(card: str, n_bytes: float, flops: float) -> float:
    """The least time of a kernel on ``card``: bytes over the memory rate
    or float32 operations over the float32 rate, the larger."""
    table = peaks(card)
    return max(n_bytes / table["hbm_bytes_s"], flops / table["float32"])
