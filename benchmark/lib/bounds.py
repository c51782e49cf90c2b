"""The chip's peaks and the roofline arithmetic of one call.

Frozen copy of `chip_smoke.py` `HBM_BYTES_PER_S`, `BF16_OPS_PER_S`,
`bound_ms` and `matmul_bound` (seconds here, not ms): a call's bound is the
larger of its bytes over the HBM rate and its operations over the dense
bf16 tensor-core rate. Each input byte is counted read once and each
output byte written once; the operations are those the shapes need.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, no sparsity), at
# its full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least time a call that moves `n_bytes` and computes `n_flops`
    can take on the chip."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS_PER_S)


def int8_matmul_work(m: int, n_in: int, n_out: int) -> tuple[float, float]:
    """(bytes, flops) of one weight-only int8 product x (m, In) @ W (In,
    Out): the int8 codes and f32 column scales once, bf16 x and y once,
    2 m In Out operations."""
    n_bytes = n_in * n_out + n_out * 4 + m * (n_in + n_out) * 2
    return n_bytes, 2.0 * m * n_in * n_out
