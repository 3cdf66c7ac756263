"""Published peaks of one NVIDIA H100 SXM and the bytes and operations the
port's kernels need, for the roofline metrics.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense:
3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor cores
(the kernels compute in float32 on the CUDA cores). A card set below
700 W runs slower; the run prints its power limit beside the numbers.

Per kernel (``csrc/<kernel>.cu`` on ``csrc/onepass.cuh``): the float32
rows of one factor, the float32 parameters of one problem, the outputs of
one problem (the packed upper triangle of H, g and the cost) and the
floating-point operations of one factor, counted from
``csrc/factor_math.cuh`` (the exponential loss is 9: -b s, expm1, 1 +,
the select, a exp, a -, 2 a b exp). maha6: e = R p + t - mu (21), r = S e
(15), |r|^2 (5), the loss (9), the mask (2), S R (45), the Jacobian's
cross products (27), 21 H terms x 7 (147), 6 g terms x 7 (42), the cost
(1): 314.

A call reads each input byte once and writes each output once: rows x 4
bytes a factor, the parameters and the outputs a problem. Only the
factors the program matched count, not the zero lanes a buffer is padded
with.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# kernel: (float32 rows a factor, float32 params a problem, outputs a
# problem, operations a factor)
KERNELS = {
    "maha6": (16, 16, 28, 314),
    "maha3": (16, 8, 10, 121),
    "maha3c": (10, 8, 10, 76),
    "reproj": (6, 20, 28, 239),
    "p2p": (10, 16, 28, 165),
}


def bytes_needed(kernel: str, factors: int, problems: int) -> int:
    rows, params, outputs, _ = KERNELS[kernel]
    return 4 * (rows * factors + (params + outputs) * problems)


def operations(kernel: str, factors: int) -> int:
    return KERNELS[kernel][3] * factors


def bound_seconds(kernel: str, factors: int, problems: int) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the float32 peak."""
    return max(
        bytes_needed(kernel, factors, problems) / PEAK_BYTES_PER_S,
        operations(kernel, factors) / PEAK_FP32_FLOP_PER_S,
    )
