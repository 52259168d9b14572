"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit) and
the least time a piece of work could take on it (the bound arithmetic of
`chip_smoke.py`, copied here so that the yardstick stays fixed).

fp32 and int32 operations issue on separate pipes, each at its own peak,
so the operations take the longer of the two; the least time is the larger
of that and the bytes' time at the HBM bandwidth.
"""

HBM_BYTES_S = 3.35e12                      # 80 GB HBM3
FP32_OPS_S = 67e12                         # fp32 outside the tensor cores
SM_CLOCK_HZ = 1.98e9                       # maximum SM clock
INT32_OPS_S = 132 * 64 * SM_CLOCK_HZ       # 132 SMs x 64 int32 lanes


def least_seconds(nbytes: float, fp32_ops: float = 0.0, int32_ops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_S, fp32_ops / FP32_OPS_S, int32_ops / INT32_OPS_S)
