"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; a card set lower runs slower, so
every share is printed beside the card's power limit)."""

HBM_BYTES_PER_S = 3.35e12      # 80 GB of HBM3
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
FP64_OPS_PER_S = 34e12         # float64 outside the tensor cores

# float operations of one leaf test (sub, mul, add, compare; selects and
# the per-ray reciprocals and d.d not counted): sphere 3 sub + 3 mul + 2 add
# + 1 add + 1 mul + 1 compare; box 6 compares; ray_box 6 sub + 6 mul + 12
# compares; ray_sphere 3 sub + 6 (qb) + 7 (qc) + 4 (disc) + 3 compares
FLOPS_PER_TEST = {"sphere": 11, "box": 6, "ray_box": 24, "ray_sphere": 23}


def ops_rate(dtype) -> float:
    """The peak rate of the type the kernel computes in."""
    return FP64_OPS_PER_S if str(dtype).endswith("float64") else \
        FP32_OPS_PER_S


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    """``(bound ms, "bytes" or "operations", bytes ms, operations ms)``:
    the least time the card could take, the larger of the two terms."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / ops_rate(dtype) * 1e3
    return (b, "bytes", b, o) if b >= o else (o, "operations", b, o)
