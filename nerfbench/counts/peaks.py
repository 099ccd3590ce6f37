"""NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit."""

BF16_TENSOR_FLOPS = 989e12  # bf16 (and fp16) on the tensor cores
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def flops_per_s(dtype_name: str) -> float:
    """The peak of a GEMM's compute dtype (a configuration's mlp_dtype)."""
    return BF16_TENSOR_FLOPS if dtype_name in ("bfloat16", "float16") else FP32_FLOPS
