"""Published peaks of the chip the benchmark measures: one NVIDIA H100 SXM
(NVIDIA's data sheet; dense rates, no sparsity; at the full 700 W limit)."""

#: bfloat16 tensor-core operations per second
BF16_FLOPS = 989e12
#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
#: device memory, bytes
HBM_BYTES = 80e9
