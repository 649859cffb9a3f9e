"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

FLOPS = {
    "bf16": 989.4e12,   # tensor cores, bfloat16 in, float32 accumulate
    "tf32": 494.7e12,   # tensor cores, TF32
    "fp32": 66.9e12,    # CUDA cores, full float32 (TF32 off)
}
HBM_BYTES_PER_S = 3.35e12
