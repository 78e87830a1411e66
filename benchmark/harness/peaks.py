"""Published peaks of the card the benchmark runs on (NVIDIA's data sheet
of the H100 SXM: dense rates, no sparsity, at the full 700 W power
limit).  Roofline shares and ``mfu`` divide by these."""

BF16_FLOPS = 989e12      # FLOP/s, bf16 and fp16 tensor cores
FP32_FLOPS = 67e12       # FLOP/s, float32 outside the tensor cores
TF32_FLOPS = 495e12      # FLOP/s
INT8_OPS = 1979e12       # OP/s
HBM_BYTES = 3.35e12      # bytes/s

PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
              "float32": FP32_FLOPS}
