"""attention_d72_roofline: DiT-XL/2's K1 forward and backward (bfloat16, 28
layers at (B·16, 1024, 72)) against their roofline at the real head dim 72,
in % (:func:`benchmark.readers.attention_roofline`: read only where each
kernel launched 28 times a traced step)."""

from benchmark.readers import attention_roofline


def read(record):
    return attention_roofline(record, "attention_d72_roofline")
