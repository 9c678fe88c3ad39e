"""attention_f32_roofline: the float32 cells' K1 forward and backward
against their roofline at the TF32 peak, in %
(:func:`benchmark.readers.attention_roofline`)."""

from benchmark.readers import attention_roofline


def read(record):
    return attention_roofline(record, "attention_f32_roofline")
