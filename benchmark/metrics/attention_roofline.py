"""attention_roofline: the bfloat16 flagship's K1 forward and backward
against their roofline, in % (:func:`benchmark.readers.attention_roofline`)."""

from benchmark.readers import attention_roofline


def read(record):
    return attention_roofline(record, "attention_roofline")
