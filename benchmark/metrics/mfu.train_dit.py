"""mfu.train_dit: DiT-XL/2's trained model FLOPs' share of the card's bfloat16
peak, in % (:func:`benchmark.readers.train_mfu`)."""

from benchmark.readers import train_mfu as read  # noqa: F401
