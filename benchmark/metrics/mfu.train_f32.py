"""mfu.train_f32: the trained model FLOPs' share of the card's peak for the
trained precision, in % (:func:`benchmark.readers.train_mfu`)."""

from benchmark.readers import train_mfu as read  # noqa: F401
