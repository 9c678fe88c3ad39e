"""device_idle.train_f32: the card's idle share of the traced sub-window, in %
(:func:`benchmark.readers.device_idle`)."""

from benchmark.readers import device_idle as read  # noqa: F401
