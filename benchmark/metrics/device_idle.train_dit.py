"""device_idle.train_dit: the card's idle share of DiT-XL/2's traced sub-window,
in % (:func:`benchmark.readers.device_idle`)."""

from benchmark.readers import device_idle as read  # noqa: F401
