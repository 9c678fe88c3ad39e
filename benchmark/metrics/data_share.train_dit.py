"""data_share.train_dit: the share of the DiT cell's traced train steps spent
fetching and preparing the batch, in % (:func:`benchmark.spans.data_share`)."""

from benchmark.spans import data_share


def read(record):
    return data_share(record, "data_share.train_dit")
