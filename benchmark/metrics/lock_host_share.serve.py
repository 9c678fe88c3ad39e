"""lock_host_share.serve: the share of the traced requests' time under the
server's lock spent in host work of the tile path, in %: 100 × Σ
(``wsi.gather`` + ``wsi.h2d`` + ``wsi.stitch``) ÷ Σ ``serve.locked``."""

from benchmark.spans import total_ns, trees


def read(record):
    spans = trees(record, "lock_host_share.serve", "serve.request")
    if spans is None:
        return None
    locked = total_ns(spans, "serve.locked")
    if locked <= 0:
        record.note("lock_host_share.serve left out: no traced serve.locked span")
        return None
    return 100.0 * total_ns(spans, "wsi.gather", "wsi.h2d", "wsi.stitch") / locked
