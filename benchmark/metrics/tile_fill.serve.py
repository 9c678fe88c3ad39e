"""tile_fill.serve: the share of the tile slots of the traced requests'
tile batches that held a tile, in %: 100 × Σ ``tiles`` ÷ Σ ``slots`` over
the ``wsi.batch`` spans. The program's own count of what
``tile_slot_fill.serve`` counts with the benchmark's forward hook."""

from benchmark.spans import named, trees


def read(record):
    spans = trees(record, "tile_fill.serve", "serve.request")
    if spans is None:
        return None
    batches = named(spans, "wsi.batch")
    if not batches:
        record.note("tile_fill.serve left out: no traced wsi.batch span")
        return None
    return 100.0 * sum(s.attrs["tiles"] for s in batches) / sum(s.attrs["slots"] for s in batches)
