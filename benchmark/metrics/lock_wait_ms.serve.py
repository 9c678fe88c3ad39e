"""lock_wait_ms.serve: the median ``serve.lock_wait`` of the traced
requests, in ms: how long a request waits for the server's lock (the card
serves one request at a time). Read from 10 requests on."""

import statistics

from benchmark.spans import named, trees

LEAST = 10


def read(record):
    spans = trees(record, "lock_wait_ms.serve", "serve.request", least=LEAST)
    if spans is None:
        return None
    waits = [s.end_ns - s.start_ns for s in named(spans, "serve.lock_wait")]
    if len(waits) < LEAST:
        record.note(f"lock_wait_ms.serve left out: {len(waits)} traced lock waits, fewer than {LEAST}")
        return None
    return statistics.median(waits) / 1e6
