"""lock_idle_share.serve: the share of the traced stretch of lock holdings
in which no request held the server's lock, in %: 100 × (1 − Σ
``serve.locked`` ÷ (last end − first start)). The stretch is the longest
run of traced holdings that follow each other in the lock's own order (the
``served`` attribute), so no untraced request held the lock inside it."""

from benchmark.spans import named, total_ns, trees


def read(record):
    spans = trees(record, "lock_idle_share.serve", "serve.request", least=2)
    if spans is None:
        return None
    locked = sorted(named(spans, "serve.locked"), key=lambda s: s.attrs["served"])
    run, best = locked[:1], []
    for prev, s in zip(locked, locked[1:]):
        run = run + [s] if s.attrs["served"] == prev.attrs["served"] + 1 else [s]
        best = max(best, run, key=len)
    if len(best) < 2:
        record.note(f"lock_idle_share.serve left out: no two traced lock holdings in a row ({len(locked)} traced)")
        return None
    stretch = best[-1].end_ns - best[0].start_ns
    return 100.0 * (1.0 - total_ns(best, "serve.locked") / stretch)
