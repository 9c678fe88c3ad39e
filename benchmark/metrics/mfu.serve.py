"""mfu.serve: the model FLOPs of the tiles answered in the window (the
velocity evaluations a tile needs × one forward's FLOPs, counted from the
configuration's shapes) over the window's seconds and the card's peak for
the served precision, in %."""

from benchmark.work import PEAK_FLOPS


def read(record):
    c, w = record.counts, record.work
    if not c.get("real_tiles_in_window") or record.window_s <= 0:
        return None
    flops = c["real_tiles_in_window"] * c["evaluations_per_tile"] * w["forward_flops_per_tile"]
    return 100.0 * flops / record.window_s / PEAK_FLOPS[w["precision"]]
