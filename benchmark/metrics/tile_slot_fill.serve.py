"""tile_slot_fill.serve: the share of the tile slots of the velocity
evaluations that held a tile of a request, in %: the real tiles of the
window's requests times the evaluations a tile needs, over the tile rows
the benchmark's forward hook counted on the net."""


def read(record):
    c = record.counts
    if not c.get("tile_rows"):
        return None
    return 100.0 * c["real_tiles"] * c["evaluations_per_tile"] / c["tile_rows"]
