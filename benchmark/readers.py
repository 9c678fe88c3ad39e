"""The formulas that more than one per-layer reader uses. Each reader under
``metrics/`` is the file of one metric name and calls one of these; a
formula returns None where the run has nothing for it to read."""

from __future__ import annotations

from benchmark.work import PEAK_FLOPS, attention_work, least_s

ATTENTION_CATEGORIES = ("attention forward K1-fwd", "attention backward K1-bwd")


def device_idle(record):
    """The share of the traced sub-window in which no kernel ran on the card,
    in %: 100 × (1 − the union of the kernel intervals ÷ the sub-window's
    wall time)."""
    t = record.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def train_mfu(record):
    """The model FLOPs of the tiles trained in the window (3 × one forward's
    FLOPs a tile, counted from the configuration's shapes) over the window's
    seconds and the card's peak for the trained precision, in %."""
    c, w = record.counts, record.work
    if not c.get("tiles") or record.window_s <= 0:
        return None
    return 100.0 * 3 * w["forward_flops_per_tile"] * c["tiles"] / record.window_s / PEAK_FLOPS[w["precision"]]


def attention_roofline(record, name: str):
    """The least time of the traced steps' attention work (forward and
    backward of every attention layer at the cell's (BH, T, d), counted from
    the configuration's shapes, at the trained precision's peak) over the
    device time of the attention kernels' category, in %. Read only where
    the kernels launched as often as the model has attention layers."""
    t, c, w = record.trace, record.counts, record.work
    if t is None or not c.get("traced_steps") or not w.get("attention"):
        return None
    steps, batch, precision = c["traced_steps"], c["batch"], w["precision"]
    layers = len(w["attention"])
    launches = c.get("launches", {})
    if launches.get("K1-fwd") != steps * layers or launches.get("K1-bwd") != steps * layers:
        record.note(f"{name} left out: K1 launches {launches.get('K1-fwd')}/{launches.get('K1-bwd')}, "
                    f"expected {steps * layers} each")
        return None
    device_s = sum(t.by_category.get(k, 0.0) for k in ATTENTION_CATEGORIES)
    if device_s <= 0:
        return None
    least = 0.0
    for heads, tokens, d in w["attention"]:
        for backward in (False, True):
            flops, bytes_ = attention_work(batch * heads, tokens, d, precision, backward)
            least += least_s(flops, bytes_, precision)
    return 100.0 * steps * least / device_s
