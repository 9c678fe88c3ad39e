"""ln_modulate_roofline: the DiT's LayerNorm-modulate kernels (the forward and
the backward of every adaLN LayerNorm) against their bandwidth roofline, in %:
the least time of the traced steps' LayerNorm-modulate bytes over the device
time of the kernels whose name holds ``ln_modulate`` (``record.trace.by_kernel``).

The least time counts 2 · depth + 1 calls a step (two a block and the final
layer's, ``net.depth`` of the configuration), each over batch · T · hidden
elements, T = (H / patch) · (W / patch): the forward reads x and writes y, the
backward reads dy and x and writes dx, x in f32 (the DiT's residual stream), y
and dy in the trained precision (16 bytes an element under bf16-mixed), at
``benchmark.work.PEAK_BYTES_PER_S``. Read only where each kernel launched that
often over the traced steps (``ops.launches()``); elsewhere, and on a program
without these kernels, a note and None."""

from benchmark.work import ELEM_BYTES, PEAK_BYTES_PER_S

X_BYTES = 4  # the residual stream is f32 in every precision


def read(record):
    t, c, w = record.trace, record.counts, record.work
    net = record.cell.config.get("net", {})
    if t is None or not c.get("traced_steps") or not w.get("precision") or "depth" not in net:
        return None
    calls = c["traced_steps"] * (2 * int(net["depth"]) + 1)
    launches = c.get("launches", {})
    if launches.get("ln_modulate_fwd") != calls or launches.get("ln_modulate_bwd") != calls:
        record.note(f"ln_modulate_roofline left out: LayerNorm-modulate launches {launches.get('ln_modulate_fwd')}/"
                    f"{launches.get('ln_modulate_bwd')}, expected {calls} each")
        return None
    device_s = sum(s for name, s in t.by_kernel.items() if "ln_modulate" in name)
    if device_s <= 0:
        record.note("ln_modulate_roofline left out: no ln_modulate kernel in the trace")
        return None
    _, h, wd = net["dim"]
    patch = int(net["patch_size"])
    elements = c["batch"] * (h // patch) * (wd // patch) * int(net["hidden_size"])
    y_bytes = ELEM_BYTES[w["precision"]]
    per_call = elements * (X_BYTES + y_bytes) + elements * (y_bytes + 2 * X_BYTES)
    return 100.0 * calls * per_call / PEAK_BYTES_PER_S / device_s
