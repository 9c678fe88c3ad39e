"""fused_conv_roofline: the least time of the traced steps' fused ResBlock
convolutions (for every 3×3 conv of every ResBlock: the forward K2, the
input gradient K3, the gradient through the norm and SiLU K4, the weight
gradient K5; work counted from the configuration's shapes, bfloat16) over
the device time of the "fused conv K2-K5" category, in %. Read only where
each of the four kernels launched once per such conv and step."""

from benchmark.work import fused_conv_work, least_s


def read(record):
    t, c, w = record.trace, record.counts, record.work
    if t is None or not c.get("traced_steps") or not w.get("fused_conv"):
        return None
    steps, batch = c["traced_steps"], c["batch"]
    convs = w["resblock_convs"]
    launches = c.get("launches", {})
    want = steps * len(convs)
    if any(launches.get(k) != want for k in ("K2", "K3", "K4", "K5")):
        record.note(f"fused_conv_roofline left out: launches {launches}, expected {want} of K2-K5 each")
        return None
    device_s = t.by_category.get("fused conv K2-K5", 0.0)
    if device_s <= 0:
        return None
    least = sum(least_s(flops, bytes_, "bfloat16") for side, cin, cout in convs
                for flops, bytes_ in fused_conv_work(side, cin, cout, batch).values())
    return 100.0 * steps * least / device_s
