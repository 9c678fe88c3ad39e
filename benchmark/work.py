"""The yardstick of every share: the card's peaks and the work of the model,
counted from the configuration's shapes, never from what a kernel launches.

- FLOPs: two per multiply-add of every convolution, dense layer and
  attention product of the plain reference net (``torch.utils.flop_counter``
  over it on the ``meta`` device, so no memory and no arithmetic). Attention
  is 4·BH·T²·d forward and 10·BH·T²·d backward (the five products).
- Bytes: each input read once, each output written once.
- Peaks (one H100 SXM, NVIDIA's data sheet, dense): 989e12 FLOP/s for
  bfloat16 work, 495e12 for float32 work (the TF32 tensor-core rate: no
  float32 matrix work can beat it), 3.35e12 B/s of HBM.
"""

from __future__ import annotations

from functools import lru_cache

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def least_s(flops: float, bytes_: float, precision: str) -> float:
    """The least time the card takes for the work: operations or bytes, whichever bounds it."""
    return max(flops / PEAK_FLOPS[precision], bytes_ / PEAK_BYTES_PER_S)


@lru_cache(maxsize=None)
def _forward_flops(key: str, size: int) -> int:
    import json

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.adm import build

    net_cfg = json.loads(key)
    net = build(net_cfg, device="meta")
    with torch.device("meta"), FlopCounterMode(display=False) as counter:
        net(torch.zeros(1), torch.zeros(1, int(net_cfg["dim"][0]), size, size))
    return int(counter.get_total_flops())


def forward_flops(net_cfg: dict, size: int) -> int:
    """FLOPs of one forward of the net on one tile of ``size`` × ``size`` pixels."""
    import json

    return _forward_flops(json.dumps(net_cfg, sort_keys=True), int(size))


def attention_layers(net_cfg: dict, size: int) -> list[tuple[int, int, int]]:
    """(heads, T, d) of every attention layer of one forward on one tile of
    ``size`` × ``size`` pixels (which levels attend follows the net's
    configured image size, as the net reads its configuration)."""
    from .reference.adm import attention_levels

    levels = attention_levels(net_cfg["attention_resolutions"], int(net_cfg["dim"][-1]))
    mult, mc, per_head = list(net_cfg["channel_mult"]), int(net_cfg["num_channels"]), int(net_cfg["num_head_channels"])
    out, ds = [], 1
    for level, m in enumerate(mult):
        ch = m * mc
        if ds in levels:
            t = (size // ds) ** 2
            down = int(net_cfg["num_res_blocks"])
            up = int(net_cfg["num_res_blocks"]) + 1
            out += [(max(ch // per_head, 1), t, per_head if ch >= per_head else ch)] * (down + up)
        if level != len(mult) - 1:
            ds *= 2
    ch = mult[-1] * mc
    out.append((max(ch // per_head, 1), (size // ds) ** 2, per_head if ch >= per_head else ch))
    return out


def attention_work(bh: int, t: int, d: int, precision: str, backward: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one attention call at (BH, T, d): forward q, k, v read,
    o and the f32 log-sum-exp written; backward q, k, v, o, do and the
    log-sum-exp read, dq, dk, dv written."""
    e = ELEM_BYTES[precision]
    if backward:
        return 10.0 * bh * t * t * d, 8.0 * bh * t * d * e + 4.0 * bh * t
    return 4.0 * bh * t * t * d, 4.0 * bh * t * d * e + 4.0 * bh * t


def resblock_convs(net_cfg: dict, size: int) -> list[tuple[int, int, int]]:
    """(side, C, D) of the two 3×3 convolutions of every ResBlock of one
    forward on a tile of ``size`` px, in forward order: the input conv C → D,
    the output conv D → D."""
    mc, nrb = int(net_cfg["num_channels"]), int(net_cfg["num_res_blocks"])
    mult = list(net_cfg["channel_mult"])
    convs, skips, ch, side = [], [mc], mc, size

    def block(c, d, s):
        convs.extend([(s, c, d), (s, d, d)])

    for level, m in enumerate(mult):
        for _ in range(nrb):
            block(ch, m * mc, side)
            ch = m * mc
            skips.append(ch)
        if level != len(mult) - 1:
            skips.append(ch)
            side //= 2
    block(ch, ch, side)
    block(ch, ch, side)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nrb + 1):
            block(ch + skips.pop(), m * mc, side)
            ch = m * mc
        if level != 0:
            side *= 2
    return convs


def fused_conv_work(side: int, c: int, d: int, batch: int) -> dict:
    """{kernel: (FLOPs, bytes)} of one fused ResBlock conv at (B, side², C → D),
    bfloat16 activations and weights, f32 scale, shift and bias:
    K2 the forward (norm, FiLM and SiLU applied as it loads), K3 the input
    gradient, K4 the gradient through the norm and SiLU (elementwise: bytes
    only), K5 the weight gradient."""
    px = batch * side * side
    mac = 2.0 * px * 9 * c * d
    return {
        "K2": (mac, 2.0 * px * (c + d) + 2.0 * 9 * c * d + 4.0 * (2 * batch * c + d)),
        "K3": (mac, 2.0 * px * (d + c) + 2.0 * 9 * c * d),
        "K4": (0.0, 6.0 * px * c + 16.0 * batch * c),
        "K5": (mac, 2.0 * px * (c + d) + 8.0 * batch * c + 4.0 * (9 * c * d + d)),
    }
