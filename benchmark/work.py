"""The yardstick of every share: the card's peaks and the work of the model,
counted from the configuration's shapes, never from what a kernel launches.

- FLOPs: two per multiply-add of every convolution, dense layer and
  attention product of the plain reference net that the configuration
  names (``torch.utils.flop_counter`` over it on the ``meta`` device, so no
  memory and no arithmetic). Attention is 4·BH·T²·d forward and
  10·BH·T²·d backward (the five products), over the (heads, T, d) of each
  attention layer that the reference module lists.
- Bytes: each input read once, each output written once.
- Peaks (one H100 SXM, NVIDIA's data sheet, dense): 989e12 FLOP/s for
  bfloat16 work, 495e12 for float32 work (the TF32 tensor-core rate: no
  float32 matrix work can beat it), 3.35e12 B/s of HBM.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def least_s(flops: float, bytes_: float, precision: str) -> float:
    """The least time the card takes for the work: operations or bytes, whichever bounds it."""
    return max(flops / PEAK_FLOPS[precision], bytes_ / PEAK_BYTES_PER_S)


_FORWARD_FLOPS: dict = {}


def forward_flops(ref, net_cfg: dict, size: int) -> int:
    """FLOPs of one forward of the reference net of module ``ref`` (a
    configuration's ``reference``) on one tile of ``size`` × ``size`` pixels
    with ``net_cfg["dim"][0]`` channels: ``FlopCounterMode`` over it on the
    ``meta`` device."""
    import json

    key = (ref.__name__, json.dumps(net_cfg, sort_keys=True), int(size))
    if key not in _FORWARD_FLOPS:
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        net = ref.build(net_cfg, device="meta")
        with torch.device("meta"), FlopCounterMode(display=False) as counter:
            net(torch.zeros(1), torch.zeros(1, int(net_cfg["dim"][0]), size, size))
        _FORWARD_FLOPS[key] = int(counter.get_total_flops())
    return _FORWARD_FLOPS[key]


def attention_work(bh: int, t: int, d: int, precision: str, backward: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one attention call at (BH, T, d): forward q, k, v read,
    o and the f32 log-sum-exp written; backward q, k, v, o, do and the
    log-sum-exp read, dq, dk, dv written."""
    e = ELEM_BYTES[precision]
    if backward:
        return 10.0 * bh * t * t * d, 8.0 * bh * t * d * e + 4.0 * bh * t
    return 4.0 * bh * t * t * d, 4.0 * bh * t * d * e + 4.0 * bh * t


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
