"""The work counters against a direct count at tiny shapes, and pinned at the
cells' own sizes: what the configurations' named reference gives is what the
ADM-only counting gave before each configuration named its reference."""

from __future__ import annotations

import hashlib

import pytest
import torch

from benchmark import core, inputs, work
from benchmark.reference import adm
from benchmark.tests.tiny import NET, ROOT


def _direct(net_cfg):
    """FLOPs, attention shapes and ResBlock conv shapes of one forward, by
    hand from hooks on the reference's blocks: two per multiply-add."""
    net = adm.build(net_cfg)
    c, h, w = net_cfg["dim"]
    mc = net_cfg["num_channels"]
    assert net_cfg.get("out_channels") in (None, c)
    flops = [2 * h * w * 9 * c * mc + 2 * mc * 4 * mc + 2 * (4 * mc) ** 2 + 2 * h * w * 9 * mc * c]
    attention, convs = [], []

    def res(m, args, out):
        x = args[0]
        s, cin, cout = x.shape[2], x.shape[1], out.shape[1]
        flops[0] += 2 * s * s * 9 * (cin * cout + cout * cout) + 2 * 4 * mc * 2 * cout
        flops[0] += 2 * s * s * cin * cout if cin != cout else 0
        convs.extend([(s, cin, cout), (s, cout, cout)])

    def attn(m, args, out):
        _, ch, s, _ = args[0].shape
        t, d = s * s, ch // m.num_heads
        attention.append((m.num_heads, t, d))
        flops[0] += 2 * t * ch * 4 * ch + 4 * m.num_heads * t * t * d

    def resample(m, args, out):
        flops[0] += 2 * out.shape[2] * out.shape[3] * 9 * out.shape[1] * out.shape[1]

    for m in net.modules():
        if isinstance(m, adm.ResBlock):
            m.register_forward_hook(res)
        elif isinstance(m, adm.AttentionBlock):
            m.register_forward_hook(attn)
        elif isinstance(m, (adm.Downsample, adm.Upsample)):
            m.register_forward_hook(resample)
    with torch.no_grad():
        net(torch.zeros(1), torch.zeros(1, c, h, w))
    return flops[0], attention, convs


@pytest.mark.parametrize("attn", ["16", "16,8", ""])
def test_counts_match_a_direct_count(attn):
    cfg = dict(NET, attention_resolutions=attn)
    flops, attention, convs = _direct(cfg)
    assert work.forward_flops(adm, cfg, 32) == flops
    assert adm.attention_shapes(cfg, 32) == attention
    assert adm.fused_convs(cfg, 32) == convs


def test_attention_work():
    flops, bytes_ = work.attention_work(512, 1024, 32, "bfloat16", backward=False)
    assert flops == 4 * 512 * 1024**2 * 32
    assert bytes_ == 4 * 512 * 1024 * 32 * 2 + 4 * 512 * 1024
    flops, bytes_ = work.attention_work(512, 1024, 32, "float32", backward=True)
    assert flops == 10 * 512 * 1024**2 * 32
    assert bytes_ == 8 * 512 * 1024 * 32 * 4 + 4 * 512 * 1024


def test_fused_conv_work_and_least_time():
    w = work.fused_conv_work(32, 128, 256, 2)
    px = 2 * 32 * 32
    assert w["K2"][0] == w["K3"][0] == w["K5"][0] == 2 * px * 9 * 128 * 256
    assert w["K4"] == (0.0, 6 * px * 128 + 16 * 2 * 128)
    assert work.least_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert work.PEAK_FLOPS["float32"] == 495e12


def test_flagship_forward_is_what_the_record_says():
    cfg = {"dim": [3, 256, 256], "num_channels": 128, "num_res_blocks": 2, "channel_mult": [1, 2, 2, 4],
           "attention_resolutions": "16,8", "num_head_channels": 32}
    assert abs(work.forward_flops(adm, cfg, 256) / 1e12 - 0.8144) < 1e-3
    assert adm.attention_shapes(cfg, 256) == [(16, 1024, 32)]
    assert len(adm.fused_convs(cfg, 256)) == 44


def test_mask_net_at_512_px():
    cfg = {"dim": [4, 256, 256], "out_channels": 3, "num_channels": 128, "num_res_blocks": 2,
           "channel_mult": [1, 2, 2, 4], "attention_resolutions": [16, 8], "num_head_channels": 32}
    assert adm.attention_shapes(cfg, 512) == [(16, 4096, 32)] * 6
    assert len(adm.fused_convs(cfg, 512)) == 44
    assert work.forward_flops(adm, cfg, 512) > 4 * work.forward_flops(adm, dict(cfg, attention_resolutions="16,8"), 256)


# What the parent of the change that made each configuration name its
# reference computed on the CPU, at the sizes each cell runs: one forward's
# FLOPs, the attention and fused-conv shape lists (the convs by a digest of
# their repr), and a digest of the weights drawn for the net's parameters.
PINNED = {
    "cfm-unet-256": {
        "flops": {256: 814414168064},
        "attention": {256: [(16, 1024, 32)]},
        "convs": {256: (44, "1bec6473f0c7581deb5b855cb6a1e151c6a38ed34ffd845b2c0d7684023a6dc6")},
        "parameters": 70954883,
        "weights": "5cf3615c34747c24f7fb92502089a3cdf2810c1357e762c521ae7ba6a327ae2d",
    },
    "cfm-unet-mask-512": {
        "flops": {512: 3498735173632, 256: 836039999488},
        "attention": {512: [(16, 4096, 32)] * 6, 256: [(16, 1024, 32)] * 6},
        "convs": {512: (44, "66ba725bed42b9fee6642e0b0ab5cba4994349537dcb7ec27f4d38bf31db33f8")},
        "parameters": 76214275,
        "weights": "7528bc5168d80701e962ef070589a3c8ed6e5e9fc4468ed3da1284ad3ccbf62a",
    },
}
PIN_SEED = 2**31 + 19


@pytest.mark.parametrize("config", sorted(PINNED))
def test_named_reference_counts_what_the_adm_counting_did(config):
    entry = core.find(core.load_manifest(ROOT)["configs"], config, "config")
    conf = core.load_json(ROOT / entry["file"])
    ref, net_cfg, want = core.reference(ROOT, conf["reference"]), conf["net"], PINNED[config]
    for size, flops in want["flops"].items():
        assert work.forward_flops(ref, net_cfg, size) == flops
    for size, shapes in want["attention"].items():
        assert ref.attention_shapes(net_cfg, size) == shapes
    for size, (n, digest) in want["convs"].items():
        convs = ref.fused_convs(net_cfg, size)
        assert (len(convs), hashlib.sha256(repr(convs).encode()).hexdigest()) == (n, digest)
    names = [(k, tuple(p.shape)) for k, p in ref.build(net_cfg, device="meta").named_parameters()]
    weights = inputs.make_weights(names, PIN_SEED, "cpu", ref.zeroed)
    h = hashlib.sha256()
    for k, _ in names:
        h.update(k.encode())
        h.update(weights[k].contiguous().numpy().tobytes())
    assert sum(w.numel() for w in weights.values()) == want["parameters"]
    assert h.hexdigest() == want["weights"]
