"""The work counters against a direct count at tiny shapes."""

from __future__ import annotations

import pytest
import torch

from benchmark import work
from benchmark.reference import adm
from benchmark.tests.tiny import NET


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
    assert work.forward_flops(cfg, 32) == flops
    assert work.attention_layers(cfg, 32) == attention
    assert work.resblock_convs(cfg, 32) == convs


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
    assert abs(work.forward_flops(cfg, 256) / 1e12 - 0.8144) < 1e-3
    assert work.attention_layers(cfg, 256) == [(16, 1024, 32)]
    assert len(work.resblock_convs(cfg, 256)) == 44


def test_mask_net_at_512_px():
    cfg = {"dim": [4, 256, 256], "out_channels": 3, "num_channels": 128, "num_res_blocks": 2,
           "channel_mult": [1, 2, 2, 4], "attention_resolutions": [16, 8], "num_head_channels": 32}
    assert work.attention_layers(cfg, 512) == [(16, 4096, 32)] * 6
    assert len(work.resblock_convs(cfg, 512)) == 44
    assert work.forward_flops(cfg, 512) > 4 * work.forward_flops(dict(cfg, attention_resolutions="16,8"), 256)
