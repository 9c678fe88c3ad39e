"""The sealed generator of the conditional and multitask tasks, on the CPU.

Each task is sealed by ``export_generator`` with its condition baked in
(``target_class=`` for the class-conditional task, ``mask=`` a tensor for the
mask-conditioned one), loaded by ``load_generator`` and run: equal to the
direct ``generate`` with the same condition, and different from it under
another condition. The multitask program returns ``(image, mask)`` as the
JAX function does, under BatchNorm with its running statistics baked in and
under dopri5 (the encoder's and both decoders' state re-bound inside the
loop). Tiny nets, jittered so no output is trivially zero.
"""

from __future__ import annotations

import numpy as np
import torch

from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.models.shared_encoder import SharedEncoder
from stain2stain_tpu_torch.models.task_decoders import FlowMatchingDecoder, SegmentationDecoder
from stain2stain_tpu_torch.models.unet_4to3 import UNet4to3
from stain2stain_tpu_torch.ops.solvers import SolverConfig
from stain2stain_tpu_torch.serving import export_generator, load_generator
from stain2stain_tpu_torch.tasks import (
    ClassConditionalFlowMatchingModule,
    MaskConditionedFlowMatchingModule,
    MultitaskFlowMatchingModule,
)

SIZE = 16
TINY = dict(num_channels=16, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="8", num_head_channels=8)


def _jitter(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        for name, b in module.named_buffers():
            if name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=gen)
    return module


def _source(channels: int = 3) -> torch.Tensor:
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.uniform(-1, 1, size=(2, SIZE, SIZE, channels)).astype(np.float32))


def _sealed(task, tmp_path, name: str, num_steps: int = 2, **gen_kwargs):
    program = export_generator(task, tmp_path / f"{name}.pt2", batch=2, image_size=SIZE, num_steps=num_steps,
                               **gen_kwargs)
    return load_generator(program, device="cpu")


def test_class_conditional_program_bakes_in_the_class(tmp_path):
    net = _jitter(UNetModel(dim=(3, SIZE, SIZE), class_cond=True, num_classes=3, device="cpu", **TINY))
    task = ClassConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler"), num_classes=3)
    src = _source()
    call = _sealed(task, tmp_path, "class2", target_class=2)
    out = call(src)
    assert torch.equal(out, task.generate(src, num_steps=2, target_class=2))
    assert not torch.equal(out, task.generate(src, num_steps=2, target_class=0))
    assert (tmp_path / "class2.pt2.json").read_text().count('"target_class": "2"') == 1


def test_mask_conditioned_program_bakes_in_the_mask(tmp_path):
    net = _jitter(UNet4to3(image_size=SIZE, device="cpu", **TINY))
    task = MaskConditionedFlowMatchingModule(net=net, solver=SolverConfig("euler"))
    src = _source()
    mask = (torch.arange(SIZE * SIZE).reshape(1, SIZE, SIZE, 1) % 3 == 0).to(torch.float32).expand(2, -1, -1, -1)
    call = _sealed(task, tmp_path, "mask", mask=mask.clone())
    out = call(src)
    assert torch.equal(out, task.generate(src, num_steps=2, mask=mask))
    assert not torch.equal(out, task.generate(src, num_steps=2, mask=torch.zeros_like(mask)))


def test_multitask_program_returns_image_and_mask(tmp_path):
    feats, dec_feats, temb = (8, 16, 32), (16, 8), 16
    task = MultitaskFlowMatchingModule(
        encoder=_jitter(SharedEncoder(3, feats, norm="batch", device="cpu"), 1),
        flow_decoder=_jitter(FlowMatchingDecoder(feats[-1], dec_feats, 3, temb, norm="batch", device="cpu"), 2),
        seg_decoder=_jitter(SegmentationDecoder(feats[-1], dec_feats, 1, norm="batch", device="cpu"), 3),
        solver=SolverConfig("dopri5"), time_emb_dim=temb,
    )
    src = _source()
    image, mask = task.generate(src, num_steps=2)
    out = _sealed(task, tmp_path, "multitask")(src)
    assert isinstance(out, tuple) and len(out) == 2
    assert out[0].shape == (2, SIZE, SIZE, 3) and out[1].shape == (2, SIZE, SIZE, 1)
    assert (out[0] - image).abs().max().item() <= 1e-6
    assert torch.equal(out[1], mask)
