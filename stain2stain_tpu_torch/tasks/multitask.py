"""Multitask (binary) flow matching and segmentation on a shared encoder
(counterpart of ``stain2stain_tpu/tasks/multitask.py``):

    H&E → SharedEncoder → F ─┬→ FlowMatchingDecoder(F, skips, t_emb) → velocity
                             └→ SegmentationDecoder(F, skips)        → mask logits

Loss: ``L_FM + α·(w·Dice + (1−w)·BCE)``; in eval also the hard-threshold
``dice_coef`` and ``iou``. The three networks sit in one
:class:`MultitaskNet`, the task's ``net``, so the trainer's state, optimizer,
clipping and checkpoint take them (BatchNorm buffers included) as they take
a UNet; its state-dict keys are the reference Lightning module's.

Each training step runs the encoder **once** on ``cat([xt, src])`` (2B) and
splits its output between the heads (JAX ``_fused_heads``); under
``norm="batch"`` the statistics therefore span the 2B batch, as in JAX. Every
forward sets the net's train or eval mode, so validation and ``generate``
read the running statistics. ``generate`` integrates the encoder → flow
decoder ODE and runs the segmentation head once on the source, returning
``(image, mask)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.losses import bce_with_logits, dice_loss, mse_loss
from ..ops.time_embedding import timestep_embedding_sincos
from ..parallel.mesh import batch_sum
from .base import FlowMatchingTask


class MultitaskNet(nn.Module):
    """``encoder``, ``flow_decoder`` and ``seg_decoder`` in one module. Its
    ``dtype`` is theirs: setting it (the trainer does for bf16) sets all three."""

    def __init__(self, encoder: nn.Module, flow_decoder: nn.Module, seg_decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.flow_decoder = flow_decoder
        self.seg_decoder = seg_decoder

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.dtype

    @dtype.setter
    def dtype(self, value: torch.dtype) -> None:
        for module in (self.encoder, self.flow_decoder, self.seg_decoder):
            module.dtype = value


class SharedBackboneTask(FlowMatchingTask):
    """Common machinery of the shared-encoder family. Subclasses give the
    segmentation terms (:meth:`_seg_terms`), the eval metrics and
    :meth:`predict_mask`."""

    batch_fields = ("image", "image", "mask")
    seg_metric_name = "seg_bce"

    def __init__(
        self,
        encoder: Optional[nn.Module] = None,
        flow_decoder: Optional[nn.Module] = None,
        seg_decoder: Optional[nn.Module] = None,
        flow_matcher=None,
        solver=None,
        optimizer=None,
        scheduler=None,
        compile: bool = True,
        log_images: bool = True,
        seg_loss_weight: float = 1.0,
        dice_weight: float = 0.5,
        n_images_log: int = 5,
        time_emb_dim: int = 256,
        net: Optional[MultitaskNet] = None,
        device=None,
    ):
        if net is None:
            net = MultitaskNet(encoder, flow_decoder, seg_decoder)
        super().__init__(
            net=net,
            flow_matcher=flow_matcher,
            solver=solver,
            optimizer=optimizer,
            scheduler=scheduler,
            compile=compile,
            log_images=log_images,
            n_images_log=n_images_log,
            device=device,
        )
        self.seg_loss_weight = seg_loss_weight
        self.dice_weight = dice_weight
        self.time_emb_dim = time_emb_dim

    # --------------------------------------------------------- forward parts
    def forward_flow(self, t: torch.Tensor, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        self.net.train(train)
        bottleneck, skips = self.net.encoder(x)
        return self.net.flow_decoder(bottleneck, skips, timestep_embedding_sincos(t, self.time_emb_dim))

    def forward_segmentation(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        self.net.train(train)
        return self.net.seg_decoder(*self.net.encoder(x))

    def _fused_heads(self, t: torch.Tensor, xt: torch.Tensor, src: torch.Tensor, *, train: bool):
        """(velocity, segmentation logits) from one encoder pass over the 2B batch."""
        self.net.train(train)
        batch = xt.shape[0]
        bottleneck, skips = self.net.encoder(torch.cat([xt, src], dim=0))
        t_emb = timestep_embedding_sincos(t, self.time_emb_dim)
        vt = self.net.flow_decoder(bottleneck[:batch], [s[:batch] for s in skips], t_emb)
        seg_logits = self.net.seg_decoder(bottleneck[batch:], [s[batch:] for s in skips])
        return vt, seg_logits

    # -------------------------------------------------------------- the loss
    def _seg_terms(self, seg_logits: torch.Tensor, target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(Dice term, the other term) of the segmentation loss."""
        raise NotImplementedError

    def _eval_metrics(self, seg_logits: torch.Tensor, target: torch.Tensor) -> dict:
        raise NotImplementedError

    def loss_and_metrics(
        self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
    ):
        """(loss, {"loss", "flow_loss", "seg_loss", "seg_dice", the other term;
        in eval also "dice_coef", "iou"}); ``t`` and ``eps`` may be injected."""
        src, tgt, target = batch[0], batch[1], batch[2]
        t, xt, ut = self.flow_matcher.sample_location_and_conditional_flow(
            src, tgt, generator=generator, t=t, eps=eps
        )
        vt, seg_logits = self._fused_heads(t, xt, src, train=train)
        flow_loss = mse_loss(vt, ut)
        seg_dice, seg_other = self._seg_terms(seg_logits, target)
        seg_loss = self.dice_weight * seg_dice + (1.0 - self.dice_weight) * seg_other
        loss = flow_loss + self.seg_loss_weight * seg_loss
        metrics = {"loss": loss, "flow_loss": flow_loss, "seg_loss": seg_loss, "seg_dice": seg_dice,
                   self.seg_metric_name: seg_other}
        if not train:
            metrics.update(self._eval_metrics(seg_logits, target))
        return loss, {k: v.detach() for k, v in metrics.items()}

    # -------------------------------------------------------------- sampling
    def predict_mask(self, seg_logits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def generate(self, source: torch.Tensor, num_steps: int = 50) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) or (H, W, 3) source in [-1, 1] → (translated (B, H, W, 3)
        f32, the predicted mask of the source)."""
        with torch.inference_mode():
            source = torch.as_tensor(source, device=self.device).to(torch.float32)
            if source.ndim == 3:
                source = source[None]

            def velocity(t, x):
                return self.forward_flow(t.expand(x.shape[0]), x)

            img = self._integrate(velocity, source, num_steps)
            return img, self.predict_mask(self.forward_segmentation(source))

    def render_panels(self, batch: tuple, generator: Optional[torch.Generator] = None, num_steps: int = 2) -> dict:
        """Source / generated / target [0, 1] panels, the predicted mask and,
        when the batch has one, the true mask (its first n rows, beside the
        others; JAX passes every row)."""
        prepared = self.prepare_batch(self.device_fields(batch), generator, train=False)
        src, tgt = prepared[0], prepared[1]
        n = min(self.n_images_log, src.shape[0])
        gen, pred_mask = self.generate(src[:n], num_steps=num_steps)

        def to01(x):
            return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0).cpu().numpy()

        panels = {"source": to01(src[:n]), "generated": to01(gen), "target": to01(tgt[:n]),
                  "pred_mask": pred_mask.to(torch.float32).cpu().numpy()}
        if len(prepared) > 2:
            panels["gt_mask"] = prepared[2][:n].to(torch.float32).cpu().numpy()
        return panels


class MultitaskFlowMatchingModule(SharedBackboneTask):
    """Binary-mask variant: Dice + BCE on one logit channel."""

    batch_fields = ("image", "image", "mask")

    def _seg_terms(self, seg_logits, target):
        return dice_loss(seg_logits, target), bce_with_logits(seg_logits, target)

    def _eval_metrics(self, seg_logits, target):
        """Hard-threshold Dice and IoU over the batch (JAX ``:190-199``)."""
        pred = (torch.sigmoid(seg_logits) > 0.5).to(torch.float32)
        gt = target.to(torch.float32)
        inter, pred_sum, gt_sum, union_or = batch_sum(torch.stack([
            torch.sum(pred * gt), torch.sum(pred), torch.sum(gt), torch.sum(torch.clamp(pred + gt, 0.0, 1.0))
        ]))
        union_sum = pred_sum + gt_sum
        return {"dice_coef": (2.0 * inter + 1e-7) / (union_sum + 1e-7), "iou": (inter + 1e-7) / (union_or + 1e-7)}

    def predict_mask(self, seg_logits: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) f32 in {0, 1}."""
        return (torch.sigmoid(seg_logits) > 0.5).to(torch.float32)


__all__ = ["MultitaskNet", "SharedBackboneTask", "MultitaskFlowMatchingModule"]
