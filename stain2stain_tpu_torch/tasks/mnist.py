"""MNIST classifier task of the template demo (counterpart of
``stain2stain_tpu/tasks/mnist.py:20-49``).

``SimpleDenseNet`` with cross-entropy; ``loss`` and ``acc`` per split, and
``val/acc_best``, the running max the template's sweep optimizes (the
trainer's ``_track_best``). A :class:`TaskModule` without a flow matcher,
a solver or ``generate``: the trainer needs none of them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .base import TaskModule


class MNISTLitModule(TaskModule):
    batch_fields = ("raw", "label")
    monitor = "val/loss"
    track_best = {"val/acc": ("max", "val/acc_best")}

    def __init__(self, net=None, optimizer=None, scheduler=None, compile: bool = True, device=None):
        super().__init__(net=net, optimizer=optimizer, scheduler=scheduler, log_images=False, device=device)

    def prepare_batch(self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
                      augment: Optional[dict] = None) -> tuple:
        """(images, labels) on the device: uint8 images as torchvision's
        ``ToTensor`` + ``Normalize((0.1307,), (0.3081,))`` give them
        (float images are taken as normalized), labels int64."""
        x, y = super().prepare_batch(batch, generator, train=train)[:2]
        if x.dtype == torch.uint8:
            x = (x.to(torch.float32) / 255.0 - 0.1307) / 0.3081
        return x, y

    def loss_and_metrics(self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False):
        """(cross-entropy, {"loss", "acc"}) of one prepared batch."""
        x, y = batch[0], batch[1]
        self.net.train(train)
        logits = self.net(x)
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(dim=-1) == y).to(torch.float32).mean()
        return loss, {"loss": loss.detach(), "acc": acc}


__all__ = ["MNISTLitModule"]
