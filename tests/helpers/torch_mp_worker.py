"""Worker of the port's two-process tests (``tests/test_torch_multiprocess.py``).

Each process joins a gloo group of 2 on the CPU through the port's
``maybe_initialize_distributed`` (torchrun's variables, set by the test) and
runs one mode:

- ``step``: a toy regression through ``DistributedDataParallel`` on the
  port's sharded ``DataLoader`` (the mirror of ``mp_train_worker.py``);
  prints ``MPOK rank=… loss=… checksum=…``;
- ``cfm DIR``: a tiny-UNet CFM step with t, noise and crops injected (this
  rank's rows of the global arrays in ``DIR/inputs.pt``), the gradients
  averaged over the ranks; then the trainer's own step on this rank's rows
  of the global batch (generator draws, SGD with lr 1, so the parameter
  change is the gradient);
- ``bn DIR``: the trainer's step of the tiny multitask net under BatchNorm;
- ``fsdp DIR``: from a one-process checkpoint, one Adam step with
  ``fsdp=2`` (the sharded moments) and one with ``fsdp=1`` (DDP), and a
  checkpoint of the ``fsdp=2`` state.

Rank 0 writes what it computed to ``DIR/result.pt``. The helpers that build
the tasks and run a trainer step are imported by the test for the
one-process side.
"""

from __future__ import annotations

import functools
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from stain2stain_tpu_torch.models import UNetModel  # noqa: E402
from stain2stain_tpu_torch.ops.cfm import ConditionalFlowMatcher  # noqa: E402
from stain2stain_tpu_torch.ops.losses import mse_loss  # noqa: E402
from stain2stain_tpu_torch.parallel import shard_batch  # noqa: E402
from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule  # noqa: E402
from stain2stain_tpu_torch.training import Trainer  # noqa: E402
from stain2stain_tpu_torch.training import optim as toptim  # noqa: E402
from stain2stain_tpu_torch.utils.seed import seed_everything  # noqa: E402

SIZE = 16
TINY_UNET = dict(num_channels=16, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="8",
                 num_head_channels=8)
SIGMA = 0.1
AUGMENT = {"crop_size": SIZE, "hflip": True, "vflip": True}


def cfm_task(state_dict=None, lr: float = 1.0, opt=toptim.SGD):
    net = UNetModel(dim=(3, SIZE, SIZE), device="cpu", dropout=0.0, **TINY_UNET)
    if state_dict is not None:
        net.load_state_dict(state_dict)
    return ConditionalFlowMatchingModule(net=net, optimizer=functools.partial(opt, lr=lr),
                                         flow_matcher=ConditionalFlowMatcher(sigma=SIGMA))


def multitask_task(state_dict=None):
    from stain2stain_tpu_torch.models.shared_encoder import SharedEncoder
    from stain2stain_tpu_torch.models.task_decoders import FlowMatchingDecoder, SegmentationDecoder
    from stain2stain_tpu_torch.tasks import MultitaskFlowMatchingModule

    task = MultitaskFlowMatchingModule(
        encoder=SharedEncoder(features=(8, 16), norm="batch", device="cpu"),
        flow_decoder=FlowMatchingDecoder(bottleneck_channels=16, features=(8,), time_emb_dim=16, norm="batch",
                                         device="cpu"),
        seg_decoder=SegmentationDecoder(bottleneck_channels=16, features=(8,), norm="batch", device="cpu"),
        optimizer=functools.partial(toptim.SGD, lr=1.0), time_emb_dim=16, device="cpu",
    )
    if state_dict is not None:
        task.net.load_state_dict(state_dict)
    return task


def trainer_step(task, batch: tuple, augment=None, **trainer_kw) -> dict:
    """One step of the port's Trainer on ``batch`` (this process's rows):
    ``delta`` = parameters before − after (the gradient under SGD lr 1),
    ``buffers`` after, the step's ``loss``, and the trainer. The run's seed
    is set to 0 first: the step's generator derives from it, in the test's
    process as in a fresh worker."""
    seed_everything(0)
    trainer = Trainer(accelerator="cpu", logger=False, callbacks=[], **trainer_kw)
    trainer._prepare_task(task)
    trainer._init_state(task)
    trainer._wrap_ddp(task)
    before = {n: p.detach().clone() for n, p in task.net.named_parameters()}
    metrics = trainer._train_step(task, batch, augment)
    return {
        "delta": {n: before[n] - p.detach() for n, p in task.net.named_parameters()},
        "buffers": {n: b.detach().clone() for n, b in task.net.named_buffers()},
        "loss": float(metrics["loss"]),
        "trainer": trainer,
    }


def injected_grads(task, src_u8, tgt_u8, t, eps) -> dict:
    """Gradients of the CFM loss with t and the noise given, averaged over the ranks."""
    src, tgt = task.prepare_batch((src_u8, tgt_u8), train=True)
    t, xt, ut = task.flow_matcher.sample_location_and_conditional_flow(src, tgt, t=t, eps=eps)
    loss = mse_loss(task._apply_net(t, xt, train=True), ut)
    loss.backward()
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    grads = {}
    for name, p in task.net.named_parameters():
        g = p.grad.detach().clone()
        if world > 1:
            torch.distributed.all_reduce(g)
            g /= world
        grads[name] = g
    return grads


def _save(out: Path, result: dict) -> None:
    if torch.distributed.get_rank() == 0:
        torch.save(result, out / "result.pt")


def mode_step() -> None:
    from torch.nn.parallel import DistributedDataParallel

    from stain2stain_tpu_torch.data.base import DataLoader, Dataset

    class ToyPairs(Dataset):
        def __init__(self, n=32, dim=8):
            rng = np.random.default_rng(0)
            self.x = rng.standard_normal((n, dim)).astype(np.float32)
            self.y = (self.x @ rng.standard_normal((dim, 1))).astype(np.float32)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, idx):
            return self.x[idx], self.y[idx]

    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    loader = DataLoader(ToyPairs(), batch_size=8, shuffle=True, drop_last=True, num_workers=1, seed=0,
                        shard_index=rank, num_shards=world)
    torch.manual_seed(0)
    model = DistributedDataParallel(torch.nn.Linear(8, 1))
    opt = toptim.Adam(model.parameters(), lr=1e-2)
    epoch_means = []
    for epoch in range(4):
        loader.set_epoch(epoch)
        losses = []
        for x, y in loader:
            assert x.shape[0] == 4, x.shape  # the global batch of 8 over 2 processes
            loss = torch.mean(torch.square(model(torch.from_numpy(x)) - torch.from_numpy(y)))
            opt.zero_grad()
            loss.backward()
            opt.step()
            mean = loss.detach().clone()
            torch.distributed.all_reduce(mean)
            losses.append(float(mean) / world)
        epoch_means.append(float(np.mean(losses)))
    checksum = float(sum(p.detach().double().abs().sum() for p in model.parameters()))
    assert epoch_means[-1] < epoch_means[0], epoch_means
    print(f"MPOK rank={rank} loss={epoch_means[-1]:.8f} checksum={checksum:.10f}", flush=True)


def mode_cfm(out: Path) -> None:
    inputs = torch.load(out / "inputs.pt", weights_only=False)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    rows = functools.partial(shard_batch, None, index=rank, count=world)
    task = cfm_task(inputs["state_dict"])
    src, tgt, t, eps = rows((inputs["src"], inputs["tgt"], inputs["t"], inputs["eps"]))
    grads = injected_grads(task, src, tgt, t, eps)
    step = trainer_step(cfm_task(inputs["state_dict"]), rows(inputs["batch"]), AUGMENT)
    _save(out, {"grads": grads, "delta": step["delta"]})


def mode_bn(out: Path) -> None:
    inputs = torch.load(out / "inputs.pt", weights_only=False)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    step = trainer_step(multitask_task(inputs["state_dict"]), shard_batch(None, inputs["batch"], rank, world))
    _save(out, {"delta": step["delta"], "buffers": step["buffers"]})


def mode_fsdp(out: Path) -> None:
    inputs = torch.load(out / "inputs.pt", weights_only=False)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    batch = shard_batch(None, inputs["batch"], rank, world)
    seed_everything(0)  # the one-process checkpoint's run seed
    result = {}
    for fsdp in (2, 1):
        task = cfm_task(lr=1e-3, opt=toptim.Adam)
        trainer = Trainer(accelerator="cpu", logger=False, callbacks=[], fsdp=fsdp, fsdp_min_size=16)
        trainer._prepare_task(task)
        trainer._init_state(task)
        trainer._wrap_ddp(task)
        trainer._restore(str(out / "one_process"))
        trainer._train_step(task, batch, AUGMENT)
        result[f"params_fsdp{fsdp}"] = {n: p.detach().clone() for n, p in task.net.named_parameters()}
        opt = trainer.state.optimizer
        result[f"state_bytes_fsdp{fsdp}"] = (opt.state_bytes() if fsdp > 1 else
                                             sum(v.numel() * v.element_size() for s in opt.state.values()
                                                 for v in s.values() if torch.is_tensor(v)))
        if fsdp > 1:
            result["sharded_params"] = [n for n, p in task.net.named_parameters()
                                        if any(p is opt.params[i] for i in opt.sharded())]
            trainer.save_checkpoint(str(out / "fsdp2"))
    byte_counts = [torch.tensor(result["state_bytes_fsdp2"])]
    gathered = [torch.zeros_like(byte_counts[0]) for _ in range(world)]
    torch.distributed.all_gather(gathered, byte_counts[0])
    result["state_bytes_fsdp2_by_rank"] = [int(b) for b in gathered]
    _save(out, result)


def main() -> None:
    torch.set_num_threads(1)
    from stain2stain_tpu_torch.parallel import maybe_initialize_distributed

    assert maybe_initialize_distributed(), "no process group"
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "step":
        mode_step()
    else:
        {"cfm": mode_cfm, "bn": mode_bn, "fsdp": mode_fsdp}[mode](Path(args[0]))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"MPDONE rank={os.environ['RANK']}", flush=True)


if __name__ == "__main__":
    main()
