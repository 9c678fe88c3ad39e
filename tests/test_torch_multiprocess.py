"""Data parallelism of the port over two gloo processes on the CPU.

Each test starts two workers (``tests/helpers/torch_mp_worker.py``, or the
training entry point itself through ``tests/helpers/torch_ddp_cli.py``),
waits for both within its own limit and kills both past it, as
``tests/test_multiprocess.py`` does for the JAX package. Checked against one
process on the same global batch:

- (a) a toy DDP regression on the sharded loader: both ranks end with the
  same parameters and losses;
- (b) a tiny-UNet CFM step: the gradient averaged over 2 ranks equals the
  one-process gradient within 1e-5 × max|g|, and the JAX package's gradient
  on the global batch within 3e-4 (t, noise and crops injected, dropout 0);
  the trainer's own step (generator draws for the global batch) equals the
  one-process step within 1e-5 × max|g|;
- (c) the multitask net under BatchNorm: the 2-rank running statistics and
  gradient equal the one-process ones within 1e-5;
- (d) ``fsdp=2``: each rank holds about half of the sharded parameters'
  Adam moments, the update equals DDP's within 1e-6, and its checkpoint
  resumes in one process (and a one-process checkpoint in it);
- (e) ``python -m stain2stain_tpu_torch.train ... trainer=ddp_sim`` end to
  end: the launcher starts rank 1, ``val/loss`` and ``test/loss`` are the
  same on both ranks, only rank 0 writes logger files, and the checkpoint
  resumes in one process with the same test loss.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops.cfm import ConditionalFlowMatcher as JaxFlowMatcher
from stain2stain_tpu.ops.image import normalize_uint8 as j_normalize_uint8
from stain2stain_tpu.ops.losses import mse_loss as j_mse_loss
from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
from stain2stain_tpu_torch.config import compose, instantiate
from stain2stain_tpu_torch.training import Trainer
from stain2stain_tpu_torch.training import optim as toptim
from stain2stain_tpu_torch.utils.seed import seed_everything
from stain2stain_tpu_torch.utils.utils import instantiate_task
from tests.helpers import torch_mp_worker as W

REPO_ROOT = Path(__file__).resolve().parent.parent
WORKER = REPO_ROOT / "tests" / "helpers" / "torch_mp_worker.py"
CLI = REPO_ROOT / "tests" / "helpers" / "torch_ddp_cli.py"
TIMEOUT = 240
RANK_TOL = 1e-5  # 2 ranks against one process, × max|g|: f32 summation order only
JAX_TOL = 3e-4  # the port against the JAX package (tests/test_torch_training.py)
FSDP_TOL = 1e-6  # the sharded update against DDP's: the same elementwise Adam


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    """This process's environment without launch variables, with ``extra``."""
    launch = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
              "NUM_PROCESSES", "PROCESS_ID")
    env = {k: v for k, v in os.environ.items() if k not in launch}
    return dict(env, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1", **extra)


def _wait(procs: list) -> list[str]:
    """Both outputs; on the limit both are killed. Asserts exit code 0."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-6000:]}"
    return outs


def _launch_pair(*args: str) -> list[str]:
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)),
        )
        for rank in range(2)
    ]
    return _wait(procs)


def _fields(outs: list[str], tag: str) -> list[dict]:
    lines = [line for out in outs for line in out.splitlines() if line.startswith(tag)]
    return [dict(kv.split("=", 1) for kv in line.split()[1:]) for line in lines]


def _assert_close(got: dict, want: dict, rel: float, what: str) -> None:
    assert set(got) == set(want) and got
    scale = max(float(v.abs().max()) for v in want.values())
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=rel * scale, rtol=0,
                                   err_msg=f"{what}: {name}")


def _uint8(rng, *shape) -> np.ndarray:
    return rng.integers(0, 256, shape, dtype=np.uint8)


def test_two_process_data_parallel_step():
    fields = _fields(_launch_pair("step"), "MPOK")
    assert {f["rank"] for f in fields} == {"0", "1"}
    assert len({f["checksum"] for f in fields}) == 1, fields
    assert len({f["loss"] for f in fields}) == 1, fields


def test_two_rank_cfm_step_equals_one_process_and_jax(tmp_path):
    rng = np.random.default_rng(7)
    jnet = JaxUNet(dim=(3, W.SIZE, W.SIZE), fused_attention=False, dtype=jnp.float32, dropout=0.0, **W.TINY_UNET)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((2,), jnp.float32), jnp.zeros((2, W.SIZE, W.SIZE, 3)))
    params = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
                                    params["params"])
    state_dict = unet_state_dict_from_flax(params, image_size=W.SIZE, **W.TINY_UNET)
    # the injected step: 24-px tiles cropped on the host at given offsets, t and the noise given
    big_src, big_tgt = _uint8(rng, 4, 24, 24, 3), _uint8(rng, 4, 24, 24, 3)
    tops, lefts = rng.integers(0, 9, 4), rng.integers(0, 9, 4)
    src = np.stack([big_src[i, y:y + W.SIZE, x:x + W.SIZE] for i, (y, x) in enumerate(zip(tops, lefts))])
    tgt = np.stack([big_tgt[i, y:y + W.SIZE, x:x + W.SIZE] for i, (y, x) in enumerate(zip(tops, lefts))])
    t = rng.uniform(size=4).astype(np.float32)
    eps = rng.standard_normal((4, W.SIZE, W.SIZE, 3)).astype(np.float32)
    batch = (_uint8(rng, 4, 24, 24, 3), _uint8(rng, 4, 24, 24, 3))  # the trainer's step crops and flips these
    torch.save({"state_dict": state_dict, "src": src, "tgt": tgt, "t": torch.from_numpy(t),
                "eps": torch.from_numpy(eps), "batch": batch}, tmp_path / "inputs.pt")
    _launch_pair("cfm", str(tmp_path))
    ranks = torch.load(tmp_path / "result.pt", weights_only=False)

    one = W.injected_grads(W.cfm_task(state_dict), src, tgt, torch.from_numpy(t), torch.from_numpy(eps))
    _assert_close(ranks["grads"], one, RANK_TOL, "2 ranks vs one process, injected")

    def loss_fn(p):
        s, g = j_normalize_uint8(jnp.asarray(src)), j_normalize_uint8(jnp.asarray(tgt))
        tb = jnp.asarray(t)[:, None, None, None]
        xt = (1.0 - tb) * s + tb * g + W.SIGMA * jnp.asarray(eps)
        vt = jnet.apply({"params": p}, jnp.asarray(t), xt, train=True)
        return j_mse_loss(vt, JaxFlowMatcher(sigma=W.SIGMA).conditional_flow(s, g, jnp.asarray(t)))

    with jax.default_matmul_precision("highest"):
        jax_grads = jax.jit(jax.grad(loss_fn))(params)
    want = unet_state_dict_from_flax(jax.device_get(jax_grads), image_size=W.SIZE, **W.TINY_UNET)
    for name, g in ranks["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=JAX_TOL, rtol=JAX_TOL, err_msg=name)

    one_step = W.trainer_step(W.cfm_task(state_dict), batch, W.AUGMENT)
    _assert_close(ranks["delta"], one_step["delta"], RANK_TOL, "2 ranks vs one process, trainer step")


def test_two_rank_batchnorm_statistics_and_gradients_equal_one_process(tmp_path):
    rng = np.random.default_rng(3)
    torch.manual_seed(3)
    state_dict = W.multitask_task().net.state_dict()
    batch = (_uint8(rng, 4, W.SIZE, W.SIZE, 3), _uint8(rng, 4, W.SIZE, W.SIZE, 3),
             (rng.uniform(size=(4, W.SIZE, W.SIZE)) > 0.6).astype(np.uint8))
    torch.save({"state_dict": state_dict, "batch": batch}, tmp_path / "inputs.pt")
    _launch_pair("bn", str(tmp_path))
    ranks = torch.load(tmp_path / "result.pt", weights_only=False)
    one = W.trainer_step(W.multitask_task(state_dict), batch)
    _assert_close(ranks["delta"], one["delta"], RANK_TOL, "gradient")
    stats = [k for k in one["buffers"] if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(ranks["buffers"][k].numpy(), one["buffers"][k].numpy(), atol=RANK_TOL,
                                   rtol=RANK_TOL, err_msg=k)
        assert not torch.equal(one["buffers"][k], state_dict[k]), k  # updated by the step


def test_fsdp_shards_the_moments_and_matches_ddp(tmp_path):
    rng = np.random.default_rng(5)
    torch.manual_seed(5)
    task = W.cfm_task(lr=1e-3, opt=toptim.Adam)
    batch = (_uint8(rng, 4, 24, 24, 3), _uint8(rng, 4, 24, 24, 3))
    first = W.trainer_step(task, batch, W.AUGMENT)["trainer"]  # one process: one Adam step, then its checkpoint
    first.save_checkpoint(str(tmp_path / "one_process"))
    torch.save({"batch": batch}, tmp_path / "inputs.pt")
    _launch_pair("fsdp", str(tmp_path))
    ranks = torch.load(tmp_path / "result.pt", weights_only=False)

    # the sharded update equals DDP's
    _assert_close(ranks["params_fsdp2"], ranks["params_fsdp1"], FSDP_TOL, "fsdp=2 vs DDP")
    # each rank holds half the moments of the sharded parameters, all of the others'
    net = dict(task.net.named_parameters())
    sharded = sum(net[n].numel() for n in ranks["sharded_params"]) * 4 * 2  # exp_avg, exp_avg_sq in f32
    whole = ranks["state_bytes_fsdp1"]
    assert sharded > whole // 2, (sharded, whole)  # most of the moments shard at fsdp_min_size 16
    for held in ranks["state_bytes_fsdp2_by_rank"]:
        assert held == whole - sharded // 2, (held, whole, sharded)
    # the fsdp=2 checkpoint resumes in one process: the ranks' weights bit for bit, and the
    # moments of one process's own second step from the same one-process checkpoint
    first._train_step(task, batch, W.AUGMENT)
    resumed = Trainer(accelerator="cpu", logger=False, callbacks=[])
    fresh = W.cfm_task(lr=1e-3, opt=toptim.Adam)
    resumed._prepare_task(fresh)
    resumed._init_state(fresh)
    resumed._restore(str(tmp_path / "fsdp2"))
    assert resumed.state.step == first.state.step == 2
    for n, p in fresh.net.named_parameters():
        assert torch.equal(p.detach(), ranks["params_fsdp2"][n]), n
    got, want = resumed.state.optimizer.state_dict()["state"], first.state.optimizer.state_dict()["state"]
    assert set(got) == set(want) and len(want) == len(net)
    for key in ("exp_avg", "exp_avg_sq"):
        _assert_close({i: got[i][key] for i in got}, {i: want[i][key] for i in want}, RANK_TOL, key)


def test_train_cli_ddp_sim_runs_two_ranks(tmp_path):
    overrides = [
        "experiment=smoke_synthetic", "trainer=ddp_sim", "trainer.max_epochs=1", "test=true",
        "extras.print_config=false", f"data.data_dir={tmp_path / 'data'}",
        f"logger.csv.save_dir={tmp_path}/loggers-${{oc.env:RANK}}",
        f"callbacks.model_checkpoint.dirpath={tmp_path / 'ckpts'}",
    ]
    proc = subprocess.Popen([sys.executable, str(CLI), *overrides], cwd=tmp_path, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=_env(PROJECT_ROOT=str(tmp_path)))
    fields = _fields(_wait([proc]), "MPFIT")
    assert sorted(f["rank"] for f in fields) == ["0", "1"] and {f["world"] for f in fields} == {"2"}
    for key in ("val", "test", "steps", "checksum"):
        assert len({f[key] for f in fields}) == 1, (key, fields)
    # the loggers' files come from rank 0 alone
    assert list((tmp_path / "loggers-0").rglob("metrics.csv"))
    assert not (tmp_path / "loggers-1").exists()
    # the checkpoint resumes in one process: the same test loss on the same weights
    cfg = compose(REPO_ROOT / "configs", "train.yaml", ["experiment=smoke_synthetic", "trainer=cpu",
                                                         f"data.data_dir={tmp_path / 'data'}"])
    cfg["runtime"] = {"output_dir": str(tmp_path / "one"), "cwd": str(tmp_path)}
    seed_everything(cfg["seed"])  # the eval batches' draws come from the run's seed
    trainer = instantiate(cfg.trainer, logger=False, callbacks=[])
    metrics = trainer.test(instantiate_task(cfg.model, device="cpu"), instantiate(cfg.data),
                           ckpt_path=str(tmp_path / "ckpts" / "last"))
    np.testing.assert_allclose(metrics["test/loss"], float(fields[0]["test"]), rtol=1e-6)
