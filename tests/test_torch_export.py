"""PyTorch port's sealed generator (``serving.py``, ``export_model``) vs the
direct ``generate`` and vs the JAX package, on the CPU.

A tiny UNet (16 px, 16 channels, attention at a level and in the mid block)
with jittered flax weights carried across by ``unet_state_dict_from_flax``
is sealed by ``export_generator`` under euler and rk4, loaded by
``load_generator`` and run: within 1e-6 of the direct ``generate`` (the
same ops in the same order) and 3e-4 of JAX's ``generate`` on the same
weights and source (dopri5: ``test_torch_export_dopri5.py``). The program's
graph holds the registered K1-fwd op (``s2s::attention_fwd``), and a bf16
``fused_conv`` net's holds K2's (``s2s::conv3x3_fwd``). The sidecar has JAX's
keys; ``python -m stain2stain_tpu_torch.export_model`` writes the same program.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops.solvers import SolverConfig as JaxSolverConfig
from stain2stain_tpu.serving import export_generator as jax_export_generator
from stain2stain_tpu.tasks import ConditionalFlowMatchingModule as JaxCFM
from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.ops.solvers import SolverConfig
from stain2stain_tpu_torch.serving import export_generator, load_generator
from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule

REPO_ROOT = Path(__file__).resolve().parent.parent
SIZE = 16
TINY = dict(num_channels=16, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="8", num_head_channels=8)
DIRECT_TOL = 1e-6
JAX_TOL = 3e-4


def _pair(**kw):
    """(flax net, jittered flax params, port net with the same weights)."""
    jnet = JaxUNet(dim=(3, SIZE, SIZE), fused_attention=False, dtype=jnp.float32, **kw)
    x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((2,), jnp.float32), x)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params
    )
    tnet = UNetModel(dim=(3, SIZE, SIZE), device="cpu", **kw)
    tnet.load_state_dict(unet_state_dict_from_flax(params, image_size=SIZE, **kw), strict=True)
    return jnet, params, tnet


@pytest.fixture(scope="module")
def nets():
    return _pair(**TINY)


def _source(batch: int = 2) -> np.ndarray:
    return np.random.default_rng(7).uniform(-1, 1, size=(batch, SIZE, SIZE, 3)).astype(np.float32)


def _ops(call) -> set:
    """Every call target of a loaded program's graphs, the loop bodies' included."""
    gm = call.program.graph_module
    return {str(node.target) for mod in gm.modules() if isinstance(mod, torch.fx.GraphModule)
            for node in mod.graph.nodes if node.op == "call_function"}


def check_sealed_generator(jnet, params, tnet, tmp_path, method: str, num_steps: int) -> None:
    """Export, load and run ``generate`` under ``method``: against the direct
    call (1e-6) and JAX (3e-4); the graph holds K1-fwd's op, and dopri5's a
    ``while_loop``."""
    src = _source()
    task = ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig(method))
    direct = task.generate(torch.from_numpy(src), num_steps=num_steps)
    program = export_generator(task, tmp_path / f"{method}.pt2", batch=2, image_size=SIZE, num_steps=num_steps)
    call = load_generator(program, device="cpu")
    loaded = call(src)
    assert loaded.shape == direct.shape and torch.isfinite(loaded).all()
    assert (loaded - direct).abs().max().item() <= DIRECT_TOL
    jtask = JaxCFM(net=jnet, solver=JaxSolverConfig(method))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jtask.generate({"params": params}, jnp.asarray(src), num_steps=num_steps))
    assert np.abs(loaded.numpy() - ref).max() < JAX_TOL * max(1.0, np.abs(ref).max())
    ops = _ops(call)
    assert "s2s.attention_fwd.default" in ops
    assert ("while_loop" in ops) == (method == "dopri5")


@pytest.mark.parametrize("method,num_steps", [("euler", 3), ("rk4", 3)])
def test_sealed_generator_matches_direct_and_jax(nets, tmp_path, method, num_steps):
    """The fixed-step solvers (dopri5 in ``test_torch_export_dopri5.py``)."""
    check_sealed_generator(*nets, tmp_path, method, num_steps)


def test_sidecar_keys_equal_jax(nets, tmp_path):
    jnet, params, tnet = nets
    task = ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("euler"))
    export_generator(task, tmp_path / "g.pt2", batch=2, image_size=SIZE, num_steps=2)
    jax_export_generator(JaxCFM(net=jnet, solver=JaxSolverConfig("euler")), {"params": params},
                         tmp_path / "g.stablehlo", batch=2, image_size=SIZE, num_steps=2)
    ours = json.loads((tmp_path / "g.pt2.json").read_text())
    theirs = json.loads((tmp_path / "g.stablehlo.json").read_text())
    assert set(ours) == set(theirs)
    assert {k: ours[k] for k in ("task", "batch", "image_size", "num_steps", "in_channels", "gen_kwargs")} == \
        {k: theirs[k] for k in ("task", "batch", "image_size", "num_steps", "in_channels", "gen_kwargs")}
    assert ours["platforms"] == ["cpu"]


def test_fused_conv_program_holds_k2(tmp_path):
    """A bf16 ``fused_conv`` net runs K2 in ``generate``: its program holds
    ``s2s::conv3x3_fwd`` and gives the direct output bit for bit."""
    torch.manual_seed(0)
    net = UNetModel(dim=(3, 16, 16), num_channels=128, num_res_blocks=1, channel_mult=(1,),
                    attention_resolutions="16", num_head_channels=32, fused_conv=True, device="cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn_like(p))
    net.dtype = torch.bfloat16
    task = ConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler"))
    src = torch.from_numpy(_source())
    direct = task.generate(src, num_steps=2)
    program = export_generator(task, tmp_path / "fused.pt2", batch=2, image_size=16, num_steps=2)
    call = load_generator(program, device="cpu")
    assert {"s2s.conv3x3_fwd.default", "s2s.attention_fwd.default"} <= _ops(call)
    assert torch.equal(call(src), direct)


def test_one_platform_and_device(nets, tmp_path):
    _, _, tnet = nets
    task = ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("euler"))
    with pytest.raises(ValueError, match=r"\['cuda', 'cpu'\]"):
        export_generator(task, tmp_path / "g.pt2", batch=2, image_size=SIZE, platforms=["cuda", "cpu"])
    program = export_generator(task, tmp_path / "g.pt2", batch=2, image_size=SIZE, num_steps=2, platforms=["cpu"])
    with pytest.raises(ValueError, match="exported for cpu"):
        load_generator(program, device="meta")


def test_export_model_cli(nets, tmp_path, monkeypatch):
    """``export_model`` on a checkpoint writes the program ``export_generator``
    writes for the same task: the same output."""
    from stain2stain_tpu_torch import export_model

    _, _, tnet = nets
    ckpt = tmp_path / "last.ckpt"
    torch.save({"state_dict": {f"net.{k}": v for k, v in tnet.state_dict().items()}}, ckpt)
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    out = export_model.main([
        f"ckpt_path={ckpt}", "device=cpu", "model.solver.solver=euler", "num_steps=2", "+batch=2",
        f"+image_size={SIZE}", f"+out={tmp_path / 'cli.pt2'}", f"model.net.dim=[3,{SIZE},{SIZE}]",
        "model.net.num_channels=16", "model.net.num_res_blocks=1", "model.net.channel_mult=[1,2]",
        "model.net.attention_resolutions='8'", "model.net.num_head_channels=8",
    ])
    assert Path(out) == tmp_path / "cli.pt2"
    meta = json.loads((tmp_path / "cli.pt2.json").read_text())
    assert (meta["batch"], meta["image_size"], meta["num_steps"], meta["platforms"]) == (2, SIZE, 2, ["cpu"])
    src = _source()
    direct = ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("euler")).generate(
        torch.from_numpy(src), num_steps=2)
    assert torch.equal(load_generator(out, device="cpu")(src), direct)
