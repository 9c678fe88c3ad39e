"""PyTorch port's serving path vs the JAX package's, on the CPU.

``generate`` per solver, the tiled ``TranslationServer``, the HTTP round
trip, the config tree read through the port's config code, the serving CLI
(``build_server`` and the module run), the port's isolation from JAX, and
device resolution. The nets are tiny (16 px, 16 channels, attention at a
level and in the mid block) with jittered flax weights carried across by
``unet_state_dict_from_flax``.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops.solvers import SolverConfig as JaxSolverConfig
from stain2stain_tpu.server import TranslationServer as JaxTranslationServer
from stain2stain_tpu.tasks import ConditionalFlowMatchingModule as JaxCFM
from stain2stain_tpu_torch import resolve_device
from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
from stain2stain_tpu_torch.config import InstantiationError, compose, instantiate
from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.ops.solvers import SolverConfig
from stain2stain_tpu_torch.server import TranslationServer, serve_forever
from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule

REPO_ROOT = Path(__file__).resolve().parent.parent
SIZE = 16
TINY = dict(
    num_channels=16,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_resolutions="8",
    num_head_channels=8,
)
CONV_KW = dict(
    image_size=SIZE,
    num_channels=16,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_resolutions="8",
    num_head_channels=8,
)


@pytest.fixture(scope="module")
def nets():
    """(flax net, jittered flax params, port net with the same weights)."""
    jnet = JaxUNet(dim=(3, SIZE, SIZE), fused_attention=False, dtype=jnp.float32, **TINY)
    x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((2,), jnp.float32), x)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params
    )
    tnet = UNetModel(dim=(3, SIZE, SIZE), device="cpu", **TINY)
    tnet.load_state_dict(unet_state_dict_from_flax(params, **CONV_KW), strict=True)
    return jnet, params, tnet


def _source(batch: int = 2) -> np.ndarray:
    return np.random.default_rng(7).uniform(-1, 1, size=(batch, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_generate_fixed_step_matches_jax(nets, method):
    jnet, params, tnet = nets
    src = _source()
    jtask = JaxCFM(net=jnet, solver=JaxSolverConfig(method))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda s: jtask.generate({"params": params}, s, num_steps=3))(src))
    ttask = ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig(method))
    got = ttask.generate(torch.from_numpy(src), num_steps=3)
    assert got.shape == src.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-4, rtol=3e-4)


def test_generate_dopri5_same_evaluations_and_state(nets):
    jnet, params, tnet = nets
    src = _source()
    jtask = JaxCFM(net=jnet, solver=JaxSolverConfig("dopri5"))
    j_calls = []

    def jvelocity(t, x):
        jax.debug.callback(lambda: j_calls.append(1))
        return jtask._apply_net({"params": params}, jnp.full((x.shape[0],), t), x, train=False)

    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jtask._integrate(jvelocity, jnp.asarray(src), 100))

    ttask = ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("dopri5"))
    t_calls = []
    hook = tnet.register_forward_hook(lambda *_: t_calls.append(1))
    try:
        got = ttask.generate(torch.from_numpy(src), num_steps=100)
    finally:
        hook.remove()
    assert len(t_calls) == len(j_calls) >= 7
    # accept/reject decisions agree, so only the per-evaluation 3e-4 net
    # tolerance accumulates over the steps
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=1e-3)


def test_translation_server_matches_jax(nets):
    jnet, params, tnet = nets
    img = np.random.default_rng(8).integers(0, 256, size=(40, 52, 3), dtype=np.uint8)
    jtask = JaxCFM(net=jnet, solver=JaxSolverConfig("euler"))
    with jax.default_matmul_precision("highest"):
        jserver = JaxTranslationServer(jtask, {"params": params}, num_steps=2, tile=16, overlap=4, batch=2)
        ref = jserver.translate(img)
    tserver = TranslationServer(
        ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("euler")),
        num_steps=2, tile=16, overlap=4, batch=2,
    )
    got = tserver.translate(img)
    assert got.shape == (40, 52, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=3e-4)
    assert tserver.info["requests_served"] == 1


def test_http_round_trip(nets):
    from PIL import Image

    _, _, tnet = nets
    server = TranslationServer(
        ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("euler")),
        num_steps=2, tile=16, overlap=4, batch=2,
    )
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(server, "127.0.0.1", 0, ready), daemon=True)
    thread.start()
    assert ready.wait(10)
    base = f"http://127.0.0.1:{server.bound_port}"
    try:
        assert urllib.request.urlopen(f"{base}/healthz", timeout=30).read() == b"ok"
        img = np.random.default_rng(9).integers(0, 256, size=(23, 30, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        req = urllib.request.Request(
            f"{base}/translate", data=buf.getvalue(), headers={"Content-Type": "image/png"}
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            out = np.asarray(Image.open(io.BytesIO(resp.read())))
        assert out.shape == (23, 30, 3)
        bad = urllib.request.Request(f"{base}/translate", data=b"not an image")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
        info = json.loads(urllib.request.urlopen(f"{base}/info", timeout=30).read())
        assert info["requests_served"] == 1 and info["device"] == "cpu"
    finally:
        server.httpd.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_unconditioned_server_refuses_a_target_class(nets):
    """Class conditioning is a property of the model: a class for a net
    without ``class_cond`` is refused, at construction and per request."""
    _, _, tnet = nets
    task = ConditionalFlowMatchingModule(net=tnet)
    with pytest.raises(ValueError, match="not class-conditioned"):
        TranslationServer(task, num_steps=2, tile=16, overlap=4, batch=2, target_class=1)
    server = TranslationServer(task, num_steps=2, tile=16, overlap=4, batch=2)
    assert server.info["class_conditioned"] is False and server.info["target_class"] is None
    with pytest.raises(ValueError, match="not class-conditioned"):
        server.translate(np.zeros((16, 16, 3), np.uint8), target_class=1)


_TINY_OVERRIDES = [
    "model=conditional_flow_matching",
    f"model.net.dim=[3,{SIZE},{SIZE}]",
    "model.net.num_channels=16",
    "model.net.num_res_blocks=1",
    "model.net.channel_mult=[1,2]",
    "model.net.attention_resolutions='8'",
    "model.net.num_head_channels=8",
]


def test_config_tree_instantiates_port_classes():
    cfg = compose(REPO_ROOT / "configs", "infer.yaml", _TINY_OVERRIDES)
    assert cfg.model.net["_target_"] == "stain2stain_tpu.models.UNetModel"
    net = instantiate(cfg.model.net, device="cpu")
    assert isinstance(net, UNetModel) and net.dropout == 0.1
    solver = instantiate(cfg.model.solver)()
    assert isinstance(solver, SolverConfig) and solver.solver == "dopri5"
    # the task, with its net built where the caller says
    task = instantiate(cfg.model, net=net)
    assert isinstance(task, ConditionalFlowMatchingModule) and task.net is net
    optimizer, scheduler = task.configure_optimizers()
    assert type(optimizer).__module__ == "stain2stain_tpu_torch.training.optim"
    assert scheduler.patience == 10
    # a target that neither package has raises, naming it
    with pytest.raises(InstantiationError, match=r"stain2stain_tpu\.serving\.export_onnx"):
        instantiate({"_target_": "stain2stain_tpu.serving.export_onnx"})


def test_serve_cli_build_server(nets, tmp_path, monkeypatch):
    from stain2stain_tpu_torch import serve

    _, _, tnet = nets
    ckpt = tmp_path / "last.ckpt"
    torch.save({"state_dict": {f"net.{k}": v for k, v in tnet.state_dict().items()}}, ckpt)
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    cfg = compose(
        REPO_ROOT / "configs",
        "infer.yaml",
        _TINY_OVERRIDES
        + [f"ckpt_path={ckpt}", "device=cpu", "model.solver.solver=euler", "num_steps=2",
           "tile=16", "overlap=4", "wsi_batch=2"],
    )
    server = serve.build_server(cfg)
    assert server.info["tile"] == 16 and server.task.solver.solver == "euler"
    img = np.random.default_rng(10).integers(0, 256, size=(20, 18, 3), dtype=np.uint8)
    ref = TranslationServer(
        ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("euler")),
        num_steps=2, tile=16, overlap=4, batch=2,
    ).translate(img)
    np.testing.assert_array_equal(server.translate(img), ref)


def test_serve_cli_answers_over_http(nets, tmp_path):
    """``python -m stain2stain_tpu_torch.serve`` composes, loads and serves."""
    from PIL import Image

    _, _, tnet = nets
    ckpt = tmp_path / "net.pt"
    torch.save(tnet.state_dict(), ckpt)
    cmd = [
        sys.executable, "-m", "stain2stain_tpu_torch.serve", *_TINY_OVERRIDES,
        f"ckpt_path={ckpt}", "device=cpu", "model.solver.solver=euler", "num_steps=2",
        "tile=16", "overlap=4", "wsi_batch=2", "host=127.0.0.1", "port=0",
    ]
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), PROJECT_ROOT=str(tmp_path))
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:  # ends at EOF if the server dies
            match = re.search(r"Serving \S+ on 127\.0\.0\.1:(\d+)", line)
            if match:
                port = int(match.group(1))
                break
        assert port, f"server exited with {proc.poll()}"
        img = np.random.default_rng(11).integers(0, 256, size=(20, 24, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/translate", data=buf.getvalue(),
            headers={"Content-Type": "image/png"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            assert np.asarray(Image.open(io.BytesIO(resp.read()))).shape == (20, 24, 3)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert (tmp_path / "logs" / "infer").is_dir()  # config_main's run directory


def test_port_imports_nothing_of_jax():
    code = (
        "import sys\n"
        "import stain2stain_tpu_torch, stain2stain_tpu_torch.serve, stain2stain_tpu_torch.server\n"
        "import stain2stain_tpu_torch.models.unet, stain2stain_tpu_torch.compat\n"
        "import stain2stain_tpu_torch.train, stain2stain_tpu_torch.training, stain2stain_tpu_torch.data\n"
        "import stain2stain_tpu_torch.data.synthetic_module, stain2stain_tpu_torch.data.device_cache\n"
        "import stain2stain_tpu_torch.data.native, stain2stain_tpu_torch.utils.utils\n"
        "import stain2stain_tpu_torch.ops.cfm, stain2stain_tpu_torch.ops.dropout, stain2stain_tpu_torch.ops.losses\n"
        "import stain2stain_tpu_torch.ops.conv, stain2stain_tpu_torch.ops.metrics, stain2stain_tpu_torch.ops.inception\n"
        "import stain2stain_tpu_torch.inference, stain2stain_tpu_torch.eval, stain2stain_tpu_torch.eval_quality\n"
        "import stain2stain_tpu_torch.infer_simple_flowmatching, stain2stain_tpu_torch.infer_wsi\n"
        "import stain2stain_tpu_torch.infer_any2any, stain2stain_tpu_torch.data.class_conditional\n"
        "import stain2stain_tpu_torch.tasks.class_conditional_flow_matching, stain2stain_tpu_torch.wsi\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax', 'stain2stain_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax.', 'optax.', 'stain2stain_tpu.')))\n"
        "assert 'stain2stain_tpu_torch.serve' in sys.modules and 'stain2stain_tpu_torch.train' in sys.modules\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UNetModel(dim=(3, SIZE, SIZE), **TINY)
    net = UNetModel(dim=(3, SIZE, SIZE), device="cpu", **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConditionalFlowMatchingModule(net=net, device="cuda")
    assert ConditionalFlowMatchingModule(net=net).device.type == "cpu"
