"""PyTorch port's tools vs the JAX package's, on the CPU: ``convert_ckpt``,
``data_sanity``, ``center_resize`` and ``scripts/torch_from_orbax.py``.

- ``convert_ckpt`` on a reference-layout Lightning ``.ckpt`` of the
  ``tests/helpers/adm_torch.py`` oracle, in the legacy qkv order and in the
  new one (``+attention_order=new``): the converted directory's net against
  the oracle, and against the JAX net from JAX's converter on the same file
  (3e-4); a stray key raises ``ConversionError`` naming it.
- A multitask ``.ckpt`` of the ``tests/helpers/multitask_torch.py`` oracle:
  its tensors land in the port's net as they are, BatchNorm statistics
  included, and without ``norm=batch`` the JAX guard fires with JAX's message.
- An aux-fraction ``.ckpt`` (no ``frac_head``): JAX's converted checkpoint
  fails in ``generate`` on the missing head; the port's directory, with the
  head as the task's init draws it, loads through ``load_task``.
- ``data_sanity``: the report equals JAX ``check_csv_dataset``'s on the same
  tree, whole and with a file removed; exit 0, then 1.
- ``center_resize`` against ``jax.image.resize``, up and down (1e-6).
- ``scripts/torch_from_orbax.py`` on a JAX ``CheckpointIO`` save of a tiny
  aux-fraction task: the port's velocity and fraction head against JAX's (3e-4).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.compat import convert_lightning_state_dict as jax_convert
from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu_torch import convert_ckpt, data_sanity
from stain2stain_tpu_torch.compat import ConversionError
from stain2stain_tpu_torch.config import compose
from stain2stain_tpu_torch.inference import load_task
from stain2stain_tpu_torch.ops.image import center_resize
from tests.helpers import multitask_torch as mt
from tests.helpers.adm_torch import ADMUNet

REPO_ROOT = Path(__file__).resolve().parent.parent
TOL = 3e-4
SIZE = 16
TINY = dict(num_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="8", num_head_channels=8)
NET_OVERRIDES = [
    f"model.net.dim=[3,{SIZE},{SIZE}]", "model.net.num_channels=32", "model.net.num_res_blocks=1",
    "model.net.channel_mult=[1,2]", "model.net.attention_resolutions='8'", "model.net.num_head_channels=8",
    "model.net.dropout=0.0", "device=cpu",
]


def _qkv_perm(channels: int, head_dim: int) -> np.ndarray:
    """Legacy row of each ``[q‖k‖v]`` column (JAX ``torch_unet.py::_qkv_perm``)."""
    cols = np.arange(3 * channels)
    comp, rem = cols // channels, cols % channels
    return (rem // head_dim) * 3 * head_dim + comp * head_dim + rem % head_dim


def _oracle() -> ADMUNet:
    torch.manual_seed(0)
    oracle = ADMUNet(image_size=SIZE, **TINY).eval()
    with torch.no_grad():
        for p in oracle.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return oracle


def _new_order(sd: dict) -> dict:
    """The oracle's legacy-order state dict as a ``use_new_attention_order``
    net keeps it: every qkv's rows ``[q‖k‖v]``."""
    out = dict(sd)
    for key in [k for k in sd if k.endswith(".qkv.weight")]:
        prefix = key[: -len(".weight")]
        channels = sd[key].shape[1]
        perm = torch.from_numpy(_qkv_perm(channels, TINY["num_head_channels"]))
        for name in ("weight", "bias"):
            out[f"{prefix}.{name}"] = sd[f"{prefix}.{name}"][perm]
    return out


def _convert(tmp_path, overrides: list, out: Path):
    return convert_ckpt.main(overrides + [f"+out={out}", f"paths.log_dir={tmp_path}/logs", "extras.print_config=false"])


@pytest.mark.parametrize("order", ["legacy", "new"])
def test_convert_ckpt_unet_against_oracle_and_jax(tmp_path, monkeypatch, order):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    oracle = _oracle()
    sd = oracle.state_dict() if order == "legacy" else _new_order(oracle.state_dict())
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {**{f"net.{k}": v for k, v in sd.items()}, "flow_matcher.sigma": torch.tensor(0.0)},
                "epoch": 4, "global_step": 40}, ckpt)
    out = tmp_path / "converted"
    _convert(tmp_path, [f"ckpt_path={ckpt}", "model=conditional_flow_matching", f"+attention_order={order}"]
             + NET_OVERRIDES, out)
    meta = json.loads((out / "meta.json").read_text())
    assert meta == {"epoch": 4, "global_step": 40, "converted_from": str(ckpt), "weights_only_conversion": True}
    saved = torch.load(out / "state.pt", weights_only=True)
    assert saved["step"] == 40 and saved["optimizer"]["state"] == {}
    cfg = compose(REPO_ROOT / "configs", "infer.yaml", ["model=conditional_flow_matching", f"ckpt_path={out}"]
                  + NET_OVERRIDES)
    net = load_task(cfg).net.eval()
    x = np.random.default_rng(2).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([0.2, 0.8], np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(t), torch.from_numpy(x)).numpy()
        ref = oracle(torch.from_numpy(t), torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() < TOL * max(1.0, np.abs(ref).max())
    # JAX's converter on the same file, its net on the same input
    params = jax_convert(torch.load(ckpt, weights_only=True)["state_dict"], image_size=SIZE, attention_order=order,
                         **TINY)
    jnet = JaxUNet(dim=(3, SIZE, SIZE), fused_attention=False, dtype=jnp.float32, **TINY)
    with jax.default_matmul_precision("highest"):
        jref = np.asarray(jnet.apply({"params": params}, jnp.asarray(t), jnp.asarray(x)))
    assert np.abs(got - jref).max() < TOL * max(1.0, np.abs(jref).max())


def test_convert_ckpt_stray_key_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    sd = {f"net.{k}": v for k, v in _oracle().state_dict().items()}
    torch.save({"state_dict": {**sd, "net.stray.weight": torch.zeros(3)}}, tmp_path / "stray.ckpt")
    with pytest.raises(ConversionError, match="stray.weight"):
        _convert(tmp_path, [f"ckpt_path={tmp_path / 'stray.ckpt'}", "model=conditional_flow_matching"]
                 + NET_OVERRIDES, tmp_path / "bad")
    del sd["net.out.2.bias"]
    torch.save({"state_dict": sd}, tmp_path / "short.ckpt")
    with pytest.raises(ConversionError, match=r"out\.2\.bias"):
        _convert(tmp_path, [f"ckpt_path={tmp_path / 'short.ckpt'}", "model=conditional_flow_matching"]
                 + NET_OVERRIDES, tmp_path / "bad")


MT_OVERRIDES = [
    "model=conditional_flow_matching_multitask", "model.encoder.features=[8,16]", "model.flow_decoder.features=[8]",
    "model.flow_decoder.bottleneck_channels=16", "model.flow_decoder.time_emb_dim=16", "model.seg_decoder.features=[8]",
    "model.seg_decoder.bottleneck_channels=16", "model.time_emb_dim=16", "device=cpu",
]
BATCH_NORM = ["+model.encoder.norm=batch", "+model.flow_decoder.norm=batch", "+model.seg_decoder.norm=batch"]


def test_convert_ckpt_multitask(tmp_path, monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    torch.manual_seed(6)

    class Oracle(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = mt.SharedEncoder(3, (8, 16))
            self.flow_decoder = mt.FlowMatchingDecoder(16, (8,), 3, 16)
            self.seg_decoder = mt.SegmentationDecoder(16, (8,), 1)

    oracle = Oracle()
    mt.randomize_bn_stats(oracle, seed=7)
    ckpt = tmp_path / "multitask.ckpt"
    torch.save({"state_dict": {**oracle.state_dict(), "flow_matcher.sigma": torch.tensor(0.0)}, "epoch": 3,
                "global_step": 42}, ckpt)
    with pytest.raises(ValueError, match=r"convert AND evaluate with \+model\.encoder\.norm=batch"):
        _convert(tmp_path, [f"ckpt_path={ckpt}"] + MT_OVERRIDES, tmp_path / "bad")
    out = tmp_path / "converted_mt"
    _convert(tmp_path, [f"ckpt_path={ckpt}"] + MT_OVERRIDES + BATCH_NORM, out)
    task = load_task(compose(REPO_ROOT / "configs", "infer.yaml", [f"ckpt_path={out}"] + MT_OVERRIDES + BATCH_NORM))
    ours = task.net.state_dict()
    assert set(ours) == set(oracle.state_dict())
    for key, value in oracle.state_dict().items():
        assert torch.equal(ours[key], value), key
    assert json.loads((out / "meta.json").read_text())["global_step"] == 42


AUX = ["model=conditional_flow_matching", "model._target_=stain2stain_tpu.tasks.AuxFractionFlowMatchingModule"]


def test_convert_ckpt_aux_fraction(tmp_path, monkeypatch):
    """The reference ``.ckpt`` holds no ``frac_head``: JAX's converter writes
    the net alone and the JAX task's ``_split`` then fails in ``generate``;
    the port writes the head as its init draws it, and ``load_task`` loads
    the directory."""
    from src.convert_ckpt import main as jax_convert_main
    from stain2stain_tpu.config import compose as jax_compose
    from stain2stain_tpu.config import instantiate as jax_instantiate
    from stain2stain_tpu.inference import load_state

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    ckpt = tmp_path / "aux.ckpt"
    torch.save({"state_dict": {f"net.{k}": v for k, v in _oracle().state_dict().items()}, "epoch": 1,
                "global_step": 8}, ckpt)
    jax_overrides = [f"ckpt_path={ckpt}", *AUX, *[o for o in NET_OVERRIDES if o != "device=cpu"],
                     f"paths.log_dir={tmp_path}/logs", "extras.print_config=false"]
    jax_convert_main([*jax_overrides, f"+out={tmp_path / 'jax_aux'}"])
    jtask = jax_instantiate(jax_compose(REPO_ROOT / "configs", "infer.yaml", jax_overrides)["model"])
    state = load_state(str(tmp_path / "jax_aux"))
    src = np.zeros((1, SIZE, SIZE, 3), np.float32)
    with pytest.raises(KeyError, match="frac_head"):
        jtask.generate(state.variables, jnp.asarray(src), num_steps=2)

    out = tmp_path / "port_aux"
    _convert(tmp_path, [f"ckpt_path={ckpt}", *AUX, *NET_OVERRIDES], out)
    assert json.loads((out / "meta.json").read_text())["initialized_heads"] == ["frac_head"]
    task = load_task(compose(REPO_ROOT / "configs", "infer.yaml", [f"ckpt_path={out}", *AUX, *NET_OVERRIDES]))
    assert set(task.heads) == {"frac_head"}
    assert torch.isfinite(task.generate(torch.from_numpy(src), num_steps=2)).all()


def _tree(tmp_path):
    from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset

    return generate_paired_dataset(tmp_path / "ds", n_train=6, n_val=2, n_test=2, size=32, with_mask=True)


def test_data_sanity_report_equals_jax(tmp_path, monkeypatch, capsys):
    from src.data_sanity import check_csv_dataset as jax_check

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    root = _tree(tmp_path)
    cfg = {"data_dir": str(root), "csv_file_name": "metadata.csv"}
    ours = data_sanity.check_csv_dataset(cfg)
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(jax_check(cfg), default=str))
    assert ours["rows"] == 10 and not ours["errors"] and ours["shape_histogram"] == {"32x32": 40}
    argv = [f"data.data_dir={root}", "data=paired_data_mask_he_amyloid", "data.csv_file_name=metadata.csv",
            f"paths.log_dir={tmp_path}/logs", "extras.print_config=false"]
    assert data_sanity.main(argv)["rows"] == 10

    victim = next((root / "train").glob("*.png"))
    victim.unlink()
    ours = data_sanity.check_csv_dataset(cfg)
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(jax_check(cfg), default=str))
    assert ours["errors"] and sum(ours["missing_files"].values()) == 1
    capsys.readouterr()
    with pytest.raises(SystemExit) as exit_info:
        data_sanity.main(argv)
    assert exit_info.value.code == 1
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index('{\n  "csv"'):])["missing_files"] == ours["missing_files"]
    assert data_sanity.check_csv_dataset({"data_dir": str(tmp_path / "nowhere")})["errors"]


@pytest.mark.parametrize("shape,size", [((2, 16, 16, 3), 8), ((2, 20, 12, 3), 7), ((1, 9, 13, 4), 24),
                                        ((2, 32, 32, 3), 5)])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_center_resize_matches_jax(shape, size, method):
    from stain2stain_tpu.ops.image import center_resize as jax_center_resize

    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = center_resize(torch.from_numpy(x), size, method).numpy()
    ref = np.asarray(jax_center_resize(jnp.asarray(x), size, method))
    assert got.shape == ref.shape == (shape[0], size, size, shape[-1])
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_torch_from_orbax_aux_fraction(tmp_path, monkeypatch):
    """A JAX ``CheckpointIO`` save of an aux-fraction task → the script → the
    port's velocity and fraction head equal JAX's on the same input."""
    import optax

    from stain2stain_tpu.ops.solvers import SolverConfig as JaxSolverConfig
    from stain2stain_tpu.tasks import AuxFractionFlowMatchingModule as JaxAux
    from stain2stain_tpu.training.state import CheckpointIO as JaxCheckpointIO
    from stain2stain_tpu.training.state import TrainState as JaxTrainState

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    jnet = JaxUNet(dim=(3, SIZE, SIZE), fused_attention=False, dtype=jnp.float32, **TINY)
    jtask = JaxAux(net=jnet, solver=JaxSolverConfig("euler"))
    x = np.random.default_rng(4).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    variables = jtask.init_variables(jax.random.key(0), (jnp.asarray(x),))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
                                       jax.device_get(variables))
    state = JaxTrainState.create(variables, optax.adam(1e-3))
    JaxCheckpointIO().save(tmp_path / "orbax", state, {"epoch": 2, "global_step": 16})

    spec = importlib.util.spec_from_file_location("torch_from_orbax", REPO_ROOT / "scripts" / "torch_from_orbax.py")
    script = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "torch_from_orbax", script)  # its config_main finds configs/ beside it
    spec.loader.exec_module(script)
    out = tmp_path / "port"
    script.main([f"ckpt_path={tmp_path / 'orbax'}", f"+out={out}", *AUX, *NET_OVERRIDES,
                 f"paths.log_dir={tmp_path}/logs", "extras.print_config=false"])
    meta = json.loads((out / "meta.json").read_text())
    assert (meta["epoch"], meta["global_step"], meta["weights_only_conversion"]) == (2, 16, True)
    task = load_task(compose(REPO_ROOT / "configs", "infer.yaml", [f"ckpt_path={out}", *AUX, *NET_OVERRIDES]))
    t = np.array([0.3, 0.6], np.float32)
    with torch.no_grad():
        vt, frac = task._forward(torch.from_numpy(t), torch.from_numpy(x))
    with jax.default_matmul_precision("highest"):
        jvt, jfrac = jtask._forward(variables, jnp.asarray(t), jnp.asarray(x), train=False)
    assert np.abs(vt.numpy() - np.asarray(jvt)).max() < TOL * max(1.0, float(np.abs(jvt).max()))
    np.testing.assert_allclose(frac.numpy(), np.asarray(jfrac), atol=TOL, rtol=0)
