"""The port's evaluation slice against the JAX package, on the CPU.

- Metrics: ``psnr``, ``ssim`` and ``fid_from_stats`` within 1e-5; the
  random-feature CNN with JAX's parameters injected within 1e-4 (its own
  weights come from numpy, under another name); both packages' Inception
  loaders on one converted npz (equal weights) and ``pool3_features``, both
  pooling variants, within 1e-4 of max|ref|; the resize to 299² when shrinking; the committed golden fixture
  at the tolerances of ``tests/test_inception.py``; ``evaluate_quality`` on
  the same weights and batches: SSIM and PSNR within 1e-4, FID with the same
  extractor weights within 1e-3 relative.
- The CLIs, in process, on a checkpoint the port's trainer writes
  (``experiment=smoke_synthetic trainer=cpu``): ``eval`` gives
  ``Trainer.test``'s metrics, ``eval_quality`` prints one JSON line with its
  keys, ``infer_simple_flowmatching`` and ``infer_wsi`` write their images.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops import inception as j_inception
from stain2stain_tpu.ops import metrics as j_metrics
from stain2stain_tpu.ops.solvers import SolverConfig as JaxSolverConfig
from stain2stain_tpu.tasks import ConditionalFlowMatchingModule as JaxCFM
from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
from stain2stain_tpu_torch.config import compose
from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.ops import inception, metrics
from stain2stain_tpu_torch.ops.solvers import SolverConfig
from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule
from stain2stain_tpu_torch.train import train

REPO_ROOT = Path(__file__).resolve().parent.parent
OP_TOL = 1e-5


def _images(seed: int, shape=(3, 32, 32, 3)) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    return a, np.clip(a + 0.1 * rng.standard_normal(shape).astype(np.float32), 0, 1)


@pytest.mark.parametrize("shape", [(3, 32, 32, 3), (2, 23, 40, 1)], ids=["rgb", "ragged_gray"])
def test_psnr_and_ssim_match_jax(shape):
    a, b = _images(0, shape)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)), float(j_metrics.psnr(a, b)), rtol=OP_TOL)
    np.testing.assert_allclose(float(metrics.ssim(ta, tb)), float(j_metrics.ssim(a, b)), atol=OP_TOL)
    assert float(metrics.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_fid_from_stats_matches_jax(rank_deficient):
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((5 if rank_deficient else 40, 8)) for _ in range(2)]
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in feats]
    args = (*stats[0], *stats[1])
    np.testing.assert_allclose(metrics.fid_from_stats(*args), j_metrics.fid_from_stats(*args), rtol=OP_TOL)


def test_random_cnn_matches_jax_with_its_weights():
    jax_ext = j_metrics.FeatureExtractor(kind="random", feature_dim=64)
    ext = metrics.FeatureExtractor(kind="random", feature_dim=64, device="cpu")
    x = _images(2, (2, 33, 20, 3))[0]
    ref = jax_ext(x)  # draws JAX's weights
    ext.random_params = [torch.from_numpy(np.array(w)) for w in jax_ext._random_params]
    got = ext(x)
    assert got.dtype == np.float64 and got.shape == ref.shape == (2, 64)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    # the port's own weights are numpy draws under another name
    assert ext.name == "random_cnn_np_64_seed0" != jax_ext.name
    own = metrics.FeatureExtractor(kind="random", feature_dim=64, device="cpu")
    np.testing.assert_array_equal(own(x), own(x))
    assert not np.allclose(own(x), ref)
    with pytest.raises(ValueError, match="unknown feature-extractor kind"):
        metrics.FeatureExtractor(kind="vgg", device="cpu")


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    """The converter's npz of the golden fixture's torch-layout state dict."""
    from scripts.convert_inception_weights import state_dict_to_npz
    from scripts.gen_inception_golden import fake_state_dict

    npz = str(tmp_path_factory.mktemp("inception") / "w.npz")
    state_dict_to_npz(fake_state_dict(), npz)
    return npz


@pytest.mark.parametrize("fid_variant", [True, False], ids=["fid", "stock"])
def test_pool3_features_match_jax(inception_npz, fid_variant):
    """Both packages' loaders (BN folded) on one npz, then pool3 features."""
    jax_params = j_inception.load_params(inception_npz)
    params = inception.load_params(inception_npz, device="cpu")
    for name, (w, b) in params.items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(jax_params[name][0]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jax_params[name][1]))
    x = _images(3, (2, 64, 64, 3))[0]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(j_inception.pool3_features, static_argnames="fid_variant")(
            jax_params, jnp.asarray(x), fid_variant=fid_variant))
    got = inception.pool3_features(params, torch.from_numpy(x), fid_variant=fid_variant).numpy()
    assert got.shape == (2, inception.FEATURE_DIM)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_init_params_has_the_architecture_shapes():
    params = inception.init_params(seed=0, device="cpu")
    assert {k: tuple(w.shape) for k, (w, _) in params.items()} == {
        k: (kh, kw, i, o) for k, (o, i, kh, kw) in j_inception.CONV_SPECS.items()}
    feats = inception.pool3_features(params, torch.rand(1, 32, 32, 3))
    assert feats.shape == (1, 2048) and torch.isfinite(feats).all()


def test_resize_when_shrinking_matches_jax():
    x = _images(4, (1, 320, 352, 3))[0]
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), "bilinear"))
    got = inception.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_golden_pool3_activations(inception_npz, monkeypatch, tmp_path):
    """``tests/fixtures/inception_golden.npz`` through the port: the converter's
    npz, the port's loader (BN folded) and forward, at the tolerances of
    ``tests/test_inception.py::test_golden_pool3_activations``; the extractor
    picks the weights up from ``S2S_INCEPTION_WEIGHTS``."""
    from scripts.gen_inception_golden import INPUT_SHAPE, SEED

    want = np.load(REPO_ROOT / "tests" / "fixtures" / "inception_golden.npz")
    x = torch.from_numpy(np.array(jax.random.uniform(jax.random.key(SEED), INPUT_SHAPE)))
    params = inception.load_params(inception_npz, device="cpu")
    monkeypatch.setenv("S2S_INCEPTION_WEIGHTS", inception_npz)
    ext = metrics.FeatureExtractor(kind="inception", device="cpu")
    assert ext.name == "inception_v3_fid" and set(params) == set(inception.CONV_SPECS)
    fid_feats = inception.pool3_features(params, x).numpy()
    stock = inception.pool3_features(params, x, fid_variant=False).numpy()
    np.testing.assert_allclose(fid_feats[:, :16], want["pool3_fid"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(stock[:, :16], want["pool3_stock"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(fid_feats, axis=1), want["pool3_fid_norm"], rtol=2e-3)
    np.testing.assert_allclose(ext(x.numpy()), fid_feats, rtol=1e-6, atol=1e-6)
    monkeypatch.setenv("S2S_INCEPTION_WEIGHTS", str(tmp_path / "missing.npz"))
    with pytest.raises(RuntimeError, match="unavailable"):
        metrics.FeatureExtractor(kind="inception", device="cpu")
    assert metrics.FeatureExtractor(device="cpu").name.startswith("random_cnn_np_")


def test_evaluate_quality_matches_jax():
    size, tiny = 16, dict(num_channels=16, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="8",
                          num_head_channels=8)
    jnet = JaxUNet(dim=(3, size, size), fused_attention=False, dtype=jnp.float32, **tiny)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((2,), jnp.float32), jnp.zeros((2, size, size, 3)))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params["params"])
    tnet = UNetModel(dim=(3, size, size), device="cpu", **tiny)
    tnet.load_state_dict(unet_state_dict_from_flax(params, image_size=size, **tiny), strict=True)
    loader = [tuple(rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8) for _ in range(2)) for n in (4, 3)]
    jax_ext = j_metrics.FeatureExtractor(kind="random", feature_dim=4)
    jax_ext(np.zeros((1, size, size, 3), np.float32))  # draws its weights
    ext = metrics.FeatureExtractor(kind="random", feature_dim=4, device="cpu")
    ext.random_params = [torch.from_numpy(np.array(w)) for w in jax_ext._random_params]
    with jax.default_matmul_precision("highest"):
        ref = j_metrics.evaluate_quality(JaxCFM(net=jnet, solver=JaxSolverConfig("euler")), {"params": params},
                                         loader, num_steps=2, extractor=jax_ext)
    got = metrics.evaluate_quality(ConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("euler")),
                                   loader, num_steps=2, extractor=ext)
    assert set(got) == set(ref) == {"ssim", "psnr", "fid", "fid_extractor", "fid_comparable"}
    np.testing.assert_allclose(got["ssim"], ref["ssim"], atol=1e-4)
    np.testing.assert_allclose(got["psnr"], ref["psnr"], atol=1e-4)
    np.testing.assert_allclose(got["fid"], ref["fid"], rtol=1e-3)
    assert got["fid_comparable"] is False and got["fid_extractor"] == "random_cnn_np_4_seed0"
    with pytest.raises(ValueError, match="no batches"):
        metrics.evaluate_quality(ConditionalFlowMatchingModule(net=tnet), loader, max_batches=0, extractor=ext)


# ------------------------------------------------------------------- CLIs

NET = ["model.net.dim=[3,32,32]", "model.net.num_channels=8", "model.net.num_res_blocks=1",
       "model.net.channel_mult=[1,2]", "model.net.attention_resolutions=''", "model.net.num_heads=1",
       "model.net.dropout=0.0", "model.solver.solver=euler"]


@pytest.fixture(scope="module")
def smoke_ckpt(tmp_path_factory):
    """The port's trainer on ``experiment=smoke_synthetic`` (CPU): its best
    checkpoint, its data directory and its test metrics."""
    tmp = tmp_path_factory.mktemp("eval_smoke")
    data = tmp / "synthetic"
    cfg = compose(REPO_ROOT / "configs", "train.yaml",
                  ["experiment=smoke_synthetic", "trainer=cpu", f"data.data_dir={data}", "logger=csv"])
    (tmp / "out").mkdir()
    cfg["runtime"] = {"output_dir": str(tmp / "out"), "cwd": str(tmp)}
    cfg["extras"]["print_config"] = False
    cfg["extras"]["enforce_tags"] = False
    metrics_, objects = train(cfg)
    return tmp, data, objects["trainer"].checkpoint_callback.best_model_path, metrics_


def test_eval_cli_gives_the_test_metrics(smoke_ckpt, monkeypatch):
    from stain2stain_tpu_torch import eval as eval_cli

    tmp, data, best, train_metrics = smoke_ckpt
    monkeypatch.setenv("PROJECT_ROOT", str(tmp))
    got = eval_cli.main(["data=synthetic", f"data.data_dir={data}", "trainer=cpu", f"ckpt_path={best}",
                         "extras.print_config=false", *NET])
    assert got == {"test/loss": train_metrics["test/loss"]}
    with pytest.raises(ValueError, match="ckpt_path is required"):
        eval_cli.main(["data=synthetic", f"data.data_dir={data}", "trainer=cpu", "extras.print_config=false", *NET])


def test_eval_quality_cli_prints_one_json_line(smoke_ckpt, monkeypatch, capsys):
    from stain2stain_tpu_torch import eval_quality

    tmp, data, best, _ = smoke_ckpt
    monkeypatch.setenv("PROJECT_ROOT", str(tmp))
    capsys.readouterr()
    got = eval_quality.main(["data=synthetic", f"data.data_dir={data}", "device=cpu", f"ckpt_path={best}",
                             "num_steps=2", "n_batches=1", *NET])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == got
    assert set(got) == {"ssim", "psnr", "fid", "fid_extractor", "fid_comparable"}
    assert got["fid_comparable"] is False and -1.0 <= got["ssim"] <= 1.0 and np.isfinite(got["fid"])


def test_infer_clis_write_panels_and_the_translated_image(smoke_ckpt, monkeypatch):
    from stain2stain_tpu_torch import infer_simple_flowmatching, infer_wsi

    tmp, data, best, _ = smoke_ckpt
    monkeypatch.setenv("PROJECT_ROOT", str(tmp))
    common = ["device=cpu", f"ckpt_path={best}", "num_steps=2", *NET]
    panels = infer_simple_flowmatching.main(["data=synthetic", f"data.data_dir={data}", "n_images=3", *common])
    files = sorted(panels.iterdir())
    assert [f.name for f in files] == [f"sample_{i:05d}.png" for i in range(3)]
    assert np.asarray(Image.open(files[0])).shape == (32, 3 * 32, 3)  # source | generated | target

    img = np.random.default_rng(6).integers(0, 256, (45, 70, 3), dtype=np.uint8)
    np.save(tmp / "slide.npy", img)
    out = infer_wsi.main([f"input={tmp / 'slide.npy'}", f"output={tmp / 'slide_out.png'}", "tile=32",
                          "overlap=8", "wsi_batch=2", *common])
    translated = np.asarray(Image.open(out))
    assert out == str(tmp / "slide_out.png") and translated.shape == img.shape
    # the same translation through the library: the tiled generator of the same task
    from stain2stain_tpu_torch.inference import load_task
    from stain2stain_tpu_torch.ops.image import denormalize_np, normalize_uint8_np
    from stain2stain_tpu_torch.wsi import make_tiled_generator, translate_large_image

    cfg = compose(REPO_ROOT / "configs", "infer.yaml", common)
    want = denormalize_np(translate_large_image(make_tiled_generator(load_task(cfg), num_steps=2),
                                                normalize_uint8_np(img), tile=32, overlap=8, batch_size=2))
    np.testing.assert_array_equal(translated, (want * 255).astype(np.uint8))


def test_load_state_reads_checkpoint_directories_and_files(smoke_ckpt, tmp_path):
    from stain2stain_tpu_torch.inference import load_state

    _, _, best, _ = smoke_ckpt
    sd, meta = load_state(best)
    assert meta["global_step"] > 0 and "input_blocks.0.0.weight" in sd
    torch.save({"state_dict": {f"net.{k}": v for k, v in sd.items()}}, tmp_path / "last.ckpt")
    again, none = load_state(str(tmp_path / "last.ckpt"))
    assert none == {} and all(torch.equal(again[k], v) for k, v in sd.items())
    with pytest.raises(FileNotFoundError):
        load_state(str(tmp_path))
    net = UNetModel(dim=(3, 32, 32), device="cpu", num_channels=8, num_res_blocks=1, channel_mult=(1, 2),
                    attention_resolutions="", num_heads=1)
    net.load_state_dict(sd, strict=True)  # the smoke net's weights, whole
