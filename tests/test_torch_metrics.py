"""The quality metrics (PSNR, SSIM, FID's statistics, InceptionV3's
features and its resize) against the JAX package on the CPU, the weight
loaders against JAX's converter, and the CLI's ``--val_metrics``.

InceptionV3 is held at 75x75 without the resize (its smallest input; the
JAX network is compiled once), with a synthetic state dict in
pytorch-FID's names: kernels N(0, 2 / fan_in) so the features neither
vanish nor blow up through the ReLU tower, BatchNorm statistics near (0, 1).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flaxdiff_tpu.metrics import common as jcommon
from flaxdiff_tpu.metrics import fid as jfid
from flaxdiff_tpu.metrics import image_quality as jiq
from flaxdiff_tpu.metrics import inception as jinc
from flaxdiff_tpu.utils import fill_params_by_path
from flaxdiff_tpu.utils import to_unit_float as jax_to_unit_float
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch import convert, train
from flaxdiff_tpu_torch.metrics import (FeatureStats, FIDComputer, InceptionV3Features,
                                        MetricTracker, frechet_distance, get_fid_metric,
                                        get_psnr_metric, get_ssim_metric, load_inception_params,
                                        make_inception_extractor, psnr, resize_bilinear,
                                        resize_weights, ssim)
from flaxdiff_tpu_torch.utils import to_unit_float

# f32 on both sides: convolutions and reductions summed in another order
METRIC_TOL = 1e-5
FEATURE_TOL = 1e-4   # of max|ref|, through ~95 convolutions


def _images(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


# --- PSNR and SSIM ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 16, 16, 3), (2, 2, 13, 12, 2)], ids=["4d", "5d"])
@pytest.mark.parametrize("data_range", [2.0, 1.0])
def test_psnr_and_ssim_match_jax(shape, data_range):
    """A batch of images (a video batch flattened over frames) and a noisy
    copy of it; SSIM's 11x11 window, VALID, over 16 and 13 x 12 images."""
    lo = -1.0 if data_range == 2.0 else 0.0
    target = _images(shape, 1, lo)
    pred = np.clip(target + 0.2 * _images(shape, 2), lo, 1.0)
    for port_fn, jax_fn in ((psnr, jiq.psnr), (ssim, jiq.ssim)):
        out = float(port_fn(torch.from_numpy(pred), torch.from_numpy(target), data_range))
        ref = float(jax_fn(jnp.asarray(pred), jnp.asarray(target), data_range))
        assert out == pytest.approx(ref, rel=METRIC_TOL, abs=METRIC_TOL), port_fn.__name__
    with pytest.raises(ValueError, match="smaller than"):
        ssim(torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 3))


def test_paired_metrics_match_jax():
    """The EvaluationMetric factories: [-1, 1] samples against a uint8
    batch of another size (paired on the shorter), as JAX scores them."""
    samples = _images((4, 16, 16, 3), 3)
    batch = {"sample": np.random.default_rng(4).integers(0, 256, (3, 16, 16, 3), np.uint8)}
    for port, ref in ((get_psnr_metric("cpu"), jiq.get_psnr_metric()),
                      (get_ssim_metric("cpu"), jiq.get_ssim_metric())):
        assert (port.name, port.higher_is_better) == (ref.name, ref.higher_is_better)
        assert port.function(samples, batch) == pytest.approx(
            ref.function(samples, batch), rel=METRIC_TOL, abs=METRIC_TOL)
        with pytest.raises(ValueError, match="paired batch"):
            port.function(samples, None)


@pytest.mark.parametrize("kind", ["uint8", "minus_one_one", "unit", "255_float"])
def test_to_unit_float_matches_jax(kind):
    rng = np.random.default_rng(5)
    images = {"uint8": rng.integers(0, 256, (2, 4, 4, 3), np.uint8),
              "minus_one_one": rng.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32),
              "unit": rng.uniform(0, 1, (2, 4, 4, 3)).astype(np.float32),
              "255_float": rng.uniform(0, 255, (2, 4, 4, 3)).astype(np.float32)}[kind]
    np.testing.assert_array_equal(to_unit_float(images), jax_to_unit_float(images))


def test_metric_tracker_matches_jax():
    port, ref = MetricTracker(), jcommon.MetricTracker()
    for name, value, hib in (("psnr", 20.0, True), ("psnr", 19.0, True), ("psnr", 21.0, True),
                             ("fid", 50.0, False), ("fid", 60.0, False), ("fid", 40.0, False)):
        assert port.update(name, value, hib) == ref.update(name, value, hib)
        assert port.is_best(name, value + 1) == ref.is_best(name, value + 1)
    assert port.best == ref.best and port.directions == ref.directions


# --- FID's statistics -----------------------------------------------------------------

def test_feature_stats_and_frechet_distance_match_jax():
    """Statistics streamed in uneven chunks (f64 on both sides, the same
    numpy ops: bit-equal), and the distance of full-rank covariances and of
    rank-deficient ones (fewer samples than features: sqrtm's product is
    singular and may take the regularised retry)."""
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((n, 16)) * s for n, s in ((7, 1.0), (20, 2.0), (13, 0.5))]
    port, ref = FeatureStats(), jfid.FeatureStats()
    for f in feats:
        port.update(torch.from_numpy(f))
        ref.update(f)
    assert port.n == ref.n == 40
    np.testing.assert_array_equal(port.mean, ref.mean)
    np.testing.assert_array_equal(port.cov, ref.cov)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        port.update(np.zeros(3))
    other = rng.standard_normal((40, 16)) + 0.3
    for a, b in ((np.concatenate(feats), other), (feats[0], other[:5])):
        args = (a.mean(0), np.cov(a.T), b.mean(0), np.cov(b.T))
        out, expect = frechet_distance(*args), jfid.frechet_distance(*args)
        assert np.isfinite(out) and out == pytest.approx(expect, rel=1e-10, abs=1e-10)


def test_fid_metric_accumulates_real_and_resets_generated():
    """get_fid_metric with a fixed host extractor (a projection of each
    image to 12 features) over two validation calls: the real side's
    statistics accumulate, the generated side's restart; the values equal
    JAX's."""
    proj = np.random.default_rng(7).standard_normal((8 * 8 * 3, 12))
    extractor = lambda images: np.asarray(images, np.float64).reshape(len(images), -1) @ proj
    port = get_fid_metric(extractor=extractor, batch_size=5)
    ref = jfid.get_fid_metric(extractor=extractor, batch_size=5)
    assert (port.name, port.higher_is_better) == ("fid", False)
    for seed in (8, 9):
        rng = np.random.default_rng(seed)
        batch = {"sample": rng.integers(0, 256, (14, 8, 8, 3), np.uint8)}
        samples = rng.uniform(-1, 1, (13, 8, 8, 3)).astype(np.float32)
        assert port.function(samples, batch) == pytest.approx(ref.function(samples, batch),
                                                              rel=1e-10)
    computer = FIDComputer(extractor, batch_size=5)
    with pytest.raises(ValueError, match=">=2 samples"):
        computer.compute()
    with pytest.raises(ValueError, match="real images"):
        port.function(samples, {})


# --- InceptionV3 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def fid_state():
    """A synthetic state dict in pytorch-FID's names: every weight of the
    pool3 path, plus the classifier head and BatchNorm counters it also
    holds."""
    rng = np.random.default_rng(10)
    state = {}
    for name, t in InceptionV3Features(resize_input=False, device="cpu").state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("conv.weight"):
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("running_var"):
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif name.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        state[name] = a.astype(np.float32)
        if name.endswith("running_var"):
            state[name.replace("running_var", "num_batches_tracked")] = np.array(0)
    state["fc.weight"] = np.zeros((1008, 2048), np.float32)
    state["fc.bias"] = np.zeros((1008,), np.float32)
    return state


@pytest.fixture(scope="module")
def jax_inception(fid_state):
    """The JAX module's variables from the same dict through JAX's own
    converter and path loader (shapes traced, never computed)."""
    jm = jinc.InceptionV3Features(resize_input=False)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3)))
    variables = fill_params_by_path(template, jinc.convert_torch_state_dict(fid_state))
    return jm, variables


def test_inception_features_match_jax(fid_state, jax_inception):
    """pool3 features of 2 images at 75x75, the same weights loaded by name
    on both sides, within 1e-4 of max|ref|."""
    jm, variables = jax_inception
    x = _images((2, 75, 75, 3), 11, lo=0.0)
    ref = np.asarray(jax.jit(jm.apply)(variables, x))
    model = InceptionV3Features(resize_input=False, device="cpu").load_torch_state_dict(
        fid_state)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 2048) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=FEATURE_TOL * np.abs(ref).max())


def test_inception_loaders_agree_with_jax_converter(fid_state, jax_inception, tmp_path):
    """pytorch-FID's dict loaded directly, as a .pth, and as the flax-path
    npz of scripts/convert_inception_weights.py (JAX's converter): the same
    weights; convert.inception_state_dict_from_flax inverts JAX's layout.
    A missing or misshapen weight raises."""
    _, variables = jax_inception
    model = InceptionV3Features(device="cpu")
    state = lambda: {k: v.clone() for k, v in model.state_dict().items()}
    drawn = state()
    model.load_torch_state_dict(fid_state)
    direct = state()
    from_flax = convert.inception_state_dict_from_flax(jax.device_get(variables))
    assert from_flax.keys() == direct.keys()
    np.savez(tmp_path / "flax.npz", **jinc.convert_torch_state_dict(fid_state))
    torch.save({k: torch.as_tensor(v) for k, v in fid_state.items()}, tmp_path / "fid.pth")
    loaded = [from_flax]
    for path in ("flax.npz", "fid.pth"):
        model.load_state_dict(drawn)
        load_inception_params(model, str(tmp_path / path))
        loaded.append(state())
    for got in loaded:
        for name, value in direct.items():
            assert torch.equal(got[name], value), name
    short = {k: v for k, v in fid_state.items() if k != "Mixed_6c.branch1x1.bn.bias"}
    with pytest.raises(ValueError, match="missing"):
        model.load_torch_state_dict(short)
    bad = dict(fid_state, **{"Mixed_6c.branch1x1.bn.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="mismatched"):
        model.load_torch_state_dict(bad)


@pytest.mark.parametrize("in_hw,out_hw", [((20, 24), (29, 31)), ((60, 31), (29, 31))],
                         ids=["grow", "shrink_one_axis"])
def test_resize_matches_jax_bilinear(in_hw, out_hw):
    """jax.image.resize(..., "bilinear") growing (plain interpolation) and
    shrinking (the antialiasing triangle, renormalised at the edges) with
    the other axis already at its size: the weights and the result."""
    x = _images((2,) + in_hw + (3,), 12, lo=0.0)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + out_hw + (3,), "bilinear"))
    out = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=METRIC_TOL)
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat
    for n_in, n_out in zip(in_hw, out_hw):
        if n_in != n_out:
            jw = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                               _fill_triangle_kernel, True))
            np.testing.assert_allclose(resize_weights(n_in, n_out), jw, rtol=0, atol=1e-7)


def test_inception_extractor_takes_uint8_and_video():
    """uint8 is divided by 255 and a video's frames are samples, as JAX's
    extractor does; the seeded weights are the same from call to call."""
    clip = np.random.default_rng(13).integers(0, 256, (1, 2, 16, 16, 3), np.uint8)
    extractor = make_inception_extractor(seed=3, device="cpu")
    feats = extractor(clip)
    assert feats.shape == (2, 2048) and bool(torch.isfinite(feats).all())
    assert torch.equal(feats, extractor(clip.reshape(2, 16, 16, 3).astype(np.float32) / 255.0))
    redrawn = InceptionV3Features(seed=3, device="cpu").state_dict()
    assert all(torch.equal(v, redrawn[k]) for k, v in extractor.model.state_dict().items())


# --- validation and the CLI -----------------------------------------------------------

def test_cli_val_metrics_psnr_ssim_fid(tmp_path, capsys):
    """--val_metrics psnr,ssim,fid: a validation grid after step 2 scored
    against the batch the next chunk trains on, logged as val/<name>,
    finite; FID through seeded random Inception features on the CPU."""
    model = dict(emb_features=16, feature_depths=[8, 16], num_res_blocks=1, norm_groups=4,
                 attention_configs=[None, None])
    argv = ["--device", "cpu", "--image_size", "16", "--batch_size", "4", "--dtype", "float32",
            "--model_config", json.dumps(model), "--text_encoder", "none", "--total_steps", "4",
            "--warmup_steps", "2", "--save_every", "4", "--log_every", "2", "--checkpoint_dir",
            str(tmp_path), "--val_every", "2", "--val_samples", "2", "--val_steps", "2",
            "--val_metrics", "psnr,ssim,fid"]
    hist = train.main(argv)
    (val,) = hist["validation"]
    assert set(val["metrics"]) == {"psnr", "ssim", "fid"}
    assert all(np.isfinite(v) for v in val["metrics"].values())
    logged = [json.loads(line) for line in capsys.readouterr().out.splitlines()
              if line.startswith("{") and "val/wall_s" in line]
    assert [set(k for k in row if k.startswith("val/")) for row in logged] == [
        {"val/wall_s", "val/psnr", "val/ssim", "val/fid"}]


@pytest.mark.parametrize("name,match", [("clip", "CLIP's published weights"),
                                        ("clip_score", "CLIP's published weights"),
                                        ("lpips", "unknown --val_metrics entry")])
def test_cli_refuses_the_clip_metrics_and_unknown_names(tmp_path, name, match):
    with pytest.raises(SystemExit, match=match):
        train.make_run(["--device", "cpu", "--checkpoint_dir", str(tmp_path), "--val_every", "2",
                        "--val_metrics", f"psnr,{name}"])
