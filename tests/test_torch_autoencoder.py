"""The port's latent diffusion (``flaxdiff_tpu_torch/models/autoencoder.py``,
``sd_vae.py``, the codec in the train step, the sampler, the pipeline and the
CLI) against the JAX package, on the CPU in f32.

Codecs: the KL VAE with seeded numpy leaves (its GroupNorm + SiLU through the
JAX package's interpreted Pallas kernels, ``FLAXDIFF_FUSED_NORM=interpret``,
where a test says so) and the SD VAE loaded in both packages from one diffusers-named state dict
(``tests/test_sd_vae.py``'s torch twin). The posterior's noise is the JAX
codec's own draw, ``jax.random.normal(key, mean.shape)``, handed to the port.
"""
import json

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models.autoencoder import KLAutoEncoder as JaxKL
from flaxdiff_tpu.models.sd_vae import SDVAE as JaxSDVAE
from flaxdiff_tpu.models.sd_vae import convert_sd_vae_torch_state_dict as jax_convert_sd
from flaxdiff_tpu.models.unet import Unet as JaxUnet
from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
from flaxdiff_tpu.samplers import DDIMSampler as JaxDDIM
from flaxdiff_tpu.samplers import DiffusionSampler as JaxSampler
from flaxdiff_tpu.schedulers import CosineNoiseSchedule as JaxCosine
from flaxdiff_tpu.trainer.train_step import TrainStepConfig as JaxStepConfig
from flaxdiff_tpu.trainer.train_step import _make_loss_builder as jax_loss_builder
from test_sd_vae import GROUPS, TVAE
from test_torch_dit import _env
from test_torch_train import assert_close_to_max
from test_torch_unet import START, randomize, one_torch_thread  # noqa: F401 (autouse)
from test_torch_unet import TINY as UNET_TINY

from flaxdiff_tpu_torch import convert, train
from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
from flaxdiff_tpu_torch.models import SDVAE, KLAutoEncoder, Unet, build_autoencoder
from flaxdiff_tpu_torch.models.autoencoder import gaussian_sample, kl_divergence
from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
from flaxdiff_tpu_torch.trainer import TrainStepConfig, make_loss_builder

# codecs a few convolutions deep, f32 on both sides: 1e-4 of max(1, max|ref|)
CODEC_TOL = 1e-4
KL = dict(latent_channels=2, block_channels=(8, 16), layers_per_block=1, norm_groups=4,
          scaling_factor=0.5)


class StepState(NamedTuple):
    """What the JAX loss builder reads of a train state (its key, step and
    params): a full TrainState would compile adamw's init leaf by leaf."""
    rng: jax.Array
    step: int
    params: dict


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, tol=CODEC_TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def kl_pair():
    """The JAX KL VAE with seeded leaves and the port's with the same."""
    shapes = jax.eval_shape(lambda k: JaxKL.create(k, image_size=16, **KL).params,
                            jax.random.PRNGKey(0))
    params = randomize(shapes, 4)
    return JaxKL(params, **KL), KLAutoEncoder(**KL, device="cpu").load_flax_params(params)


def _diffusers_state(legacy: bool):
    """The torch twin's diffusers-named state dict, with the CompVis-era
    attention names (query/key/value/proj_attn, 1x1-conv weights) if `legacy`."""
    torch.manual_seed(7)
    state = {}
    for k, v in TVAE().state_dict().items():
        if legacy:
            for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                             ("to_out.0", "proj_attn")):
                if f".{new}." in k:
                    k = k.replace(f".{new}.", f".{old}.")
                    v = v[:, :, None, None] if v.ndim == 2 else v
                    break
        state[k] = v
    return state


@pytest.fixture(scope="module")
def sd_pair():
    state = _diffusers_state(False)
    jvae = JaxSDVAE.from_torch_state_dict({k: v.numpy() for k, v in state.items()},
                                          norm_groups=GROUPS, scaling_factor=0.5)
    return jvae, SDVAE.from_torch_state_dict(state, norm_groups=GROUPS, scaling_factor=0.5,
                                             device="cpu")


@pytest.mark.parametrize("legacy", [False, True], ids=["modern", "legacy"])
def test_sd_vae_takes_diffusers_state_dicts_like_the_jax_converter(sd_pair, legacy, tmp_path):
    """Both attention namings load into exactly the weights the JAX
    converter gives (its tree converted name for name), with the
    architecture inferred from the shapes; the flax-path npz the conversion
    script writes loads the same."""
    jvae, _ = sd_pair
    state = _diffusers_state(legacy)
    port = SDVAE.from_torch_state_dict(state, norm_groups=GROUPS, scaling_factor=0.5,
                                       device="cpu")
    assert port.serialize() == jvae.serialize()
    ref = convert.state_dict_from_flax(port.net, jvae.params)
    got = port.net.state_dict()
    assert got.keys() == ref.keys()
    for name, value in ref.items():
        assert torch.equal(got[name], value), name
    flat = jax_convert_sd({k: v.numpy() for k, v in state.items()})
    np.savez(tmp_path / "vae.npz", **flat)
    npz = SDVAE.from_npz(str(tmp_path / "vae.npz"), norm_groups=GROUPS, device="cpu")
    assert all(torch.equal(npz.net.state_dict()[n], v) for n, v in ref.items())
    with pytest.raises(ValueError, match="unmapped"):
        SDVAE.from_torch_state_dict({"encoder.conv_in.running_gizmo": np.zeros(3)},
                                    device="cpu")


# a clip folds to its codec's image batch, so the JAX codec's jitted
# programs compile once for both
CODEC_CASES = [("kl_vae", (2, 16, 16, 3)), ("kl_vae", (1, 2, 16, 16, 3)),
               ("sd_vae", (2, 32, 32, 3)), ("sd_vae", (1, 2, 32, 32, 3))]


@pytest.mark.parametrize("codec,shape", CODEC_CASES,
                         ids=[f"{c}-{len(s)}d" for c, s in CODEC_CASES])
def test_codec_encode_decode_match_jax(kl_pair, sd_pair, codec, shape):
    """encode's posterior mean, encode with the JAX codec's own noise draw,
    and decode, for images and clips (frames folded through the codec),
    each within 1e-4 of max(1, max|ref|); the scaling factor applies. The
    KL VAE runs the JAX package's interpreted GroupNorm kernels (traced for
    its images, whose programs its clips reuse)."""
    jvae, port = kl_pair if codec == "kl_vae" else sd_pair
    x = _x(shape, 1)
    key = jax.random.PRNGKey(9)
    interpret = "interpret" if codec == "kl_vae" and len(shape) == 4 else None
    with _env("FLAXDIFF_FUSED_NORM", interpret):
        ref_mean = np.asarray(jvae.encode(jnp.asarray(x)))
        ref_sample = np.asarray(jvae.encode(jnp.asarray(x), key=key))
        ref_dec = np.asarray(jvae.decode(jnp.asarray(ref_mean)))
    # the JAX codec's draw: normal(key, mean.shape) over the folded frames
    folded = (int(np.prod(ref_mean.shape[:-3])), *ref_mean.shape[-3:])
    noise = np.array(jax.random.normal(key, folded))
    with torch.no_grad():
        _close(port.encode(torch.from_numpy(x)), ref_mean)
        _close(port.encode(torch.from_numpy(x), torch.from_numpy(noise)), ref_sample)
        _close(port.decode(torch.from_numpy(ref_mean)), ref_dec)
    assert np.abs(ref_sample - ref_mean).max() > 1e-3, "the noise moved nothing"
    assert port.downscale_factor == jvae.downscale_factor
    assert port.latent_channels == jvae.latent_channels


def test_gaussian_sample_and_kl_match_jax():
    """The posterior sample clips logvar to [-30, 20]; the KL term per sample."""
    from flaxdiff_tpu.models.autoencoder import gaussian_sample as jax_sample
    from flaxdiff_tpu.models.autoencoder import kl_divergence as jax_kl
    moments = _x((2, 4, 4, 6), 2) * np.array([1, 1, 1, 40, -40, 1], np.float32)
    key = jax.random.PRNGKey(1)
    noise = np.array(jax.random.normal(key, (2, 4, 4, 3)))
    _close(gaussian_sample(torch.from_numpy(moments), torch.from_numpy(noise)),
           jax_sample(jnp.asarray(moments), key), 1e-5)
    _close(kl_divergence(torch.from_numpy(moments)), jax_kl(jnp.asarray(moments)), 1e-5)


def test_registry_builds_each_codec_and_refuses_stable_diffusion():
    vae = build_autoencoder("sd_vae", seed=1, block_out_channels=(8, 8), norm_groups=4,
                            layers_per_block=1, device="cpu")
    clip = torch.zeros(2, 3, 16, 16, 3)
    z = vae.encode(clip)
    assert z.shape == (2, 3, 8, 8, 4) and vae.decode(z).shape == clip.shape
    again = build_autoencoder("sd_vae", seed=1, block_out_channels=(8, 8), norm_groups=4,
                              layers_per_block=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(vae.net.parameters(), again.net.parameters()))
    assert not any(p.requires_grad for p in vae.net.parameters())
    # diffusers' names, and back
    names = vae.diffusers_state_dict()
    assert "encoder.down_blocks.0.resnets.0.conv1.weight" in names
    assert "decoder.mid_block.attentions.0.to_out.0.weight" in names
    back = SDVAE.from_torch_state_dict(names, norm_groups=4, device="cpu")
    assert back.serialize() == vae.serialize()
    assert all(torch.equal(back.net.state_dict()[k], v) for k, v in vae.net.state_dict().items())
    assert torch.equal(build_autoencoder("identity", channels=3, device="cpu").encode(clip), clip)
    with pytest.raises(NotImplementedError, match="A9's rest"):
        build_autoencoder("stable_diffusion")


# --- the latent train step, trajectory, pipeline and CLI ---------------------------

# tests/test_torch_unet.py's tiny UNet with one res block a level (a smaller
# program for XLA to compile) on the KL VAE's latents
LATENT_UNET = dict(UNET_TINY, num_res_blocks=1, output_channels=KL["latent_channels"])
BATCH, RES, CTX_LEN, CTX_DIM = 3, 16, 7, 12


@pytest.fixture(scope="module")
def latent_unet():
    jm = JaxUnet(**LATENT_UNET)
    lat = (1, RES // 2, RES // 2, KL["latent_channels"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), np.zeros(lat, np.float32),
                            np.zeros((1,), np.float32), np.zeros((1, CTX_LEN, CTX_DIM), np.float32))
    params = randomize(shapes["params"], 13)
    freqs = np.array(jax.random.normal(jax.random.PRNGKey(42), (16,)) * 16.0)
    tm = Unet(**LATENT_UNET, in_channels=KL["latent_channels"], context_dim=CTX_DIM,
              device="cpu")
    tm.load_flax_params(params, freqs)
    return jm, params, tm


def test_latent_train_step_matches_jax(kl_pair, latent_unet):
    """uint8 images normalized, encoded by the frozen KL VAE (the posterior
    sampled with the JAX step's ``vae_key`` draw), then diffused in the
    latent: the loss within 1e-5 relative and every gradient within 1e-4 of
    its max|g|; no gradient reaches the codec."""
    jvae, port_vae = kl_pair
    jm, params, tm = latent_unet
    apply_fn = lambda p, x, t, c: jm.apply({"params": p}, x, t, c)
    rng = np.random.default_rng(14)
    batch = {"sample": rng.integers(0, 256, (BATCH, RES, RES, 3), dtype=np.uint8),
             "cond": rng.standard_normal((BATCH, CTX_LEN, CTX_DIM)).astype(np.float32)}
    null = np.zeros((1, CTX_LEN, CTX_DIM), np.float32)
    schedule = JaxCosine(timesteps=1000)
    cfg = JaxStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=True, weighted_loss=True)
    jstate = StepState(jax.random.PRNGKey(18), 0, params)
    build = jax_loss_builder(apply_fn, schedule, JaxEps(), cfg, None, jvae, null)
    lat = (BATCH, RES // 2, RES // 2, KL["latent_channels"])

    def draws_of(st):
        """The JAX step's draws (train_step.py:53-84), the fourth key the codec's."""
        key = jax.random.fold_in(st.rng, st.step)
        noise_key, t_key, uncond_key, vae_key = jax.random.split(key, 4)
        return (jax.random.normal(noise_key, lat), schedule.sample_timesteps(t_key, BATCH),
                jax.random.bernoulli(uncond_key, 0.12, (BATCH,)), jax.random.normal(vae_key, lat))

    # the draws in the same program as the step: one compile, not one per draw
    ref_loss, ref_grads, draws = jax.jit(lambda st, b: (
        *jax.value_and_grad(build(st, b))(st.params), draws_of(st)))(jstate, batch)
    port_build = make_loss_builder(CosineNoiseSchedule(1000), EpsilonPredictionTransform(),
                                   TrainStepConfig(uncond_prob=0.12),
                                   null_cond=torch.from_numpy(null), autoencoder=port_vae)
    loss = port_build({k: torch.from_numpy(v) for k, v in batch.items()},
                      *(torch.from_numpy(np.array(d)) for d in draws))(tm)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    grads = dict(zip([n for n, _ in tm.named_parameters()],
                     torch.autograd.grad(loss, list(tm.parameters()))))
    ref = {k: v.numpy() for k, v in convert.state_dict_from_flax(tm, ref_grads).items()}
    gmax = max(np.abs(r).max() for r in ref.values())
    for name, g in grads.items():
        if name.endswith("to_k.bias"):
            # zero by the math: both sides hold f32 rounding
            assert max(np.abs(g.numpy()).max(), np.abs(ref[name]).max()) <= 1e-6 * gmax, name
            continue
        assert_close_to_max(g.numpy(), ref[name], 1e-4, f"grad {name}")


def test_latent_ddim_cfg_trajectory_decoded_matches_jax(kl_pair, latent_unet):
    """4 DDIM steps with CFG 3.0 in the KL VAE's latent from t = 333, then
    decoded to 16 x 16 x 3, against ``DiffusionSampler(autoencoder=...)``
    within 1e-3 (the trajectory's tolerance, tests/test_torch_unet.py)."""
    jvae, port_vae = kl_pair
    jm, params, tm = latent_unet
    rng = np.random.default_rng(15)
    x_init = rng.standard_normal((2, RES // 2, RES // 2, KL["latent_channels"])).astype(
        np.float32)
    ctx = rng.standard_normal((2, CTX_LEN, CTX_DIM)).astype(np.float32)
    uncond = np.zeros_like(ctx)
    engine = JaxSampler(model_fn=lambda p, x, t, c: jm.apply({"params": p}, x, t, c),
                        schedule=JaxCosine(timesteps=1000), transform=JaxEps(),
                        sampler=JaxDDIM(), guidance_scale=3.0, autoencoder=jvae)
    ref = np.asarray(engine.generate_samples(
        params, num_samples=2, resolution=RES, diffusion_steps=4, conditioning=ctx,
        unconditional=uncond, init_samples=jnp.asarray(x_init), start_step=START))
    sampler = DiffusionSampler(lambda x, t, c: tm(x, t, c), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(), DDIMSampler(), guidance_scale=3.0,
                               device="cpu", autoencoder=port_vae)
    out = sampler.generate_samples(num_samples=2, resolution=RES, diffusion_steps=4,
                                   init_samples=torch.from_numpy(x_init),
                                   conditioning=torch.from_numpy(ctx),
                                   unconditional=torch.from_numpy(uncond), start_step=START)
    assert ref.shape == (2, RES, RES, 3) and (np.abs(ref) >= 1.0).mean() < 0.5
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=1e-3)


def _cli(ckpt_dir, *extra):
    model = dict(emb_features=32, feature_depths=[16, 32],
                 attention_configs=[None, {"heads": 2, "dim_head": 8}], num_res_blocks=1,
                 norm_groups=4)
    codec = dict(KL, seed=3)
    return ["--dataset", "synthetic", "--text_encoder", "hash", "--image_size", "16",
            "--batch_size", "4", "--model_config", json.dumps(model), "--dtype", "float32",
            "--lr", "1e-3", "--warmup_steps", "2", "--total_steps", "2", "--save_every", "2",
            "--log_every", "2", "--checkpoint_dir", str(ckpt_dir), "--device", "cpu",
            "--seed", "1", "--autoencoder", "kl_vae", "--autoencoder_opts", json.dumps(codec),
            *extra]


def test_cli_trains_a_latent_model_and_the_pipeline_serves_it(tmp_path, capsys):
    """``--autoencoder kl_vae`` trains the UNet on the codec's 8 x 8 x 2
    latents (its output channels the latent's), records the codec in
    pipeline_config.json as the JAX CLI does, and
    ``from_checkpoint(autoencoder=...)`` serves prompts decoded to 16 x 16."""
    hist = train.main(_cli(tmp_path))
    assert "latent diffusion via kl_vae: 2x downscale, 2 latent channels" in \
        capsys.readouterr().out
    assert hist["steps"] == [2] and all(np.isfinite(hist["loss"]))
    config = json.loads((tmp_path / "pipeline_config.json").read_text())
    jax_entry = JaxKL({}, **KL).serialize()     # the JAX CLI's entry (no params needed)
    assert config["autoencoder"] == {"name": "kl_vae", **jax_entry}
    assert config["model"]["output_channels"] == config["model"]["in_channels"] == 2
    codec = build_autoencoder("kl_vae", **dict(KL, seed=3), device="cpu")
    pipe = DiffusionInferencePipeline.from_checkpoint(str(tmp_path), device="cpu",
                                                      autoencoder=codec)
    out = pipe.generate_samples(resolution=16, diffusion_steps=2, sampler="ddim",
                                guidance_scale=3.0, prompts=["bright", "dark"], seed=3)
    assert out.shape == (2, 16, 16, 3) and np.isfinite(out).all() and np.abs(out).max() <= 1
    with pytest.warns(UserWarning, match="pass autoencoder="):
        DiffusionInferencePipeline.from_checkpoint(str(tmp_path), device="cpu")


@pytest.mark.parametrize("extra,match", [
    (["--autoencoder", "stable_diffusion"], "A9's rest"),
    (["--num_frames", "16"], "A9's rest"),
    (["--image_size", "15"], "not divisible"),
], ids=["stable_diffusion", "num_frames", "image_size"])
def test_cli_refuses_what_latent_training_cannot_run(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        train.make_run(_cli(tmp_path, *extra))
