"""The port's KL autoencoder trainer (``flaxdiff_tpu_torch/trainer/
autoencoder_trainer.py``) against the JAX package, on the CPU in f32.

The JAX ``AutoEncoderTrainer`` runs three steps once per module, its
posterior noise drawn inside its own jitted step from ``fold_in(rng, step)``;
the same draws (one jitted vmap of that fold-in) go to the port's steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flaxdiff_tpu.models.autoencoder import KLAutoEncoder as JaxKL
from flaxdiff_tpu.parallel import create_mesh
from flaxdiff_tpu.trainer.autoencoder_trainer import AutoEncoderTrainer as JaxAETrainer
from flaxdiff_tpu.trainer.autoencoder_trainer import AutoEncoderTrainerConfig as JaxAEConfig
from test_torch_train import assert_close_to_max
from test_torch_unet import randomize, one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch import convert
from flaxdiff_tpu_torch.models import KLAutoEncoder
from flaxdiff_tpu_torch.trainer import AdamW, AutoEncoderTrainer, AutoEncoderTrainerConfig

KL = dict(latent_channels=2, block_channels=(8, 16), layers_per_block=1, norm_groups=4)
STEPS, BATCH, SIDE, LR = 3, 2, 16, 1e-3
# the loss of each step, relative; params and EMA of max|p|; PSNR (dB) and
# SSIM absolute (an untrained codec's SSIM is near 0); the latent scale,
# relative
LOSS_TOL, PARAM_TOL, METRIC_TOL = 1e-5, 1e-4, 1e-4
CONFIG = dict(kl_weight=1e-2, recon_loss="l1", ema_decay=0.9, normalize=True, log_every=1,
              seed=3)


def _images(seed):
    return np.random.default_rng(seed).integers(0, 256, (BATCH, SIDE, SIDE, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer after three steps on seeded batches, with its losses,
    each step's posterior noise, the initial params and the batches."""
    shapes = jax.eval_shape(lambda k: JaxKL.create(k, image_size=SIDE, **KL).params,
                            jax.random.PRNGKey(0))
    params = randomize(shapes, 7)
    mesh = create_mesh(axes={"data": 1}, devices=jax.devices()[:1])
    trainer = JaxAETrainer(JaxKL(params, **KL), optax.adamw(LR), mesh, JaxAEConfig(**CONFIG))
    batches = [{"sample": _images(10 + i)} for i in range(STEPS + 1)]
    losses = []
    for b in batches[:STEPS]:
        metrics = trainer.train_step(trainer.put_batch(b))
        losses.append({k: float(v) for k, v in metrics.items()})
    d = 2 ** (len(KL["block_channels"]) - 1)
    shape = (BATCH, SIDE // d, SIDE // d, KL["latent_channels"])
    key = jax.random.PRNGKey(CONFIG["seed"])
    draws = jax.jit(jax.vmap(lambda s: jax.random.normal(jax.random.fold_in(key, s), shape)))(
        jnp.arange(STEPS))
    return {"trainer": trainer, "losses": losses, "noise": np.asarray(draws),
            "params": params, "batches": batches}


def _port_trainer(params):
    vae = KLAutoEncoder(**KL, device="cpu").load_flax_params(params)
    return AutoEncoderTrainer(vae, AdamW(LR), AutoEncoderTrainerConfig(**CONFIG), device="cpu")


@pytest.fixture(scope="module")
def port_run(jax_run):
    trainer = _port_trainer(jax_run["params"])
    losses = [{k: float(v) for k, v in trainer.train_step(b, torch.tensor(n)).items()}
              for b, n in zip(jax_run["batches"], jax_run["noise"])]
    return trainer, losses


def _flax_flat(trainer, tree):
    return trainer.state.flatten(convert.state_dict_from_flax(trainer.state.model, tree))


def test_three_steps_match_the_jax_trainer(jax_run, port_run):
    """Loss, reconstruction and KL of each step within 1e-5 relative, then
    params and EMA within 1e-4 of their max."""
    trainer, losses = port_run
    for step, (mine, ref) in enumerate(zip(losses, jax_run["losses"])):
        for k in ("loss", "recon", "kl"):
            np.testing.assert_allclose(mine[k], ref[k], rtol=LOSS_TOL, err_msg=f"step {step} {k}")
    jstate = jax_run["trainer"].state
    assert_close_to_max(trainer.state.params.numpy(), _flax_flat(trainer, jstate.params).numpy(),
                        PARAM_TOL, "params")
    assert_close_to_max(trainer.state.ema.numpy(), _flax_flat(trainer, jstate.ema_params).numpy(),
                        PARAM_TOL, "ema")


@pytest.mark.parametrize("use_ema", [True, False])
def test_evaluate_psnr_ssim_match_jax(jax_run, port_run, use_ema):
    trainer, _ = port_run
    batch = jax_run["batches"][STEPS]
    mine = trainer.evaluate(batch, use_ema=use_ema)
    ref = jax_run["trainer"].evaluate(batch, use_ema=use_ema)
    assert set(mine) == set(ref) == {"psnr", "ssim"}
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=METRIC_TOL, err_msg=k)


def test_measure_latent_scale_matches_jax_on_the_exported_weights(jax_run, port_run):
    """The scale is measured on the weight set trained_vae exports (EMA by
    default), and the exported codec carries it."""
    trainer, _ = port_run
    batches = jax_run["batches"]
    mine = trainer.measure_latent_scale(iter(batches), num_batches=2)
    ref = jax_run["trainer"].measure_latent_scale(iter(batches), num_batches=2)
    np.testing.assert_allclose(mine, ref, rtol=METRIC_TOL)
    raw = trainer.measure_latent_scale(iter(batches), num_batches=2, use_ema=False)
    assert abs(raw - mine) > 1e-6 * abs(mine)   # the two weight sets differ
    vae = trainer.trained_vae(scaling_factor=mine)
    assert vae.scaling_factor == mine and not any(p.requires_grad
                                                  for p in vae.net.parameters())


def test_fit_history_and_generator_draws(jax_run):
    """fit logs every `log_every` steps through one read-back each; without
    given noise the trainer's generator draws it, the same for one seed."""
    runs = []
    for _ in range(2):
        trainer = _port_trainer(jax_run["params"])
        seen = []
        hist = trainer.fit(iter(jax_run["batches"]), total_steps=3,
                           callbacks=[lambda s, loss, vals: seen.append((s, loss))])
        assert hist["steps"] == [1, 2, 3] and [s for s, _ in seen] == [1, 2, 3]
        assert all(np.isfinite(hist[k]).all() for k in ("loss", "recon", "kl"))
        runs.append(trainer.state.params.clone())
    assert torch.equal(runs[0], runs[1])


def test_jax_trainer_state_converts_and_continues(jax_run):
    """A JAX trainer's params, EMA, moments and count load into the port's
    trainer (convert.autoencoder_trainer_from_flax): the weights come over
    exactly and the exported codecs encode alike."""
    jtrainer = jax_run["trainer"]
    trainer = convert.autoencoder_trainer_from_flax(jtrainer.state,
                                                    _port_trainer(jax_run["params"]))
    assert trainer.state.step == STEPS and int(trainer.state.count) == STEPS
    assert torch.equal(trainer.state.params, _flax_flat(trainer, jtrainer.state.params))
    assert torch.equal(trainer.state.ema, _flax_flat(trainer, jtrainer.state.ema_params))
    x = np.random.default_rng(4).uniform(-1, 1, (BATCH, SIDE, SIDE, 3)).astype(np.float32)
    for use_ema in (True, False):
        mine = trainer.trained_vae(use_ema=use_ema).encode(torch.from_numpy(x))
        ref = jtrainer.trained_vae(use_ema=use_ema).encode(jnp.asarray(x))
        assert_close_to_max(mine.detach().numpy(), np.asarray(ref), PARAM_TOL, "encode")
