"""The JAX CLI's training options in the port, on the CPU, against the JAX
code they replace: the float16 dynamic loss scale (flax's DynamicScale in
the JAX step), gradient accumulation (optax.MultiSteps), lamb (optax.lamb),
the monitored step's numerics aux, the loss ring and the gate counter (the
JAX step with a poisoned batch), the conditioning helpers of the input
config, a resume in the middle of an accumulation, the checkpoints of
earlier runs, and the CLI's refusals.

Inputs are made with numpy from a seed. The step-level tests use a
three-conv denoiser whose torch modules carry the flax modules' names; the
JAX step's own draws are handed to the port's step (``jax_draws``).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.dynamic_scale import DynamicScale as FlaxDynamicScale
from torch import nn

from flaxdiff_tpu.inputs import ConditionalInputConfig as JaxConditionalInputConfig
from flaxdiff_tpu.inputs import DiffusionInputConfig as JaxDiffusionInputConfig
from flaxdiff_tpu.inputs import HashTextEncoder as JaxHashTextEncoder
from flaxdiff_tpu.models.unet import Unet as JaxUnet
from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
from flaxdiff_tpu.schedulers import CosineNoiseSchedule as JaxCosine
from flaxdiff_tpu.telemetry.numerics import NumericsConfig as JaxNumericsConfig
from flaxdiff_tpu.telemetry.numerics import flatten_aux as jax_flatten_aux
from flaxdiff_tpu.trainer import DiffusionTrainer as JaxTrainer
from flaxdiff_tpu.trainer import TrainerConfig as JaxTrainerConfig
from flaxdiff_tpu.trainer.train_state import TrainState as JaxTrainState
from flaxdiff_tpu.trainer.train_step import TrainStepConfig as JaxStepConfig
from flaxdiff_tpu.trainer.train_step import make_train_step as jax_make_train_step
from test_torch_fit import _Leaves, _JaxDenoiser
from test_torch_train import jax_draws
from test_torch_unet import TINY, randomize, one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch import convert, train
from flaxdiff_tpu_torch.inputs import ConditionalInputConfig, DiffusionInputConfig, HashTextEncoder
from flaxdiff_tpu_torch.models import Unet
from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
from flaxdiff_tpu_torch.telemetry.numerics import NumericsConfig, flatten_aux, module_segments
from flaxdiff_tpu_torch.trainer import (Checkpointer, DiffusionTrainer, DynamicScale, MultiSteps,
                                        TrainerConfig, TrainState, TrainStepConfig, adamw, chain,
                                        clip_by_global_norm, lamb, make_train_step,
                                        warmup_cosine_decay_schedule)
from flaxdiff_tpu_torch.typing import Policy

LR, SHAPE = 1e-3, (4, 8, 8, 3)


class _Denoiser(nn.Module):
    """test_torch_fit's three-conv denoiser, its modules named as flax names
    _JaxDenoiser's, so the numerics aux's module keys are comparable."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(2, 8)
        self.Conv_0, self.Conv_1 = nn.Conv2d(3, 8, 3, padding=1), nn.Conv2d(8, 3, 3, padding=1)

    def forward(self, x, t, cond=None):
        x = x.float()
        temb = self.Dense_0(torch.stack([torch.sin(t * 0.01), torch.cos(t * 0.01)], dim=-1))
        h = nn.functional.silu(self.Conv_0(x.permute(0, 3, 1, 2)) + temb[:, :, None, None])
        return self.Conv_1(h).permute(0, 2, 3, 1)


def _torch_leaves(params):
    """flax leaves of _JaxDenoiser -> the torch parameter names and layouts."""
    dense = params["Dense_0"]
    out = {"Dense_0.weight": dense["kernel"].T, "Dense_0.bias": dense["bias"]}
    for conv in ("Conv_0", "Conv_1"):
        out[f"{conv}.weight"] = params[conv]["kernel"].transpose(3, 2, 0, 1)
        out[f"{conv}.bias"] = params[conv]["bias"]
    return {k: np.ascontiguousarray(np.asarray(v)) for k, v in out.items()}


def _jax_params(seed=0):
    model = _JaxDenoiser()
    init = model.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + SHAPE[1:]), jnp.zeros((1,)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray((0.3 * rng.standard_normal(p.shape)).astype(np.float32)),
        init["params"])
    return model, params


def _port_state(params, tx, **kwargs):
    model = _Denoiser()
    state = TrainState(model, tx, ema_decay=0.999, **kwargs)
    state.params.copy_(state.flatten(_torch_leaves(params)))
    if state.ema is not None:
        state.ema.copy_(state.params)
    return state


def _schedules():
    return (optax.warmup_cosine_decay_schedule(0.0, LR, 2, 8),
            warmup_cosine_decay_schedule(0.0, LR, 2, 8))


def _steps(numerics=None):
    """The JAX step (jitted) and the port's on the same configuration:
    cosine/eps, float samples, weighted loss, no CFG dropout, the gate on."""
    model = _JaxDenoiser()
    apply_fn = lambda p, x, t, c: model.apply({"params": p}, x, t, c)
    cfg = JaxStepConfig(uncond_prob=0.0, ema_decay=0.999, normalize=False, weighted_loss=True)
    jstep = jax.jit(jax_make_train_step(apply_fn, JaxCosine(timesteps=1000), JaxEps(), cfg,
                                        gate_nonfinite=True, numerics=numerics))
    pcfg = TrainStepConfig(uncond_prob=0.0, ema_decay=0.999, normalize=False, weighted_loss=True)
    pstep = make_train_step(CosineNoiseSchedule(1000), EpsilonPredictionTransform(), pcfg,
                            gate_nonfinite=True,
                            numerics=None if numerics is None else NumericsConfig())
    return apply_fn, jstep, pstep


def _batches(n, nan_at=(), seed=3):
    rng = np.random.default_rng(seed)
    out = [(0.5 * rng.standard_normal(SHAPE)).astype(np.float32) for _ in range(n)]
    for i in nan_at:
        out[i][:] = np.nan
    return out


def _adam(opt_state):
    """optax's ScaleByAdamState inside chain(clip, adamw)."""
    return opt_state[1][0]


def _assert_lr_quantum(out, ref, what, lr=LR):
    """As tests/test_torch_train.py: Adam turns ulp-level differences of
    near-zero gradients into whole steps of lr, so every element within 3
    lr and 99% of them within 1e-2 lr."""
    d = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 3 * lr, f"{what}: max difference {d.max():.3g}"
    assert float((d <= 1e-2 * lr).mean()) >= 0.99, what


def _assert_close_to_max(out, ref, tol, what):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    err, bound = np.abs(out - ref).max(), tol * np.abs(ref).max()
    assert err <= bound, f"{what}: max error {err:.3g} above {bound:.3g}"


# --- the float16 loss scale (fault C4) --------------------------------------------

def test_loss_scale_matches_flax_dynamic_scale():
    """8 steps with growth_interval 2 and a NaN batch at step 5, the JAX
    step's draws on both sides: the scale and fin_steps equal flax's
    DynamicScale exactly after every step (two growths and a backoff), the
    step advances on every step while the optimizer's count skips the NaN
    step, the losses agree within 1e-5 relative, and the params and EMA
    stand within lr quanta, the moments within 1e-5 of their largest
    element, of the JAX step's."""
    sched, psched = _schedules()
    apply_fn, jstep, pstep = _steps()
    _, params = _jax_params()
    jstate = JaxTrainState.create(
        apply_fn=apply_fn, params=params, rng=jax.random.PRNGKey(5), ema_decay=0.999,
        tx=optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched)),
        dynamic_scale=FlaxDynamicScale(growth_interval=2))
    state = _port_state(params, chain(clip_by_global_norm(1.0), adamw(psched)),
                        dynamic_scale=DynamicScale(growth_interval=2))
    scales = []
    for x in _batches(8, nan_at=(4,)):
        draws = jax_draws(jstate, SHAPE)
        jstate, jloss = jstep(jstate, {"sample": x})
        loss = pstep(state, {"sample": torch.from_numpy(x)}, *draws)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        scales.append(float(state.dynamic_scale.scale))
        assert scales[-1] == float(jstate.dynamic_scale.scale)
        assert int(state.dynamic_scale.fin_steps) == int(jstate.dynamic_scale.fin_steps)
        assert state.step == int(jstate.step)
        assert int(state.count) == int(_adam(jstate.opt_state).count)
    assert scales == [65536.0, 65536.0, 131072.0, 131072.0, 65536.0, 65536.0, 65536.0, 131072.0]
    assert state.step == 8 and int(state.count) == 7
    flat = lambda tree: state.flatten(_torch_leaves(tree)).numpy()
    _assert_lr_quantum(state.params.numpy(), flat(jstate.params), "params")
    _assert_lr_quantum(state.ema.numpy(), flat(jstate.ema_params), "ema")
    adam = _adam(jstate.opt_state)
    _assert_close_to_max(state.exp_avg.numpy(), flat(adam.mu), 1e-5, "mu")
    _assert_close_to_max(state.exp_avg_sq.numpy(), flat(adam.nu), 1e-5, "nu")


def test_float16_cli_builds_a_loss_scale(tmp_path):
    """Fault C4: ``--dtype float16`` trained with no loss scale. The CLI now
    builds flax's (scale 65536, growth every 2000 finite steps), as the JAX
    CLI's float16 policy does, and another dtype builds none; two float16
    steps on the CPU keep the scale and the state finite."""
    tiny = json.dumps({**TINY, "attention_configs": [None, None]})
    base = ["--device", "cpu", "--image_size", "16", "--batch_size", "2", "--model_config", tiny,
            "--total_steps", "2", "--save_every", "100", "--log_every", "1",
            "--text_encoder", "none"]
    run = train.make_run(base + ["--dtype", "float16", "--checkpoint_dir", str(tmp_path / "a")])
    scale = run.trainer.state.dynamic_scale
    assert scale is not None and float(scale.scale) == 65536.0 and int(scale.fin_steps) == 0
    assert scale.growth_interval == 2000 and run.trainer.state.model.conv_in.dtype == torch.float16
    hist = run.trainer.fit(run.batches(0), total_steps=2)
    assert all(np.isfinite(hist["loss"])) and float(scale.scale) == 65536.0
    assert int(scale.fin_steps) == 2 and int(run.trainer.state.count) == 2
    bf16 = train.make_run(base + ["--dtype", "bfloat16", "--checkpoint_dir", str(tmp_path / "b")])
    assert bf16.trainer.state.dynamic_scale is None


# --- gradient accumulation and lamb against optax -------------------------------------

def _flat_tree(state, tree):
    return state.flatten({n: np.asarray(tree[n.split(".")[-1]]) for n, _, _ in state.layout})


def test_multisteps_matches_optax():
    """MultiSteps(k=3) over clip(1.0) + adamw on warmup-cosine with warmup
    and decay divided by k (train.py:460-465), 7 micro-steps of seeded
    gradients above the clip: after each, the mini-step and the inner count
    equal optax's, the accumulator and both moments within 1e-6 relative
    (plus 1e-6 of the largest element: the running mean's subtraction
    leaves an ulp of the larger terms in small elements), the params
    within 1e-6 of the buffer's largest value, and the params
    unchanged on every micro-step but the emit ones (and the first emit,
    at the warmup's lr of 0)."""
    k, shapes = 3, [(6, 5), (5,), (3, 2, 4)]
    rng = np.random.default_rng(50)
    model = _Leaves(shapes, rng)
    params = {str(i): jnp.asarray(p.detach().numpy()) for i, p in enumerate(model.p)}
    warmup, decay = max(6 // k, 1), max(21 // k, max(6 // k, 1) + 1)
    ref_tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup, decay))), every_k_schedule=k)
    ref_state = ref_tx.init(params)
    state = TrainState(model, MultiSteps(chain(clip_by_global_norm(1.0), adamw(
        warmup_cosine_decay_schedule(0.0, 1e-2, warmup, decay))), k), ema_decay=None)
    for step in range(7):
        grads = {str(i): (1e3 * rng.standard_normal(s)).astype(np.float32)
                 for i, s in enumerate(shapes)}
        before = state.params.clone()
        updates, ref_state = ref_tx.update(grads, ref_state, params)
        params = optax.apply_updates(params, updates)
        state.apply_gradients(_flat_tree(state, grads), None)
        assert int(state.mini_step) == int(ref_state.mini_step) == (step + 1) % k
        inner = _adam(ref_state.inner_opt_state)
        assert int(state.count) == int(inner.count) == (step + 1) // k
        # the first emit applies lr 0: the warmup starts at 0
        assert torch.equal(state.params, before) == ((step + 1) % k != 0 or step + 1 == k), step
        for out, ref in ((state.acc, ref_state.acc_grads), (state.exp_avg, inner.mu),
                         (state.exp_avg_sq, inner.nu)):
            ref = _flat_tree(state, ref).numpy()
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
        ref = _flat_tree(state, params).numpy()
        np.testing.assert_allclose(state.params.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    assert state.step == 7


# the tiny UNet with one residual block a level: every kind of leaf (conv
# kernels, GroupNorm scales, 3D attention projections) at half the count,
# which halves the time XLA takes to compile optax's update
LEAVES_UNET = {**TINY, "num_res_blocks": 1}


@pytest.fixture(scope="module")
def unet_leaves():
    """The UNet's flax leaves: their shapes and seeded values."""
    jm = JaxUnet(**LEAVES_UNET)
    x = np.zeros((1, 16, 16, 3), np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, np.zeros((1,), np.float32),
                            np.zeros((1, 7, 12), np.float32))["params"]
    return shapes, randomize(shapes, 51)


@pytest.mark.parametrize("k", [1, 2], ids=["alone", "multisteps"])
def test_lamb_matches_optax_on_the_unet_leaves(unet_leaves, k):
    """clip(1.0) + lamb(1e-2) on a tiny UNet's real leaves (every flax
    leaf one torch parameter of the flat layout), alone and under
    MultiSteps(k=2), 4 micro-steps of seeded gradients: the per-leaf trust
    ratio makes the params hold within 1e-6 of their largest value and the
    moments within 1e-5 relative (plus 1e-6 of the largest) of optax.lamb's:
    the clip's global norm sums 230k elements in another order, which moves
    every clipped gradient by up to ~1e-6 relative."""
    shapes, params = unet_leaves
    model = Unet(**LEAVES_UNET, in_channels=3, context_dim=12, device="cpu")
    tx = chain(clip_by_global_norm(1.0), lamb(1e-2))
    ref_tx = optax.chain(optax.clip_by_global_norm(1.0), optax.lamb(1e-2))
    if k > 1:
        tx, ref_tx = MultiSteps(tx, k), optax.MultiSteps(ref_tx, every_k_schedule=k)
    state = TrainState(model, tx, ema_decay=None)
    flat = lambda tree: state.flatten(convert.state_dict_from_flax(model, tree))
    state.params.copy_(flat(params))
    ref_state = ref_tx.init(params)

    @jax.jit
    def ref_update(grads, ref_state, params):
        updates, ref_state = ref_tx.update(grads, ref_state, params)
        return optax.apply_updates(params, updates), ref_state

    rng = np.random.default_rng(52)
    for _ in range(4):
        grads = jax.tree_util.tree_map(
            lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32), shapes)
        params, ref_state = ref_update(grads, ref_state, params)
        state.apply_gradients(flat(grads), None)
    ref = flat(params).numpy()
    assert not np.allclose(ref, flat(randomize(shapes, 51)).numpy())
    np.testing.assert_allclose(state.params.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    inner = _adam(ref_state.inner_opt_state if k > 1 else ref_state)
    for out, r in ((state.exp_avg, inner.mu), (state.exp_avg_sq, inner.nu)):
        ref = flat(r).numpy()
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    assert int(state.count) == int(inner.count) == 4 // k


# --- the monitored step, the loss ring and the gate counter ---------------------------

def test_numerics_aux_ring_and_gate_counter_match_the_jax_step():
    """Five steps, plain / monitored / plain NaN / monitored NaN / monitored,
    with a 3-slot loss ring and the gate counter on both sides: each
    monitored step's flattened aux has the JAX step's keys (per-module
    entries under the flax names) and values within 1e-4 relative (NaN where
    JAX has NaN, counts and ``skipped`` exact); after every step the gate
    counter equals JAX's exactly and the ring holds the same losses (NaN at
    the poisoned steps' slots) within 1e-5 relative."""
    _, params = _jax_params(1)
    sched, psched = _schedules()
    apply_fn, jplain, pplain = _steps()
    _, jmon, pmon = _steps(JaxNumericsConfig(per_module=True))
    jstate = JaxTrainState.create(
        apply_fn=apply_fn, params=params, rng=jax.random.PRNGKey(7), ema_decay=0.999,
        tx=optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched)),
        loss_ring_size=3, gate_counter=True)
    state = _port_state(params, chain(clip_by_global_norm(1.0), adamw(psched)),
                        loss_ring_size=3, gate_counter=True)
    monitored = [False, True, False, True, True]
    for x, mon in zip(_batches(5, nan_at=(2, 3), seed=4), monitored):
        draws = jax_draws(jstate, SHAPE)
        batch = {"sample": torch.from_numpy(x)}
        if mon:
            jstate, _, jaux = jmon(jstate, {"sample": x})
            _, aux = pmon(state, batch, *draws)
            ref, out = jax_flatten_aux(jaux), flatten_aux(aux)
            assert set(out) == set(ref) and "numerics/module/Conv_1/update_ratio" in out
            for key, v in ref.items():
                if key.endswith(("nonfinite", "skipped")):
                    assert out[key] == v, key
                else:
                    np.testing.assert_allclose(out[key], v, rtol=1e-4, atol=1e-12, err_msg=key)
        else:
            jstate, _ = jplain(jstate, {"sample": x})
            pplain(state, batch, *draws)
        assert state.gate_events.tolist() == np.asarray(jstate.gate_events).tolist()
        np.testing.assert_allclose(state.loss_ring.numpy(), np.asarray(jstate.loss_ring),
                                   rtol=1e-5)
    n = state.params.numel()
    assert state.gate_events.tolist() == [2 * n, 4 * n, 2 * n]
    assert np.isnan(state.loss_ring.numpy()).sum() == 2
    assert all(torch.isfinite(v).all() for k, v in state.buffers().items() if k != "loss_ring")


def test_module_keys_are_the_jax_unets(unet_leaves):
    """The aux's modules of the ported UNet are the JAX UNet's top-level
    modules (``time_proj`` is ``TimeProjection_0``), and they tile the
    flat layout in one contiguous range each."""
    shapes, _ = unet_leaves
    state = TrainState(Unet(**LEAVES_UNET, in_channels=3, context_dim=12, device="cpu"),
                       adamw(1e-3), ema_decay=None)
    segments = module_segments(state.layout)
    assert sorted(name for name, _, _ in segments) == sorted(shapes)
    assert segments[0][1] == 0 and sum(n for _, _, n in segments) == state.params.numel()


# --- conditioning ---------------------------------------------------------------------

def test_input_shapes_and_conditioning_match_jax():
    """get_input_shapes (image, video, and a codec's latent with sizes that
    do not divide) and process_conditioning with a CFG-dropout mask, the
    JAX hash encoder's table on both sides."""
    jenc = JaxHashTextEncoder.create(features=16)
    enc = HashTextEncoder(features=16, table=np.asarray(jenc.model.table))
    codec = type("Codec", (), {"downscale_factor": 8, "latent_channels": 4})()
    texts = ["a bright photo", "dark", "", "a photo of a cat"]
    mask = np.array([False, True, False, True])
    for shape in ((36, 20, 3), (5, 17, 17, 3)):
        jcfg = JaxDiffusionInputConfig("sample", shape, [JaxConditionalInputConfig(encoder=jenc)])
        cfg = DiffusionInputConfig("sample", shape, [ConditionalInputConfig(encoder=enc)])
        for codec_ in (None, codec):
            assert cfg.get_input_shapes(codec_) == jcfg.get_input_shapes(codec_)
        (ref,) = jcfg.process_conditioning({"text": texts}, jnp.asarray(mask))
        (out,) = cfg.process_conditioning({"text": texts}, torch.from_numpy(mask))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
        (plain,) = cfg.process_conditioning({"text": texts})
        np.testing.assert_allclose(plain.numpy(), np.asarray(jenc(texts)), atol=1e-6)


# --- checkpoints ----------------------------------------------------------------------

def _trainer(checkpointer=None, seed=3):
    torch.manual_seed(0)             # the denoiser's initializers
    tx = MultiSteps(chain(clip_by_global_norm(1.0), lamb(warmup_cosine_decay_schedule(
        0.0, 1e-3, 2, 8))), 3)
    return DiffusionTrainer(
        _Denoiser(), tx, CosineNoiseSchedule(1000), EpsilonPredictionTransform(),
        TrainerConfig(log_every=2, seed=seed, normalize=False, uncond_prob=0.0,
                      numerics_cadence=3, loss_ring=2, gate_counter=True),
        device="cpu", checkpointer=checkpointer, policy=Policy(compute_dtype=torch.float16))


def test_resume_in_the_middle_of_an_accumulation_is_bit_equal(tmp_path):
    """MultiSteps(k=3) over lamb with the loss scale, the ring, the gate
    counter and the monitored step every 3 steps: 4 steps, save (mini-step
    1 of 3), a new trainer restores and takes 3 more, and every buffer (the
    accumulator, the counts, the scale and the ring too) and the generator
    equal 7 uninterrupted steps bit for bit."""
    batches = [{"sample": x} for x in _batches(7, seed=8)]
    whole = _trainer()
    whole.fit(iter(batches), total_steps=7)
    first = _trainer(Checkpointer(str(tmp_path)))
    first.fit(iter(batches[:4]), total_steps=4, save_every=4)
    first.checkpointer.close()
    assert int(first.state.mini_step) == 1
    second = _trainer(Checkpointer(str(tmp_path)), seed=99)
    assert second.restore_checkpoint() == 4
    second.fit(iter(batches[4:]), total_steps=3)
    second.checkpointer.close()
    assert set(whole.state.buffers()) >= {"acc", "mini_step", "count", "loss_scale",
                                          "loss_scale_fin_steps", "loss_ring", "gate_events"}
    for name, buf in whole.state.buffers().items():
        assert torch.equal(second.state.buffers()[name], buf), name
    assert torch.equal(second.generator.get_state(), whole.generator.get_state())
    assert int(whole.state.count) == 2 and whole.state.step == 7


def test_an_earlier_checkpoint_restores_without_scale_or_accumulation(tmp_path):
    """A checkpoint of the earlier format (params, EMA, moments, step; the
    step was the optimizer's count) restores into a state with no loss scale
    and no accumulation, its count taken from the step; a state that
    accumulates refuses it, naming what it lacks."""
    state = TrainState(_Denoiser(), adamw(1e-3))
    state.params.normal_(generator=torch.Generator().manual_seed(0))
    old = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in state.state_dict().items() if k != "count"}
    old["step"] = 5
    torch.save({"state": old, "extra": {}}, tmp_path / "old.pt")
    saved = torch.load(tmp_path / "old.pt", weights_only=True)["state"]
    fresh = TrainState(_Denoiser(), adamw(1e-3))
    fresh.load_state_dict(saved)
    assert fresh.step == 5 and int(fresh.count) == 5 and torch.equal(fresh.params, state.params)
    accumulating = TrainState(_Denoiser(), MultiSteps(adamw(1e-3), 2))
    with pytest.raises(ValueError, match="acc"):
        accumulating.load_state_dict(saved)


# --- the CLI's refusals -----------------------------------------------------------------

@pytest.mark.parametrize("flags,error,match", [
    (["--optimizer", "lamb", "--flat_params"], SystemExit, "--flat_params is elementwise-only"),
    (["--optimizer", "lamb", "--flat_optimizer"], SystemExit,
     "--flat_optimizer is elementwise-only"),
    (["--gate_counter", "--no_nonfinite_gate"], ValueError, "requires gate_nonfinite"),
    (["--val_every", "2", "--val_metrics", "fid"], SystemExit, "A10"),
    (["--anomaly_action", "skip_step"], SystemExit, "A14"),
    (["--flash_tune_cache", "cache"], SystemExit, "queue B"),
], ids=["lamb_flat_params", "lamb_flat_optimizer", "gate_counter_no_gate", "val_metrics",
        "anomaly_action", "flash_tune_cache"])
def test_cli_refuses_what_train_py_refuses(tmp_path, flags, error, match):
    """train.py's refusals, with its messages (the flat flags' text is the
    JAX CLI's; the gate counter's the JAX trainer's), and the flags whose
    features are not ported, naming their ROADMAP.md item."""
    tiny = json.dumps({**TINY, "attention_configs": [None, None]})
    argv = ["--device", "cpu", "--image_size", "16", "--batch_size", "2", "--dtype", "float32",
            "--model_config", tiny, "--text_encoder", "none", "--checkpoint_dir",
            str(tmp_path)] + flags
    with pytest.raises(error, match=match):
        train.make_run(argv)
    if "flat" in match:
        source = (Path(__file__).parents[1] / "train.py").read_text()
        assert "is elementwise-only" in source and "information across a leaf's shape" in source
    if error is ValueError:
        with pytest.raises(ValueError, match=match):
            JaxTrainer(apply_fn=None, init_fn=None, tx=None, schedule=None, transform=None,
                       config=JaxTrainerConfig(gate_counter=True, gate_nonfinite=False))
