"""The port's training slice against the JAX package, on the CPU in f32.

Kernel backward: each port Function's backward (its plain versions, on CPU
tensors) against ``jax.vjp`` of the Pallas kernels run through the
interpreter, and against torch autograd of the eager composition. Train
step: the tiny UNet's loss, gradients and 3-step params/EMA against
``flaxdiff_tpu.trainer.make_train_step``, with the JAX step's own draws
handed to the port's step. Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from flaxdiff_tpu.models.unet import Unet as JaxUnet
from flaxdiff_tpu.ops.attention import _maybe_pad_head_dim as jax_pad_head_dim
from flaxdiff_tpu.ops.flash_attention import flash_attention as jax_flash
from flaxdiff_tpu.ops.fused_adaln import fused_geglu as jax_geglu
from flaxdiff_tpu.ops.fused_norm import fused_groupnorm_silu as jax_gn
from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
from flaxdiff_tpu.predictors import KarrasPredictionTransform as JaxKarras
from flaxdiff_tpu.schedulers import CosineNoiseSchedule as JaxCosine
from flaxdiff_tpu.schedulers import EDMNoiseSchedule as JaxEDM
from flaxdiff_tpu.trainer.train_state import TrainState as JaxTrainState
from flaxdiff_tpu.trainer.train_step import TrainStepConfig as JaxStepConfig
from flaxdiff_tpu.trainer.train_step import _make_loss_builder as jax_loss_builder
from flaxdiff_tpu.trainer.train_step import make_train_step as jax_make_train_step
from flaxdiff_tpu.utils import normalize_images as jax_normalize_images
from test_torch_unet import TINY, randomize, one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch import convert, predictors, schedulers, utils
from flaxdiff_tpu_torch.models import Unet
from flaxdiff_tpu_torch.models.common import fourier_freqs
from flaxdiff_tpu_torch.ops import fused_geglu, fused_groupnorm_silu
from flaxdiff_tpu_torch.ops.attention import dot_product_attention, eager_attention
from flaxdiff_tpu_torch.ops.fused_adaln import gelu_tanh
from flaxdiff_tpu_torch.ops.fused_norm import (groupnorm_bwd_dx, groupnorm_bwd_finalize,
                                               groupnorm_bwd_stats, groupnorm_finalize,
                                               groupnorm_stats, rows_per_block)
from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform, KarrasPredictionTransform
from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule, EDMNoiseSchedule
from flaxdiff_tpu_torch.trainer import AdamW, TrainStepConfig, make_loss_builder, make_train_step

# f32 on both sides; the two differ only in summation order and the
# libraries' exp/tanh/rsqrt, a few ulps each
KERNEL_TOL = 1e-5


def assert_close_to_max(out, ref, tol, what=""):
    """Every element within tol * max|ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    bound = tol * np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= bound, f"{what}: max error {err:.3g} above {bound:.3g}"


def jitted_vjp(fn, args, cotangent):
    """``jax.vjp`` of `fn` at `args` applied to `cotangent`, as one jitted
    program: the interpreted Pallas kernels run about twice as fast jitted
    as eagerly, compile included."""
    return jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(tuple(map(jnp.asarray, args)), cotangent)


def torch_vjp(fn, args, cotangent):
    """Gradients of <fn(*args), cotangent> with respect to every arg."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    return [g.numpy() for g in torch.autograd.grad(out, ts, torch.from_numpy(cotangent))]


# --- kernel backward ----------------------------------------------------------

@pytest.mark.parametrize("lq,lk,d", [
    (48, 77, 64),    # cross-attention to the 77-token text context, 16-row kv tiles
    (40, 24, 32),    # Lq != Lk, neither a tile multiple, head dim 32
    (33, 33, 64),    # ragged self-attention
    (1, 77, 128),    # one q row against the text context, head dim 128
])
def test_flash_backward_matches_pallas_kernels(lq, lk, d):
    rng = np.random.default_rng(lq + lk + d)
    q = rng.standard_normal((2, lq, 2, d)).astype(np.float32)
    k = rng.standard_normal((2, lk, 2, d)).astype(np.float32)
    v = rng.standard_normal((2, lk, 2, d)).astype(np.float32)
    g = rng.standard_normal((2, lq, 2, d)).astype(np.float32)
    # 16-row blocks: the interpreted kernels stream several q and kv blocks
    # and mask a padded tail
    refs = jitted_vjp(lambda a, b, c: jax_flash(a, b, c, None, 16, 16, True), (q, k, v), g)
    outs = torch_vjp(lambda a, b, c: dot_product_attention(a, b, c, backend="flash"),
                     (q, k, v), g)
    eager = torch_vjp(eager_attention, (q, k, v), g)
    for name, out, ref, second in zip("qkv", outs, refs, eager):
        assert_close_to_max(out, ref, KERNEL_TOL, f"d{name} vs Pallas")
        assert_close_to_max(out, second, KERNEL_TOL, f"d{name} vs autograd of eager")


@pytest.mark.parametrize("d", [40, 72, 80, 96, 160, 256, 288, 384])
def test_attention_dispatch_pads_odd_head_dims_through_autograd(d):
    """dq, dk, dv through the dispatch's flash path (zero-padded to the next
    of 32, 64, 128 and 256, and above 256 to the next multiple of 64: 288
    runs at 320; 256 and 384 are native) against ``jax.vjp`` of the
    reference's TPU path for the same head dim: pad to a multiple of 128
    lanes (``_maybe_pad_head_dim``: 288 runs at 384 there), the Pallas
    kernels interpreted with the true head dim's scale, the slice; and
    against autograd of the eager math."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((2, 30, 2, d)).astype(np.float32)
    k = rng.standard_normal((2, 77, 2, d)).astype(np.float32)
    v = rng.standard_normal((2, 77, 2, d)).astype(np.float32)
    g = rng.standard_normal((2, 30, 2, d)).astype(np.float32)

    def reference(a, b, c):
        a, b, c, pad = jax_pad_head_dim(a, b, c, native=False)
        assert pad == (-d) % 128
        return jax_flash(a, b, c, 1.0 / np.sqrt(d), 16, 16, True)[..., :d]

    refs = jitted_vjp(reference, (q, k, v), g)
    outs = torch_vjp(lambda a, b, c: dot_product_attention(a, b, c, backend="auto"), (q, k, v), g)
    eager = torch_vjp(eager_attention, (q, k, v), g)
    for name, out, ref, second in zip("qkv", outs, refs, eager):
        assert out.shape == ref.shape
        assert_close_to_max(out, ref, KERNEL_TOL, f"d{name} vs Pallas")
        assert_close_to_max(out, second, KERNEL_TOL, f"d{name} vs autograd of eager")


def _eager_groupnorm_silu(x, scale, bias, groups, apply_silu, eps=1e-6):
    xg = x.view(x.shape[0], -1, groups, x.shape[-1] // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).view(x.shape) * scale + bias
    return F.silu(y) if apply_silu else y


@pytest.mark.parametrize("shape,apply_silu,mean", [
    ((2, 100, 256), True, 0.0),       # HW not a multiple of the port's 32-row block
    ((2, 10, 10, 64), False, 0.0),    # NHWC input, normalize + affine only
    # mean 20, std 1: the shifted statistics. At mean 100 the f32 inputs
    # have an ulp of 7.6e-6, the two sides' means differ by about that, and
    # dx by ~1e-5 of its max, at this tolerance's edge
    ((2, 64, 128), True, 20.0),
])
def test_groupnorm_backward_matches_pallas_kernels(shape, apply_silu, mean):
    rng = np.random.default_rng(int(mean) + shape[-1])
    c = shape[-1]
    x = (mean + rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    refs = jitted_vjp(lambda a, s, b: jax_gn(a, s, b, groups=8, eps=1e-6, apply_silu=apply_silu,
                                             interpret=True, force_pallas=True), (x, scale, bias), g)
    outs = torch_vjp(lambda a, s, b: fused_groupnorm_silu(a, s, b, groups=8,
                                                          apply_silu=apply_silu),
                     (x, scale, bias), g)
    eager = torch_vjp(lambda a, s, b: _eager_groupnorm_silu(a, s, b, 8, apply_silu),
                      (x, scale, bias), g)
    for name, out, ref, second in zip(("dx", "dscale", "dbias"), outs, refs, eager):
        assert_close_to_max(out, ref, KERNEL_TOL, f"{name} vs Pallas")
        assert_close_to_max(out, second, KERNEL_TOL, f"{name} vs autograd of eager")


@pytest.mark.parametrize("shape,groups", [
    ((3, 1000, 64), 8),    # 7 blocks of 143 rows, the last 142
    ((2, 701, 48), 4),     # 4 blocks of 176 rows, the last 173; 12 channels a group
])
def test_groupnorm_backward_blocks_match_pallas_kernels(shape, groups):
    """The backward statistics in ``rows_per_block``'s blocks (several,
    the last ragged), their finalize and the dx pass give the reference's
    dx, dscale and dbias."""
    b, hw, c = shape
    rows = rows_per_block(b, hw, c)
    nblk = -(-hw // rows)
    assert nblk > 1 and hw % rows
    rng = np.random.default_rng(hw)
    x = (0.5 + rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    refs = jitted_vjp(lambda a, s, b: jax_gn(a, s, b, groups=groups, eps=1e-6, apply_silu=True,
                                             interpret=True, force_pallas=True), (x, scale, bias), g)
    xt, gt, st, bt = map(torch.from_numpy, (x, g, scale, bias))
    mean, rstd = groupnorm_finalize(groupnorm_stats(xt, groups), hw, c, 1e-6)
    gsums, csums = groupnorm_bwd_stats(xt, gt, mean, rstd, st, bt, True)
    assert gsums.shape == (b, nblk, 2, groups) and csums.shape == (b, nblk, 2, c)
    s, dscale, dbias = groupnorm_bwd_finalize(gsums, csums, hw)
    dx = groupnorm_bwd_dx(xt, gt, mean, rstd, st, bt, s, True)
    for name, out, ref in zip(("dx", "dscale", "dbias"), (dx, dscale, dbias), refs):
        assert_close_to_max(out.numpy(), ref, KERNEL_TOL, f"{name} vs Pallas")


def test_geglu_backward_matches_pallas_kernel():
    rng = np.random.default_rng(5)
    proj = (2.0 * rng.standard_normal((2, 37, 192))).astype(np.float32)
    g = rng.standard_normal((2, 37, 96)).astype(np.float32)
    (ref,) = jitted_vjp(lambda p: jax_geglu(p, interpret=True, force_pallas=True), (proj,), g)
    (out,) = torch_vjp(fused_geglu, (proj,), g)

    def eager(p):
        gate, val = p.chunk(2, dim=-1)
        return val * F.gelu(gate, approximate="tanh")

    (second,) = torch_vjp(eager, (proj,), g)
    assert_close_to_max(out, ref, KERNEL_TOL, "dproj vs Pallas")
    assert_close_to_max(out, second, KERNEL_TOL, "dproj vs autograd of eager")
    np.testing.assert_allclose(gelu_tanh(torch.from_numpy(proj)).numpy(),
                               np.asarray(jax.nn.gelu(proj)), atol=1e-6)


# --- the train step against make_train_step ------------------------------------

LR = 1e-4
BATCH, RES, CTX_LEN, CTX_DIM = 3, 16, 77, 12
SEED = 18  # of the JAX state's rng: each of its first 3 steps drops one sample's context


def jax_draw_arrays(state, x_shape, schedule=JaxCosine(timesteps=1000)):
    """The JAX step's own draws (train_step.py:53-84): fold the step into
    the state's key, split in four, then bernoulli, the schedule's
    timesteps and normal; traceable, so a test may draw inside the jitted
    reference step."""
    rng = jax.random.fold_in(state.rng, state.step)
    noise_key, t_key, uncond_key, _ = jax.random.split(rng, 4)
    mask = jax.random.bernoulli(uncond_key, 0.12, (x_shape[0],))
    t = schedule.sample_timesteps(t_key, x_shape[0])
    noise = jax.random.normal(noise_key, x_shape, dtype=jnp.float32)
    return noise, t, mask


def jax_draws(state, x_shape, schedule=JaxCosine(timesteps=1000)):
    """``jax_draw_arrays`` as torch tensors."""
    return tuple(torch.from_numpy(np.array(a)) for a in jax_draw_arrays(state, x_shape, schedule))


def make_batch(rng, normalize):
    shape = (BATCH, RES, RES, 3)
    sample = (rng.integers(0, 256, shape, dtype=np.uint8) if normalize
              else rng.standard_normal(shape).astype(np.float32))
    return {"sample": sample,
            "cond": rng.standard_normal((BATCH, CTX_LEN, CTX_DIM)).astype(np.float32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def torch_draws(arrays):
    """JAX draws (numpy or jax arrays) as torch tensors."""
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def jax_trainer():
    """The tiny UNet with seeded weights (drawn over the tree's shapes from
    ``jax.eval_shape``: no eager init) and the JAX step on float samples,
    jitted once per module with the step's own draws made inside the same
    program: ``step(state, batch) -> (draws, state, loss)`` and
    ``value_and_grad(state, batch) -> (draws, (loss, grads))``, both views
    of one compiled program; every case of the module shares it."""
    normalize = False
    jm = JaxUnet(**TINY)
    x = np.zeros((1, RES, RES, 3), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, np.zeros((1,), np.float32),
                                            np.zeros((1, CTX_LEN, CTX_DIM), np.float32)))
    params = randomize(shapes["params"], 11)
    apply_fn = lambda p, x, t, c: jm.apply({"params": p}, x, t, c)
    cfg = JaxStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=normalize,
                        weighted_loss=True)
    null = np.zeros((1, CTX_LEN, CTX_DIM), np.float32)
    schedule, transform = JaxCosine(timesteps=1000), JaxEps()
    shape = (BATCH, RES, RES, 3)
    step = jax_make_train_step(apply_fn, schedule, transform, cfg, null_cond=null,
                               gate_nonfinite=True)
    build = jax_loss_builder(apply_fn, schedule, transform, cfg, None, None, null)
    # one program: the draws, the loss and gradients at the state, and the
    # step (one compile of the UNet's backward, not one for each)
    program = jax.jit(lambda st, b: (jax_draw_arrays(st, shape),
                                     jax.value_and_grad(build(st, b))(st.params), *step(st, b)))
    drawn_step = lambda st, b: (lambda d, _, new, loss: (d, new, loss))(*program(st, b))
    value_and_grad = lambda st, b: program(st, b)[:2]
    state0 = JaxTrainState.create(apply_fn=apply_fn, params=params, tx=optax.adamw(LR),
                                  rng=jax.random.PRNGKey(SEED), ema_decay=0.999)
    return dict(params=params, step=drawn_step,
                value_and_grad=value_and_grad, state0=state0)


def port_trainer(jt, normalize=False):
    """The port's model, state and step at the JAX side's initial weights."""
    model = Unet(**TINY, in_channels=3, context_dim=CTX_DIM, device="cpu")
    model.load_flax_params(jt["params"], fourier_freqs(TINY["emb_features"]))
    cfg = TrainStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=normalize,
                          weighted_loss=True)
    null = torch.zeros(1, CTX_LEN, CTX_DIM)
    from flaxdiff_tpu_torch.trainer import TrainState
    state = TrainState(model, AdamW(LR), ema_decay=0.999)
    step = make_train_step(CosineNoiseSchedule(1000), EpsilonPredictionTransform(), cfg,
                           null_cond=null, gate_nonfinite=True)
    build = make_loss_builder(CosineNoiseSchedule(1000), EpsilonPredictionTransform(), cfg,
                              null_cond=null)
    return state, step, build


def port_layout(state, tree):
    """A JAX params-shaped tree as a flat buffer of the port state's layout."""
    return state.flatten(convert.state_dict_from_flax(state.model, tree)).numpy()


def assert_lr_quantum(out, ref, what):
    """Adam turns ulp-level differences of near-zero gradients into whole
    steps of lr (ROADMAP A5), so trajectories are held to lr quanta: every
    element within 3 lr, and 99% of them within 1e-2 lr."""
    d = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 3 * LR, f"{what}: max difference {d.max():.3g} above {3 * LR:.3g}"
    share = float((d <= 1e-2 * LR).mean())
    assert share >= 0.99, f"{what}: only {share:.4f} of elements within 1e-2 lr"


def jax_inputs(batch):
    """What the JAX float step takes for a port batch: uint8 samples
    normalized by the JAX package's ``normalize_images``."""
    x = batch["sample"]
    if x.dtype == np.uint8:
        x = np.asarray(jax_normalize_images(x))
    return {**batch, "sample": x}


@pytest.mark.parametrize("normalize", [False, True], ids=["float", "uint8"])
def test_train_step_loss_grads_and_three_steps_match_jax(jax_trainer, normalize):
    """The port's step on float samples, and on uint8 samples it normalizes
    itself, against the one JAX float step (uint8 samples normalized for it
    as ``normalize_images`` does)."""
    jt = jax_trainer
    state, step, build = port_trainer(jt, normalize)
    rng = np.random.default_rng(21)
    batches = [make_batch(rng, normalize) for _ in range(3)]
    jstate = jt["state0"]

    # loss and gradients at the same params and draws
    draws, (ref_loss, ref_grads) = jt["value_and_grad"](jstate, jax_inputs(batches[0]))
    loss = build(torch_batch(batches[0]), *torch_draws(draws))(state.model)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    grads = dict(zip([n for n, _, _ in state.layout],
                     torch.autograd.grad(loss, list(state.model.parameters()))))
    ref = {k: v.numpy() for k, v in convert.state_dict_from_flax(state.model, ref_grads).items()}
    assert grads.keys() == ref.keys()
    gmax = max(np.abs(r).max() for r in ref.values())
    for name, g in grads.items():
        if name.endswith("to_k.bias"):
            # zero by the math (softmax ignores the shift a key bias adds to
            # every logit of a row): both sides hold f32 rounding, ~1e-10
            assert max(np.abs(g.numpy()).max(), np.abs(ref[name]).max()) <= 1e-6 * gmax, name
            continue
        assert_close_to_max(g.numpy(), ref[name], 1e-4, f"grad {name}")

    # three steps with the JAX step's draws
    dropped = 0
    for batch in batches:
        draws, jstate, jloss = jt["step"](jstate, jax_inputs(batch))
        noise, t, mask = torch_draws(draws)
        dropped += int(mask.sum())
        loss = step(state, torch_batch(batch), noise, t, mask)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert dropped > 0, "the draws never exercised the CFG splice"
    assert state.step == int(jstate.step) == 3
    assert_lr_quantum(state.params.numpy(), port_layout(state, jstate.params), "params")
    assert_lr_quantum(state.ema.numpy(), port_layout(state, jstate.ema_params), "ema")
    moved = np.abs(state.params.numpy() - port_layout(state, jt["params"]))
    assert np.median(moved) > LR, "the params barely moved: the comparison would be empty"


@pytest.mark.parametrize("samples", ["float"])
def test_edm_train_step_loss_and_grads_match_jax(jax_trainer, samples):
    """EDM training through the same loss builder: float timesteps (ln sigma
    ~ N(-1.2, 1.2) mapped through the inverse ramp), c_in on x_t, c_noise =
    log(sigma) / 4 into the UNet, the c_skip / c_out wrap and the EDM
    weights, with the JAX step's own draws."""
    jt = jax_trainer
    jm = JaxUnet(**TINY)
    apply_fn = lambda p, x, t, c: jm.apply({"params": p}, x, t, c)
    cfg = JaxStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False, weighted_loss=True)
    null = np.zeros((1, CTX_LEN, CTX_DIM), np.float32)
    schedule = JaxEDM(timesteps=1000)
    build = jax_loss_builder(apply_fn, schedule, JaxKarras(), cfg, None, None, null)
    batch = make_batch(np.random.default_rng(29), False)
    shape = (BATCH, RES, RES, 3)
    draws, (ref_loss, ref_grads) = jax.jit(lambda p: (
        jax_draw_arrays(jt["state0"], shape, schedule),
        jax.value_and_grad(build(jt["state0"], batch))(p)))(jt["params"])
    draws = torch_draws(draws)
    t = draws[1]
    assert t.dtype == torch.float32 and not torch.equal(t, t.round())

    model = Unet(**TINY, in_channels=3, context_dim=CTX_DIM, device="cpu")
    model.load_flax_params(jt["params"], fourier_freqs(TINY["emb_features"]))
    port_build = make_loss_builder(EDMNoiseSchedule(1000), KarrasPredictionTransform(),
                                   TrainStepConfig(uncond_prob=0.12, ema_decay=0.999,
                                                   normalize=False, weighted_loss=True),
                                   null_cond=torch.from_numpy(null))
    loss = port_build(torch_batch(batch), *draws)(model)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    ref = {k: v.numpy() for k, v in convert.state_dict_from_flax(model, ref_grads).items()}
    gmax = max(np.abs(r).max() for r in ref.values())
    for name, g in grads.items():
        if name.endswith("to_k.bias"):
            # zero by the math, as in the eps step above
            assert max(np.abs(g.numpy()).max(), np.abs(ref[name]).max()) <= 1e-6 * gmax, name
            continue
        assert_close_to_max(g.numpy(), ref[name], 1e-4, f"grad {name}")


@pytest.mark.parametrize("samples", ["float"])
def test_nonfinite_gate_matches_jax(jax_trainer, samples):
    """A batch with a NaN: params, moments and EMA stay where they were, on
    both sides, and the step counter advances; the next step agrees."""
    jt = jax_trainer
    state, step, _ = port_trainer(jt)
    rng = np.random.default_rng(22)
    bad, good = make_batch(rng, False), make_batch(rng, False)
    bad["sample"][1, 3, 4, 0] = np.nan
    jstate = jt["state0"]
    before = [t.clone() for t in (state.params, state.exp_avg, state.exp_avg_sq, state.ema)]
    draws, jstate, jloss = jt["step"](jstate, bad)
    loss = step(state, torch_batch(bad), *torch_draws(draws))
    assert np.isnan(float(jloss)) and torch.isnan(loss)
    adam = jstate.opt_state[0]
    assert state.step == int(jstate.step) == int(adam.count) == 1
    for now, then, tree in zip((state.params, state.exp_avg, state.exp_avg_sq, state.ema),
                               before, (jstate.params, adam.mu, adam.nu, jstate.ema_params)):
        assert torch.equal(now, then)
        np.testing.assert_array_equal(now.numpy(), port_layout(state, tree))
    draws, jstate, _ = jt["step"](jstate, good)
    step(state, torch_batch(good), *torch_draws(draws))
    assert_lr_quantum(state.params.numpy(), port_layout(state, jstate.params), "params")


@pytest.mark.parametrize("samples", ["float"])
def test_train_state_from_flax_continues_the_jax_run(jax_trainer, samples):
    """Two JAX steps, the state converted, then one more step on each side."""
    jt = jax_trainer
    rng = np.random.default_rng(23)
    jstate = jt["state0"]
    for _ in range(2):
        _, jstate, _ = jt["step"](jstate, make_batch(rng, False))
    model = Unet(**TINY, in_channels=3, context_dim=CTX_DIM, device="cpu")
    state = convert.train_state_from_flax(jstate, model, AdamW(LR))
    adam = jstate.opt_state[0]
    assert state.step == 2
    for flat, tree in ((state.params, jstate.params), (state.ema, jstate.ema_params),
                       (state.exp_avg, adam.mu), (state.exp_avg_sq, adam.nu)):
        np.testing.assert_array_equal(flat.numpy(), port_layout(state, tree))
    # the module's parameters are views of the state's buffer
    name, off, shape = state.layout[0]
    assert torch.equal(dict(model.named_parameters())[name].detach().reshape(-1),
                       state.params[off:off + shape.numel()])
    batch = make_batch(rng, False)
    _, step, _ = port_trainer(jt)
    draws, jstate, jloss = jt["step"](jstate, batch)
    loss = step(state, torch_batch(batch), *torch_draws(draws))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_lr_quantum(state.params.numpy(), port_layout(state, jstate.params), "params")
    assert_lr_quantum(state.exp_avg.numpy(), port_layout(state, jstate.opt_state[0].mu), "mu")


# --- the pieces of the step ---------------------------------------------------------

@pytest.mark.parametrize("features", [16, 32, 64, 128, 256, 512, 768, 1024, 1280])
def test_fourier_table_is_bit_exact_with_jax(features):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (features // 2,)) * 16.0)
    from flaxdiff_tpu_torch.models.common import FourierEmbedding
    np.testing.assert_array_equal(FourierEmbedding(features).freqs.numpy(), ref)


def test_unlisted_fourier_width_stays_nan():
    from flaxdiff_tpu_torch.models.common import FourierEmbedding
    assert torch.isnan(FourierEmbedding(20).freqs).all()


def test_normalize_and_cfg_splice_match_jax():
    from flaxdiff_tpu.utils import cfg_uncond_splice as jax_splice
    from flaxdiff_tpu.utils import normalize_images as jax_normalize
    rng = np.random.default_rng(24)
    img = rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(utils.normalize_images(torch.from_numpy(img)).numpy(),
                                  np.asarray(jax_normalize(img)))
    emb = rng.standard_normal((3, 5, 4)).astype(np.float32)
    null = rng.standard_normal((1, 5, 4)).astype(np.float32)
    mask = np.array([True, False, True])
    np.testing.assert_array_equal(
        utils.cfg_uncond_splice(*map(torch.from_numpy, (emb, null, mask))).numpy(),
        np.asarray(jax_splice(emb, null, mask)))
    with pytest.raises(ValueError):
        utils.cfg_uncond_splice(torch.from_numpy(emb), torch.from_numpy(null),
                                torch.ones(2, dtype=torch.bool))


@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_loss_weights_and_add_noise_match_jax(gamma):
    js = JaxCosine(timesteps=1000, p2_k=1.0, p2_gamma=gamma)
    ts = CosineNoiseSchedule(1000, p2_k=1.0, p2_gamma=gamma)
    t = np.array([0, 1, 250, 999], np.int32)
    np.testing.assert_allclose(ts.loss_weights(torch.from_numpy(t)).numpy(),
                               np.asarray(js.loss_weights(t)), rtol=1e-6)
    rng = np.random.default_rng(25)
    x0, noise = (rng.standard_normal((4, 3, 3, 2)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        ts.add_noise(*map(torch.from_numpy, (x0, noise, t))).numpy(),
        np.asarray(js.add_noise(x0, noise, t)))


def test_sample_timesteps_draws_from_the_generator():
    ts = CosineNoiseSchedule(1000)
    a = ts.sample_timesteps(torch.Generator().manual_seed(1), 4096)
    b = ts.sample_timesteps(torch.Generator().manual_seed(1), 4096)
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert int(a.min()) == 0 and int(a.max()) == 999


@pytest.mark.parametrize("name", ["EpsilonPredictionTransform", "DirectPredictionTransform",
                                  "VPredictionTransform"])
def test_prediction_transform_forward_matches_jax(name):
    from flaxdiff_tpu import predictors as jpredictors
    rng = np.random.default_rng(26)
    x0, noise = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    t = np.array([0, 321, 999], np.int32)
    ref = getattr(jpredictors, name)().forward(JaxCosine(timesteps=1000), x0, noise, t)
    out = getattr(predictors, name)().forward(CosineNoiseSchedule(1000),
                                              *map(torch.from_numpy, (x0, noise, t)))
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_trainer_draws_on_its_generator_and_counts_steps():
    """The port trainer on the CPU: seeded draws repeat, the step counter
    and get_params follow the state."""
    from flaxdiff_tpu_torch.trainer import DiffusionTrainer, TrainerConfig
    rng = np.random.default_rng(27)
    batch = make_batch(rng, True)
    losses = []
    for _ in range(2):
        model = Unet(**TINY, in_channels=3, context_dim=CTX_DIM, device="cpu")
        torch.manual_seed(0)
        model.load_state_dict({k: torch.randn_like(v) * 0.1 if k.endswith("weight") else v
                               for k, v in model.state_dict().items()})
        trainer = DiffusionTrainer(model, AdamW(1e-3), CosineNoiseSchedule(1000),
                                   EpsilonPredictionTransform(), TrainerConfig(seed=5),
                                   null_cond=torch.zeros(1, CTX_LEN, CTX_DIM), device="cpu")
        losses.append([float(trainer.train_step(batch)) for _ in range(2)])
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()
    assert trainer.state.step == 2
    live, ema = trainer.get_params(use_ema=False), trainer.get_params()
    name = next(iter(live))
    assert torch.equal(live[name], dict(trainer.state.model.named_parameters())[name])
    assert not torch.equal(live[name], ema[name])


def test_unet_loss_graph_runs_every_backward_through_its_function():
    """The tiny UNet's loss graph holds one Function node per attention,
    GroupNorm and GEGLU call, so every backward kernel runs once per call
    on the card and nothing cuts the graph at a kernel."""
    from flaxdiff_tpu_torch.ops import FlashAttentionFn, GEGLUFn, GroupNormSiLUFn
    model = Unet(**TINY, in_channels=3, context_dim=CTX_DIM, device="cpu")
    rng = np.random.default_rng(28)
    x = torch.from_numpy(rng.standard_normal((1, RES, RES, 3)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, CTX_LEN, CTX_DIM)).astype(np.float32))
    loss = model(x, torch.tensor([5.0]), ctx).square().mean()
    seen, stack, counts = set(), [loss.grad_fn], {}
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        counts[type(node).__name__] = counts.get(type(node).__name__, 0) + 1
        stack.extend(nxt for nxt, _ in node.next_functions)
    # attention at the last level: self + cross down and up, cross-only in
    # the middle; 11 res blocks with two norms each; a feed-forward per block
    assert counts.get(FlashAttentionFn._backward_cls.__name__) == 5
    assert counts.get(GroupNormSiLUFn._backward_cls.__name__) == 22
    assert counts.get(GEGLUFn._backward_cls.__name__) == 3
