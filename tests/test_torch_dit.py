"""The port's DiT (SimpleDiT, its RoPE and AdaLN-Zero layers, the scan
orders) against the JAX package, on the CPU in f32.

Every leaf of the flax side is replaced with seeded numpy values and
converted with ``convert.state_dict_from_flax``: a fresh DiT has a
zero-initialised AdaLN projection and output projection, outputs exactly 0
and has no trunk gradient. The JAX model runs as it runs on the CPU (the
eager epilogue composition) and under ``FLAXDIFF_FUSED_ADALN=interpret``
(the Pallas kernels through the interpreter); the port runs its kernels'
plain versions either way.
"""
import contextlib
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flaxdiff_tpu.models import common as jcommon
from flaxdiff_tpu.models import sfc as jsfc
from flaxdiff_tpu.models.dit import SimpleDiT as JaxDiT
from flaxdiff_tpu.models import vit_common as jvit
from flaxdiff_tpu.models.vit_common import AdaLNZero as JaxAdaLNZero
from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
from flaxdiff_tpu.samplers import DDIMSampler as JaxDDIM
from flaxdiff_tpu.samplers import DiffusionSampler as JaxSampler
from flaxdiff_tpu.schedulers import LinearNoiseSchedule as JaxLinear
from flaxdiff_tpu.trainer.train_state import TrainState as JaxTrainState
from flaxdiff_tpu.trainer.train_step import TrainStepConfig as JaxStepConfig
from flaxdiff_tpu.trainer.train_step import _make_loss_builder as jax_loss_builder
from flaxdiff_tpu.trainer.train_step import make_train_step as jax_make_train_step
from test_torch_train import assert_close_to_max
from test_torch_unet import randomize, one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch import convert
from flaxdiff_tpu_torch.models import AdaLNZero, SimpleDiT
from flaxdiff_tpu_torch.models import common as tcommon
from flaxdiff_tpu_torch.models import sfc as tsfc
from flaxdiff_tpu_torch.models import vit_common as tvit
from flaxdiff_tpu_torch.ops import FlashAttentionFn, GateResidualFn, LNModulateFn
from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule
from flaxdiff_tpu_torch.trainer import AdamW, TrainState, TrainStepConfig, make_loss_builder
from flaxdiff_tpu_torch.trainer import make_train_step

# f32 on both sides: matmuls and reductions summed in another order
MODULE_TOL = 1e-4
# the tiny DiT: 2 blocks, emb 64 over 2 heads of 32, patch 2 on 8x8x4 latents
TINY = dict(output_channels=4, patch_size=2, emb_features=64, num_layers=2, num_heads=2,
            mlp_ratio=4)
BATCH, RES, CH, CTX_LEN, CTX_DIM = 2, 8, 4, 7, 64
SCANS = {"raster": {}, "hilbert": {"use_hilbert": True}, "zigzag": {"use_zigzag": True}}
MODES = ["default", "interpret"]   # FLAXDIFF_FUSED_ADALN on the JAX side


def tiny_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, RES, RES, CH)).astype(np.float32),
            np.array([17.0, 640.0], np.float32),
            rng.standard_normal((BATCH, CTX_LEN, CTX_DIM)).astype(np.float32))


@functools.cache
def jax_shapes(**cfg):
    """The JAX model and its parameter tree's shapes, traced once per
    configuration with the epilogue kernels off (the tree is the same either
    way: the norms carry no parameters), never computed."""
    jm = JaxDiT(**TINY, **cfg)
    x, t, ctx = tiny_inputs(0)
    with _env("FLAXDIFF_FUSED_ADALN", None):
        return jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, t, ctx)["params"]


def jax_dit(seed, **cfg):
    """The JAX model and a tree of seeded leaves."""
    jm, shapes = jax_shapes(**cfg)
    return jm, randomize(shapes, seed)


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def port_dit(params, **cfg):
    tm = SimpleDiT(**TINY, **cfg, in_channels=CH, context_dim=CTX_DIM, device="cpu")
    return tm.load_flax_params(params)


def assert_grads_close(model, grads, ref_tree, what):
    """Each parameter's gradient within tol * its max|g|; gradients that are
    zero by the math (a key bias without RoPE: softmax ignores a shift shared
    by a row's logits) hold only rounding on both sides, below 1e-6 of the
    model's largest gradient."""
    ref = {k: v.numpy() for k, v in convert.state_dict_from_flax(model, ref_tree).items()}
    assert grads.keys() == ref.keys()
    gmax = max(np.abs(r).max() for r in ref.values())
    for name, g in grads.items():
        if np.abs(ref[name]).max() <= 1e-6 * gmax:
            assert np.abs(g).max() <= 1e-6 * gmax, f"{what} {name}: not ~0"
            continue
        assert_close_to_max(g, ref[name], MODULE_TOL, f"{what} grad {name}")


# --- index math and tables --------------------------------------------------------

@pytest.mark.parametrize("h,w", [(4, 4), (16, 16), (5, 7), (1, 9)])
def test_scan_indices_and_sincos_table_are_bit_exact(h, w):
    for name in ("hilbert_indices", "zigzag_indices"):
        out, ref = getattr(tsfc, name)(h, w), getattr(jsfc, name)(h, w)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(tsfc.inverse_permutation(out), jsfc.inverse_permutation(ref))
    np.testing.assert_array_equal(tsfc.build_2d_sincos_pos_embed(32, h, w),
                                  jsfc.build_2d_sincos_pos_embed(32, h, w))


def test_patchify_round_trips_like_jax():
    x, _, _ = tiny_inputs(1)
    idx = jsfc.hilbert_indices(4, 4)
    ref, ref_inv = jsfc.sfc_patchify(jnp.asarray(x), 2, idx)
    out, inv = tsfc.sfc_patchify(torch.from_numpy(x), 2, "hilbert")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(inv.numpy(), ref_inv)
    np.testing.assert_array_equal(tsfc.sfc_unpatchify(out, inv, 2, RES, RES, CH).numpy(), x)
    np.testing.assert_array_equal(tsfc.patchify(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jsfc.patchify(jnp.asarray(x), 2)))


def test_time_projection_widens_like_flax():
    """The conditioning's TimeProjection takes 16 wide and gives 64 wide, as
    flax sizes its first Dense from the input."""
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((3, 16)).astype(np.float32)
    jm = jcommon.TimeProjection(features=64)
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), emb)["params"], 3)
    tm = tcommon.TimeProjection(16, 64, device="cpu")
    tm.load_state_dict(convert.state_dict_from_flax(tm, params))
    with torch.no_grad():
        out = tm(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm.apply({"params": params}, emb)),
                               atol=MODULE_TOL, rtol=MODULE_TOL)


# --- modules ----------------------------------------------------------------------

def test_rope_attention_with_context_and_positional_encoding_match_jax():
    """Cross-attention to a longer context with the default RoPE table (sized
    to the longer sequence), and the learned positional table."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, 10, 32)).astype(np.float32)
    ctx = rng.standard_normal((BATCH, 13, 24)).astype(np.float32)
    jm = jvit.RoPEAttention(heads=2, dim_head=16)
    params = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, ctx)["params"], 7)
    tm = tvit.RoPEAttention(32, 2, 16, context_dim=24, device="cpu")
    tm.load_state_dict(convert.state_dict_from_flax(tm, params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm.apply({"params": params}, x, ctx)),
                               atol=MODULE_TOL, rtol=MODULE_TOL)
    jpe = jvit.PositionalEncoding(max_len=16, embedding_dim=32)
    pe = randomize(jax.eval_shape(jpe.init, jax.random.PRNGKey(0), x)["params"], 8)
    tpe = tvit.PositionalEncoding(16, 32, device="cpu")
    tpe.load_state_dict(convert.state_dict_from_flax(tpe, pe))
    with torch.no_grad():
        out = tpe(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jpe.apply({"params": pe}, x)), atol=1e-6)


class JaxAdaLNHolder(fnn.Module):
    """Holds the JAX AdaLNZero one level down: its own tree starts with a
    submodule named "params", which flax's apply takes for a misnested
    variables dict."""

    @fnn.compact
    def __call__(self, x, cond):
        return JaxAdaLNZero(features=64, name="ada")(x, cond)


@pytest.mark.parametrize("mode", MODES)
def test_adaln_zero_with_clip_matches_jax(monkeypatch, mode):
    """The AdaLN projection scaled so the MLP pair crosses +-10: the clip
    runs before the two-view kernel and its gradient is exact."""
    if mode == "interpret":
        monkeypatch.setenv("FLAXDIFF_FUSED_ADALN", "interpret")
    rng = np.random.default_rng(4)
    x = (1.0 + rng.standard_normal((BATCH, 12, 64))).astype(np.float32)
    cond = (4.0 * rng.standard_normal((BATCH, 64))).astype(np.float32)
    jm = JaxAdaLNHolder()
    params = randomize(jm.init(jax.random.PRNGKey(0), x, cond)["params"], 5)
    params = jax.tree_util.tree_map(lambda a: a * 3.0, params)
    tm = AdaLNZero(64, device="cpu")
    tm.load_state_dict({k.removeprefix("ada."): v
                        for k, v in convert.state_dict_from_flax(tm, params).items()})
    ref = jm.apply({"params": params}, x, cond)
    gs = [rng.standard_normal(np.shape(r)).astype(np.float32) for r in ref]
    proj = cond @ np.asarray(params["ada"]["params"]["ada_proj"]["kernel"])
    assert np.abs(proj[:, :128]).max() > 10.0, "the clip never engages"
    xt, ct = (torch.from_numpy(a).requires_grad_() for a in (x, cond))
    outs = tm(xt, ct)
    for i, (out, r) in enumerate(zip(outs, ref)):
        assert_close_to_max(out.detach().numpy(), np.asarray(r), MODULE_TOL, f"output {i}")
    loss = lambda p, a, c: sum(jnp.sum(o * g) for o, g in zip(jm.apply({"params": p}, a, c), gs))
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(params, x, cond)
    grads = torch.autograd.grad(sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, gs)),
                                [xt, ct] + list(tm.parameters()))
    assert_close_to_max(grads[0].numpy(), np.asarray(ref_grads[1]), MODULE_TOL, "dx")
    assert_close_to_max(grads[1].numpy(), np.asarray(ref_grads[2]), MODULE_TOL, "dcond")
    assert_grads_close(tm, {"ada." + n: g.numpy()
                            for (n, _), g in zip(tm.named_parameters(), grads[2:])},
                       ref_grads[0], "AdaLNZero")


# every scan order with and without learn_sigma as the JAX model runs on the
# CPU; through the interpreted Pallas kernels, each scan order once and
# learn_sigma on and off (learn_sigma changes only the tail, after the last
# kernel); each interpreted case costs ~8 s on one core.
DIT_CASES = ([(scan, sigma, "default") for scan in SCANS for sigma in (False, True)]
             + [("raster", False, "interpret"), ("hilbert", False, "interpret"),
                ("zigzag", True, "interpret")])


@pytest.mark.parametrize("scan,learn_sigma,mode", DIT_CASES,
                         ids=[f"{s}-{'learn_sigma' if ls else 'eps'}-{m}" for s, ls, m in DIT_CASES])
def test_tiny_dit_forward_and_grads_match_jax(monkeypatch, scan, learn_sigma, mode):
    cfg = dict(SCANS[scan], learn_sigma=learn_sigma)
    jm, params = jax_dit(11, **cfg)
    if mode == "interpret":
        monkeypatch.setenv("FLAXDIFF_FUSED_ADALN", "interpret")
    tm = port_dit(params, **cfg)
    x, t, ctx = tiny_inputs(12)
    g = np.random.default_rng(13).standard_normal((BATCH, RES, RES, CH)).astype(np.float32)

    def fwd_and_grads(p):
        out, vjp = jax.vjp(lambda q: jm.apply({"params": q}, x, t, ctx), p)
        return out, vjp(g)[0]

    # the interpreted kernels run ~4x faster compiled; the XLA composition
    # runs faster eagerly than it compiles
    ref, ref_grads = (jax.jit(fwd_and_grads) if mode == "interpret" else fwd_and_grads)(params)
    ref = np.asarray(ref)
    out = tm(*map(torch.from_numpy, (x, t, ctx)))
    assert out.shape == ref.shape == (BATCH, RES, RES, CH)
    assert np.abs(ref).max() > 0.1   # random weights: not the zero-init output
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=MODULE_TOL, rtol=MODULE_TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), list(tm.parameters()))
    assert_grads_close(tm, {n: gr.numpy() for (n, _), gr in zip(tm.named_parameters(), grads)},
                       ref_grads, f"{scan}/{mode}")


def test_dit_loss_graph_runs_every_epilogue_through_its_function():
    """The tiny DiT's loss graph: two LayerNorm + modulate calls, two gated
    residuals and one attention per block, each a Function node, so every
    backward kernel runs once per call on the card."""
    tm = SimpleDiT(**TINY, in_channels=CH, context_dim=CTX_DIM, device="cpu")
    loss = tm(*map(torch.from_numpy, tiny_inputs(14))).square().mean()
    seen, stack, counts = set(), [loss.grad_fn], {}
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        counts[type(node).__name__] = counts.get(type(node).__name__, 0) + 1
        stack.extend(nxt for nxt, _ in node.next_functions)
    assert counts.get(LNModulateFn._backward_cls.__name__) == 4
    assert counts.get(GateResidualFn._backward_cls.__name__) == 4
    assert counts.get(FlashAttentionFn._backward_cls.__name__) == 2


def test_unported_options_raise():
    """remat is ported (tests/test_torch_unet_variants.py holds it bit-equal);
    the training-free caches are ROADMAP.md A8."""
    assert SimpleDiT(**TINY, remat=True, device="cpu").remat
    tm = SimpleDiT(**TINY, in_channels=CH, device="cpu")
    x, t, _ = tiny_inputs(15)
    with pytest.raises(NotImplementedError, match="A8"):
        tm(torch.from_numpy(x), torch.from_numpy(t), cache_mode="record", cache_split=1)


@pytest.mark.parametrize("scan", list(SCANS))
def test_dit_state_dict_from_flax_covers_every_leaf(scan):
    """Every flax leaf lands on a port parameter and every port parameter
    (the Fourier buffer aside) comes from a flax leaf."""
    jm, params = jax_dit(16, **SCANS[scan])
    tm = SimpleDiT(**TINY, **SCANS[scan], in_channels=CH, context_dim=CTX_DIM, device="cpu")
    state = convert.state_dict_from_flax(tm, params, np.zeros(TINY["emb_features"] // 2))
    assert set(state) == set(tm.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(state) == n_leaves + 1
    for name, t in tm.state_dict().items():
        assert state[name].shape == t.shape, name


def test_dit_init_laws():
    """A fresh port DiT draws from the JAX model's laws: flax's default,
    lecun normal (std 1/sqrt(fan_in)), for the patch conv, attention, MLP
    and conditioning Denses (vit_common.py:149, dit.py:93-97); the fan-avg
    law of ``TimeProjection`` (common.py:78) for the time MLP; zeros for the
    AdaLN and output projections (vit_common.py:298, dit.py:162). Each std
    within 10% of its law."""
    torch.manual_seed(0)
    state = SimpleDiT(**TINY, in_channels=CH, context_dim=CTX_DIM, device="cpu").state_dict()
    laws = {"embed.patch_embed.proj.weight": 1 / np.sqrt(2 * 2 * CH),
            "block_0.attn.to_q.weight": 1 / np.sqrt(64),
            "block_1.attn.to_out.weight": 1 / np.sqrt(64),
            "block_0.mlp_in.weight": 1 / np.sqrt(64),
            "block_1.mlp_out.weight": 1 / np.sqrt(256),
            "cond.t_out.weight": 1 / np.sqrt(256),
            "cond.text_proj.weight": 1 / np.sqrt(CTX_DIM),
            "cond.t_proj.dense_0.weight": np.sqrt(2 / (64 + 256)),
            "cond.t_proj.dense_1.weight": np.sqrt(2 / (256 + 256))}
    for name, std in laws.items():
        got = float(state[name].std())
        assert abs(got / std - 1) < 0.1, f"{name}: std {got:.4g}, law {std:.4g}"
    for name in ("block_0.ada.ada_proj.weight", "final_proj.weight"):
        assert not state[name].any(), name
    hilbert = SimpleDiT(**TINY, use_hilbert=True, in_channels=CH, device="cpu").state_dict()
    std = float(hilbert["embed.scan_proj.weight"].std())
    assert abs(std * np.sqrt(2 * 2 * CH) - 1) < 0.1, std


# --- the slice: sampling and the train step -----------------------------------------

def test_ddim_cfg_trajectory_matches_jax():
    """4 DDIM steps with CFG 3.0 from t = 333 (from t = 999 a random-weight
    model drives every sample into the clip)."""
    jm, params = jax_dit(17)
    # a smaller output projection keeps the random model's eps near unit
    # scale, so most of x0 stays inside the clip
    params = {**params, "final_proj": jax.tree_util.tree_map(lambda a: a * 0.1,
                                                             params["final_proj"])}
    tm = port_dit(params)
    rng = np.random.default_rng(18)
    # half scale: at t = 333 the linear schedule's signal rate is ~0.57, so
    # x0 = (x - sigma eps) / signal of a unit-scale x would mostly clip
    x_init = (0.5 * rng.standard_normal((BATCH, RES, RES, CH))).astype(np.float32)
    ctx = rng.standard_normal((BATCH, CTX_LEN, CTX_DIM)).astype(np.float32)
    uncond = np.zeros_like(ctx)
    engine = JaxSampler(model_fn=lambda p, x, t, c: jm.apply({"params": p}, x, t, c),
                        schedule=JaxLinear(timesteps=1000), transform=JaxEps(),
                        sampler=JaxDDIM(), guidance_scale=3.0)
    ref = np.asarray(engine.generate_samples(
        params, num_samples=BATCH, resolution=RES, diffusion_steps=4, conditioning=ctx,
        unconditional=uncond, init_samples=jnp.asarray(x_init), start_step=333.0, channels=CH))
    sampler = DiffusionSampler(lambda x, t, c: tm(x, t, c), LinearNoiseSchedule(1000),
                               EpsilonPredictionTransform(), DDIMSampler(), guidance_scale=3.0,
                               device="cpu")
    out = sampler.generate_samples(diffusion_steps=4, init_samples=torch.from_numpy(x_init),
                                   conditioning=torch.from_numpy(ctx),
                                   unconditional=torch.from_numpy(uncond), start_step=333.0,
                                   channels=CH).numpy()
    assert (np.abs(ref) >= 1.0).mean() < 0.5 and np.abs(ref).mean() > 0.05
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)


LR = 1e-4
SEED = 18   # of the JAX state's rng: its first steps drop some samples' context


def jax_draws(state, schedule, x_shape):
    """The JAX step's own draws (train_step.py:53-84)."""
    rng = jax.random.fold_in(state.rng, state.step)
    noise_key, t_key, uncond_key, _ = jax.random.split(rng, 4)
    mask = jax.random.bernoulli(uncond_key, 0.12, (x_shape[0],))
    t = schedule.sample_timesteps(t_key, x_shape[0])
    noise = jax.random.normal(noise_key, x_shape, dtype=jnp.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (noise, t, mask))


def make_batch(rng):
    return {"sample": rng.standard_normal((BATCH, RES, RES, CH)).astype(np.float32),
            "cond": rng.standard_normal((BATCH, CTX_LEN, CTX_DIM)).astype(np.float32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_trainer():
    """The tiny DiT with seeded weights and the JAX step, jitted once."""
    jm, params = jax_dit(19)
    apply_fn = lambda p, x, t, c: jm.apply({"params": p}, x, t, c)
    cfg = JaxStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False, weighted_loss=True)
    null = np.zeros((1, CTX_LEN, CTX_DIM), np.float32)
    schedule, transform = JaxLinear(timesteps=1000), JaxEps()
    step = jax_make_train_step(apply_fn, schedule, transform, cfg, null_cond=null,
                               gate_nonfinite=True)
    build = jax_loss_builder(apply_fn, schedule, transform, cfg, None, None, null)
    # eager: one call, cheaper than compiling it
    value_and_grad = lambda st, b: jax.value_and_grad(build(st, b))(st.params)
    state0 = JaxTrainState.create(apply_fn=apply_fn, params=params, tx=optax.adamw(LR),
                                  rng=jax.random.PRNGKey(SEED), ema_decay=0.999)
    return dict(params=params, step=step, value_and_grad=value_and_grad, state0=state0,
                schedule=schedule)


def port_step():
    cfg = TrainStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False, weighted_loss=True)
    null = torch.zeros(1, CTX_LEN, CTX_DIM)
    args = (LinearNoiseSchedule(1000), EpsilonPredictionTransform(), cfg)
    return (make_train_step(*args, null_cond=null, gate_nonfinite=True),
            make_loss_builder(*args, null_cond=null))


def port_layout(state, tree):
    return state.flatten(convert.state_dict_from_flax(state.model, tree)).numpy()


def assert_lr_quantum(out, ref, what):
    """Adam turns ulp-level differences of near-zero gradients into whole
    steps of lr: every element within 3 lr, 99% within 1e-2 lr."""
    d = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 3 * LR, f"{what}: max difference {d.max():.3g} above {3 * LR:.3g}"
    share = float((d <= 1e-2 * LR).mean())
    assert share >= 0.99, f"{what}: only {share:.4f} of elements within 1e-2 lr"


def test_dit_train_step_loss_grads_and_three_steps_match_jax(jax_trainer):
    jt = jax_trainer
    state = TrainState(port_dit(jt["params"]), AdamW(LR), ema_decay=0.999)
    step, build = port_step()
    rng = np.random.default_rng(20)
    batches = [make_batch(rng) for _ in range(3)]
    jstate = jt["state0"]
    shape = (BATCH, RES, RES, CH)
    draws = jax_draws(jstate, jt["schedule"], shape)
    ref_loss, ref_grads = jt["value_and_grad"](jstate, batches[0])
    loss = build(torch_batch(batches[0]), *draws)(state.model)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(state.model.parameters()))
    assert_grads_close(state.model, {n: g.numpy() for (n, _, _), g in zip(state.layout, grads)},
                       ref_grads, "train step")
    dropped = 0
    for batch in batches:
        noise, t, mask = jax_draws(jstate, jt["schedule"], shape)
        dropped += int(mask.sum())
        jstate, jloss = jt["step"](jstate, batch)
        loss = step(state, torch_batch(batch), noise, t, mask)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert dropped > 0, "the draws never exercised the CFG splice"
    assert state.step == int(jstate.step) == 3
    assert_lr_quantum(state.params.numpy(), port_layout(state, jstate.params), "params")
    assert_lr_quantum(state.ema.numpy(), port_layout(state, jstate.ema_params), "ema")
    moved = np.abs(state.params.numpy() - port_layout(state, jt["params"]))
    assert np.median(moved) > LR, "the params barely moved: the comparison would be empty"


def test_train_state_from_flax_continues_a_jax_dit_run(jax_trainer):
    """Two JAX steps, the state converted, then one more step on each side."""
    jt = jax_trainer
    rng = np.random.default_rng(21)
    jstate = jt["state0"]
    for _ in range(2):
        jstate, _ = jt["step"](jstate, make_batch(rng))
    model = SimpleDiT(**TINY, in_channels=CH, context_dim=CTX_DIM, device="cpu")
    state = convert.train_state_from_flax(jstate, model, AdamW(LR))
    adam = jstate.opt_state[0]
    assert state.step == 2
    for flat, tree in ((state.params, jstate.params), (state.ema, jstate.ema_params),
                       (state.exp_avg, adam.mu), (state.exp_avg_sq, adam.nu)):
        np.testing.assert_array_equal(flat.numpy(), port_layout(state, tree))
    batch = make_batch(rng)
    step, _ = port_step()
    draws = jax_draws(jstate, jt["schedule"], (BATCH, RES, RES, CH))
    jstate, jloss = jt["step"](jstate, batch)
    loss = step(state, torch_batch(batch), *draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_lr_quantum(state.params.numpy(), port_layout(state, jstate.params), "params")
