"""The port's fit loop, optimizer chain, checkpoints and data feed on the CPU,
against optax, the port's own step loop and the JAX package's ``fit``.

Inputs are made with numpy from a seed. The model is a three-conv denoiser:
these tests hold bookkeeping (fit against the step loop, resume, rollback,
checkpoints) bit for bit, which no model's numerics change, and the UNet's
numerics are held in ``tests/test_torch_train.py``.
"""
import os
import shutil
import signal

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from flaxdiff_tpu.data.dataset_map import get_dataset as jax_get_dataset
from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
from flaxdiff_tpu.schedulers import CosineNoiseSchedule as JaxCosine
from flaxdiff_tpu.trainer import DiffusionTrainer as JaxTrainer
from flaxdiff_tpu.trainer import TrainerConfig as JaxTrainerConfig

from flaxdiff_tpu_torch.data import get_dataset, iterate_batches, prefetch_map, prefetch_to_device
from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
from flaxdiff_tpu_torch.trainer import (AdamW, Checkpointer, DiffusionTrainer, TrainerConfig,
                                        TrainState, TrainStepConfig, adam, adamw, chain,
                                        clip_by_global_norm, lamb, make_train_step,
                                        warmup_cosine_decay_schedule)
from flaxdiff_tpu_torch.trainer import trainer as trainer_module

CTX_LEN, CTX_DIM, BATCH, RES = 7, 12, 2, 16


# --- the optimizer chain against optax ------------------------------------------

class _Leaves(nn.Module):
    def __init__(self, shapes, rng):
        super().__init__()
        self.p = nn.ParameterList(
            nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
            for s in shapes)


@pytest.mark.parametrize("opt", ["adamw", "adam"])
@pytest.mark.parametrize("grad_scale", [1e-3, 1e3], ids=["below_clip", "above_clip"])
def test_optimizer_chain_matches_optax(opt, grad_scale):
    """clip_by_global_norm(1.0) then adam/adamw on warmup_cosine_decay(0,
    1e-2, 3, 5), 5 updates on the same seeded gradients: both moments
    within 1e-6 relative element by element (bit for bit below the clip;
    above it the global norm is summed in another order, an ulp apart), the
    params within 1e-6 relative to the buffer's largest value, and the first
    update exactly zero (optax evaluates the schedule at the count before
    the increment). The params are held to the buffer's largest value since
    XLA's pow(0.999, 3) is an ulp off the correctly rounded one and
    1 - b2^3 carries that as 2e-5 relative into small elements."""
    rng = np.random.default_rng(40)
    shapes = [(6, 5), (5,), (3, 2, 4)]
    model = _Leaves(shapes, rng)
    params = {str(i): jnp.asarray(p.detach().numpy()) for i, p in enumerate(model.p)}
    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 5)
    ref_tx = optax.chain(optax.clip_by_global_norm(1.0), getattr(optax, opt)(schedule))
    ref_state = ref_tx.init(params)
    tx = chain(clip_by_global_norm(1.0), {"adam": adam, "adamw": adamw}[opt](
        warmup_cosine_decay_schedule(0.0, 1e-2, 3, 5)))
    state = TrainState(model, tx, ema_decay=None)
    before = state.params.clone()
    for k in range(5):
        grads = {str(i): (grad_scale * rng.standard_normal(s)).astype(np.float32)
                 for i, s in enumerate(shapes)}
        updates, ref_state = ref_tx.update(grads, ref_state, params)
        params = optax.apply_updates(params, updates)
        state.apply_gradients(state.flatten({n: grads[n.split(".")[-1]]
                                             for n, _, _ in state.layout}), None)
        if k == 0:
            assert torch.equal(state.params, before), "the first update is not zero"
    adam_state = ref_state[1][0]
    flat = lambda tree: state.flatten({n: np.array(tree[n.split(".")[-1]])
                                       for n, _, _ in state.layout}).numpy()
    assert not np.allclose(state.params.numpy(), before.numpy())
    for out, ref in ((state.exp_avg, adam_state.mu), (state.exp_avg_sq, adam_state.nu)):
        if grad_scale < 1:
            np.testing.assert_array_equal(out.numpy(), flat(ref))
        else:
            np.testing.assert_allclose(out.numpy(), flat(ref), rtol=1e-6, atol=0)
    ref = flat(params)
    np.testing.assert_allclose(state.params.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert state.step == int(adam_state.count) == 5


def test_lamb_is_not_ported():
    """lamb, once refused here, is ported: it takes optax.lamb's defaults
    (eps 1e-6, weight decay 0) and the trust ratio; its numerics are held
    against optax in tests/test_torch_train_options.py."""
    import inspect
    ref = inspect.signature(optax.lamb).parameters
    tx = lamb(1e-3)
    assert tx.trust_ratio and (tx.b1, tx.b2, tx.eps, tx.weight_decay) == tuple(
        ref[k].default for k in ("b1", "b2", "eps", "weight_decay")) == (0.9, 0.999, 1e-6, 0.0)


# --- fit against the step loop ---------------------------------------------------

def _model(seed=0):
    torch.manual_seed(seed)
    return _TorchDenoiser()


def _tx():
    return chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(0.0, 1e-3, 2, 8)))


def _trainer(depth=2, log_every=2, checkpointer=None, seed=3, **cfg):
    return DiffusionTrainer(_model(), _tx(), CosineNoiseSchedule(1000),
                            EpsilonPredictionTransform(),
                            TrainerConfig(log_every=log_every, pipeline_depth=depth, seed=seed,
                                          **cfg),
                            null_cond=torch.zeros(1, CTX_LEN, CTX_DIM), device="cpu",
                            checkpointer=checkpointer)


def _batches(n, seed=0, nan_at=None):
    """`n` uint8 batches with a text context (and a caption the step
    ignores); batch `nan_at` (0-based) is NaN everywhere."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = {"sample": rng.integers(0, 256, (BATCH, RES, RES, 3), dtype=np.uint8),
             "cond": rng.standard_normal((BATCH, CTX_LEN, CTX_DIM)).astype(np.float32),
             "text": ["bright", "dark"]}
        if i == nan_at:
            b["sample"] = np.full((BATCH, RES, RES, 3), np.nan, np.float32)
        out.append(b)
    return out


def _buffers(trainer):
    return {k: v.clone() for k, v in trainer.state.buffers().items()}


def test_fit_is_bit_equal_to_the_step_loop_at_every_depth():
    """fit over 6 batches (windows of 2) against make_train_step fed the
    same draws from a generator of the same seed: params, EMA, moments and
    every window loss bit for bit, at pipeline depth 0, 1 and 2."""
    batches = _batches(6)
    hand = _trainer()
    step = make_train_step(hand.schedule, EpsilonPredictionTransform(),
                           TrainStepConfig(uncond_prob=0.12, ema_decay=0.999),
                           null_cond=torch.zeros(1, CTX_LEN, CTX_DIM), gate_nonfinite=True)
    gen = torch.Generator().manual_seed(3)
    losses = []
    for b in batches:
        noise = torch.randn((BATCH, RES, RES, 3), generator=gen)
        t = hand.schedule.sample_timesteps(gen, BATCH)
        mask = torch.rand(BATCH, generator=gen) < 0.12
        losses.append(float(step(hand.state, {"sample": torch.from_numpy(b["sample"]),
                                              "cond": torch.from_numpy(b["cond"])},
                                 noise, t, mask)))
    for depth in (0, 1, 2):
        tr = _trainer(depth=depth)
        hist = tr.fit(iter(batches), total_steps=6)
        assert hist["steps"] == [2, 4, 6] and hist["loss"] == losses[1::2], depth
        for name, buf in _buffers(tr).items():
            assert torch.equal(buf, hand.state.buffers()[name]), (depth, name)
        assert tr.state.step == 6 and torch.equal(tr.generator.get_state(), gen.get_state())


# --- behaviour against the JAX package's fit --------------------------------------

class _JaxDenoiser(fnn.Module):
    @fnn.compact
    def __call__(self, x, t, cond=None):
        temb = fnn.Dense(8)(jnp.stack([jnp.sin(t * 0.01), jnp.cos(t * 0.01)], axis=-1))
        h = jax.nn.swish(fnn.Conv(8, (3, 3))(x) + temb[:, None, None, :])
        return fnn.Conv(x.shape[-1], (3, 3))(h)


class _TorchDenoiser(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(2, 8)
        self.conv1, self.conv2 = nn.Conv2d(3, 8, 3, padding=1), nn.Conv2d(8, 3, 3, padding=1)

    def forward(self, x, t, cond=None):
        temb = self.dense(torch.stack([torch.sin(t * 0.01), torch.cos(t * 0.01)], dim=-1))
        h = nn.functional.silu(self.conv1(x.permute(0, 3, 1, 2)) + temb[:, :, None, None])
        return self.conv2(h).permute(0, 2, 3, 1)


def _float_batches(nan_at):
    rng = np.random.default_rng(41)
    out = [{"sample": (0.1 * rng.standard_normal((8, 8, 8, 3))).astype(np.float32)}
           for _ in range(6)]
    out[nan_at]["sample"][:] = np.nan
    return out


def _record_recover(trainer, log, snapshot):
    inner = trainer._recover

    def recover(*args, **kwargs):
        log.append((kwargs.get("step"), trainer.state.step if snapshot else None))
        landed = inner(*args, **kwargs)
        log.append(landed)
        if snapshot:
            log.append({k: v.clone() for k, v in trainer.state.buffers().items()})
        return landed
    trainer._recover = recover


def test_nan_batch_rolls_back_like_the_jax_fit(mesh):
    """A NaN batch at step 4 of 6 (windows of 2), the same batches on both
    sides: both roll back at the window ending at step 4 onto the best
    state of step 2 and report the same windows; the port lands on its
    snapshot bit for bit and the gate kept every buffer finite. (Each side
    draws its own noise, so the losses are not compared.)"""
    batches = _float_batches(nan_at=3)
    model = _JaxDenoiser()
    jax_tr = JaxTrainer(
        apply_fn=lambda p, x, t, c: model.apply({"params": p}, x, t, c),
        init_fn=lambda key: model.init(key, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)))["params"],
        tx=optax.adamw(1e-3), schedule=JaxCosine(timesteps=1000), transform=JaxEps(), mesh=mesh,
        config=JaxTrainerConfig(log_every=2, normalize=False, weighted_loss=False,
                                uncond_prob=0.0))
    jax_log = []
    _record_recover(jax_tr, jax_log, snapshot=False)
    jax_hist = jax_tr.fit(iter(batches), total_steps=6)

    port = DiffusionTrainer(_TorchDenoiser(), AdamW(1e-3), CosineNoiseSchedule(1000),
                            EpsilonPredictionTransform(),
                            TrainerConfig(log_every=2, normalize=False, weighted_loss=False,
                                          uncond_prob=0.0), device="cpu")
    snapshots = []
    snap = port._snapshot_best

    def record_snapshot(loss):
        snap(loss)
        snapshots.append({k: v.clone() for k, v in port.best_state.items()})
    port._snapshot_best = record_snapshot
    port_log = []
    _record_recover(port, port_log, snapshot=True)
    hist = port.fit(iter(batches), total_steps=6)

    assert jax_log[0][0] == 4 and jax_log[1] == 2          # window of step 4, landed on 2
    assert port_log[0][1] == 4 and port_log[1] == 2
    assert hist["steps"] == jax_hist["steps"] == [2, 6]
    assert not hist["preempted"] and not jax_hist["preempted"]
    landed = port_log[2]
    assert all(torch.equal(landed[k], snapshots[0][k]) for k in snapshots[0])
    assert all(torch.isfinite(v).all() for v in port.state.buffers().values() if v is not None)
    assert np.isfinite(jax_hist["final_loss"]) and np.isfinite(hist["final_loss"])


# --- checkpoints, resume and preemption ---------------------------------------------

def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """3 steps, save, a new trainer restores and takes 3 more: the state
    and the generator equal 6 uninterrupted steps bit for bit, whether the
    caller restores or fit does (``restore_at_start``)."""
    batches = _batches(6, seed=1)
    whole = _trainer()
    whole.fit(iter(batches), total_steps=6)
    first = _trainer(checkpointer=Checkpointer(str(tmp_path / "a")))
    first.fit(iter(batches[:3]), total_steps=3, save_every=3)
    first.checkpointer.close()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    explicit = _trainer(checkpointer=Checkpointer(str(tmp_path / "a")), seed=99)
    assert explicit.restore_checkpoint() == 3
    at_start = _trainer(checkpointer=Checkpointer(str(tmp_path / "b")), seed=98,
                        restore_at_start=True)
    for second in (explicit, at_start):
        hist = second.fit(iter(batches[3:]), total_steps=3)
        second.checkpointer.close()
        assert hist["steps"] == [2, 3] and second.state.step == 6
        for name, buf in whole.state.buffers().items():
            assert torch.equal(second.state.buffers()[name], buf), name
        assert torch.equal(second.generator.get_state(), whole.generator.get_state())


def test_sigterm_checkpoints_and_returns(tmp_path):
    """A callback that sends SIGTERM at step 2: fit returns preempted with a
    checkpoint of step 2, and the previous handler is back."""
    seen = []
    mine = lambda s, f: seen.append(s)
    prev = signal.signal(signal.SIGTERM, mine)
    try:
        tr = _trainer(log_every=1, checkpointer=Checkpointer(str(tmp_path)))
        kill = lambda step, loss, m: step == 2 and os.kill(os.getpid(), signal.SIGTERM)
        hist = tr.fit(iter(_batches(6)), total_steps=6, callbacks=[kill])
        tr.checkpointer.close()
        assert hist["preempted"] and hist["steps"] == [1, 2]
        assert tr.checkpointer.all_steps() == [2] and hist["saves"]["started"] == 1
        assert seen == [signal.SIGTERM]         # the previous handler was chained
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_checkpointer_rotates_and_never_restores_a_partial_step(tmp_path, monkeypatch):
    state = TrainState(_Leaves([(4, 3)], np.random.default_rng(0)), AdamW(1e-3))
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in range(1, 6):
        state.step = step
        assert ckpt.save(step, state, {"tag": step})
    ckpt.wait_until_finished()
    assert ckpt.all_steps() == [4, 5]
    assert not ckpt.save(5, state) and ckpt.last_save_result == "skipped_exists"
    # a crashed write: a step directory without meta.json, a leftover
    # temporary directory, and a save whose write raises half way
    (tmp_path / "9").mkdir()
    (tmp_path / "9" / "state.pt").write_bytes(b"partial")
    (tmp_path / ".tmp-8-1").mkdir()

    def torn(obj, path):
        with open(path, "wb") as f:
            f.write(b"torn")
        raise OSError("disk full")
    monkeypatch.setattr(torch, "save", torn)
    state.step = 7
    assert ckpt.save(7, state)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_until_finished()
    monkeypatch.undo()
    assert ckpt.all_steps() == [4, 5] and ckpt.latest_step() == 5
    restored, extra = ckpt.restore()
    assert restored["step"] == 5 and extra["tag"] == 5
    state.params.zero_()
    state.load_state_dict(restored)
    assert state.step == 5 and state.params.abs().sum() > 0
    with pytest.raises(ValueError, match="layout"):
        TrainState(_Leaves([(3, 4)], np.random.default_rng(0)), AdamW(1e-3)).load_state_dict(
            restored)
    assert not os.path.exists(tmp_path / ".tmp-7-{}".format(os.getpid()))


# --- data ---------------------------------------------------------------------------

def test_synthetic_dataset_matches_the_jax_generator():
    ref = jax_get_dataset("synthetic", image_size=16).source.get_source()
    out = get_dataset("synthetic", image_size=16).source
    assert len(out) == len(ref) == 256
    for i in (0, 1, 77, 255):
        np.testing.assert_array_equal(out[i]["image"], ref[i]["image"])
        assert out[i]["text"] == ref[i]["text"]


def test_batch_stream_resumes_at_any_batch():
    ds = get_dataset("synthetic", image_size=8, n=40)
    whole = iterate_batches(ds, 16, seed=5)
    first = [next(whole) for _ in range(7)]         # 2 batches an epoch
    resumed = iterate_batches(ds, 16, seed=5, start_batch=3)
    for a, b in zip(first[3:], resumed):
        np.testing.assert_array_equal(a["sample"], b["sample"])
        assert a["text"] == b["text"]
    assert not np.array_equal(first[0]["sample"], first[2]["sample"])   # epochs reshuffle


def test_prefetchers_keep_order_and_raise_at_next():
    def source(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise KeyError("bad record")
            yield {"sample": np.full((2,), i, np.float32), "text": ["x"]}

    assert [int(b["sample"][0]) for b in prefetch_map(lambda b: b, source(9), depth=2)] == \
        list(range(9))
    it = prefetch_map(lambda b: b, source(5, fail_at=3), depth=1)
    assert [int(next(it)["sample"][0]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError):
        next(it)
    up = prefetch_to_device(source(6), "cpu", depth=2)
    got = [next(up) for _ in range(4)]
    assert [int(b["sample"][0]) for b in got] == [0, 1, 2, 3]
    assert set(got[0]) == {"sample"} and isinstance(got[0]["sample"], torch.Tensor)
    up.close()
    assert not up._thread.is_alive()
    with pytest.raises(StopIteration):
        next(up)
    bad = prefetch_to_device(source(4, fail_at=1), "cpu", depth=2)
    next(bad)
    with pytest.raises(KeyError):
        next(bad)
    bad.close()


def test_fit_reads_the_losses_back_once_per_window(monkeypatch):
    """The loop's one read-back: one fetch per log window."""
    calls = []
    fetch = trainer_module._fetch_losses
    monkeypatch.setattr(trainer_module, "_fetch_losses",
                        lambda w: calls.append(len(w)) or fetch(w))
    _trainer(log_every=3).fit(iter(_batches(7)), total_steps=7)
    assert calls == [3, 3, 1]
