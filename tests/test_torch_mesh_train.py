"""Training under a mesh (``DiffusionTrainer(mesh=...)``, the sharded flat
train state, the CLI's ``--mesh_*`` flags) on a world of 4 gloo processes,
against the one-process port step on the global batch and the JAX
package's step fed the same draws.

- 3 steps of the tiny UNet on {data: 2, fsdp: 2};
- a tiny UNet3D with ``backend="ring"`` on {data: 2, seq: 2} (the ring runs
  its spatial and temporal attention), as ``tests/test_ring_attention.py``'s
  UNet3D step does on the JAX mesh: the first step's loss and gradients,
  then 3 steps;
- the clip's global norm and lamb's per-parameter norms summed across the
  fsdp slices;
- a resume under the mesh bit-equal to the uninterrupted run, and its
  {fsdp: 2} checkpoint restored in one process;
- the CLI under ``torchrun``'s environment variables with ``--device cpu``.

Tolerances are ``tests/test_torch_train.py``'s: losses within 1e-5 (first
step) or 1e-4 relative, gradients within 1e-4 of the largest (the key
projections' biases, zero by the math, below 1e-6 of it), params and EMA
within lr quanta (Adam turns ulp-level gradient differences into whole
steps of lr). This file is its own worker (``tests/torch_world.py``).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import free_port, run_worker, spawn  # noqa: E402
if __name__ != "__main__":      # the test process (a worker imports no JAX)
    from test_torch_unet import one_torch_thread  # noqa: F401,E402 (autouse)

WORLD = 4
LR = 1e-4
UNET = dict(output_channels=3, emb_features=32, feature_depths=(16, 32),
            attention_configs=(None, {"heads": 2, "dim_head": 8, "backend": "auto"}),
            num_res_blocks=2, norm_groups=4)       # tests/test_torch_unet.py's TINY
UNET3D = dict(output_channels=3, emb_features=32, feature_depths=(8, 16),
              attention_levels=(False, True), num_res_blocks=1, heads=2, norm_groups=4)
BATCH, RES, CTX_LEN, CTX_DIM = 4, 16, 77, 12       # one row per data x fsdp rank
V_BATCH, FRAMES, V_RES, V_CTX_LEN, V_CTX_DIM = 2, 4, 8, 5, 16
STEPS = 3


# --- shared by both sides ---------------------------------------------------------

def unet_batches(seed=21, n=STEPS):
    rng = np.random.default_rng(seed)
    return [{"sample": rng.standard_normal((BATCH, RES, RES, 3)).astype(np.float32),
             "cond": rng.standard_normal((BATCH, CTX_LEN, CTX_DIM)).astype(np.float32)}
            for _ in range(n)]


def video_batches(seed=12):
    rng = np.random.default_rng(seed)
    return [{"sample": rng.standard_normal((V_BATCH, FRAMES, V_RES, V_RES, 3)).astype(np.float32),
             "cond": rng.standard_normal((V_BATCH, V_CTX_LEN, V_CTX_DIM)).astype(np.float32)}
            for _ in range(STEPS)]


def unet(path, device="cpu"):
    from flaxdiff_tpu_torch.models import Unet
    model = Unet(**UNET, in_channels=3, context_dim=CTX_DIM, device=device)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(path).items()})
    return model


def unet3d(path, backend):
    from flaxdiff_tpu_torch.models.unet3d import UNet3D
    model = UNet3D(**UNET3D, backend=backend, in_channels=3, context_dim=V_CTX_DIM, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(path).items()})
    return model


def step_fn(ctx_len, ctx_dim):
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import TrainStepConfig, make_loss_builder, make_train_step
    cfg = TrainStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False,
                          weighted_loss=True)
    null = torch.zeros(1, ctx_len, ctx_dim)
    args = (CosineNoiseSchedule(1000), EpsilonPredictionTransform(), cfg)
    return (make_train_step(*args, null_cond=null, gate_nonfinite=True),
            make_loss_builder(*args, null_cond=null))


def run_steps(state, step, batches, draws, rows=slice(None)):
    """Steps on `rows` of each batch and of its draws; the losses."""
    losses = []
    for i, batch in enumerate(batches):
        d = [torch.from_numpy(np.array(draws[f"{name}{i}"][rows])) for name in ("noise", "t", "mask")]
        losses.append(float(step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()},
                                 *d)))
    return losses


def gathered(state):
    return {k: state.gather(getattr(state, k)).numpy().copy()
            for k in ("params", "ema", "exp_avg", "exp_avg_sq")}


def trainer(path, mesh, ckdir=None):
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import AdamW, Checkpointer, DiffusionTrainer, TrainerConfig
    return DiffusionTrainer(unet(path), AdamW(LR), CosineNoiseSchedule(1000),
                            EpsilonPredictionTransform(), TrainerConfig(seed=5, normalize=False),
                            null_cond=torch.zeros(1, CTX_LEN, CTX_DIM), device="cpu",
                            checkpointer=Checkpointer(ckdir) if ckdir else None, mesh=mesh)


def cli_args(ckdir, *extra):
    model = dict(emb_features=32, feature_depths=[16, 32],
                 attention_configs=[None, {"heads": 2, "dim_head": 8}], num_res_blocks=1,
                 norm_groups=4)
    return ["--dataset", "synthetic", "--text_encoder", "hash", "--image_size", "16",
            "--batch_size", "4", "--model_config", json.dumps(model), "--dtype", "float32",
            "--optimizer", "adamw", "--lr", "1e-3", "--warmup_steps", "2", "--total_steps", "3",
            "--save_every", "2", "--log_every", "1", "--checkpoint_dir", str(ckdir),
            "--device", "cpu", "--seed", "1", *extra]


# --- the worker -----------------------------------------------------------------

def _rows(mesh, batch):
    from flaxdiff_tpu_torch.parallel import batch_shard
    block, blocks = batch_shard(mesh)
    return slice(block * batch // blocks, (block + 1) * batch // blocks)


def _case_unet(rank, world, outdir):
    from flaxdiff_tpu_torch.parallel import create_mesh
    from flaxdiff_tpu_torch.trainer import AdamW, TrainState
    mesh = create_mesh({"data": 2, "fsdp": 2})
    state = TrainState(unet(os.path.join(outdir, "unet.npz")), AdamW(LR), 0.999, mesh=mesh)
    assert state.params.numel() == -(-state.numel // 2)
    step, _ = step_fn(CTX_LEN, CTX_DIM)
    draws = np.load(os.path.join(outdir, "unet_draws.npz"))
    losses = run_steps(state, step, unet_batches(), draws, _rows(mesh, BATCH))
    out = gathered(state)
    if rank == 0:
        np.savez(os.path.join(outdir, "unet_mesh.npz"), losses=losses, **out)


def _case_unet3d_ring(rank, world, outdir):
    import flaxdiff_tpu_torch.parallel.ring_attention as ra
    from flaxdiff_tpu_torch.parallel import create_mesh, use_mesh
    from flaxdiff_tpu_torch.trainer import AdamW, TrainState
    calls = {"n": 0}
    fwd = ra.ring_forward

    def counted(*a, **k):
        calls["n"] += 1
        return fwd(*a, **k)

    ra.ring_forward = counted
    mesh = create_mesh({"data": 2, "seq": 2})
    state = TrainState(unet3d(os.path.join(outdir, "unet3d.npz"), "ring"), AdamW(LR), 0.999,
                       mesh=mesh)
    step, build = step_fn(V_CTX_LEN, V_CTX_DIM)
    draws = np.load(os.path.join(outdir, "unet3d_draws.npz"))
    rows = _rows(mesh, V_BATCH)
    batches = video_batches()
    d0 = [torch.from_numpy(draws[f"{n}0"][rows]) for n in ("noise", "t", "mask")]
    with use_mesh(mesh):
        state.gather_params()
        loss = build({k: torch.from_numpy(v[rows]) for k, v in batches[0].items()}, *d0)(
            state.model)
        grads = state.gather(state.grads(loss)).numpy()
        loss0 = float(state.mean_over_batch(loss.detach()))
        first = calls["n"]
        losses = run_steps(state, step, batches, draws, rows)
    ra.ring_forward = fwd
    np.savez(os.path.join(outdir, f"unet3d_mesh_{rank}.npz"), loss0=loss0, grads=grads,
             losses=losses, ring_calls=[first, calls["n"]], **gathered(state))


def _case_clip_lamb(rank, world, outdir):
    from flaxdiff_tpu_torch.parallel import create_mesh
    from flaxdiff_tpu_torch.telemetry.numerics import segment_norms
    from flaxdiff_tpu_torch.trainer import TrainState, chain, clip_by_global_norm, optim
    mesh = create_mesh({"data": 2, "fsdp": 2})
    state = TrainState(unet(os.path.join(outdir, "unet.npz")),
                       chain(clip_by_global_norm(0.05), optim.lamb(LR)), 0.999, mesh=mesh)
    step, build = step_fn(CTX_LEN, CTX_DIM)
    draws = np.load(os.path.join(outdir, "unet_draws.npz"))
    rows = _rows(mesh, BATCH)
    batches = unet_batches()[:2]
    d0 = [torch.from_numpy(draws[f"{n}0"][rows]) for n in ("noise", "t", "mask")]
    state.gather_params()
    shard = state.grads(build({k: torch.from_numpy(v[rows]) for k, v in batches[0].items()},
                              *d0)(state.model))
    whole = state.gather(shard)
    norms = {"global": float(state.global_norm(shard)),
             "global_whole": float(torch.linalg.vector_norm(whole)),
             "segments": state.segment_norms(state.params)[:len(state.lengths)].numpy(),
             "segments_whole": segment_norms(state.gather(state.params), state.lengths).numpy()}
    losses = run_steps(state, step, batches, draws, rows)
    out = gathered(state)           # a collective: every rank
    if rank == 0:
        np.savez(os.path.join(outdir, "clip_lamb_mesh.npz"), losses=losses, **norms, **out)


def _case_resume(rank, world, outdir):
    """4 trainer steps saving at 2 and 4; a fresh trainer restored from 2
    takes steps 3 and 4: every rank's state and generator bit-equal."""
    from flaxdiff_tpu_torch.parallel import create_mesh
    mesh = create_mesh({"data": 2, "fsdp": 2})
    path, ckdir = os.path.join(outdir, "unet.npz"), os.path.join(outdir, "ckpt")
    rows = _rows(mesh, BATCH)
    batches = [{k: v[rows] for k, v in b.items()} for b in unet_batches(31, 4)]
    a = trainer(path, mesh, ckdir)
    for i, b in enumerate(batches):
        a.train_step(b)
        if i in (1, 3):
            a.save_checkpoint()
    a.checkpointer.wait_until_finished()
    b_ = trainer(path, mesh, ckdir)
    assert b_.restore_checkpoint(2) == 2
    for b in batches[2:]:
        b_.train_step(b)
    equal = [bool(torch.equal(x, y)) for x, y in zip(a.state.buffers().values(),
                                                     b_.state.buffers().values())]
    equal.append(bool(torch.equal(a.generator.get_state(), b_.generator.get_state())))
    equal.append(a.state.step == b_.state.step == 4)
    np.save(os.path.join(outdir, f"resume_{rank}.npy"), np.array(equal))
    params = a.state.gather(a.state.params).numpy()
    if rank == 0:
        np.save(os.path.join(outdir, "resume_params.npy"), params)


def _case_cli(rank, world, outdir):
    """The CLI started as torchrun starts it: the process group from the
    environment (this world's own group torn down first)."""
    import torch.distributed as dist
    from flaxdiff_tpu_torch import train
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=os.environ["CLI_PORT"])
    ckdir = os.path.join(outdir, "cli")
    hist = train.main(cli_args(ckdir, "--mesh_fsdp", "2"))
    assert not dist.is_initialized()
    with open(os.path.join(outdir, f"cli_{rank}.json"), "w") as f:
        json.dump({"loss": hist["loss"], "steps": hist["steps"]}, f)


CASES = {"unet": _case_unet, "unet3d_ring": _case_unet3d_ring, "clip_lamb": _case_clip_lamb,
         "resume": _case_resume, "cli": _case_cli}

if __name__ == "__main__":
    run_worker(CASES)


# --- the tests ------------------------------------------------------------------

def _jax_draws(seed, shape, steps):
    """The JAX step's draws for its first `steps` steps (they depend on its
    key and step only), one program."""
    import jax
    from test_torch_train import jax_draw_arrays
    from test_torch_unet3d import StepState
    key = jax.random.PRNGKey(seed)
    draws = jax.jit(lambda k: [jax_draw_arrays(StepState(k, s, None), shape)
                               for s in range(steps)])(key)
    return {f"{name}{s}": np.asarray(a) for s, d in enumerate(draws)
            for name, a in zip(("noise", "t", "mask"), d)}


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The seeded weights (drawn over the JAX trees' shapes, converted to the
    port's names) and the JAX draws written for the world, which is then
    started; the JAX references are computed while it runs."""
    import jax
    from flaxdiff_tpu.models.unet import Unet as JaxUnet
    from flaxdiff_tpu.models.unet3d import UNet3D as JaxUNet3D
    from test_torch_unet import randomize
    from test_torch_unet_variants import load_port
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.models.common import fourier_freqs
    from flaxdiff_tpu_torch.models.unet3d import UNet3D
    outdir = str(tmp_path_factory.mktemp("mesh_world"))
    x = np.zeros((1, RES, RES, 3), np.float32)
    shapes = jax.eval_shape(lambda: JaxUnet(**UNET).init(
        jax.random.PRNGKey(0), x, np.zeros((1,), np.float32),
        np.zeros((1, CTX_LEN, CTX_DIM), np.float32)))["params"]
    params = randomize(shapes, 11)
    model = Unet(**UNET, in_channels=3, context_dim=CTX_DIM, device="cpu")
    model.load_flax_params(params, fourier_freqs(UNET["emb_features"]))
    np.savez(os.path.join(outdir, "unet.npz"), **{k: v.numpy() for k, v in
                                                  model.state_dict().items()})
    vx = np.zeros((1, FRAMES, V_RES, V_RES, 3), np.float32)
    vshapes = jax.eval_shape(JaxUNet3D(**UNET3D).init, jax.random.PRNGKey(0), vx,
                             np.zeros((1,), np.float32),
                             np.zeros((1, V_CTX_LEN, V_CTX_DIM), np.float32))["params"]
    vparams = randomize(vshapes, 13)
    vmodel = load_port(UNet3D(**UNET3D, in_channels=3, context_dim=V_CTX_DIM, device="cpu"),
                       vparams)
    np.savez(os.path.join(outdir, "unet3d.npz"), **{k: v.numpy() for k, v in
                                                    vmodel.state_dict().items()})
    draws = _jax_draws(18, (BATCH, RES, RES, 3), STEPS)
    vdraws = _jax_draws(3, (V_BATCH, FRAMES, V_RES, V_RES, 3), STEPS)
    np.savez(os.path.join(outdir, "unet_draws.npz"), **draws)
    np.savez(os.path.join(outdir, "unet3d_draws.npz"), **vdraws)
    world = spawn(os.path.abspath(__file__), WORLD, outdir, env={"CLI_PORT": str(free_port())})
    yield dict(outdir=outdir, world=world, params=params, vparams=vparams, draws=draws,
               vdraws=vdraws)
    world.kill()


def _results(prepared, name):
    prepared["world"].wait()
    return np.load(os.path.join(prepared["outdir"], name))


def _one_process(prepared, tx=None, batches=None):
    from flaxdiff_tpu_torch.trainer import AdamW, TrainState
    state = TrainState(unet(os.path.join(prepared["outdir"], "unet.npz")), tx or AdamW(LR), 0.999)
    step, _ = step_fn(CTX_LEN, CTX_DIM)
    losses = run_steps(state, step, batches or unet_batches(), prepared["draws"])
    return state, losses


def test_fsdp_unet_steps_match_one_process_and_jax(prepared):
    """3 steps on {data: 2, fsdp: 2}: the global loss and the gathered
    params, EMA and moments against the one-process port step on the
    global batch, and against JAX's ``make_train_step`` with the same
    draws."""
    import jax
    import optax
    from flaxdiff_tpu.models.unet import Unet as JaxUnet
    from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
    from flaxdiff_tpu.schedulers import CosineNoiseSchedule as JaxCosine
    from flaxdiff_tpu.trainer.train_state import TrainState as JaxTrainState
    from flaxdiff_tpu.trainer.train_step import TrainStepConfig as JaxStepConfig
    from flaxdiff_tpu.trainer.train_step import make_train_step as jax_make_train_step
    from test_torch_train import assert_lr_quantum
    from flaxdiff_tpu_torch import convert
    jm = JaxUnet(**UNET)
    apply_fn = lambda p, x, t, c: jm.apply({"params": p}, x, t, c)
    step = jax.jit(jax_make_train_step(
        apply_fn, JaxCosine(timesteps=1000), JaxEps(),
        JaxStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False, weighted_loss=True),
        null_cond=np.zeros((1, CTX_LEN, CTX_DIM), np.float32), gate_nonfinite=True))
    jstate = JaxTrainState.create(apply_fn=apply_fn, params=prepared["params"],
                                  tx=optax.adamw(LR), rng=jax.random.PRNGKey(18),
                                  ema_decay=0.999)
    jlosses = []
    for batch in unet_batches():
        jstate, loss = step(jstate, batch)
        jlosses.append(float(loss))
    state, losses = _one_process(prepared)
    layout = lambda tree: state.flatten(convert.state_dict_from_flax(state.model, tree)).numpy()
    got = _results(prepared, "unet_mesh.npz")
    np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    for name in ("params", "ema", "exp_avg", "exp_avg_sq"):
        assert_lr_quantum(got[name], getattr(state, name).numpy(), f"{name} vs one process")
    assert_lr_quantum(got["params"], layout(jstate.params), "params vs JAX")
    assert_lr_quantum(got["ema"], layout(jstate.ema_params), "ema vs JAX")


def test_ring_unet3d_on_data_and_seq_matches_one_process_and_jax(prepared):
    """{data: 2, seq: 2} with ``backend="ring"``: the ring ran, the first
    step's global loss and gradients against JAX's ``value_and_grad`` (xla
    attention) and the one-process port, 3 steps against the one-process
    port; the seq ranks of a data row end bit-equal."""
    import jax
    from flaxdiff_tpu.models.unet3d import UNet3D as JaxUNet3D
    from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
    from flaxdiff_tpu.schedulers import CosineNoiseSchedule as JaxCosine
    from flaxdiff_tpu.trainer.train_step import TrainStepConfig as JaxStepConfig
    from flaxdiff_tpu.trainer.train_step import _make_loss_builder as jax_loss_builder
    from test_torch_train import assert_close_to_max, assert_lr_quantum
    from test_torch_unet3d import StepState
    from flaxdiff_tpu_torch import convert
    from flaxdiff_tpu_torch.trainer import AdamW, TrainState
    jm = JaxUNet3D(**UNET3D)
    apply_fn = lambda p, x, t, c: jm.apply({"params": p}, x, t, c)
    cfg = JaxStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False, weighted_loss=True)
    build = jax_loss_builder(apply_fn, JaxCosine(timesteps=1000), JaxEps(), cfg, None, None,
                             np.zeros((1, V_CTX_LEN, V_CTX_DIM), np.float32))
    batches = video_batches()
    ref_loss, ref_grads = jax.jit(lambda st, b: jax.value_and_grad(build(st, b))(st.params))(
        StepState(jax.random.PRNGKey(3), 0, prepared["vparams"]), batches[0])

    state = TrainState(unet3d(os.path.join(prepared["outdir"], "unet3d.npz"), "auto"), AdamW(LR),
                       0.999)
    step, pbuild = step_fn(V_CTX_LEN, V_CTX_DIM)
    vd = prepared["vdraws"]
    loss = pbuild({k: torch.from_numpy(v) for k, v in batches[0].items()},
                  *[torch.from_numpy(np.array(vd[f"{n}0"])) for n in ("noise", "t", "mask")])(state.model)
    one_grads = state.grads(loss).numpy()
    losses = run_steps(state, step, batches, vd)
    ref = state.flatten(convert.state_dict_from_flax(state.model, ref_grads)).numpy()

    runs = [_results(prepared, f"unet3d_mesh_{r}.npz") for r in range(WORLD)]
    got = runs[0]
    first, total = got["ring_calls"]
    assert first > 0 and total > first, "the ring never ran"
    np.testing.assert_allclose(got["loss0"], float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(got["loss0"], float(loss.detach()), rtol=1e-5)
    gmax = np.abs(ref).max()
    for name, off, shape in state.layout:
        sl = slice(off, off + shape.numel())
        if np.abs(ref[sl]).max() <= 1e-6 * gmax:
            # zero by the math (a key bias without RoPE): rounding on both sides
            assert np.abs(got["grads"][sl]).max() <= 1e-6 * gmax, name
            continue
        assert_close_to_max(got["grads"][sl], ref[sl], 1e-4, f"grad {name} vs JAX")
        assert_close_to_max(got["grads"][sl], one_grads[sl], 1e-4, f"grad {name} vs one process")
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    for name in ("params", "ema", "exp_avg", "exp_avg_sq"):
        assert_lr_quantum(got[name], getattr(state, name).numpy(), f"{name} vs one process")
    for other in runs[1:]:
        for name in ("params", "ema", "exp_avg", "exp_avg_sq", "losses"):
            np.testing.assert_array_equal(other[name], got[name])


def test_clip_and_lamb_norms_sum_across_shards(prepared):
    """The clip's global norm and lamb's per-parameter norms over the fsdp
    slices equal the norms of the gathered buffers; 2 clipped lamb steps
    on {data: 2, fsdp: 2} match the one-process port."""
    from test_torch_train import assert_lr_quantum
    from flaxdiff_tpu_torch.trainer import chain, clip_by_global_norm, optim
    state, losses = _one_process(prepared, chain(clip_by_global_norm(0.05), optim.lamb(LR)),
                                 unet_batches()[:2])
    got = _results(prepared, "clip_lamb_mesh.npz")
    # f32 sums of squares in two orders (two slices' partials, or one pass)
    np.testing.assert_allclose(got["global"], got["global_whole"], rtol=1e-5)
    assert got["global"] > 0.05, "the clip never engaged"
    np.testing.assert_allclose(got["segments"], got["segments_whole"], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    for name in ("params", "exp_avg", "exp_avg_sq"):
        assert_lr_quantum(got[name], getattr(state, name).numpy(), f"{name} vs one process")


def test_resume_under_the_mesh_is_bit_equal_and_restores_in_one_process(prepared):
    """A {data: 2, fsdp: 2} trainer restored from its step-2 checkpoint
    takes steps 3 and 4 bit for bit on every rank; its step-4 checkpoint
    restores in one process with the params the shards gathered to, and
    those match one process's 4 trainer steps on the global batches."""
    from test_torch_train import assert_lr_quantum
    from flaxdiff_tpu_torch.trainer import Checkpointer
    for rank in range(WORLD):
        equal = _results(prepared, f"resume_{rank}.npy")
        assert equal.all(), (rank, equal)
    outdir = prepared["outdir"]
    params = np.load(os.path.join(outdir, "resume_params.npy"))
    one = trainer(os.path.join(outdir, "unet.npz"), None)
    state, extra = Checkpointer(os.path.join(outdir, "ckpt")).restore(4)
    one.state.load_state_dict(state)
    one.generator.set_state(extra["generator"])
    np.testing.assert_array_equal(one.state.params.numpy(), params)
    fresh = trainer(os.path.join(outdir, "unet.npz"), None)
    for b in unet_batches(31, 4):
        fresh.train_step(b)
    assert torch.equal(fresh.generator.get_state(), one.generator.get_state())
    assert_lr_quantum(params, fresh.state.params.numpy(), "params vs one process")


def test_cli_under_torchrun_environment(prepared, tmp_path):
    """``python -m flaxdiff_tpu_torch.train --mesh_fsdp 2 --device cpu`` as
    torchrun starts it on 4 ranks: every rank logs the same global losses,
    which match the one-process CLI's; rank 0 alone wrote the log, and the
    checkpoints and pipeline config are there."""
    from flaxdiff_tpu_torch import train
    one = train.main(cli_args(tmp_path / "one"))
    runs = []
    for rank in range(WORLD):
        prepared["world"].wait()
        with open(os.path.join(prepared["outdir"], f"cli_{rank}.json")) as f:
            runs.append(json.load(f))
    assert all(r == runs[0] for r in runs)
    assert runs[0]["steps"] == one["steps"] == [1, 2, 3]
    np.testing.assert_allclose(runs[0]["loss"], one["loss"], rtol=1e-4)
    ckdir = os.path.join(prepared["outdir"], "cli")
    assert sorted(os.listdir(ckdir)) == sorted(os.listdir(tmp_path / "one"))
    with open(os.path.join(ckdir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    # one writer: each window's row once, the final loss once
    assert [r["step"] for r in rows if "loss" in r] == one["steps"]
    assert sum("final_loss" in r for r in rows) == 1
