"""The port's conditioning inputs, inference pipeline, training CLI and the
import of JAX checkpoints, on the CPU, against the JAX package.

A JAX run is a tiny UNet state with seeded numpy leaves saved by the JAX
``Checkpointer``, carried across by ``scripts/export_flax_checkpoint.py``
(which needs JAX, so this path is tested here only).
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flaxdiff_tpu.inference import DiffusionInferencePipeline as JaxPipeline
from flaxdiff_tpu.inference.pipeline import save_pipeline_config as jax_save_pipeline_config
from flaxdiff_tpu.inputs import ConditionalInputConfig as JaxConditional
from flaxdiff_tpu.inputs import DiffusionInputConfig as JaxInputConfig
from flaxdiff_tpu.inputs import HashTextEncoder as JaxHash
from flaxdiff_tpu.models.unet import Unet as JaxUnet
from flaxdiff_tpu.trainer.checkpoints import Checkpointer as JaxCheckpointer
from flaxdiff_tpu.trainer.train_state import TrainState as JaxTrainState
from test_torch_unet import START, TINY, randomize

from flaxdiff_tpu_torch import train
from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline, build_model
from flaxdiff_tpu_torch.inputs import (ConditionalInputConfig, DiffusionInputConfig,
                                       HashTextEncoder)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import export_flax_checkpoint  # noqa: E402

PROMPTS = ["a bright photo", "", "Dark  DARK dark", "w " * 90]
HASH = dict(vocab_size=64, features=12, max_length=7)   # the tiny UNet's context


def test_hash_tokenizer_and_embeddings_match_jax():
    """The md5 ids equal the JAX tokenizer's; given the JAX table, the
    embeddings agree within 1e-6."""
    ref = JaxHash.create()
    enc = HashTextEncoder(table=np.asarray(ref.model.table))
    toks, ref_toks = enc.tokenize(PROMPTS), ref.tokenize(PROMPTS)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(toks[key], ref_toks[key])
    np.testing.assert_allclose(enc(PROMPTS).numpy(), np.asarray(ref(PROMPTS)), atol=1e-6, rtol=0)
    own = HashTextEncoder()          # no table given: a seeded torch draw
    assert torch.equal(own.table, HashTextEncoder().table) and own.serialize() == ref.serialize()


def _jax_input_config():
    return JaxInputConfig(sample_data_key="sample", sample_data_shape=(16, 16, 3),
                          conditions=[JaxConditional(encoder=JaxHash.create(**HASH))])


def _config(input_config):
    return {"model": {"name": "unet", **TINY, "dtype": "float32"},
            "schedule": {"name": "cosine", "timesteps": 1000}, "predictor": "epsilon",
            "input_config": input_config.serialize(), "autoencoder": None,
            "flat_params": False}


def test_pipeline_config_reads_in_both_packages(tmp_path):
    """A config the port writes builds a JAX pipeline, and one the JAX
    package writes builds the port's: the same model, schedule, predictor
    and input config (the port takes the context width from the encoder)."""
    port_inputs = DiffusionInputConfig("sample", (16, 16, 3),
                                       [ConditionalInputConfig(HashTextEncoder(**HASH))])
    assert port_inputs.serialize() == _jax_input_config().serialize()
    config = json.loads(json.dumps({**_config(port_inputs),
                                    "model": {**_config(port_inputs)["model"],
                                              "context_dim": HASH["features"]}}))
    with pytest.warns(UserWarning, match="context_dim"):     # flax infers it
        jax_pipe = JaxPipeline.from_config(config, params={})
    assert jax_pipe.input_config.serialize() == port_inputs.serialize()
    assert type(jax_pipe.model).__name__ == "Unet" and jax_pipe.model.feature_depths == [16, 32]

    jax_save_pipeline_config(str(tmp_path), _config(_jax_input_config()))
    config = json.loads((tmp_path / "pipeline_config.json").read_text())
    pipe = DiffusionInferencePipeline.from_config(config, params={}, device="cpu")
    assert pipe.input_config.serialize() == _jax_input_config().serialize()
    assert pipe.model.feature_depths == (16, 32)
    assert pipe.input_config.get_unconditionals(3)[0].shape == (3, 7, 12)


def test_registry_builds_what_is_ported_and_names_the_rest():
    dit = build_model("simple_dit+hilbert", device="cpu", patch_size=2, emb_features=16,
                      num_layers=1, num_heads=1)
    assert dit.scan_order == "hilbert"
    for name, item in (("uvit", "A7"), ("unet_3d", "A9"), ("simple_mmdit+2d", "A7")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            build_model(name, device="cpu")
    with pytest.raises(TypeError):
        build_model("unet", device="cpu", feature_depths=(8,), norm_groups=2, conv_type="w_conv")


# --- a JAX checkpoint in the port --------------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A tiny text-conditional UNet's state with seeded numpy leaves (EMA
    distinct from the params), saved by the JAX Checkpointer with its
    pipeline config, and exported for the port."""
    root = tmp_path_factory.mktemp("jax_run")
    run, out = root / "run", root / "export"
    jm = JaxUnet(**TINY)
    shapes = (np.zeros((1, 16, 16, 3), np.float32), np.zeros((1,), np.float32),
              np.zeros((1, HASH["max_length"], HASH["features"]), np.float32))
    init = jm.init(jax.random.PRNGKey(0), *shapes)["params"]
    params, ema = randomize(init, 31), randomize(init, 32)
    # the state as the JAX CLI keeps it: flax variables dicts ({"params": tree})
    state = JaxTrainState.create(apply_fn=None, params={"params": params},
                                 tx=optax.adamw(1e-4), rng=jax.random.PRNGKey(0),
                                 ema_decay=0.999)
    state = state.replace(ema_params={"params": ema}, step=jnp.asarray(7, state.step.dtype))
    ckpt = JaxCheckpointer(str(run))
    ckpt.save(7, state, meta={"best_loss": 1.0})
    ckpt.wait_until_finished()
    ckpt.close()
    inputs = _jax_input_config()
    jax_save_pipeline_config(str(run), _config(inputs))
    info = export_flax_checkpoint.export(str(run), str(out))
    return dict(jm=jm, params=params, ema=ema, run=run, out=out, info=info,
                encoder=inputs.conditions[0].encoder)


def test_export_writes_every_file(exported):
    assert exported["info"] == {"step": 7, "files": ["params.npz", "ema_params.npz",
                                                     "hash_table.npy", "pipeline_config.json"]}
    np.testing.assert_array_equal(np.load(exported["out"] / "hash_table.npy"),
                                  np.asarray(exported["encoder"].model.table))


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_exported_unet_matches_flax_apply(exported, use_ema):
    """The model from ``from_flax_export`` against ``model.apply`` on the
    restored tree: within 1e-4."""
    pipe = DiffusionInferencePipeline.from_flax_export(str(exported["out"]), device="cpu")
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([13.0, 801.0], np.float32)
    ctx = np.asarray(exported["encoder"](["bright", "dark"]))
    tree = exported["ema" if use_ema else "params"]
    ref = np.asarray(exported["jm"].apply({"params": tree}, x, t, ctx))
    pipe._load(use_ema)
    with torch.no_grad():
        out = pipe.model(*map(torch.from_numpy, (x, t, np.array(ctx)))).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_exported_ddim_cfg_trajectory_matches_jax(exported):
    """DDIM-3 with CFG 3.0 on prompts from the same initial samples (the JAX
    engine's inputs handed to the port; DDIM draws nothing else), from
    t = 333: the JAX pipeline restored from the orbax run against the port's
    from the export, within 1e-3."""
    jax_pipe = JaxPipeline.from_checkpoint(str(exported["run"]))
    pipe = DiffusionInferencePipeline.from_flax_export(str(exported["out"]), device="cpu")
    x_init = np.random.default_rng(34).standard_normal((2, 16, 16, 3)).astype(np.float32)
    prompts = ["bright", "dark"]
    cond = np.asarray(jax_pipe.input_config.conditions[0].encoder(prompts))
    uncond = np.asarray(jax_pipe.input_config.get_unconditionals(2)[0])
    ref = np.asarray(jax_pipe.get_sampler("ddim", 3.0).generate_samples(
        jax_pipe.ema_params, num_samples=2, resolution=16, diffusion_steps=3,
        conditioning=cond, unconditional=uncond, init_samples=jnp.asarray(x_init),
        start_step=START))
    pipe._load(use_ema=True)
    enc = pipe.input_config.conditions[0].encoder
    out = pipe.get_sampler("ddim", 3.0).generate_samples(
        num_samples=2, resolution=16, diffusion_steps=3, conditioning=enc(prompts),
        unconditional=pipe.input_config.get_unconditionals(2)[0],
        init_samples=torch.from_numpy(x_init), start_step=START).numpy()
    assert (np.abs(ref) >= 1.0).mean() < 0.5 and np.abs(ref).mean() > 0.05
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)
    assert pipe.get_sampler("ddim", 3.0) is pipe.get_sampler("ddim", 3.0)
    assert pipe.get_sampler("ddim", 3.0) is not pipe.get_sampler("ddim", 1.0)


# --- the CLI ------------------------------------------------------------------------

def _cli(ckpt_dir, total, *extra):
    model = dict(emb_features=32, feature_depths=[16, 32],
                 attention_configs=[None, {"heads": 2, "dim_head": 8}], num_res_blocks=1,
                 norm_groups=4)
    return ["--dataset", "synthetic", "--text_encoder", "hash", "--image_size", "16",
            "--batch_size", "4", "--model_config", json.dumps(model), "--dtype", "float32",
            "--optimizer", "adamw", "--lr", "1e-3", "--warmup_steps", "2",
            "--total_steps", str(total), "--save_every", "2", "--log_every", "2",
            "--checkpoint_dir", str(ckpt_dir), "--device", "cpu", "--seed", "1", *extra]


def test_cli_trains_resumes_and_serves_prompts(tmp_path, capsys):
    """A 6-step run stopped after 4 (checkpoints at 2 and 4), then the CLI
    resumes from step 4 and trains to 6: bit-equal to six uninterrupted
    steps (state, and the data stream resumed at its batch); then the
    pipeline samples from the newest checkpoint with prompts."""
    run = train.make_run(_cli(tmp_path / "a", 6))
    hist = run.trainer.fit(run.batches(0), total_steps=4, save_every=2)
    run.trainer.checkpointer.close()
    assert hist["steps"] == [2, 4] and all(np.isfinite(hist["loss"]))
    hist = train.main(_cli(tmp_path / "a", 6))
    assert "resumed from step 4" in capsys.readouterr().out and hist["steps"] == [2]
    train.main(_cli(tmp_path / "b", 6))
    resumed = train.make_run(_cli(tmp_path / "a", 6)).trainer
    whole = train.make_run(_cli(tmp_path / "b", 6)).trainer
    assert resumed.state.step == whole.state.step == 6
    for name, buf in whole.state.buffers().items():
        assert torch.equal(resumed.state.buffers()[name], buf), name
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "2", "4", "6", "hash_table.npy", "pipeline_config.json"]

    pipe = DiffusionInferencePipeline.from_checkpoint(str(tmp_path / "a"), device="cpu")
    out = pipe.generate_samples(resolution=16, diffusion_steps=2, sampler="ddim",
                                guidance_scale=3.0, prompts=["bright", "dark"], seed=3)
    again = pipe.generate_samples(resolution=16, diffusion_steps=2, sampler="ddim",
                                  guidance_scale=3.0, prompts=["bright", "dark"], seed=3)
    assert out.shape == (2, 16, 16, 3) and np.isfinite(out).all() and np.abs(out).max() <= 1
    np.testing.assert_array_equal(out, again)
    config = json.loads((tmp_path / "a" / "pipeline_config.json").read_text())
    assert config["model"]["context_dim"] == 64 and config["input_config"]["conditions"][0][
        "encoder"] == {"type": "hash", "vocab_size": 4096, "features": 64, "max_length": 77}


@pytest.mark.parametrize("flag", [["--mesh_fsdp", "2"], ["--text_encoder", "clip"],
                                  ["--grad_accum", "2"], ["--dataset", "oxford_flowers102"]])
def test_cli_refuses_what_is_not_ported(tmp_path, flag):
    with pytest.raises(SystemExit):
        train.parse_args(_cli(tmp_path, 2, *flag))


def test_cli_lamb_names_the_roadmap(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train.make_run(_cli(tmp_path, 2, "--optimizer", "lamb"))
