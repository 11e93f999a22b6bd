"""The port's conditioning inputs, inference pipeline, training CLI and the
import of JAX checkpoints, on the CPU, against the JAX package.

A JAX run is a tiny UNet state with seeded numpy leaves saved by the JAX
``Checkpointer``, carried across by ``scripts/export_flax_checkpoint.py``
(which needs JAX, so this path is tested here only).
"""
import json
import re
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
    """Every 2D family builds (``+2d`` reaches the hybrid SSM DiT and, as in
    JAX, is dropped with a warning by a model without it); ``unet_3d`` names
    its ROADMAP item."""
    dit = build_model("simple_dit+hilbert", device="cpu", patch_size=2, emb_features=16,
                      num_layers=1, num_heads=1)
    assert dit.scan_order == "hilbert"
    assert type(build_model("uvit", device="cpu", patch_size=2, emb_features=16, num_layers=2,
                            num_heads=2)).__name__ == "UViT"
    with pytest.warns(UserWarning, match="use_2d_fusion"):
        mm = build_model("simple_mmdit+2d", device="cpu", patch_size=2, emb_features=16,
                         num_layers=1, num_heads=2)
    assert type(mm).__name__ == "SimpleMMDiT"
    ssm = build_model("hybrid_ssm+zigzag+2d", device="cpu", patch_size=2, emb_features=16,
                      num_layers=2, num_heads=2, ssm_state_dim=4)
    assert ssm.scan_order == "zigzag" and ssm.ssm_block_0.spatial_fusion is not None
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        build_model("unet_3d", device="cpu")
    with pytest.raises(ValueError, match="common.py:119"):
        build_model("unet", device="cpu", feature_depths=(8,), norm_groups=2, conv_type="w_conv")


# each registered name at tiny widths, with its suffixes where the JAX model takes them
TINY_MODELS = {
    "unet": dict(emb_features=16, feature_depths=(8, 16), num_res_blocks=1, norm_groups=4,
                 attention_configs=[None, {"heads": 2, "dim_head": 8}]),
    "uvit+hilbert": dict(patch_size=2, emb_features=16, num_layers=2, num_heads=2),
    "simple_dit+zigzag": dict(patch_size=2, emb_features=16, num_layers=1, num_heads=2),
    "simple_udit+hilbert": dict(patch_size=2, emb_features=16, num_layers=2, num_heads=2),
    "simple_mmdit+hilbert": dict(patch_size=2, emb_features=16, num_layers=1, num_heads=2),
    "hierarchical_mmdit+hilbert": dict(base_patch_size=2, emb_features=(16, 32),
                                       num_layers=(1, 1), num_heads=(2, 2)),
    "hybrid_ssm+hilbert+2d": dict(patch_size=2, emb_features=16, num_layers=2, num_heads=2,
                                  ssm_state_dim=4),
}
# C2's keys, at the JAX defaults and as the strings a config holds
C2_VALUES = [dict(dtype="float32", precision=None, activation="swish", remat=False,
                  conv_type="conv", fused_epilogues=True, force_fp32_for_softmax=True),
             dict(dtype="bfloat16", precision="highest", activation="gelu", remat=True,
                  conv_type="separable", fused_epilogues=False,
                  force_fp32_for_softmax=False)]


def test_the_port_knows_each_jax_models_keys():
    """The port's copy of each JAX model's field list equals the JAX
    dataclass's (flax's parent and name aside)."""
    from flaxdiff_tpu.inference.registry import MODEL_REGISTRY as JAX_REGISTRY
    from flaxdiff_tpu_torch.inference.registry import JAX_FIELDS, MODEL_REGISTRY
    assert set(JAX_FIELDS) == set(MODEL_REGISTRY) == set(JAX_REGISTRY) - {"unet_3d"}
    for name, fields in JAX_FIELDS.items():
        jax_fields = [f for f in JAX_REGISTRY[name].__dataclass_fields__
                      if f not in ("parent", "name")]
        assert list(fields) == jax_fields, name


@pytest.mark.parametrize("values", C2_VALUES, ids=["defaults", "strings"])
@pytest.mark.parametrize("name", list(TINY_MODELS))
def test_build_model_takes_c2_keys_like_jax(name, values):
    """Each of C2's keys that the JAX model has is honoured, at its default
    and at another string value; the ones it lacks, and an unknown key, are
    dropped with a warning naming them, as the JAX registry does."""
    from flaxdiff_tpu.inference.registry import MODEL_REGISTRY as JAX_REGISTRY
    base = name.split("+")[0]
    fields = set(JAX_REGISTRY[base].__dataclass_fields__)
    kwargs = {**TINY_MODELS[name], **values, "no_such_key": 1}
    lacking = sorted(k for k in kwargs if k not in fields)
    with pytest.warns(UserWarning, match=re.escape(str(lacking))):
        model = build_model(name, device="cpu", context_dim=12, **kwargs)
    if "remat" in fields:
        assert model.remat == values["remat"]
    if "fused_epilogues" in fields:
        blocks = [m for m in model.modules() if hasattr(m, "fused")]
        assert blocks and all(m.fused == values["fused_epilogues"] for m in blocks)
    if base == "unet":
        assert model.down_0_res_0.conv1.conv_type == model.conv_in.conv_type == values[
            "conv_type"]
    if "activation" in fields and base != "uvit":
        from flaxdiff_tpu_torch.typing import ACTIVATION_MAP
        acts = {m.activation for m in model.modules() if hasattr(m, "activation")}
        assert acts == {ACTIVATION_MAP[values["activation"]]}, acts
    dt = torch.bfloat16 if values["dtype"] == "bfloat16" else torch.float32
    x = torch.randn(1, 8, 8, 3, dtype=dt)
    out = model(x, torch.tensor([5.0]), torch.randn(1, 4, 12))
    assert out.shape == (1, 8, 8, 3) and torch.isfinite(out).all()


# a scan order reaches sfc's device indices, and +2d the SSM's re-permutes
SCAN_ORDER_MODELS = {"simple_dit+hilbert": TINY_MODELS["simple_dit+zigzag"],
                     **{k: TINY_MODELS[k] for k in ("uvit+hilbert", "simple_mmdit+hilbert",
                                                    "hybrid_ssm+hilbert+2d")}}


@pytest.mark.parametrize("name", list(SCAN_ORDER_MODELS))
def test_a_scan_order_model_trains_after_sampling(name):
    """One DDIM request, which runs under inference mode, then one training
    step of the same model in the same process: the scan-order indices the
    request uploaded and cached serve the step's backward (they are not
    inference tensors)."""
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DiffusionSampler, get_sampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import AdamW, DiffusionTrainer, TrainerConfig
    model = build_model(name, device="cpu", in_channels=3, context_dim=8,
                        **SCAN_ORDER_MODELS[name])
    null = torch.zeros(1, 4, 8)
    DiffusionSampler(model, CosineNoiseSchedule(1000), EpsilonPredictionTransform(),
                     get_sampler("ddim"), device="cpu").generate_samples(
        1, 8, 2, conditioning=null, unconditional=null)
    trainer = DiffusionTrainer(model, AdamW(1e-3), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(), TrainerConfig(seed=1),
                               null_cond=null, device="cpu")
    rng = np.random.default_rng(0)
    loss = trainer.train_step({"sample": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
                               "cond": rng.standard_normal((2, 4, 8)).astype(np.float32)})
    assert np.isfinite(float(loss))


def test_a_jax_config_with_c2_keys_loads(tmp_path):
    """A pipeline_config.json the JAX package writes, naming C2's keys,
    builds the port's pipeline."""
    model = {"name": "unet", **TINY, "dtype": "float32", "activation": "swish",
             "precision": "default", "conv_type": "conv", "remat": True}
    model["attention_configs"] = [None, {"heads": 2, "dim_head": 8,
                                         "force_fp32_for_softmax": True}]
    jax_save_pipeline_config(str(tmp_path), {**_config(_jax_input_config()), "model": model})
    config = json.loads((tmp_path / "pipeline_config.json").read_text())
    JaxPipeline.from_config(config, params={})
    pipe = DiffusionInferencePipeline.from_config(config, params={}, device="cpu")
    assert pipe.model.remat and pipe.model.feature_depths == (16, 32)


# --- a JAX checkpoint in the port --------------------------------------------------

def _save_jax_run(run, params, ema, config, flat=False):
    """A JAX CLI run of `params`/`ema` at step 7 in `run`: the state as the
    CLI keeps it (flax variables dicts, {"params": tree}), saved by the JAX
    Checkpointer with `config` as its pipeline config. With `flat`, the
    flat-params layout (``TrainerConfig.flat_params``): one vector per
    dtype, and the template beside it that the export unflattens with."""
    from flaxdiff_tpu.trainer.optim import (TEMPLATE_FILENAME, flatten_params,
                                            param_template, serialize_template)
    params, ema = {"params": params}, {"params": ema}
    if flat:
        (run / TEMPLATE_FILENAME).parent.mkdir(parents=True, exist_ok=True)
        (run / TEMPLATE_FILENAME).write_text(json.dumps(serialize_template(
            param_template(params))))
        params, ema = flatten_params(params, 128), flatten_params(ema, 128)
    state = JaxTrainState.create(apply_fn=None, params=params, tx=optax.adamw(1e-4),
                                 rng=jax.random.PRNGKey(0), ema_decay=0.999)
    state = state.replace(ema_params=ema, step=jnp.asarray(7, state.step.dtype))
    ckpt = JaxCheckpointer(str(run))
    ckpt.save(7, state, meta={"best_loss": 1.0})
    ckpt.wait_until_finished()
    ckpt.close()
    jax_save_pipeline_config(str(run), {**config, "flat_params": flat})


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
    inputs = _jax_input_config()
    _save_jax_run(run, params, ema, _config(inputs))
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


MMDIT = dict(output_channels=3, patch_size=2, emb_features=16, num_layers=2, num_heads=2)


@pytest.mark.parametrize("family", ["unet-flat_params", "simple_mmdit"])
def test_other_exports_serve_and_match_flax_apply(tmp_path, family):
    """A flat-params JAX run (the export unflattens it with its template;
    ``from_config`` alone takes such a config too, since the port's state
    is flat in every run) and a run of another family, SimpleMMDiT:
    ``from_flax_export`` builds the model and its EMA output matches
    ``model.apply`` within 1e-4."""
    from flaxdiff_tpu.models.mmdit import SimpleMMDiT as JaxMMDiT
    inputs = _jax_input_config()
    x = np.random.default_rng(35).standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([13.0, 801.0], np.float32)
    ctx = np.asarray(inputs.conditions[0].encoder(["bright", "dark"]))
    if family == "simple_mmdit":
        jm, model = JaxMMDiT(**MMDIT), {"name": "simple_mmdit", **MMDIT}
    else:
        jm, model = JaxUnet(**TINY), _config(inputs)["model"]
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, t, ctx)["params"]
    params, ema = randomize(init, 36), randomize(init, 37)
    config = {**_config(inputs), "model": model}
    _save_jax_run(tmp_path / "run", params, ema, config, flat=family != "simple_mmdit")
    export_flax_checkpoint.export(str(tmp_path / "run"), str(tmp_path / "out"))
    if family != "simple_mmdit":
        saved = json.loads((tmp_path / "out" / "pipeline_config.json").read_text())
        assert saved["flat_params"]
        built = DiffusionInferencePipeline.from_config(saved, params={}, device="cpu")
        assert built.model is not None
    pipe = DiffusionInferencePipeline.from_flax_export(str(tmp_path / "out"), device="cpu")
    ref = np.asarray(jm.apply({"params": ema}, x, t, ctx))
    pipe._load(use_ema=True)
    with torch.no_grad():
        out = pipe.model(*map(torch.from_numpy, (x, t, ctx))).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    samples = pipe.generate_samples(resolution=16, diffusion_steps=2, sampler="ddim",
                                    guidance_scale=3.0, prompts=["bright", "dark"], seed=3)
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()


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


# --grad_accum, once refused here, is ported (tests/test_torch_train_options.py);
# --telemetry_dir (A14) takes its place
@pytest.mark.parametrize("flag", [["--mesh_fsdp", "2"], ["--text_encoder", "clip"],
                                  ["--telemetry_dir", "tel"], ["--dataset", "oxford_flowers102"]])
def test_cli_refuses_what_is_not_ported(tmp_path, flag):
    with pytest.raises(SystemExit):
        train.parse_args(_cli(tmp_path, 2, *flag))


def test_cli_lamb_names_the_roadmap(tmp_path):
    """``--optimizer lamb``, once refused naming ROADMAP.md, builds the
    clip + lamb chain now; what the CLI still refuses names its item."""
    run = train.make_run(_cli(tmp_path / "a", 2, "--optimizer", "lamb"))
    assert run.trainer.state.tx.adam.trust_ratio and run.trainer.state.tx.adam.eps == 1e-6
    with pytest.raises(SystemExit, match="ROADMAP.md A10"):
        train.make_run(_cli(tmp_path / "b", 2, "--val_every", "2", "--val_metrics", "fid"))
