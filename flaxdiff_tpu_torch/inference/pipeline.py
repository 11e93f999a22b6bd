"""DiffusionInferencePipeline (counterpart of
``flaxdiff_tpu/inference/pipeline.py:48-340``): rebuild the model from the
config dict the training CLI saves beside its checkpoints, load the
parameters, and generate with samplers cached per configuration.

A latent model's codec (``models/autoencoder.py``: ``SDVAE.from_npz(...)``,
``KLAutoEncoder.create(...)``) is passed in, never rebuilt from the config,
as in the JAX package; samples come back decoded.

``generate_samples(..., cache_plan=)`` serves a request through the
training-free caches (a ``CachePlan``, ``SpatialPlan`` or ``ComposedPlan``;
docs/CACHING.md) and counts its steps on the global hub's ``diffcache/*``
counters.

``from_registry`` loads the best run of a ``ModelRegistry``. It runs on the
card unless given ``device="cpu"``. ``from_wandb_run`` is not ported: wandb
is not installed on the port's machines.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..inputs import DiffusionInputConfig
from ..predictors import TRANSFORM_REGISTRY, PredictionTransform
from ..samplers import SAMPLER_REGISTRY, DiffusionSampler, Sampler
from ..schedulers import get_schedule
from .registry import build_model

CONFIG_FILENAME = "pipeline_config.json"
HASH_TABLE_FILENAME = "hash_table.npy"
EXPORT_FILES = ("params.npz", "ema_params.npz")


def _sampler_cache_key(sampler: Sampler, guidance_scale: float) -> Tuple:
    """The sampler's class and every setting: DDIMSampler(eta=0) and
    DDIMSampler(eta=1) must not share an engine (pipeline.py:29-46)."""
    return (type(sampler), tuple(sorted((k, repr(v)) for k, v in vars(sampler).items())),
            float(guidance_scale))


def _load_table(directory: str) -> Optional[np.ndarray]:
    path = os.path.join(directory, HASH_TABLE_FILENAME)
    return np.load(path) if os.path.exists(path) else None


def save_pipeline_config(checkpoint_dir: str, config: Dict[str, Any]) -> None:
    """Write the config dict the pipeline rebuilds from, in the JAX
    package's file name and format."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, CONFIG_FILENAME), "w") as f:
        json.dump(config, f, indent=2)


class DiffusionInferencePipeline:
    """The model, its parameters (and EMA), the diffusion math and the input
    config; one ``DiffusionSampler`` per (sampler and settings, guidance
    scale). `params` / `ema_params`: the model's state dicts."""

    def __init__(self, model: torch.nn.Module, params: Dict[str, torch.Tensor], schedule,
                 transform: PredictionTransform,
                 input_config: Optional[DiffusionInputConfig] = None,
                 ema_params: Optional[Dict[str, torch.Tensor]] = None,
                 config: Optional[Dict[str, Any]] = None, device: DeviceLike = None,
                 autoencoder=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.autoencoder = None if autoencoder is None else autoencoder.to(self.device)
        self.params, self.ema_params = params, ema_params
        self.schedule = schedule
        self.transform = transform
        self.input_config = input_config
        self.config = config or {}
        self._sampler_cache: Dict[Tuple, DiffusionSampler] = {}
        self._loaded: Optional[Dict[str, torch.Tensor]] = None

    # -- construction ------------------------------------------------------------

    @staticmethod
    def from_config(config: Dict[str, Any], params: Dict[str, torch.Tensor],
                    ema_params: Optional[Dict[str, torch.Tensor]] = None,
                    hash_table: Optional[np.ndarray] = None,
                    device: DeviceLike = None,
                    autoencoder=None) -> "DiffusionInferencePipeline":
        """config = {"model": {"name": ..., **kwargs}, "schedule": {"name":
        ..., **kwargs}, "predictor": name, "input_config": ...}, as either
        package's CLI writes it. A text-conditional model's context width,
        which flax infers and torch must be told, comes from the encoder's
        when the config does not give it; with `autoencoder`, the model's
        input channels are its latent channels unless the config says.
        A config trained with a codec (its "autoencoder" entry) needs the
        codec passed here."""
        device = resolve_device(device)
        if config.get("autoencoder") and autoencoder is None:
            warnings.warn(f"the run trained in a {config['autoencoder'].get('name')} codec's "
                          "latent space: pass autoencoder= to decode its samples",
                          stacklevel=2)
        input_config = None
        if config.get("input_config"):
            input_config = DiffusionInputConfig.deserialize(config["input_config"],
                                                            table=hash_table)
        model_cfg = dict(config["model"])
        if input_config is not None and input_config.conditions:
            model_cfg.setdefault("context_dim", input_config.conditions[0].encoder.features)
        if autoencoder is not None:
            model_cfg.setdefault("in_channels", autoencoder.latent_channels)
        model = build_model(model_cfg.pop("name"), device=device, **model_cfg)
        sched_cfg = dict(config.get("schedule", {"name": "cosine"}))
        schedule = get_schedule(sched_cfg.pop("name"), **sched_cfg)
        pred_name = config.get("predictor", "epsilon")
        if pred_name not in TRANSFORM_REGISTRY:
            raise ValueError(f"unknown predictor {pred_name!r}")
        return DiffusionInferencePipeline(
            model=model, params=params, ema_params=ema_params, schedule=schedule,
            transform=TRANSFORM_REGISTRY[pred_name](), input_config=input_config,
            config=config, device=device, autoencoder=autoencoder)

    @staticmethod
    def from_checkpoint(checkpoint_dir: str, step: Optional[int] = None,
                        device: DeviceLike = None,
                        autoencoder=None) -> "DiffusionInferencePipeline":
        """The config, the hash encoder's table and the train state saved by
        the port's training CLI (``flaxdiff_tpu_torch.train``), at `step`
        (default: the newest). The state is flat in every run, so a run
        trained with ``--flat_params`` loads as any other."""
        from ..trainer.checkpoints import Checkpointer
        with open(os.path.join(checkpoint_dir, CONFIG_FILENAME)) as f:
            config = json.load(f)
        ckpt = Checkpointer(checkpoint_dir)
        state, _ = ckpt.restore(step)
        ckpt.close()

        def named(flat):
            if flat is None:
                return None
            out, off = {}, 0
            for name, shape in state["layout"]:
                n = int(np.prod(shape, dtype=np.int64))
                out[name] = flat[off:off + n].view(shape)
                off += n
            return out

        return DiffusionInferencePipeline.from_config(
            config, named(state["params"]), named(state["ema"]),
            hash_table=_load_table(checkpoint_dir), device=device, autoencoder=autoencoder)

    @staticmethod
    def from_registry(registry_path: str, metric: str = "loss", device: DeviceLike = None,
                      autoencoder=None) -> "DiffusionInferencePipeline":
        """The best run for `metric` of a ``ModelRegistry`` (its
        ``registry.json``, as either package writes it): the checkpoint of the
        step that achieved the best value while it is still on disk (a
        rotated-out step warns and loads the newest)."""
        from ..trainer.checkpoints import Checkpointer
        from ..trainer.registry import ModelRegistry
        best = ModelRegistry(registry_path).best_run(metric)
        if best is None:
            raise FileNotFoundError(f"registry {registry_path} has no best run for metric "
                                    f"{metric!r}")
        ck = Checkpointer(best["checkpoint_dir"])
        steps = ck.all_steps()
        ck.close()
        step = best.get("step") if best.get("step") in steps else None
        if step is None and best.get("step") is not None:
            warnings.warn(f"registry best step {best['step']} no longer on disk under "
                          f"{best['checkpoint_dir']}; loading latest", stacklevel=2)
        return DiffusionInferencePipeline.from_checkpoint(
            best["checkpoint_dir"], step=step, device=device, autoencoder=autoencoder)

    @staticmethod
    def from_flax_export(export_dir: str, device: DeviceLike = None,
                         autoencoder=None) -> "DiffusionInferencePipeline":
        """A JAX run written out by ``scripts/export_flax_checkpoint.py``:
        ``pipeline_config.json``, ``params.npz`` and ``ema_params.npz`` (the
        flax tree's leaves under "/"-joined paths) and the hash table, for
        any ported model, converted by ``convert.state_dict_from_flax``. A flat-params run loads too: the
        export wrote its structured tree."""
        from .. import convert
        with open(os.path.join(export_dir, CONFIG_FILENAME)) as f:
            config = json.load(f)
        trees = []
        for fname in EXPORT_FILES:
            path = os.path.join(export_dir, fname)
            if not os.path.exists(path):
                trees.append(None)
                continue
            with np.load(path) as npz:
                trees.append(convert.flax_tree({k: npz[k] for k in npz.files}))
        pipe = DiffusionInferencePipeline.from_config(
            config, {}, hash_table=_load_table(export_dir), device=device,
            autoencoder=autoencoder)
        pipe.config = config
        pipe.params, pipe.ema_params = (
            None if tree is None else convert.state_dict_from_flax(pipe.model, tree)
            for tree in trees)
        if pipe.params is None:
            raise FileNotFoundError(f"no {EXPORT_FILES[0]} in {export_dir}")
        return pipe

    # -- sampling ----------------------------------------------------------------

    def get_sampler(self, sampler: Union[str, Sampler, Type[Sampler]] = "ddim",
                    guidance_scale: float = 0.0, cache_plan=None) -> DiffusionSampler:
        """`cache_plan` (a ``CachePlan``, ``SpatialPlan`` or ``ComposedPlan``)
        turns the training-free caches on. The plan is normalised first
        (``resolve_plan``: degenerate axes route to the simpler loop), then
        its key joins the sampler cache's, so two effective plans never share
        a sampler. A model without the ``cache_mode`` contract raises
        ValueError."""
        from ..ops.diffcache import resolve_cache_fns
        from ..ops.spatialcache import ComposedPlan, resolve_composed_fns, resolve_plan
        if isinstance(sampler, str):
            if sampler not in SAMPLER_REGISTRY:
                raise ValueError(f"unknown sampler {sampler!r}")
            sampler = SAMPLER_REGISTRY[sampler]()
        elif isinstance(sampler, type):
            sampler = sampler()
        plan = resolve_plan(cache_plan)
        key = _sampler_cache_key(sampler, guidance_scale) + (
            plan.key() if plan is not None else None,)
        if key not in self._sampler_cache:
            if plan is None:
                cache_fns = None
            elif isinstance(plan, ComposedPlan):
                cache_fns = resolve_composed_fns(self.model, plan)
            else:
                cache_fns = resolve_cache_fns(self.model, plan)
            self._sampler_cache[key] = DiffusionSampler(
                lambda x, t, c: self.model(x, t, c), self.schedule, self.transform, sampler,
                guidance_scale=guidance_scale, device=self.device, autoencoder=self.autoencoder,
                cache_plan=plan, cache_fns=cache_fns)
        return self._sampler_cache[key]

    def _load(self, use_ema: bool) -> None:
        """Load the chosen parameters into the model, unless they are
        loaded. Every parameter must be given; buffers the state dict lacks
        (the Fourier frequencies, no flax parameter) keep the model's own,
        the port's table of the JAX draws."""
        params = self.ema_params if use_ema and self.ema_params is not None else self.params
        if params is not self._loaded:
            missing = {n for n, _ in self.model.named_parameters()} - set(params)
            if missing:
                raise KeyError(f"parameters missing from the state dict: {sorted(missing)[:5]}")
            self.model.load_state_dict({**self.model.state_dict(), **params})
            self._loaded = params

    def generate_samples(self, num_samples: int = 4, resolution: int = 64,
                         diffusion_steps: int = 50, sampler: Union[str, Sampler] = "euler_ancestral",
                         guidance_scale: float = 0.0, prompts=None, use_ema: bool = True,
                         seed: int = 42, sequence_length: Optional[int] = None, channels: int = 3,
                         inpaint_reference=None, inpaint_mask=None,
                         cache_plan=None) -> np.ndarray:
        """Samples in [-1, 1] as a host array [N, R, R, C] ([N, T, R, R, C]
        with a `sequence_length`; decoded pixels with a codec, R and C the
        pixels'). Prompts go through
        the input config (N becomes their count) with its null tokens as the
        unconditional input; a conditional model without prompts gets the
        null tokens (pipeline.py:249-276). Every draw comes from a generator
        seeded with `seed` on the pipeline's device. `cache_plan`: the
        training-free caches for this request (see `get_sampler`); None
        keeps the plain loop."""
        self._load(use_ema)
        conditioning = unconditional = None
        if prompts is not None:
            if self.input_config is None or not self.input_config.conditions:
                raise ValueError("pipeline has no conditioning inputs")
            conditioning = self.input_config.conditions[0].encoder(list(prompts))
            num_samples = conditioning.shape[0]
            unconditional = self.input_config.get_unconditionals(batch_size=num_samples)[0]
        elif self.input_config is not None and self.input_config.conditions:
            conditioning = self.input_config.get_unconditionals(batch_size=num_samples)[0]
        ds = self.get_sampler(sampler, guidance_scale, cache_plan=cache_plan)
        if ds.cache_active:
            # host arithmetic on the static plan: no device sync
            from ..telemetry import global_telemetry
            tel = global_telemetry()
            tel.counter("diffcache/requests").inc()
            if ds.spatial_active:
                counts = ds.cache_plan.counts(diffusion_steps)
                tel.counter("diffcache/spatial_requests").inc()
                tel.counter("diffcache/spatial_steps").inc(counts["spatial"])
                refresh, reused = counts["refresh"], counts["reused"]
            else:
                flags = ds.cache_plan.flags(diffusion_steps)
                refresh, reused = int(flags.sum()), int((~flags).sum())
            tel.counter("diffcache/refresh_steps").inc(refresh)
            tel.counter("diffcache/reused_steps").inc(reused)
        out = ds.generate_samples(
            num_samples=num_samples, resolution=resolution, diffusion_steps=diffusion_steps,
            generator=make_generator(seed, self.device), conditioning=conditioning,
            unconditional=unconditional, sequence_length=sequence_length, channels=channels,
            inpaint_reference=inpaint_reference, inpaint_mask=inpaint_mask)
        return out.cpu().numpy()
