"""Training CLI of the port (counterpart of ``train.py``):

    python -m flaxdiff_tpu_torch.train --dataset synthetic --text_encoder hash \\
        --image_size 64 --batch_size 16 --total_steps 1000 --checkpoint_dir ckpt/run

``--dataset packed_shards --dataset_path 'shards/*.rec'`` trains on packed-record
shards (``data.write_image_dataset`` writes them; images must be PNG), and
``--dataset combined_aesthetic --dataset_path ROOT`` on the JAX registry's
production mix under ROOT.

It trains on the card (``--device cpu`` for the CPU), checkpoints every
``--save_every`` steps, writes ``pipeline_config.json`` (and the hash
encoder's table, ``hash_table.npy``) beside the checkpoints, and resumes
when the directory already holds a checkpoint: the state, the generator and
the data stream continue where the run stopped, and training runs up to
``--total_steps`` (the JAX CLI runs ``--total_steps`` more after a resume).
Sample from the result with
``DiffusionInferencePipeline.from_checkpoint(checkpoint_dir)``.

``--dtype float16`` trains with flax's dynamic loss scale, ``--grad_accum
k`` accumulates k micro-batches a update (``optax.MultiSteps``, warmup and
decay divided by k), ``--numerics_cadence``, ``--loss_ring`` and
``--gate_counter`` watch the run's health, ``--val_every`` samples a
validation grid from the EMA params between chunks of the fit, scored by
``--val_metrics psnr,ssim,fid`` against the next real batch (FID with
InceptionV3 features, pytorch-FID's weights from ``--inception_weights``,
seeded random ones without), and
``--profile_dir`` writes a torch.profiler trace of a few steps.
``--telemetry_dir DIR`` writes the run's telemetry there (``telemetry.jsonl``:
phase rows, metric snapshots, the cross-host aggregate; ``goodput.json``;
``trace.json``; ``programs.jsonl``; incident bundles; ``devprof.jsonl`` when
the trainer's ``profile_cadence`` or ``profile_trigger`` opens device-profile
windows), sampled every ``--telemetry_sample_every`` steps, and
``--prometheus_textfile`` a Prometheus textfile beside it; read the directory
with ``python scripts/diagnose_run.py DIR``. The run logs to
``<checkpoint_dir>/train_log.jsonl`` and ends by recording itself in the
model registry (``--registry``, default ``<checkpoint_dir>/../registry.json``)
under ``--run_name``.
``--autoencoder kl_vae|sd_vae`` trains in a codec's latent space (``sd_vae``
with ``--autoencoder_opts '{"npz": "sd_vae.npz"}'`` loads converted weights;
without, both codecs take random weights from ``{"seed": N}``); serve such a
run with ``from_checkpoint(checkpoint_dir, autoencoder=SDVAE.from_npz(...))``.

Across ranks, one process per card::

    torchrun --nproc_per_node N -m flaxdiff_tpu_torch.train --mesh_fsdp N ...

``--mesh_data/--mesh_fsdp/--mesh_seq`` lay the ranks out as the JAX CLI's
mesh (data -1 takes the rest); the process group comes from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``; a process group the
caller already started is used as it is (mesh flags with neither are
refused). Each rank
trains on its data x fsdp block of the global ``--batch_size`` rows, and
rank 0 alone writes the logs, telemetry, registry, pipeline config and
checkpoints. With no ``torchrun`` environment and no mesh flags the run is
one process's, as before.

Only what is ported is accepted; any other flag of ``train.py`` is refused
(ROADMAP.md names the items that port them).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


# the JAX CLI's mesh flags and defaults (data takes the ranks left over)
MESH_DEFAULTS = {"mesh_data": -1, "mesh_fsdp": 1, "mesh_seq": 1, "mesh_tensor": 1}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="flaxdiff_tpu_torch trainer")
    p.add_argument("--dataset", default="synthetic",
                   help="a name in the port's dataset registry: synthetic, packed_shards, "
                        "combined_aesthetic")
    p.add_argument("--dataset_path", default=None,
                   help="the dataset's root: packed_shards' glob of shard files, "
                        "combined_aesthetic's mount root")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--num_frames", type=int, default=0,
                   help="refused above 0: the video sources are ROADMAP.md A9's rest")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--architecture", default="unet",
                   help="registry name, e.g. unet, simple_dit+hilbert")
    p.add_argument("--model_config", default="{}", help="JSON kwargs for the model constructor")
    p.add_argument("--autoencoder", default=None,
                   choices=["identity", "kl_vae", "sd_vae", "stable_diffusion"],
                   help="latent-diffusion codec: the prior trains in its latent space and "
                        "validation decodes (stable_diffusion is refused: ROADMAP.md A9's rest)")
    p.add_argument("--autoencoder_opts", default="{}",
                   help='JSON codec opts. sd_vae: {"npz": "sd_vae.npz"} loads converted '
                        "weights (scripts/convert_sd_vae_weights.py); kl_vae / sd_vae "
                        'without weights take random ones from {"seed": N}')
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--schedule", default="cosine")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--predictor", default="epsilon")
    p.add_argument("--text_encoder", default="hash", choices=["none", "hash"])
    p.add_argument("--uncond_prob", type=float, default=0.12)
    p.add_argument("--optimizer", default="adamw", choices=["adam", "adamw", "lamb"])
    p.add_argument("--lr", type=float, default=2.7e-4)
    p.add_argument("--warmup_steps", type=int, default=10000)
    p.add_argument("--total_steps", type=int, default=100000,
                   help="train up to this step; a resumed run stops here too (the JAX "
                        "train.py trains this many more steps after a resume). It is also "
                        "the LR schedule's decay length")
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--flat_optimizer", action="store_true",
                   help="accepted for train.py's checks: the port's optimizer always runs "
                        "over flat buffers (elementwise optimizers only, not lamb)")
    p.add_argument("--flat_params", action="store_true",
                   help="accepted for train.py's checks and recorded in the pipeline config: "
                        "the port's state is always flat (elementwise optimizers only; no "
                        "per-module numerics)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help=">1 accumulates gradients over k micro-batches per optimizer update "
                        "(optax.MultiSteps)")
    p.add_argument("--ema_decay", type=float, default=0.999)
    # parallelism (train.py:97-102): ranks of the process group
    p.add_argument("--mesh_data", type=int, default=MESH_DEFAULTS["mesh_data"])
    p.add_argument("--mesh_fsdp", type=int, default=MESH_DEFAULTS["mesh_fsdp"])
    p.add_argument("--mesh_seq", type=int, default=MESH_DEFAULTS["mesh_seq"])
    p.add_argument("--mesh_tensor", type=int, default=MESH_DEFAULTS["mesh_tensor"],
                   help="refused above 1: tensor parallelism is ROADMAP.md A12's second half")
    p.add_argument("--checkpoint_dir", default="./checkpoints/run")
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of a few steps of each fit chunk here")
    p.add_argument("--telemetry_dir", default=None,
                   help="enable the telemetry: phase rows, metric snapshots and the "
                        "cross-host aggregate in telemetry.jsonl, the goodput account in "
                        "goodput.json, host spans in trace.json, the program registry in "
                        "programs.jsonl, device-profile rows in devprof.jsonl; one event "
                        "synchronize per sampled step. Read it with scripts/diagnose_run.py")
    p.add_argument("--telemetry_sample_every", type=int, default=1,
                   help="with --telemetry_dir, close the device phase every N-th step only; "
                        "off-sample steps add no host sync")
    p.add_argument("--prometheus_textfile", default=None,
                   help="also export the telemetry snapshot to this path in Prometheus text "
                        "format (atomic rename). Requires --telemetry_dir")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="steps dispatched ahead of the card at most; 0: no bound")
    p.add_argument("--no_nonfinite_gate", action="store_true",
                   help="let non-finite updates land (the save then reads the loss first)")
    p.add_argument("--gate_counter", action="store_true",
                   help="count on the device the elements the non-finite gate masked in "
                        "params / optimizer state / EMA, read once a window; needs the gate "
                        "and changes the checkpoint")
    p.add_argument("--flash_tune_cache", default=None,
                   help="refused: the port's flash kernels have no tunable tiles yet "
                        "(ROADMAP.md queue B)")
    p.add_argument("--loss_ring", type=int, default=0,
                   help="a device ring of this many losses, read once per ring instead of "
                        "a loss window; changes the checkpoint")
    p.add_argument("--numerics_cadence", type=int, default=0,
                   help="every N steps run the monitored step (global and per-module grad "
                        "and param norms, update ratios, non-finite counts); 0 disables")
    p.add_argument("--anomaly_action", default="warn", choices=["warn", "skip_step", "rollback"],
                   help="only warn is ported (skip_step and rollback: ROADMAP.md A14's "
                        "second half)")
    p.add_argument("--val_every", type=int, default=0, help="0 disables in-loop validation")
    p.add_argument("--val_samples", type=int, default=8)
    p.add_argument("--val_steps", type=int, default=200)
    p.add_argument("--val_guidance", type=float, default=3.0)
    p.add_argument("--val_metrics", default="",
                   help="comma list of {psnr, ssim, fid}; clip and clip_score are refused "
                        "(they need CLIP's published weights)")
    p.add_argument("--inception_weights", default=None,
                   help="pytorch-FID's InceptionV3 state dict (.pth) or the npz of "
                        "scripts/convert_inception_weights.py (standard FID; seeded random "
                        "features otherwise)")
    p.add_argument("--sampler", default="euler_ancestral")
    p.add_argument("--registry", default=None,
                   help="path to registry.json for cross-run best tracking "
                        "(default: <checkpoint_dir>/../registry.json)")
    p.add_argument("--run_name", default=None,
                   help="the run's name in the registry (default: the checkpoint dir's name)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device; default: CUDA")
    args = p.parse_args(argv)
    _refuse_dataset(p, args.dataset)
    return args


def _refuse_dataset(parser: argparse.ArgumentParser, name: str) -> None:
    """Exit naming the ROADMAP.md item of a dataset the port lacks."""
    from .data import DATASET_REGISTRY, UNPORTED_DATASETS
    if name.startswith("online:"):
        parser.error(f"--dataset {name}: the online loader fetches over HTTP "
                     "(ROADMAP.md A11's rest)")
    if name in UNPORTED_DATASETS:
        parser.error(f"--dataset {name}: {UNPORTED_DATASETS[name]}")
    if name not in DATASET_REGISTRY:
        parser.error(f"--dataset {name}: unknown; the port's registry holds "
                     f"{sorted(DATASET_REGISTRY)}")


@dataclasses.dataclass
class Run:
    """What ``main`` trains: the trainer (with its checkpointer, restored
    when the directory held a checkpoint), the step it starts from, a
    factory of the host batch stream from a given step, and the validation
    (None without ``--val_every``): ``validate(step)``."""

    args: argparse.Namespace
    trainer: Any
    start_step: int
    batches: Callable[[int], Iterator[Dict[str, Any]]]
    validate: Optional[Callable[[int], Dict[str, Any]]] = None
    telemetry: Any = None
    logger: Any = None
    validator: Any = None
    mesh: Any = None
    rank: int = 0                 # global rank; 0 writes the run's files
    owns_group: bool = False      # make_run started the process group


# --val_metrics name -> its EvaluationMetric factory in metrics/
VAL_METRICS = {"psnr": "get_psnr_metric", "ssim": "get_ssim_metric", "fid": "get_fid_metric"}


def _refuse_unported(args: argparse.Namespace) -> None:
    """train.py's own refusals, and the flags whose features are not ported."""
    if args.flash_tune_cache:
        raise SystemExit("--flash_tune_cache: the port's flash kernels have no tunable tiles "
                         "yet (ROADMAP.md queue B)")
    if args.anomaly_action != "warn":
        raise SystemExit(f"--anomaly_action {args.anomaly_action}: the anomaly detector's "
                         "actions with the NaN provenance probe are ROADMAP.md A14's second "
                         "half; only warn is ported")
    if args.prometheus_textfile and not args.telemetry_dir:
        raise SystemExit("--prometheus_textfile requires --telemetry_dir")
    if args.mesh_tensor > 1:
        raise SystemExit(f"--mesh_tensor {args.mesh_tensor}: tensor parallelism (partition rules "
                         "with the tensor axis, head-parallel flash) is ROADMAP.md A12's second "
                         "half")
    if args.num_frames:
        raise SystemExit(f"--num_frames {args.num_frames}: the video and audio-video sources "
                         "read clips with OpenCV and ffmpeg (ROADMAP.md A9's rest)")
    if args.autoencoder == "stable_diffusion":
        raise SystemExit("--autoencoder stable_diffusion wraps diffusers and downloads SD's VAE "
                         "weights (ROADMAP.md A9's rest); use --autoencoder sd_vae with "
                         "--autoencoder_opts '{\"npz\": ...}' for converted weights")
    for name in filter(None, args.val_metrics.split(",")):
        if name in ("clip", "clip_score"):
            raise SystemExit(f"--val_metrics {name}: the CLIP metrics need CLIP's published "
                             "weights, which are not in the repository")
        if name not in VAL_METRICS:
            raise SystemExit(f"unknown --val_metrics entry {name!r}")
    # train.py:469-496: the whole state is flat under --flat_params, which
    # clears --flat_optimizer; either takes elementwise optimizers only
    if args.flat_params:
        args.flat_optimizer = False
    flag = "flat_params" if args.flat_params else "flat_optimizer" if args.flat_optimizer else None
    elementwise_safe = {"adam", "adamw"}
    if flag and args.optimizer not in elementwise_safe:
        raise SystemExit(
            f"--{flag} is elementwise-only ({sorted(elementwise_safe)}); {args.optimizer!r} "
            "mixes information across a leaf's shape, which changes meaning under "
            "concatenation")


TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def _distributed(args: argparse.Namespace):
    """(device, mesh, owns_group): the counterpart of
    ``jax.distributed.initialize()`` and the CLI's mesh (train.py:316-323).
    No process group, no ``torchrun`` environment and the mesh flags at
    their defaults: this process alone, no mesh. Otherwise the caller's
    group, or one started from ``torchrun``'s environment (NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU)."""
    import torch.distributed as dist
    from .device import resolve_device
    from .parallel import create_mesh
    env = all(k in os.environ for k in TORCHRUN_ENV)
    flags = any(getattr(args, k) != v for k, v in MESH_DEFAULTS.items())
    if not (dist.is_initialized() or env or flags):
        return resolve_device(args.device), None, False
    if not (dist.is_initialized() or env):
        raise SystemExit("the --mesh_* flags take their ranks from torchrun's environment "
                         "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or from a "
                         "process group the caller started: run under torchrun")
    name = args.device
    if env and (name is None or name == "cuda"):
        name = f"cuda:{os.environ['LOCAL_RANK']}"
    device = resolve_device(name)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    owns = not dist.is_initialized()
    if owns:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    mesh = create_mesh({"data": args.mesh_data, "fsdp": args.mesh_fsdp,
                        "seq": args.mesh_seq, "tensor": args.mesh_tensor},
                       device_type=device.type)
    return device, mesh, owns


def make_run(argv: Optional[List[str]] = None) -> Run:
    """Parse `argv`, build the data, model, optimizer chain and trainer,
    restore the newest checkpoint of ``--checkpoint_dir`` if there is one,
    and write the pipeline config and hash table beside it; the run's
    logger (``train_log.jsonl``) and, with ``--telemetry_dir``, its
    telemetry hub."""
    from .data import get_dataset, iterate_batches, prefetch_map
    from .inference.pipeline import HASH_TABLE_FILENAME, save_pipeline_config
    from .inference.registry import build_model
    from .inputs import ConditionalInputConfig, DiffusionInputConfig, HashTextEncoder
    from .models import build_autoencoder
    from .predictors import get_transform
    from .samplers import SAMPLER_REGISTRY
    from .schedulers import get_schedule
    from .trainer import (Checkpointer, DiffusionTrainer, MultiSteps, TrainerConfig,
                          ValidationConfig, Validator, chain, clip_by_global_norm, optim,
                          warmup_cosine_decay_schedule)
    from .parallel import use_mesh
    from .typing import Policy

    args = parse_args(argv)
    _refuse_unported(args)
    device, mesh, owns_group = _distributed(args)
    rank = 0 if mesh is None else torch.distributed.get_rank()
    blocks = 1
    if mesh is not None:
        from .parallel import batch_shard, mesh_shape_for
        block, blocks = batch_shard(mesh)
        if args.batch_size % blocks:
            raise SystemExit(f"--batch_size {args.batch_size} is not divisible by the mesh's "
                             f"{blocks} data x fsdp ranks")
        if rank == 0:
            print(f"mesh: {mesh_shape_for(mesh)}")
    os.makedirs(args.checkpoint_dir, exist_ok=True)

    from .trainer.logging import MultiLogger, make_logger
    # rank 0 alone writes the run's files
    logger = (make_logger(jsonl_path=os.path.join(args.checkpoint_dir, "train_log.jsonl"))
              if rank == 0 else MultiLogger([]))
    telemetry = None
    if args.telemetry_dir and rank == 0:
        # a world of one over the in-memory transport keeps a single-host run
        # on the aggregation path of a multi-host one (train.py:548-557); main
        # makes the hub process-global, so layers without plumbing land on it
        from .resilience.coordination import InMemoryTransport
        from .telemetry import Telemetry
        telemetry = Telemetry.create(args.telemetry_dir,
                                     transport=InMemoryTransport.make_world(1)[0],
                                     prometheus_textfile=args.prometheus_textfile,
                                     logger=logger, device=device)

    autoencoder = None
    if args.autoencoder:
        autoencoder = build_autoencoder(args.autoencoder, device=device,
                                        **json.loads(args.autoencoder_opts))
        if args.image_size % autoencoder.downscale_factor:
            raise SystemExit(
                f"--image_size {args.image_size} is not divisible by the {autoencoder.name} "
                f"codec's downscale factor {autoencoder.downscale_factor}; the encoder would "
                "produce ceil-sized latents that disagree with the prior's sample shape")
        print(f"latent diffusion via {autoencoder.name}: {autoencoder.downscale_factor}x "
              f"downscale, {autoencoder.latent_channels} latent channels")

    encoder = None
    if args.text_encoder == "hash":
        # a resumed run encodes with the table it trained with
        table_path = os.path.join(args.checkpoint_dir, HASH_TABLE_FILENAME)
        encoder = HashTextEncoder(table=np.load(table_path) if os.path.exists(table_path)
                                  else None)
        if mesh is not None:
            torch.distributed.barrier()        # every rank has read it before rank 0 writes
        if rank == 0:
            np.save(table_path, encoder.table.numpy())
    conditions = [ConditionalInputConfig(encoder=encoder)] if encoder is not None else []
    input_config = DiffusionInputConfig("sample", (args.image_size, args.image_size, 3),
                                        conditions)
    # --dataset_path is the registry entry's root (train.py:370-375)
    dataset = get_dataset(args.dataset, image_size=args.image_size,
                          **({"root": args.dataset_path} if args.dataset_path else {}))

    model_kwargs = json.loads(args.model_config)
    model_kwargs.setdefault("dtype", args.dtype)
    if autoencoder is not None:
        model_kwargs.setdefault("output_channels", autoencoder.latent_channels)
        model_kwargs.setdefault("in_channels", autoencoder.latent_channels)
    if encoder is not None:
        model_kwargs.setdefault("context_dim", encoder.features)
    torch.manual_seed(args.seed)          # the modules' own initializers
    model = build_model(args.architecture, device=device, **model_kwargs)
    schedule = get_schedule(args.schedule, timesteps=args.timesteps)
    transform = get_transform(args.predictor)

    # the CLI's optimizer (train.py:456-503): MultiSteps advances the inner
    # schedule once per k micro-steps, so warmup and decay are divided by k;
    # optax needs decay > warmup
    accum = max(args.grad_accum, 1)
    warmup = max(args.warmup_steps // accum, 1)
    lr = warmup_cosine_decay_schedule(0.0, args.lr, warmup,
                                      max(args.total_steps // accum, warmup + 1))
    tx = chain(clip_by_global_norm(args.grad_clip), getattr(optim, args.optimizer)(lr))
    if accum > 1:
        tx = MultiSteps(tx, accum)
    # float16 compute gets the dynamic loss scale (train.py:515-518)
    policy = Policy(compute_dtype=torch.float16) if args.dtype == "float16" else None
    null_cond = input_config.get_unconditionals()[0] if encoder is not None else None
    ckpt = Checkpointer(args.checkpoint_dir)
    trainer = DiffusionTrainer(
        model, tx, schedule, transform,
        TrainerConfig(uncond_prob=args.uncond_prob, ema_decay=args.ema_decay,
                      log_every=args.log_every, seed=args.seed,
                      pipeline_depth=args.pipeline_depth,
                      gate_nonfinite=not args.no_nonfinite_gate,
                      numerics_cadence=args.numerics_cadence, loss_ring=args.loss_ring,
                      gate_counter=args.gate_counter, flat_params=args.flat_params,
                      profile_dir=args.profile_dir,
                      telemetry_sample_every=args.telemetry_sample_every),
        null_cond=null_cond, device=device, checkpointer=ckpt, policy=policy,
        autoencoder=autoencoder, telemetry=telemetry, mesh=mesh)
    start = 0
    if trainer.latest_checkpoint_step() is not None:
        restore = (telemetry.goodput.measure_badput("restart") if telemetry is not None
                   else contextlib.nullcontext())
        with restore:
            start = trainer.restore_checkpoint()
        if rank == 0:
            print(f"resumed from step {start}; training up to --total_steps "
                  f"{args.total_steps} ({max(args.total_steps - start, 0)} more), where the "
                  f"JAX train.py would train {args.total_steps} more")
    config = {
        "model": {"name": args.architecture, **model_kwargs},
        "schedule": {"name": args.schedule, "timesteps": args.timesteps},
        "predictor": args.predictor,
        "input_config": input_config.serialize() if conditions else None,
        "autoencoder": ({"name": args.autoencoder, **autoencoder.serialize()}
                        if autoencoder is not None else None),
        "flat_params": args.flat_params,
    }
    if rank == 0:
        save_pipeline_config(args.checkpoint_dir, config)

    def encode_text(batch):
        if encoder is not None:
            batch["cond"] = encoder(batch["text"]).numpy()
        return batch

    def my_rows(batch):
        """This rank's data x fsdp block of the global batch's rows."""
        if mesh is None:
            return batch
        rows = args.batch_size // blocks
        return {k: v[block * rows:(block + 1) * rows] for k, v in batch.items()}

    def batches(step: int) -> Iterator[Dict[str, Any]]:
        """The host stream from batch `step` on (this rank's rows of it),
        text encoded two batches ahead in a background thread."""
        return prefetch_map(lambda b: encode_text(my_rows(b)),
                            iterate_batches(dataset, args.batch_size, args.seed,
                                            start_batch=step), depth=2)

    validate = validator = None
    if args.val_every:
        from . import metrics
        val_metrics = []
        for name in filter(None, args.val_metrics.split(",")):
            kwargs = {"params_file": args.inception_weights} if name == "fid" else {}
            val_metrics.append(getattr(metrics, VAL_METRICS[name])(device=device, **kwargs))
        validator = Validator(
            trainer.state.model, trainer.schedule, transform,
            ValidationConfig(num_samples=args.val_samples, diffusion_steps=args.val_steps,
                             guidance_scale=args.val_guidance if encoder else 0.0,
                             resolution=args.image_size),
            sampler=SAMPLER_REGISTRY[args.sampler](), device=device, autoencoder=autoencoder,
            metrics=val_metrics)

        def validate(step: int) -> Dict[str, Any]:
            """A grid from the EMA params for the prompt "a photo", scored
            against real images (train.py:779-805): the batch at index `step`
            of the stream, the next chunk's first. The JAX CLI takes the next
            batch off its training iterator; the port's stream is a function
            of the step, so it reads the batch and trains on it too."""
            cond = unc = None
            if encoder is not None:
                cond = encoder(["a photo"] * args.val_samples).to(device)
                unc = input_config.get_unconditionals(args.val_samples)[0].to(device)
            real = next(iterate_batches(dataset, args.batch_size, args.seed, start_batch=step))
            t0 = time.perf_counter()
            # under a mesh every rank samples (a ring attention is collective)
            scope = contextlib.nullcontext() if mesh is None else use_mesh(mesh)
            with scope:
                result = validator.run(trainer.get_params(use_ema=True), cond, unc, batch=real)
            return {"step": step, "wall_s": time.perf_counter() - t0,
                    "samples": Validator.to_uint8(result["samples"]),
                    "metrics": result["metrics"]}

    return Run(args, trainer, start, batches, validate, telemetry, logger, validator, mesh,
               rank, owns_group)


def _merge(total: Dict[str, Any], hist: Dict[str, Any], offset: int) -> None:
    """Fold one fit chunk's history into the run's: window steps shifted by
    the micro-steps run before the chunk, lists joined, counts summed."""
    for key, value in hist.items():
        if key == "steps":
            total.setdefault(key, []).extend(s + offset for s in value)
        elif isinstance(value, list):
            total.setdefault(key, []).extend(value)
        elif key == "saves":
            saves = total.setdefault(key, {})
            for k, n in value.items():
                saves[k] = saves.get(k, 0) + n
        elif key == "skipped_steps":
            total[key] = total.get(key, 0) + value
        elif key == "preempted":
            total[key] = total.get(key, False) or value
        else:
            total[key] = value


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train to ``--total_steps`` and return the fit history ({} when the
    checkpoint is already there), with ``checkpoint``: the last save's step,
    seconds the loop was held, bytes and seconds writing; with
    ``--val_every``, ``validation``: each grid's step, wall time, uint8
    samples and metrics. With ``--val_every`` the fit runs in chunks that
    end at multiples of it, a validation grid after each but the last
    (train.py:772-810). Windows, validation metrics and grids and
    resilience events go to the run's logger; the run ends recorded in the
    model registry (train.py:833-850) and, with ``--telemetry_dir``, with a
    last snapshot and the goodput line. Under a mesh every rank trains and
    validates; rank 0 alone prints, logs and records, and a process group
    the run started is destroyed at its end."""
    from .telemetry import set_global_telemetry
    from .trainer.logging import attach_resilience
    from .trainer.registry import ModelRegistry
    run = make_run(argv)
    args, trainer, tel, logger = run.args, run.trainer, run.telemetry, run.logger
    detach = attach_resilience(logger)
    prev_tel = set_global_telemetry(tel) if tel is not None else None
    run_name = args.run_name or os.path.basename(os.path.normpath(args.checkpoint_dir))
    say = print if run.rank == 0 else (lambda *a, **k: None)
    hist: Dict[str, Any] = {}
    remaining, done = args.total_steps - run.start_step, 0
    try:
        while done < remaining:
            step = run.start_step + done
            end = min((step // args.val_every + 1) * args.val_every, args.total_steps) \
                if args.val_every else args.total_steps

            def log(s, loss, metrics, at=step):
                say(json.dumps({"step": at + s, "loss": loss,
                                  **{k: v for k, v in metrics.items() if k != "window_losses"}}))
                logger.log({"loss": loss, **metrics}, step=at + s)

            chunk = trainer.fit(run.batches(step), total_steps=end - step,
                                save_every=args.save_every, callbacks=[log])
            for row in chunk.get("numerics", []):
                say(json.dumps(row))
            _merge(hist, chunk, done)
            done += end - step
            if chunk["preempted"]:
                break
            if run.validate is not None and done < remaining:
                scope = contextlib.ExitStack()
                if tel is not None:
                    scope.enter_context(tel.span("validation", cat="eval",
                                                 args={"step": run.start_step + done}))
                    scope.enter_context(tel.goodput.measure_badput("eval"))
                with scope:
                    result = run.validate(run.start_step + done)
                hist.setdefault("validation", []).append(result)
                say(json.dumps({"step": result["step"], "val/wall_s": result["wall_s"],
                                  **{f"val/{k}": v for k, v in result["metrics"].items()}}))
                logger.log({f"val/{k}": v for k, v in result["metrics"].items()},
                           step=result["step"])
                logger.log_images("val/samples", result["samples"], step=result["step"])
        trainer.checkpointer.close()
        hist["checkpoint"] = dict(trainer.checkpointer.last_save)
        final_step = trainer.state.step
        if "final_loss" in hist and run.rank == 0:
            logger.log({"final_loss": hist["final_loss"]}, step=final_step)
            # the run and its best metrics across runs (train.py:833-850),
            # at the step whose checkpoint holds them
            final_metrics, directions = {"loss": hist["final_loss"]}, {"loss": False}
            if run.validator is not None:
                for m in run.validator.metrics:
                    if m.name in run.validator.tracker.best:
                        final_metrics[m.name] = run.validator.tracker.best[m.name]
                        directions[m.name] = m.higher_is_better
            reg_path = args.registry or os.path.join(
                os.path.dirname(os.path.abspath(args.checkpoint_dir)), "registry.json")
            became_best = ModelRegistry(reg_path).register_run(
                run_name, checkpoint_dir=args.checkpoint_dir, step=final_step,
                metrics=final_metrics, metric_directions=directions,
                config={"architecture": args.architecture, "schedule": args.schedule,
                        "dataset": args.dataset})
            logger.log({f"registry/best_{k}": v for k, v in became_best.items()},
                       step=final_step)
        if tel is not None:
            tel.export(step=final_step)
    finally:
        detach()
        logger.finish()
        if tel is not None:
            tel.close()
            set_global_telemetry(prev_tel)
        if run.owns_group:
            torch.distributed.destroy_process_group()
    if tel is not None:
        t = tel.goodput.totals()
        if t["goodput_fraction"] is not None:
            print(f"goodput: {t['goodput_fraction']:.1%} of {t['total_s']:.1f} s "
                  f"(badput {t['badput_total_s']:.1f} s: "
                  + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(t["badput_s"].items()))
                  + f") over {t['incarnations']} incarnation(s)")
    say(f"done: step {trainer.state.step}, final loss {hist.get('final_loss', float('nan')):.4f}")
    return hist


if __name__ == "__main__":
    main()
