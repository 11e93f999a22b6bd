"""Training CLI of the port (counterpart of ``train.py``):

    python -m flaxdiff_tpu_torch.train --dataset synthetic --text_encoder hash \\
        --image_size 64 --batch_size 16 --total_steps 1000 --checkpoint_dir ckpt/run

It trains on the card (``--device cpu`` for the CPU), checkpoints every
``--save_every`` steps, writes ``pipeline_config.json`` (and the hash
encoder's table, ``hash_table.npy``) beside the checkpoints, and resumes
when the directory already holds a checkpoint: the state, the generator and
the data stream continue where the run stopped, and training runs up to
``--total_steps`` (the JAX CLI runs ``--total_steps`` more after a resume).
Sample from the result with
``DiffusionInferencePipeline.from_checkpoint(checkpoint_dir)``.

Only what is ported is accepted; any other flag of ``train.py`` is refused
(ROADMAP.md names the items that port them).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="flaxdiff_tpu_torch trainer")
    p.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--architecture", default="unet",
                   help="registry name, e.g. unet, simple_dit+hilbert")
    p.add_argument("--model_config", default="{}", help="JSON kwargs for the model constructor")
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
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--checkpoint_dir", default="./checkpoints/run")
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="steps dispatched ahead of the card at most; 0: no bound")
    p.add_argument("--no_nonfinite_gate", action="store_true",
                   help="let non-finite updates land (the save then reads the loss first)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device; default: CUDA")
    return p.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What ``main`` trains: the trainer (with its checkpointer, restored
    when the directory held a checkpoint), the step it starts from, and a
    factory of the host batch stream from a given step."""

    args: argparse.Namespace
    trainer: Any
    start_step: int
    batches: Callable[[int], Iterator[Dict[str, Any]]]


def make_run(argv: Optional[List[str]] = None) -> Run:
    """Parse `argv`, build the data, model, optimizer chain and trainer,
    restore the newest checkpoint of ``--checkpoint_dir`` if there is one,
    and write the pipeline config and hash table beside it."""
    from .data import get_dataset, iterate_batches, prefetch_map
    from .device import resolve_device
    from .inference.pipeline import HASH_TABLE_FILENAME, save_pipeline_config
    from .inference.registry import build_model
    from .inputs import ConditionalInputConfig, DiffusionInputConfig, HashTextEncoder
    from .predictors import get_transform
    from .schedulers import get_schedule
    from .trainer import (Checkpointer, DiffusionTrainer, TrainerConfig, chain,
                          clip_by_global_norm, optim, warmup_cosine_decay_schedule)

    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.checkpoint_dir, exist_ok=True)

    encoder = None
    if args.text_encoder == "hash":
        # a resumed run encodes with the table it trained with
        table_path = os.path.join(args.checkpoint_dir, HASH_TABLE_FILENAME)
        encoder = HashTextEncoder(table=np.load(table_path) if os.path.exists(table_path)
                                  else None)
        np.save(table_path, encoder.table.numpy())
    conditions = [ConditionalInputConfig(encoder=encoder)] if encoder is not None else []
    input_config = DiffusionInputConfig("sample", (args.image_size, args.image_size, 3),
                                        conditions)
    dataset = get_dataset(args.dataset, image_size=args.image_size)

    model_kwargs = json.loads(args.model_config)
    model_kwargs.setdefault("dtype", args.dtype)
    if encoder is not None:
        model_kwargs.setdefault("context_dim", encoder.features)
    torch.manual_seed(args.seed)          # the modules' own initializers
    model = build_model(args.architecture, device=device, **model_kwargs)
    schedule = get_schedule(args.schedule, timesteps=args.timesteps)
    transform = get_transform(args.predictor)

    # the CLI's optimizer (train.py:456-468); optax needs decay > warmup
    warmup = max(args.warmup_steps, 1)
    lr = warmup_cosine_decay_schedule(0.0, args.lr, warmup, max(args.total_steps, warmup + 1))
    tx = chain(clip_by_global_norm(args.grad_clip), getattr(optim, args.optimizer)(lr))
    null_cond = input_config.get_unconditionals()[0] if encoder is not None else None
    ckpt = Checkpointer(args.checkpoint_dir)
    trainer = DiffusionTrainer(
        model, tx, schedule, transform,
        TrainerConfig(uncond_prob=args.uncond_prob, ema_decay=args.ema_decay,
                      log_every=args.log_every, seed=args.seed,
                      pipeline_depth=args.pipeline_depth,
                      gate_nonfinite=not args.no_nonfinite_gate),
        null_cond=null_cond, device=device, checkpointer=ckpt)
    start = 0
    if ckpt.latest_step() is not None:
        start = trainer.restore_checkpoint()
        print(f"resumed from step {start}; training up to --total_steps {args.total_steps} "
              f"({max(args.total_steps - start, 0)} more), where the JAX train.py would "
              f"train {args.total_steps} more")
    save_pipeline_config(args.checkpoint_dir, {
        "model": {"name": args.architecture, **model_kwargs},
        "schedule": {"name": args.schedule, "timesteps": args.timesteps},
        "predictor": args.predictor,
        "input_config": input_config.serialize() if conditions else None,
        "autoencoder": None,
        "flat_params": False,
    })

    def encode_text(batch):
        if encoder is not None:
            batch["cond"] = encoder(batch["text"]).numpy()
        return batch

    def batches(step: int) -> Iterator[Dict[str, Any]]:
        """The host stream from batch `step` on, text encoded two batches
        ahead in a background thread."""
        return prefetch_map(encode_text, iterate_batches(dataset, args.batch_size, args.seed,
                                                         start_batch=step), depth=2)

    return Run(args, trainer, start, batches)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train to ``--total_steps`` and return the fit history ({} when the
    checkpoint is already there), with ``checkpoint``: the last save's step,
    seconds the loop was held, bytes and seconds writing."""
    run = make_run(argv)
    args, trainer = run.args, run.trainer
    hist: Dict[str, Any] = {}
    remaining = args.total_steps - run.start_step
    if remaining > 0:
        def log(step, loss, metrics):
            print(json.dumps({"step": run.start_step + step, "loss": loss, **metrics}))

        hist = trainer.fit(run.batches(run.start_step), total_steps=remaining,
                           save_every=args.save_every, callbacks=[log])
    trainer.checkpointer.close()
    hist["checkpoint"] = dict(trainer.checkpointer.last_save)
    print(f"done: step {trainer.state.step}, final loss {hist.get('final_loss', float('nan')):.4f}")
    return hist


if __name__ == "__main__":
    main()
