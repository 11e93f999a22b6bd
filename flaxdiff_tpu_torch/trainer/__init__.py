from .checkpoints import Checkpointer
from .loss_scale import DynamicScale
from .optim import (AdamW, Chain, ClipByGlobalNorm, MultiSteps, adam, adamw, chain,
                    clip_by_global_norm, lamb, warmup_cosine_decay_schedule)
from .train_state import TrainState
from .train_step import TrainStepConfig, make_loss_builder, make_train_step
from .trainer import DiffusionTrainer, TrainerConfig
from .validation import ValidationConfig, Validator

__all__ = ["AdamW", "Chain", "Checkpointer", "ClipByGlobalNorm", "DiffusionTrainer",
           "DynamicScale", "MultiSteps", "TrainState", "TrainStepConfig", "TrainerConfig",
           "ValidationConfig", "Validator", "adam", "adamw", "chain", "clip_by_global_norm",
           "lamb", "make_loss_builder", "make_train_step", "warmup_cosine_decay_schedule"]
