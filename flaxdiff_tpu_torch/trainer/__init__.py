from .autoencoder_trainer import AutoEncoderTrainer, AutoEncoderTrainerConfig
from .checkpoints import Checkpointer
from .logging import (JsonlLogger, MultiLogger, attach_resilience, make_logger,
                      save_image_grid)
from .loss_scale import DynamicScale
from .optim import (AdamW, Chain, ClipByGlobalNorm, MultiSteps, adam, adamw, chain,
                    clip_by_global_norm, lamb, warmup_cosine_decay_schedule)
from .registry import ModelRegistry, pull_artifact
from .train_state import TrainState
from .train_step import TrainStepConfig, make_loss_builder, make_train_step
from .trainer import DiffusionTrainer, TrainerConfig
from .validation import ValidationConfig, Validator

__all__ = ["AdamW", "AutoEncoderTrainer", "AutoEncoderTrainerConfig", "Chain", "Checkpointer",
           "ClipByGlobalNorm", "DiffusionTrainer", "DynamicScale", "JsonlLogger", "ModelRegistry",
           "MultiLogger", "MultiSteps", "TrainState", "TrainStepConfig", "TrainerConfig",
           "ValidationConfig", "Validator", "adam", "adamw", "chain", "clip_by_global_norm",
           "attach_resilience", "lamb", "make_logger", "make_loss_builder", "make_train_step",
           "pull_artifact", "save_image_grid", "warmup_cosine_decay_schedule"]
