from .train_state import AdamW, TrainState
from .train_step import TrainStepConfig, make_loss_builder, make_train_step
from .trainer import DiffusionTrainer, TrainerConfig

__all__ = ["AdamW", "DiffusionTrainer", "TrainState", "TrainStepConfig", "TrainerConfig",
           "make_loss_builder", "make_train_step"]
