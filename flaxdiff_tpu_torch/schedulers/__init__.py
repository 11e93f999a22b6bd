from .common import NoiseSchedule, bcast_right
from .discrete import (CosineNoiseSchedule, DiscreteNoiseSchedule, ExpNoiseSchedule,
                       LinearNoiseSchedule, cosine_beta_schedule, exp_beta_schedule,
                       linear_beta_schedule)

__all__ = ["NoiseSchedule", "bcast_right", "DiscreteNoiseSchedule", "LinearNoiseSchedule",
           "CosineNoiseSchedule", "ExpNoiseSchedule", "linear_beta_schedule",
           "cosine_beta_schedule", "exp_beta_schedule"]
