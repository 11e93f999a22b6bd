from .common import NoiseSchedule, SigmaSchedule, bcast_right
from .continuous import (ContinuousNoiseSchedule, CosineContinuousNoiseSchedule,
                         SqrtContinuousNoiseSchedule)
from .discrete import (CosineNoiseSchedule, DiscreteNoiseSchedule, ExpNoiseSchedule,
                       LinearNoiseSchedule, cosine_beta_schedule, exp_beta_schedule,
                       linear_beta_schedule)
from .karras import (CosineGeneralNoiseSchedule, EDMNoiseSchedule, KarrasVENoiseSchedule,
                     SimpleExpNoiseSchedule)

SCHEDULE_REGISTRY = {
    "linear": LinearNoiseSchedule,
    "cosine": CosineNoiseSchedule,
    "exp": ExpNoiseSchedule,
    "cosine_continuous": CosineContinuousNoiseSchedule,
    "cosine_general": CosineGeneralNoiseSchedule,
    "sqrt": SqrtContinuousNoiseSchedule,
    "karras": KarrasVENoiseSchedule,
    "simple_exp": SimpleExpNoiseSchedule,
    "edm": EDMNoiseSchedule,
}


def get_schedule(name: str, **kwargs) -> NoiseSchedule:
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown schedule {name!r}; known: {sorted(SCHEDULE_REGISTRY)}")
    return SCHEDULE_REGISTRY[name](**kwargs)


__all__ = ["NoiseSchedule", "SigmaSchedule", "bcast_right", "ContinuousNoiseSchedule",
           "CosineContinuousNoiseSchedule", "SqrtContinuousNoiseSchedule",
           "DiscreteNoiseSchedule", "LinearNoiseSchedule", "CosineNoiseSchedule",
           "ExpNoiseSchedule", "linear_beta_schedule", "cosine_beta_schedule",
           "exp_beta_schedule", "KarrasVENoiseSchedule", "SimpleExpNoiseSchedule",
           "EDMNoiseSchedule", "CosineGeneralNoiseSchedule", "SCHEDULE_REGISTRY",
           "get_schedule"]
