from .common import (DiffusionSampler, GivenNoise, NoiseSource, RowNoise, Sampler,
                     get_timestep_spacing)
from .ddim import DDIMSampler
from .ddpm import DDPMSampler, SimpleDDPMSampler
from .euler import EulerAncestralSampler, EulerSampler, SimplifiedEulerSampler
from .heun import HeunSampler
from .multistep_dpm import MultiStepDPMSampler
from .rk4 import RK4Sampler

SAMPLER_REGISTRY = {
    "ddpm": DDPMSampler,
    "simple_ddpm": SimpleDDPMSampler,
    "ddim": DDIMSampler,
    "euler": EulerSampler,
    "simple_euler": SimplifiedEulerSampler,
    "euler_ancestral": EulerAncestralSampler,
    "heun": HeunSampler,
    "rk4": RK4Sampler,
    "multistep_dpm": MultiStepDPMSampler,
}


def get_sampler(name: str, **kwargs) -> Sampler:
    if name not in SAMPLER_REGISTRY:
        raise ValueError(f"Unknown sampler {name!r}; known: {sorted(SAMPLER_REGISTRY)}")
    return SAMPLER_REGISTRY[name](**kwargs)


__all__ = ["DiffusionSampler", "GivenNoise", "NoiseSource", "RowNoise", "Sampler",
           "get_timestep_spacing",
           "DDIMSampler", "DDPMSampler", "SimpleDDPMSampler", "EulerSampler",
           "SimplifiedEulerSampler", "EulerAncestralSampler", "HeunSampler",
           "MultiStepDPMSampler", "RK4Sampler", "SAMPLER_REGISTRY", "get_sampler"]
