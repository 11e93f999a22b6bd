from .common import DiffusionSampler, Sampler, get_timestep_spacing
from .ddim import DDIMSampler

__all__ = ["DiffusionSampler", "Sampler", "get_timestep_spacing", "DDIMSampler"]
