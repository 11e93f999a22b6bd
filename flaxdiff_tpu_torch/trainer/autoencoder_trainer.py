"""The KL autoencoder's trainer (counterpart of
``flaxdiff_tpu/trainer/autoencoder_trainer.py``): reconstruction (l1 or l2)
plus ``kl_weight`` times the KL of the posterior, AdamW, EMA, PSNR / SSIM
evaluation and the SD latent scale (1 / std of the encoder's latents).

The trainer owns a trainable copy of the codec's network in a
``TrainState`` (one flat f32 buffer for params, EMA and moments), so the
codec handed in stays frozen. The JAX step draws the posterior's noise from
``fold_in(rng, step)``; here each step's noise is an argument of
``train_step`` (a test hands in the JAX draw) or, without one, a draw of the
trainer's ``torch.Generator``. The encoder and decoder are stacks of
``ResidualBlock``, so a step runs the fused GroupNorm + SiLU kernels forward
and backward on the card.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, make_generator
from ..models.autoencoder import KLAutoEncoder, gaussian_sample, kl_divergence
from ..utils import normalize_images
from .optim import Optimizer
from .train_state import TrainState


@dataclasses.dataclass
class AutoEncoderTrainerConfig:
    kl_weight: float = 1e-6        # SD-style tiny KL
    recon_loss: str = "l2"         # "l1" | "l2"
    ema_decay: Optional[float] = 0.999
    normalize: bool = True
    log_every: int = 100
    seed: int = 0                  # of the trainer's generator


class AutoEncoderTrainer:
    """Trains a ``KLAutoEncoder``'s encoder and decoder jointly, on the
    codec's device (CUDA unless it was built with ``device="cpu"``)."""

    def __init__(self, vae: KLAutoEncoder, tx: Optimizer,
                 config: AutoEncoderTrainerConfig = AutoEncoderTrainerConfig(),
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        if config.recon_loss not in ("l1", "l2"):
            raise ValueError(f"recon_loss must be l1 or l2, got {config.recon_loss!r}")
        self.vae = vae if device is None else vae.to(device)
        self.device = self.vae.device
        self.config = config
        net = copy.deepcopy(self.vae.net).train().requires_grad_(True)
        self.state = TrainState(net, tx, config.ema_decay)
        self.generator = make_generator(config.seed, self.device) if generator is None \
            else generator

    def _inputs(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        x = x.to(self.device, non_blocking=True)
        return normalize_images(x) if self.config.normalize else x.float()

    def noise_shape(self, x: torch.Tensor) -> tuple:
        """The posterior mean's shape for a batch of images [B, H, W, C]."""
        d = self.vae.downscale_factor
        return (x.shape[0], -(-x.shape[1] // d), -(-x.shape[2] // d), self.vae.latent_channels)

    def loss(self, x: torch.Tensor, noise: torch.Tensor):
        """(loss, recon, kl) of normalized images `x` with the posterior
        sample's `noise`."""
        net = self.state.model
        moments = net.encoder(x)
        recon = net.decoder(gaussian_sample(moments, noise)).float()
        err = recon - x
        rec = err.abs().mean() if self.config.recon_loss == "l1" else (err * err).mean()
        kl = kl_divergence(moments.float()).mean()
        return rec + self.config.kl_weight * kl, rec, kl

    def train_step(self, batch: Mapping[str, Any],
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One update on {"sample": [B, H, W, C]}; the metrics stay on the
        device (no host sync). `noise`: the posterior's draw, of the
        posterior mean's shape; the trainer's generator draws it without."""
        x = self._inputs(batch["sample"])
        if noise is None:
            noise = torch.randn(self.noise_shape(x), generator=self.generator,
                                device=self.device)
        loss, rec, kl = self.loss(x, noise.to(self.device))
        grads = self.state.grads(loss)
        self.state.apply_gradients(grads, self.config.ema_decay)
        return {"loss": loss.detach(), "recon": rec.detach(), "kl": kl.detach()}

    def fit(self, data: Iterator[Mapping[str, Any]], total_steps: int,
            callbacks: Sequence[Callable[[int, float, Dict], None]] = ()) -> Dict[str, Any]:
        """`total_steps` steps; every `log_every` steps (and at the last) the
        step's loss, recon and kl are read back in one copy and appended to
        the history, and each callback gets ``(step, loss, values)``."""
        cfg = self.config
        history: Dict[str, Any] = {"steps": [], "loss": [], "recon": [], "kl": []}
        t0 = time.perf_counter()
        for i in range(total_steps):
            metrics = self.train_step(next(data))
            if (i + 1) % cfg.log_every == 0 or i == total_steps - 1:
                loss, rec, kl = torch.stack([metrics["loss"], metrics["recon"],
                                             metrics["kl"]]).cpu().tolist()
                vals = {"loss": loss, "recon": rec, "kl": kl}
                history["steps"].append(i + 1)
                for k in ("loss", "recon", "kl"):
                    history[k].append(vals[k])
                for cb in callbacks:
                    cb(i + 1, vals["loss"], vals)
        history["final_loss"] = history["loss"][-1] if history["loss"] else float("nan")
        history["seconds"] = time.perf_counter() - t0
        return history

    @torch.no_grad()
    def evaluate(self, batch: Mapping[str, Any], use_ema: bool = True) -> Dict[str, float]:
        """Reconstruction PSNR (dB) and, for images of at least 11x11, SSIM
        on a batch in [-1, 1], through the posterior means."""
        from ..metrics.image_quality import psnr, ssim
        vae = self.trained_vae(use_ema=use_ema, scaling_factor=1.0)
        x = self._inputs(batch["sample"])
        recon = vae.decode(vae.encode(x))
        out = {"psnr": float(psnr(recon, x))}
        if x.shape[-3] >= 11 and x.shape[-2] >= 11:
            out["ssim"] = float(ssim(recon, x))
        return out

    # -- export ---------------------------------------------------------------

    def weights(self, use_ema: bool = True) -> Dict[str, torch.Tensor]:
        """Parameter name -> tensor of the network: the EMA or the live set."""
        flat = self.state.ema if use_ema and self.state.ema is not None else self.state.params
        return self.state.views(flat)

    def trained_vae(self, use_ema: bool = True,
                    scaling_factor: Optional[float] = None) -> KLAutoEncoder:
        """A frozen ``KLAutoEncoder`` holding the trained weights."""
        vae = copy.deepcopy(self.vae)
        with torch.no_grad():
            for name, p in vae.net.named_parameters():
                p.copy_(self.weights(use_ema)[name])
        if scaling_factor is not None:
            vae.scaling_factor = float(scaling_factor)
        return vae

    @torch.no_grad()
    def measure_latent_scale(self, data: Iterator[Mapping[str, Any]], num_batches: int = 8,
                             use_ema: bool = True) -> float:
        """The SD convention, 1 / std of the encoder's latents (the mean of
        each batch's population std), so scaled latents have about unit
        variance. `use_ema` must match the ``trained_vae`` export the factor
        is applied to: measured on one weight set and applied to the other,
        a young run's EMA lag breaks the unit variance."""
        vae = self.trained_vae(use_ema=use_ema, scaling_factor=1.0)
        stds = [torch.std(vae.encode(self._inputs(next(data)["sample"])).float(), correction=0)
                for _ in range(num_batches)]
        return 1.0 / max(float(torch.stack(stds).mean()), 1e-6)
