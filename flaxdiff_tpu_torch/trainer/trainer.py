"""The diffusion trainer (counterpart of the core of
``flaxdiff_tpu/trainer/trainer.py``): it owns the train state and a seeded
``torch.Generator`` on the device, draws each step's noise, timesteps and
CFG-dropout mask there (and, for latent diffusion, the codec's posterior
noise), runs the step, and drives the fit loop with
checkpoints, resume, preemption, abnormal-loss rollback, the float16 loss
scale, the monitored step at the numerics cadence, the loss ring, the gate
counter and a profiler window.

Not ported (ROADMAP.md A14): telemetry (phases, goodput, MFU), the anomaly
detector and its actions other than ``warn``, the NaN provenance probe,
automated profile windows, the watchdog, elastic worlds and the data plane.
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import time
import warnings
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.prefetch import prefetch_to_device
from ..device import DeviceLike, make_generator, resolve_device
from ..predictors import PredictionTransform
from ..schedulers.common import NoiseSchedule
from ..telemetry.numerics import NumericsConfig, flatten_aux
from ..typing import Policy
from .checkpoints import Checkpointer
from .loss_scale import DynamicScale
from .optim import Optimizer
from .train_state import TrainState
from .train_step import TrainStepConfig, make_train_step


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    uncond_prob: float = 0.12
    ema_decay: float = 0.999
    normalize: bool = True
    weighted_loss: bool = True
    gate_nonfinite: bool = True
    seed: int = 0                      # of the default generator
    log_every: int = 100               # steps a loss window holds
    # a window loss that is NaN, Inf or <= this rolls back to the best state
    abnormal_loss_floor: float = 1e-8
    keep_best_state: bool = True
    checkpoint_on_sigterm: bool = True
    restore_at_start: bool = False     # fit restores the newest checkpoint first
    # steps dispatched ahead of the card at most; 0: no bound (the window
    # fetch is then the only wait)
    pipeline_depth: int = 2
    # every N steps the monitored twin of the step runs and its health aux
    # is read back (history["numerics"]); 0: never
    numerics_cadence: int = 0
    # > 0: a device ring of this many losses, written in the step at
    # step % N, is read once every N steps instead of a window of losses
    # (the window is then N steps long); changes the checkpoint
    loss_ring: int = 0
    # a [3] int32 count on the device of the elements the gate masked in
    # params / optimizer state / EMA, read at each window; needs the gate;
    # changes the checkpoint
    gate_counter: bool = False
    # the state is flat in any case; a flat-params run's aux has no
    # per-module entries, as in the JAX package
    flat_params: bool = False
    # a torch.profiler trace of `profile_steps` steps from step
    # `profile_at_step` of each fit (clamped into the fit) in profile_dir
    profile_dir: Optional[str] = None
    profile_at_step: int = 10
    profile_steps: int = 5


def _fetch_losses(window: Sequence[torch.Tensor]) -> list[float]:
    """The window's losses on the host: one device-to-host copy, the fit
    loop's only wait on the card between windows."""
    return torch.stack(list(window)).cpu().tolist()


class DiffusionTrainer:
    """model(x, t, cond) -> raw output, with f32 parameters (its compute
    dtype is its own); it is moved to ``device`` (CUDA unless the caller
    passes ``device="cpu"``). `optimizer`: an ``AdamW`` or a ``Chain``
    (``trainer/optim.py``)."""

    def __init__(self, model: nn.Module, optimizer: Optimizer, schedule: NoiseSchedule,
                 transform: PredictionTransform, config: TrainerConfig = TrainerConfig(),
                 null_cond: Optional[torch.Tensor] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 checkpointer: Optional[Checkpointer] = None, policy: Optional[Policy] = None,
                 autoencoder=None):
        """`policy`: the mixed-precision policy; a float16 compute dtype
        keeps a dynamic loss scale in the state (trainer.py:335-339).
        `autoencoder`: latent diffusion, the codec frozen and moved to the
        trainer's device; batches stay pixels and are encoded in the step."""
        if config.gate_counter and not config.gate_nonfinite:
            raise ValueError("gate_counter counts the in-graph gate's activations — it requires "
                             "gate_nonfinite")
        self.device = resolve_device(device)
        self.config = config
        self.schedule = schedule.to(self.device)
        self.autoencoder = None if autoencoder is None else autoencoder.to(self.device)
        scale = None
        if policy is not None and policy.compute_dtype == torch.float16:
            scale = DynamicScale(device=self.device)
        self.state = TrainState(model.to(self.device), optimizer, config.ema_decay,
                                dynamic_scale=scale, loss_ring_size=max(config.loss_ring, 0),
                                gate_counter=config.gate_counter)
        self.generator = make_generator(config.seed, self.device) if generator is None \
            else generator
        self.checkpointer = checkpointer
        self.best_loss = float("inf")
        self.best_state: Optional[Dict[str, Any]] = None   # buffers and step
        self.best_step: Optional[int] = None
        null = None if null_cond is None else torch.as_tensor(null_cond).to(self.device)
        step_cfg = TrainStepConfig(uncond_prob=config.uncond_prob, ema_decay=config.ema_decay,
                                   normalize=config.normalize,
                                   weighted_loss=config.weighted_loss)
        self._step = make_train_step(self.schedule, transform, step_cfg, null_cond=null,
                                     gate_nonfinite=config.gate_nonfinite, policy=policy,
                                     autoencoder=self.autoencoder)
        self._step_monitored = None
        if config.numerics_cadence > 0:
            self._step_monitored = make_train_step(
                self.schedule, transform, step_cfg, null_cond=null,
                gate_nonfinite=config.gate_nonfinite, policy=policy,
                numerics=NumericsConfig(per_module=not config.flat_params),
                autoencoder=self.autoencoder)

    def _run(self, step, batch: Mapping[str, "torch.Tensor | np.ndarray"]):
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items() if k in ("sample", "cond") and v is not None}
        x = batch["sample"]
        gen, dev = self.generator, self.device
        shape, vae_shape = x.shape, None
        if self.autoencoder is not None:
            # the latent's shape (inputs/config.py's ceil division), and the
            # posterior mean's: a clip's frames folded into its batch
            d, c = self.autoencoder.downscale_factor, self.autoencoder.latent_channels
            *lead, h, w, _ = x.shape
            shape = (*lead, -(-h // d), -(-w // d), c)
            vae_shape = (math.prod(lead), *shape[-3:])
        noise = torch.randn(shape, generator=gen, device=dev)
        t = self.schedule.sample_timesteps(gen, x.shape[0])
        uncond_mask = torch.rand(x.shape[0], generator=gen, device=dev) < self.config.uncond_prob
        vae_noise = None if vae_shape is None else torch.randn(vae_shape, generator=gen,
                                                               device=dev)
        return step(self.state, batch, noise, t, uncond_mask, vae_noise)

    def train_step(self, batch: Mapping[str, "torch.Tensor | np.ndarray"]) -> torch.Tensor:
        """One step on {"sample": [B, (T,) H, W, C], "cond": optional
        [B, L, D]}; returns the loss as a tensor on the device (no host
        sync)."""
        return self._run(self._step, batch)

    def train_step_monitored(self, batch: Mapping[str, "torch.Tensor | np.ndarray"]):
        """The numerics-cadence step: ``(loss, aux)`` with the health aux on
        the device (``telemetry/numerics.py``). Needs ``numerics_cadence > 0``."""
        if self._step_monitored is None:
            raise ValueError("train_step_monitored needs TrainerConfig.numerics_cadence > 0")
        return self._run(self._step_monitored, batch)

    def get_params(self, use_ema: bool = True) -> dict[str, torch.Tensor]:
        """Parameter name -> tensor: the EMA copy, or the live parameters."""
        flat = self.state.ema if use_ema and self.state.ema is not None else self.state.params
        return {name: t.detach() for name, t in self.state.views(flat).items()}

    # -- best state and checkpoints -------------------------------------------

    def _snapshot_best(self, loss: float) -> None:
        """Copy the state as it stands into the best-state buffers (one
        state's worth of device memory, allocated once)."""
        bufs = {k: v for k, v in self.state.buffers().items() if v is not None}
        if self.best_state is None:
            self.best_state = {k: torch.empty_like(v) for k, v in bufs.items()}
        for k, v in bufs.items():
            self.best_state[k].copy_(v)
        self.best_loss, self.best_step = loss, self.state.step

    def save_checkpoint(self) -> bool:
        """Start an asynchronous save of the state, the generator's state and
        the best loss at the current step; False without a checkpointer or
        when the checkpointer skipped it."""
        if self.checkpointer is None:
            return False
        extra = {"generator": self.generator.get_state(), "best_loss": float(self.best_loss)}
        return self.checkpointer.save(self.state.step, self.state, extra)

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Restore the state and the generator from `step` (default: the
        newest); returns the step. The best state is seeded from the
        restored one, so a rollback stays armed after a resume
        (flaxdiff_tpu/trainer/trainer.py:629-655)."""
        if self.checkpointer is None:
            raise ValueError("trainer has no checkpointer")
        state, extra = self.checkpointer.restore(step)
        self.state.load_state_dict(state)
        self.generator.set_state(extra["generator"])
        best = float(extra.get("best_loss", float("inf")))
        if self.config.keep_best_state:
            self._snapshot_best(best if best > 0 else float("inf"))
        else:
            self.best_loss = best if best > 0 else float("inf")
        return self.state.step

    def _recover(self, bad_loss: float) -> Optional[int]:
        """Abnormal-loss recovery (flaxdiff_tpu/trainer/trainer.py:1853-1898):
        the best state if there is one, else the newest checkpoint, else go
        on in place with the generator's next draws. Returns the step the
        run landed on, or None."""
        if self.best_state is not None:
            warnings.warn(f"abnormal loss {bad_loss}; restored the best state of step "
                          f"{self.best_step}", RuntimeWarning, stacklevel=2)
            for k, v in self.state.buffers().items():
                if v is not None:
                    v.copy_(self.best_state[k])
            self.state.step = self.best_step
            return self.best_step
        if self.checkpointer is not None and self.checkpointer.latest_step() is not None:
            restored = self.restore_checkpoint()
            warnings.warn(f"abnormal loss {bad_loss}; no best state, restored checkpoint "
                          f"step {restored}", RuntimeWarning, stacklevel=2)
            return restored
        warnings.warn(f"abnormal loss {bad_loss}; no best state or checkpoint, continuing",
                      RuntimeWarning, stacklevel=2)
        return None

    def _abnormal(self, loss: float) -> bool:
        return not math.isfinite(loss) or loss <= self.config.abnormal_loss_floor

    # -- the fit loop ------------------------------------------------------------

    def fit(self, data: Iterator[Mapping], total_steps: int,
            callbacks: Sequence[Callable[[int, float, Dict], None]] = (),
            save_every: Optional[int] = None) -> Dict[str, Any]:
        """Run `total_steps` steps on host batches from `data` and return
        the history: per window ``steps``, ``loss`` (the window's last) and
        ``imgs_per_sec``; ``preempted``; ``saves`` by result; ``final_loss``
        and ``best_loss``; with ``numerics_cadence`` the monitored steps'
        flattened aux (``numerics``, each with its ``step``) and
        ``skipped_steps``; with ``gate_counter`` each window's masked
        elements where there were any (``gate_activations``); with
        ``profile_dir`` the trace's path (``profile_trace``).

        The loop waits on the card once a window: batches go up through
        ``prefetch_to_device``, at most `pipeline_depth` steps are in flight
        (tracked by CUDA events: ``query()`` first, ``synchronize()`` on the
        oldest only when the card is that far behind), and the window's
        losses stay on the device until one ``torch.stack(...).cpu()`` every
        `log_every` steps, or one read of the loss ring every `loss_ring`
        steps. A monitored step's aux is read back at once. A NaN, Inf or a
        loss at or below `abnormal_loss_floor` anywhere in the window rolls
        the state back (``_recover``); the JAX package acts on the window's
        last loss only, since its gate keeps a poisoned update out of the
        state, and counts the rest. After a healthy window the state is
        snapshotted as the best when the window's last loss beats the best
        so far (trainer.py:1716-1719). A checkpoint is written every
        `save_every` steps (not right after a rollback) and at the end;
        SIGTERM saves and returns with ``preempted`` set, and the previous
        handler is restored on the way out. Up to `pipeline_depth` + 2
        batches of `data` may be taken but unused when fit returns."""
        cfg = self.config
        history: Dict[str, Any] = {"steps": [], "loss": [], "imgs_per_sec": [],
                                   "preempted": False,
                                   "saves": {"started": 0, "skipped_exists": 0}}
        if cfg.numerics_cadence > 0:
            history.update(numerics=[], skipped_steps=0)
        if cfg.gate_counter:
            history["gate_activations"] = []
        if cfg.restore_at_start and self.checkpointer is not None \
                and self.checkpointer.latest_step() is not None:
            self.restore_checkpoint()

        def save() -> None:
            if self.checkpointer is not None:
                self.save_checkpoint()
                history["saves"][self.checkpointer.last_save_result] += 1

        stop, prev_handler, installed = [False], None, False
        if cfg.checkpoint_on_sigterm:
            def on_term(signum, frame):
                stop[0] = True
                if callable(prev_handler):
                    prev_handler(signum, frame)
            try:
                prev_handler = signal.signal(signal.SIGTERM, on_term)
                installed = True
            except ValueError:
                warnings.warn("checkpoint_on_sigterm: fit is not on the main thread, so no "
                              "SIGTERM handler; preemption will not checkpoint",
                              RuntimeWarning, stacklevel=2)

        state = self.state
        ring_n = max(cfg.loss_ring, 0)
        if ring_n and state.loss_ring is None:
            raise ValueError("TrainerConfig.loss_ring > 0 but the train state carries no ring")
        fetch_every = ring_n or cfg.log_every
        gate_prev = state.gate_events.cpu() if state.gate_events is not None else None
        # the profiler window, clamped into this fit (trainer.py:1289-1292)
        profile_at = max(1, min(cfg.profile_at_step, max(total_steps - cfg.profile_steps + 1, 1)))
        profiler = None

        def newest_losses(n: int) -> list[float]:
            """The last `n` steps' losses: the window's, or the ring's slots."""
            if not ring_n:
                return _fetch_losses(window[-n:]) if n else []
            ring = _fetch_losses([state.loss_ring])[0]
            n = min(n, ring_n)
            return [ring[(state.step - n + k) % ring_n] for k in range(n)]

        def close_profiler() -> None:
            nonlocal profiler
            if cuda:
                torch.cuda.synchronize()
            profiler.__exit__(None, None, None)
            path = os.path.join(cfg.profile_dir, f"trace_step{state.step}.json")
            profiler.export_chrome_trace(path)
            history["profile_trace"] = path
            profiler = None

        cuda = self.device.type == "cuda"
        upload = prefetch_to_device(data, self.device, depth=max(cfg.pipeline_depth, 1))
        window: list[torch.Tensor] = []
        inflight: list[torch.cuda.Event] = []
        losses, steps_in_window, t0 = [], 0, time.perf_counter()
        try:
            batch = next(upload) if total_steps > 0 else None
            for i in range(total_steps):
                if stop[0]:
                    history["preempted"] = True
                    break
                if cfg.profile_dir is not None:
                    if i + 1 == profile_at and profiler is None:
                        os.makedirs(cfg.profile_dir, exist_ok=True)
                        activities = [torch.profiler.ProfilerActivity.CPU]
                        if cuda:
                            activities.append(torch.profiler.ProfilerActivity.CUDA)
                        profiler = torch.profiler.profile(activities=activities)
                        profiler.__enter__()
                    elif profiler is not None and i + 1 == profile_at + cfg.profile_steps:
                        close_profiler()
                monitored = (self._step_monitored is not None
                             and (i + 1) % cfg.numerics_cadence == 0)
                if monitored:
                    loss, aux = self.train_step_monitored(batch)
                else:
                    loss = self.train_step(batch)
                if not ring_n:
                    window.append(loss)
                bsz = batch["sample"].shape[0]
                if cuda and cfg.pipeline_depth > 0:
                    done = torch.cuda.Event()
                    done.record()
                    inflight.append(done)
                    while len(inflight) > cfg.pipeline_depth:
                        oldest = inflight.pop(0)
                        if not oldest.query():
                            oldest.synchronize()
                if i + 1 < total_steps:
                    batch = next(upload)
                if monitored:
                    # the one wait a cadence step pays: its aux
                    flat = flatten_aux(aux)
                    history["numerics"].append({"step": state.step, **flat})
                    history["skipped_steps"] += int(flat.get("numerics/skipped", 0.0) > 0)
                steps_in_window += 1
                recovered = False
                if (i + 1) % fetch_every == 0 or i == total_steps - 1:
                    inflight.clear()
                    vals = newest_losses(steps_in_window)
                    window = []
                    loss = vals[-1]
                    metrics: Dict[str, Any] = {}
                    if gate_prev is not None:
                        # the window fetch settled the card: no further wait.
                        # A rollback rewinds the count below the baseline
                        events = state.gate_events.cpu()
                        delta = (events - gate_prev).clamp_min(0).tolist()
                        gate_prev = events
                        if any(delta):
                            metrics["gate_activations"] = delta
                            history["gate_activations"].append(
                                {"step": state.step, "params": delta[0],
                                 "opt_state": delta[1], "ema": delta[2]})
                    if any(self._abnormal(v) for v in vals):
                        self._recover(next(v for v in vals if self._abnormal(v)))
                        recovered = True
                    else:
                        ips = steps_in_window * bsz / max(time.perf_counter() - t0, 1e-9)
                        losses.append(loss)
                        history["steps"].append(i + 1)
                        history["loss"].append(loss)
                        history["imgs_per_sec"].append(ips)
                        metrics.update(imgs_per_sec=ips, loss_window_mean=float(np.mean(vals)))
                        if ring_n:
                            metrics["window_losses"] = vals
                        for cb in callbacks:
                            cb(i + 1, loss, metrics)
                        if cfg.keep_best_state and loss < self.best_loss:
                            self._snapshot_best(loss)
                    steps_in_window, t0 = 0, time.perf_counter()
                if not recovered and save_every and (i + 1) % save_every == 0:
                    bad = None
                    if not cfg.gate_nonfinite and steps_in_window:
                        # no gate: a non-finite update may have landed, so
                        # the save reads the newest loss first
                        bad = next((v for v in newest_losses(1) if self._abnormal(v)), None)
                    if bad is None:
                        save()
                    else:
                        self._recover(bad)
                        window, steps_in_window, t0 = [], 0, time.perf_counter()
            save()
        finally:
            upload.close()
            if profiler is not None:
                close_profiler()
            if installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
        history["final_loss"] = losses[-1] if losses else float("nan")
        history["best_loss"] = self.best_loss
        return history
