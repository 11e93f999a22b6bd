"""The diffusion trainer (counterpart of the core of
``flaxdiff_tpu/trainer/trainer.py``): it owns the train state and a seeded
``torch.Generator`` on the device, draws each step's noise, timesteps and
CFG-dropout mask there (and, for latent diffusion, the codec's posterior
noise), runs the step, and drives the fit loop with
checkpoints, resume, preemption, abnormal-loss rollback, the float16 loss
scale, the monitored step at the numerics cadence, the loss ring, the gate
counter, a profiler window and, under an enabled telemetry hub, the run's
telemetry: phase timing (sampled every ``telemetry_sample_every`` steps),
goodput attribution, the MFU meter, memory gauges at log cadence, device
profile windows (``profile_cadence`` / ``profile_trigger``) and the program
registry's rows of the step and its monitored twin.

Under a mesh (``mesh=``, ``parallel.create_mesh`` over a process group:
one process per card, ``torchrun``) the state is sharded over fsdp and the
gradients reduced over data x fsdp (``TrainState``); each rank's batch holds
its data x fsdp block of the global batch's rows (ranks of one seq group the
same rows), and the step's draws are made for the global batch on every
rank alike, each keeping its rows: an N-rank step is the one-process step
on the global batch up to reduction order, and the generator's state is the
same on every rank. The step runs under ``use_mesh``, so attention layers
with ``backend="ring"`` or ``"ulysses"`` go sequence-parallel. Checkpoints
gather the shards and global rank 0 writes them; which step to restore and
whether SIGTERM stops the run (at a log step) are agreed across the ranks.
The monitored step (``numerics_cadence``) is not ported under a mesh.

Not ported (ROADMAP.md A14's second half): the anomaly detector's actions
other than ``warn`` (``skip_step``, ``rollback``) with the NaN provenance
probe, the watchdog, elastic worlds and coordinated restarts, and the data
plane.
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
from ..parallel import collectives
from ..parallel.context import use_mesh
from ..parallel.mesh import batch_shard
from ..device import DeviceLike, make_generator, resolve_device
from ..predictors import PredictionTransform
from ..resilience.events import record_event
from ..profiling import FlopCounter, MFUMeter, device_peak_flops, mfu
from ..schedulers.common import NoiseSchedule
from ..telemetry import global_telemetry
from ..telemetry.memory import MemoryMonitor
from ..telemetry.numerics import NumericsConfig, flatten_aux
from ..telemetry.programs import peak_allocated
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
    # device-profile windows (telemetry/devprof.py) under an enabled hub:
    # > 0 opens a torch.profiler window of `profile_steps` steps every
    # `profile_cadence` steps, parsed into a devprof.jsonl row reconciled
    # with the step's program row; the window's cost is `profile` badput
    profile_cadence: int = 0
    # when this file exists at a log step it is consumed and one window
    # opens at the next step
    profile_trigger: Optional[str] = None
    # under an enabled hub, the step's device time is closed (an event
    # synchronize) on every N-th step only; off-sample steps add no sync
    telemetry_sample_every: int = 1

# a first step no slower than this many median steady steps did not pay
# a build (the kernels were already built): its compile badput is moved
# back to productive at the end of the fit (the JAX package's ratio)
_COMPILE_RECLASS_RATIO = 2.0


def _fetch_losses(window: Sequence[torch.Tensor]) -> list[float]:
    """The window's losses on the host: one device-to-host copy, the fit
    loop's only wait on the card between windows."""
    return torch.stack(list(window)).cpu().tolist()


def _settle(event: torch.cuda.Event) -> None:
    """Wait for the card to reach `event`: a sampled step's device close
    under telemetry (the counterpart of ``block_until_ready``)."""
    event.synchronize()


def _batch_signature(batch: Mapping[str, Any]) -> str:
    return ",".join(f"['{k}']{tuple(v.shape)}" for k, v in sorted(batch.items())
                    if k in ("sample", "cond") and hasattr(v, "shape"))


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
                 autoencoder=None, telemetry=None, mesh=None):
        """`policy`: the mixed-precision policy; a float16 compute dtype
        keeps a dynamic loss scale in the state (trainer.py:335-339).
        `autoencoder`: latent diffusion, the codec frozen and moved to the
        trainer's device; batches stay pixels and are encoded in the step.
        `telemetry`: a ``telemetry.Telemetry`` hub (default: the
        process-global one, disabled unless replaced). `mesh`: a
        ``DeviceMesh`` of ``parallel.create_mesh`` (the module docstring);
        None trains in this process alone."""
        if config.gate_counter and not config.gate_nonfinite:
            raise ValueError("gate_counter counts the in-graph gate's activations — it requires "
                             "gate_nonfinite")
        if mesh is not None and config.numerics_cadence > 0:
            raise ValueError("numerics_cadence: the monitored step's norms over a sharded state "
                             "are not ported (ROADMAP.md A12's second half)")
        self.device = resolve_device(device)
        self.config = config
        self.telemetry = telemetry
        self.schedule = schedule.to(self.device)
        self.autoencoder = None if autoencoder is None else autoencoder.to(self.device)
        scale = None
        if policy is not None and policy.compute_dtype == torch.float16:
            scale = DynamicScale(device=self.device)
        self.mesh = mesh
        self.state = TrainState(model.to(self.device), optimizer, config.ema_decay,
                                dynamic_scale=scale, loss_ring_size=max(config.loss_ring, 0),
                                gate_counter=config.gate_counter, mesh=mesh)
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
        # under a mesh the draws are the global batch's, this rank keeping
        # its block of rows (one block of one without a mesh)
        block, blocks = (0, 1) if self.mesh is None else batch_shard(self.mesh)
        rows = x.shape[0] * blocks
        shape, vae_shape = (rows, *x.shape[1:]), None
        if self.autoencoder is not None:
            # the latent's shape (inputs/config.py's ceil division), and the
            # posterior mean's: a clip's frames folded into its batch
            d, c = self.autoencoder.downscale_factor, self.autoencoder.latent_channels
            *lead, h, w, _ = shape
            shape = (*lead, -(-h // d), -(-w // d), c)
            vae_shape = (math.prod(lead), *shape[-3:])
        mine = lambda a: a if a is None else a.view(blocks, -1, *a.shape[1:])[block]
        noise = mine(torch.randn(shape, generator=gen, device=dev))
        t = mine(self.schedule.sample_timesteps(gen, rows))
        uncond_mask = mine(torch.rand(rows, generator=gen, device=dev) < self.config.uncond_prob)
        vae_noise = mine(None if vae_shape is None else torch.randn(vae_shape, generator=gen,
                                                                    device=dev))
        if self.mesh is None:
            return step(self.state, batch, noise, t, uncond_mask, vae_noise)
        with use_mesh(self.mesh):
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
        # under a mesh the fsdp slices gathered whole: every rank calls this
        return {name: t.detach() for name, t in self.state.views(self.state.gather(flat)).items()}

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

    def _from_rank0(self, value: int) -> int:
        """Global rank 0's `value` on every rank (itself without a mesh)."""
        if self.mesh is None:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        collectives.check_device(None, t)
        torch.distributed.broadcast(t, src=0)
        return int(t.item())

    def _any_rank(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (itself without a mesh)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        collectives.all_reduce_(t, None, torch.distributed.ReduceOp.MAX)
        return bool(t.item())

    def latest_checkpoint_step(self) -> Optional[int]:
        """The newest complete checkpoint step (None without one); under a
        mesh global rank 0's answer, on every rank."""
        if self.checkpointer is None:
            return None
        step = self._from_rank0(-1 if (s := self.checkpointer.latest_step()) is None else s)
        return None if step < 0 else step

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
        if step is None and self.mesh is not None:
            step = self.latest_checkpoint_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.checkpointer.directory}")
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
        if self.latest_checkpoint_step() is not None:
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
        batches of `data` may be taken but unused when fit returns.

        Telemetry: every step's wall time is split into phases (``host``,
        ``data_wait``, ``device``, ``checkpoint``, ``numerics``,
        ``profile``, ``other``) and booked to the hub's goodput account
        (the first step and the monitored twin's first: ``compile``; later
        steps productive; ``data_stall``, ``checkpoint_commit``,
        ``numerics``, ``profile``); ``history["goodput"]`` is this fit's
        delta. Under an enabled hub a sampled step (every
        ``telemetry_sample_every``-th, the first, each log step) closes its
        device phase by synchronising a CUDA event recorded after it; its
        phase row goes to ``telemetry.jsonl``; the first step runs under
        ``profiling.FlopCounter`` for the model FLOPs behind the MFU
        (``history["mfu"]`` by window, ``mfu_device`` in the callbacks'
        metrics) and the program rows; memory gauges, the cross-host
        aggregate and a metrics snapshot go out at log cadence; profile
        windows open at ``profile_cadence`` or the ``profile_trigger``
        file. A disabled hub adds no sync, no file and no profiler."""
        cfg = self.config
        history: Dict[str, Any] = {"steps": [], "loss": [], "imgs_per_sec": [], "mfu": [],
                                   "preempted": False,
                                   "saves": {"started": 0, "skipped_exists": 0}}
        if cfg.numerics_cadence > 0:
            history.update(numerics=[], skipped_steps=0)
        if cfg.gate_counter:
            history["gate_activations"] = []

        # telemetry: phases and goodput always (host clocks only); the device
        # closes, rows, FLOPs, gauges and profile windows under an enabled hub
        tel = self.telemetry if self.telemetry is not None else global_telemetry()
        timed = tel.enabled
        cuda = self.device.type == "cuda"
        peak = device_peak_flops(self.device) if timed else None
        device_meter = MFUMeter(peak_flops=peak) if timed else None
        timer = tel.step_timer(mfu_meter=device_meter,
                               sample_every=max(cfg.telemetry_sample_every, 1))
        goodput = tel.goodput
        gp_base_prod, gp_base_bad = goodput.raw_counters()
        memory = MemoryMonitor(self.device) if timed else None
        devprof = None
        if timed and tel.devprof_path and (cfg.profile_cadence > 0
                                           or cfg.profile_trigger is not None):
            from ..telemetry.devprof import DeviceProfiler
            devprof = DeviceProfiler(tel.devprof_path, cadence=cfg.profile_cadence,
                                     window=max(cfg.profile_steps, 1),
                                     trigger_path=cfg.profile_trigger, metrics=tel.registry,
                                     cuda=cuda)
        compile_busies: list = []
        steady_busies: list = []
        # the program rows: FLOPs counted on each program's first call
        programs: Dict[str, Dict[str, Any]] = {}
        flops: Optional[float] = None

        if cfg.restore_at_start and self.latest_checkpoint_step() is not None:
            with goodput.measure_badput("restart"):
                self.restore_checkpoint()

        def save() -> None:
            if self.checkpointer is not None:
                self.save_checkpoint()
                history["saves"][self.checkpointer.last_save_result] += 1

        # under a mesh a SIGTERM stops the run at the next log step, once the
        # ranks agree (each rank's collectives must stay in one order)
        stop, prev_handler, installed = [False], None, False
        stop_agreed = False
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
                torch.cuda.synchronize(self.device)
            profiler.__exit__(None, None, None)
            path = os.path.join(cfg.profile_dir, f"trace_step{state.step}.json")
            profiler.export_chrome_trace(path)
            history["profile_trace"] = path
            profiler = None

        def run_step(kind: str, fn, batch):
            """One call of the step; a program's first call under an
            enabled hub runs inside the FLOP counter and is timed for its
            row."""
            if not timed or kind in programs:
                return fn(batch)
            t0 = time.perf_counter()
            with FlopCounter() as counter:
                out = fn(batch)
            programs[kind] = {"flops": counter.total, "host_s": time.perf_counter() - t0,
                              "key": f"{kind}:{_batch_signature(batch)}", "step": i + 1}
            return out

        def register_programs() -> None:
            """One program row per step program run so far (the JAX
            trainer's first log window), its compile_ms the first call's
            busy time (the build, the allocator's warm-up, the library's
            algorithm choice)."""
            if tel.programs is None:
                return
            for kind, info in programs.items():
                if (kind, info["key"]) in tel.programs:
                    continue
                busy = info.get("busy_s", info["host_s"])
                tel.programs.record(kind, info["key"], compile_ms=busy * 1e3,
                                    flops_jaxpr=info["flops"],
                                    hbm_peak_bytes=peak_allocated(self.device),
                                    extra={"first_call_step": info["step"]})

        def settle_step(idx: int, compile_step: bool) -> Dict[str, float]:
            """Close the step's phases, write its row when sampled, and book
            its wall time to the goodput account."""
            phases = timer.end_step()
            if timed and timer.last_row is not None:
                tel.record_step(timer.last_row)
            busy = phases.get("host", 0.0) + phases.get("device", 0.0) + phases.get("other", 0.0)
            if compile_step:
                goodput.record_badput("compile", busy)
                compile_busies.append(busy)
                for info in programs.values():
                    if info["step"] == idx + 1:
                        info["busy_s"] = busy
            else:
                goodput.record_productive(busy)
                if len(steady_busies) < 512:
                    steady_busies.append(busy)
            goodput.record_badput("data_stall", phases.get("data_wait", 0.0))
            goodput.record_badput("numerics", phases.get("numerics", 0.0))
            goodput.record_badput("profile", phases.get("profile", 0.0))
            goodput.record_badput("checkpoint_commit", phases.get("checkpoint", 0.0))
            return phases

        def reclassify_warm_compile() -> None:
            """A first step no slower than _COMPILE_RECLASS_RATIO x the median
            steady step built nothing: its busy time goes back to productive,
            with a ``warm_compile_reclassified`` event (needs 3 steady
            steps)."""
            if not compile_busies or len(steady_busies) < 3:
                return
            med = sorted(steady_busies)[len(steady_busies) // 2]
            for busy in compile_busies:
                if busy <= _COMPILE_RECLASS_RATIO * max(med, 1e-9):
                    moved = goodput.reattribute("compile", busy)
                    if moved > 0:
                        record_event("warm_compile_reclassified", "train.step",
                                     detail=f"first-step busy {busy:.3f}s ~ steady median "
                                            f"{med:.3f}s: nothing built; re-attributed "
                                            f"productive")
            compile_busies.clear()

        def close_devprof(at_step: Optional[int]) -> None:
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
            inflight.clear()
            register_programs()
            key = programs.get("train_step", {}).get("key")
            devprof.close(at_step, kind="train_step", key=key, programs=tel.programs)

        upload = prefetch_to_device(data, self.device, depth=max(cfg.pipeline_depth, 1))
        window: list[torch.Tensor] = []
        inflight: list[torch.cuda.Event] = []
        losses, steps_in_window, t0 = [], 0, time.perf_counter()
        monitored_compiled = False
        i = 0
        try:
            with goodput.measure_badput("data_stall"):
                batch = next(upload) if total_steps > 0 else None
            for i in range(total_steps):
                if stop[0] if self.mesh is None else stop_agreed:
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
                compile_step = i == 0 or (monitored and not monitored_compiled)
                log_step = (i + 1) % fetch_every == 0 or i == total_steps - 1
                timer.begin_step(i + 1)
                if compile_step or log_step:
                    # these steps wait on the card anyway: an exact sample
                    timer.mark_sampled()
                if devprof is not None:
                    if devprof.should_close(i + 1):
                        with timer.phase("profile"):
                            close_devprof(i + 1)
                    elif devprof.should_open(i + 1):
                        with timer.phase("profile"):
                            devprof.open(i + 1)
                with timer.phase("host"):
                    if monitored:
                        loss, aux = run_step("train_step_monitored",
                                             self.train_step_monitored, batch)
                        monitored_compiled = True
                    else:
                        loss = run_step("train_step", self.train_step, batch)
                if not ring_n:
                    window.append(loss)
                bsz = batch["sample"].shape[0] * (1 if self.mesh is None
                                                  else self.state.batch_ranks)
                done = None
                if cuda and (cfg.pipeline_depth > 0 or (timed and timer.sampled)):
                    done = torch.cuda.Event()
                    done.record()
                if cuda and cfg.pipeline_depth > 0:
                    inflight.append(done)
                    while len(inflight) > cfg.pipeline_depth:
                        oldest = inflight.pop(0)
                        if not oldest.query():
                            oldest.synchronize()
                if i + 1 < total_steps:
                    with timer.phase("data_wait"):
                        batch = next(upload)
                if timed and timer.sampled and done is not None:
                    # the device close: the device phase is the card's time
                    # still owed for every step since the last sample
                    with timer.phase("device"):
                        _settle(done)
                    inflight.clear()
                if monitored:
                    # the one wait a cadence step pays: its aux
                    with timer.phase("numerics"):
                        flat = flatten_aux(aux)
                        history["numerics"].append({"step": state.step, **flat})
                        history["skipped_steps"] += int(flat.get("numerics/skipped", 0.0) > 0)
                        if timed:
                            tel.record_numerics(flat, step=state.step)
                steps_in_window += 1
                recovered = False
                if log_step:
                    inflight.clear()
                    if self.mesh is not None:
                        stop_agreed = self._any_rank(stop[0])
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
                        dt = max(time.perf_counter() - t0, 1e-9)
                        ips = steps_in_window * bsz / dt
                        if flops is None and "train_step" in programs:
                            flops = programs["train_step"]["flops"]
                        step_mfu = mfu(flops, dt / steps_in_window, peak) if flops else None
                        losses.append(loss)
                        history["steps"].append(i + 1)
                        history["loss"].append(loss)
                        history["imgs_per_sec"].append(ips)
                        history["mfu"].append(step_mfu)
                        metrics.update(imgs_per_sec=ips, loss_window_mean=float(np.mean(vals)))
                        if step_mfu is not None:
                            metrics["mfu"] = step_mfu
                        if timed and flops and device_meter.steps:
                            device_meter.flops_per_step = flops
                            mfu_dev = device_meter.mfu()
                            if mfu_dev is not None:
                                metrics["mfu_device"] = mfu_dev
                        if ring_n:
                            metrics["window_losses"] = vals
                        for cb in callbacks:
                            cb(i + 1, loss, metrics)
                        if cfg.keep_best_state and loss < self.best_loss:
                            self._snapshot_best(loss)
                        if timed:
                            register_programs()
                            tel.gauge("train/loss").set(loss)
                            tel.gauge("train/imgs_per_sec").set(ips)
                            if step_mfu is not None:
                                tel.gauge("train/mfu").set(step_mfu)
                            memory.record(tel.registry)
                            agg = {"step_time": dt / steps_in_window, "imgs_per_sec": ips,
                                   "loss": loss}
                            if timer.last is not None:
                                agg["data_wait"] = timer.last.get("data_wait", 0.0)
                                agg["device_time"] = timer.last.get("device", 0.0)
                            tel.aggregate(agg, step=i + 1)
                            tel.export(step=i + 1)
                    steps_in_window, t0 = 0, time.perf_counter()
                if not recovered and save_every and (i + 1) % save_every == 0:
                    with timer.phase("checkpoint"):
                        bad = None
                        if not cfg.gate_nonfinite and steps_in_window:
                            # no gate: a non-finite update may have landed, so
                            # the save reads the newest loss first
                            bad = next((v for v in newest_losses(1) if self._abnormal(v)),
                                       None)
                        if bad is None:
                            with tel.span("ckpt.save", cat="checkpoint", args={"step": i + 1}):
                                save()
                            goodput.persist()
                        else:
                            self._recover(bad)
                            window, steps_in_window, t0 = [], 0, time.perf_counter()
                settle_step(i, compile_step)
                if devprof is not None and log_step:
                    devprof.poll_trigger()
            reclassify_warm_compile()
            with goodput.measure_badput("checkpoint_commit"), \
                    tel.span("ckpt.final_save", cat="checkpoint"):
                save()
        finally:
            upload.close()
            if profiler is not None:
                close_profiler()
            if devprof is not None and devprof.active():
                with goodput.measure_badput("profile"):
                    close_devprof(None)
            if installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
            if timed:
                try:
                    tel.flush()
                except OSError as e:
                    record_event("telemetry_lost", "telemetry.flush", detail=repr(e))
        history["final_loss"] = losses[-1] if losses else float("nan")
        history["best_loss"] = self.best_loss
        prod, bad = goodput.raw_counters()
        history["goodput"] = {
            "productive_s": prod - gp_base_prod,
            "badput_s": {k: round(v - gp_base_bad.get(k, 0.0), 6) for k, v in bad.items()
                         if v - gp_base_bad.get(k, 0.0) > 0.0}}
        return history
