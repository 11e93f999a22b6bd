"""Program engine for the serving scheduler (counterpart of
``flaxdiff_tpu/serving/engine.py``).

Owns the **program cache**: round callables built by the pipeline's
`DiffusionSampler` (``make_chunk_program`` and its cached kinds,
``make_terminal_program``), keyed on

    (kind, batch_bucket, scan_steps, resolution, sequence_length,
     channels, num_samples, sampler, guidance, use_ema, has_cond,
     has_uncond, cache_plan)

as the JAX engine keys its compiled programs, so repeat traffic builds
nothing. Where JAX compiles a program, a round callable here is a Python
closure run eagerly under ``torch.inference_mode()``: its first call pays
what a first call on the card pays (the kernels' nvcc build, cuDNN's
algorithm choice, the allocator's first blocks), which `prewarm` takes off
the request path. Hits and misses are counted at
`serving/program_cache_hits` / `serving/program_cache_misses`. Kinds:
"chunk" (uncached), "chunk_cached" (timestep cache), "chunk_spatial"
(timestep x spatial cache), "terminal".

Batching model: the batch axis holds requests, each row a block of the
request's `num_samples` samples with its own `NoiseSource` (by default a
generator seeded with the request's seed on the pipeline's device, drawn
in the solo loop's order: the initial noise, then each step's). Rows never
interact: a padding row, or a step past a row's last, draws zeros and
keeps its carry. So a batched request follows its solo trajectory: in
bucket 1 it is bit-identical to `DiffusionInferencePipeline.generate_samples`
with the same arguments (on the CPU and on the card); in larger buckets
it is up to the rounding of the batch's kernels, which on the card
depends on the bucket's size and the row's position and mates (the
determinism contract in `request.py`).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import make_generator
from ..samplers.common import NoiseSource, RowNoise
from ..utils import clip_images
from .request import SampleRequest, ServingFuture

# batch buckets the scheduler pads micro-batches up to; the largest is
# also the admission cap per round
DEFAULT_BATCH_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8)


def bucket_up(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n (the scheduler never builds a group larger
    than max(buckets))."""
    for b in sorted(buckets):
        if b >= n:
            return b
    return max(buckets)


def nfe_bucket(n: int) -> int:
    """Next power of two >= n: the run-to-completion round length, so
    nearby NFEs share one program (rows mask their own tail)."""
    b = 1
    while b < n:
        b *= 2
    return b


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device` without a device sync: to the card it goes
    through pinned memory as a non-blocking copy (a copy from pageable
    memory would wait for the whole device)."""
    if device.type != "cuda":
        return t.to(device)
    return t.contiguous().pin_memory().to(device, non_blocking=True)


def _rowify(state: Any, k: int) -> Any:
    """A sampler state with every 0-d leaf (multistep DPM's lambdas)
    broadcast to the row's k samples, so states stack along the batch."""
    if isinstance(state, torch.Tensor):
        return state.reshape(1).expand(k).clone() if state.ndim == 0 else state
    return type(state)(_rowify(s, k) for s in state)


def _cat_rows(parts: List[Any]) -> Any:
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return type(parts[0])(_cat_rows([p[i] for p in parts]) for i in range(len(parts[0])))


def _row_slice(state: Any, sl: slice) -> Any:
    if isinstance(state, torch.Tensor):
        return state[sl]
    return type(state)(_row_slice(s, sl) for s in state)


class RequestState:
    """One admitted request's device-resident trajectory carry."""

    __slots__ = ("req", "future", "submit_t", "admit_t", "group",
                 "x", "rng", "state", "pairs", "terminal_t", "nfe",
                 "done", "cond", "uncond", "compile_ms", "rounds",
                 "first_dispatch_t", "plan", "flags", "taps", "codes",
                 "trace", "attempts", "orig_req", "degraded")

    def __init__(self, req: SampleRequest, future: ServingFuture,
                 submit_t: float, admit_t: float, group: tuple,
                 x, rng, state, pairs, terminal_t: float,
                 cond, uncond, plan=None, flags=None, taps=None,
                 codes=None):
        self.req = req
        self.future = future
        self.submit_t = submit_t
        self.admit_t = admit_t
        self.group = group
        self.x = x                  # [num_samples, *sample_shape]
        self.rng = rng              # the row's NoiseSource
        self.state = state          # sampler state, leaves [num_samples, ...]
        self.pairs = pairs          # [nfe, 2] host trajectory pairs
        self.terminal_t = terminal_t
        self.nfe = int(req.diffusion_steps)
        self.done = 0               # completed trajectory steps
        self.cond = cond
        self.uncond = uncond
        self.compile_ms = 0.0
        self.rounds = 0
        self.first_dispatch_t: Optional[float] = None
        # training-free cache (docs/CACHING.md): the request's plan, its
        # host-side refresh flags or composed step codes, and its cache
        # carry (a dict holding the taps and, under a composed plan, the
        # score reference), which the row's own model calls read and write
        self.plan = plan
        self.flags = flags
        self.taps = taps
        self.codes = codes
        # request-scoped trace accumulator (telemetry/reqtrace.py);
        # None on the disabled hub — the scheduler attaches it
        self.trace = None
        # serving resilience (serving/supervision.py), attached by the
        # scheduler after prepare: failed-attempt count carried across
        # requeues, the pre-brownout request for a faithful replay, and
        # the brownout degradation flags surfaced on SampleResult
        self.attempts = 0
        self.orig_req = req
        self.degraded: tuple = ()

    @property
    def remaining(self) -> int:
        return self.nfe - self.done


class SamplerProgramEngine:
    """Prepares request carries and advances them in batched rounds
    over a `DiffusionInferencePipeline`, on the pipeline's device.

    `noise_factory(req) -> NoiseSource` gives a request's draws (default:
    a generator seeded with `req.seed` on the pipeline's device, the solo
    pipeline's); tests pass another implementation's draws through it."""

    def __init__(self, pipeline, telemetry=None,
                 noise_factory: Optional[Callable[[SampleRequest], NoiseSource]] = None):
        self.pipeline = pipeline
        if telemetry is None:
            from ..telemetry import global_telemetry
            telemetry = global_telemetry()
        self.telemetry = telemetry
        self.noise_factory = noise_factory or (
            lambda req: NoiseSource(make_generator(req.seed, pipeline.device)))
        self._programs: Dict[tuple, Any] = {}
        # last dispatched round's provenance (program kind/key, bucket,
        # live steps, cache-plan codes) — written by advance()/finalize()
        # on the single dispatch thread, read by the scheduler's request
        # tracer right after the call. None until the first round.
        self.last_round_info: Optional[Dict[str, Any]] = None
        self.last_finalize_info: Optional[Dict[str, Any]] = None

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    # -- keys -----------------------------------------------------------------
    def _plan_for(self, req: SampleRequest):
        """The request's effective plan — None, a `CachePlan` (timestep
        axis) or a `ComposedPlan` (timestep x spatial), normalized so
        degenerate axes route to the simpler program. None when absent,
        disabled, or the pipeline's model cannot honor it (counted at
        `serving/cache_unsupported` — the request still runs, uncached,
        preserving the bit-exact default)."""
        from ..ops.diffcache import model_supports_cache
        from ..ops.spatialcache import ComposedPlan, resolve_plan
        plan = resolve_plan(req.cache_plan)
        if plan is None:
            return None
        base = plan.cache if isinstance(plan, ComposedPlan) else plan
        if not model_supports_cache(self.pipeline.model, base):
            self.telemetry.counter("serving/cache_unsupported").inc()
            return None
        return plan

    def group_key(self, req: SampleRequest) -> tuple:
        """Compatibility key: requests sharing it may ride one round.
        NFE is deliberately absent — rows mask their own trajectory
        length, so short requests don't queue behind long ones. The
        cache plan IS present (last element): plans change the program,
        so two plans must never share a round or a program."""
        use_ema = bool(req.use_ema and self.pipeline.ema_params is not None)
        ic = self.pipeline.input_config
        conditional = bool(ic is not None and ic.conditions)
        has_cond = bool(req.prompts is not None
                        or req.conditioning is not None or conditional)
        # CFG pairs a null embedding with the prompt — mirror
        # generate_samples: uncond exists only on the prompted path
        has_uncond = bool((req.prompts is not None
                           or req.conditioning is not None)
                          and conditional)
        plan = self._plan_for(req)
        return (int(req.resolution), req.sequence_length,
                int(req.channels), int(req.num_samples),
                str(req.sampler), float(req.guidance_scale),
                use_ema, has_cond, has_uncond,
                plan.key() if plan is not None else None)

    def _program_key(self, kind: str, group: tuple, bucket: int,
                     scan_steps: int) -> tuple:
        return (kind, int(bucket), int(scan_steps)) + group

    def _get_program(self, kind: str, group: tuple, bucket: int,
                     scan_steps: int, build) -> Tuple[Any, bool]:
        key = self._program_key(kind, group, bucket, scan_steps)
        prog = self._programs.get(key)
        if prog is not None:
            self.telemetry.counter("serving/program_cache_hits").inc()
            return prog, False
        self.telemetry.counter("serving/program_cache_misses").inc()
        prog = build()
        self._programs[key] = prog
        return prog, True

    @property
    def program_cache_size(self) -> int:
        return len(self._programs)

    # -- request admission ----------------------------------------------------
    def _sampler_for(self, req: SampleRequest):
        return self.pipeline.get_sampler(req.sampler, req.guidance_scale,
                                         cache_plan=self._plan_for(req))

    def _conditioning(self, req: SampleRequest):
        """(cond, uncond) on the device, as `generate_samples` builds them:
        the prompts' encoding with the null tokens as the unconditional
        input, or the null tokens alone for a prompt-less conditional
        model."""
        pipe, dev, k = self.pipeline, self.pipeline.device, req.num_samples
        ic = pipe.input_config
        conditional = ic is not None and ic.conditions
        cond = uncond = None
        if req.conditioning is not None:
            cond = torch.as_tensor(req.conditioning, dtype=torch.float32)
            if conditional:
                uncond = ic.get_unconditionals(batch_size=k)[0]
        elif req.prompts is not None:
            if not conditional:
                raise ValueError("pipeline has no conditioning inputs")
            cond = ic.conditions[0].encoder(list(req.prompts))
            uncond = ic.get_unconditionals(batch_size=k)[0]
        elif conditional:
            cond = ic.get_unconditionals(batch_size=k)[0]
        return tuple(None if c is None else upload(c, dev) for c in (cond, uncond))

    def prepare(self, req: SampleRequest, future: ServingFuture,
                submit_t: float, admit_t: float) -> RequestState:
        """Build the device-resident carry for one request — the state a
        solo `generate_samples` call reaches right before its loop, so the
        batched trajectory continues it draw for draw."""
        k = req.num_samples
        ds = self._sampler_for(req)
        resolution, channels = int(req.resolution), int(req.channels)
        if ds.autoencoder is not None:
            resolution = resolution // ds.autoencoder.downscale_factor
            channels = ds.autoencoder.latent_channels
        if req.sequence_length is not None:
            shape = (k, req.sequence_length, resolution, resolution, channels)
        else:
            shape = (k, resolution, resolution, channels)
        with torch.inference_mode():
            cond, uncond = self._conditioning(req)
            noise = self.noise_factory(req)
            x = noise.normal(shape) * ds.schedule.max_noise_std()
            state = _rowify(ds.sampler.init_state(x), k)
        pairs, terminal_t = ds.trajectory_inputs(int(req.diffusion_steps))
        plan = self._plan_for(req)
        flags = taps = codes = None
        if plan is not None:
            # host-side numpy schedule (zero device work) and an empty
            # carry: step 0 of every plan refreshes, which fills it
            taps = {}
            if ds.spatial_active:
                codes = plan.step_codes(int(req.diffusion_steps))
            else:
                flags = plan.flags(int(req.diffusion_steps))
        return RequestState(
            req=req, future=future, submit_t=submit_t, admit_t=admit_t,
            group=self.group_key(req), x=x, rng=noise, state=state,
            pairs=pairs, terminal_t=terminal_t, cond=cond, uncond=uncond,
            plan=plan, flags=flags, taps=taps, codes=codes)

    # -- batched rounds -------------------------------------------------------
    def _stack_rows(self, rows: List[RequestState], bucket: int):
        """Stack per-row carries, replicating row 0 into padding slots
        (inert: they are never live, draw nothing, and their output is
        discarded)."""
        srcs = rows + [rows[0]] * (bucket - len(rows))
        group = rows[0].group
        x = torch.cat([r.x for r in srcs])
        state = _cat_rows([r.state for r in srcs])
        cond = torch.cat([r.cond for r in srcs]) if group[7] else None
        uncond = torch.cat([r.uncond for r in srcs]) if group[8] else None
        return x, state, cond, uncond

    def _round_inputs(self, rows: List[RequestState], bucket: int, round_steps: int):
        """The round's per-sample step table on the device ([round_steps, 4,
        bucket * k]: t_cur, t_next, global step index, live), one upload,
        and the live flags per row on the host."""
        k = rows[0].req.num_samples
        meta = torch.zeros(round_steps, 4, bucket * k)
        steps = torch.arange(round_steps)
        n_act = []
        for j, r in enumerate(rows + [rows[0]] * (bucket - len(rows))):
            live = max(0, min(r.remaining, round_steps)) if j < len(rows) else 0
            sl = r.pairs[r.done:r.done + round_steps]
            if sl.shape[0] == 0:        # exhausted padding row
                sl = r.pairs[-1:].expand(round_steps, 2)
            elif sl.shape[0] < round_steps:
                sl = torch.cat([sl, sl[-1:].expand(round_steps - sl.shape[0], 2)])
            cols = slice(j * k, (j + 1) * k)
            meta[:, 0, cols] = sl[:, :1]
            meta[:, 1, cols] = sl[:, 1:]
            meta[:, 2, cols] = (r.done + steps).float()[:, None]
            meta[:, 3, cols] = (steps < live).float()[:, None]
            n_act.append(live)
        live = [[i < n for n in n_act] for i in range(round_steps)]
        return upload(meta, self.device), live, n_act

    def _round_codes(self, rows: List[RequestState], round_steps: int, spatial: bool):
        """Round-level cache schedule: per step, the OR of each row's own
        offset-aligned flags, or the MAX of its composed codes (refresh
        beats spatial beats reuse) — no row gets LESS refresh than its
        plan scheduled; round-mates can only add fidelity."""
        want = [0] * round_steps
        for r in rows:
            w = (r.codes if spatial else r.flags)[r.done:r.done + round_steps]
            for j in range(len(w)):
                want[j] = max(want[j], int(w[j]))
        return want

    def advance(self, rows: List[RequestState], bucket: int,
                round_steps: int) -> Tuple[List[RequestState], float]:
        """Run one round: every row advances min(remaining, round_steps)
        steps of its own trajectory. Returns (rows that completed their
        trajectory this round, first-call seconds — 0 on a cache hit)."""
        group = rows[0].group
        self.pipeline._load(group[6])
        ds = self._sampler_for(rows[0].req)
        with torch.inference_mode():
            return self._advance(ds, rows, bucket, round_steps)

    def _advance(self, ds, rows, bucket, round_steps):
        group = rows[0].group
        plan = rows[0].plan             # group-uniform (plan is in the key)
        x, state, cond, uncond = self._stack_rows(rows, bucket)
        meta, live, n_act = self._round_inputs(rows, bucket, round_steps)
        k = rows[0].req.num_samples
        noise = RowNoise([r.rng for r in rows] + [None] * (bucket - len(rows)), k,
                         device=self.device)

        t0 = time.perf_counter()
        want = None             # cache-plan step codes this round ran
        if plan is None:
            kind = "chunk"
            program, miss = self._get_program(
                kind, group, bucket, round_steps,
                lambda: ds.make_chunk_program(round_steps))
            x_n, state_n = program(x, noise, meta, live, cond, uncond, state)
        else:
            spatial = ds.spatial_active
            kind = "chunk_spatial" if spatial else "chunk_cached"
            want = self._round_codes(rows, round_steps, spatial)
            program, miss = self._get_program(
                kind, group, bucket, round_steps,
                lambda: ds.make_cached_chunk_program(round_steps))
            conds = [(r.cond, r.uncond) for r in rows]
            x_n, state_n = program(x, noise, meta, live, conds, [r.taps for r in rows], state,
                                   want)
            self._count_cache_steps(rows, n_act, want, spatial)
        compile_s = (time.perf_counter() - t0) if miss else 0.0
        self.last_round_info = {
            "kind": kind,
            "key": str(self._program_key(kind, group, bucket, round_steps)),
            "bucket": int(bucket), "rows": len(rows),
            "steps": int(round_steps), "miss": bool(miss),
            "n_act": [int(v) for v in n_act[:len(rows)]],
        }
        if want is not None:
            self.last_round_info["codes"] = want

        finished: List[RequestState] = []
        for i, r in enumerate(rows):
            sl = slice(i * k, (i + 1) * k)
            r.x = x_n[sl]
            r.state = _row_slice(state_n, sl)
            r.done += int(n_act[i])
            r.rounds += 1
            r.compile_ms += compile_s * 1e3
            if r.remaining <= 0:
                finished.append(r)
        return finished, compile_s

    def _count_cache_steps(self, rows, n_act, want, spatial: bool) -> None:
        tel = self.telemetry
        tel.counter("serving/cache_rows").inc(len(rows))
        live = [want[j] for i in range(len(rows)) for j in range(n_act[i])]
        if spatial:
            tel.counter("serving/spatial_rows").inc(len(rows))
            tel.counter("serving/cache_refresh_steps").inc(sum(w == 2 for w in live))
            tel.counter("serving/spatial_steps").inc(sum(w == 1 for w in live))
            tel.counter("serving/cache_reused_steps").inc(sum(w == 0 for w in live))
        else:
            tel.counter("serving/cache_refresh_steps").inc(sum(bool(w) for w in live))
            tel.counter("serving/cache_reused_steps").inc(sum(not w for w in live))

    def finalize(self, rows: List[RequestState],
                 bucket: int) -> Tuple[torch.Tensor, float]:
        """Terminal denoise + (optional) decode + clip for completed
        rows. Returns ([R, num_samples, *sample_shape] on the device in
        row order, first-call seconds)."""
        group = rows[0].group
        self.pipeline._load(group[6])
        ds = self._sampler_for(rows[0].req)
        with torch.inference_mode():
            return self._finalize(ds, rows, bucket)

    def _finalize(self, ds, rows, bucket):
        group = rows[0].group
        x, _, cond, uncond = self._stack_rows(rows, bucket)
        k = rows[0].req.num_samples
        srcs = rows + [rows[0]] * (bucket - len(rows))
        t_term = upload(torch.tensor([r.terminal_t for r in srcs],
                                     dtype=torch.float32).repeat_interleave(k), self.device)
        program, miss = self._get_program(
            "terminal", group, bucket, 0, lambda: ds.make_terminal_program())
        t0 = time.perf_counter()
        x0 = program(x, t_term, cond, uncond)
        compile_s = (time.perf_counter() - t0) if miss else 0.0
        self.last_finalize_info = {
            "kind": "terminal",
            "key": str(self._program_key("terminal", group, bucket, 0)),
            "bucket": int(bucket), "miss": bool(miss),
        }
        x0 = x0[:len(rows) * k]
        if ds.autoencoder is not None:
            x0 = ds.autoencoder.decode(x0)
        return clip_images(x0.reshape((len(rows), k) + tuple(x0.shape[1:]))), compile_s

    # -- program-cache pre-warming -------------------------------------------
    def prewarm(self, reqs: List[SampleRequest], round_steps: int,
                batch_buckets: Tuple[int, ...]) -> Dict[str, Any]:
        """Run the hot (bucket, NFE, plan) programs once BEFORE admission
        opens, so first-call costs (the kernels' build, cuDNN's algorithm
        choice, the allocator's first blocks) never hit user traffic.

        Each request in `reqs` is a traffic prototype: for every batch
        bucket, one synthetic row is prepared and driven through the
        EXACT dispatch path — `prepare` -> `advance` rounds ->
        `finalize` — so the programs land under the very keys warm
        traffic computes. Outputs are discarded; the synthetic rounds DO
        count into the `serving/cache_*` step counters (they ran), and
        the first-call work is reported here rather than on any
        request's latency. Returns {"programs", "seconds"}; counted at
        `serving/prewarm_programs` / `serving/prewarm_ms`."""
        from .scheduler import _block_until_ready
        t0 = time.perf_counter()
        before = self.program_cache_size
        for req in reqs:
            rs = round_steps or nfe_bucket(int(req.diffusion_steps))
            for bucket in sorted(set(batch_buckets)):
                rows = [self.prepare(req, ServingFuture(), t0, t0)]
                while rows[0].remaining > 0:
                    finished, _ = self.advance(rows, bucket, rs)
                out, _ = self.finalize(finished, bucket)
                # settle before admission opens, so the warm-up's device
                # work does not overlap the first real round
                _block_until_ready(out)
        seconds = time.perf_counter() - t0
        programs = self.program_cache_size - before
        self.telemetry.counter("serving/prewarm_programs").inc(programs)
        self.telemetry.gauge("serving/prewarm_ms").set(seconds * 1e3)
        return {"programs": programs, "seconds": seconds}

    def plan_parallelism(self, *args, **kwargs):
        """The chips-per-request decision of the JAX engine comes from its
        parallelism planner, which the port does not have yet."""
        raise NotImplementedError(
            "plan_parallelism needs the parallelism planner, ROADMAP.md A12")
