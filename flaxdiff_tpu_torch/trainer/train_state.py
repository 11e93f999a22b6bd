"""Train state (counterpart of ``flaxdiff_tpu/trainer/train_state.py``): the
module's parameters, an f32 EMA copy, the optimizer state, the step and,
as configured, the dynamic loss scale, the loss ring and the gate counter.

The parameters live in one flat f32 buffer that every parameter of the
module views, and the EMA, both moments and the accumulator of gradient
accumulation are flat buffers of the same layout. The optimizer update, the
EMA and the non-finite gate are then a few elementwise ops over a few
tensors, not a few per parameter, as the JAX step fuses them into one
program.

Two counts are kept apart, as in the JAX state: ``step`` (a host int) counts
calls of the step and advances on every one, and ``count`` (an int32 on the
device, optax's count) counts the updates that landed: it drives Adam's bias
corrections and the learning-rate schedule, and stays where it is on a step
the loss scale rejected and on the micro-steps of an accumulation. Both are
checkpointed.

Under a mesh (``mesh=``, ``parallel.create_mesh``) the flat buffers are
sharded over its fsdp dim, the counterpart of the JAX package's per-leaf
FSDP specs (``parallel/partition.py`` ``fsdp_sharding_tree``) in the design
of FSDP1's flat parameter: params, EMA, both moments and the accumulator are
padded with zeros to a multiple of the fsdp size and each rank keeps one
contiguous slice (``params`` is then the rank's slice). Before the forward
``gather_params`` fills the whole buffer the module views
(``all_gather``); ``grads`` reduce-scatters the backward's flat gradient
over fsdp, all-reduces it over data and divides by data x fsdp, leaving
each rank its slice of the global batch's mean gradient. The optimizer, the
EMA and the gate are elementwise, so they run on the slice; the clip's
global norm, lamb's per-parameter norms, the loss scale's verdict and the
gate counter sum their partials across the ranks. The padding stays zero and
never enters a norm, the counter or a checkpoint. Collectives run even on a
group of one rank.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..parallel import collectives
from ..telemetry.numerics import segment_norms, tree_nonfinite_count
from .loss_scale import DynamicScale
from .optim import AdamW, MultiSteps, Optimizer, as_chain, every_k

__all__ = ["AdamW", "TrainState"]

# the buffers the optimizer owns (optax's opt_state), by kind
_OPT_FLOATS = ("exp_avg", "exp_avg_sq", "acc")
_OPT_INTS = ("count", "mini_step")
# the buffers of the parameters' flat layout, sharded under a mesh
_FLAT = ("params", "ema") + _OPT_FLOATS


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 sqrt, correctly rounded as XLA's is. torch's vectorised CPU sqrt
    is an ulp off in ~0.6% of values, so CPU tensors take it in f64 (exact
    after the one rounding to f32); CUDA's sqrt is IEEE."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


class TrainState:
    """Params (a flat f32 buffer the module's parameters view), EMA, Adam
    moments, the optimizer's count and the step. `tx` is an ``AdamW``, a
    ``Chain`` of gradient transforms ending in one, or a ``MultiSteps`` of
    either (``trainer/optim.py``); MultiSteps adds the accumulator ``acc``
    and the ``mini_step``. `dynamic_scale`: the float16 loss scale the step
    uses; `loss_ring_size` > 0 keeps a device ring of that many losses,
    written at ``step % size``; `gate_counter` keeps a [3] int32 count of
    the elements the non-finite gate masked in params / optimizer state /
    EMA. `mesh`: shard the flat buffers over its fsdp dim and reduce the
    gradients over data x fsdp (the module above); None keeps one process's
    whole state."""

    def __init__(self, model: nn.Module, tx: Optimizer, ema_decay: Optional[float] = 0.999,
                 dynamic_scale: Optional[DynamicScale] = None, loss_ring_size: int = 0,
                 gate_counter: bool = False, mesh=None):
        params = list(model.named_parameters())
        if any(p.dtype != torch.float32 for _, p in params):
            raise TypeError("the train state keeps f32 parameters")
        self.model, self.tx, self.mesh = model, tx, mesh
        self.layout = []          # (name, offset, shape)
        offset = 0
        for name, p in params:
            self.layout.append((name, offset, p.shape))
            offset += p.numel()
        self.numel = offset
        self.lengths = [shape.numel() for _, _, shape in self.layout]
        flat = torch.cat([p.detach().reshape(-1) for _, p in params])
        if mesh is None:
            # the module views the state's own params
            self.params = self.module_params = flat
            self.shard_offset, self.shard_size = 0, offset
            self._seg_lengths = self.lengths
        else:
            self._init_shards(flat)
        for (_, p), (_, off, shape) in zip(params, self.layout):
            p.data = self.module_params[off:off + p.numel()].view(shape)
        dev = self.params.device
        self._lengths = torch.tensor(self._seg_lengths, device=dev)
        self.exp_avg = torch.zeros_like(self.params)
        self.exp_avg_sq = torch.zeros_like(self.params)
        self.ema = self.params.clone() if ema_decay is not None else None
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        accumulate = isinstance(tx, MultiSteps)
        self.acc = torch.zeros_like(self.params) if accumulate else None
        self.mini_step = torch.zeros((), dtype=torch.int32, device=dev) if accumulate else None
        self.dynamic_scale = None if dynamic_scale is None else dynamic_scale.to(dev)
        self.loss_ring = (torch.zeros(loss_ring_size, dtype=torch.float32, device=dev)
                          if loss_ring_size > 0 else None)
        self.gate_events = torch.zeros(3, dtype=torch.int32, device=dev) if gate_counter else None
        self.step = 0
        self._table: Optional[torch.Tensor] = None

    # -- the fsdp shards --------------------------------------------------------

    def _init_shards(self, flat: torch.Tensor) -> None:
        """Every rank starts from global rank 0's params; this rank keeps its
        slice of them padded to a multiple of the fsdp size. A mesh without
        an fsdp (or data) dim has nothing to shard (or reduce) over it."""
        from ..parallel.mesh import AXIS_DATA, AXIS_FSDP, axis_group, axis_rank, axis_size
        mesh = self.mesh
        self._fsdp_group, self._data_group = axis_group(mesh, AXIS_FSDP), axis_group(mesh, AXIS_DATA)
        self.fsdp_size = axis_size(mesh, AXIS_FSDP)
        self.batch_ranks = axis_size(mesh, AXIS_DATA) * self.fsdp_size
        collectives.check_device(None, flat)
        torch.distributed.broadcast(flat, src=0)
        padded = -(-self.numel // self.fsdp_size) * self.fsdp_size
        self.shard_size = padded // self.fsdp_size
        self.shard_offset = axis_rank(mesh, AXIS_FSDP) * self.shard_size
        self.module_params = torch.zeros(padded, dtype=flat.dtype, device=flat.device)
        self.module_params[:self.numel] = flat
        # without an fsdp dim the slice is the whole buffer the module views
        self.params = self.module_params if self._fsdp_group is None else \
            self.module_params[self.shard_offset:self.shard_offset + self.shard_size].clone()
        # each parameter's piece of this slice, then the slice's padding
        lo, hi = self.shard_offset, self.shard_offset + self.shard_size
        self._seg_lengths = [max(0, min(off + n, hi) - max(off, lo))
                             for (_, off, _), n in zip(self.layout, self.lengths)]
        self._seg_lengths.append(self.shard_size - sum(self._seg_lengths))

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole flat buffer of this layout (itself
        without a mesh)."""
        if self.mesh is None:
            return full
        full = torch.as_tensor(full).to(self.params.device).reshape(-1)
        lo = self.shard_offset
        piece = full[lo:min(lo + self.shard_size, self.numel)]
        return torch.cat([piece, piece.new_zeros(self.shard_size - piece.numel())])

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole flat buffer from the fsdp ranks' slices (a collective
        under a mesh; the buffer itself without one)."""
        if self.mesh is None:
            return shard
        if self._fsdp_group is None:
            return shard[:self.numel]
        return collectives.all_gather_flat(shard, self._fsdp_group)[:self.numel]

    def gather_params(self) -> None:
        """Fill the buffer the module views from the ranks' param slices
        (before a forward); nothing to do without a mesh."""
        if self.mesh is not None and self._fsdp_group is not None:
            collectives.all_gather_into(self.module_params, self.params, self._fsdp_group)

    def mean_over_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data x fsdp ranks of a per-rank value (each
        rank's mean over its rows: their mean is the global batch's), the
        same on every rank; `x` itself without a mesh."""
        if self.mesh is None:
            return x
        out = x.detach().float().reshape(1).clone()
        for group in (self._fsdp_group, self._data_group):
            if group is not None:
                collectives.all_reduce_(out, group)
        return (out / self.batch_ranks).reshape(x.shape)

    def all_ranks(self, flag: torch.Tensor) -> torch.Tensor:
        """A device bool true on every rank of the world (itself without a
        mesh): one verdict for the whole world."""
        if self.mesh is None:
            return flag
        out = flag.reshape(1).to(torch.int32)
        collectives.all_reduce_(out, None, torch.distributed.ReduceOp.MIN)
        return out.reshape(flag.shape).bool()

    def _sum_over_shards(self, partial: torch.Tensor) -> torch.Tensor:
        """Sum a per-slice partial over the fsdp ranks (the data replicas
        hold the same slices)."""
        if self.mesh is None or self._fsdp_group is None:
            return partial
        return collectives.all_reduce_(partial.clone(), self._fsdp_group)

    def global_norm(self, flat: torch.Tensor) -> torch.Tensor:
        """The L2 norm of a flat buffer of this layout: the slices' squared
        norms summed across the ranks before the root (at one rank the root
        of a squared norm gives the norm back exactly)."""
        norm = torch.linalg.vector_norm(flat)
        if self.mesh is None:
            return norm
        return _sqrt(self._sum_over_shards((norm * norm).reshape(1))).reshape(())

    def segment_norms(self, flat: torch.Tensor) -> torch.Tensor:
        """Each parameter's L2 norm (under a mesh, then the slice's padding,
        0), the slices' squared norms summed across the ranks."""
        norms = segment_norms(flat, self._seg_lengths)
        if self.mesh is None:
            return norms
        return _sqrt(self._sum_over_shards(norms * norms))

    # -- layout --------------------------------------------------------------------

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Parameter name -> its view of a flat buffer of this layout."""
        return {name: flat[off:off + shape.numel()].view(shape)
                for name, off, shape in self.layout}

    def flatten(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """A flat buffer of this layout from name -> tensor."""
        return torch.cat([torch.as_tensor(tensors[name], dtype=torch.float32).reshape(-1)
                          for name, _, _ in self.layout]).to(self.params.device)

    def grads(self, loss: torch.Tensor) -> torch.Tensor:
        """d loss / d params as one flat buffer (zeros where unused); under a
        mesh this rank's slice of its mean over the data x fsdp ranks."""
        params = [p for p in self.model.parameters()]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        parts = [(torch.zeros_like(p) if g is None else g).reshape(-1)
                 for p, g in zip(params, grads)]
        if self.mesh is None:
            return torch.cat(parts)
        pad = self.module_params.numel() - self.numel
        shard = torch.cat(parts + [parts[0].new_zeros(pad)])
        if self._fsdp_group is not None:
            shard = collectives.reduce_scatter_flat(shard, self._fsdp_group)
        if self._data_group is not None:
            collectives.all_reduce_(shard, self._data_group)
        return shard / self.batch_ranks

    # -- the optimizer chain -----------------------------------------------------

    def _schedule(self) -> torch.Tensor:
        """Rows ``[lr(c), 1 - b1^(c+1), 1 - b2^(c+1)]`` (f32) for every count
        c up to the step, on the device: the update gathers its row at the
        device count, so neither the schedule nor the bias corrections wait
        for the count. The count never exceeds the step, and the table
        grows by doubling."""
        have = 0 if self._table is None else self._table.shape[0]
        if self.step < have:
            return self._table
        tx = as_chain(self.tx).adam
        size = max(1024, 2 * (self.step + 1))
        b1, b2 = torch.tensor(tx.b1), torch.tensor(tx.b2)
        # f32 bias corrections, as optax computes 1 - decay ** count
        rows = np.array([(tx.lr(c), float(1.0 - b1 ** (c + 1)), float(1.0 - b2 ** (c + 1)))
                         for c in range(have, size)], dtype=np.float32)
        new = torch.from_numpy(rows).to(self.params.device)
        self._table = new if self._table is None else torch.cat([self._table, new])
        return self._table

    def _trust_ratio(self, update: torch.Tensor) -> torch.Tensor:
        """optax's scale_by_trust_ratio per parameter, ||p|| / ||u|| (1 where
        either is 0), spread over the parameter's elements."""
        pn = self.segment_norms(self.params)
        un = self.segment_norms(update)
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
        return torch.repeat_interleave(ratio, self._lengths, output_size=self.params.numel())

    def _update(self, grads: torch.Tensor) -> dict[str, torch.Tensor]:
        """The new params and optimizer state (not yet stored) for one
        update of the chain in optax's order of operations: the chain's
        transforms, Adam at the incremented count, the decoupled weight
        decay, the trust ratio, the learning rate at the count before it.
        Under MultiSteps the chain runs on the running mean of the
        micro-steps' gradients and its state and update land only on the
        emit step; the others add ``0 * update`` to the params
        (_accumulation.py:340-373)."""
        chain, k = as_chain(self.tx), every_k(self.tx)
        tx = chain.adam
        if k > 1:
            grads = self.acc + (grads - self.acc) / (self.mini_step + 1)
            acc = grads
        for transform in chain.transforms:
            grads = transform(grads, self.global_norm)
        # index_select, not [count]: a 0-dim index tensor is read back to the host
        lr, bc1, bc2 = self._schedule().index_select(0, self.count.view(1))[0].unbind()
        mu = (1.0 - tx.b1) * grads + tx.b1 * self.exp_avg
        nu = (1.0 - tx.b2) * (grads * grads) + tx.b2 * self.exp_avg_sq
        update = (mu / bc1) / (_sqrt(nu / bc2) + tx.eps)
        if tx.weight_decay:
            update = update + tx.weight_decay * self.params
        if tx.trust_ratio:
            update = update * self._trust_ratio(update)
        update = update * -lr
        new = {"exp_avg": mu, "exp_avg_sq": nu, "count": self.count + 1}
        if k > 1:
            emit = self.mini_step == k - 1
            new = {name: torch.where(emit, v, getattr(self, name)) for name, v in new.items()}
            new.update(acc=acc * ~emit, mini_step=(self.mini_step + 1) % k)
            update = update * emit
        new["params"] = self.params + update
        return new

    def apply_gradients(self, grads: torch.Tensor, ema_decay: Optional[float],
                        gate_nonfinite: bool = False, finite: Optional[torch.Tensor] = None,
                        loss: Optional[torch.Tensor] = None,
                        verdict: Optional[torch.Tensor] = None) -> None:
        """One step, in the JAX step's order (train_step.py:250-301): the
        optimizer update; with `finite` (the loss scale's verdict, a device
        bool) the params and optimizer state kept where it is False; the EMA
        ``ema * decay + params * (1 - decay)`` over the params that stand;
        the loss ring's slot ``step % size`` set to `loss`; then the gate
        over params, optimizer state and EMA: with `verdict` (the monitored
        step's global one) every buffer keeps its old value where it is
        False, else with ``gate_nonfinite`` each element whose new value is
        not finite keeps its old one (``_finite_only_gate``); the gate
        counter adds what was masked. The step advances either way."""
        new = self._update(grads)
        old = {name: getattr(self, name) for name in new}
        if finite is not None:
            new = {name: torch.where(finite, v, old[name]) for name, v in new.items()}
        if self.ema is not None and ema_decay is not None:
            new["ema"] = self.ema * ema_decay + new["params"] * (1.0 - ema_decay)
            old["ema"] = self.ema
        if self.loss_ring is not None and loss is not None:
            self.loss_ring[self.step % self.loss_ring.numel()] = loss.detach().float()
        if verdict is not None or gate_nonfinite:
            if self.gate_events is not None:
                zero = torch.zeros((), dtype=torch.int32, device=self.params.device)
                count = lambda names: sum((tree_nonfinite_count(new[n]) for n in names
                                           if n in new), zero)
                counts = self._sum_over_shards(
                    torch.stack([count(("params",)), count(_OPT_FLOATS), count(("ema",))]))
                if verdict is not None:
                    counts = torch.where(verdict, torch.zeros_like(counts), counts)
                self.gate_events += counts
            if verdict is not None:
                new = {name: torch.where(verdict, v, old[name]) for name, v in new.items()}
            else:
                new = {name: v if name in _OPT_INTS
                       else torch.where(torch.isfinite(v), v, old[name])
                       for name, v in new.items()}
        for name, v in new.items():
            old[name].copy_(v)
        self.step += 1

    # -- checkpoints --------------------------------------------------------------

    def buffers(self) -> dict[str, Optional[torch.Tensor]]:
        """The state's tensors by name: what a checkpoint, a snapshot or a
        rollback holds. The four flat buffers always (the EMA None without
        one) and the count; the others as configured."""
        out = {"params": self.params, "ema": self.ema, "exp_avg": self.exp_avg,
               "exp_avg_sq": self.exp_avg_sq, "count": self.count}
        optional = {"acc": self.acc, "mini_step": self.mini_step,
                    "loss_ring": self.loss_ring, "gate_events": self.gate_events}
        if self.dynamic_scale is not None:
            optional.update(self.dynamic_scale.buffers())
        out.update({k: v for k, v in optional.items() if v is not None})
        return out

    def state_dict(self) -> dict[str, Any]:
        """Every buffer, the step and the layout ([name, shape] per
        parameter, in buffer order), the tensors as they are (no copy);
        under a mesh the flat buffers gathered whole (a collective every
        rank runs), so the format is one process's."""
        bufs = self.buffers()
        if self.mesh is not None:
            bufs = {k: self.gather(v) if k in _FLAT else v for k, v in bufs.items()}
        return {**bufs, "step": self.step,
                "layout": [[name, list(shape)] for name, _, shape in self.layout]}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a ``state_dict`` into this state's buffers in place (the
        module's parameters stay views of them). A checkpoint without a
        count (written before the count had its own buffer) takes its step
        as the count, which it was. Raises when the layout, a buffer's size,
        or which buffers there are differs."""
        layout = [[name, list(shape)] for name, _, shape in self.layout]
        saved = [[name, list(shape)] for name, shape in state["layout"]]
        if saved != layout:
            diff = next(((a, b) for a, b in zip(saved, layout) if a != b),
                        (len(saved), len(layout)))
            raise ValueError(f"checkpoint layout differs from the model's: {diff}")
        state = dict(state)
        if "count" not in state:
            state["count"] = torch.tensor(int(state["step"]), dtype=torch.int32)
        bufs = self.buffers()
        extra = [k for k, v in state.items() if isinstance(v, torch.Tensor) and k not in bufs]
        if extra:
            raise ValueError(f"the checkpoint has {extra}, which this state does not keep "
                             "(another --grad_accum, --dtype, --loss_ring or --gate_counter?)")
        for name, buf in bufs.items():
            src = state.get(name)
            if (buf is None) != (src is None):
                raise ValueError(f"{name}: the checkpoint has {'no ' * (src is None)}{name}, "
                                 f"the state {'none' if buf is None else 'one'}")
            if buf is not None:
                want = (self.numel,) if name in _FLAT else tuple(buf.shape)
                if tuple(src.shape) != want:
                    raise ValueError(f"{name}: shape {tuple(src.shape)}, want {want}")
                buf.copy_(self.shard(src) if name in _FLAT else src)
        self.step = int(state["step"])
        self.gather_params()
