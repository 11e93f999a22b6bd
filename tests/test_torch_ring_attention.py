"""The port's ring and Ulysses attention (``flaxdiff_tpu_torch/parallel/``)
on a world of 4 gloo processes, against the JAX package's
``ring_self_attention`` and ``ulysses_self_attention`` on its CPU mesh.

Forward and the q/k/v gradients through the attention dispatch
(``backend="ring"`` / ``"ulysses"`` under ``use_mesh``) on {seq: 4} and
{data: 2, seq: 2}, at ``tests/test_ring_attention.py``'s and
``tests/test_ulysses.py``'s tolerances; and the ring's hop loop driven by
the in-process transport, bit-equal on the CPU to the process-group one.
This file is its own worker (``tests/torch_world.py``): one world runs all
cases, and the test process computes the JAX references meanwhile.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import run_worker, spawn  # noqa: E402
if __name__ != "__main__":      # the test process (a worker imports no JAX)
    from test_torch_unet import one_torch_thread  # noqa: F401,E402 (autouse)

WORLD = 4
B, S, H, D = 2, 64, 4, 16          # D pads to 32 in the dispatch
MESHES = {"seq4": {"seq": 4}, "data2_seq2": {"data": 2, "seq": 2}}
BACKENDS = ("ring", "ulysses")
FWD_TOL, GRAD_TOL = 2e-5, 1e-4     # tests/test_ring_attention.py


def inputs():
    """q, k, v and the output cotangent, [B, S, H, D] f32, from a seed."""
    rng = np.random.default_rng(40)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4)]


# --- the worker -----------------------------------------------------------------

def _case_dispatch(rank, world, outdir):
    """Each mesh and backend: this rank's rows of the output and of the
    gradients, through the dispatch (its gate opens)."""
    import flaxdiff_tpu_torch.parallel.ring_attention as ra
    from flaxdiff_tpu_torch.ops.attention import dot_product_attention
    from flaxdiff_tpu_torch.parallel import batch_shard, create_mesh, use_mesh
    calls = {"n": 0}
    fwd = ra.ring_forward

    def counted(*a, **k):
        calls["n"] += 1
        return fwd(*a, **k)

    ra.ring_forward = counted
    q, k, v, cot = inputs()
    for mname, axes in MESHES.items():
        mesh = create_mesh(axes)
        block, blocks = batch_shard(mesh)
        rows = slice(block * B // blocks, (block + 1) * B // blocks)
        for backend in BACKENDS:
            ts = [torch.from_numpy(a[rows]).requires_grad_() for a in (q, k, v)]
            before = calls["n"]
            with use_mesh(mesh):
                out = dot_product_attention(*ts, backend=backend)
            (out * torch.from_numpy(cot[rows])).sum().backward()
            assert (calls["n"] > before) == (backend == "ring")
            np.savez(os.path.join(outdir, f"{mname}_{backend}_{rank}.npz"),
                     rows=np.arange(B)[rows], out=out.detach().numpy(),
                     **{f"d{n}": t.grad.numpy() for n, t in zip("qkv", ts)})
    ra.ring_forward = fwd


def _case_transport(rank, world, outdir):
    """The hop loop over a process-group ring of 4 against the same loop
    with every shard in one process (the in-process transport)."""
    from flaxdiff_tpu_torch.parallel import (InProcessTransport, ProcessGroupTransport,
                                             ring_backward, ring_forward)
    from flaxdiff_tpu_torch.parallel.collectives import all_gather_flat
    import torch.distributed as dist
    q, k, v, do = (torch.from_numpy(a).repeat(1, 1, 1, 2) for a in inputs())   # D 32
    shards = [list(t.chunk(world, 1)) for t in (q, k, v, do)]
    group = dist.new_group(list(range(world)))
    pg = ProcessGroupTransport(group)
    mine = [[s[rank]] for s in shards]
    (o,), (lse,) = ring_forward(*mine[:3], pg)
    grads = ring_backward(*mine[:3], [o], [lse], mine[3], pg)
    got = [all_gather_flat(t.contiguous(), group) for t in (o, lse, *[g[0] for g in grads])]
    if rank == 0:
        ip = InProcessTransport(world)
        outs, lses = ring_forward(*shards[:3], ip)
        dq, dk, dv = ring_backward(*shards[:3], outs, lses, shards[3], ip)
        want = [torch.cat(x) for x in (outs, lses, dq, dk, dv)]
        equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        np.save(os.path.join(outdir, "transport.npy"), np.array(equal))


CASES = {"dispatch": _case_dispatch, "transport": _case_transport}

if __name__ == "__main__":
    run_worker(CASES)


# --- the tests ------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world, started once for every case of the module."""
    outdir = str(tmp_path_factory.mktemp("ring_world"))
    w = spawn(os.path.abspath(__file__), WORLD, outdir)
    yield w, outdir
    w.kill()


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's output and q/k/v gradients for each mesh and backend, one
    program each (the port's world runs meanwhile)."""
    import jax
    import jax.numpy as jnp
    from flaxdiff_tpu.parallel import create_mesh as jax_mesh
    from flaxdiff_tpu.parallel.ring_attention import ring_self_attention
    from flaxdiff_tpu.parallel.ulysses import ulysses_self_attention
    q, k, v, cot = map(jnp.asarray, inputs())
    refs = {}
    for mname, axes in MESHES.items():
        mesh = jax_mesh(axes, devices=jax.devices()[:WORLD])
        for backend, fn in zip(BACKENDS, (ring_self_attention, ulysses_self_attention)):
            def run(a, b, c, fn=fn, mesh=mesh):
                out, vjp = jax.vjp(lambda x, y, z: fn(x, y, z, mesh), a, b, c)
                return out, vjp(cot)
            out, grads = jax.jit(run)(q, k, v)
            refs[mname, backend] = [np.asarray(out)] + [np.asarray(g) for g in grads]
    return refs


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_sequence_parallel_attention_matches_jax(world, jax_refs, mname, backend):
    """Every rank's rows of the output within 2e-5 and of dq, dk, dv within
    1e-4 of the JAX package's sequence-parallel attention on the same mesh
    (the seq ranks of a data row hold the same rows)."""
    w, outdir = world
    w.wait()
    out_ref, *grad_refs = jax_refs[mname, backend]
    for rank in range(WORLD):
        got = np.load(os.path.join(outdir, f"{mname}_{backend}_{rank}.npz"))
        rows = got["rows"]
        np.testing.assert_allclose(got["out"], out_ref[rows], rtol=FWD_TOL, atol=FWD_TOL)
        for name, ref in zip("qkv", grad_refs):
            np.testing.assert_allclose(got[f"d{name}"], ref[rows], rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=f"rank {rank} d{name}")


def test_in_process_transport_is_the_process_group_ring(world):
    """out, lse, dq, dk and dv of the hop loop bit-equal whether a process
    group or one process holds the 4 shards."""
    w, outdir = world
    w.wait()
    equal = np.load(os.path.join(outdir, "transport.npy"))
    assert equal.tolist() == [True] * 5
