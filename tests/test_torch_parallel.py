"""The port's mesh and the attention dispatch's parallel backends against the
JAX package (fault C7: the dispatch takes "ring", "ulysses", "performer"
and "prebuilt", as ``flaxdiff_tpu/ops/attention.py`` does).

``create_mesh``'s sizes and errors against the JAX ``_resolve_sizes``, the
batch dims against ``batch_spec``, and the sequence-parallel gate, on a
world of 4 gloo processes (this file is its own worker,
``tests/torch_world.py``); the four backends on one process against the JAX
dispatch.
"""
import json
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
# axis dicts a world of 4 takes, in the JAX CLI's order
MESH_CASES = [{"data": -1}, {"data": 2, "fsdp": 2}, {"data": 1, "fsdp": 2, "seq": 2},
              {"data": -1, "fsdp": 1, "seq": 1, "tensor": 1}, {"data": 2, "seq": 2, "tensor": 1},
              {"data": -1, "fsdp": 4}, {"fsdp": 2, "seq": 2, "tensor": 0}]
BAD_MESHES = [{"data": 3}, {"data": -1, "fsdp": -1}, {"data": -1, "fsdp": 3},
              {"data": 2, "seq": 4}]
# (axes, devices) for _resolve_sizes alone
RESOLVE_CASES = [({"data": -1}, 8), ({"data": 2, "fsdp": -1}, 8), ({"data": -1, "seq": 4}, 8),
                 ({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1}, 1), ({"data": -1, "fsdp": 3}, 8),
                 ({"data": -1, "fsdp": -1}, 4), ({"data": 2, "fsdp": 2}, 8),
                 ({"data": 4, "tensor": 2}, 8)]


def _error(fn, *args):
    try:
        return repr(fn(*args))
    except ValueError as e:
        return f"ValueError: {e}"


# --- the worker -----------------------------------------------------------------

def _case_meshes(rank, world, outdir):
    from flaxdiff_tpu_torch.parallel import (axis_rank, batch_shard, batch_spec, create_mesh,
                                             local_batch_size, mesh_shape_for)
    rows = []
    for axes in MESH_CASES:
        mesh = create_mesh(axes)
        shape = mesh_shape_for(mesh)
        rows.append({"shape": list(shape.items()), "batch_spec": list(batch_spec(mesh)),
                     "batch_shard": list(batch_shard(mesh)),
                     "ranks": {a: axis_rank(mesh, a) for a in shape},
                     "local_batch": local_batch_size(8, mesh)})
    errors = [_error(create_mesh, axes) for axes in BAD_MESHES]
    with open(os.path.join(outdir, f"meshes_{rank}.json"), "w") as f:
        json.dump({"rows": rows, "errors": errors}, f)


def _case_gate(rank, world, outdir):
    """Shapes the gate turns away under {seq: 4} run "auto", bit for bit:
    a sequence of 30, cross-attention (q and kv lengths differ), and
    Ulysses with 2 heads."""
    from flaxdiff_tpu_torch.ops.attention import dot_product_attention
    from flaxdiff_tpu_torch.parallel import create_mesh, use_mesh
    mesh = create_mesh({"seq": 4})
    rng = np.random.default_rng(41)
    cases = [("ring", (2, 30, 4, 32), (2, 30, 4, 32)), ("ring", (2, 64, 4, 32), (2, 8, 4, 32)),
             ("ulysses", (2, 64, 2, 32), (2, 64, 2, 32))]
    equal = []
    for backend, qs, ks in cases:
        q = torch.from_numpy(rng.standard_normal(qs).astype(np.float32))
        k, v = (torch.from_numpy(rng.standard_normal(ks).astype(np.float32)) for _ in range(2))
        with use_mesh(mesh):
            out = dot_product_attention(q, k, v, backend=backend)
        equal.append(bool(torch.equal(out, dot_product_attention(q, k, v, backend="auto"))))
    np.save(os.path.join(outdir, f"gate_{rank}.npy"), np.array(equal))


CASES = {"meshes": _case_meshes, "gate": _case_gate}

if __name__ == "__main__":
    run_worker(CASES)


# --- the tests ------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("parallel_world"))
    w = spawn(os.path.abspath(__file__), WORLD, outdir)
    yield w, outdir
    w.kill()


@pytest.mark.parametrize("axes,n", RESOLVE_CASES, ids=lambda c: str(c))
def test_resolve_sizes_matches_jax(axes, n):
    from flaxdiff_tpu.parallel.mesh import _resolve_sizes as jax_resolve
    from flaxdiff_tpu_torch.parallel.mesh import _resolve_sizes
    assert _error(_resolve_sizes, axes, n) == _error(jax_resolve, axes, n)


def test_create_mesh_matches_jax(world):
    """Each rank's mesh: the JAX mesh's dims and sizes over 4 devices, its
    batch dims (``batch_spec``), its block of the global batch (data major)
    and the JAX package's errors for meshes a world of 4 cannot take."""
    import jax
    from flaxdiff_tpu.parallel import create_mesh as jax_mesh
    from flaxdiff_tpu.parallel.mesh import batch_spec as jax_batch_spec
    from flaxdiff_tpu.parallel.mesh import mesh_shape_for as jax_shape
    devices = jax.devices()[:WORLD]
    want, specs = [], []
    for axes in MESH_CASES:
        mesh = jax_mesh(axes, devices=devices)
        want.append(list(jax_shape(mesh).items()))
        spec = jax_batch_spec(mesh)[0]
        specs.append([] if spec is None else [spec] if isinstance(spec, str) else list(spec))
    errors = [_error(jax_mesh, axes, devices) for axes in BAD_MESHES]
    w, outdir = world
    w.wait()
    for rank in range(WORLD):
        with open(os.path.join(outdir, f"meshes_{rank}.json")) as f:
            got = json.load(f)
        assert [[list(x) for x in r["shape"]] for r in got["rows"]] == [
            [list(x) for x in s] for s in want]
        assert [r["batch_spec"] for r in got["rows"]] == specs
        assert got["errors"] == errors
        for row, shape in zip(got["rows"], want):
            sizes, ranks = dict(shape), row["ranks"]
            # the row-major layout of ranks over the dims
            flat = 0
            for name, size in shape:
                flat = flat * size + ranks[name]
            assert flat == rank
            block = ranks.get("data", 0) * sizes.get("fsdp", 1) + ranks.get("fsdp", 0)
            assert row["batch_shard"] == [block, sizes.get("data", 1) * sizes.get("fsdp", 1)]
            assert row["local_batch"] == 8 // row["batch_shard"][1]


def test_gate_turns_unshardable_shapes_to_auto(world):
    w, outdir = world
    w.wait()
    for rank in range(WORLD):
        assert np.load(os.path.join(outdir, f"gate_{rank}.npy")).tolist() == [True] * 3


# --- C7: the four backends on one process ---------------------------------------------

C7_SHAPE = (2, 64, 2, 32)


def _c7_inputs():
    rng = np.random.default_rng(42)
    return [rng.standard_normal(C7_SHAPE).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("backend", ["ring", "ulysses", "performer", "prebuilt"])
def test_c7_backends_match_jax(backend, monkeypatch):
    """Each backend the JAX dispatch takes gives the JAX package's output
    (f32, [2, 64, 2, 32]); without a mesh "ring" and "ulysses" are "auto"
    bit for bit; "performer" runs with the JAX package's seed-0 projection
    in the port's projection cache (threefry cannot be redrawn in torch);
    "prebuilt" warns and runs the xla math, as the JAX package does off
    TPU."""
    import jax.numpy as jnp
    from flaxdiff_tpu.ops import linear_attention as jax_favor
    from flaxdiff_tpu.ops.attention import dot_product_attention as jax_attention
    from flaxdiff_tpu_torch.ops import linear_attention
    from flaxdiff_tpu_torch.ops.attention import dot_product_attention
    q, k, v = _c7_inputs()
    if backend == "performer":
        n = linear_attention.default_features(C7_SHAPE[-1])
        proj = torch.from_numpy(np.array(jax_favor._cached_projection(C7_SHAPE[-1], n, 0)))
        monkeypatch.setattr(linear_attention, "_cached_projection",
                            lambda d, m, seed: proj if (d, m, seed) == (C7_SHAPE[-1], n, 0)
                            else pytest.fail(f"projection {(d, m, seed)}"))
    if backend == "prebuilt":
        with pytest.warns(UserWarning):
            want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v)), backend=backend))
        with pytest.warns(UserWarning, match="prebuilt"):
            got = dot_product_attention(*map(torch.from_numpy, (q, k, v)), backend=backend)
    else:
        want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v)), backend=backend))
        got = dot_product_attention(*map(torch.from_numpy, (q, k, v)), backend=backend)
    tol = 1e-4 if backend == "performer" else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    if backend in ("ring", "ulysses"):
        auto = dot_product_attention(*map(torch.from_numpy, (q, k, v)), backend="auto")
        assert torch.equal(got, auto)


def test_unknown_backend_still_raises():
    from flaxdiff_tpu_torch.ops.attention import dot_product_attention
    q = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="unknown attention backend"):
        dot_product_attention(q, q, q, backend="splash")


def test_cli_refuses_tensor_parallelism(tmp_path):
    """--mesh_tensor above 1 names A12's second half; the mesh flags parse
    with the JAX CLI's defaults."""
    from flaxdiff_tpu_torch import train
    args = train.parse_args(["--device", "cpu", "--checkpoint_dir", str(tmp_path)])
    assert {k: getattr(args, k) for k in train.MESH_DEFAULTS} == {
        "mesh_data": -1, "mesh_fsdp": 1, "mesh_seq": 1, "mesh_tensor": 1}
    with pytest.raises(SystemExit, match="A12's second half"):
        train._refuse_unported(train.parse_args(["--mesh_tensor", "2"]))
    # mesh flags with no torchrun environment and no process group
    with pytest.raises(SystemExit, match="torchrun"):
        train.make_run(["--device", "cpu", "--mesh_fsdp", "2", "--checkpoint_dir",
                        str(tmp_path)])
