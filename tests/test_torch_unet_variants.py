"""The UNet's remaining variants against the JAX package, on the CPU in f32:
every conv type, every activation, the RMSNorm branch, pure attention, the
FlaxDiff CLI's default architecture (``ref_arch``) and ``remat``; and the
JAX ``Unet``'s own build failures, which the port mirrors.

Every leaf of the flax side is replaced with seeded numpy values and
converted with ``convert.state_dict_from_flax``. The helpers here serve the
other model-family tests too.
"""
import jax
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models import attention as jattn
from flaxdiff_tpu.models import common as jcommon
from flaxdiff_tpu.models.unet import Unet as JaxUnet
from flaxdiff_tpu.typing import ACTIVATION_MAP as JAX_ACTIVATIONS
from test_torch_dit import assert_grads_close
from test_torch_unet import randomize

from flaxdiff_tpu_torch import convert
from flaxdiff_tpu_torch.models import ConvLayer, ResidualBlock, SimpleDiT, TransformerBlock, Unet
from flaxdiff_tpu_torch.models.common import FusedGroupNormSiLU, GroupNorm, RMSNorm
from flaxdiff_tpu_torch.typing import ACTIVATION_MAP

# modules and whole tiny models in f32: both sides sum convolutions and
# matmuls in their own order
MODULE_TOL = 1e-4


def flax_leaves(jm, seed, *args, transform=None):
    """The JAX module's parameter tree (shapes traced, never computed) with
    seeded numpy leaves; `transform` may rewrite the tree."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    params = randomize(shapes, seed)
    return transform(params) if transform else params


def load_port(tm, params):
    """Load the converted tree into the port module: every parameter comes
    from a flax leaf and every leaf lands on a parameter; buffers (the
    Fourier frequencies, the port's table of the JAX draws) stay."""
    state = convert.state_dict_from_flax(tm, params)
    assert set(state) == {n for n, _ in tm.named_parameters()}, \
        set(state) ^ {n for n, _ in tm.named_parameters()}
    tm.load_state_dict({**tm.state_dict(), **state}, strict=True)
    return tm


def forward_and_grads(jm, tm, params, args, grads: bool, seed: int = 99, jit: bool = False,
                      tol: float = MODULE_TOL):
    """The port's output against ``jm.apply`` within tol (of the larger of
    1 and max|ref|, elementwise), and with `grads` every parameter gradient
    of <out, g> for a seeded g within tol of its max|g| (``jax.vjp`` against
    autograd). Returns the reference output."""
    fwd = lambda p: jm.apply({"params": p}, *args)
    if grads:
        out_shape = jax.eval_shape(fwd, params).shape
        g = np.random.default_rng(seed).standard_normal(out_shape).astype(np.float32)
        run = lambda p: (lambda r, vjp: (r, vjp(g)[0]))(*jax.vjp(fwd, p))
        ref, ref_grads = (jax.jit(run) if jit else run)(params)
    else:
        ref = (jax.jit(fwd) if jit else fwd)(params)
    ref = np.asarray(ref)
    targs = [None if a is None else torch.from_numpy(np.array(a)) for a in args]
    with torch.set_grad_enabled(grads):
        out = tm(*targs)
    assert out.shape == ref.shape
    assert np.abs(ref).max() > 0.05, "a near-zero output compares nothing"
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))
    if grads:
        names = [n for n, _ in tm.named_parameters()]
        tgrads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                     [p for _, p in tm.named_parameters()])
        assert_grads_close(tm, {n: t.numpy() for n, t in zip(names, tgrads)}, ref_grads,
                           type(tm).__name__)
    return ref


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- modules ------------------------------------------------------------------------

CONV_CASES = [("conv", 1), ("separable", 1), ("separable", 2), ("conv_transpose", 1)]


@pytest.mark.parametrize("size", [7, 8], ids=["odd", "even"])
@pytest.mark.parametrize("conv_type,strides", CONV_CASES,
                         ids=[f"{c}-s{s}" for c, s in CONV_CASES])
def test_conv_layer_types_match_flax(conv_type, strides, size):
    """Each conv type alone at an odd and an even size. conv_transpose is
    stride 2 with flax's "SAME" padding and its kernel unflipped
    (``transpose_kernel=False``), against torch's flipping transpose."""
    x = _x((2, size, size, 5), size)
    jm = jcommon.ConvLayer(conv_type, features=6, kernel_size=(3, 3), strides=strides)
    params = flax_leaves(jm, 1, x)
    tm = load_port(ConvLayer(5, 6, (3, 3), strides, device="cpu", conv_type=conv_type), params)
    ref = forward_and_grads(jm, tm, params, [x], grads=True)
    expect = 2 * size if conv_type == "conv_transpose" else -(-size // strides)
    assert ref.shape == (2, expect, expect, 6)


def test_w_conv_raises_in_jax_and_in_the_port():
    """The JAX package cannot build its weight-standardised conv
    (``nn.map_variables`` is handed a module instance); the port raises,
    naming the line. When the reference is fixed, the first half fails: port
    ``w_conv`` then."""
    x = _x((1, 4, 4, 3), 0)
    with pytest.raises(Exception):
        jcommon.ConvLayer("w_conv", features=4).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="common.py:119"):
        ConvLayer(3, 4, device="cpu", conv_type="w_conv")


NORM_CASES = ([(name, 4, "conv") for name in sorted(ACTIVATION_MAP)]
              + [("swish", 0, "conv"), ("gelu", 0, "conv"), ("swish", 4, "separable")])


@pytest.mark.parametrize("activation,groups,conv_type", NORM_CASES,
                         ids=[f"{a}-g{g}-{c}" for a, g, c in NORM_CASES])
def test_residual_block_variants_match_flax(activation, groups, conv_type):
    """Every activation name of the JAX map through the residual block
    (swish/silu on the fused GroupNorm + SiLU path, the rest after an f32
    GroupNorm), the RMSNorm branch (``norm_groups = 0``) and separable
    convolutions; the time embedding goes through the same activation."""
    assert set(ACTIVATION_MAP) == set(JAX_ACTIVATIONS)
    x, temb = _x((2, 6, 6, 8), 2), _x((2, 16), 3)
    jm = jcommon.ResidualBlock(conv_type=conv_type, features=12, norm_groups=groups,
                               activation=JAX_ACTIVATIONS[activation])
    params = flax_leaves(jm, 4, x, temb)
    tm = load_port(ResidualBlock(8, 12, 16, groups, device="cpu",
                                 activation=ACTIVATION_MAP[activation], conv_type=conv_type),
                   params)
    norm = {True: FusedGroupNormSiLU, False: GroupNorm if groups > 0 else RMSNorm}
    assert type(tm.norm1) is norm[groups > 0 and activation in ("swish", "silu")]
    forward_and_grads(jm, tm, params, [x, temb], grads=False)


@pytest.mark.parametrize("cross_only", [False, True], ids=["self", "cross_only"])
def test_only_pure_attention_matches_flax(cross_only):
    """A pure-attention block is attn1(norm1(x)) and nothing else (the
    transformer block keeps its outer residual); cross-only attends to the
    context."""
    x, ctx = _x((2, 4, 4, 16), 5), _x((2, 7, 12), 6)
    jm = jattn.TransformerBlock(heads=2, dim_head=8, only_pure_attention=True,
                                use_self_and_cross=not cross_only)
    params = flax_leaves(jm, 7, x, ctx)
    tm = load_port(TransformerBlock(16, 12, heads=2, dim_head=8, device="cpu",
                                    use_self_and_cross=not cross_only,
                                    only_pure_attention=True), params)
    assert tm.block_0.ff is None and tm.block_0.attn2 is None
    forward_and_grads(jm, tm, params, [x, ctx], grads=True)


# --- whole UNets ----------------------------------------------------------------------

UNET = dict(output_channels=3, emb_features=16, feature_depths=(16, 32), num_res_blocks=1,
            num_middle_res_blocks=1, norm_groups=4)
# bench.py:130-138's ref_arch at tiny widths: pure attention at every
# attention level, dim_head = C / heads
REF_ARCH = [None, {"heads": 2, "dim_head": 32 // 2, "only_pure_attention": True}]
UNET_INPUTS = lambda seed: (_x((2, 8, 8, 3), seed), np.array([17.0, 640.0], np.float32),
                            _x((2, 5, 12), seed + 1))


def _unets(seed, **cfg):
    """The JAX and the port Unet of `cfg` (activations by name) with the
    same seeded weights, and seeded inputs."""
    jax_cfg = {k: (JAX_ACTIVATIONS[v] if k == "activation" else v) for k, v in cfg.items()}
    jm = JaxUnet(**UNET, **jax_cfg)
    args = UNET_INPUTS(seed)
    params = flax_leaves(jm, seed + 2, *args)
    tm = load_port(Unet(**UNET, **cfg, in_channels=3, context_dim=12, device="cpu"), params)
    return jm, tm, params, args


def test_ref_arch_unet_forward_and_grads_match_jax():
    """The FlaxDiff CLI's default architecture: pure attention with
    dim_head = C / heads (self on the way down and up, cross-only in the
    middle)."""
    jm, tm, params, args = _unets(10, attention_configs=REF_ARCH)
    forward_and_grads(jm, tm, params, args, grads=True, jit=True)


@pytest.mark.parametrize("cfg", [dict(activation="gelu", conv_type="separable"),
                                 dict(activation="mish", attention_configs=REF_ARCH)],
                         ids=["gelu-separable", "mish-ref_arch"])
def test_unet_variants_match_jax(cfg):
    """Another activation through every residual block, the time embedding
    and the output stage; separable convolutions at conv_in, in every block
    and at conv_mid_out."""
    jm, tm, params, args = _unets(20, **cfg)
    forward_and_grads(jm, tm, params, args, grads=False, jit=True)


def _grads(model, args, seed):
    out = model(*map(torch.from_numpy, args))
    g = torch.from_numpy(_x(tuple(out.shape), seed))
    return out, torch.autograd.grad((out * g).sum(), list(model.parameters()))


@pytest.mark.parametrize("family", ["unet", "simple_dit"])
def test_remat_is_bit_equal_to_no_remat(family):
    """remat recomputes each block in the backward pass: the forward and
    every gradient equal the plain model's bit for bit, and the parameter
    names do not change."""
    torch.manual_seed(0)
    if family == "unet":
        make = lambda remat: Unet(**UNET, attention_configs=REF_ARCH, in_channels=3,
                                  context_dim=12, remat=remat, device="cpu")
        args = UNET_INPUTS(30)
    else:
        make = lambda remat: SimpleDiT(patch_size=2, emb_features=32, num_layers=2,
                                       num_heads=2, in_channels=3, context_dim=12,
                                       remat=remat, device="cpu")
        args = UNET_INPUTS(31)
    plain, remat = make(False), make(True)
    state = {k: (torch.randn_like(v) * 0.2 if k.endswith("bias") or v.ndim < 2
                 else torch.randn_like(v) / v[0].numel() ** 0.5)
             if not k.endswith("freqs") else v for k, v in plain.state_dict().items()}
    plain.load_state_dict(state)
    remat.load_state_dict(state)
    (out, grads), (rout, rgrads) = _grads(plain, args, 32), _grads(remat, args, 32)
    assert float(out.detach().abs().max()) > 0.05
    assert torch.equal(out, rout)
    for (name, _), g, r in zip(plain.named_parameters(), grads, rgrads):
        assert torch.equal(g, r), name


def test_jax_unet_build_failures_are_mirrored():
    """The JAX Unet cannot be built with conv_transpose (its ConvLayer
    strides conv_in by 2, so the first residual add fails) or with
    norm_groups = 0 (final_norm is a GroupNorm); the port raises a
    ValueError saying why. When the reference is fixed, these fail: port the
    setting then."""
    x, t, ctx = UNET_INPUTS(40)
    for cfg, why in ((dict(conv_type="conv_transpose"), "conv_in doubles"),
                     (dict(norm_groups=0), "final_norm")):
        with pytest.raises(Exception):
            jax.eval_shape(JaxUnet(**{**UNET, **cfg}).init, jax.random.PRNGKey(0), x, t, ctx)
        with pytest.raises(ValueError, match=why):
            Unet(**{**UNET, **cfg}, device="cpu")
