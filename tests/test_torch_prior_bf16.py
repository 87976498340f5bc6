"""The depth-prior nets under `dtype=bfloat16` against the reference
package's Flax modules with the same dtype and the same parameters, on the
CPU.

Flax's rules under bf16: a convolution (and `MMAF`'s dense layers) takes
bf16 inputs, weights and bias, rounds its product to bf16 and adds the bias
in bf16; GroupNorm takes float32 statistics and returns float32; the
completion heads return float32. XLA on the CPU may keep intermediates in
float32 where the program says bf16 (its excess-precision option, on by
default); the Flax modules here are compiled with it off, so that they
round where their dtypes say, as the port does.

Tolerances. The blocks round at the same places as the port: conv blocks,
residual blocks, 3D blocks and the hourglass at 1e-5 of their largest
output (float32 noise). `MMAF` rounds its dense layers, sigmoid and gates
in bf16, where XLA's expanded sigmoid rounds between its ops: two bf16 ulps
of its largest output (2^-7 of it). Through the nets, a float32 difference
of 1e-7 upstream flips a bf16 rounding downstream (one ulp, 2^-8 relative),
and such flips compound through 20 to 70 layers: each output of the four
nets is held to twice the reference's own bf16 error on it (its bf16
forward against its float32 forward of the same weights), and the port's
bf16 forward is no farther from that float32 forward than twice the
reference's bf16 forward is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.depth_priors import blocks as t_blocks
from outdoor_nerf_depth_torch.depth_priors import completion as t_completion
from outdoor_nerf_depth_torch.depth_priors import generate as t_generate
from outdoor_nerf_depth_torch.depth_priors import stereo as t_stereo
from outdoor_nerf_depth_tpu.depth_priors import blocks as j_blocks
from outdoor_nerf_depth_tpu.depth_priors import completion as j_completion
from outdoor_nerf_depth_tpu.depth_priors import stereo as j_stereo
from tests.test_torch_depth_priors import (
    TINY_GUIDED, TINY_RESNET, TINY_STEREO, _completion_inputs, _convert, _nchw, _nhwc, _np,
    _stereo_inputs, _t, _variables)

torch.set_num_threads(1)

BF16, T_BF16 = jnp.bfloat16, torch.bfloat16
BLOCK_RTOL_OF_MAX = 1e-5
MMAF_RTOL_OF_MAX = 2.0**-7
NET_GAP_FACTOR = 2.0


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _apply(module, variables, *args):
    """`module.apply` compiled to round where its dtypes say."""
    compiled = jax.jit(module.apply).lower(variables, *args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(variables, *args)


def _close_to_max(got, want, rtol_of_max):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol_of_max * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("kind", ["conv", "conv_stride2", "conv_nonorm", "res_proj", "res_stride2"])
def test_2d_blocks_match_flax_bf16(kind):
    x = np.random.default_rng(0).normal(size=(2, 8, 12, 5)).astype(np.float32)
    kw = {"conv": {}, "conv_stride2": dict(strides=2), "conv_nonorm": dict(use_norm=False,
                                                                            use_act=False)}
    if kind in kw:
        j_mod = j_blocks.ConvBlock(6, dtype=BF16, **kw[kind])
        t_mod = t_blocks.ConvBlock(5, 6, dtype=T_BF16, **kw[kind])
    else:
        strides = 2 if kind == "res_stride2" else 1
        j_mod = j_blocks.ResBlock(6, strides=strides, dtype=BF16)
        t_mod = t_blocks.ResBlock(5, 6, strides=strides, dtype=T_BF16)
    variables = _variables(j_mod, x)
    want = _apply(j_mod, variables, x)
    got = _convert(variables, t_mod)(_nchw(x))
    # A conv without norm returns bf16; GroupNorm returns float32, as Flax's.
    want_dtype = (BF16, T_BF16) if kind == "conv_nonorm" else (jnp.float32, torch.float32)
    assert (want.dtype, got.dtype) == want_dtype
    _close_to_max(_nhwc(got.float()), want.astype(jnp.float32), BLOCK_RTOL_OF_MAX)


@pytest.mark.parametrize("module", ["conv3d", "hourglass"])
def test_3d_blocks_match_flax_bf16(module):
    x = np.random.default_rng(2).normal(size=(1, 17, 4, 8, 4)).astype(np.float32)
    if module == "conv3d":
        j_mod, t_mod = (j_blocks.Conv3dBlock(8, strides=2, dtype=BF16),
                        t_blocks.Conv3dBlock(4, 8, strides=2, dtype=T_BF16))
    else:
        j_mod, t_mod = j_blocks.Hourglass3d(4, dtype=BF16), t_blocks.Hourglass3d(4, dtype=T_BF16)
    variables = _variables(j_mod, x)
    got = _convert(variables, t_mod)(_nchw(x))
    assert got.dtype == torch.float32
    _close_to_max(_nhwc(got), _apply(j_mod, variables, x), BLOCK_RTOL_OF_MAX)


def test_mmaf_matches_flax_bf16():
    rng = np.random.default_rng(14)
    g, d = (rng.normal(size=(2, 6, 10, 8)).astype(np.float32) for _ in range(2))
    j_mod = j_completion.MMAF(8, dtype=BF16)
    variables = _variables(j_mod, g, d)
    t_mod = _convert(variables, t_completion.MMAF(8, dtype=T_BF16))
    for got, want in zip(t_mod(_nchw(g), _nchw(d)), _apply(j_mod, variables, g, d)):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        _close_to_max(_nhwc(got), want, MMAF_RTOL_OF_MAX)


def _hold_to_the_gap(got, want_bf16, want_f32, key):
    got, want_bf16, want_f32 = (np.asarray(a, np.float32) for a in (got, want_bf16, want_f32))
    gap = np.abs(want_bf16 - want_f32).max()
    assert gap > 0, key  # the reference's bf16 forward did round
    assert np.abs(got - want_bf16).max() <= NET_GAP_FACTOR * gap, key
    assert np.abs(got - want_f32).max() <= NET_GAP_FACTOR * gap, key


@pytest.mark.parametrize("variant", ["cfnet", "pcwnet"])
def test_stereo_net_bf16_matches_flax(variant):
    left, right, _ = _stereo_inputs()
    j_net = j_stereo.StereoNet(variant=variant, dtype=BF16, **TINY_STEREO)
    variables = _variables(j_net, left, right)
    t_net = _convert(variables, t_stereo.StereoNet(variant=variant, dtype=T_BF16, **TINY_STEREO))
    want = _apply(j_net, variables, left, right)
    want_f32 = _apply(j_stereo.StereoNet(variant=variant, **TINY_STEREO), variables, left, right)
    got = t_net(_t(left), _t(right))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32 and want[key].dtype == jnp.float32, key
        _hold_to_the_gap(_np(got[key]), want[key], want_f32[key], key)


@pytest.mark.parametrize("arch", ["guided", "resnet"])
def test_completion_net_bf16_matches_flax(arch):
    rgb, sparse, _ = _completion_inputs()
    j_cls, kw = ((j_completion.GuidedCompletionNet, TINY_GUIDED) if arch == "guided" else
                 (j_completion.DepthCompletionNet, TINY_RESNET))
    t_cls = (t_completion.GuidedCompletionNet if arch == "guided" else
             t_completion.DepthCompletionNet)
    variables = _variables(j_cls(dtype=BF16, **kw), rgb, sparse)
    t_net = _convert(variables, t_cls(dtype=T_BF16, **kw))
    want = _apply(j_cls(dtype=BF16, **kw), variables, rgb, sparse)
    want_f32 = _apply(j_cls(**kw), variables, rgb, sparse)
    got = t_net(_t(rgb), _t(sparse))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert (np.asarray(want) > 0).mean() > 0.2
    _hold_to_the_gap(_np(got), want, want_f32, arch)


def test_build_completion_net_passes_the_dtype():
    for arch in ("guided", "resnet"):
        net = t_generate.build_completion_net(arch, torch.Generator().manual_seed(0),
                                              dtype=T_BF16)
        convs = [m for m in net.modules() if isinstance(m, t_blocks.Conv)]
        assert convs and all(c.dtype == T_BF16 for c in convs)
        assert all(p.dtype == torch.float32 for p in net.parameters())
        f32 = t_generate.build_completion_net(arch, torch.Generator().manual_seed(0))
        assert all(c.dtype == torch.float32 for c in f32.modules()
                   if isinstance(c, t_blocks.Conv))
