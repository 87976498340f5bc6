"""The port's depth-prior nets against the reference package on the CPU:
the conv blocks (Flax "SAME" padding on even and odd sizes, GroupNorm
epsilon), the resizes, the cost-volume ops, both StereoNet variants, the
guided conv, MMAF and both completion nets, the losses, three Adam steps
of each net against optax, and the parameter conversion. The same Flax
weights go into the port through `params_from_flax`; inputs come from
numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.depth_priors import blocks as t_blocks
from outdoor_nerf_depth_torch.depth_priors import completion as t_completion
from outdoor_nerf_depth_torch.depth_priors import stereo as t_stereo
from outdoor_nerf_depth_torch.ops import guided_conv as t_guided
from outdoor_nerf_depth_torch.tools import train_prior as t_train_prior
from outdoor_nerf_depth_tpu.depth_priors import blocks as j_blocks
from outdoor_nerf_depth_tpu.depth_priors import completion as j_completion
from outdoor_nerf_depth_tpu.depth_priors import stereo as j_stereo
from outdoor_nerf_depth_tpu.ops import guided_conv as j_guided

torch.set_num_threads(1)

# The reference tests' tiny stereo net, and completion at small widths.
TINY_STEREO = dict(max_disparity=32, base_features=8, num_groups=4, concat_features=4,
                   refine_offsets=2)
TINY_GUIDED = dict(base_features=8)
TINY_RESNET = dict(base_features=8, encoder_blocks=(2, 2, 2, 2))
H, W = 32, 64
# Float32 through ~20 conv + GroupNorm layers: with these random weights the
# completion nets' depths reach 150-280 m, and the reference's own forward is
# 7e-4 to 1e-3 m from a float64 forward of the same weights (the port's 6e-4
# to 7e-4 m). Depths are held to 1e-5 of the largest depth; stereo outputs
# are pixels (up to 32).
BLOCK_ATOL = 1e-5
STEREO_ATOL = 5e-4
DEPTH_RTOL_OF_MAX = 1e-5
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return x.detach().numpy()


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2) if x.ndim == 4 else _t(x).permute(0, 4, 1, 2, 3)


def _nhwc(x):
    return _np(x.permute(0, 2, 3, 1) if x.dim() == 4 else x.permute(0, 2, 3, 4, 1))


def _variables(module, *args, seed=1):
    """Random Flax variables of `module` for these inputs, made with numpy
    (tracing `init` for the shapes only; compiling it takes far longer than
    the tests): kernels with Flax's fan-in scale, GroupNorm scales near 1,
    small biases, StereoNet's `range_gamma` at its 1.5. Zero-initialised
    convs get weights too, so every parameter matters."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            val = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            val = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "range_gamma":
            val = np.full(shape, 1.5)
        else:
            val = 0.05 * rng.normal(size=shape)
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _apply(module, variables, *args):
    return jax.jit(module.apply)(variables, *args)


def _convert(variables, module):
    return convert.params_from_flax(jax.device_get(variables), module)


def _stereo_inputs(seed=0, n=1, h=H, w=W):
    rng = np.random.default_rng(seed)
    left = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    right = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    disp = rng.uniform(0.0, 36.0, size=(n, h, w)).astype(np.float32)
    disp[rng.uniform(size=disp.shape) < 0.3] = 0.0  # unknown pixels
    return left, right, disp


def _completion_inputs(seed=0, n=1, h=H, w=W):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    gt = rng.uniform(2.0, 80.0, size=(n, h, w)).astype(np.float32)
    sparse = np.where(rng.uniform(size=gt.shape) < 0.05, gt, 0.0).astype(np.float32)
    return rgb, sparse, gt


# --------------------------------------------------------------------------
# Blocks.


@pytest.mark.parametrize("size", [(8, 12), (9, 7), (8, 7)], ids=["even", "odd", "mixed"])
@pytest.mark.parametrize("kind,kw", [
    ("conv", dict(strides=1)), ("conv", dict(strides=2)), ("conv", dict(dilation=2)),
    ("conv", dict(kernel=5, strides=2)), ("conv_nonorm", dict(strides=2)),
    ("res", dict(strides=1)), ("res", dict(strides=2)), ("res_proj", dict(strides=1)),
])
def test_2d_blocks_match(kind, kw, size):
    x = np.random.default_rng(0).normal(size=(2,) + size + (5,)).astype(np.float32)
    if kind.startswith("conv"):
        extra = dict(use_norm=False, use_act=False) if kind == "conv_nonorm" else {}
        j_mod, t_mod = j_blocks.ConvBlock(6, **kw, **extra), t_blocks.ConvBlock(5, 6, **kw, **extra)
    else:
        out = 6 if kind == "res_proj" else 5
        j_mod, t_mod = j_blocks.ResBlock(out, **kw), t_blocks.ResBlock(5, out, **kw)
    variables = _variables(j_mod, x)
    want = np.asarray(_apply(j_mod, variables, x))
    got = _nhwc(_convert(variables, t_mod)(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("size", [(6, 8, 10), (5, 7, 9), (17, 6, 7)])
@pytest.mark.parametrize("strides", [1, 2])
def test_conv3d_block_matches(size, strides):
    x = np.random.default_rng(1).normal(size=(1,) + size + (4,)).astype(np.float32)
    j_mod, t_mod = j_blocks.Conv3dBlock(8, strides=strides), t_blocks.Conv3dBlock(4, 8, strides=strides)
    variables = _variables(j_mod, x)
    got = _nhwc(_convert(variables, t_mod)(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(_apply(j_mod, variables, x)), atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("depth", [17, 24])
def test_hourglass3d_matches(depth):
    """Stage 2's 17 hypotheses (odd all the way down) and stage 1's 24
    (even: every stride-2 conv pads (0, 1))."""
    x = np.random.default_rng(2).normal(size=(1, depth, 4, 8, 4)).astype(np.float32)
    j_mod, t_mod = j_blocks.Hourglass3d(4), t_blocks.Hourglass3d(4)
    variables = _variables(j_mod, x)
    got = _nhwc(_convert(variables, t_mod)(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(_apply(j_mod, variables, x)), atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("size", [(32, 64), (40, 56)])
def test_unet_features_match(size):
    x = np.random.default_rng(3).uniform(size=(1,) + size + (3,)).astype(np.float32)
    j_mod, t_mod = j_blocks.UNetFeatures(8), t_blocks.UNetFeatures(8)
    variables = _variables(j_mod, x)
    t_out = _convert(variables, t_mod)(_nchw(x))
    for want, got in zip(_apply(j_mod, variables, x), t_out):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=BLOCK_ATOL, rtol=0)


def test_symmetric_padding_would_miss_the_reference():
    """A 3x3 stride-2 conv on an even size: Flax pads (0, 1), and torch's
    symmetric padding=1 samples one pixel to the left. The port's explicit
    padding matches; padding=1 does not."""
    x = np.random.default_rng(4).normal(size=(1, 8, 8, 3)).astype(np.float32)
    j_mod = j_blocks.ConvBlock(4, strides=2, use_norm=False, use_act=False)
    variables = _variables(j_mod, x)
    want = np.asarray(_apply(j_mod, variables, x))
    conv = _convert(variables, t_blocks.ConvBlock(3, 4, strides=2, use_norm=False,
                                                  use_act=False)).conv
    assert t_blocks.same_pads(8, 3, 2) == (0, 1) and t_blocks.same_pads(9, 3, 2) == (1, 1)
    np.testing.assert_allclose(_nhwc(conv(_nchw(x))), want, atol=BLOCK_ATOL, rtol=0)
    symmetric = F.conv2d(_nchw(x), conv.weight, conv.bias, stride=2, padding=1)
    assert np.abs(_nhwc(symmetric) - want).max() > 0.1


def test_groupnorm_epsilon_is_flax_s():
    """Flax's GroupNorm has epsilon 1e-6; torch's default 1e-5 is visibly
    off on a low-variance input."""
    x = (np.random.default_rng(5).normal(size=(1, 4, 4, 8)) * 3e-3).astype(np.float32)
    j_mod = j_blocks.ConvBlock(8, kernel=1, use_act=False)
    variables = _variables(j_mod, x)
    want = np.asarray(_apply(j_mod, variables, x))
    block = _convert(variables, t_blocks.ConvBlock(8, 8, kernel=1, use_act=False))
    assert block.norm.eps == 1e-6 and block.norm.num_groups == 8
    np.testing.assert_allclose(_nhwc(block(_nchw(x))), want, atol=1e-4, rtol=0)
    block.norm.eps = 1e-5
    assert np.abs(_nhwc(block(_nchw(x))) - want).max() > 1e-2


def test_lecun_normal_init():
    """Flax's default kernel init: std sqrt(1 / fan_in), truncated at 2 std;
    zero biases; GroupNorm scale 1, bias 0; MMAF's injections zero."""
    gen = torch.Generator().manual_seed(0)
    conv = t_blocks.Conv(64, 128, 3, generator=gen)
    std = np.sqrt(1.0 / (64 * 9))
    w = _np(conv.weight)
    assert abs(w.std() / std - 1.0) < 0.02 and np.abs(w).max() <= 2 * std / 0.87962566103423978
    assert not conv.bias.detach().any()
    net = t_completion.GuidedCompletionNet(**TINY_GUIDED, generator=gen)
    assert all(not p.any() for n, p in net.named_parameters() if "inject" in n)
    norm = net.guide_stem.norm
    assert norm.weight.detach().eq(1).all() and not norm.bias.detach().any()
    a = t_stereo.StereoNet(**TINY_STEREO, generator=torch.Generator().manual_seed(3))
    b = t_stereo.StereoNet(**TINY_STEREO, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert a.range_gamma.item() == 1.5


def test_guided_net_init_matches_flax_init_leaf_by_leaf():
    """The guided completion net at its full width, from a torch seed and
    from Flax's `init` at PRNG key 0: each leaf that Flax initialises to a
    constant (biases, GroupNorm, MMAF's injections) has the same constant,
    and each random kernel has std sqrt(1 / fan_in) in both, within four
    standard errors of a sample std (sqrt(1 / (2 n)) for n elements)."""
    j_net = j_completion.GuidedCompletionNet()
    flax_init = jax.jit(j_net.init)(jax.random.PRNGKey(0), np.zeros((1, 32, 64, 3), np.float32),
                                    np.zeros((1, 32, 64), np.float32))
    from_flax = _convert(flax_init, t_completion.GuidedCompletionNet())
    own = t_completion.GuidedCompletionNet(generator=torch.Generator().manual_seed(0))
    want = dict(from_flax.named_parameters())
    n_random = 0
    for key, p in own.named_parameters():
        got, ref = _np(p), _np(want[key])
        if np.ptp(ref) == 0.0:
            np.testing.assert_array_equal(got, ref, err_msg=key)
            continue
        n_random += 1
        std = np.sqrt(1.0 / np.prod(got.shape[1:]))
        bound = 4.0 / np.sqrt(2.0 * got.size)
        assert abs(ref.std() / std - 1.0) < bound, key
        assert abs(got.std() / std - 1.0) < bound, key
    assert n_random == 27  # 21 conv kernels (head included), MMAF's 6 Dense kernels


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample2d_matches(factor):
    x = np.random.default_rng(6).normal(size=(2, 5, 7, 3)).astype(np.float32)
    got = _np(t_blocks.upsample2d(_t(x), factor))
    np.testing.assert_allclose(got, np.asarray(j_blocks.upsample2d(x, factor)), atol=1e-6, rtol=0)


def test_upsample3d_matches():
    x = np.random.default_rng(7).normal(size=(1, 3, 5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(_np(t_blocks.upsample3d(_t(x))),
                               np.asarray(j_blocks.upsample3d(x)), atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# Cost-volume ops.


def _features(seed, c=8, h=6, w=11):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, h, w, c)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("d", [0, 1, 4, 11, 13])
def test_shifts_match(d):
    x, _ = _features(8)
    np.testing.assert_array_equal(_np(t_stereo.shift_right_features(_t(x), d)),
                                  np.asarray(j_stereo.shift_right_features(x, d)))
    np.testing.assert_array_equal(_np(t_stereo.shift_left_features(_t(x), d)),
                                  np.asarray(j_stereo.shift_left_features(x, d)))


def test_cost_volume_and_correlation_match():
    left, right = _features(9)
    np.testing.assert_allclose(_np(t_stereo.groupwise_correlation(_t(left), _t(right), 4)),
                               np.asarray(j_stereo.groupwise_correlation(left, right, 4)),
                               atol=1e-6, rtol=0)
    got = _np(t_stereo.build_cost_volume(_t(left), _t(right), 5, 4, 3))
    want = np.asarray(j_stereo.build_cost_volume(left, right, 5, 4, 3))
    assert got.shape == want.shape == (2, 5, 6, 11, 10)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_warp_by_disparity_matches():
    feat, _ = _features(10)
    rng = np.random.default_rng(10)
    disp = rng.uniform(-3.0, 14.0, size=(2, 6, 11)).astype(np.float32)
    disp[0, 0, :4] = [0.0, 2.0, 11.0, 10.0]  # integers and the edges
    np.testing.assert_allclose(_np(t_stereo.warp_by_disparity(_t(feat), _t(disp))),
                               np.asarray(j_stereo.warp_by_disparity(feat, disp)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("per_pixel", [False, True], ids=["global", "per_pixel"])
def test_disparity_regression_matches(per_pixel):
    rng = np.random.default_rng(11)
    logits = (3 * rng.normal(size=(2, 9, 5, 7))).astype(np.float32)
    values = (rng.uniform(0, 20, size=(2, 9, 5, 7)) if per_pixel
              else np.arange(9)).astype(np.float32)
    (mean, var) = t_stereo.disparity_regression(_t(logits), _t(values))
    want_mean, want_var = j_stereo.disparity_regression(jnp.asarray(logits), jnp.asarray(values))
    np.testing.assert_allclose(_np(mean), np.asarray(want_mean), atol=1e-6, rtol=0)
    # Variances reach ~100 px^2, where one float32 ulp is ~8e-6.
    np.testing.assert_allclose(_np(var), np.asarray(want_var), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("variant", ["cfnet", "pcwnet"])
def test_stereo_net_matches(variant):
    left, right, _ = _stereo_inputs()
    j_net = j_stereo.StereoNet(variant=variant, **TINY_STEREO)
    variables = _variables(j_net, left, right)
    t_net = _convert(variables, t_stereo.StereoNet(variant=variant, **TINY_STEREO))
    want = _apply(j_net, variables, left, right)
    got = t_net(_t(left), _t(right))
    assert sorted(got) == sorted(want) == sorted(["disparity", "confidence", "disparity_1_4",
                                                  "disparity_1_8", "uncertainty_1_8"])
    for key in want:
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=STEREO_ATOL,
                                   rtol=0, err_msg=key)


def test_multi_scale_loss_and_depth_match():
    rng = np.random.default_rng(12)
    _, _, disp = _stereo_inputs(seed=12, n=2)
    outputs = {"disparity": rng.uniform(0, 32, (2, H, W)),
               "disparity_1_4": rng.uniform(0, 8, (2, H // 4, W // 4)),
               "disparity_1_8": rng.uniform(0, 4, (2, H // 8, W // 8))}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    want = float(j_stereo.multi_scale_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                                           jnp.asarray(disp), 32.0))
    got = float(t_stereo.multi_scale_loss({k: _t(v) for k, v in outputs.items()}, _t(disp), 32.0))
    assert got == pytest.approx(want, rel=1e-5)
    d = np.array([0.0, 0.05, 0.1, 0.2, 3.0, 100.0], np.float32)
    np.testing.assert_array_equal(_np(t_stereo.disparity_to_depth(_t(d), 718.856, 0.54)),
                                  np.asarray(j_stereo.disparity_to_depth(d, 718.856, 0.54)))


# --------------------------------------------------------------------------
# Guided conv and completion.


@pytest.mark.parametrize("weights", ["softmax", "raw"])
def test_guided_local_conv_matches(weights):
    """The completion nets' softmax kernels (outputs within the inputs'
    range) at 1e-6, and raw normal weights, whose sums of 9 or 25 products
    reach ~10, at 1e-6 plus a relative 1e-6."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    for k in (3, 5):
        w = rng.normal(size=(2, 5, 7, k * k, 4)).astype(np.float32)
        if weights == "softmax":
            w = np.asarray(jax.nn.softmax(w, axis=-2))
        rtol = 1e-6 if weights == "raw" else 0
        want = np.asarray(j_guided.guided_local_conv(x, w))
        np.testing.assert_array_equal(_np(t_guided.extract_patches(_t(x), k)),
                                      np.asarray(j_guided.extract_patches(x, k)))
        np.testing.assert_allclose(_np(t_guided.guided_local_conv(_t(x), _t(w))), want,
                                   atol=1e-6, rtol=rtol)
        w_nchw = _t(w).permute(0, 3, 4, 1, 2)
        np.testing.assert_allclose(_nhwc(t_guided.guided_local_conv_nchw(_nchw(x), w_nchw)),
                                   want, atol=1e-6, rtol=rtol)
    with pytest.raises(ValueError, match="not a square"):
        t_guided.guided_local_conv(_t(x), torch.zeros(2, 5, 7, 8, 4))


def test_mmaf_matches():
    rng = np.random.default_rng(14)
    g, d = (rng.normal(size=(2, 6, 10, 8)).astype(np.float32) for _ in range(2))
    j_mod = j_completion.MMAF(8)
    variables = _variables(j_mod, g, d)
    t_mod = _convert(variables, t_completion.MMAF(8))
    for got, want in zip(t_mod(_nchw(g), _nchw(d)), _apply(j_mod, variables, g, d)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ["guided", "resnet"])
def test_completion_net_matches(arch):
    """Against the reference, and the port's float32 forward against its
    own float64 forward of the same weights, both to 1e-5 of the largest depth."""
    rgb, sparse, _ = _completion_inputs()
    j_net, t_net = ((j_completion.GuidedCompletionNet(**TINY_GUIDED),
                     t_completion.GuidedCompletionNet(**TINY_GUIDED)) if arch == "guided" else
                    (j_completion.DepthCompletionNet(**TINY_RESNET),
                     t_completion.DepthCompletionNet(**TINY_RESNET)))
    variables = _variables(j_net, rgb, sparse)
    want = np.asarray(_apply(j_net, variables, rgb, sparse))
    got = _np(_convert(variables, t_net)(_t(rgb), _t(sparse)))
    assert got.shape == want.shape == (1, H, W) and (want > 0).mean() > 0.2
    atol = DEPTH_RTOL_OF_MAX * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    exact = _np(t_net.double()(_t(rgb).double(), _t(sparse).double()))
    np.testing.assert_allclose(got, exact, atol=atol, rtol=0)


def test_completion_losses_match():
    rng = np.random.default_rng(15)
    rgb, sparse, gt = _completion_inputs(seed=15, n=2)
    pred = rng.uniform(0, 80, size=gt.shape).astype(np.float32)
    warped = rng.uniform(size=rgb.shape).astype(np.float32)
    mask = rng.uniform(size=gt.shape) < 0.6
    pairs = [
        (t_completion.masked_depth_mse(_t(pred), _t(sparse)),
         j_completion.masked_depth_mse(pred, sparse)),
        (t_completion.masked_depth_l1(_t(pred), _t(sparse)),
         j_completion.masked_depth_l1(pred, sparse)),
        (t_completion.edge_aware_smoothness(_t(pred), _t(rgb)),
         j_completion.edge_aware_smoothness(pred, rgb)),
        (t_completion.photometric_loss(_t(warped), _t(rgb), _t(mask)),
         j_completion.photometric_loss(warped, rgb, mask)),
        (t_completion.photometric_loss(_t(warped), _t(rgb)),
         j_completion.photometric_loss(warped, rgb)),
    ]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-5)


# --------------------------------------------------------------------------
# Train steps and parameter conversion.

NETS = {
    "cfnet": (lambda: j_stereo.StereoNet(variant="cfnet", **TINY_STEREO),
              lambda: t_stereo.StereoNet(variant="cfnet", **TINY_STEREO)),
    "pcwnet": (lambda: j_stereo.StereoNet(variant="pcwnet", **TINY_STEREO),
               lambda: t_stereo.StereoNet(variant="pcwnet", **TINY_STEREO)),
    "guided": (lambda: j_completion.GuidedCompletionNet(**TINY_GUIDED),
               lambda: t_completion.GuidedCompletionNet(**TINY_GUIDED)),
    "resnet": (lambda: j_completion.DepthCompletionNet(**TINY_RESNET),
               lambda: t_completion.DepthCompletionNet(**TINY_RESNET)),
}


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


@pytest.mark.parametrize("name", sorted(NETS))
def test_train_steps_match_optax_adam(name):
    """Three Adam steps (lr 1e-3, optax's defaults) on three batches, both
    sides in float64: the reference nets at `dtype=float64` under x64, the
    port's modules in double. Each step's loss (relative 1e-7) and every
    element of every gradient (relative 1e-6, plus 1e-9 of the step's
    largest gradient) are held, then every parameter after the third step
    (1e-6). The reference's values reach the comparison through
    `params_from_flax`, in float32. Nothing is re-synced between steps, and
    no element is exempt.

    float64 because Adam moves a parameter by about +-lr whatever its
    gradient's size: in float32, gradients that are zero in exact
    arithmetic (the logits convs' biases, which the softmax over
    disparities ignores) come out as rounding noise of either sign and
    become +-lr steps, while in float64 the noise stays below Adam's eps.
    The gradients are held as well as the parameters because Adam's step
    does not see a gradient's scale."""
    lr = 1e-3
    stereo_net = name in ("cfnet", "pcwnet")
    batches = [tuple(a.astype(np.float64) for a in
                     (_stereo_inputs if stereo_net else _completion_inputs)(seed=20 + i, n=2))
               for i in range(3)]
    with jax.enable_x64(True):
        j_net, t_net = NETS[name][0]().clone(dtype=jnp.float64), NETS[name][1]()
        if stereo_net:
            def j_loss(v, left, right, disp):
                return j_stereo.multi_scale_loss(j_net.apply(v, left, right), disp, 32.0)
            t_loss = t_train_prior.stereo_loss(t_net, 32.0)
        else:
            def j_loss(v, rgb, sparse, gt):
                pred = j_net.apply(v, rgb, sparse)
                return (j_completion.masked_depth_mse(pred, gt)
                        + 0.01 * j_completion.edge_aware_smoothness(pred, rgb))
            # The reference casts its head's output to float32 before the
            # ReLU and the depth scale (the output cast of its bf16 path);
            # the port's head output is cast alike here.
            t_net.head.register_forward_hook(lambda module, args, out: out.float())
            t_loss = t_train_prior.completion_loss(t_net, 0.01)
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                           _variables(j_net, *batches[0][:2]))
        _convert(variables, t_net)
        t_net.double()
        tx = optax.adam(lr)
        opt_state = tx.init(variables)

        @jax.jit
        def j_step(v, opt_state, *batch):
            loss, grads = jax.value_and_grad(j_loss)(v, *batch)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(v, updates), opt_state, loss, grads

        optimizer = t_train_prior.make_optimizer(t_net, lr)
        for batch in batches:
            got = t_train_prior.train_step(optimizer, t_loss, tuple(_t(a) for a in batch))
            variables, opt_state, want, grads = j_step(variables, opt_state, *batch)
            assert float(got) == pytest.approx(float(want), rel=1e-7)
            want_grads = {k: _np(g) for k, g in
                          _convert(grads, NETS[name][1]()).named_parameters()}
            largest = max(np.abs(g).max() for g in want_grads.values())
            for key, p in t_net.named_parameters():
                np.testing.assert_allclose(_np(p.grad), want_grads[key], rtol=1e-6,
                                           atol=1e-9 * largest, err_msg=key)
        want_params = dict(_convert(variables, NETS[name][1]()).named_parameters())
    for key, got in t_net.named_parameters():
        np.testing.assert_allclose(_np(got), _np(want_params[key]), rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(NETS))
def test_params_from_flax_round_trips(name):
    """Every Flax leaf lands in a distinct torch parameter with its values
    (kernels transposed to [out, in, *kernel]), and back."""
    j_net, t_net = NETS[name][0](), NETS[name][1]()
    args = _stereo_inputs()[:2] if name in ("cfnet", "pcwnet") else _completion_inputs()[:2]
    variables = _variables(j_net, *args)
    leaves = dict(_flat(variables["params"]))
    _convert(variables, t_net)
    params = dict(t_net.named_parameters())
    assert len(params) == len(leaves)
    torch_values = sorted(np.sort(_np(p).ravel()).tobytes() for p in params.values())
    flax_values = sorted(np.sort(v.ravel()).tobytes() for v in leaves.values())
    assert torch_values == flax_values
    if name in ("cfnet", "pcwnet"):
        assert t_net.range_gamma.item() == pytest.approx(float(leaves[("range_gamma",)]))


def test_params_from_flax_raises_on_a_mismatch():
    j_net = j_completion.GuidedCompletionNet(**TINY_GUIDED)
    variables = jax.device_get(_variables(j_net, *_completion_inputs()[:2]))

    def edited(fn):
        tree = jax.tree_util.tree_map(np.asarray, variables)
        fn(tree["params"])
        return tree

    cases = [
        lambda p: p["MMAF_0"].update(extra={"kernel": np.zeros((3, 3))}),  # unknown module
        lambda p: p["ConvBlock_0"]["GroupNorm_0"].update(mean=np.zeros(8)),  # unknown leaf
        lambda p: p.pop("_GuidedFusion_2"),  # missing parameters
        lambda p: p["Conv_0"].update(kernel=np.zeros((5, 5, 8, 1))),  # wrong shape
        lambda p: p.update(ResBlock_4=p["ResBlock_3"]),  # an auto-name past the last
    ]
    for fn in cases:
        with pytest.raises(ValueError):
            convert.params_from_flax(edited(fn), t_completion.GuidedCompletionNet(**TINY_GUIDED))
