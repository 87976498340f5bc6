"""Photometric self-supervision for depth completion in the port against the
reference package, on the CPU: `CompletionDataset.sample_batch_with_near`
and `train_prior complete --photo`.

The layout is a textured sequence written here: a tilted textured plane
8-14 m away, the camera moving 0.5 m sideways and turning 0.01 rad a
frame, with 30% sparse depth and dense ground truth. `sample_batch_with_near`
draws the reference's crops and neighbours: rgb, sparse, gt, the neighbour
and K equal exactly with and without `K.txt`, `success` equal, R and t
within the reference test's pose tolerance (R 0.05, t 0.15) of the
reference's, whose PnP is OpenCV's. Three `--photo` Adam steps (masked MSE,
smoothness, and the photometric term of the neighbour warped through the
predicted depth) match the reference's loss and optax's Adam in float64,
fed the reference batch's R and t, at the float64 train-step tolerances of
`tests/test_torch_depth_priors.py`: losses at relative 1e-7, parameters at
1e-6. The CLI trains a few steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from outdoor_nerf_depth_torch.data import png
from outdoor_nerf_depth_torch.depth_priors import completion as t_completion
from outdoor_nerf_depth_torch.depth_priors import datasets as t_datasets
from outdoor_nerf_depth_torch.depth_priors.generate import save_depth_u16
from outdoor_nerf_depth_torch.tools import train_prior as t_train_prior
from outdoor_nerf_depth_tpu.depth_priors import completion as j_completion
from outdoor_nerf_depth_tpu.depth_priors import datasets as j_datasets
from outdoor_nerf_depth_tpu.depth_priors import pose as j_pose
from outdoor_nerf_depth_torch.depth_priors import pose as t_pose
from tests.test_torch_depth_priors import TINY_GUIDED, _convert, _np, _t, _variables
from tests.test_torch_pose import render_plane

pytest.importorskip("cv2")  # the reference's pose estimator
torch.set_num_threads(1)

N_FRAMES = 4
KITTI_FOCAL = 721.5377  # the dataset's focal without K.txt
# Frame size and crop with K.txt (fx 100) and without (the KITTI focal,
# whose narrower view needs a wider frame to hold the pose); the train
# steps' smaller crop (their PnP need only succeed).
LAYOUTS = {True: (160, 256, (128, 224), 100.0), False: (256, 704, (224, 640), KITTI_FOCAL)}
TRAIN_CROP = (96, 176)
POSE_R_ATOL, POSE_T_ATOL = 0.05, 0.15
LR, SMOOTH, PHOTO = 1e-3, 0.01, 0.1
PARAM_ATOL = 1e-6


def write_sequence(root, with_k=True, seed=0):
    """A textured plane 8-14 m away, tilted, seen by a camera that moves
    0.5 m sideways and turns 0.01 rad a frame; texture cells of ~8 px.
    Without K.txt the frames are rendered through the KITTI focal."""
    h, w, _, focal = LAYOUTS[with_k]
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, (w - 1) / 2], [0, focal, (h - 1) / 2], [0, 0, 1]])
    normal = np.array([0.3, -0.1, 1.0]) / np.linalg.norm([0.3, -0.1, 1.0])
    tex = rng.uniform(size=(128, 128, 3))
    for sub in ("image", "sparse", "groundtruth"):
        os.makedirs(os.path.join(root, sub))
    for i in range(N_FRAMES):
        # World = the first camera; camera i maps X to R_i X + t_i.
        R = t_pose.rodrigues(np.array([0.0, 0.01 * i, 0.0]))
        t = -R @ np.array([0.5 * i, 0.0, 0.0])
        frame, depth = render_plane(tex, K, R, t, h, w, normal, 10.0, cell=8 * 10.0 / focal)
        frame = np.clip(frame + rng.normal(0, 0.02, frame.shape), 0, 1)
        name = f"{i:06d}.png"
        png.write_png(os.path.join(root, "image", name), (frame * 255).astype(np.uint8))
        save_depth_u16(depth, os.path.join(root, "groundtruth", name))
        save_depth_u16(np.where(rng.uniform(size=(h, w)) < 0.3, depth, 0.0),
                       os.path.join(root, "sparse", name))
    if with_k:
        np.savetxt(os.path.join(root, "K.txt"), K)
    return str(root)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    return write_sequence(tmp_path_factory.mktemp("photo_seq"))


@pytest.mark.parametrize("with_k", [True, False])
def test_sample_batch_with_near_matches(tmp_path, with_k):
    root = write_sequence(tmp_path / "seq", with_k=with_k)
    crop = LAYOUTS[with_k][2]
    port = t_datasets.CompletionDataset(root, crop=crop, seed=4)
    ref = j_datasets.CompletionDataset(root, crop=crop, seed=4)
    for _ in range(2):
        got, want = port.sample_batch_with_near(3), ref.sample_batch_with_near(3)
        assert len(got) == len(want) == 8
        for name, g, w in zip(("rgb", "sparse", "gt", "rgb_near"), got[:4], want[:4]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(got[7], want[7])  # K
        np.testing.assert_array_equal(got[6], want[6])  # success
        assert got[6].sum() > 0
        np.testing.assert_allclose(got[4], want[4], atol=POSE_R_ATOL)
        np.testing.assert_allclose(got[5], want[5], atol=POSE_T_ATOL)
        assert got[4].dtype == got[5].dtype == np.float32
    # The draws that follow stay on the reference's.
    for g, w in zip(port.sample_batch(2), ref.sample_batch(2)):
        np.testing.assert_array_equal(g, w)
    if with_k:
        K = np.loadtxt(os.path.join(root, "K.txt")).astype(np.float32)
        np.testing.assert_array_equal(got[7], K)  # not shifted by the crop
    else:
        assert got[7][0, 0] == np.float32(KITTI_FOCAL)


def test_failed_pnp_gives_the_identity_and_success_0(tmp_path):
    root = write_sequence(tmp_path / "seq")
    h, w = LAYOUTS[True][:2]
    for i in range(N_FRAMES):  # no depth: nothing to back-project
        save_depth_u16(np.zeros((h, w)), os.path.join(root, "sparse", f"{i:06d}.png"))
    rgb, sparse, gt, near, R, t, success, K = t_datasets.CompletionDataset(
        root, crop=TRAIN_CROP).sample_batch_with_near(2)
    np.testing.assert_array_equal(success, np.zeros(2, np.float32))
    np.testing.assert_array_equal(R, np.stack([np.eye(3, dtype=np.float32)] * 2))
    np.testing.assert_array_equal(t, np.zeros((2, 3), np.float32))


def test_photo_train_steps_match_the_reference(sequence):
    """Three Adam steps of the guided net (base 8) in float64 on three
    batches drawn by the reference's `sample_batch_with_near`, its R and t
    fed to both: the loss at relative 1e-7 (its photometric term non-zero)
    and every parameter after the third step at 1e-6."""
    ref_set = j_datasets.CompletionDataset(sequence, crop=TRAIN_CROP, seed=2)
    batches = [tuple(np.asarray(a, np.float64) for a in ref_set.sample_batch_with_near(2))
               for _ in range(3)]
    assert all(b[6].sum() > 0 for b in batches)
    with jax.enable_x64(True):
        j_net = j_completion.GuidedCompletionNet(**TINY_GUIDED).clone(dtype=jnp.float64)
        t_net = t_completion.GuidedCompletionNet(**TINY_GUIDED)

        def j_terms(v, rgb, sp, gt, rgb_near, R, t, success, K):
            pred = j_net.apply(v, rgb, sp)
            loss = j_completion.masked_depth_mse(pred, gt)
            loss += SMOOTH * j_completion.edge_aware_smoothness(pred, rgb)
            warped, valid = jax.vmap(j_pose.inverse_warp, in_axes=(0, 0, 0, 0, None))(
                rgb_near, pred, R, t, K)
            valid = valid & (success[:, None, None] > 0)
            photo = j_completion.photometric_loss(warped, rgb, mask=valid)
            return loss + PHOTO * photo, photo

        def j_loss(v, *batch):
            return j_terms(v, *batch)[0]

        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                           _variables(j_net, *batches[0][:2]))
        _convert(variables, t_net)
        t_net.double()
        # The reference casts its head's output to float32 even in float64.
        t_net.head.register_forward_hook(lambda module, args, out: out.float())
        t_loss = t_train_prior.photo_completion_loss(t_net, SMOOTH, PHOTO)
        tx = optax.adam(LR)
        opt_state = tx.init(variables)

        @jax.jit
        def j_step(v, opt_state, *batch):
            loss, grads = jax.value_and_grad(j_loss)(v, *batch)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(v, updates), opt_state, loss

        optimizer = t_train_prior.make_optimizer(t_net, LR)
        for batch in batches:
            photo = float(jax.jit(j_terms)(variables, *batch)[1])
            assert photo > 0
            got = t_train_prior.train_step(optimizer, t_loss, tuple(_t(a) for a in batch))
            variables, opt_state, want = j_step(variables, opt_state, *batch)
            assert float(got) == pytest.approx(float(want), rel=1e-7)
        want_params = dict(_convert(variables, t_completion.GuidedCompletionNet(
            **TINY_GUIDED)).named_parameters())
    for key, got in t_net.named_parameters():
        np.testing.assert_allclose(_np(got), _np(want_params[key]), rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


def test_train_prior_photo_cli(sequence, capsys):
    for arch in ("guided", "resnet"):
        model = t_train_prior.main(["complete", "--data", sequence, "--photo", "--arch", arch,
                                    "--steps", "2", "--batch", "2",
                                    "--crop", *map(str, TRAIN_CROP),
                                    "--print-every", "1", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "step 2: loss" in out and "nan" not in out
        assert all(torch.isfinite(p).all() for p in model.parameters())
