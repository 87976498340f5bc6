"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each printing one JSON line; any failure raises and the run exits
non-zero without the final line:

  device      CUDA must be present; the card's name and power limit
  build       nvcc builds every CUDA source of the port into build/, all at once,
              then g++ the loop's C++ dataplane
  kernels     each kernel against its plain PyTorch version on the card, at the
              shapes of the paths and at edge cases (K2b at the osplit probe's
              [16, 524288, 16], P1 and P2 at the gather probe's 8.4M queries,
              which must match bit for bit; K2a and K2b also twice on one
              input, their run-to-run difference, and on bf16 inputs, which
              they accumulate in f32 and return in bf16; K2a also at the oct
              layout's [4194304, 16]); times from CUDA
              events, with K1a and K1b also for one ray (their launch
              floor), a device copy of K2b's input, and P2 also at chunks
              of 256 and 1024 rows (same bytes, other k-step counts)
  train       the port's own train() on the flagship config
              (configs/kitti_mipnerf360.json, full widths, batch 4096, float32)
              on the synthetic scene of 8 images of 94x310, for a few steps;
              every kernel of the path must have been launched
  render      render_image() of one 94x310 test view in chunks of 16384 rays,
              held against the same model on the CPU for a few rays
  profile     two more mip train steps under torch.profiler: device time per
              step by kernel and by kind, and the share of the step the card
              is busy
  ngp_train   train() on configs/kitti_ngp.json at full width (hash grid
              L16 F2 T2^19, batch 8192, sample budget 32) on the same scene for
              20 steps, occupancy refreshes at steps 0 and 16, then a warmup and
              a sampled refresh timed on their own; 16 K2a launches per step
  ngp_render  render_image() of one 94x310 view with the trained grid, held
              against the same model and grid on the CPU for a few rays
  ngp_profile two more NGP train steps under torch.profiler, then one warmup
              and one sampled occupancy refresh
  probe_osplit_bwd  probes.osplit_bwd.run() at full size (524,288 points, L16,
              T 2^19): the hash-table backward stage by stage, 16 scans against
              one K2b launch; one K2b launch per timed batched call, 16 K2a
              launches per timed fwd+bwd, merged row sums equal to the port's
  probe_gather      probes.gather_attack.run() at full size (8.4M queries):
              index_select against table size, sorts against operand count,
              P1 and P2 beside index_select
  kitti       the KITTI data path: the port's fixture writer (30 views of
              94x310 in a temporary directory; train batches from the C++
              dataplane, as in the reference loop), the mip flagship trained on
              it at full width from scene_dir=.../dtu_format for 4 steps with
              a checkpoint every 2, then resumed to 6 steps (step 4 must be
              restored), configs/kitti_ngp.json trained on it for 20 steps
              (and again on numpy-sampled pixels, use_native_batcher=false,
              its steps beside the dataplane's),
              and both evaluated on the 3 test views (PSNR, SSIM, depth
              RMSE); K1a, K1b and K2a launches counted on each part
  nerfpp      NeRF++ on the same fixture's NeRF++ layout (<fixture>/nerfpp):
              configs/kitti_nerfpp.json at full width (cascade 64 + 128,
              fg and bg PointFieldMLP 8x256, batch 1024, float32, clip 1.0)
              trained for 20 steps (median step ms after the first, peak
              memory), one 94x310 test view rendered in chunks of the
              config's 16384 rays (peak memory) and held against the same
              model on the CPU for a few rays, the 3 test views evaluated,
              then two more steps under torch.profiler; NeRF++ composites
              with cumprod, so no kernel of the port may launch on any part
  bf16        bfloat16 compute (matmuls on the tensor cores, parameters in
              float32): on the same NeRF++ fixture, configs/kitti_nerfpp.json
              at the reference bench's nerfpp_1024 point (batch 1024, 8 steps
              per loop iteration) for 40 steps, 8 steps profiled, a render
              held against the CPU; then on the synthetic scene
              configs/kitti_mipnerf360_16k_remat.json at full width (batch
              16384, remat=dots) for 6 steps with 6 K1a and 3 K1b launches a
              step (the recompute runs K1a again), one step each at remat
              none, dots and full (peak memory), two steps profiled (the
              matmuls must run as bf16 tensor-core GEMMs, above the float32
              SIMT peak), a render held against the CPU; the flagship at batch
              4096 in bf16 beside phase train's float32 step; and
              configs/kitti_ngp.json in bf16 for 20 steps (16 K2a launches a
              step) with a render held against the CPU
  ngp_eval    NGP's iterative eval renderer (ngp_eval_renderer=iterative) on
              the grid phase kitti trained: a 94x310 test view, its rounds and
              samples per ray, held against the dense train-path renderer at
              sample budget 0 (mean |difference| of rgb and opacity below
              0.02) and against the CPU on 128 rays; rays/s of both renderers
              (and of the dense one at the config's budget) and their ratio
  priors      the depth-prior generators at full width on one synthetic
              KITTI frame (376x1241, padded to 384x1248): StereoNet cfnet and
              pcwnet (max disparity 192, base 32) on a pair whose right view
              is the left warped by a known disparity ramp, GuidedCompletionNet
              (base 32) and DepthCompletionNet (ResNet-34, base 64) on 5%
              sparse depth; for each the forward ms and peak memory, one
              profiled forward (device time by kind and by op), the outputs on
              a 128x256 crop held against the same net on the CPU, and 20 Adam
              steps (lr 1e-4) at 256x512, batch 2, whose loss must fall; no kernel of
              the port may launch in them. Then the chain on the fixture of
              phase kitti: completion priors for its 30 views from the trained
              guided net, ste_conf priors (confidence >= 0.5) for two synthetic
              KITTI pairs from the trained cfnet, every PNG read back,
              DrivingSceneDataset on the completion prior, and the mip flagship
              trained on it for 4 steps and evaluated (K1a/K1b counted)
  priors_photo photometric self-supervision for depth completion at full
              width: a textured street of 6 frames at 376x1241 (KITTI focal,
              known poses, K.txt, 5% sparse depth); estimate_pose_pnp on the
              5 consecutive pairs (success share, rotation and translation
              error against the truth, host ms of matching and of PnP); the
              --photo loss trained for 20 steps at 256x512, batch 2, for the
              ResNet-34 and the guided net (host ms of the crops with their
              PnP poses, device ms, the photometric term after training,
              peak memory) and train_prior --photo for 2 steps; the four
              prior nets at 384x1248 in bf16 beside float32 on the same
              weights (forward ms, peak memory, largest difference, the
              kernels of one profiled bf16 forward, which must hold bf16
              kernels); the C++ dataplane's batches a second at 4096 and
              16384 rays on the kitti fixture beside the numpy sampler, and
              one single-threaded batch against the CPU's pinhole cast; no
              kernel of the port may launch in any of it
  eval_render the tools on phase kitti's checkpoints: tools.eval restores the
              mip run (step 6, "restored step 6") and its per-image PSNR,
              SSIM, RMSE and AbsRel equal the in-train eval's to 1e-4; every
              saved color_###.png decodes to the 8-bit codes of the rendered
              array and depth_###.png to its uint16 codes; tools.render draws 8
              frames of each path (ellipse, spiral, spline, train) at 94x310
              and 2 ellipse frames at 188 rows from the mip checkpoint and 4
              ellipse frames from NGP's (ms per frame, K1a launches per frame:
              3 per render chunk for mip, 1 for NGP); one frame is held against
              the CPU; tools.eval --offline scores the saved renders against the
              fixture's images, equal to the same metrics computed here on the
              8-bit renders to 1e-4
  lpips       the VGG16 LPIPS machinery with random weights (no LPIPS value is
              a metric): distances on the card against the CPU to relative
              1e-4 at 94x310 and 376x1241, ms and peak memory per image pair,
              and MetricSuite(compute_lpips=True) refusing the unstamped file
  gate        tools.quality_gate on the analytic sphere scene: NGP at its full
              600 steps with its thresholds asserted (PSNR >= 26 dB, depth RMSE
              <= 0.10), mip and NeRF++ at a tenth of their 3,000 steps with
              their metrics reported; train and eval seconds, ms a step and the
              K1a, K1b and K2a launches of each (asserted)
  cameras     copies of phase kitti's driving layout whose COLMAP camera is
              rewritten as OPENCV and as OPENCV_FISHEYE: one batch of pixels
              cast on the card against the CPU's cast (1e-5 of the largest
              component), then the mip flagship at full width for 4 steps,
              casting its pixels on the card (use_native_batcher=false: the
              C++ dataplane would cast pinhole rays, fault 4); 3 K1a and 3
              K1b a step
  depth_losses mip, NGP and NeRF++ at full width on the kitti fixture under
              the mse, urf and nll depth losses (8, 20 and 10 steps): finite
              depth losses, the launches of each run (3 K1a + 3 K1b a mip
              step, 1 + 1 + 16 K2a an NGP step, none for NeRF++), and each
              loss's median step ms over mse's
  ngp_layouts the rest of NGP on the kitti fixture at full width:
              configs/kitti_ngp.json under hash_layout oct, oct with
              grad_mode=scatter, quad and corner for 20 steps each (median ms
              of the steps without a refresh, peak memory, test PSNR/RMSE;
              1 K1a and 1 K1b a step, 1 K2a a step at [4194304, 16] for oct
              and none for the others), each trained encoding on the card
              against the CPU on 4,096 points (forward, and the sorted table
              gradient against autograd's scatter one); the HDR field with
              optimize_ext on osplit for 20 steps (pose_dT's gradient finite
              and non-zero, 16 K2a a step), its test views through the
              dense and the iterative renderer; mark_invisible_cells on the
              fixture's 27 train cameras and the 5 cascades of 128^3 cells
              (ms, culled cells, border flips against the CPU); the NGP
              quality gate (600 steps) under corner and oct, its thresholds
              asserted; probes.ngp_layout.run() at full size
  mip_options the mip-NeRF 360 options on the kitti fixture at the flagship's
              full width (NerfMLP 8x1024, PropMLP 4x256, 64/64/32 samples,
              batch 4096): the flagship, NeRF++ and NGP for 10 steps each
              under their own rgb loss and under rawnerf's (ms a step of each,
              finite losses); Ref-NeRF (density and predicted normals, the
              integrated directional encoding of degree 5, reflections,
              roughness, n.v, density and bottleneck noise 0.1, normals in
              the proposal MLPs, the orientation and predicted-normal losses
              at Ref-NeRF's mults) for 20 steps in float32 and in bf16 (ms a
              step, peak memory, every loss term, the angle between density
              and predicted normals before and after training); the float32
              run's first forward and backward on 256 rays on the card, on the
              CPU and on the CPU with the field MLPs in float64 (colours,
              normals, every parameter's gradient: the card no further from
              the float64 run than 4x the CPU's float32) and the nerf level's
              K1a weights against the plain version; Ref-NeRF
              under remat=dots for 5 steps (6 K1a, 3 K1b a step; its first
              loss against none's); GLO (4 features) with learned exposure
              for 20 steps, then a test view rendered before and after the
              embeddings are perturbed, which must be equal (eval uses
              neither); cylinder rays for 10 steps; 3 K1a and 3 K1b a mip step
  blender     configs/blender_ngp.json at full width (hash grid L16 F2
              T2^19, 128 samples, 512 candidates, batch 8192, white
              background) on a Synthetic-NeRF-shaped layout written by
              tools/make_blender_fixture.py (100 train and 4 test views of
              800x800 RGBA, camera_angle_x 0.6911): write and load seconds,
              300 steps of the config's schedule (past its 256 warmup steps;
              1 K1a, 1 K1b and 16 K2a a step), ms a step and rays/s, and the
              test views' PSNR (40 K1a a view)
  ddp         data parallelism over torch.distributed on the one card, each
              rank a process of this script launched by torchrun
              (`--standalone`): (a) world 1 under NCCL on cuda:0: the same
              flagship and NGP steps timed in that process without a group,
              then in the group, then without it again (the cost of the
              group's path at world 1); then the CLI
              (`python -m outdoor_nerf_depth_torch`'s main inside the group):
              the flagship at full width on the synthetic scene for 6 steps
              with checkpoints at 3 and 6 and its test-split eval (3 K1a and
              3 K1b a step, 3 K1a a test view), then configs/kitti_ngp.json
              for 6 steps (16 K2a a step), the step ms of each and the ms of
              the step's flat gradient all-reduce; (b) world 2 under gloo,
              both ranks on cuda:0 with CUDA tensors (no move to the CPU):
              3 flagship steps, 3 under remat=dots (whose recompute runs on
              autograd's device thread) and 1 NGP step at budget 32 through
              the untrained (warmup-refreshed) grid, each rank on its half
              of the global batches, held against one process fed the whole
              batches and the same generator (loss and gradient norm,
              parameters; tolerances at DDP_*), with the per-rank step ms,
              the launches on each rank and the gloo all-reduce ms

then the kernel summary, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from outdoor_nerf_depth_torch import __main__ as cli  # noqa: E402
from outdoor_nerf_depth_torch import parallel  # noqa: E402
from outdoor_nerf_depth_torch.data import datasets as datasets_lib  # noqa: E402
from outdoor_nerf_depth_torch.data import native_batcher  # noqa: E402
from outdoor_nerf_depth_torch.data import png  # noqa: E402
from outdoor_nerf_depth_torch.data import rays as rays_lib  # noqa: E402
from outdoor_nerf_depth_torch.depth_priors import generate, stereo  # noqa: E402
from outdoor_nerf_depth_torch.depth_priors import completion as prior_completion  # noqa: E402
from outdoor_nerf_depth_torch.depth_priors import datasets as prior_datasets  # noqa: E402
from outdoor_nerf_depth_torch.depth_priors import pose as pose_lib  # noqa: E402
from outdoor_nerf_depth_torch.ops import chunk_gather, cuda_build, prefix_scan  # noqa: E402
from outdoor_nerf_depth_torch.ops import occupancy as occ_lib  # noqa: E402
from outdoor_nerf_depth_torch.ops import refdirs, volren, volren_weights  # noqa: E402
from outdoor_nerf_depth_torch.probes import gather_attack, ngp_layout, osplit_bwd  # noqa: E402
from outdoor_nerf_depth_torch.data import cameras as cameras_lib  # noqa: E402
from outdoor_nerf_depth_torch.tools import e2e_prior_loop, make_kitti_fixture  # noqa: E402
from outdoor_nerf_depth_torch.tools import make_blender_fixture  # noqa: E402
from outdoor_nerf_depth_torch.tools import eval as eval_tool  # noqa: E402
from outdoor_nerf_depth_torch.tools import quality_gate  # noqa: E402
from outdoor_nerf_depth_torch.tools import render as render_tool  # noqa: E402
from outdoor_nerf_depth_torch.tools import train_prior  # noqa: E402
from outdoor_nerf_depth_torch.train import lpips as lpips_lib  # noqa: E402
from outdoor_nerf_depth_torch.train import metrics as metrics_lib  # noqa: E402
from outdoor_nerf_depth_torch.train import step as step_lib  # noqa: E402
from outdoor_nerf_depth_torch.train.config import load_config  # noqa: E402
from outdoor_nerf_depth_torch.utils import image as image_lib  # noqa: E402
from outdoor_nerf_depth_torch.train.loop import (  # noqa: E402
    build_dataset, evaluate, set_full_float32, train)

CONFIG = "configs/kitti_mipnerf360.json"
NGP_CONFIG = "configs/kitti_ngp.json"
NERFPP_CONFIG = "configs/kitti_nerfpp.json"
NERFPP_STEPS = 20
REMAT_CONFIG = "configs/kitti_mipnerf360_16k_remat.json"  # batch 16384, bf16, remat=dots
NERFPP_FUSED, NERFPP_BF16_STEPS = 8, 40  # the bench's nerfpp_1024: 8 steps per iteration
NGP_EVAL_MEAN_TOL = 0.02
STEPS = 6
NGP_STEPS = 20  # occupancy refreshes before steps 0 and 16
N_IMAGES, HEIGHT, WIDTH = 8, 94, 310  # the synthetic scene of the mip_4096 shape
# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds below.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# Kernel vs plain version on the same inputs. Forward: one f32 prefix sum
# in another order; backward: a suffix sum of products on top of it.
FWD_ATOL, BWD_ATOL = 1e-6, 1e-5
# Per sample: bytes each input read once and each output written once, and
# the operations (K1a: prefix add, p + tau, two exps, a subtraction; K1b:
# g*w, g*e, suffix add, a subtraction).
FWD_BYTES, FWD_OPS = 12, 5
BWD_BYTES, BWD_OPS = 16, 4
TRAIN_SHAPES = [(4096, 64), (4096, 64), (4096, 32)]  # per step: 2 prop levels + nerf
RENDER_SHAPE = (16384, 32)  # nerf level of one render chunk (prop levels: S=64)
NGP_K1_SHAPE = (8192, 128)  # NGP: batch x max_samples, once per step and render chunk
# K1 error cases beyond the path's shapes. K1a takes its float4 build where
# S > 96 and S % 4 == 0 ((130, 192)), its float2 build where 32 < S <= 64 and
# S is even, and its scalar build elsewhere ((7, 33), (5, 126), (9, 66)).
K1_EDGE_SHAPES = [(7, 33), (130, 192), (5, 126), (9, 66)]
K1_FLOOR_SHAPE = (1, 64)  # one ray: K1's time per call is then launch and latency
# K2a: one inclusive scan per hash level on the [points, 8F] table-gradient
# stream. Per element: read 4 B, write 4 B, one add.
SCAN_BYTES, SCAN_OPS = 8, 1
SCAN_PATH = (262144, 16)  # batch 8192 x sample_budget 32 points, 8F = 16 lanes
# The oct layout's one scan a step over all 16 levels at once.
OCT_SCAN_PATH = (16 * SCAN_PATH[0], 16)
SCAN_SHAPES = [SCAN_PATH, (1048576, 16), OCT_SCAN_PATH, (16777216, 16),  # path, budget 0, oct, 16.8M
               (osplit_bwd.SAMPLES, osplit_bwd.LANES),  # the osplit probe's per-level scan
               (1, 8), (7, 8), (4097, 8), (1, 128), (7, 128), (4097, 128)]
# A float32 prefix sum in any order is off the exact sum by a few ulps of
# the running sum of |x| (its deepest chain here is ~550 adds at 16.8M rows,
# and rounding errors of random sign grow as the root of that): 1e-5 of
# the running |x| sum, for the kernel and the plain version against float64
# and for the two against each other.
SCAN_RTOL = 1e-5
NGP_LEVELS = 16
# K2b: the osplit probe's 16 levels x 8192*64 points x 8F lanes, and edges.
SCAN_BATCHED_PATH = (NGP_LEVELS, osplit_bwd.SAMPLES, osplit_bwd.LANES)
SCAN_BATCHED_SHAPES = [SCAN_BATCHED_PATH, (3, 100, 16), (3, 1025, 16), (1, 1, 8), (2, 7, 128),
                       (5, 4097, 8),
                       # many tiles per element; many elements of one tile or
                       # less; lanes 1 and 128 (the scalar and widest builds)
                       (2, 1000003, 16), (4096, 100, 16), (20000, 7, 8), (3, 70001, 1),
                       (2, 9000, 128)]
# P1 and P2: the gather probe's queries, then partial last tiles; P2 also on
# a table of 4 chunks, so the tiles wrap around them many times.
GATHER_QUERIES = gather_attack.QUERIES
GATHER_EDGE_QUERIES = (1, 2049, 100003)
ONEHOT_WRAP_ROWS = 4 * chunk_gather.ONEHOT_CHUNK
ONEHOT_SCALING_CHUNKS = (256, 1024)  # P2 timed beside the probe's 512 as well
# The scans on bf16 inputs (f32 accumulation, bf16 out): K2a at its path
# shape, K2b across tiles and batch elements. The kernel's and the plain
# version's f32 sums may round to neighbouring bf16 values: one bf16 ulp
# (its eps, relative) of the running |x| sum.
SCAN_BF16_SHAPES = [SCAN_PATH, (3, 70001, 16)]
SCAN_BF16_RTOL = float(torch.finfo(torch.bfloat16).eps)
# The KITTI phase: the fixture of the quality runs, the mip flagship for 4
# steps with checkpoints at 2 and 4, resumed to 6; NGP for 20 steps.
KITTI_VIEWS = 30
KITTI_MIP_STEPS, KITTI_MIP_RESUMED_STEPS, KITTI_CKPT_EVERY = 4, 6, 2
KITTI_TEST_VIEWS = 3  # views 9, 19, 29
# The priors phase: one KITTI frame (376x1241, padded to a multiple of 32),
# the training crop and batch of the reference's prior CLIs, the crop held
# against the CPU, and the chain's stereo folder (pairs of KITTI frames).
PRIOR_FRAME, PRIOR_PADDED = (376, 1241), (384, 1248)
PRIOR_CROP, PRIOR_BATCH, PRIOR_STEPS = (256, 512), 2, 20
# Adam at 1e-4, a tenth of the prior CLI's default: at 1e-3 the first step
# moves every weight by ~1e-3, the completion nets' depth overshoots by
# ~100 m and their output ReLU dies for many initialisations (in the
# reference too; PERF.md §6), which would leave nothing to learn.
PRIOR_LR = 1e-4
PRIOR_CPU_CROP = (128, 256)
PRIOR_RAMP_DISP = 64.0  # the synthetic pair's disparity ramp: 4 to ~60 px
PRIOR_STEREO_PAIRS = 2
PRIOR_CONF_THRESHOLD = 0.5
# Card against CPU, the same float32 weights and inputs: cuDNN's convolution
# algorithms sum in other orders than the CPU's through 20 to 70 conv layers;
# disparities and depths are held to 1e-3 of the largest value, confidences
# (in [0, 1]) to 1e-3.
PRIOR_CPU_RTOL_OF_MAX = 1e-3
# Phase priors_photo: a textured street at the KITTI frame size and focal,
# the camera driving 0.8 m and turning 0.01 rad a frame, sparse depth at the
# fixture's ~5%; the photometric term at the root CLI's weights; the
# dataplane timed over BATCHER_CALLS calls at each batch size, its
# single-threaded batch held to the CPU's pinhole cast (the C++ and the
# torch float32 casts round alike to a few ulps: 1e-6 of the largest
# direction component).
PHOTO_FRAMES, PHOTO_FOCAL, PHOTO_SPEED, PHOTO_YAW = 6, 721.5377, 0.8, 0.01
PHOTO_CELL, PHOTO_DENSITY = 0.3, 0.05
PHOTO_ARCHS = ("resnet", "guided")
PHOTO_SMOOTH, PHOTO_WEIGHT, PHOTO_CLI_STEPS = 0.01, 0.1, 2
BATCHER_RAYS, BATCHER_CALLS, BATCHER_CAST_RTOL_OF_MAX = (4096, 16384), 50, 1e-6
# Phase eval_render: the tools on phase kitti's checkpoints. Per-image
# metrics of tools.eval against the in-train eval, and of the offline
# evaluator against the same metrics in-process: 1e-4.
EVAL_KEYS = ("psnr", "ssim", "rmse", "abs_rel")
EVAL_TOL = 1e-4
PATH_FRAMES, NGP_PATH_FRAMES, TALL_FRAMES, TALL_HEIGHT = 8, 4, 2, 188
# Phase lpips: random VGG16 weights (no metric), the card against the CPU.
LPIPS_SIZES = [(HEIGHT, WIDTH), PRIOR_FRAME]
LPIPS_RTOL = 1e-4
# Phase gate: NGP at its full budget with its thresholds asserted; mip and
# NeRF++ at a tenth of theirs (the thresholds belong to the full budget).
GATE_RUNS = (("ngp", 1.0, True), ("mipnerf360", 0.1, False), ("nerfpp", 0.1, False))
# Phase blender: configs/blender_ngp.json on a Synthetic-NeRF-shaped layout
# (100 train and 4 test views of 800x800 RGBA), past the occupancy warmup.
BLENDER_CONFIG = "configs/blender_ngp.json"
BLENDER_TRAIN, BLENDER_TEST, BLENDER_SIZE, BLENDER_STEPS = 100, 4, 800, 300
# Phase cameras: the kitti fixture with its camera rewritten with a lens.
# The card's cast of a batch against the CPU's: the Newton inversion and
# sin/cos round in other places on the card, a few float32 ulps of the
# directions (~1): 1e-5 of their largest component.
LENS_MODELS, LENS_STEPS, LENS_CAST_RTOL_OF_MAX = ("OPENCV", "OPENCV_FISHEYE"), 4, 1e-5
# Phase depth_losses: each backend on the fixture under mse, urf and nll.
DEPTH_LOSS_RUNS = (("mip", CONFIG, 8), ("ngp", NGP_CONFIG, 20), ("nerfpp", NERFPP_CONFIG, 10))
DEPTH_LOSS_KINDS = ("mse", "urf", "nll")
# Phase ngp_layouts: configs/kitti_ngp.json on the kitti fixture under the
# other hash layouts (oct also with autograd's scatter gradient), then the
# HDR field with extrinsics refinement on osplit; the NGP gate under corner
# and oct. The encodings on the card against the CPU on a few thousand
# points: the forward blends 8 f32 products a level in another order
# (1e-5 of the largest feature); the card's sorted table gradient against
# the CPU's scatter one at 1e-4 of the largest entry (a row is the
# difference of two f32 prefix sums, which reach ~10x the largest row; one
# f32 ulp of a prefix 800x the row is 1e-4 of it). The cull on the card
# against the CPU: a cell whose projection lies on an image border may flip
# with the rounding of R^T (p - t); at most 1e-4 of the cells.
LAYOUT_RUNS = (("oct", "auto"), ("oct", "scatter"), ("quad", "auto"), ("corner", "auto"))
LAYOUT_CHECK_POINTS = 4096
LAYOUT_FWD_RTOL, LAYOUT_GRAD_RTOL = 1e-5, 1e-4
GATE_LAYOUTS = ("corner", "oct")
CULL_FLIP_SHARE = 1e-4
# Phase mip_options: the mip-NeRF 360 options on the kitti fixture at the
# flagship's full width. The Ref-NeRF field options, with both noises on so
# that both draws run, and normals in the proposal MLPs too (the
# orientation loss reads every level).
REFNERF_NERF = {"compute_density_normals": True, "enable_pred_normals": True,
                "use_directional_enc": True, "deg_view": 5, "use_reflections": True,
                "enable_pred_roughness": True, "use_n_dot_v": True, "density_noise": 0.1,
                "bottleneck_noise": 0.1}
REFNERF_PROP = {"compute_density_normals": True, "enable_pred_normals": True}
# The loss mults of multinerf's configs/blender_refnerf.gin (Ref-NeRF).
REFNERF_LOSSES = {"orientation_loss_mult": 0.1, "orientation_coarse_loss_mult": 0.01,
                  "orientation_loss_target": "normals_pred", "predicted_normal_loss_mult": 3e-4,
                  "predicted_normal_coarse_loss_mult": 3e-5}
OPTION_STEPS, OPTION_REMAT_STEPS, OPTION_SHORT_STEPS = 20, 5, 10
OPTION_CPU_RAYS = 256
# Card against CPU, one forward and backward of 256 rays from the same
# weights (see _card_against_cpu): colours at 1e-4 absolute.
OPTION_CPU_ATOL = 1e-4
# Phase ddp: (a) world 1 under NCCL through the CLI (the flagship with
# checkpoints and its eval, NGP), (b) world 2 under gloo on one card. Two
# ranks against one process fed the concatenated batches and the same
# generator, float32 with TF32 off: the ranks' rows go through the same ops
# as one process's, but GEMMs of half the rows may take other kernels and
# the losses are summed in other orders (a few float32 ulps: relative 1e-5
# on each step's loss, 1e-4 on the gradient norm, whose smallest entries
# carry that rounding); Adam turns the rounding of near-zero gradients into
# moves of up to lr a step, so parameters are held to 1e-5 + 1e-4 |p| on
# 99.9% of their entries and to Adam's bound on every entry.
DDP_STEPS, DDP_NGP_STEPS, DDP_CLI_STEPS, DDP_SEED = 3, 1, 6, 7
# Steps timed with and without the group at world 1 (a); the median skips
# the first DDP_TIMED_SKIP of each run.
DDP_TIMED_STEPS, DDP_TIMED_SKIP = 12, 2
DDP_LOSS_RTOL, DDP_GRAD_NORM_RTOL = 1e-5, 1e-4
DDP_PARAM_ATOL, DDP_PARAM_RTOL, DDP_PARAM_SHARE = 1e-5, 1e-4, 0.999
DDP_ALLREDUCE_REPS, DDP_TIMEOUT_S = 10, 300
REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "outdoor_nerf_depth_torch/csrc/volren_weights.cu"
SCAN_SOURCE = "outdoor_nerf_depth_torch/csrc/prefix_scan.cu"
GATHER_SOURCE = "outdoor_nerf_depth_torch/csrc/chunk_gather.cu"
KERNEL_IDS = ("K1a", "K1b", "K2a", "K2b", "P1", "P2")


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(shape, bytes_per, ops_per):
    n = math.prod(shape)
    return 1e3 * max(n * bytes_per / HBM_BYTES_PER_S, n * ops_per / FP32_FLOPS_PER_S)


def take_bound_ms(queries, chunk):
    """P1: read each index (4 B) and the table once, write each 64-byte row."""
    return 1e3 * (queries * (4 + 4 * chunk_gather.LANES) + chunk * 4 * chunk_gather.LANES) \
        / HBM_BYTES_PER_S


def onehot_bound(queries, rows, chunk, tile):
    """P2: (bound ms, what bounds it). Bytes: each index and each 64-byte
    output row once, each distinct chunk of bf16 rows once; operations: the
    one-hot products."""
    tiles = -(-queries // tile)
    chunk_bytes = chunk * chunk_gather.LANES * 2
    out_bytes = queries * (4 + 4 * chunk_gather.LANES)
    bytes_s = (out_bytes + min(tiles, rows // chunk) * chunk_bytes) / HBM_BYTES_PER_S
    ops_s = tiles * tile * chunk * chunk_gather.LANES * 2 / BF16_FLOPS_PER_S
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"


def linear_flops(modules, n):
    """Multiply-add FLOPs of every nn.Linear in `modules` on n inputs."""
    return sum(2 * n * layer.in_features * layer.out_features
               for m in modules for layer in m.modules() if isinstance(layer, torch.nn.Linear))


def mlp_forward_flops(model, n_rays):
    """Multiply-add FLOPs of every field-MLP layer for one forward of n_rays
    (each prop level runs prop_mlp on num_prop_samples, the last level
    nerf_mlp on num_nerf_samples)."""
    levels = [(model.prop_mlp, model.num_prop_samples)] * (model.num_levels - 1)
    levels.append((model.nerf_mlp, model.num_nerf_samples))
    return sum(linear_flops([mlp], n_rays * samples) for mlp, samples in levels)


def nerfpp_forward_flops(model, n_rays):
    """Multiply-add FLOPs of the fg and bg fields of every NeRF++ level on
    that level's samples (level i runs on the sum of the first i + 1
    cascade counts)."""
    total, samples = 0, 0
    for level, n in enumerate(model.cascade_samples):
        samples += n
        fields = getattr(model, f"level{level}")
        total += linear_flops([fields.fg_field, fields.bg_field], n_rays * samples)
    return total


def ngp_points(model, n_rays):
    """Points the NGP field evaluates for n_rays: the batch budget, or all slots."""
    per_ray = model.sample_budget if 0 < model.sample_budget < model.max_samples \
        else model.max_samples
    return n_rays * per_ray


def ngp_forward_flops(model, n_rays):
    return linear_flops([model.field], ngp_points(model, n_rays))


def device_ms(fn, launches=50, reps=5):
    """Median device time of one call: `launches` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events. A call slower than
    5 ms gets fewer launches, so one replay stays near 250 ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    first = start.elapsed_time(end)
    launches = max(1, min(launches, int(250.0 / max(first, 1e-3))))
    reps = reps if first < 100.0 else 2
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3 if first < 100.0 else 1):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    set_full_float32()
    return smi


def phase_build():
    t0 = time.perf_counter()
    sources = [volren_weights.SOURCE, prefix_scan.SOURCE, chunk_gather.SOURCE]
    reports = cuda_build.build(sources)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_batcher.load()  # the train loop's C++ dataplane, with g++
    emit({"phase": "build", "seconds": seconds,
          "libraries": [os.path.relpath(cuda_build.library_path(s), REPO) for s in sources],
          "ptxas": reports, "dataplane_seconds": time.perf_counter() - t0,
          "dataplane": os.path.relpath(native_batcher.library_path(), REPO)})


def _check_pair(tau, g):
    w, e = volren_weights.weights_fwd_cuda(tau)
    dtau = volren_weights.weights_bwd_cuda(g, w, e)
    torch.cuda.synchronize()
    w_ref, e_ref = volren_weights.weights_from_tau_plain(tau)
    dtau_ref = volren_weights.weights_from_tau_bwd_plain(g, w_ref, e_ref)
    for x in (w, e, dtau):
        if not torch.isfinite(x).all():
            raise AssertionError(f"non-finite kernel output at {tuple(tau.shape)}")
    err_fwd = max(float((w - w_ref).abs().max()), float((e - e_ref).abs().max()))
    err_bwd = float((dtau - dtau_ref).abs().max())
    if err_fwd > FWD_ATOL or err_bwd > BWD_ATOL:
        raise AssertionError(
            f"K1 disagrees with its plain version at {tuple(tau.shape)}: "
            f"fwd {err_fwd} (tol {FWD_ATOL}), bwd {err_bwd} (tol {BWD_ATOL})"
        )
    return err_fwd, err_bwd


def _check_scan(x):
    """K2a and torch.cumsum against a float64 scan; errors relative to the
    running sum of |x| (plus 1, for the all-small start); and two calls on
    the same input within the tolerance of each other (the look-back sums
    its carries in an order that depends on timing)."""
    got = prefix_scan.cumsum_cuda(x)
    again = prefix_scan.cumsum_cuda(x)
    plain = prefix_scan.cumsum_plain(x)
    torch.cuda.synchronize()
    # float64 reference along the contiguous axis (fast on the card).
    ref = torch.cumsum(x.double().t().contiguous(), dim=1).t()
    scale = torch.cumsum(x.abs().double().t().contiguous(), dim=1).t() + 1.0
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite K2a output at {tuple(x.shape)}")
    err = {
        "kernel_vs_plain_abs": float((got - plain).abs().max()),
        "kernel_vs_plain": float(((got.double() - plain.double()).abs() / scale).max()),
        "kernel_vs_f64": float(((got.double() - ref).abs() / scale).max()),
        "plain_vs_f64": float(((plain.double() - ref).abs() / scale).max()),
        "run_to_run_abs": float((got - again).abs().max()),
        "run_to_run": float(((got.double() - again.double()).abs() / scale).max()),
    }
    del ref, scale
    if max(err["kernel_vs_f64"], err["plain_vs_f64"], err["run_to_run"]) > SCAN_RTOL \
            or err["kernel_vs_plain"] > 2 * SCAN_RTOL:
        raise AssertionError(f"K2a disagrees at {tuple(x.shape)}: {err} (tol {SCAN_RTOL})")
    return err


def _check_scan_batched(x):
    """K2b and torch.cumsum(dim=1) against a float64 scan, as `_check_scan`;
    no carry leaks across batch elements: row 0 of each is its input; and two
    calls on the same input differ by at most the tolerance (the look-back
    sums its carries in an order that depends on timing)."""
    got = prefix_scan.cumsum_batched_cuda(x)
    again = prefix_scan.cumsum_batched_cuda(x)
    plain = prefix_scan.cumsum_batched_plain(x)
    torch.cuda.synchronize()
    xt = x.double().transpose(1, 2).contiguous()  # scan along the contiguous axis
    ref = torch.cumsum(xt, dim=2).transpose(1, 2)
    scale = torch.cumsum(xt.abs(), dim=2).transpose(1, 2) + 1.0
    del xt
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite K2b output at {tuple(x.shape)}")
    if not torch.equal(got[:, 0], x[:, 0]):
        raise AssertionError(f"K2b leaks a carry into row 0 at {tuple(x.shape)}")
    err = {
        "kernel_vs_plain_abs": float((got - plain).abs().max()),
        "kernel_vs_plain": float(((got.double() - plain.double()).abs() / scale).max()),
        "kernel_vs_f64": float(((got.double() - ref).abs() / scale).max()),
        "plain_vs_f64": float(((plain.double() - ref).abs() / scale).max()),
        "run_to_run_abs": float((got - again).abs().max()),
        "run_to_run": float(((got.double() - again.double()).abs() / scale).max()),
    }
    del ref, scale
    if max(err["kernel_vs_f64"], err["plain_vs_f64"], err["run_to_run"]) > SCAN_RTOL \
            or err["kernel_vs_plain"] > 2 * SCAN_RTOL:
        raise AssertionError(f"K2b disagrees at {tuple(x.shape)}: {err} (tol {SCAN_RTOL})")
    return err


def _check_scan_bf16(x32):
    """The scan wrappers on a bf16 input: K2a for [N, lanes], K2b for
    [B, N, lanes]; one launch, a bf16 result within one bf16 ulp of the
    plain version's, relative to the running |x| sum."""
    x = x32.to(torch.bfloat16)
    batched = x.dim() == 3
    before = (prefix_scan.LAUNCHES, prefix_scan.BATCHED_LAUNCHES)
    got = prefix_scan.cumsum_batched(x) if batched else prefix_scan.cumsum(x)
    plain = (prefix_scan.cumsum_batched_plain if batched else prefix_scan.cumsum_plain)(x)
    torch.cuda.synchronize()
    launched = (prefix_scan.LAUNCHES - before[0], prefix_scan.BATCHED_LAUNCHES - before[1])
    if got.dtype != torch.bfloat16 or got.shape != x.shape or launched != ((0, 1) if batched
                                                                           else (1, 0)):
        raise AssertionError(f"bf16 scan at {tuple(x.shape)}: {got.dtype}, launches {launched}")
    scale = torch.cumsum(x.abs().double(), dim=1 if batched else 0) + 1.0
    err = float(((got.double() - plain.double()).abs() / scale).max())
    if not torch.isfinite(got).all() or err > SCAN_BF16_RTOL:
        raise AssertionError(f"bf16 scan disagrees at {tuple(x.shape)}: {err} "
                             f"(tol {SCAN_BF16_RTOL})")
    return {"kernel_vs_plain": err, "kernel_vs_plain_abs": float((got - plain).abs().max()),
            "kernel": "K2b" if batched else "K2a"}


def _gather_inputs(gen, queries, high, rows, dtype):
    """int32 indices in [0, high), the first 0 and the last high - 1, and a
    [rows, 16] table of normal values in `dtype`."""
    idx = torch.randint(0, high, (queries,), generator=gen, device="cuda", dtype=torch.int32)
    idx[0], idx[-1] = 0, high - 1
    table = torch.randn((rows, chunk_gather.LANES), generator=gen, device="cuda").to(dtype)
    return idx, table


def _exact(name, got, want):
    """Max abs error of a gather kernel against its plain version; must be 0."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite values")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"{name} differs from its plain version by {err}")
    return err


def _gather_kernels(gen):
    """P1 and P2 against their plain versions (exact), then timed at the
    gather probe's shapes with their plain versions and index_select."""
    take, onehot = chunk_gather.TAKE_CHUNK, chunk_gather.ONEHOT_CHUNK
    tile = chunk_gather.ONEHOT_TILE
    errors = {"P1": {}, "P2": {}}
    for q in (GATHER_QUERIES,) + GATHER_EDGE_QUERIES:
        idx, table = _gather_inputs(gen, q, take, take, torch.float32)
        errors["P1"][str(q)] = _exact(f"P1 at {q} queries",
                                      chunk_gather.take_from_chunk_cuda(idx, table),
                                      chunk_gather.take_from_chunk_plain(idx, table))
    cases = [(GATHER_QUERIES, gather_attack.ONEHOT_ROWS)] + \
        [(q, ONEHOT_WRAP_ROWS) for q in GATHER_EDGE_QUERIES]
    for q, rows in cases:
        idx, table = _gather_inputs(gen, q, onehot, rows, torch.bfloat16)
        errors["P2"][f"{q}q_{rows}rows"] = _exact(
            f"P2 at {q} queries, {rows} rows", chunk_gather.onehot_extract_cuda(idx, table),
            chunk_gather.onehot_extract_plain(idx, table))
    # Tiles of 64 over a table of 2 chunks: each chunk serves every other tile.
    q, rows = GATHER_EDGE_QUERIES[-1], 2 * onehot
    idx, table = _gather_inputs(gen, q, onehot, rows, torch.bfloat16)
    errors["P2"][f"{q}q_{rows}rows_tile64"] = _exact(
        f"P2 at tile 64 over {rows} rows", chunk_gather.onehot_extract_cuda(idx, table, onehot, 64),
        chunk_gather.onehot_extract_plain(idx, table, onehot, 64))
    # Indices outside [0, chunk) give zero rows; the others their rows.
    idx, table = _gather_inputs(gen, q, onehot, ONEHOT_WRAP_ROWS, torch.bfloat16)
    idx[::7], idx[3::11] = onehot, -1
    bad = (idx < 0) | (idx >= onehot)
    got = chunk_gather.onehot_extract_cuda(idx, table)
    want = torch.where(bad[:, None], 0.0,
                       chunk_gather.onehot_extract_plain(idx.clamp(0, onehot - 1), table))
    errors["P2"][f"{q}q_out_of_range"] = _exact("P2 with indices outside [0, chunk)", got, want)

    timing = {}
    q = GATHER_QUERIES
    idx, table = _gather_inputs(gen, q, take, take, torch.float32)
    timing["P1"] = {"queries": q, "chunk": take,
                    "ms": device_ms(lambda: chunk_gather.take_from_chunk_cuda(idx, table)),
                    "plain_ms": device_ms(lambda: chunk_gather.take_from_chunk_plain(idx, table)),
                    "library_ms": device_ms(lambda: torch.index_select(table, 0, idx)),
                    "bound_ms": take_bound_ms(q, take), "bound_by": "bytes"}
    rows = gather_attack.ONEHOT_ROWS
    idx, table = _gather_inputs(gen, q, onehot, rows, torch.bfloat16)
    global_rows = chunk_gather.onehot_rows(q, rows, onehot, tile, "cuda") + idx
    bound, bound_by = onehot_bound(q, rows, onehot, tile)
    timing["P2"] = {"queries": q, "table_rows": rows, "chunk": onehot, "tile": tile,
                    "ms": device_ms(lambda: chunk_gather.onehot_extract_cuda(idx, table)),
                    "plain_ms": device_ms(lambda: chunk_gather.onehot_extract_plain(idx, table)),
                    "library_ms": device_ms(
                        lambda: torch.index_select(table, 0, global_rows).to(torch.float32)),
                    "bound_ms": bound, "bound_by": bound_by}
    # What bounds P2: the same queries and table at other chunk sizes move
    # the same bytes through k-steps in proportion to chunk. The bound is the
    # bytes' up to 512 rows; at 1024 the bf16 products bound it.
    by_chunk = {}
    for c in ONEHOT_SCALING_CHUNKS:
        idx_c = torch.randint(0, c, (q,), generator=gen, device="cuda", dtype=torch.int32)
        errors["P2"][f"{q}q_chunk{c}"] = _exact(
            f"P2 at chunk {c}", chunk_gather.onehot_extract_cuda(idx_c, table, c, tile),
            chunk_gather.onehot_extract_plain(idx_c, table, c, tile))
        bound_c, bound_by_c = onehot_bound(q, rows, c, tile)
        by_chunk[str(c)] = {"ms": device_ms(lambda: chunk_gather.onehot_extract_cuda(
                                idx_c, table, c, tile)),
                            "bound_ms": bound_c, "bound_by": bound_by_c}
    timing["P2"]["by_chunk"] = by_chunk
    return errors, timing


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda shape: 2.0 * torch.rand(shape, generator=gen, device="cuda")
    randn = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    cases = {f"{r}x{s}": rand((r, s)) for r, s in
             [(4096, 64), (4096, 32), (16384, 32), (16384, 64), NGP_K1_SHAPE] + K1_EDGE_SHAPES}
    saturated = rand((256, 32))
    saturated[:, :4] = 10.0  # an opaque wall: later weights and gradients ~0
    cases["saturated_256x32"] = saturated
    opaque = rand((256, 64))
    opaque[:, -1] = float("inf")  # opaque background
    cases["inf_last_256x64"] = opaque
    errors = {name: _check_pair(tau, randn(tau.shape)) for name, tau in cases.items()}
    del cases

    timing = {}
    for shape in sorted(set(TRAIN_SHAPES + [RENDER_SHAPE, NGP_K1_SHAPE])):
        tau, g = rand(shape), randn(shape)
        w, e = volren_weights.weights_from_tau_plain(tau)
        timing[f"{shape[0]}x{shape[1]}"] = {
            "fwd_ms": device_ms(lambda: volren_weights.weights_fwd_cuda(tau)),
            "fwd_plain_ms": device_ms(lambda: volren_weights.weights_from_tau_plain(tau)),
            "fwd_bound_ms": bound_ms(shape, FWD_BYTES, FWD_OPS),
            "bwd_ms": device_ms(lambda: volren_weights.weights_bwd_cuda(g, w, e)),
            "bwd_plain_ms": device_ms(lambda: volren_weights.weights_from_tau_bwd_plain(g, w, e)),
            "bwd_bound_ms": bound_ms(shape, BWD_BYTES, BWD_OPS),
        }
    tau, g = rand(K1_FLOOR_SHAPE), randn(K1_FLOOR_SHAPE)
    w, e = volren_weights.weights_from_tau_plain(tau)
    timing["floor"] = {"shape": list(K1_FLOOR_SHAPE),
                       "fwd_ms": device_ms(lambda: volren_weights.weights_fwd_cuda(tau)),
                       "bwd_ms": device_ms(lambda: volren_weights.weights_bwd_cuda(g, w, e))}

    scan_errors, scan_timing = {}, {}
    for shape in SCAN_SHAPES:
        x = randn(shape)
        key = f"{shape[0]}x{shape[1]}"
        scan_errors[key] = _check_scan(x)
        if shape[0] >= SCAN_PATH[0]:
            # torch.cumsum is both the plain version and the one library
            # call computing the function: timed once, reported as both.
            plain = device_ms(lambda: prefix_scan.cumsum_plain(x))
            scan_timing[key] = {"ms": device_ms(lambda: prefix_scan.cumsum_cuda(x)),
                                "plain_ms": plain, "library_ms": plain,
                                "bound_ms": bound_ms(shape, SCAN_BYTES, SCAN_OPS)}
        del x

    batched_errors, batched_timing = {}, {}
    for shape in SCAN_BATCHED_SHAPES:
        x = randn(shape)
        key = "x".join(str(d) for d in shape)
        batched_errors[key] = _check_scan_batched(x)
        if shape == SCAN_BATCHED_PATH:
            plain = device_ms(lambda: prefix_scan.cumsum_batched_plain(x))
            # A device copy moves the same 8 B per element: the memory rate
            # this card reaches in practice, beside the bound's 3.35 TB/s.
            batched_timing[key] = {"ms": device_ms(lambda: prefix_scan.cumsum_batched_cuda(x)),
                                   "plain_ms": plain, "library_ms": plain,
                                   "copy_ms": device_ms(lambda: x.clone()),
                                   "bound_ms": bound_ms(shape, SCAN_BYTES, SCAN_OPS)}
        del x
    bf16_errors = {"x".join(str(d) for d in shape): _check_scan_bf16(randn(shape))
                   for shape in SCAN_BF16_SHAPES}
    gather_errors, gather_timing = _gather_kernels(gen)
    emit({"phase": "kernels",
          "max_abs_err": {k: {"fwd": f, "bwd": b} for k, (f, b) in errors.items()},
          "tolerance": {"fwd": FWD_ATOL, "bwd": BWD_ATOL},
          "timing": timing,
          "timing_method": "device time per call: up to 50 calls in a CUDA graph, median of "
                           "5 replays (fewer for calls over 5 ms)",
          "library_ms": None,
          "library_note": "no single PyTorch call computes compositing weights from optical depth",
          "scan_errors": scan_errors,
          "scan_tolerance": {"vs_f64_rel_to_running_abs_sum": SCAN_RTOL,
                             "kernel_vs_plain": 2 * SCAN_RTOL},
          "scan_timing": scan_timing,
          "scan_library": "torch.cumsum(x, dim=0)",
          "scan_batched_errors": batched_errors,
          "scan_batched_timing": batched_timing,
          "scan_batched_library": "torch.cumsum(x, dim=1)",
          "scan_bf16_errors": bf16_errors,
          "scan_bf16_tolerance": {"vs_plain_rel_to_running_abs_sum": SCAN_BF16_RTOL},
          "gather_max_abs_err": gather_errors, "gather_tolerance": 0.0,
          "gather_timing": gather_timing,
          "gather_library": {"P1": "torch.index_select(table, 0, idx)",
                             "P2": "torch.index_select(table, 0, rows).float(), "
                                   "row ids computed beforehand"}})
    return {"errors": errors, "timing": timing, "scan_errors": scan_errors,
            "scan_timing": scan_timing, "batched_errors": batched_errors,
            "batched_timing": batched_timing, "bf16_errors": bf16_errors,
            "gather_errors": gather_errors, "gather_timing": gather_timing}


def _flagship_config(exp_dir):
    config = load_config(CONFIG, ["dataset=synthetic", f"max_steps={STEPS}",
                                  "print_every=1", f"exp_dir={exp_dir}"])
    mp = config.model_params
    expected = (mp["num_levels"], mp["num_prop_samples"], mp["num_nerf_samples"],
                mp["nerf_mlp_params"], mp["prop_mlp_params"], config.batch_size,
                config.compute_dtype)
    if expected != (3, 64, 32, {"net_depth": 8, "net_width": 1024},
                    {"net_depth": 4, "net_width": 256}, 4096, "float32"):
        raise AssertionError(f"{CONFIG} is no longer the flagship shape: {expected}")
    return config


def _scene(config, split, seed):
    return datasets_lib.SyntheticDataset(
        split, global_batch_size=config.batch_size, n_images=N_IMAGES,
        height=HEIGHT, width=WIDTH, seed=seed,
    )


def _launches():
    return {"K1a": volren_weights.FWD_LAUNCHES, "K1b": volren_weights.BWD_LAUNCHES,
            "K2a": prefix_scan.LAUNCHES, "K2b": prefix_scan.BATCHED_LAUNCHES,
            "P1": chunk_gather.TAKE_LAUNCHES, "P2": chunk_gather.ONEHOT_LAUNCHES}


def _only(**counts):
    """Launch counts of every kernel: those given, 0 for the others."""
    return {k: counts.get(k, 0) for k in KERNEL_IDS}


def _reset_launches():
    volren_weights.reset_launch_counts()
    prefix_scan.reset_launch_counts()
    chunk_gather.reset_launch_counts()


def _check_history(history, steps):
    if len(history) != steps:
        raise AssertionError(f"expected {steps} logged steps, got {len(history)}")
    for entry in history:
        losses = {k: v for k, v in entry.items() if k.startswith("loss")}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite loss at step {entry['step']}: {losses}")


def phase_train(exp_dir):
    config = _flagship_config(exp_dir)
    dataset = _scene(config, "train", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    model, history = train(config, device="cuda", dataset=dataset, log_fn=lambda line: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    if launches != _only(K1a=3 * STEPS, K1b=3 * STEPS):
        raise AssertionError(f"expected 3 K1a and 3 K1b launches per step, got {launches}")
    _check_history(history, STEPS)
    step_ms = [1e3 * config.batch_size / e["rays_per_sec"] for e in history]
    steady = statistics.median(step_ms[1:])
    # Backward of a linear layer is two products of the forward's size.
    step_tflop = 3 * mlp_forward_flops(model, config.batch_size) / 1e12
    emit({"phase": "train", "config": CONFIG, "steps": STEPS, "batch": config.batch_size,
          "scene": f"synthetic {N_IMAGES}x{HEIGHT}x{WIDTH}", "seconds": seconds,
          "step_ms": step_ms, "median_step_ms_after_first": steady,
          "rays_per_sec": 1e3 * config.batch_size / steady,
          "mlp_tflop_per_step": step_tflop,
          "mlp_tflop_per_s": step_tflop / (steady / 1e3),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches,
          "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")},
          "grad_norm": history[-1]["grad_norm"]})
    return config, model, launches, steady


def _render_check(config, model, flops_fn, expect, label, rtol, batch=None, rgb_atol=1e-3):
    """Render one test view three times (launches counted on the first),
    then hold 128 of its rays against the same model on the CPU. The view
    is the synthetic scene's first test view unless `batch` is given; the
    renderer is the config's `ngp_eval_renderer` for an NGP model."""
    batch = batch or _scene(config, "test", 0).image_batch(0)
    renderer = config.ngp_eval_renderer
    n_rays = HEIGHT * WIDTH
    chunks = math.ceil(n_rays / config.render_chunk_size)
    times = []
    for i in range(3):
        if i == 0:
            _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_lib.render_image(model, batch, config.render_chunk_size, "cuda", renderer)
        times.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            launches = _launches()
            if launches != expect(chunks):
                raise AssertionError(f"{label}: expected {expect(chunks)} launches, got {launches}")
    for key, shape in (("rgb", (HEIGHT, WIDTH, 3)), ("distance_mean", (HEIGHT, WIDTH))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{key}: shape {out[key].shape} or non-finite values")

    n_ref = 128
    sub = rays_lib.map_fields(
        lambda r: r.reshape((n_rays,) + r.shape[2:])[:n_ref].reshape((1, n_ref) + r.shape[2:]),
        batch,
    )
    gpu = step_lib.render_image(model, sub, config.render_chunk_size, "cuda", renderer)
    cpu = step_lib.render_image(copy.deepcopy(model).cpu(), sub, config.render_chunk_size, "cpu",
                                renderer)
    rgb_err = float(np.abs(gpu["rgb"] - cpu["rgb"]).max())
    dist_err = float(np.max(np.abs(gpu["distance_mean"] - cpu["distance_mean"])
                            / np.maximum(np.abs(cpu["distance_mean"]), 1e-6)))
    if rgb_err > rgb_atol or dist_err > rtol:
        raise AssertionError(f"{label}: GPU render disagrees with CPU: rgb {rgb_err} "
                             f"(tol {rgb_atol}), distance {dist_err} (tol {rtol})")
    flop = flops_fn(model, n_rays)
    return {"phase": label, "rays": n_rays, "chunk": config.render_chunk_size,
            "chunks": chunks, "ms": times, "median_ms": statistics.median(times),
            "launches": launches, "mlp_tflop": flop / 1e12,
            "mlp_tflop_per_s": flop / 1e12 / (statistics.median(times) / 1e3),
            "rgb_mean": float(out["rgb"].mean()),
            "distance_mean_median": float(np.median(out["distance_mean"])),
            "cpu_reference": {"rays": n_ref, "rgb_max_abs_err": rgb_err,
                              "distance_mean_max_rel_err": dist_err,
                              "tolerance": {"rgb_abs": rgb_atol, "distance_rel": rtol}},
            "render": out}


def _without_image(out):
    """A render check's record without the rendered arrays."""
    return {k: v for k, v in out.items() if k != "render"}


def phase_render(config, model):
    # Float32 matmuls of width 1024 sum in another order on the card, and
    # resampling passes that on: 1e-3 of slack on rgb in [0, 1], relative
    # 1e-3 on distances.
    out = _render_check(config, model, mlp_forward_flops,
                        lambda chunks: _only(K1a=3 * chunks), "render", 1e-3)
    emit(_without_image(out))
    return out["launches"]


KERNEL_KINDS = (  # first match wins; names as the CUDA libraries and torch give them
    ("volren_weights", ("weights_fwd_kernel", "weights_bwd_kernel")),  # K1a, K1b
    ("prefix_scan", ("prefix_scan_",)),  # K2a, K2b
    ("convolution", ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "conv3d", "winograd",
                     "cudnn", "fft2d", "implicit_")),  # the prior nets' cuDNN kernels
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "nvjet")),
    ("sort", ("sort", "radix")),
    ("scan", ("scan", "cumsum")),
    ("reduce", ("reduce",)),
    ("gather_scatter", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _kind(name):
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _profile(label, work, steps, step_tflop=None):
    """Run `work(i)` for i < steps under torch.profiler; emit device time per
    step by kind and kernel, the busy share, and the ops (with their input
    shapes) whose kernels took the most device time."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            work(i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if device_total <= 0:
        raise AssertionError("the profiler recorded no device time")
    by_kind = {}
    for e in kernels:
        kind = _kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3 / steps
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")
           and e.self_device_time_total > 0]
    top_ops = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    matmuls = sorted((e for e in kernels if _kind(e.key) == "matmul"),
                     key=lambda e: e.self_device_time_total, reverse=True)
    record = {"phase": label, "steps": steps, "wall_ms_per_step": wall_ms,
              "device_ms_per_step": device_total, "device_busy_share": device_total / wall_ms,
              "matmul_tflop_per_s_while_running": step_tflop / (by_kind.get("matmul", 0.0) / 1e3)
              if step_tflop and by_kind.get("matmul") else None,
              "device_ms_per_step_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
              "device_share_by_kind": {k: v / device_total for k, v in by_kind.items()},
              "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
              "top_kernels": [{"name": e.key[:120],
                               "ms_per_step": e.self_device_time_total / 1e3 / steps,
                               "calls_per_step": e.count / steps} for e in top],
              "top_ops": [{"op": e.key, "input_shapes": str(e.input_shapes)[:160],
                           "device_ms_per_step": e.self_device_time_total / 1e3 / steps,
                           "calls_per_step": e.count / steps} for e in top_ops],
              "top_matmul_kernels": [{"name": e.key[:160],
                                      "ms_per_step": e.self_device_time_total / 1e3 / steps}
                                     for e in matmuls[:4]]}
    emit(record)
    return record


def phase_profile(config, model, step_tflop, label="profile", steps=2, dataset=None):
    """Two train steps (after one unprofiled) under the profiler, on the
    synthetic scene unless `dataset` is given; returns the record."""
    dataset = dataset or _scene(config, "train", 1)
    optimizer, lr_fn = step_lib.make_optimizer(config, model)
    train_step = step_lib.make_train_step(config, model, optimizer, lr_fn,
                                          cameras=dataset.cameras_on("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [rays_lib.to_device(dataset.sample_batch(), "cuda") for _ in range(steps + 1)]
    train_step(batches[0], 0, 0.5, gen)
    torch.cuda.synchronize()
    return _profile(label, lambda i: train_step(batches[i + 1], i + 1, 0.5, gen), steps,
                    step_tflop)


def _ngp_config(exp_dir):
    config = load_config(NGP_CONFIG, ["dataset=synthetic", f"max_steps={NGP_STEPS}",
                                      "print_every=1", f"exp_dir={exp_dir}"])
    mp, fp = config.model_params, config.model_params["field_params"]
    expected = (mp["scale"], mp["max_samples"], mp["n_candidates"], mp["sample_budget"],
                fp["n_levels"], fp["n_features"], fp["log2_table_size"],
                fp["base_resolution"], fp["hidden_width"], config.batch_size,
                config.compute_dtype, config.occupancy_update_every)
    if expected != (8.0, 128, 512, 32, NGP_LEVELS, 2, 19, 16, 64, 8192, "float32", 16):
        raise AssertionError(f"{NGP_CONFIG} is no longer the full-width NGP shape: {expected}")
    return config


@contextlib.contextmanager
def _record_scan_shapes(shapes):
    """Record the shape of every K2a launch (the wrapper is called as usual)."""
    launch = prefix_scan.cumsum_cuda

    def recording(x):
        shapes.add(tuple(x.shape))
        return launch(x)

    prefix_scan.cumsum_cuda = recording
    try:
        yield
    finally:
        prefix_scan.cumsum_cuda = launch


def _ngp_launches(steps):
    """An NGP train run: 1 K1a and 1 K1b a step, 16 K2a (one a hash level)."""
    return _only(K1a=steps, K1b=steps, K2a=NGP_LEVELS * steps)


def _occupied_share(model):
    grid = model.occupancy
    thresh = torch.clamp(occ_lib.mean_density(grid), max=model.density_threshold)
    return float((grid > thresh).float().mean())


def phase_ngp_train(exp_dir):
    config = _ngp_config(exp_dir)
    dataset = _scene(config, "train", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    scan_shapes = set()
    t0 = time.perf_counter()
    with _record_scan_shapes(scan_shapes):
        model, history = train(config, device="cuda", dataset=dataset, log_fn=lambda line: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _launches()
    want = _ngp_launches(NGP_STEPS)
    if launches != want:
        raise AssertionError(f"expected {want} launches in {NGP_STEPS} NGP steps, got {launches}")
    if scan_shapes != {SCAN_PATH}:
        raise AssertionError(f"K2a ran at {scan_shapes}, expected only {SCAN_PATH}")
    _check_history(history, NGP_STEPS)
    step_ms = [1e3 * config.batch_size / e["rays_per_sec"] for e in history]
    refresh_steps = set(range(0, NGP_STEPS, config.occupancy_update_every))
    plain_steps = [ms for i, ms in enumerate(step_ms) if i > 0 and i not in refresh_steps]
    steady = statistics.median(plain_steps)
    share_trained = _occupied_share(model)

    # The two kinds of refresh on their own, through the loop's update function.
    update = step_lib.make_occupancy_update_fn(config, model)
    gen = torch.Generator(device="cuda").manual_seed(7)
    refresh_ms = {}
    for kind, warmup in (("warmup", True), ("sampled", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = update(model.occupancy, gen, warmup)
        torch.cuda.synchronize()
        refresh_ms[kind] = 1e3 * (time.perf_counter() - t0)
        if not torch.isfinite(grid).all():
            raise AssertionError(f"non-finite grid after a {kind} refresh")
    model.occupancy.copy_(grid)  # keep the sampled refresh, as the loop would
    if _launches()["K2a"] != NGP_LEVELS * NGP_STEPS:
        raise AssertionError("a refresh launched K2a: it should run no backward")
    points = ngp_points(model, config.batch_size)
    step_tflop = 3 * ngp_forward_flops(model, config.batch_size) / 1e12
    emit({"phase": "ngp_train", "config": NGP_CONFIG, "steps": NGP_STEPS,
          "batch": config.batch_size, "field_points_per_step": points,
          "scene": f"synthetic {N_IMAGES}x{HEIGHT}x{WIDTH}", "seconds": seconds,
          "step_ms": step_ms, "refresh_steps": sorted(refresh_steps),
          "median_step_ms_without_refresh": steady,
          "rays_per_sec": 1e3 * config.batch_size / steady,
          "refresh_ms": refresh_ms,
          "occupied_share_after_training": share_trained,
          "occupied_share_after_sampled_refresh": _occupied_share(model),
          "rm_s": history[-1]["rm_s"], "vr_s": history[-1]["vr_s"],
          "mlp_tflop_per_step": step_tflop,
          "max_memory_allocated_bytes": peak,
          "launches": launches, "k2a_shapes": sorted(scan_shapes),
          "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")},
          "grad_norm": history[-1]["grad_norm"]})
    return config, model, launches, step_tflop


def phase_ngp_render(config, model):
    # The same bf16 tables and marching on both; width-64 f32 matmuls and
    # exp/pow sum and round in another order on the card: 1e-3 on rgb in
    # [0, 1], relative 1e-3 on distances.
    out = _render_check(config, model, ngp_forward_flops,
                        lambda chunks: _only(K1a=chunks), "ngp_render", 1e-3)
    emit(_without_image(out))
    return out["launches"]


def _check_probe_times(label, results):
    bad = {k: v for k, v in results.items() if k.endswith(("_s", "_ns_per_row"))
           and not (isinstance(v, float) and math.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"{label}: times not finite and positive: {bad}")


def _per_call(label, counted, per_call):
    """A timed group's launches must be `per_call` for each of its calls."""
    if counted["calls"] <= 0 or counted["launches"] != per_call * counted["calls"]:
        raise AssertionError(f"{label}: expected {per_call} launches per call, got {counted}")


def phase_probe_osplit_bwd():
    _reset_launches()
    t0 = time.perf_counter()
    results = osplit_bwd.run(device="cuda")
    seconds = time.perf_counter() - t0
    launches = _launches()
    _check_probe_times("probe_osplit_bwd", results)
    if not results["merged_matches"]:
        raise AssertionError(f"merged row sums disagree: {results['merged_max_abs_diff']}")
    groups = results["launches"]
    _per_call("osplit fwd+bwd K2a", groups["osplit_fwd_bwd"], NGP_LEVELS)
    _per_call("one-level K2a", groups["cumsum_kernel_1lvl"], 1)
    _per_call("16 separate K2a", groups["cumsum_kernel_16_separate"], NGP_LEVELS)
    _per_call("batched K2b", groups["cumsum_kernel_batched"], 1)
    if launches["K2b"] != groups["cumsum_kernel_batched"]["launches"]:
        raise AssertionError(f"K2b launched outside its timed calls: {launches}")
    emit({"phase": "probe_osplit_bwd", "seconds": seconds, "kernel_launches": launches,
          **results})
    return launches


def phase_probe_gather():
    _reset_launches()
    t0 = time.perf_counter()
    results = gather_attack.run(device="cuda")
    seconds = time.perf_counter() - t0
    launches = _launches()
    _check_probe_times("probe_gather", results)
    _per_call("P1", results["launches"]["P1"], 1)
    _per_call("P2", results["launches"]["P2"], 1)
    if results["C_max_abs_err"] != 0.0 or results["D_max_abs_err"] != 0.0:
        raise AssertionError(f"P1/P2 differ from index_select: {results['C_max_abs_err']}, "
                             f"{results['D_max_abs_err']}")
    if launches["P1"] <= 0 or launches["P2"] <= 0:
        raise AssertionError(f"P1 or P2 not launched by the gather probe: {launches}")
    emit({"phase": "probe_gather", "seconds": seconds, "kernel_launches": launches, **results})
    return launches


def _kitti_run(config, label, expect, eval_expect):
    """train() and evaluate() on the fixture, launches counted on each;
    returns (model, history, log lines, launches, eval metrics)."""
    lines = []
    _reset_launches()
    t0 = time.perf_counter()
    model, history = train(config, device="cuda", log_fn=lines.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    if launches != expect:
        raise AssertionError(f"{label}: expected {expect} launches, got {launches}")
    _reset_launches()
    t0 = time.perf_counter()
    mean, per_image = evaluate(config, model, device="cuda", log_fn=lambda line: None)
    eval_seconds = time.perf_counter() - t0
    eval_launches = _launches()
    if eval_launches != eval_expect:
        raise AssertionError(f"{label} eval: expected {eval_expect} launches, got {eval_launches}")
    if len(per_image) != KITTI_TEST_VIEWS or not all(
            math.isfinite(mean[k]) for k in ("psnr", "ssim", "rmse", "abs_rel")) \
            or mean["n_valid"] <= 0:
        raise AssertionError(f"{label} eval: {len(per_image)} views, {mean}")
    return model, history, lines, {
        "train_seconds": seconds, "train_launches": launches,
        "eval_seconds": eval_seconds, "eval_launches": eval_launches,
        "step_ms": [1e3 * config.batch_size / e["rays_per_sec"] for e in history],
        "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")},
        **{k: mean[k] for k in ("psnr", "ssim", "rmse", "abs_rel", "n_valid")},
        "per_image": [{k: m[k] for k in EVAL_KEYS} for m in per_image]}


def phase_kitti(root):
    """The KITTI data path at full width: fixture, mip with a checkpoint
    resume, NGP, and the test split's metrics; launches per part. Returns
    the launches, NGP's config and trained model (with its grid), and the
    resumed mip run's per-image eval metrics."""
    t0 = time.perf_counter()
    make_kitti_fixture.main(root, KITTI_VIEWS)
    fixture_seconds = time.perf_counter() - t0
    scene = os.path.join(root, "dtu_format")
    chunks = KITTI_TEST_VIEWS * math.ceil(HEIGHT * WIDTH / 16384)  # render chunks of eval
    out = {"phase": "kitti", "fixture": f"{KITTI_VIEWS} views of {HEIGHT}x{WIDTH}",
           "fixture_seconds": fixture_seconds}
    probe = load_config(CONFIG, [f"scene_dir={scene}"])
    if not native_batcher.applies(probe, build_dataset(probe, "train")):
        raise AssertionError("kitti: the driving layout should draw from the C++ dataplane")
    out["batches"] = "C++ dataplane (use_native_batcher, shared intrinsics)"
    launches = {}

    exp = os.path.join(root, "mip")
    base = [f"scene_dir={scene}", f"exp_dir={exp}", "print_every=1",
            f"checkpoint_every={KITTI_CKPT_EVERY}"]
    config = load_config(CONFIG, base + [f"max_steps={KITTI_MIP_STEPS}"])
    if config.dataset != "driving" or config.render_chunk_size != 16384:
        raise AssertionError(f"{CONFIG} no longer trains on the driving layout")
    steps = KITTI_MIP_STEPS
    _, history, _, mip = _kitti_run(config, "kitti mip", _only(K1a=3 * steps, K1b=3 * steps),
                                    _only(K1a=3 * chunks))
    _check_history(history, steps)
    saved = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    if saved != ["2", "4", "model_meta.json"]:
        raise AssertionError(f"kitti mip: checkpoints {saved}")
    config = load_config(CONFIG, base + [f"max_steps={KITTI_MIP_RESUMED_STEPS}"])
    steps = KITTI_MIP_RESUMED_STEPS - KITTI_MIP_STEPS
    _, history, lines, resumed = _kitti_run(config, "kitti mip resumed",
                                            _only(K1a=3 * steps, K1b=3 * steps),
                                            _only(K1a=3 * chunks))
    if json.loads(lines[0]) != {"restored_step": KITTI_MIP_STEPS} or \
            [e["step"] for e in history] != [KITTI_MIP_STEPS + 1, KITTI_MIP_RESUMED_STEPS]:
        raise AssertionError(f"kitti mip: no resume from step {KITTI_MIP_STEPS}: {lines[:2]}")
    out["mip"] = dict(mip, near_m=config.near, far_m=config.far)
    out["mip_resumed"] = dict(resumed, restored_step=KITTI_MIP_STEPS)
    launches["kitti_mip"], launches["kitti_mip_resumed"] = (
        mip["train_launches"], resumed["train_launches"])
    launches["kitti_mip_eval"] = resumed["eval_launches"]
    torch.cuda.empty_cache()

    config = load_config(NGP_CONFIG, [f"scene_dir={scene}", f"exp_dir={os.path.join(root, 'ngp')}",
                                      f"max_steps={NGP_STEPS}", "print_every=1"])
    model, history, _, ngp = _kitti_run(
        config, "kitti ngp", _ngp_launches(NGP_STEPS),
        _only(K1a=chunks))
    _check_history(history, NGP_STEPS)
    out["ngp"] = dict(ngp, rm_s=history[-1]["rm_s"], vr_s=history[-1]["vr_s"],
                      occupied_share=_occupied_share(model))
    launches["kitti_ngp"], launches["kitti_ngp_eval"] = ngp["train_launches"], ngp["eval_launches"]
    torch.cuda.empty_cache()
    # The same NGP run on numpy-sampled pixels cast in the step, the loop's
    # batches before the dataplane: its steps beside the dataplane's.
    numpy_config = config.replace(exp_dir=os.path.join(root, "ngp_numpy"),
                                  use_native_batcher=False)
    _, history, _, numpy_ngp = _kitti_run(numpy_config, "kitti ngp numpy batches",
                                          _ngp_launches(NGP_STEPS), _only(K1a=chunks))
    _check_history(history, NGP_STEPS)
    launches["kitti_ngp_numpy"] = numpy_ngp["train_launches"]
    refresh = set(range(0, NGP_STEPS, config.occupancy_update_every))
    steady = lambda run: statistics.median(
        ms for i, ms in enumerate(run["step_ms"]) if i not in refresh)
    out["ngp_batches"] = {
        "dataplane_median_step_ms": steady(ngp), "numpy_median_step_ms": steady(numpy_ngp),
        "numpy": {k: numpy_ngp[k] for k in ("psnr", "ssim", "rmse", "abs_rel", "step_ms")}}
    torch.cuda.empty_cache()
    emit(out)
    return launches, config, model, out["mip_resumed"]["per_image"]


def phase_nerfpp(root):
    """NeRF++ at full width on the fixture written by phase `kitti`: train,
    render, evaluate, profile; no kernel of the port on any part."""
    scene = os.path.join(root, "nerfpp")
    config = load_config(NERFPP_CONFIG, [f"scene_dir={scene}", f"max_steps={NERFPP_STEPS}",
                                         f"exp_dir={os.path.join(root, 'nerfpp_exp')}",
                                         "print_every=1"])
    mp = config.model_params
    expected = (config.dataset, tuple(mp["cascade_samples"]), mp["net_depth"], mp["net_width"],
                mp["pos_degrees"], mp["view_degrees"], config.batch_size, config.compute_dtype,
                config.grad_max_norm, config.depth_loss_type, config.lambda_depth,
                config.depth_loss_reduce, config.depth_fg_far_mask, config.render_chunk_size)
    if expected != ("nerfpp", (64, 128), 8, 256, 10, 4, 1024, "float32", 1.0, "mse", 1.0,
                    "mean_valid", True, 16384):
        raise AssertionError(f"{NERFPP_CONFIG} is no longer the full-width NeRF++ shape: "
                             f"{expected}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    model, history = train(config, device="cuda", log_fn=lambda line: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"nerfpp": _launches()}
    if launches["nerfpp"] != _only():
        raise AssertionError(f"a kernel launched on the NeRF++ path: {launches['nerfpp']}")
    _check_history(history, NERFPP_STEPS)
    step_ms = [1e3 * config.batch_size / e["rays_per_sec"] for e in history]
    steady = statistics.median(step_ms[1:])
    step_tflop = 3 * nerfpp_forward_flops(model, config.batch_size) / 1e12
    points = config.batch_size * 2 * sum(
        sum(mp["cascade_samples"][:i + 1]) for i in range(len(mp["cascade_samples"])))

    test = datasets_lib.NerfppSceneDataset(scene, "test", config.batch_size)
    if (test.height, test.width) != (HEIGHT, WIDTH):
        raise AssertionError(f"fixture views are {test.height}x{test.width}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Float32 8x256 matmuls sum in another order on the card, and the
    # inverse-CDF resampling passes that on: 1e-3 on rgb in [0, 1],
    # relative 1e-3 on depths.
    render = _render_check(config, model, nerfpp_forward_flops, lambda chunks: _only(),
                           "nerfpp_render", 1e-3, batch=test.image_batch(0))
    render["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit(_without_image(render))
    launches["nerfpp_render"] = render["launches"]

    _reset_launches()
    t0 = time.perf_counter()
    mean, per_image = evaluate(config, model, device="cuda", log_fn=lambda line: None)
    eval_seconds = time.perf_counter() - t0
    launches["nerfpp_eval"] = _launches()
    if launches["nerfpp_eval"] != _only():
        raise AssertionError(f"a kernel launched in the NeRF++ eval: {launches['nerfpp_eval']}")
    if len(per_image) != KITTI_TEST_VIEWS or not all(
            math.isfinite(mean[k]) for k in ("psnr", "ssim", "rmse", "abs_rel")) \
            or mean["n_valid"] <= 0:
        raise AssertionError(f"nerfpp eval: {len(per_image)} views, {mean}")
    emit({"phase": "nerfpp", "config": NERFPP_CONFIG, "steps": NERFPP_STEPS,
          "batch": config.batch_size, "field_points_per_step": points,
          "scene": f"KITTI fixture, NeRF++ layout, {test.n_images} test views of "
                   f"{HEIGHT}x{WIDTH}", "seconds": seconds,
          "step_ms": step_ms, "median_step_ms_after_first": steady,
          "rays_per_sec": 1e3 * config.batch_size / steady,
          "mlp_tflop_per_step": step_tflop, "mlp_tflop_per_s": step_tflop / (steady / 1e3),
          "max_memory_allocated_bytes": peak,
          "launches": launches["nerfpp"], "k1_launches": launches["nerfpp"]["K1a"]
          + launches["nerfpp"]["K1b"] + launches["nerfpp_render"]["K1a"]
          + launches["nerfpp_eval"]["K1a"],
          "k1_note": "0 by design: NeRF++ composites with cumprod(1 - alpha + 1e-6), "
                     "not K1's exp-of-cumsum",
          "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")},
          "grad_norm": history[-1]["grad_norm"],
          "render_chunk": config.render_chunk_size,
          "eval": {"views": len(per_image), "seconds": eval_seconds,
                   **{k: mean[k] for k in ("psnr", "ssim", "rmse", "abs_rel", "n_valid")}}})

    train_set = datasets_lib.NerfppSceneDataset(scene, "train", config.batch_size)
    phase_profile(config.replace(depth_scale=float(train_set.scene_scale)), model, step_tflop,
                  label="nerfpp_profile", dataset=train_set)
    del model
    torch.cuda.empty_cache()
    return launches


def _train_phase(config, dataset=None, scan_shapes=None, max_steps=None):
    """train() from scratch with the launch counts zeroed before it, for
    `max_steps` steps of the config's schedule when given; returns (model,
    history, launches, seconds, peak memory bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _record_scan_shapes(scan_shapes if scan_shapes is not None else set()):
        model, history = train(config, device="cuda", dataset=dataset, log_fn=lambda line: None,
                               max_steps=max_steps)
    torch.cuda.synchronize()
    return (model, history, _launches(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def _steady_ms(config, history, skip=1):
    """Host-clock ms per step of each logged interval, and their median after `skip`."""
    step_ms = [1e3 * config.batch_size / e["rays_per_sec"] for e in history]
    return step_ms, statistics.median(step_ms[skip:])


def _one_step_memory(config, model, dataset, remat):
    """Peak memory and K1 launches of one train step of `model` under `remat`."""
    config = config.replace(remat=remat)
    optimizer, lr_fn = step_lib.make_optimizer(config, model)
    step = step_lib.make_train_step(config, model, optimizer, lr_fn,
                                    cameras=dataset.cameras_on("cuda"))
    batch = rays_lib.to_device(dataset.sample_batch(), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    stats = step(batch, 1, 0.5, gen)
    loss = float(stats["loss"])
    ms = 1e3 * (time.perf_counter() - t0)
    if not math.isfinite(loss):
        raise AssertionError(f"remat={remat}: non-finite loss {loss}")
    return {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "step_ms": ms,
            "launches": _launches(), "loss": loss}


def phase_bf16_synthetic(train_ms_f32):
    """bf16 on the synthetic scene: the 16k remat config, the flagship at
    batch 4096 and NGP; each trained, profiled or rendered, launches counted."""
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as exp_dir:
        config = load_config(REMAT_CONFIG, ["dataset=synthetic", f"max_steps={STEPS}",
                                            "print_every=1", f"exp_dir={exp_dir}"])
        mp = config.model_params
        expected = (mp["num_levels"], mp["num_prop_samples"], mp["num_nerf_samples"],
                    mp["nerf_mlp_params"], mp["prop_mlp_params"], config.batch_size,
                    config.compute_dtype, config.remat)
        if expected != (3, 64, 32, {"net_depth": 8, "net_width": 1024},
                        {"net_depth": 4, "net_width": 256}, 16384, "bfloat16", "dots"):
            raise AssertionError(f"{REMAT_CONFIG} is no longer the 16k remat shape: {expected}")
        dataset = _scene(config, "train", 0)
        model, history, counted, seconds, peak = _train_phase(config, dataset)
    # remat="dots" recomputes the forward, K1a with it: 6 K1a, 3 K1b a step.
    if counted != _only(K1a=6 * STEPS, K1b=3 * STEPS):
        raise AssertionError(f"16k remat: expected 6 K1a and 3 K1b launches a step, got {counted}")
    _check_history(history, STEPS)
    launches["bf16_mip16k"] = counted
    step_ms, steady = _steady_ms(config, history)
    step_tflop = 3 * mlp_forward_flops(model, config.batch_size) / 1e12
    memory = {remat: _one_step_memory(config, model, dataset, remat)
              for remat in ("none", "dots", "full")}
    for remat, k1a in (("none", 3), ("dots", 6), ("full", 6)):
        if memory[remat]["launches"] != _only(K1a=k1a, K1b=3):
            raise AssertionError(f"remat={remat}: launches {memory[remat]['launches']}")
    out["mip16k"] = {"config": REMAT_CONFIG, "steps": STEPS, "batch": config.batch_size,
                     "compute_dtype": config.compute_dtype, "remat": config.remat,
                     "seconds": seconds, "step_ms": step_ms, "median_step_ms_after_first": steady,
                     "rays_per_sec": 1e3 * config.batch_size / steady,
                     "mlp_tflop_per_step": step_tflop,
                     "mlp_tflop_per_s": step_tflop / (steady / 1e3),
                     "max_memory_allocated_bytes": peak, "launches": counted,
                     "one_step_by_remat": memory,
                     "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")}}
    prof = phase_profile(config, model, step_tflop, label="bf16_mip16k_profile")
    names = [k["name"] for k in prof["top_matmul_kernels"]]
    # bf16 products on the tensor cores: faster than the card's float32
    # SIMT peak, and no float32 SIMT GEMM among the largest.
    if not prof["matmul_tflop_per_s_while_running"] \
            or prof["matmul_tflop_per_s_while_running"] <= FP32_FLOPS_PER_S / 1e12 \
            or any("sgemm" in n for n in names):
        raise AssertionError(f"the 16k step's matmuls are not bf16 tensor-core GEMMs: "
                             f"{prof['matmul_tflop_per_s_while_running']} TFLOP/s, {names}")
    out["mip16k_profile"] = {k: prof[k] for k in (
        "device_ms_per_step", "device_busy_share", "matmul_tflop_per_s_while_running",
        "device_ms_per_step_by_kind", "top_matmul_kernels")}
    # bf16 rounds in another order on the card than on the CPU, through 8
    # layers of width 1024 and the resampling: 2e-2 on rgb in [0, 1],
    # relative 5e-2 on distances.
    render = _render_check(config, model, mlp_forward_flops,
                           lambda chunks: _only(K1a=3 * chunks), "bf16_mip16k_render", 5e-2,
                           rgb_atol=2e-2)
    launches["bf16_mip16k_render"] = render["launches"]
    out["mip16k_render"] = _without_image(render)
    del model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as exp_dir:
        config = _flagship_config(exp_dir).replace(compute_dtype="bfloat16")
        model, history, counted, seconds, peak = _train_phase(config, _scene(config, "train", 0))
    if counted != _only(K1a=3 * STEPS, K1b=3 * STEPS):
        raise AssertionError(f"bf16 flagship: expected 3 K1a and 3 K1b a step, got {counted}")
    _check_history(history, STEPS)
    launches["bf16_flagship"] = counted
    step_ms, steady = _steady_ms(config, history)
    out["flagship"] = {"config": CONFIG, "compute_dtype": "bfloat16", "batch": config.batch_size,
                       "steps": STEPS, "step_ms": step_ms, "median_step_ms_after_first": steady,
                       "rays_per_sec": 1e3 * config.batch_size / steady,
                       "float32_median_step_ms_after_first": train_ms_f32,
                       "max_memory_allocated_bytes": peak, "launches": counted}
    del model
    torch.cuda.empty_cache()

    scan_shapes = set()
    with tempfile.TemporaryDirectory() as exp_dir:
        config = _ngp_config(exp_dir).replace(compute_dtype="bfloat16")
        model, history, counted, seconds, peak = _train_phase(
            config, _scene(config, "train", 0), scan_shapes)
    want = _ngp_launches(NGP_STEPS)
    if counted != want or scan_shapes != {SCAN_PATH}:
        raise AssertionError(f"bf16 NGP: expected {want} at {SCAN_PATH}, got {counted} at "
                             f"{scan_shapes}")
    _check_history(history, NGP_STEPS)
    launches["bf16_ngp"] = counted
    step_ms, _ = _steady_ms(config, history)
    refresh_steps = set(range(0, NGP_STEPS, config.occupancy_update_every))
    steady = statistics.median(ms for i, ms in enumerate(step_ms)
                               if i > 0 and i not in refresh_steps)
    out["ngp"] = {"config": NGP_CONFIG, "compute_dtype": "bfloat16", "batch": config.batch_size,
                  "steps": NGP_STEPS, "step_ms": step_ms,
                  "median_step_ms_without_refresh": steady,
                  "rays_per_sec": 1e3 * config.batch_size / steady,
                  "max_memory_allocated_bytes": peak, "launches": counted,
                  "k2a_shapes": sorted(scan_shapes)}
    # The same bf16 tables and marching; bf16 width-64 matmuls round in
    # another order on the card: 2e-2 on rgb, relative 5e-2 on distances.
    render = _render_check(config, model, ngp_forward_flops, lambda chunks: _only(K1a=chunks),
                           "bf16_ngp_render", 5e-2, rgb_atol=2e-2)
    launches["bf16_ngp_render"] = render["launches"]
    out["ngp_render"] = _without_image(render)
    del model
    torch.cuda.empty_cache()
    emit({"phase": "bf16", **out})
    return launches


def phase_bf16_nerfpp(root):
    """NeRF++ at the reference bench's nerfpp_1024 operating point on the
    fixture written by phase `kitti`: bf16, batch 1024, 8 steps per loop
    iteration; a render held against the CPU; 8 steps profiled."""
    scene = os.path.join(root, "nerfpp")
    config = load_config(NERFPP_CONFIG, [
        f"scene_dir={scene}", f"max_steps={NERFPP_BF16_STEPS}", "print_every=8",
        f"exp_dir={os.path.join(root, 'nerfpp_bf16')}", "compute_dtype=bfloat16",
        f"steps_per_dispatch={NERFPP_FUSED}"])
    model, history, counted, seconds, peak = _train_phase(config)
    if counted != _only():
        raise AssertionError(f"a kernel launched on the bf16 NeRF++ path: {counted}")
    _check_history(history, NERFPP_BF16_STEPS // NERFPP_FUSED)
    step_ms, steady = _steady_ms(config, history)
    step_tflop = 3 * nerfpp_forward_flops(model, config.batch_size) / 1e12
    train_set = datasets_lib.NerfppSceneDataset(scene, "train", config.batch_size)
    prof = phase_profile(config.replace(depth_scale=float(train_set.scene_scale)), model,
                         step_tflop, label="bf16_nerfpp_profile", steps=NERFPP_FUSED,
                         dataset=train_set)
    test = datasets_lib.NerfppSceneDataset(scene, "test", config.batch_size)
    # bf16 8x256 matmuls round in another order on the card, and the
    # inverse-CDF resampling passes that on: 2e-2 on rgb, relative 5e-2 on depths.
    render = _render_check(config, model, nerfpp_forward_flops, lambda chunks: _only(),
                           "bf16_nerfpp_render", 5e-2, batch=test.image_batch(0), rgb_atol=2e-2)
    emit({"phase": "bf16", "nerfpp": {
        "config": NERFPP_CONFIG, "compute_dtype": "bfloat16", "batch": config.batch_size,
        "steps_per_dispatch": config.steps_per_dispatch, "steps": NERFPP_BF16_STEPS,
        "seconds": seconds, "step_ms_per_logged_iteration": step_ms,
        "median_step_ms_after_first_iteration": steady,
        "rays_per_sec": 1e3 * config.batch_size / steady,
        "mlp_tflop_per_step": step_tflop, "max_memory_allocated_bytes": peak,
        "launches": counted,
        "profile": {k: prof[k] for k in ("steps", "wall_ms_per_step", "device_ms_per_step",
                                         "device_busy_share", "matmul_tflop_per_s_while_running",
                                         "device_ms_per_step_by_kind", "top_matmul_kernels")},
        "render": _without_image(render)}})
    del model
    torch.cuda.empty_cache()
    return {"bf16_nerfpp": counted, "bf16_nerfpp_render": render["launches"]}


def _timed_render(model, batch, config, renderer):
    """Median ms of three renders of one view, and the last render."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_lib.render_image(model, batch, config.render_chunk_size, "cuda", renderer)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def phase_ngp_eval(config, model):
    """NGP's iterative eval renderer on the grid trained in phase `kitti`:
    a test view rendered iteratively and by the dense train path (at the
    config's budget, and at budget 0 as the reference bench's "train"
    mode), the two held against each other, the iterative one against the
    CPU; rays/s of each and their ratio."""
    test = build_dataset(config, "test")
    batch = test.image_batch(0)
    n_rays = test.height * test.width
    iterative = config.replace(ngp_eval_renderer="iterative")
    check = _render_check(iterative, model, ngp_forward_flops, lambda chunks: _only(),
                          "ngp_eval_render", 1e-3, batch=batch)
    rounds = sorted({int(r) for r in np.unique(check["render"]["rounds"])})
    samples = check["render"]["samples_per_ray"]
    it_ms = check["median_ms"]
    budget = model.sample_budget
    _reset_launches()
    train_ms, dense_budget = _timed_render(model, batch, config, "train")
    train_launches = _launches()
    model.sample_budget = 0
    try:
        train0_ms, dense = _timed_render(model, batch, config, "train")
    finally:
        model.sample_budget = budget
    it = check["render"]
    diff = {k: float(np.mean(np.abs(it[k] - dense[k]))) for k in ("rgb", "acc")}
    psnr = float(-10.0 * np.log10(np.mean((it["rgb"] - dense["rgb"]) ** 2) + 1e-12))
    # Two quadratures of one field on one grid (the reference's own test
    # holds its iterative renderer to fine quadrature at 0.02 per ray): a
    # mean over the view below 0.02 for rgb and opacity.
    if diff["rgb"] > NGP_EVAL_MEAN_TOL or diff["acc"] > NGP_EVAL_MEAN_TOL:
        raise AssertionError(f"iterative and dense renders disagree: {diff} "
                             f"(tol {NGP_EVAL_MEAN_TOL})")
    record = {
        "phase": "ngp_eval", "config": NGP_CONFIG, "view": f"fixture test view 0, "
        f"{test.height}x{test.width}", "chunk": config.render_chunk_size,
        "eval_samples_per_round": model.eval_samples_per_round,
        "eval_candidates_per_round": model.eval_candidates_per_round,
        "occupied_share": _occupied_share(model),
        "iterative": {"median_ms": it_ms, "ms": check["ms"], "rays_per_sec": n_rays / it_ms * 1e3,
                      "rounds_per_chunk": rounds,
                      "samples_per_ray_mean": float(np.mean(samples)),
                      "samples_per_ray_max": int(np.max(samples)),
                      "launches": check["launches"], "cpu_reference": check["cpu_reference"]},
        "train": {"sample_budget": budget, "median_ms": train_ms,
                  "rays_per_sec": n_rays / train_ms * 1e3, "launches": train_launches},
        "train_budget0": {"sample_budget": 0, "median_ms": train0_ms,
                          "rays_per_sec": n_rays / train0_ms * 1e3},
        "speedup_vs_budget0": train0_ms / it_ms,
        "speedup_vs_config_budget": train_ms / it_ms,
        "iterative_vs_budget0_mean_abs": diff, "iterative_vs_budget0_psnr": psnr,
        "iterative_vs_config_budget_mean_abs": {
            k: float(np.mean(np.abs(it[k] - dense_budget[k]))) for k in ("rgb", "acc")},
        "tolerance_mean_abs": NGP_EVAL_MEAN_TOL}
    emit(record)
    return {"ngp_eval": check["launches"], "ngp_eval_train": train_launches}



def _smooth_image(gen, h, w):
    """Band-limited random image in [0, 1]: low-res noise resized up."""
    base = torch.rand(1, 3, h // 16, w // 16, generator=gen)
    img = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    return img[0].permute(1, 2, 0).numpy()


def _stereo_pair(gen, h, w, max_disp=PRIOR_RAMP_DISP):
    """A left image and the right one warped from it by a known smooth
    disparity ramp: right(x) = left(x + d), so left(x) = right(x - d)."""
    left = _smooth_image(gen, h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 4.0 + (max_disp - 8.0) * (yy / h) + 2.0 * np.sin(xx / 37.0)
    xs = np.clip(xx + disp, 0, w - 1)
    x0 = np.floor(xs).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    t = (xs - x0)[..., None]
    row = np.arange(h)[:, None]
    right = left[row, x0] * (1 - t) + left[row, x1] * t
    return left, right.astype(np.float32), disp.astype(np.float32)


def _driving_frame(gen, h, w):
    """An image and a metric depth map shaped like a road scene (near at the
    bottom, far at the top, 5 to 80 m), and its 5% sparse subsample."""
    rgb = _smooth_image(gen, h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = np.clip(5.0 + 75.0 * (1.0 - yy / h) ** 2 + 3.0 * np.sin(xx / 50.0), 5.0, 80.0)
    keep = torch.rand(h, w, generator=gen).numpy() < 0.05
    return rgb, np.where(keep, depth, 0.0).astype(np.float32), depth.astype(np.float32)


def _crops(arrays, size):
    """A batch of PRIOR_BATCH crops of `size` from each [H, W, ...] array,
    at fixed corners."""
    (ch, cw), (h, w) = size, arrays[0].shape[:2]
    corners = [(0, 0), (h - ch, w - cw)][:PRIOR_BATCH]
    return tuple(np.stack([a[y:y + ch, x:x + cw] for y, x in corners]) for a in arrays)


def _op_times(prof, steps):
    """Device ms per step, children included, of the prior nets' op kinds:
    2D and 3D convolutions, the guided conv's einsum, GroupNorm, resizes,
    softmaxes and gathers."""
    ops = {"aten::cudnn_convolution", "aten::einsum", "aten::native_group_norm",
           "aten::upsample_bilinear2d", "aten::upsample_trilinear3d", "aten::_softmax",
           "aten::gather", "aten::constant_pad_nd"}
    out = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in ops:
            continue
        name = e.key
        if name == "aten::cudnn_convolution":
            name += f" {len(e.input_shapes[0]) - 2}d" if e.input_shapes else ""
        out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _prior_forward(label, net, inputs, cpu_inputs, out_keys, conf_keys=()):
    """Forward ms (median of 5) and peak memory at full width, one profiled
    forward (device time by kind and by op), and the outputs on a crop held
    against the same net on the CPU."""
    net.eval()
    with torch.inference_mode():
        net(*inputs)  # cuDNN picks its algorithms on the first call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            net(*inputs)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
            net(*inputs)
            torch.cuda.synchronize()
        gpu = net(*train_prior.to_device(cpu_inputs, "cuda"))
    cpu_net = copy.deepcopy(net).cpu()
    with torch.no_grad():
        ref = cpu_net(*train_prior.to_device(cpu_inputs, "cpu"))
    gpu = gpu if isinstance(gpu, dict) else {"depth": gpu}
    ref = ref if isinstance(ref, dict) else {"depth": ref}
    errors = {}
    for key in out_keys:
        err = float((gpu[key].cpu() - ref[key]).abs().max())
        tol = PRIOR_CPU_RTOL_OF_MAX * (1.0 if key in conf_keys else float(ref[key].abs().max()))
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{label} {key}: card vs CPU {err} > {tol}")
        errors[key] = {"max_abs_err": err, "tolerance": tol}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    by_kind = {}
    for e in kernels:
        by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0.0) + e.self_device_time_total / 1e3
    return {"forward_ms": statistics.median(times), "forward_ms_all": times,
            "max_memory_allocated_bytes": peak,
            "profiled_device_ms": sum(by_kind.values()),
            "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "device_ms_by_op": _op_times(prof, 1),
            "kernel_launches": sum(e.count for e in kernels),
            "cpu_check": {"crop": list(PRIOR_CPU_CROP), **errors}}


def _prior_train(net, loss_fn, batch):
    """PRIOR_STEPS Adam steps (optax's defaults at PRIOR_LR) on one fixed
    batch at the training crop; the loss must fall."""
    net.train()
    optimizer = train_prior.make_optimizer(net, PRIOR_LR)
    batch = train_prior.to_device(batch, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(PRIOR_STEPS):
        t0 = time.perf_counter()
        losses.append(float(train_prior.train_step(optimizer, loss_fn, batch)))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall in {PRIOR_STEPS} steps: {losses}")
    return {"steps": PRIOR_STEPS, "batch": PRIOR_BATCH, "crop": list(PRIOR_CROP), "lr": PRIOR_LR,
            "step_ms": step_ms, "median_step_ms_after_first": statistics.median(step_ms[1:]),
            "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def _emit_progress(net, record):
    train = record["train"]
    emit({"phase": "priors_progress", "net": net, "forward_ms": record["forward_ms"],
          "step_ms": train["median_step_ms_after_first"], "first_loss": train["first_loss"],
          "last_loss": train["last_loss"]})


def phase_priors(root):
    """The depth-prior generators at full width on one KITTI frame (both
    stereo variants, both completion nets: forward, CPU check, 20 training
    steps), then the prior -> NeRF chain on the fixture phase `kitti` wrote.
    No kernel of the port may launch in the prior nets."""
    gen = torch.Generator().manual_seed(0)
    (h, w), (ph, pw) = PRIOR_FRAME, PRIOR_PADDED
    out = {"phase": "priors", "frame": f"{h}x{w} padded to {ph}x{pw}"}
    _reset_launches()

    left, right, disp = _stereo_pair(gen, h, w)
    pair = [generate._pad_to_multiple(a)[0] for a in (left, right)]
    if pair[0].shape[:2] != PRIOR_PADDED:
        raise AssertionError(f"padded frame {pair[0].shape}")
    ch, cw = PRIOR_CPU_CROP
    nets = {}
    for variant in ("cfnet", "pcwnet"):
        net = stereo.StereoNet(variant=variant, generator=torch.Generator().manual_seed(1))
        net.cuda()
        record = {"config": {"max_disparity": net.max_disparity,
                             "base_features": net.features.stem.conv.weight.shape[0],
                             "num_groups": net.num_groups, "concat_features": net.concat_features,
                             "refine_offsets": net.refine_offsets},
                  "parameters": sum(p.numel() for p in net.parameters())}
        record.update(_prior_forward(
            f"stereo {variant}", net, train_prior.to_device([a[None] for a in pair], "cuda"),
            [a[None, :ch, :cw] for a in pair],
            ("disparity", "confidence", "disparity_1_4", "disparity_1_8", "uncertainty_1_8"),
            conf_keys=("confidence",)))
        loss_fn = train_prior.stereo_loss(net, net.max_disparity)
        record["train"] = _prior_train(net, loss_fn, _crops((left, right, disp), PRIOR_CROP))
        out[f"stereo_{variant}"] = record
        nets[variant] = net
        _emit_progress(f"stereo_{variant}", record)

    rgb, sparse, depth = _driving_frame(gen, h, w)
    frame = [generate._pad_to_multiple(a)[0] for a in (rgb, sparse)]
    for arch in ("guided", "resnet"):
        net = generate.build_completion_net(arch, torch.Generator().manual_seed(2)).cuda()
        record = {"parameters": sum(p.numel() for p in net.parameters())}
        record.update(_prior_forward(
            f"completion {arch}", net, train_prior.to_device([a[None] for a in frame], "cuda"),
            [a[None, :ch, :cw] for a in frame], ("depth",)))
        loss_fn = train_prior.completion_loss(net, 0.01)
        record["train"] = _prior_train(net, loss_fn, _crops((rgb, sparse, depth), PRIOR_CROP))
        out[f"completion_{arch}"] = record
        nets[arch] = net
        _emit_progress(f"completion_{arch}", record)
    launches = {"priors_nets": _launches()}
    if launches["priors_nets"] != _only():
        raise AssertionError(f"a kernel launched in the prior nets: {launches['priors_nets']}")

    # The chain: priors from the trained nets into the fixture, read back,
    # then the flagship trained on the completion prior.
    scene = os.path.join(root, "dtu_format")
    work = os.path.join(root, "priors_work")
    t0 = time.perf_counter()
    e2e_prior_loop.build_completion_data(scene, work)
    prior_dir = os.path.join(scene, f"depths_{e2e_prior_loop.PRIOR_NAME}")
    generate.generate_completion_priors(
        nets["guided"].state_dict(), os.path.join(scene, "images"),
        os.path.join(work, "completion_data", "sparse"), prior_dir, arch="guided",
        log_fn=lambda line: None)
    completion_s = time.perf_counter() - t0
    stereo_dirs = {eye: os.path.join(work, eye) for eye in ("left", "right", "ste_conf")}
    for eye in ("left", "right"):
        os.makedirs(stereo_dirs[eye])
    for i in range(PRIOR_STEREO_PAIRS):
        l_img, r_img, _ = _stereo_pair(gen, h, w)
        for eye, img in (("left", l_img), ("right", r_img)):
            png.write_png(os.path.join(stereo_dirs[eye], f"{i:06d}.png"),
                          (np.clip(img, 0, 1) * 255).astype(np.uint8))
    log = []
    t0 = time.perf_counter()
    generate.generate_stereo_priors(
        nets["cfnet"].state_dict(), stereo_dirs["left"], stereo_dirs["right"],
        stereo_dirs["ste_conf"], focal=721.5377, baseline=0.54,
        confidence_threshold=PRIOR_CONF_THRESHOLD, log_fn=log.append)
    stereo_s = time.perf_counter() - t0
    read_back = {}
    for name, d, shape in (("mffgen_crop", prior_dir, (HEIGHT, WIDTH)),
                           ("ste_conf", stereo_dirs["ste_conf"], PRIOR_FRAME)):
        codes = [png.read_png(os.path.join(d, f)) for f in sorted(os.listdir(d))]
        if not codes or any(c.dtype != np.uint16 or c.shape != shape for c in codes):
            raise AssertionError(f"{name}: {len(codes)} PNGs, {[c.shape for c in codes[:2]]}")
        read_back[name] = {"pngs": len(codes),
                           "density": float(np.mean([(c > 0).mean() for c in codes])),
                           "max_m": float(max(c.max() for c in codes)) / 256.0}
    if read_back["mffgen_crop"]["pngs"] != KITTI_VIEWS:
        raise AssertionError(f"{read_back['mffgen_crop']['pngs']} completion priors")
    dataset = datasets_lib.DrivingSceneDataset(scene, "train", 4096,
                                               depth_sup_type=e2e_prior_loop.PRIOR_NAME)
    valid = float((dataset.depth_sup > 0).mean())
    if not np.isfinite(dataset.depth_sup).all() or valid <= 0:
        raise AssertionError(f"DrivingSceneDataset on the prior: valid share {valid}")
    chunks = KITTI_TEST_VIEWS * math.ceil(HEIGHT * WIDTH / 16384)
    config = load_config(CONFIG, [f"scene_dir={scene}", f"exp_dir={os.path.join(root, 'priors_mip')}",
                                  f"max_steps={KITTI_MIP_STEPS}", "print_every=1",
                                  f"depth_sup_type={e2e_prior_loop.PRIOR_NAME}"])
    steps = KITTI_MIP_STEPS
    _, history, _, mip = _kitti_run(config, "priors mip", _only(K1a=3 * steps, K1b=3 * steps),
                                    _only(K1a=3 * chunks))
    _check_history(history, steps)
    launches["priors_mip"], launches["priors_mip_eval"] = mip["train_launches"], mip["eval_launches"]
    out["chain"] = {"completion_priors_seconds": completion_s, "stereo_priors_seconds": stereo_s,
                    "stereo_log": log, "read_back": read_back,
                    "dataset_train_views": dataset.n_images, "depth_sup_valid_share": valid,
                    "mip": mip}
    out["launches"] = launches
    del nets
    torch.cuda.empty_cache()
    emit(out)
    return launches


def _street_sequence(root, gen):
    """A textured street at the KITTI frame size, seen from a camera that
    drives PHOTO_SPEED m and turns PHOTO_YAW rad a frame: walls at x = +-5 m,
    the road 1.6 m below the camera, a far wall at 80 m, textured in cells of
    0.3 m. Writes root/{image, sparse (PHOTO_DENSITY of the pixels),
    groundtruth}/*.png and root/K.txt; returns K and the world-to-camera
    poses (R [3, 3], t [3])."""
    (h, w), f = PRIOR_FRAME, PHOTO_FOCAL
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]])
    table = torch.rand(512, 512, 3, generator=gen).numpy()
    planes = [(np.array([1.0, 0, 0]), -5.0, (2, 1)), (np.array([1.0, 0, 0]), 5.0, (2, 1)),
              (np.array([0, 1.0, 0]), 1.6, (0, 2)), (np.array([0, 0, 1.0]), 80.0, (0, 1))]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(u - K[0, 2]) / f, (v - K[1, 2]) / f, np.ones_like(u)], -1)
    for sub in ("image", "sparse", "groundtruth"):
        os.makedirs(os.path.join(root, sub))
    poses = []
    for i in range(PHOTO_FRAMES):
        yaw = PHOTO_YAW * i
        c2w = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                        [-math.sin(yaw), 0, math.cos(yaw)]])
        centre = np.array([0.0, 0.0, PHOTO_SPEED * i])
        dirs = rays @ c2w.T
        depth = np.full((h, w), np.inf)
        rgb = np.zeros((h, w, 3))
        for k, (normal, offset, axes) in enumerate(planes):
            with np.errstate(divide="ignore", invalid="ignore"):
                s = (offset - normal @ centre) / (dirs @ normal)
            hit = (s > 0) & (s < depth)
            X = centre + s[hit][:, None] * dirs[hit]
            cells = np.floor(X[:, axes] / PHOTO_CELL).astype(np.int64) + 97 * k
            rgb[hit] = table[cells[:, 0] % 512, cells[:, 1] % 512]
            depth[hit] = s[hit]  # the rays' z in the camera is 1: s is the depth
        name = f"{i:06d}.png"
        png.write_png(os.path.join(root, "image", name), (rgb * 255).astype(np.uint8))
        generate.save_depth_u16(depth, os.path.join(root, "groundtruth", name))
        keep = torch.rand(h, w, generator=gen).numpy() < PHOTO_DENSITY
        generate.save_depth_u16(np.where(keep, depth, 0.0), os.path.join(root, "sparse", name))
        poses.append((c2w.T, -c2w.T @ centre))
    np.savetxt(os.path.join(root, "K.txt"), K)
    return K, poses


def _relative_pose(poses, i):
    """(R, t) mapping camera i's points into camera i + 1's."""
    (R0, t0), (R1, t1) = poses[i], poses[i + 1]
    R = R1 @ R0.T
    return R, t1 - R @ t0


def _photo_pose_check(root, K, poses):
    """estimate_pose_pnp between consecutive full frames: success share,
    rotation and translation errors against the truth, host ms of the
    matching and of the rest (back-projection, RANSAC, refinement)."""
    read = lambda sub, i, scale: png.read_png(os.path.join(root, sub, f"{i:06d}.png")) / scale
    rows = []
    for i in range(PHOTO_FRAMES - 1):
        rgb, near = read("image", i, 255.0), read("image", i + 1, 255.0)
        sparse = read("sparse", i, 256.0).astype(np.float32)
        t0 = time.perf_counter()
        pts, pts_near = pose_lib.match_features(pose_lib.rgb_to_gray_u8(rgb),
                                                pose_lib.rgb_to_gray_u8(near))
        t1 = time.perf_counter()
        ok, R, t = pose_lib.pose_from_matches(pts, pts_near, sparse, K.astype(np.float32))
        t2 = time.perf_counter()
        R_true, t_true = _relative_pose(poses, i)
        row = {"pair": [i, i + 1], "matches": len(pts), "ok": bool(ok),
               "match_ms": 1e3 * (t1 - t0), "pnp_ms": 1e3 * (t2 - t1)}
        if ok:
            row["rotation_error_rad"] = float(np.linalg.norm(pose_lib.rodrigues_vector(
                R.astype(np.float64) @ R_true.T)))
            row["translation_error_m"] = float(np.linalg.norm(t - t_true))
        rows.append(row)
    good = [r for r in rows if r["ok"]]
    if not good:
        raise AssertionError(f"priors_photo: PnP failed on every pair: {rows}")
    return {"pairs": rows, "success_share": len(good) / len(rows),
            "median_rotation_error_rad": statistics.median(r["rotation_error_rad"] for r in good),
            "median_translation_error_m": statistics.median(r["translation_error_m"] for r in good),
            "true_translation_m": PHOTO_SPEED,
            "median_match_ms": statistics.median(r["match_ms"] for r in rows),
            "median_pnp_ms": statistics.median(r["pnp_ms"] for r in rows)}


def _photo_train(root, arch):
    """PRIOR_STEPS steps of the --photo loss at the prior CLIs' crop and
    batch: each step's host ms (crops, neighbours and their PnP poses) and
    its device ms (copy, forward, backward, Adam, synchronised), the
    photometric term after training, peak memory."""
    net = generate.build_completion_net(arch, torch.Generator().manual_seed(2)).cuda().train()
    ds = prior_datasets.CompletionDataset(root, crop=PRIOR_CROP, seed=0)
    ds.sample_batch(PRIOR_BATCH)  # the CLI's first draw
    loss_fn = train_prior.photo_completion_loss(net, PHOTO_SMOOTH, PHOTO_WEIGHT)
    optimizer = train_prior.make_optimizer(net, PRIOR_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host_ms, device_ms, losses, success = [], [], [], []
    for _ in range(PRIOR_STEPS):
        t0 = time.perf_counter()
        batch = ds.sample_batch_with_near(PRIOR_BATCH)
        t1 = time.perf_counter()
        losses.append(float(train_prior.train_step(optimizer, loss_fn,
                                                   train_prior.to_device(batch, "cuda"))))
        t2 = time.perf_counter()
        host_ms.append(1e3 * (t1 - t0))
        device_ms.append(1e3 * (t2 - t1))
        success.append(float(batch[6].mean()))
    rgb, sparse, _, near, R, t, ok, K = train_prior.to_device(batch, "cuda")
    with torch.no_grad():
        warped, valid = pose_lib.inverse_warp(near, net(rgb, sparse), R, t, K)
        photo = float(prior_completion.photometric_loss(warped, rgb,
                                                        valid & (ok[:, None, None] > 0)))
    if not all(math.isfinite(v) for v in losses) or not math.isfinite(photo) or photo <= 0:
        raise AssertionError(f"priors_photo {arch}: losses {losses}, photo term {photo}")
    step_ms = [a + b for a, b in zip(host_ms, device_ms)]
    return {"steps": PRIOR_STEPS, "batch": PRIOR_BATCH, "crop": list(PRIOR_CROP), "lr": PRIOR_LR,
            "photo_weight": PHOTO_WEIGHT, "median_step_ms": statistics.median(step_ms[1:]),
            "median_host_ms": statistics.median(host_ms[1:]),
            "median_device_ms": statistics.median(device_ms[1:]),
            "host_share": statistics.median(host_ms[1:]) / statistics.median(step_ms[1:]),
            "host_ms": host_ms, "device_ms": device_ms, "losses": losses,
            "photo_term_after": photo, "pnp_success_share": statistics.mean(success),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def _forward_timed(net, inputs):
    """Median ms of 5 synchronised forwards after one warm-up, and peak memory."""
    with torch.inference_mode():
        out = net(*inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            net(*inputs)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    out = out if isinstance(out, dict) else {"depth": out}
    return statistics.median(times), torch.cuda.max_memory_allocated(), out


def _bf16_prior_nets(gen):
    """The four prior nets at full width in bf16 beside the same weights in
    float32 (TF32 off): forward ms, peak memory, the largest output
    difference, and the kernels of one profiled bf16 forward."""
    (h, w) = PRIOR_FRAME
    left, right, _ = _stereo_pair(gen, h, w)
    rgb, sparse, _ = _driving_frame(gen, h, w)
    stereo_in = [generate._pad_to_multiple(a)[0][None] for a in (left, right)]
    completion_in = [generate._pad_to_multiple(a)[0][None] for a in (rgb, sparse)]
    nets = {f"stereo_{v}": (lambda dtype, v=v: stereo.StereoNet(
                variant=v, generator=torch.Generator().manual_seed(1), dtype=dtype), stereo_in)
            for v in ("cfnet", "pcwnet")}
    nets.update({f"completion_{a}": (lambda dtype, a=a: generate.build_completion_net(
                     a, torch.Generator().manual_seed(2), dtype=dtype), completion_in)
                 for a in ("guided", "resnet")})
    out = {}
    for name, (make, arrays) in nets.items():
        inputs = train_prior.to_device(arrays, "cuda")
        f32 = make(torch.float32).cuda().eval()
        bf16 = make(torch.bfloat16)
        bf16.load_state_dict(f32.state_dict())
        bf16.cuda().eval()
        f32_ms, f32_peak, want = _forward_timed(f32, inputs)
        del f32
        torch.cuda.empty_cache()
        bf16_ms, bf16_peak, got = _forward_timed(bf16, inputs)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.inference_mode(), torch.profiler.profile(activities=activities) as prof:
            bf16(*inputs)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in kernels)
        bf16_kernels = [e for e in kernels if "bf16" in e.key.lower()]
        conv = [e for e in kernels if _kind(e.key) == "convolution"]
        if not bf16_kernels:
            raise AssertionError(f"priors_photo {name}: no bf16 kernel in the bf16 forward: "
                                 f"{[e.key[:80] for e in kernels[:8]]}")
        diffs = {}
        for key, ref in want.items():
            diff = float((got[key].float() - ref).abs().max())
            if not math.isfinite(diff) or not torch.isfinite(got[key]).all():
                raise AssertionError(f"priors_photo {name} {key}: non-finite bf16 output")
            diffs[key] = {"max_abs": diff, "of_max": diff / max(float(ref.abs().max()), 1e-30)}
        top = sorted(conv or kernels, key=lambda e: -e.self_device_time_total)[:4]
        by_kind = {}
        for e in kernels:
            low = e.key.lower()
            kind = ("layout" if "nchwtonhwc" in low or "nhwctonchw" in low else
                    "group_norm" if "group_norm" in low or "groupnorm" in low else _kind(e.key))
            by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
        out[name] = {"f32_forward_ms": f32_ms, "bf16_forward_ms": bf16_ms,
                     "bf16_device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
                     "speedup": f32_ms / bf16_ms, "f32_peak_bytes": f32_peak,
                     "bf16_peak_bytes": bf16_peak, "bf16_vs_f32": diffs,
                     "profiled_device_ms": total / 1e3,
                     "bf16_kernel_share_of_device_time":
                         sum(e.self_device_time_total for e in bf16_kernels) / total,
                     "top_convolution_kernels": [
                         {"name": e.key[:120], "ms": e.self_device_time_total / 1e3}
                         for e in top]}
        del bf16
        torch.cuda.empty_cache()
        emit({"phase": "priors_photo_progress", "net": name, "f32_ms": f32_ms,
              "bf16_ms": bf16_ms})
    return out


def _splitmix_pixels(seed, n, n_images, height, width):
    """The dataplane's draws on one thread: (img, py, px) of each ray."""
    mask = 2**64 - 1
    state = (seed + 0x9E3779B97F4A7C15) & mask
    out = []
    for _ in range(n):
        state = (state + 0x9E3779B97F4A7C15) & mask
        z = ((state ^ (state >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        r = z ^ (z >> 31)
        out.append((r % n_images, (r >> 42) % height, (r >> 20) % width))
    return np.array(out)


def _batcher_rates(scene):
    """Batches a second of the C++ dataplane (at the machine's thread count)
    and of the numpy sampler (pixels, cast later on the card) on the KITTI
    fixture; one single-threaded batch checked against the draws and the
    port's pinhole cast on the CPU."""
    out = {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
           "num_threads": "0 (hardware concurrency)", "calls": BATCHER_CALLS}
    for n in BATCHER_RAYS:
        dataset = datasets_lib.DrivingSceneDataset(scene, "train", n)
        rates = {}
        for label, fn in (("native", native_batcher.NativeRayBatcher(dataset).sample_batch),
                          ("numpy", dataset.sample_batch)):
            for _ in range(3):
                fn()
            t0 = time.perf_counter()
            for _ in range(BATCHER_CALLS):
                fn()
            rates[label] = BATCHER_CALLS / (time.perf_counter() - t0)
        out[str(n)] = {"native_batches_per_s": rates["native"],
                       "numpy_batches_per_s": rates["numpy"],
                       "native_rays_per_s": n * rates["native"],
                       "native_over_numpy": rates["native"] / rates["numpy"]}
    dataset = datasets_lib.DrivingSceneDataset(scene, "train", BATCHER_RAYS[0])
    batch = native_batcher.NativeRayBatcher(dataset, seed=5, num_threads=1).sample_batch()
    call_seed = ((5 + 1) * 6364136223846793005 + 1442695040888963407) % 2**64
    img, py, px = _splitmix_pixels(call_seed, BATCHER_RAYS[0], dataset.n_images,
                                   dataset.height, dataset.width).T
    rays = cameras_lib.pixels_to_rays(
        torch.from_numpy(px.astype(np.float32)), torch.from_numpy(py.astype(np.float32)),
        torch.from_numpy(dataset.pixtocams.astype(np.float32)),
        torch.from_numpy(dataset.camtoworlds[img].astype(np.float32)))
    err = float((batch.rays.directions - rays[1]).abs().max())
    scale = float(rays[1].abs().max())
    if not np.array_equal(batch.rgb.numpy(), dataset.images[img, py, px]) or \
            not np.array_equal(batch.rays.cam_idx[:, 0].numpy(), img) or \
            err > BATCHER_CAST_RTOL_OF_MAX * scale:
        raise AssertionError(f"priors_photo: the dataplane's batch is off the CPU cast ({err})")
    out["check_num_threads_1"] = {"directions_max_abs_err": err,
                                  "tolerance": BATCHER_CAST_RTOL_OF_MAX * scale,
                                  "rgb_and_cam_idx": "equal"}
    return out


def phase_priors_photo(root):
    """Photometric self-supervision at full width (PnP on the KITTI-sized
    textured sequence, --photo training of both completion nets), the four
    prior nets in bf16 beside float32, and the C++ dataplane's rate. No
    kernel of the port may launch in any of it."""
    gen = torch.Generator().manual_seed(4)
    out = {"phase": "priors_photo", "frame": f"{PRIOR_FRAME[0]}x{PRIOR_FRAME[1]}"}
    _reset_launches()
    seq = os.path.join(root, "photo_sequence")
    t0 = time.perf_counter()
    K, poses = _street_sequence(seq, gen)
    out["sequence"] = {"frames": PHOTO_FRAMES, "seconds": time.perf_counter() - t0,
                       "focal": PHOTO_FOCAL, "metres_per_frame": PHOTO_SPEED,
                       "yaw_rad_per_frame": PHOTO_YAW, "sparse_density": PHOTO_DENSITY}
    out["pose"] = _photo_pose_check(seq, K, poses)
    emit({"phase": "priors_photo_progress", "pose": {k: v for k, v in out["pose"].items()
                                                     if k != "pairs"}})
    for arch in PHOTO_ARCHS:
        out[f"train_{arch}"] = _photo_train(seq, arch)
        emit({"phase": "priors_photo_progress", "arch": arch,
              **{k: out[f"train_{arch}"][k] for k in ("median_step_ms", "median_host_ms",
                                                      "median_device_ms", "photo_term_after")}})
    _, printed = _quiet(train_prior.main, ["complete", "--data", seq, "--photo", "--steps",
                                           str(PHOTO_CLI_STEPS), "--batch", str(PRIOR_BATCH),
                                           "--print-every", "1", "--lr", str(PRIOR_LR)])
    if f"step {PHOTO_CLI_STEPS}: loss" not in printed or "nan" in printed:
        raise AssertionError(f"priors_photo: train_prior --photo printed {printed!r}")
    out["cli"] = {"steps": PHOTO_CLI_STEPS, "printed": printed.splitlines()}
    out["bf16"] = _bf16_prior_nets(gen)
    out["batcher"] = _batcher_rates(os.path.join(root, "dtu_format"))
    launches = {"priors_photo": _launches()}
    if launches["priors_photo"] != _only():
        raise AssertionError(f"a kernel launched in phase priors_photo: {launches}")
    out["launches"] = launches
    torch.cuda.empty_cache()
    emit(out)
    return launches


@contextlib.contextmanager
def _recording_renders():
    """Collect every `render_image` output the loop and the tools make."""
    outs, render_image = [], step_lib.render_image

    def record(*args, **kwargs):
        outs.append(render_image(*args, **kwargs))
        return outs[-1]

    step_lib.render_image = record
    try:
        yield outs
    finally:
        step_lib.render_image = render_image


def _quiet(fn, *args):
    """fn(*args) with its prints kept off this script's output; returns
    (result, printed text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def _path_run(config_path, kind, frames, per_frame, label, extra=()):
    """tools.render on a checkpoint: frames written and decoded, launches per frame."""
    _reset_launches()
    result, _ = _quiet(render_tool.main, ["--config", config_path, f"path={kind}",
                                          f"n_frames={frames}", *extra])
    launches = _launches()
    n = len(result["frames"])
    if n != frames or launches != {k: v * n for k, v in per_frame.items()}:
        raise AssertionError(f"{label}: {n} frames, launches {launches}, expected "
                             f"{frames} x {per_frame}")
    for path in result["frames"]:
        frame = png.read_png(path)
        if frame.shape != (result["height"], 2 * result["width"] + 2, 3):
            raise AssertionError(f"{label}: frame {path} has shape {frame.shape}")
    return {"frames": n, "height": result["height"], "width": result["width"],
            "frame_ms": result["frame_ms"], "median_frame_ms": statistics.median(result["frame_ms"]),
            "launches_per_frame": {k: v // n for k, v in launches.items() if v},
            "video": result["video"]}, launches


def phase_eval_render(root, kitti_mip_eval):
    """The eval and render tools on phase kitti's checkpoints: tools.eval
    restores the mip run and matches its in-train eval, its saved renders
    decode to the rendered arrays, tools.render draws every path (and NGP
    an ellipse), one frame is held against the CPU, and the offline
    evaluator scores the saved renders against the fixture's images."""
    mip_config_path = os.path.join(root, "mip", "config.json")
    config = load_config(mip_config_path)
    test = build_dataset(config, "test")
    scale = float(test.scene_scale)
    chunks = math.ceil(HEIGHT * WIDTH / config.render_chunk_size)
    out = {"phase": "eval_render", "checkpoint": f"phase kitti mip, step {KITTI_MIP_RESUMED_STEPS}"}

    _reset_launches()
    t0 = time.perf_counter()
    with _recording_renders() as renders:
        (mean, per_image), printed = _quiet(eval_tool.main, ["--config", mip_config_path])
    eval_seconds = time.perf_counter() - t0
    launches = {"eval_render": _launches()}
    if launches["eval_render"] != _only(K1a=3 * chunks * KITTI_TEST_VIEWS):
        raise AssertionError(f"tools.eval launches {launches['eval_render']}")
    if f"restored step {KITTI_MIP_RESUMED_STEPS}" not in printed.splitlines():
        raise AssertionError(f"tools.eval restored no step {KITTI_MIP_RESUMED_STEPS}: {printed[:200]}")
    diffs = [abs(got[k] - want[k]) for got, want in zip(per_image, kitti_mip_eval) for k in EVAL_KEYS]
    if len(per_image) != len(kitti_mip_eval) or max(diffs) > EVAL_TOL:
        raise AssertionError(f"tools.eval {per_image} differs from the in-train eval {kitti_mip_eval}")
    render_dir = os.path.join(root, "mip", "renders")
    for i, r in enumerate(renders):
        color = png.read_png(os.path.join(render_dir, f"color_{i:03d}.png"))
        depth = png.read_png(os.path.join(render_dir, f"depth_{i:03d}.png"))
        codes = np.clip(np.nan_to_num(r["distance_mean"] / scale) * 256.0, 0, 65535).astype(np.uint16)
        if not (np.array_equal(color, image_lib.to_u8(r["rgb"])) and np.array_equal(depth, codes)):
            raise AssertionError(f"renders/color_{i:03d}.png or depth_{i:03d}.png differs from the render")
        summary = png.read_png(os.path.join(render_dir, f"summary_{i:03d}.png"))
        if summary.shape != (HEIGHT, 4 * WIDTH + 6, 3):
            raise AssertionError(f"summary_{i:03d}.png has shape {summary.shape}")
    out["eval"] = {"seconds": eval_seconds, "views": len(per_image), "launches": launches["eval_render"],
                   "max_abs_diff_to_in_train_eval": max(diffs), "tolerance": EVAL_TOL,
                   **{k: mean[k] for k in EVAL_KEYS}}

    # The offline evaluator against the fixture's image folder, and the same
    # metrics computed here on the quantized renders.
    images = os.path.join(root, "dtu_format", "images")
    (offline, offline_mean), _ = _quiet(eval_tool.main, ["--offline", images, render_dir,
                                                         os.path.join(root, "offline.txt")])
    files = sorted(os.listdir(images))
    suite = metrics_lib.MetricSuite()
    offline_diff = 0.0
    for i, (idx, r) in enumerate(zip(datasets_lib.split_indices(len(files), "test"), renders)):
        gt = datasets_lib.load_image(os.path.join(images, files[idx])) / 255.0
        want = suite(image_lib.to_u8(r["rgb"]) / 255.0, gt)
        offline_diff = max([offline_diff] + [abs(offline[i][k] - want[k]) for k in ("psnr", "ssim")])
    if len(offline) != KITTI_TEST_VIEWS or offline_diff > EVAL_TOL:
        raise AssertionError(f"offline eval {offline} differs by {offline_diff}")
    out["offline"] = {"views": len(offline), "max_abs_diff_in_process": offline_diff,
                      "psnr": offline_mean["psnr"], "ssim": offline_mean["ssim"]}

    # Camera paths at the fixture's 94x310 (and one at 188 rows), NGP's too;
    # their launches count with tools.eval's.
    ngp_config_path = os.path.join(root, "ngp", "config.json")
    ngp_chunks = math.ceil(HEIGHT * WIDTH / load_config(ngp_config_path).render_chunk_size)
    tall_width = round(WIDTH * TALL_HEIGHT / HEIGHT)
    tall_chunks = math.ceil(TALL_HEIGHT * tall_width / config.render_chunk_size)
    runs = [(kind, mip_config_path, kind, PATH_FRAMES, _only(K1a=3 * chunks), ())
            for kind in render_tool.PATHS]
    runs += [(f"ellipse_{TALL_HEIGHT}_rows", mip_config_path, "ellipse", TALL_FRAMES,
              _only(K1a=3 * tall_chunks), (f"render_height={TALL_HEIGHT}",)),
             ("ngp_ellipse", ngp_config_path, "ellipse", NGP_PATH_FRAMES, _only(K1a=ngp_chunks), ())]
    out["paths"] = {}
    for label, config_path, kind, frames, per_frame, extra in runs:
        out["paths"][label], counts = _path_run(config_path, kind, frames, per_frame, label, extra)
        launches["eval_render"] = {k: launches["eval_render"][k] + counts[k] for k in KERNEL_IDS}

    # One frame of the ellipse path held against the CPU.
    model, _ = step_lib.load_checkpoint(config)
    pose = render_tool.camera_path(build_dataset(config, "train"), "ellipse", PATH_FRAMES)[0]
    batch = render_tool.frame_batch(pose, test.pixtocams, HEIGHT, WIDTH, test.near, test.far)
    check = _render_check(config, model.to("cuda"), mlp_forward_flops, lambda c: _only(K1a=3 * c),
                          "eval_render_frame", 1e-3, batch=batch)
    out["frame_cpu_reference"] = check["cpu_reference"]
    out["launches"] = launches["eval_render"]
    emit(out)
    del model
    torch.cuda.empty_cache()
    return launches


def lpips_flops(h, w):
    """Multiply-adds x 2 of the 13 VGG16 convolutions on one image."""
    flops, cin = 0, 3
    for _, cout, pool_before in lpips_lib.VGG16_CONVS:
        if pool_before:
            h, w = h // 2, w // 2
        flops += 2 * 9 * cin * cout * h * w
        cin = cout
    return flops


def phase_lpips():
    """The LPIPS machinery (VGG16, cuDNN f32) with random weights: distances
    on the card against the CPU, time and peak memory per image pair, and
    the metric path refusing the unstamped file. No LPIPS value is reported
    as a metric: random weights measure nothing perceptual."""
    gen = torch.Generator().manual_seed(11)
    out = {"phase": "lpips", "weights": "random_weights(default_rng(0)), unstamped; not a metric",
           "sizes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "random.npz")
        lpips_lib.save_weights(path, lpips_lib.random_weights(np.random.default_rng(0)))
        try:
            metrics_lib.MetricSuite(compute_lpips=True, lpips_weights=path, device="cuda")
        except ValueError as e:
            out["metric_path_refuses_unstamped"] = str(e)[-120:]
        else:
            raise AssertionError("MetricSuite(compute_lpips=True) accepted unstamped weights")
        weights = lpips_lib.load_weights(path, require_export_provenance=False)
        gpu_fn = lpips_lib.make_lpips_fn(path, require_export_provenance=False, device="cuda")
        cpu_fn = lpips_lib.make_lpips_fn(path, require_export_provenance=False, device="cpu")
    dev_weights = lpips_lib.to_torch(weights, "cuda")
    _reset_launches()
    for h, w in LPIPS_SIZES:
        pred = _smooth_image(gen, h, w)
        target = np.clip(pred + 0.05 * torch.randn(pred.shape, generator=gen).numpy(), 0, 1)
        got, want = gpu_fn(pred, target), cpu_fn(pred, target)
        rel = abs(got - want) / abs(want)
        if not (math.isfinite(got) and got > 0 and rel <= LPIPS_RTOL):
            raise AssertionError(f"LPIPS at {h}x{w}: card {got} against CPU {want}")
        p, t = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (pred, target))
        with torch.inference_mode():
            lpips_lib.lpips_distance(dev_weights, p, t)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            times = []
            for _ in range(5):
                start.record()
                lpips_lib.lpips_distance(dev_weights, p, t)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        flop = 2 * lpips_flops(h, w)
        out["sizes"][f"{h}x{w}"] = {
            "card_vs_cpu_rel": rel, "tolerance_rel": LPIPS_RTOL, "ms_per_pair": ms,
            "ms_per_pair_all": times, "gflop_per_pair": flop / 1e9,
            "tflop_per_s": flop / 1e12 / (ms / 1e3),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    launches = {"lpips": _launches()}
    if launches["lpips"] != _only():
        raise AssertionError(f"a kernel of the port launched in LPIPS: {launches['lpips']}")
    emit(out)
    del dev_weights
    torch.cuda.empty_cache()
    return launches


def _gate_launches(name, config, model_levels, test_views):
    """Launches of one gate's train and eval: mip 3 K1a + 3 K1b a step and 3
    K1a a render chunk; NGP 1 + 1 a step, 16 K2a (one a hash level), 1 K1a a
    chunk; NeRF++ none."""
    steps = config.max_steps
    chunks = test_views * math.ceil(64 * 96 / config.render_chunk_size)
    if name == "mipnerf360":
        return _only(K1a=model_levels * (steps + chunks), K1b=model_levels * steps)
    if name == "ngp":
        return _only(K1a=steps + chunks, K1b=steps, K2a=model_levels * steps)
    return _only()


def phase_gate():
    """tools.quality_gate on the analytic sphere scene: NGP at its full 600
    steps with its thresholds asserted, mip and NeRF++ at a tenth of their
    budgets with their metrics reported; launches per gate."""
    out = {"phase": "gate", "runs": []}
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        for name, scale, asserted in GATE_RUNS:
            config = quality_gate.gate_config(name, root, scale)
            # The mip gate's 3 levels; NGP's 16 hash levels (the field's default).
            levels = config.model_params["num_levels"] if name == "mipnerf360" else NGP_LEVELS
            _reset_launches()
            result, _ = _quiet(quality_gate.run_gate, name, root, scale, "cuda")
            launches[f"gate_{name}"] = _launches()
            want = _gate_launches(name, config, levels, 2)
            if launches[f"gate_{name}"] != want:
                raise AssertionError(f"gate {name}: launches {launches[f'gate_{name}']}, expected {want}")
            m = result["metrics"]
            if not all(math.isfinite(m[k]) for k in ("psnr", "ssim", "rmse")):
                raise AssertionError(f"gate {name}: {m}")
            if asserted and not result["passed"]:
                raise AssertionError(f"gate {name} fails its thresholds {result['thresholds']}: {m}")
            out["runs"].append(dict(result, steps_scale=scale, thresholds_asserted=asserted,
                                    launches=launches[f"gate_{name}"]))
            torch.cuda.empty_cache()
    emit(out)
    return launches


def phase_blender():
    """configs/blender_ngp.json at full width on a Synthetic-NeRF-shaped
    layout: write, load, train past the occupancy warmup, evaluate the test
    views; launches per step and per render chunk asserted."""
    with tempfile.TemporaryDirectory() as root:
        scene = os.path.join(root, "blender")
        t0 = time.perf_counter()
        _quiet(make_blender_fixture.main, scene, BLENDER_TRAIN, BLENDER_TEST, BLENDER_SIZE)
        write_seconds = time.perf_counter() - t0
        config = load_config(BLENDER_CONFIG, [f"scene_dir={scene}", "print_every=1",
                                              f"exp_dir={os.path.join(root, 'exp')}"])
        mp, fp = config.model_params, config.model_params["field_params"]
        expected = (config.dataset, mp["scale"], mp["max_samples"], mp["n_candidates"],
                    mp.get("sample_budget", 0), tuple(mp["bg_intensity_range"]), fp["n_levels"],
                    fp["n_features"], fp["log2_table_size"], fp["hidden_width"],
                    config.batch_size, config.occupancy_warmup_steps, config.opacity_loss_mult)
        if expected != ("blender", 0.5, 128, 512, 0, (1.0, 1.0), NGP_LEVELS, 2, 19, 64, 8192,
                        256, 1e-3):
            raise AssertionError(f"{BLENDER_CONFIG} is no longer the full-width NGP shape: "
                                 f"{expected}")
        t0 = time.perf_counter()
        dataset = build_dataset(config, "train")
        load_seconds = time.perf_counter() - t0
        if (dataset.n_images, dataset.height, dataset.width) != (
                BLENDER_TRAIN, BLENDER_SIZE, BLENDER_SIZE):
            raise AssertionError(f"loaded {dataset.n_images} views of "
                                 f"{dataset.height}x{dataset.width}")
        scan_shapes = set()
        model, history, launches, seconds, peak = _train_phase(config, dataset, scan_shapes,
                                                               max_steps=BLENDER_STEPS)
        if launches != _ngp_launches(BLENDER_STEPS):
            raise AssertionError(f"blender: launches {launches}, expected "
                                 f"{_ngp_launches(BLENDER_STEPS)}")
        # No sample budget: K2a scans every slot of the batch, a shape the
        # kernel is held at in phase kernels.
        scan_path = (ngp_points(model, config.batch_size), SCAN_PATH[1])
        if scan_shapes != {scan_path} or scan_path not in SCAN_SHAPES:
            raise AssertionError(f"blender: K2a ran at {scan_shapes}, expected only {scan_path}")
        _check_history(history, BLENDER_STEPS)
        step_ms = [1e3 * config.batch_size / e["rays_per_sec"] for e in history]
        refresh = set(range(0, BLENDER_STEPS, config.occupancy_update_every))
        plain = [ms for i, ms in enumerate(step_ms) if i > 0 and i not in refresh]
        warm = [ms for i, ms in enumerate(step_ms)
                if i >= config.occupancy_warmup_steps and i not in refresh]
        steady = statistics.median(plain)
        del dataset
        _reset_launches()
        t0 = time.perf_counter()
        mean, per_image = evaluate(config, model, device="cuda", log_fn=lambda line: None)
        eval_seconds = time.perf_counter() - t0
        chunks = BLENDER_TEST * math.ceil(BLENDER_SIZE**2 / config.render_chunk_size)
        eval_launches = _launches()
        if eval_launches != _only(K1a=chunks):
            raise AssertionError(f"blender eval: launches {eval_launches}, expected {chunks} K1a")
        if len(per_image) != BLENDER_TEST or not all(
                math.isfinite(mean[k]) for k in ("psnr", "ssim")):
            raise AssertionError(f"blender eval: {len(per_image)} views, {mean}")
        emit({"phase": "blender", "config": BLENDER_CONFIG,
              "scene": f"Synthetic-NeRF layout, {BLENDER_TRAIN} train and {BLENDER_TEST} test "
                       f"views of {BLENDER_SIZE}x{BLENDER_SIZE} RGBA, 8 analytic spheres",
              "cuts": "none of views or resolution; 300 of the config's 30,000 steps (its LR "
                      "schedule kept), past occupancy_warmup_steps 256",
              "write_seconds": write_seconds, "load_seconds": load_seconds,
              "steps": BLENDER_STEPS, "train_seconds": seconds, "batch": config.batch_size,
              "field_points_per_step": ngp_points(model, config.batch_size),
              "step_ms": step_ms, "median_step_ms_without_refresh": steady,
              "median_step_ms_after_warmup": statistics.median(warm),
              "rays_per_sec": 1e3 * config.batch_size / steady,
              "rm_s": history[-1]["rm_s"], "vr_s": history[-1]["vr_s"],
              "train_psnr_last": history[-1]["psnr"],
              "occupied_share": _occupied_share(model),
              "max_memory_allocated_bytes": peak, "launches": launches,
              "k2a_shapes": sorted(scan_shapes),
              "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")},
              "eval": {"views": len(per_image), "seconds": eval_seconds,
                       "launches": eval_launches, "psnr": mean["psnr"], "ssim": mean["ssim"],
                       "per_image_psnr": [m["psnr"] for m in per_image]},
              "verdict": "none: no reference number exists for this scene"})
    del model
    torch.cuda.empty_cache()
    return {"blender": launches, "blender_eval": eval_launches}


def phase_cameras(root):
    """Copies of the kitti fixture whose COLMAP camera is rewritten with a
    lens (OPENCV, OPENCV_FISHEYE): the card's cast of a batch against the
    CPU's, then the mip flagship at full width for a few steps, casting its
    pixels on the card; 3 K1a and 3 K1b a step."""
    out = {"phase": "cameras", "models": {}}
    launches = {}
    for model_name in LENS_MODELS:
        scene = os.path.join(root, f"lens_{model_name.lower()}")
        shutil.copytree(os.path.join(root, "dtu_format"), scene)
        make_kitti_fixture.rewrite_camera(scene, model_name)
        # The C++ dataplane casts pinhole rays (fault 4, as in the reference):
        # this phase measures the lensed cast in the step, so it samples pixels.
        config = load_config(CONFIG, [f"scene_dir={scene}", f"max_steps={LENS_STEPS}",
                                      "print_every=1", f"exp_dir={scene}_exp",
                                      "use_native_batcher=false"])
        dataset = build_dataset(config, "train")
        if native_batcher.applies(config, dataset):
            raise AssertionError(f"{model_name}: the lensed runs must not use the dataplane")
        if dataset.distortion is None or (dataset.camtype == "fisheye") != (
                model_name == "OPENCV_FISHEYE") or not config.cast_rays_in_train_step:
            raise AssertionError(f"{model_name}: {dataset.distortion}, {dataset.camtype}")
        pixels = dataset.sample_batch().rays
        if not isinstance(pixels, rays_lib.Pixels):
            raise AssertionError(f"{model_name}: train batches should hold pixels")
        card = cameras_lib.cast_pixels(rays_lib.map_fields(lambda x: x.cuda(), pixels),
                                       dataset.cameras_on("cuda"), dataset.camtype)
        host = cameras_lib.cast_pixels(pixels, dataset.cameras_on("cpu"), dataset.camtype)
        errors = {}
        for name in ("origins", "directions", "viewdirs", "radii", "imageplane"):
            got, want = getattr(card, name).cpu(), getattr(host, name)
            if not torch.isfinite(got).all():
                raise AssertionError(f"{model_name}: non-finite {name} cast on the card")
            errors[name] = float((got - want).abs().max())
            # Radii are distances between neighbouring directions: their scale.
            scale = float(host.directions.abs().max() if name == "radii" else want.abs().max())
            if errors[name] > LENS_CAST_RTOL_OF_MAX * scale:
                raise AssertionError(f"{model_name}: {name} cast on the card off the CPU's "
                                     f"by {errors[name]} (scale {scale})")
        plain = cameras_lib.cast_pixels(pixels, (*dataset.cameras_on("cpu")[:2], None))
        lens_shift = float((plain.directions - host.directions).abs().max())
        model, history, run_launches, seconds, _ = _train_phase(config, dataset,
                                                                max_steps=LENS_STEPS)
        if run_launches != _only(K1a=3 * LENS_STEPS, K1b=3 * LENS_STEPS):
            raise AssertionError(f"{model_name}: launches {run_launches}")
        _check_history(history, LENS_STEPS)
        launches[f"cameras_{model_name.lower()}"] = run_launches
        out["models"][model_name] = {
            "distortion": {k: float(v) for k, v in dataset.distortion.items()},
            "camtype": dataset.camtype, "cast_max_abs_err_card_vs_cpu": errors,
            "cast_tolerance": f"{LENS_CAST_RTOL_OF_MAX} of the largest component",
            "lens_shift_of_directions": lens_shift, "steps": LENS_STEPS, "seconds": seconds,
            "step_ms": [1e3 * config.batch_size / e["rays_per_sec"] for e in history],
            "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")},
            "launches": run_launches}
        del model, dataset
        torch.cuda.empty_cache()
    emit(out)
    return launches


def phase_depth_losses(root):
    """mip, NGP and NeRF++ at full width on the kitti fixture under the mse,
    urf and nll depth losses: finite losses, K1 and K2a launches per step,
    and each loss's median step ms beside mse's."""
    out = {"phase": "depth_losses", "runs": {}}
    launches = {}
    for backend, config_path, steps in DEPTH_LOSS_RUNS:
        scene = os.path.join(root, "nerfpp" if backend == "nerfpp" else "dtu_format")
        for kind in DEPTH_LOSS_KINDS:
            exp = os.path.join(root, f"loss_{backend}_{kind}")
            config = load_config(config_path, [f"scene_dir={scene}", f"exp_dir={exp}",
                                               f"max_steps={steps}", "print_every=1",
                                               f"depth_loss_type={kind}"])
            if config.lambda_depth <= 0:
                raise AssertionError(f"{config_path}: no depth supervision")
            model, history, run_launches, seconds, _ = _train_phase(config)
            want = {"mip": _only(K1a=3 * steps, K1b=3 * steps), "ngp": _ngp_launches(steps),
                    "nerfpp": _only()}[backend]
            if run_launches != want:
                raise AssertionError(f"{backend} {kind}: launches {run_launches}, expected {want}")
            _check_history(history, steps)
            if not all(math.isfinite(e["loss_depth"]) for e in history):
                raise AssertionError(f"{backend} {kind}: non-finite depth loss")
            step_ms, steady = _steady_ms(config, history)
            launches[f"depth_losses_{backend}_{kind}"] = run_launches
            out["runs"][f"{backend}_{kind}"] = {
                "config": config_path, "steps": steps, "seconds": seconds,
                "depth_sigma": config.depth_sigma, "lambda_depth": config.lambda_depth,
                "step_ms": step_ms, "median_step_ms_after_first": steady,
                "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")},
                "launches": run_launches}
            del model
            torch.cuda.empty_cache()
        base = out["runs"][f"{backend}_mse"]["median_step_ms_after_first"]
        for kind in DEPTH_LOSS_KINDS[1:]:
            run = out["runs"][f"{backend}_{kind}"]
            run["step_ms_over_mse"] = run["median_step_ms_after_first"] / base
    emit(out)
    return launches


def _layout_config(root, scene, label, model=None, field=None):
    """configs/kitti_ngp.json on the fixture for NGP_STEPS steps, with
    `model` and `field` merged into its model_params and field_params."""
    config = load_config(NGP_CONFIG, [f"scene_dir={scene}", f"max_steps={NGP_STEPS}",
                                      "print_every=1", f"exp_dir={os.path.join(root, label)}"])
    mp = copy.deepcopy(config.model_params)
    mp.update(model or {})
    mp["field_params"].update(field or {})
    return config.replace(model_params=mp)


def _without_refresh_ms(config, history):
    """Host-clock ms of each logged step, and their median over the steps
    without an occupancy refresh (and after the first)."""
    step_ms = [1e3 * config.batch_size / e["rays_per_sec"] for e in history]
    refresh = set(range(0, len(step_ms), config.occupancy_update_every))
    return step_ms, statistics.median(
        [ms for i, ms in enumerate(step_ms) if i > 0 and i not in refresh])


def _encoding_against_cpu(encoder):
    """The trained encoder on the card against its copy on the CPU taking
    autograd's scatter gradient, on LAYOUT_CHECK_POINTS points: forward and
    table gradient, each relative to its largest entry."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((LAYOUT_CHECK_POINTS, 3), generator=gen, device="cuda")
    g = torch.randn((LAYOUT_CHECK_POINTS, encoder.out_dim), generator=gen, device="cuda")
    card = copy.deepcopy(encoder)
    card.table.grad = None
    out = card(x)
    (out * g).sum().backward()
    cpu = copy.deepcopy(encoder).cpu()
    cpu.sorted_grad, cpu.table.grad = False, None
    out_cpu = cpu(x.cpu())
    (out_cpu * g.cpu()).sum().backward()
    err = {"fwd_max_abs_err": float((out.detach().cpu() - out_cpu.detach()).abs().max()),
           "fwd_max_abs": float(out_cpu.detach().abs().max()),
           "grad_max_abs_err": float((card.table.grad.cpu() - cpu.table.grad).abs().max()),
           "grad_max_abs": float(cpu.table.grad.abs().max())}
    if not (torch.isfinite(out).all() and torch.isfinite(card.table.grad).all()) or \
            err["fwd_max_abs_err"] > LAYOUT_FWD_RTOL * err["fwd_max_abs"] or \
            err["grad_max_abs_err"] > LAYOUT_GRAD_RTOL * err["grad_max_abs"] or \
            err["grad_max_abs"] == 0.0:
        raise AssertionError(f"{encoder.layout} encoding on the card against the CPU: {err}")
    return err


def _cull(config, grid):
    """mark_invisible_cells on the train cameras of the fixture, on the card
    (timed) and on the CPU: culled cells per cascade and border flips."""
    dataset = build_dataset(config, "train")
    c2w = torch.from_numpy(dataset.camtoworlds)
    k = torch.from_numpy(np.linalg.inv(dataset.pixtocams).astype(np.float32))
    args = (dataset.width, dataset.height, config.model_params["scale"])
    card_in = (grid.cuda(), c2w.cuda(), k.cuda())
    occ_lib.mark_invisible_cells(*card_in, *args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = occ_lib.mark_invisible_cells(*card_in, *args)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    cpu = occ_lib.mark_invisible_cells(grid.cpu(), c2w, k, *args)
    card_culled, cpu_culled = card.cpu() == -1.0, cpu == -1.0
    flips = int((card_culled != cpu_culled).sum())
    if flips > CULL_FLIP_SHARE * grid.numel() or not card_culled.any() or card_culled.all():
        raise AssertionError(f"cull: {flips} cells flip between the card and the CPU, "
                             f"{int(card_culled.sum())} culled of {grid.numel()}")
    return {"cameras": int(c2w.shape[0]), "image": [dataset.height, dataset.width],
            "cells_per_cascade": int(grid.shape[1]), "ms": ms,
            "culled_per_cascade": card_culled.sum(dim=1).tolist(),
            "culled_per_cascade_cpu": cpu_culled.sum(dim=1).tolist(),
            "cells_flipping_card_vs_cpu": flips}


def _layout_gate(root, layout):
    """The NGP quality gate with its model_params naming `layout`, through
    tools.quality_gate's gate function on a copy of its NGP gate."""
    gates = quality_gate.GATES
    gate = copy.deepcopy(gates["ngp"])
    gate["config"]["model_params"]["hash_layout"] = layout
    quality_gate.GATES = dict(gates, ngp=gate)
    exp_root = os.path.join(root, f"gate_{layout}")
    try:
        config = quality_gate.gate_config("ngp", exp_root)
        _reset_launches()
        shapes = set()
        with _record_scan_shapes(shapes):
            result, _ = _quiet(quality_gate.run_gate, "ngp", exp_root, 1.0, "cuda")
    finally:
        quality_gate.GATES = gates
    launches = _launches()
    want = _gate_launches("ngp", config, 1 if layout == "oct" else 0, 2)
    want_shapes = {OCT_SCAN_PATH} if layout == "oct" else set()
    if launches != want or shapes != want_shapes:
        raise AssertionError(f"gate {layout}: launches {launches} at {shapes}, expected {want}")
    if not result["passed"]:
        raise AssertionError(f"gate {layout} fails {result['thresholds']}: {result['metrics']}")
    return dict(result, hash_layout=layout, launches=launches, k2a_shapes=sorted(shapes)), launches


def phase_ngp_layouts(root):
    """The rest of NGP at full width: configs/kitti_ngp.json on the kitti
    fixture under the oct (sorted and scatter), quad and corner layouts, each
    encoding against the CPU; the HDR field with extrinsics refinement on
    osplit; the visibility cull; the NGP gate under corner and oct; the
    layout probe at full size. Launches per run asserted."""
    scene = os.path.join(root, "dtu_format")
    chunks = KITTI_TEST_VIEWS * math.ceil(HEIGHT * WIDTH / 16384)
    out = {"phase": "ngp_layouts", "runs": {}}
    launches = {}
    for layout, grad_mode in LAYOUT_RUNS:
        label = layout if grad_mode == "auto" else f"{layout}_{grad_mode}"
        config = _layout_config(root, scene, f"layout_{label}", {"hash_layout": layout},
                                {"grad_mode": grad_mode})
        shapes = set()
        model, history, run_launches, seconds, peak = _train_phase(config, scan_shapes=shapes)
        oct_sorted = layout == "oct" and grad_mode != "scatter"
        want = _only(K1a=NGP_STEPS, K1b=NGP_STEPS, K2a=NGP_STEPS if oct_sorted else 0)
        if run_launches != want or shapes != ({OCT_SCAN_PATH} if oct_sorted else set()):
            raise AssertionError(f"{label}: launches {run_launches} at {shapes}, expected {want}")
        if model.field.encoder.layout != layout:
            raise AssertionError(f"{label}: the model hashes as {model.field.encoder.layout}")
        _check_history(history, NGP_STEPS)
        step_ms, steady = _without_refresh_ms(config, history)
        check = _encoding_against_cpu(model.field.encoder)
        _reset_launches()
        mean, per_image = evaluate(config, model, device="cuda", log_fn=lambda line: None)
        if _launches() != _only(K1a=chunks) or len(per_image) != KITTI_TEST_VIEWS or \
                not all(math.isfinite(mean[k]) for k in ("psnr", "rmse")):
            raise AssertionError(f"{label} eval: {_launches()}, {mean}")
        launches[f"ngp_layouts_{label}"] = run_launches
        out["runs"][label] = {
            "hash_layout": layout, "grad_mode": grad_mode, "steps": NGP_STEPS,
            "seconds": seconds, "step_ms": step_ms, "median_step_ms_without_refresh": steady,
            "rays_per_sec": 1e3 * config.batch_size / steady,
            "max_memory_allocated_bytes": peak, "launches": run_launches,
            "k2a_shapes": sorted(shapes), "card_vs_cpu": check,
            "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")},
            "test_psnr": mean["psnr"], "test_rmse": mean["rmse"],
            "test_ssim": mean["ssim"]}
        del model
        torch.cuda.empty_cache()

    # The HDR field with per-image extrinsics refinement on osplit.
    config = _layout_config(root, scene, "layout_hdr_ext",
                            {"optimize_ext": True, "num_images": KITTI_VIEWS},
                            {"rgb_activation": "none"})
    model, history, run_launches, seconds, peak = _train_phase(config)
    if run_launches != _ngp_launches(NGP_STEPS):
        raise AssertionError(f"hdr_ext: launches {run_launches}")
    _check_history(history, NGP_STEPS)
    pose_grad = model.pose_dT.weight.grad
    if pose_grad is None or not torch.isfinite(pose_grad).all() or not pose_grad.abs().max() > 0:
        raise AssertionError(f"hdr_ext: pose_dT gradient {pose_grad}")
    step_ms, steady = _without_refresh_ms(config, history)
    hdr = {"steps": NGP_STEPS, "seconds": seconds, "step_ms": step_ms,
           "median_step_ms_without_refresh": steady, "max_memory_allocated_bytes": peak,
           "launches": run_launches,
           "pose_dT_grad_max_abs": float(pose_grad.abs().max()),
           "pose_dR_max_abs": float(model.pose_dR.weight.detach().abs().max()),
           "pose_dT_max_abs": float(model.pose_dT.weight.detach().abs().max()),
           "losses": {k: v for k, v in history[-1].items() if k.startswith("loss")}}
    for renderer in ("train", "iterative"):
        _reset_launches()
        mean, per_image = evaluate(config.replace(ngp_eval_renderer=renderer), model,
                                   device="cuda", log_fn=lambda line: None)
        want = _only(K1a=chunks if renderer == "train" else 0)
        if _launches() != want or len(per_image) != KITTI_TEST_VIEWS or \
                not all(math.isfinite(mean[k]) for k in ("psnr", "rmse")):
            raise AssertionError(f"hdr_ext {renderer} eval: {_launches()}, {mean}")
        hdr[f"eval_{renderer}"] = {"psnr": mean["psnr"], "rmse": mean["rmse"],
                                   "ssim": mean["ssim"]}
    # Test view 0 through the iterative renderer against the dense one at
    # budget 0 (phase ngp_eval's two quadratures of one field, 0.02 apart
    # on the mean); the config's budget keeps each ray's nearest samples.
    batch = build_dataset(config, "test").image_batch(0)
    renders = {"iterative": step_lib.render_image(model, batch, config.render_chunk_size,
                                                  "cuda", "iterative"),
               "budget": step_lib.render_image(model, batch, config.render_chunk_size, "cuda")}
    budget, model.sample_budget = model.sample_budget, 0
    try:
        renders["budget0"] = step_lib.render_image(model, batch, config.render_chunk_size, "cuda")
    finally:
        model.sample_budget = budget
    diff = {name: {k: float(np.mean(np.abs(renders["iterative"][k] - renders[name][k])))
                   for k in ("rgb", "acc")} for name in ("budget0", "budget")}
    if max(diff["budget0"].values()) > NGP_EVAL_MEAN_TOL:
        raise AssertionError(f"hdr_ext: iterative and dense renders disagree: {diff}")
    hdr["iterative_vs_dense_mean_abs"] = diff
    launches["ngp_layouts_hdr_ext"] = run_launches
    out["hdr_ext"] = hdr
    out["cull"] = _cull(config, model.occupancy.detach())
    del model
    torch.cuda.empty_cache()

    out["gates"] = []
    for layout in GATE_LAYOUTS:
        result, gate_launches = _layout_gate(root, layout)
        launches[f"ngp_layouts_gate_{layout}"] = gate_launches
        out["gates"].append(result)
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["probe"] = ngp_layout.run("cuda")
    out["probe_seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit(out)
    return launches


def _options_config(root, label, steps, path=CONFIG, scene="dtu_format", model=None,
                    nerf=None, prop=None, **fields):
    """`path` on the kitti fixture for `steps` steps, with `model`, `nerf` and
    `prop` merged into its model_params, nerf_mlp_params and prop_mlp_params,
    and `fields` replaced."""
    config = load_config(path, [f"scene_dir={os.path.join(root, scene)}", f"max_steps={steps}",
                                "print_every=1", f"exp_dir={os.path.join(root, 'opt_' + label)}"])
    mp = copy.deepcopy(config.model_params)
    mp.update(model or {})
    if nerf or prop:
        mp["nerf_mlp_params"] = dict(mp["nerf_mlp_params"], **(nerf or {}))
        mp["prop_mlp_params"] = dict(mp["prop_mlp_params"], **(prop or {}))
    return config.replace(model_params=mp, **fields)


def _options_run(label, config, expect, steps, ngp=False):
    """train() from scratch with its launches asserted; (model, record)."""
    model, history, counted, seconds, peak = _train_phase(config)
    if counted != expect:
        raise AssertionError(f"mip_options {label}: launches {counted}, expected {expect}")
    _check_history(history, steps)
    step_ms, steady = (_without_refresh_ms if ngp else _steady_ms)(config, history)
    losses = lambda e: {k: v for k, v in e.items() if k.startswith("loss")}
    return model, {"steps": steps, "seconds": seconds, "step_ms": step_ms,
                   ("median_step_ms_without_refresh" if ngp else "median_step_ms_after_first"):
                   steady, "max_memory_allocated_bytes": peak, "launches": counted,
                   "launches_per_step": {k: v / steps for k, v in counted.items() if v},
                   "losses_first_step": losses(history[0]),
                   "losses_last_step": losses(history[-1])}


def _option_rays(config, device, n=None):
    """A train batch of the config's dataset on `device`, its pixels cast."""
    dataset = build_dataset(config, "train")
    batch = dataset.sample_batch()
    if n is not None:
        batch = rays_lib.map_fields(lambda x: x[:n], batch)
    batch = rays_lib.to_device(batch, device)
    rays = batch.rays
    if isinstance(rays, rays_lib.Pixels):
        rays = cameras_lib.cast_pixels(rays, dataset.cameras_on(device), dataset.camtype)
    return batch, rays


def _normal_mae(model, rays):
    """Weighted mean angle between the nerf level's density normals and its
    predicted normals, by compositing weight, in degrees."""
    with torch.no_grad():
        _, history = model(rays, train_frac=1.0, zero_glo=False)
    last = history[-1]
    return float(refdirs.weighted_mae_degrees(last["weights"], last["normals"],
                                              last["normals_pred"]))


def _forward_backward(config, model, batch, rays):
    """One forward, loss and backward of the train step's model and loss
    (deterministic sampling); the renders, histories and gradients."""
    model.zero_grad(set_to_none=True)
    forward = step_lib.make_forward(config, model, compute_extras=True)
    renderings, history = forward(rays, 0.5, None)
    loss_terms, _ = step_lib._total_loss(config, batch, renderings, history, rays)
    sum(loss_terms.values()).backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    return renderings, history, grads


def _as_float64(obj):
    return rays_lib.map_fields(lambda x: x.double() if x.is_floating_point() else x, obj)


def _option_errors(got, ref):
    """Errors of one forward and backward against another: colours and
    composited normals (max abs), per-sample normals (mean abs by
    compositing weight), each parameter's gradient (L2 relative to its
    norm); `ref` holds the weights."""
    errors = {"rgb": 0.0, "composited_normals": 0.0, "weighted_sample_normals": 0.0}
    for (r_got, h_got), (r_ref, h_ref) in zip(zip(got[0], got[1]), zip(ref[0], ref[1])):
        errors["rgb"] = max(errors["rgb"], float(
            (r_got["rgb"].detach().cpu().double() - r_ref["rgb"].detach().double()).abs().max()))
        w = h_ref["weights"].detach().double()
        for key in ("normals", "normals_pred"):
            errors["composited_normals"] = max(errors["composited_normals"], float(
                (r_got[key].detach().cpu().double() - r_ref[key].detach().double()).abs().max()))
            diff = (h_got[key].detach().cpu().double() - h_ref[key].detach().double()).abs()
            errors["weighted_sample_normals"] = max(errors["weighted_sample_normals"], float(
                (w * diff.amax(-1)).sum() / w.sum()))
    grads = {n: float((got[2][n].double() - g.double()).norm() / g.double().norm().clamp(min=1e-30))
             for n, g in ref[2].items()}
    if set(got[2]) != set(ref[2]) or not all(math.isfinite(v) for v in grads.values()):
        raise AssertionError("card against CPU: gradients missing or non-finite")
    worst = max(grads, key=grads.get)
    errors["grad_rel_of_norm"] = grads[worst]
    return errors, worst


def _card_against_cpu(config, init_model):
    """The Ref-NeRF step's forward and backward on 256 rays from the same
    weights: on the card, on the CPU in float32 (K1's plain version), and on
    the CPU with the field MLPs (encodings, layers and the density gradient)
    in float64, the heads' outputs and K1 still rounded to float32. The
    density normal differentiates IPE features of frequency up to 2^11
    through 8 layers of width 1024, whose terms cancel, so float32 keeps
    only some of its digits: the card's error against that reference is held
    to 4x the CPU float32 error's (plus 1e-6), and its colours to 1e-4 of
    the CPU's. Then the nerf level's K1a weights on those rays against the
    plain version on the card."""
    batch, rays = _option_rays(config, "cpu", OPTION_CPU_RAYS)
    card_batch, card_rays = (rays_lib.to_device(x, "cuda") for x in (batch, rays))
    card = _forward_backward(config, copy.deepcopy(init_model).cuda(), card_batch, card_rays)
    cpu = _forward_backward(config, copy.deepcopy(init_model).cpu(), batch, rays)
    reference = copy.deepcopy(init_model).cpu().double()
    for module in reference.modules():  # the field MLPs and their layers in float64
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float64
    f64 = _forward_backward(config, reference, _as_float64(batch), _as_float64(rays))
    card_err, card_worst = _option_errors(card, f64)
    cpu_err, cpu_worst = _option_errors(cpu, f64)
    card_cpu, _ = _option_errors(card, cpu)
    bad = {k: (v, cpu_err[k]) for k, v in card_err.items() if v > 4 * cpu_err[k] + 1e-6}
    if bad or card_cpu["rgb"] > OPTION_CPU_ATOL:
        raise AssertionError(f"card against CPU: {bad}, card vs CPU float32 {card_cpu}")
    last = card[1][-1]
    tau = volren.optical_depth(last["density"].detach(), last["tdist"], card_rays.directions,
                               init_model.opaque_background)
    kernel, _ = volren_weights.weights_fwd_cuda(tau.contiguous())
    plain, _ = volren_weights.weights_from_tau_plain(tau)
    k1a_err = float((kernel - plain).abs().max())
    if k1a_err > FWD_ATOL or not torch.equal(kernel, last["weights"].detach()):
        raise AssertionError(f"card against CPU: K1a weights off the plain version by {k1a_err}")
    return {"rays": OPTION_CPU_RAYS, "card_vs_float64": card_err,
            "card_worst_grad_param": card_worst, "cpu_float32_vs_float64": cpu_err,
            "cpu_worst_grad_param": cpu_worst, "card_vs_cpu_float32": card_cpu,
            "tolerance": "card vs float64 <= 4 x CPU float32 vs float64 + 1e-6; "
                         f"rgb card vs CPU float32 <= {OPTION_CPU_ATOL}",
            "nerf_level_k1a_vs_plain_max_abs_err": k1a_err, "k1a_shape": list(tau.shape)}


def phase_mip_options(root):
    """The mip-NeRF 360 options at the flagship's full width on the kitti
    fixture: the rawnerf loss on each backend, Ref-NeRF in float32 and bf16,
    the card against the CPU, remat, GLO with learned exposure and cylinder
    rays; launches asserted per run. One JSON line a part, then a summary."""
    launches, ms = {}, {}
    k1 = lambda steps, k1a=3: _only(K1a=k1a * steps, K1b=3 * steps)

    def part(name, record):
        emit({"phase": "mip_options", "part": name, **record})

    # The backends under their own rgb loss and under rawnerf's.
    for backend, path, scene in (("mip", CONFIG, "dtu_format"),
                                 ("nerfpp", NERFPP_CONFIG, "nerfpp"),
                                 ("ngp", NGP_CONFIG, "dtu_format")):
        steps = OPTION_SHORT_STEPS
        expect = {"mip": k1(steps), "nerfpp": _only(), "ngp": _ngp_launches(steps)}[backend]
        key = "median_step_ms_without_refresh" if backend == "ngp" else "median_step_ms_after_first"
        own = load_config(path).data_loss_type
        for kind in (own, "rawnerf"):
            label = f"{backend}_{kind}"
            config = _options_config(root, label, steps, path, scene, data_loss_type=kind)
            model, record = _options_run(label, config, expect, steps, ngp=backend == "ngp")
            if not math.isfinite(record["losses_last_step"]["loss_data"]):
                raise AssertionError(f"mip_options {label}: non-finite data loss")
            ms[label] = record[key]
            record["ms_over_own_loss"] = record[key] / ms[f"{backend}_{own}"]
            launches[f"mip_options_{label}"] = record["launches"]
            part(label, {"config": path, "data_loss_type": config.data_loss_type, **record})
            del model
            torch.cuda.empty_cache()
    flagship_ms = ms["mip_charb"]

    # Ref-NeRF, float32 then bf16.
    for dtype in ("float32", "bfloat16"):
        label = f"refnerf_{dtype}"
        config = _options_config(root, label, OPTION_STEPS, nerf=REFNERF_NERF,
                                 prop=REFNERF_PROP, compute_dtype=dtype, **REFNERF_LOSSES)
        init = step_lib.build_model(config, torch.Generator().manual_seed(config.seed)).cuda()
        _, rays = _option_rays(config, "cuda")
        mae_first = _normal_mae(init, rays)
        model, record = _options_run(label, config, k1(OPTION_STEPS), OPTION_STEPS)
        record["normal_mae_degrees"] = {"before_first_step": mae_first,
                                        "after_last_step": _normal_mae(model, rays)}
        ms[label] = record["median_step_ms_after_first"]
        record["ms_over_flagship"] = ms[label] / flagship_ms
        for term in ("loss_orientation", "loss_predicted_normals"):
            if term not in record["losses_last_step"]:
                raise AssertionError(f"mip_options {label}: no {term}")
        launches[f"mip_options_{label}"] = record["launches"]
        part(label, {"nerf_mlp_params": config.model_params["nerf_mlp_params"],
                     "prop_mlp_params": config.model_params["prop_mlp_params"],
                     **REFNERF_LOSSES, **record})
        del model
        torch.cuda.empty_cache()
        if dtype == "float32":
            part("card_against_cpu", _card_against_cpu(config, init.cpu()))
            remat_config = config.replace(remat="dots", max_steps=OPTION_REMAT_STEPS,
                                          exp_dir=config.exp_dir + "_remat")
            model, remat = _options_run("refnerf_remat", remat_config,
                                        k1(OPTION_REMAT_STEPS, k1a=6), OPTION_REMAT_STEPS)
            none_loss = record["losses_first_step"]
            remat["first_step_loss_rel_diff_to_none"] = {
                k: abs(v - none_loss[k]) / max(abs(none_loss[k]), 1e-30)
                for k, v in remat["losses_first_step"].items()}
            remat["none"] = {k: record[k] for k in ("median_step_ms_after_first",
                                                     "max_memory_allocated_bytes")}
            if max(remat["first_step_loss_rel_diff_to_none"].values()) > 1e-4:
                raise AssertionError(f"remat=dots first step off none's: {remat}")
            ms["refnerf_remat_dots"] = remat["median_step_ms_after_first"]
            launches["mip_options_refnerf_remat"] = remat["launches"]
            part("refnerf_remat_dots", remat)
            del model
            torch.cuda.empty_cache()
        del init

    # GLO and learned exposure: eval uses neither.
    config = _options_config(root, "glo", OPTION_STEPS,
                             model={"num_glo_features": 4, "learned_exposure_scaling": True})
    model, glo = _options_run("glo", config, k1(OPTION_STEPS), OPTION_STEPS)
    launches["mip_options_glo"] = glo["launches"]
    ms["glo_exposure"] = glo["median_step_ms_after_first"]
    glo["ms_over_flagship"] = ms["glo_exposure"] / flagship_ms
    glo["exposure_offset_max_abs_after_training"] = float(
        model.exposure_scaling.weight.detach().abs().max())
    view = build_dataset(config, "test").image_batch(0)
    _, rays = _option_rays(config, "cuda", 4096)
    with torch.no_grad():
        first = step_lib.render_image(model, view, config.render_chunk_size, "cuda")
        trained_rgb = model(rays, zero_glo=False)[0][-1]["rgb"]
        gen = torch.Generator(device="cuda").manual_seed(9)
        model.glo.weight.add_(torch.randn(model.glo.weight.shape, generator=gen, device="cuda"))
        model.exposure_scaling.weight.add_(0.5)
        second = step_lib.render_image(model, view, config.render_chunk_size, "cuda")
        perturbed_rgb = model(rays, zero_glo=False)[0][-1]["rgb"]
    if set(first) != set(second) or not all(np.array_equal(first[k], second[k]) for k in first):
        raise AssertionError("glo: the eval render moved with the GLO and exposure embeddings")
    if torch.equal(trained_rgb, perturbed_rgb):
        raise AssertionError("glo: the perturbed embeddings changed nothing in training")
    glo["eval_render_equal_after_perturbation"] = True
    glo["train_rgb_max_change_after_perturbation"] = float(
        (trained_rgb - perturbed_rgb).abs().max())
    part("glo_exposure", glo)
    del model
    torch.cuda.empty_cache()

    config = _options_config(root, "cylinder", OPTION_SHORT_STEPS, model={"ray_shape": "cylinder"})
    model, cylinder = _options_run("cylinder", config, k1(OPTION_SHORT_STEPS), OPTION_SHORT_STEPS)
    ms["cylinder"] = cylinder["median_step_ms_after_first"]
    cylinder["ms_over_flagship"] = ms["cylinder"] / flagship_ms
    launches["mip_options_cylinder"] = cylinder["launches"]
    part("cylinder", cylinder)
    del model
    torch.cuda.empty_cache()
    emit({"phase": "mip_options", "config": CONFIG, "median_step_ms": ms,
          "over_flagship": {k: v / flagship_ms for k, v in ms.items() if not k.startswith(
              ("ngp", "nerfpp"))}})
    return launches


def _ddp_spawn(part, world, workdir):
    """`world` ranks of this script launched by torchrun (`--standalone`,
    whose rendezvous takes a free port); each writes its result to
    `workdir`. torchrun fails when a rank fails; past the time limit its
    whole session is killed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", os.path.abspath(__file__), "--ddp-worker", part, workdir]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DDP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{part} ranks timed out:\n{out[-3000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{part} ranks exited {proc.returncode}:\n{out[-3000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"{part}_rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _allreduce_ms(model, reps=DDP_ALLREDUCE_REPS):
    """Host-clock ms of the step's one flat all-reduce of `model`'s
    gradients (concatenate, all-reduce, copy back), median of `reps`."""
    grads = [torch.randn_like(p) for p in model.parameters()]
    for _ in range(2):
        parallel.all_reduce_sum_(grads)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parallel.all_reduce_sum_(grads)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return {"ms": statistics.median(times), "bytes": 4 * sum(g.numel() for g in grads)}


def _ddp_cli_run(argv, exp_dir, batch):
    """The port's CLI inside this rank's group: its log lines, the step ms
    of each, the kernel launches, the files of the experiment."""
    _reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv + [f"exp_dir={exp_dir}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    steps = [x for x in lines if "loss" in x]
    for entry in steps:
        if not all(math.isfinite(v) for k, v in entry.items() if k.startswith("loss")):
            raise AssertionError(f"non-finite loss: {entry}")
    step_ms = [1e3 * batch / x["rays_per_sec"] for x in steps]
    return {"seconds": seconds, "launches": _launches(), "step_ms": step_ms,
            "median_step_ms_after_first": statistics.median(step_ms[1:]),
            "rays_per_sec_per_chip": steps[-1]["rays_per_sec_per_chip"],
            "losses": {k: v for k, v in steps[-1].items() if k.startswith("loss")},
            "eval": [x for x in lines if "split" in x],
            "files": sorted(os.listdir(exp_dir)),
            "checkpoints": sorted(os.listdir(os.path.join(exp_dir, "checkpoints")))}


def _ddp_timed(inputs, device):
    """Host-clock ms of DDP_TIMED_STEPS flagship and NGP steps (the inputs'
    weights and batches, cycled) in this process as it stands, in a group
    or not: each step, and the median after the first DDP_TIMED_SKIP."""
    out = {}
    for label in ("mip", "ngp"):
        spec = inputs[label]
        config, model = _ddp_model(spec, device)
        batches = spec["batches"] * -(-DDP_TIMED_STEPS // len(spec["batches"]))
        run = _ddp_steps(config.replace(max_steps=DDP_TIMED_STEPS), model,
                         dict(spec, batches=batches[:DDP_TIMED_STEPS]), device)
        out[label] = {"step_ms": run["step_ms"],
                      "median_ms": statistics.median(run["step_ms"][DDP_TIMED_SKIP:])}
        del model
        torch.cuda.empty_cache()
    return out


def _ddp_worker_nccl(workdir):
    """Part (a): world 1 under NCCL. The flagship's and NGP's steps timed
    without a group, in the group and without it again; then, in the group,
    the CLI on the flagship and NGP at full width on the synthetic scene."""
    set_full_float32()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    local = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(local)
    timed = {"one_process_before": _ddp_timed(inputs, local)}
    device = parallel.init_from_env()
    backend = torch.distributed.get_backend()
    if backend != "nccl" or parallel.world() != 1:
        raise AssertionError(f"joined {backend} with {parallel.world()} ranks")
    timed["world1"] = _ddp_timed(inputs, device)
    out = {"backend": backend, "device": str(device), "world": parallel.world(), "timed": timed}
    mip_argv = ["--config", CONFIG, "dataset=synthetic", f"max_steps={DDP_CLI_STEPS}",
                "print_every=1", f"checkpoint_every={DDP_CLI_STEPS // 2}"]
    out["mip"] = _ddp_cli_run(mip_argv, os.path.join(workdir, "nccl_mip"), 4096)
    test_views = datasets_lib.SyntheticDataset("test").n_images
    if out["mip"]["launches"] != _only(K1a=3 * DDP_CLI_STEPS + 3 * test_views,
                                       K1b=3 * DDP_CLI_STEPS):
        raise AssertionError(f"nccl mip: launches {out['mip']['launches']}")
    if out["mip"]["checkpoints"] != sorted([str(DDP_CLI_STEPS // 2), str(DDP_CLI_STEPS),
                                            "model_meta.json"]) or \
            "renders" not in out["mip"]["files"] or len(out["mip"]["eval"]) != 1:
        raise AssertionError(f"nccl mip: wrote {out['mip']['files']} {out['mip']['checkpoints']}")
    ngp_argv = ["--no-eval", "--config", NGP_CONFIG, "dataset=synthetic",
                f"max_steps={DDP_CLI_STEPS}", "print_every=1"]
    out["ngp"] = _ddp_cli_run(ngp_argv, os.path.join(workdir, "nccl_ngp"), 8192)
    if out["ngp"]["launches"] != _ngp_launches(DDP_CLI_STEPS):
        raise AssertionError(f"nccl ngp: launches {out['ngp']['launches']}")
    config = load_config(CONFIG)
    out["allreduce"] = _allreduce_ms(step_lib.build_model(config).to(device))
    out["still_active"] = parallel.active()
    parallel.shutdown()
    timed["one_process_after"] = _ddp_timed(inputs, device)
    return out


def _ddp_worker_gloo(workdir):
    """Part (b): one rank of two under gloo, both on cuda:0 with CUDA
    tensors: this rank's rows of each global batch through the step."""
    device = parallel.init_from_env("cuda:0", backend="gloo")
    backend = torch.distributed.get_backend()
    if backend != "gloo" or parallel.world() != 2:
        raise AssertionError(f"joined {backend} with {parallel.world()} ranks")
    set_full_float32()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"backend": backend, "device": str(device), "rank": parallel.rank()}
    for label in ("mip", "mip_remat", "ngp"):
        spec = inputs[label]
        config, model = _ddp_model(spec, device)
        run = _ddp_steps(config, model, spec, device)
        params = torch.stack([p.detach().double().sum() for p in model.parameters()])
        run["replicated"] = bool(torch.equal(*parallel.all_gather_rows(params[None])))
        if parallel.rank() == 0:
            torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
                       os.path.join(workdir, f"{label}_params.pt"))
        if label == "mip":
            run["allreduce"] = _allreduce_ms(model)
        out[label] = run
        del model
        torch.cuda.empty_cache()
    parallel.shutdown()
    return out


def _ddp_model(spec, device):
    config = load_config(spec["config"], spec["overrides"])
    model = step_lib.build_model(config)
    model.load_state_dict(spec["state"])
    return config, model.to(device)


def _ddp_steps(config, model, spec, device):
    """The steps of `spec` on `model`: on this rank's rows of each global
    batch in a group, on the whole batch otherwise; stats, ms and launches."""
    optimizer, lr_fn = step_lib.make_optimizer(config, model)
    cams = tuple(None if c is None else c.to(device) for c in spec["cams"])
    step = step_lib.make_train_step(config, model, optimizer, lr_fn, cameras=cams)
    gen = torch.Generator(device=device).manual_seed(DDP_SEED)
    stats, step_ms = [], []
    _reset_launches()
    for i, batch in enumerate(spec["batches"]):
        batch = rays_lib.to_device(parallel.shard_batch(batch), device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = step(batch, i, i / config.max_steps, gen)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        stats.append({k: float(s[k]) for k in ("loss", "psnr", "grad_norm", "rm_s", "vr_s")
                      if k in s})
    return {"stats": stats, "step_ms": step_ms, "launches": _launches()}


def _ddp_param_errors(config, got, model):
    """Card parameters of two ranks against one process's after the same
    steps: the share of entries within 1e-5 + 1e-4 |p|, and the largest
    difference against Adam's bound on two trajectories' parting (each
    moves an entry by at most lr (1 - b1) / sqrt(1 - b2) a step)."""
    diffs, close, total = [], 0, 0
    for name, p in model.named_parameters():
        want = p.detach().cpu()
        d = (got[name] - want).abs()
        close += int((d <= DDP_PARAM_ATOL + DDP_PARAM_RTOL * want.abs()).sum())
        total += d.numel()
        diffs.append(float(d.max()))
    step_bound = config.lr_init * (1 - config.adam_beta1) / math.sqrt(1 - config.adam_beta2)
    return {"max_abs": max(diffs), "share_close": close / total,
            "adam_bound": 2 * step_bound * config.max_steps}


def phase_ddp(smi):
    """Data parallelism on one card: (a) world 1 under NCCL through the CLI,
    (b) world 2 under gloo with both ranks on cuda:0, held against one
    process fed the concatenated batches and the same generator."""
    with tempfile.TemporaryDirectory() as workdir:
        mip_config = _flagship_config(workdir).replace(max_steps=DDP_STEPS)
        scene = _scene(mip_config, "train", 0)
        ngp_config = _ngp_config(workdir)
        ngp_scene = _scene(ngp_config, "train", 0)
        ngp_model = step_lib.build_model(
            ngp_config, generator=torch.Generator().manual_seed(0)).to("cuda")
        update = step_lib.make_occupancy_update_fn(ngp_config, ngp_model)
        grid = update(ngp_model.occupancy, torch.Generator(device="cuda").manual_seed(1), True)
        ngp_model.occupancy.copy_(grid)
        mip_state = step_lib.build_model(
            mip_config, generator=torch.Generator().manual_seed(0)).state_dict()
        mip = {"config": CONFIG, "overrides": [f"max_steps={DDP_STEPS}"],
               "state": mip_state, "cams": scene.cameras_on("cpu"),
               "batches": [scene.sample_batch() for _ in range(DDP_STEPS)]}
        inputs = {
            "mip": mip,
            "mip_remat": dict(mip, overrides=mip["overrides"] + ["remat=dots"]),
            "ngp": {"config": NGP_CONFIG, "overrides": [f"max_steps={DDP_NGP_STEPS}"],
                    "state": {k: v.cpu() for k, v in ngp_model.state_dict().items()},
                    "cams": ngp_scene.cameras_on("cpu"),
                    "batches": [ngp_scene.sample_batch() for _ in range(DDP_NGP_STEPS)]},
        }
        occupied = _occupied_share(ngp_model)
        del ngp_model, update
        torch.save(inputs, os.path.join(workdir, "inputs.pt"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        (nccl,) = _ddp_spawn("nccl", 1, workdir)
        nccl_seconds = time.perf_counter() - t0
        if nccl["still_active"] is not True:
            raise AssertionError("the CLI left a group it did not join")
        t0 = time.perf_counter()
        ranks = _ddp_spawn("gloo", 2, workdir)
        gloo_seconds = time.perf_counter() - t0

        gloo, checks = {}, {}
        for label, per_step in (("mip", _only(K1a=3, K1b=3)),
                                ("mip_remat", _only(K1a=6, K1b=3)), ("ngp", _ngp_launches(1))):
            spec = inputs[label]
            config, model = _ddp_model(spec, "cuda")
            one = _ddp_steps(config.replace(max_steps=len(spec["batches"])), model, spec, "cuda")
            got = torch.load(os.path.join(workdir, f"{label}_params.pt"), weights_only=True)
            steps = len(spec["batches"])
            expected = {k: v * steps for k, v in per_step.items()}
            for r, rank in enumerate(ranks):
                run = rank[label]
                if run["launches"] != expected or not run["replicated"]:
                    raise AssertionError(f"gloo {label} rank {r}: launches {run['launches']}, "
                                         f"replicated {run['replicated']}")
                for a, b in zip(run["stats"], ranks[0][label]["stats"]):
                    if a != b:
                        raise AssertionError(f"gloo {label}: the ranks' stats differ {a} {b}")
            loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                           for a, b in zip(ranks[0][label]["stats"], one["stats"]))
            norm_err = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                           for a, b in zip(ranks[0][label]["stats"], one["stats"]))
            params = _ddp_param_errors(config, got, model)
            checks[label] = {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err, **params}
            if loss_err > DDP_LOSS_RTOL or norm_err > DDP_GRAD_NORM_RTOL or \
                    params["share_close"] < DDP_PARAM_SHARE or \
                    params["max_abs"] > params["adam_bound"]:
                raise AssertionError(f"gloo {label}: 2 ranks against one process {checks[label]}")
            gloo[label] = {"step_ms_per_rank": [rank[label]["step_ms"] for rank in ranks],
                           "one_process_step_ms": one["step_ms"],
                           "launches_per_rank": [rank[label]["launches"] for rank in ranks],
                           "stats": ranks[0][label]["stats"], "one_process": one["stats"]}
            del model
            torch.cuda.empty_cache()
    emit({"phase": "ddp", "nvidia_smi": smi,
          "nccl_world1": {"seconds": nccl_seconds, "backend": nccl["backend"],
                          "device": nccl["device"],
                          "mip": {k: nccl["mip"][k] for k in (
                              "step_ms", "median_step_ms_after_first", "rays_per_sec_per_chip",
                              "launches", "losses", "checkpoints", "files")},
                          "mip_eval": nccl["mip"]["eval"][0]["mean"],
                          "ngp": {k: nccl["ngp"][k] for k in (
                              "step_ms", "median_step_ms_after_first", "launches", "losses")},
                          "allreduce": nccl["allreduce"],
                          "timed_same_process": _timed_summary(nccl["timed"])},
          "gloo_world2": {"seconds": gloo_seconds, "devices": [r["device"] for r in ranks],
                          "allreduce": [r["mip"]["allreduce"] for r in ranks],
                          "ngp_untrained_occupied_share": occupied, **gloo},
          "against_one_process": checks,
          "tolerances": {"loss_rel": DDP_LOSS_RTOL, "grad_norm_rel": DDP_GRAD_NORM_RTOL,
                         "param_atol": DDP_PARAM_ATOL, "param_rtol": DDP_PARAM_RTOL,
                         "param_share": DDP_PARAM_SHARE}})
    return {"ddp_nccl_mip": nccl["mip"]["launches"], "ddp_nccl_ngp": nccl["ngp"]["launches"],
            **{f"ddp_gloo_{label}_rank{r}": rank[label]["launches"]
               for label in ("mip", "mip_remat", "ngp") for r, rank in enumerate(ranks)}}


def _timed_summary(timed):
    """Each run's median step ms and the group's cost at world 1: its
    median less the mean of the medians without a group before and after."""
    out = {}
    for label in ("mip", "ngp"):
        med = {run: timed[run][label]["median_ms"] for run in timed}
        alone = (med["one_process_before"] + med["one_process_after"]) / 2
        out[label] = {"median_ms": med, "world1_minus_one_process_ms": med["world1"] - alone,
                      "step_ms": {run: timed[run][label]["step_ms"] for run in timed}}
    return out


def ddp_worker(part, workdir):
    """A rank of phase ddp (launched by `_ddp_spawn` through torchrun)."""
    out = {"nccl": _ddp_worker_nccl, "gloo": _ddp_worker_gloo}[part](workdir)
    with open(os.path.join(workdir, f"{part}_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)


def summary(k, launches):
    errors, timing = k["errors"], k["timing"]
    scan_errors, scan_timing = k["scan_errors"], k["scan_timing"]

    def per_step(key, shapes):
        return sum(timing[f"{r}x{s}"][key] for r, s in shapes)

    def by_phase(kernel):
        return {phase: counts[kernel] for phase, counts in launches.items()}

    ngp = f"{NGP_K1_SHAPE[0]}x{NGP_K1_SHAPE[1]}"
    def on_path(kernel):
        main_path = ("train", "ngp_train", "kitti_mip", "kitti_mip_resumed", "kitti_ngp", "nerfpp",
                     "bf16_mip16k", "bf16_flagship", "bf16_ngp", "bf16_nerfpp", "priors_mip",
                     "eval_render", "gate_ngp", "gate_mipnerf360", "gate_nerfpp", "blender",
                     "blender_eval")
        return sum(counts[kernel] for p, counts in launches.items()
                   if p in main_path or p.startswith(("cameras_", "depth_losses_",
                                                      "ngp_layouts_", "mip_options_", "ddp_")))

    k1 = {"route": "cuda", "source": SOURCE, "library_ms": None,
          "work": "one mip train step: 2 x [4096, 64] + [4096, 32] float32",
          "launches_note": "mip and NGP train runs on the synthetic scene and the KITTI fixture, "
                           "float32 and bf16 (the 16k remat run launches K1a twice a level), "
                           "mip on the port's own completion prior (phase priors), the tools' "
                           "test-view and camera-path renders (phase eval_render), the "
                           "quality gate's mip and NGP runs (phase gate), mip on lens-distorted "
                           "and fisheye cameras (phase cameras), mip and NGP under the mse, urf "
                           "and nll depth losses (phase depth_losses), mip under the Ref-NeRF, "
                           "GLO, exposure, cylinder and rawnerf options and NGP under rawnerf "
                           "(phase mip_options), NGP on the Blender "
                           "layout, trained and evaluated (phase blender), and the flagship "
                           "and NGP as ranks of a process group (phase ddp: world 1 under "
                           "NCCL, world 2 under gloo on one card, the flagship plain and "
                           "under remat=dots; counts per rank, each rank "
                           "launching a step's kernels on its own rows)"}
    path = f"{SCAN_PATH[0]}x{SCAN_PATH[1]}"
    oct_path = f"{OCT_SCAN_PATH[0]}x{OCT_SCAN_PATH[1]}"
    kernels = [
        dict(k1, name="K1a volren_weights_fwd", redesigned="PR 4",
             replaces="outdoor_nerf_depth_tpu/ops/pallas_volren.py:54",
             launches=on_path("K1a"),
             launches_by_phase=by_phase("K1a"),
             max_abs_err=max(f for f, _ in errors.values()),
             ms=per_step("fwd_ms", TRAIN_SHAPES), plain_ms=per_step("fwd_plain_ms", TRAIN_SHAPES),
             bound_ms=per_step("fwd_bound_ms", TRAIN_SHAPES), bound_by="bytes",
             ngp_step={"shape": list(NGP_K1_SHAPE), "ms": timing[ngp]["fwd_ms"],
                       "plain_ms": timing[ngp]["fwd_plain_ms"],
                       "bound_ms": timing[ngp]["fwd_bound_ms"]},
             floor_ms=timing["floor"]["fwd_ms"], floor_shape=timing["floor"]["shape"]),
        dict(k1, name="K1b volren_weights_bwd",
             replaces="outdoor_nerf_depth_tpu/ops/pallas_volren.py:72",
             launches=on_path("K1b"),
             launches_by_phase=by_phase("K1b"),
             max_abs_err=max(b for _, b in errors.values()),
             ms=per_step("bwd_ms", TRAIN_SHAPES), plain_ms=per_step("bwd_plain_ms", TRAIN_SHAPES),
             bound_ms=per_step("bwd_bound_ms", TRAIN_SHAPES), bound_by="bytes",
             ngp_step={"shape": list(NGP_K1_SHAPE), "ms": timing[ngp]["bwd_ms"],
                       "plain_ms": timing[ngp]["bwd_plain_ms"],
                       "bound_ms": timing[ngp]["bwd_bound_ms"]},
             floor_ms=timing["floor"]["bwd_ms"], floor_shape=timing["floor"]["shape"]),
        {"name": "K2a prefix_scan", "route": "cuda", "source": SCAN_SOURCE, "redesigned": "PR 5",
         "replaces": "outdoor_nerf_depth_tpu/ops/pallas_scan.py:64",
         "launches": on_path("K2a"), "launches_by_phase": by_phase("K2a"),
         "launches_note": "NGP train runs on the synthetic scene and the KITTI fixture, "
                          "float32 and bf16, the NGP quality gate (phase gate), NGP under the "
                          "mse, urf and nll depth losses (phase depth_losses), on the "
                          "Blender layout (phase blender), NGP under its own loss and rawnerf's "
                          "(phase mip_options), the oct layout's one scan a step "
                          "and osplit's HDR field with extrinsics refinement (phase "
                          "ngp_layouts), and NGP as a rank of a process group (phase ddp: "
                          "16 a step on each rank)",
         "max_abs_err": scan_errors[path]["kernel_vs_plain_abs"],
         "bf16_max_err_rel_to_running_abs_sum": max(e["kernel_vs_plain"]
                                                    for e in k["bf16_errors"].values()),
         "max_abs_err_all_shapes": max(e["kernel_vs_plain_abs"] for e in scan_errors.values()),
         "max_err_rel_to_running_abs_sum": max(e["kernel_vs_plain"] for e in scan_errors.values()),
         "run_to_run_max_abs": max(e["run_to_run_abs"] for e in scan_errors.values()),
         "work": f"one NGP train step: {NGP_LEVELS} x [{SCAN_PATH[0]}, {SCAN_PATH[1]}] float32",
         "ms": NGP_LEVELS * scan_timing[path]["ms"],
         "plain_ms": NGP_LEVELS * scan_timing[path]["plain_ms"],
         "bound_ms": NGP_LEVELS * scan_timing[path]["bound_ms"], "bound_by": "bytes",
         "library_ms": NGP_LEVELS * scan_timing[path]["library_ms"],
         "oct_step": dict(scan_timing[oct_path], shape=list(OCT_SCAN_PATH), bound_by="bytes",
                          launches=sum(counts["K2a"] for p, counts in launches.items()
                                       if p.startswith("ngp_layouts_oct"))),
         "per_call": scan_timing},
    ]
    batched = "x".join(str(d) for d in SCAN_BATCHED_PATH)
    bt = k["batched_timing"][batched]
    kernels.append(
        {"name": "K2b prefix_scan_batched", "route": "cuda", "source": SCAN_SOURCE,
         "redesigned": "PR 5",
         "replaces": "outdoor_nerf_depth_tpu/ops/pallas_scan.py:117",
         "launches": launches["probe_osplit_bwd"]["K2b"], "launches_by_phase": by_phase("K2b"),
         "max_abs_err": k["batched_errors"][batched]["kernel_vs_plain_abs"],
         "max_err_rel_to_running_abs_sum": max(e["kernel_vs_plain"]
                                               for e in k["batched_errors"].values()),
         "run_to_run_max_abs": max(e["run_to_run_abs"] for e in k["batched_errors"].values()),
         "work": f"one call at {list(SCAN_BATCHED_PATH)} float32",
         "ms": bt["ms"], "plain_ms": bt["plain_ms"], "bound_ms": bt["bound_ms"],
         "bound_by": "bytes", "library_ms": bt["library_ms"], "copy_ms": bt["copy_ms"]})
    for kid, name, line, extra in (("P1", "P1 chunk_take", 111, {}),
                                   ("P2", "P2 onehot_extract", 158, {"redesigned": "PR 4"})):
        # Timing keys (ms, plain_ms, library_ms, bound_ms, bound_by) and shape.
        kernels.append(dict(
            k["gather_timing"][kid], name=name, route="cuda", source=GATHER_SOURCE,
            replaces=f"benchmarks/probes/gather_attack_probe.py:{line}",
            launches=launches["probe_gather"][kid], launches_by_phase=by_phase(kid),
            max_abs_err=max(k["gather_errors"][kid].values()), **extra))
    emit({"kernels": kernels})


def main():
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(*sys.argv[2:4])
        return
    smi = phase_device()
    phase_build()
    k = phase_kernels()
    launches = {}
    with tempfile.TemporaryDirectory() as exp_dir:
        config, model, launches["train"], train_ms_f32 = phase_train(exp_dir)
    launches["render"] = phase_render(config, model)
    phase_profile(config, model, 3 * mlp_forward_flops(model, config.batch_size) / 1e12)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as exp_dir:
        ngp_config, ngp_model, launches["ngp_train"], ngp_tflop = phase_ngp_train(exp_dir)
    launches["ngp_render"] = phase_ngp_render(ngp_config, ngp_model)
    phase_profile(ngp_config, ngp_model, ngp_tflop, label="ngp_profile")
    update = step_lib.make_occupancy_update_fn(ngp_config, ngp_model)
    gen = torch.Generator(device="cuda").manual_seed(3)
    _profile("ngp_refresh_profile", lambda i: update(ngp_model.occupancy, gen, i == 0), 2)
    del ngp_model, update
    torch.cuda.empty_cache()
    launches["probe_osplit_bwd"] = phase_probe_osplit_bwd()
    launches["probe_gather"] = phase_probe_gather()
    with tempfile.TemporaryDirectory() as root:
        kitti_launches, kitti_ngp_config, kitti_ngp, kitti_mip_eval = phase_kitti(root)
        launches.update(kitti_launches)
        launches.update(phase_nerfpp(root))
        launches.update(phase_bf16_nerfpp(root))
        launches.update(phase_ngp_eval(kitti_ngp_config, kitti_ngp))
        del kitti_ngp
        launches.update(phase_bf16_synthetic(train_ms_f32))
        launches.update(phase_priors(root))
        launches.update(phase_priors_photo(root))
        launches.update(phase_eval_render(root, kitti_mip_eval))
        launches.update(phase_cameras(root))
        launches.update(phase_depth_losses(root))
        launches.update(phase_ngp_layouts(root))
        launches.update(phase_mip_options(root))
    launches.update(phase_lpips())
    launches.update(phase_gate())
    launches.update(phase_blender())
    launches.update(phase_ddp(smi))
    summary(k, launches)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
