"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each printing one JSON line; any failure raises and the run exits
non-zero without the final line:

  device      CUDA must be present; the card's name and power limit
  build       nvcc builds every CUDA source of the port into build/, all at once
  kernels     each kernel against its plain PyTorch version on the card, at the
              shapes of the paths and at edge cases (K2b at the osplit probe's
              [16, 524288, 16], P1 and P2 at the gather probe's 8.4M queries,
              which must match bit for bit; K2a and K2b also twice on one
              input, their run-to-run difference, and on bf16 inputs, which
              they accumulate in f32 and return in bf16); times from CUDA
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
              94x310 in a temporary directory), the mip flagship trained on
              it at full width from scene_dir=.../dtu_format for 4 steps with
              a checkpoint every 2, then resumed to 6 steps (step 4 must be
              restored), configs/kitti_ngp.json trained on it for 20 steps,
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

then the kernel summary, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from outdoor_nerf_depth_torch.data import datasets as datasets_lib  # noqa: E402
from outdoor_nerf_depth_torch.data import png  # noqa: E402
from outdoor_nerf_depth_torch.data import rays as rays_lib  # noqa: E402
from outdoor_nerf_depth_torch.depth_priors import generate, stereo  # noqa: E402
from outdoor_nerf_depth_torch.ops import chunk_gather, cuda_build, prefix_scan  # noqa: E402
from outdoor_nerf_depth_torch.ops import occupancy as occ_lib  # noqa: E402
from outdoor_nerf_depth_torch.ops import volren_weights  # noqa: E402
from outdoor_nerf_depth_torch.probes import gather_attack, osplit_bwd  # noqa: E402
from outdoor_nerf_depth_torch.tools import e2e_prior_loop, make_kitti_fixture  # noqa: E402
from outdoor_nerf_depth_torch.tools import train_prior  # noqa: E402
from outdoor_nerf_depth_torch.train import step as step_lib  # noqa: E402
from outdoor_nerf_depth_torch.train.config import load_config  # noqa: E402
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
SCAN_SHAPES = [SCAN_PATH, (1048576, 16), (16777216, 16),  # path, budget 0, 16.8M rows
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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(cuda_build.library_path(s), REPO) for s in sources],
          "ptxas": reports})


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
    want = _only(K1a=NGP_STEPS, K1b=NGP_STEPS, K2a=NGP_LEVELS * NGP_STEPS)
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
        **{k: mean[k] for k in ("psnr", "ssim", "rmse", "abs_rel", "n_valid")}}


def phase_kitti(root):
    """The KITTI data path at full width: fixture, mip with a checkpoint
    resume, NGP, and the test split's metrics; launches per part. Returns
    the launches, and NGP's config and trained model (with its grid)."""
    t0 = time.perf_counter()
    make_kitti_fixture.main(root, KITTI_VIEWS)
    fixture_seconds = time.perf_counter() - t0
    scene = os.path.join(root, "dtu_format")
    chunks = KITTI_TEST_VIEWS * math.ceil(HEIGHT * WIDTH / 16384)  # render chunks of eval
    out = {"phase": "kitti", "fixture": f"{KITTI_VIEWS} views of {HEIGHT}x{WIDTH}",
           "fixture_seconds": fixture_seconds}
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
        config, "kitti ngp", _only(K1a=NGP_STEPS, K1b=NGP_STEPS, K2a=NGP_LEVELS * NGP_STEPS),
        _only(K1a=chunks))
    _check_history(history, NGP_STEPS)
    out["ngp"] = dict(ngp, rm_s=history[-1]["rm_s"], vr_s=history[-1]["vr_s"],
                      occupied_share=_occupied_share(model))
    launches["kitti_ngp"], launches["kitti_ngp_eval"] = ngp["train_launches"], ngp["eval_launches"]
    torch.cuda.empty_cache()
    emit(out)
    return launches, config, model


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


def _train_phase(config, dataset=None, scan_shapes=None):
    """train() from scratch with the launch counts zeroed before it; returns
    (model, history, launches, seconds, peak memory bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _record_scan_shapes(scan_shapes if scan_shapes is not None else set()):
        model, history = train(config, device="cuda", dataset=dataset, log_fn=lambda line: None)
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
    want = _only(K1a=NGP_STEPS, K1b=NGP_STEPS, K2a=NGP_LEVELS * NGP_STEPS)
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


def summary(k, launches):
    errors, timing = k["errors"], k["timing"]
    scan_errors, scan_timing = k["scan_errors"], k["scan_timing"]

    def per_step(key, shapes):
        return sum(timing[f"{r}x{s}"][key] for r, s in shapes)

    def by_phase(kernel):
        return {phase: counts[kernel] for phase, counts in launches.items()}

    ngp = f"{NGP_K1_SHAPE[0]}x{NGP_K1_SHAPE[1]}"
    def on_path(kernel):
        return sum(launches[p][kernel] for p in ("train", "ngp_train", "kitti_mip",
                                                 "kitti_mip_resumed", "kitti_ngp", "nerfpp",
                                                 "bf16_mip16k", "bf16_flagship", "bf16_ngp",
                                                 "bf16_nerfpp", "priors_mip"))

    k1 = {"route": "cuda", "source": SOURCE, "library_ms": None,
          "work": "one mip train step: 2 x [4096, 64] + [4096, 32] float32",
          "launches_note": "mip and NGP train runs on the synthetic scene and the KITTI fixture, "
                           "float32 and bf16 (the 16k remat run launches K1a twice a level), "
                           "and mip on the port's own completion prior (phase priors)"}
    path = f"{SCAN_PATH[0]}x{SCAN_PATH[1]}"
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
                          "float32 and bf16",
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
    phase_device()
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
        kitti_launches, kitti_ngp_config, kitti_ngp = phase_kitti(root)
        launches.update(kitti_launches)
        launches.update(phase_nerfpp(root))
        launches.update(phase_bf16_nerfpp(root))
        launches.update(phase_ngp_eval(kitti_ngp_config, kitti_ngp))
        del kitti_ngp
        launches.update(phase_bf16_synthetic(train_ms_f32))
        launches.update(phase_priors(root))
    summary(k, launches)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
