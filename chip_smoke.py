"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each printing one JSON line; any failure raises and the run exits
non-zero without the final line:

  device   CUDA must be present; the card's name and power limit
  build    nvcc builds every CUDA source of the port into build/
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes of the main path and at edge cases; times from CUDA events
  train    the port's own train() on the flagship config
           (configs/kitti_mipnerf360.json, full widths, batch 4096, float32)
           on the synthetic scene of 8 images of 94x310, for a few steps;
           every kernel of the path must have been launched
  render   render_image() of one 94x310 test view in chunks of 16384 rays,
           held against the same model on the CPU for a few rays
  profile  two more train steps under torch.profiler: device time per step
           by kernel and by kind, and the share of the step the card is busy

then the kernel summary, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

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
from outdoor_nerf_depth_torch.data import rays as rays_lib  # noqa: E402
from outdoor_nerf_depth_torch.ops import cuda_build, volren_weights  # noqa: E402
from outdoor_nerf_depth_torch.train import step as step_lib  # noqa: E402
from outdoor_nerf_depth_torch.train.config import load_config  # noqa: E402
from outdoor_nerf_depth_torch.train.loop import set_full_float32, train  # noqa: E402

CONFIG = "configs/kitti_mipnerf360.json"
STEPS = 6
N_IMAGES, HEIGHT, WIDTH = 8, 94, 310  # the synthetic scene of the mip_4096 shape
# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds below.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
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
REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "outdoor_nerf_depth_torch/csrc/volren_weights.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(shape, bytes_per, ops_per):
    n = shape[0] * shape[1]
    return 1e3 * max(n * bytes_per / HBM_BYTES_PER_S, n * ops_per / FP32_FLOPS_PER_S)


def mlp_forward_flops(model, n_rays):
    """Multiply-add FLOPs of every field-MLP layer for one forward of n_rays
    (each prop level runs prop_mlp on num_prop_samples, the last level
    nerf_mlp on num_nerf_samples)."""
    levels = [(model.prop_mlp, model.num_prop_samples)] * (model.num_levels - 1)
    levels.append((model.nerf_mlp, model.num_nerf_samples))
    return sum(
        2 * n_rays * samples * layer.in_features * layer.out_features
        for mlp, samples in levels
        for layer in mlp.modules()
        if isinstance(layer, torch.nn.Linear)
    )


def device_ms(fn, launches=50, reps=5):
    """Median device time of one call: `launches` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    reports = cuda_build.build([volren_weights.SOURCE])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(cuda_build.library_path(volren_weights.SOURCE), REPO)],
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


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda shape: 2.0 * torch.rand(shape, generator=gen, device="cuda")
    randn = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    cases = {f"{r}x{s}": rand((r, s)) for r, s in
             [(4096, 64), (4096, 32), (16384, 32), (16384, 64), (7, 33), (130, 192)]}
    saturated = rand((256, 32))
    saturated[:, :4] = 10.0  # an opaque wall: later weights and gradients ~0
    cases["saturated_256x32"] = saturated
    opaque = rand((256, 64))
    opaque[:, -1] = float("inf")  # opaque background
    cases["inf_last_256x64"] = opaque
    errors = {name: _check_pair(tau, randn(tau.shape)) for name, tau in cases.items()}

    timing = {}
    for shape in sorted(set(TRAIN_SHAPES + [RENDER_SHAPE])):
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
    emit({"phase": "kernels",
          "max_abs_err": {k: {"fwd": f, "bwd": b} for k, (f, b) in errors.items()},
          "tolerance": {"fwd": FWD_ATOL, "bwd": BWD_ATOL},
          "timing": timing,
          "timing_method": "device time per call: 50 calls in a CUDA graph, median of 5 replays",
          "library_ms": None,
          "library_note": "no single PyTorch call computes compositing weights from optical depth"})
    return errors, timing


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


def phase_train(exp_dir):
    config = _flagship_config(exp_dir)
    dataset = datasets_lib.SyntheticDataset(
        "train", global_batch_size=config.batch_size, n_images=N_IMAGES,
        height=HEIGHT, width=WIDTH, seed=0,
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    volren_weights.reset_launch_counts()
    t0 = time.perf_counter()
    model, history = train(config, device="cuda", dataset=dataset, log_fn=lambda line: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fwd": volren_weights.FWD_LAUNCHES, "bwd": volren_weights.BWD_LAUNCHES}
    if launches != {"fwd": 3 * STEPS, "bwd": 3 * STEPS}:
        raise AssertionError(f"expected 3 K1a and 3 K1b launches per step, got {launches}")
    if len(history) != STEPS:
        raise AssertionError(f"expected {STEPS} logged steps, got {len(history)}")
    for entry in history:
        losses = {k: v for k, v in entry.items() if k.startswith("loss")}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite loss at step {entry['step']}: {losses}")
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
    return config, model, launches


def phase_render(config, model):
    test = datasets_lib.SyntheticDataset(
        "test", global_batch_size=config.batch_size, n_images=N_IMAGES,
        height=HEIGHT, width=WIDTH, seed=0,
    )
    batch = test.image_batch(0)
    n_rays = HEIGHT * WIDTH
    chunks = math.ceil(n_rays / config.render_chunk_size)
    times = []
    for i in range(3):
        if i == 0:
            volren_weights.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_lib.render_image(model, batch, config.render_chunk_size, "cuda")
        times.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            launches = {"fwd": volren_weights.FWD_LAUNCHES, "bwd": volren_weights.BWD_LAUNCHES}
            if launches != {"fwd": 3 * chunks, "bwd": 0}:
                raise AssertionError(f"expected {3 * chunks} K1a launches, got {launches}")
    for key, shape in (("rgb", (HEIGHT, WIDTH, 3)), ("distance_mean", (HEIGHT, WIDTH))):
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{key}: shape {out[key].shape} or non-finite values")

    # The same weights on the CPU (plain versions of every kernel) for a
    # few rays. Float32 matmuls of width 1024 sum in another order on the
    # card, and resampling passes that on: 1e-3 of slack on rgb in [0, 1],
    # relative 1e-3 on distances.
    n_ref = 128
    sub = rays_lib.map_fields(
        lambda r: r.reshape((n_rays,) + r.shape[2:])[:n_ref].reshape((1, n_ref) + r.shape[2:]),
        batch,
    )
    gpu = step_lib.render_image(model, sub, config.render_chunk_size, "cuda")
    cpu = step_lib.render_image(copy.deepcopy(model).cpu(), sub, config.render_chunk_size, "cpu")
    rgb_err = float(np.abs(gpu["rgb"] - cpu["rgb"]).max())
    dist_err = float(np.max(np.abs(gpu["distance_mean"] - cpu["distance_mean"])
                            / np.abs(cpu["distance_mean"])))
    if rgb_err > 1e-3 or dist_err > 1e-3:
        raise AssertionError(f"GPU render disagrees with CPU: rgb {rgb_err}, distance {dist_err}")
    emit({"phase": "render", "rays": n_rays, "chunk": config.render_chunk_size, "chunks": chunks,
          "ms": times, "median_ms": statistics.median(times), "launches": launches,
          "mlp_tflop": mlp_forward_flops(model, n_rays) / 1e12,
          "mlp_tflop_per_s": mlp_forward_flops(model, n_rays) / 1e12 / (statistics.median(times) / 1e3),
          "rgb_mean": float(out["rgb"].mean()),
          "distance_mean_median": float(np.median(out["distance_mean"])),
          "cpu_reference": {"rays": n_ref, "rgb_max_abs_err": rgb_err,
                            "distance_mean_max_rel_err": dist_err}})
    return launches


KERNEL_KINDS = (  # first match wins; names as the CUDA libraries and torch give them
    ("volren_weights", ("weights_fwd_kernel", "weights_bwd_kernel")),  # K1a, K1b
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "sm80_")),
    ("sort", ("sort", "radix")),
    ("scan", ("scan", "cumsum")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _kind(name):
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def phase_profile(config, model, steps=2):
    dataset = datasets_lib.SyntheticDataset(
        "train", global_batch_size=config.batch_size, n_images=N_IMAGES,
        height=HEIGHT, width=WIDTH, seed=1,
    )
    optimizer, lr_fn = step_lib.make_optimizer(config, model)
    train_step = step_lib.make_train_step(config, model, optimizer, lr_fn,
                                          cameras=dataset.cameras_on("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [rays_lib.to_device(dataset.sample_batch(), "cuda") for _ in range(steps + 1)]
    train_step(batches[0], 0, 0.5, gen)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            train_step(batches[i + 1], i + 1, 0.5, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    by_kind = {}
    for e in kernels:
        kind = _kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3 / steps
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    matmul_tflop = 3 * mlp_forward_flops(model, config.batch_size) / 1e12
    emit({"phase": "profile", "steps": steps, "wall_ms_per_step": wall_ms,
          "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
          "matmul_tflop_per_s_while_running": matmul_tflop / (by_kind.get("matmul", 0.0) / 1e3)
          if by_kind.get("matmul") else None,
          "device_ms_per_step_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
          "device_share_by_kind": {k: v / device_ms for k, v in by_kind.items()},
          "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
          "top_kernels": [{"name": e.key[:120], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                           "calls_per_step": e.count / steps} for e in top]})


def summary(errors, timing, train_launches, render_launches):
    def per_step(key):
        return sum(timing[f"{r}x{s}"][key] for r, s in TRAIN_SHAPES)

    common = {"route": "cuda", "source": SOURCE, "library_ms": None,
              "work": "one train step: 2 x [4096, 64] + [4096, 32] float32"}
    kernels = [
        dict(common, name="K1a volren_weights_fwd",
             replaces="outdoor_nerf_depth_tpu/ops/pallas_volren.py:54",
             launches=train_launches["fwd"],
             launches_by_phase={"train": train_launches["fwd"], "render": render_launches["fwd"]},
             max_abs_err=max(f for f, _ in errors.values()),
             ms=per_step("fwd_ms"), plain_ms=per_step("fwd_plain_ms"),
             bound_ms=per_step("fwd_bound_ms"), bound_by="bytes"),
        dict(common, name="K1b volren_weights_bwd",
             replaces="outdoor_nerf_depth_tpu/ops/pallas_volren.py:72",
             launches=train_launches["bwd"],
             launches_by_phase={"train": train_launches["bwd"], "render": render_launches["bwd"]},
             max_abs_err=max(b for _, b in errors.values()),
             ms=per_step("bwd_ms"), plain_ms=per_step("bwd_plain_ms"),
             bound_ms=per_step("bwd_bound_ms"), bound_by="bytes"),
    ]
    emit({"kernels": kernels})


def main():
    phase_device()
    phase_build()
    errors, timing = phase_kernels()
    with tempfile.TemporaryDirectory() as exp_dir:
        config, model, train_launches = phase_train(exp_dir)
    render_launches = phase_render(config, model)
    phase_profile(config, model)
    summary(errors, timing, train_launches, render_launches)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
