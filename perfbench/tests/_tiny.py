"""Tiny sizes for running cells on the CPU: the harness's look for a card is
skipped (`harness.execute` with device "cpu") and the rest of a run is driven."""

import time

from perfbench import harness

TINY = {
    "mip360_kitti": {"model_params": {
        "num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 3, "raydist_fn": "reciprocal",
        "opaque_background": True, "single_jitter": True,
        "nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8,
                            "net_width_viewdirs": 8, "max_deg_point": 4},
        "prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}},
        "batch_size": 64},
    "ngp_kitti": {"model_params": {
        "scale": 8.0, "max_samples": 16, "n_candidates": 64, "grid_resolution": 16,
        "sample_budget": 8, "field_params": {"n_levels": 2, "log2_table_size": 10,
                                             "base_resolution": 4, "max_resolution": 16,
                                             "hidden_width": 16, "geo_features": 7}},
        "batch_size": 64, "occupancy_warmup_steps": 4, "occupancy_update_every": 4,
        "render_chunk_size": 96},
}
SCENE = {"height": 24, "width": 40, "n_views": 20, "focal": 23.0, "cx": 20.0, "cy": 12.0}
TRAFFIC = {
    "train": {"warmup_steps": 4, "print_every": 2, "trace_steps": 4},
    "train_group": {"warmup_steps": 4, "print_every": 2, "trace_steps": 4},
    "view": {"warmup_train_steps": 4, "height": 12, "width": 16, "check_views": 2,
             "trace_views": 3, "warmup_views": 1, "pose_pool": 4},
}
# A cell that follows past the grid's warm-up: through the tiny grid's first sampled refresh.
TRAFFIC_BY_CELL = {"ngp_kitti.train": {"follow_steps": 5, "warmup_steps": 6}}


harness.prepare_process()


def tiny_run(workload, cache_root, seed=3_000_000_019, seconds=1.0, trace=False, root=None,
             control=False):
    root = root or harness.ROOT
    cell = harness.load_cell(workload, root)
    config = cell.config["name"]
    tiny = next(v for k, v in TINY.items() if config.startswith(k.split("_")[0]))
    return harness.Run(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                       cache_root=str(cache_root), root=root, program_overrides=tiny,
                       scene_overrides=SCENE,
                       traffic_overrides=dict(TRAFFIC[cell.traffic["driver"]],
                                              **TRAFFIC_BY_CELL.get(workload, {})),
                       control=control)
