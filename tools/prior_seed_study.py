"""How often the guided completion prior collapses, by initial-weight key,
in the reference package and in the PyTorch port from the same weights.

    python tools/prior_seed_study.py FIXTURE [out=PATH.jsonl] [first_key=0] [n_keys=8]
        [steps=400] [port=1]

FIXTURE is a KITTI fixture as `tools/make_kitti_fixture.py` (or the port's
`python -m outdoor_nerf_depth_torch.tools.make_kitti_fixture FIXTURE 30`)
writes it. The completion set is built from its `dtu_format` scene as
`tools/e2e_prior_loop.py` builds it (5% of the metric depth kept with
`default_rng(3)`), under `FIXTURE/seed_study`.

For each key k the reference package's `GuidedCompletionNet` is trained as
`train_prior.py complete` trains it (Adam 1e-3, batch 2, crop 64x192, masked
MSE + 0.01 smoothness, one batch drawn for the init), from
`jax.random.PRNGKey(k)`, on the CPU. With `port=1` the port's net starts
from the same weights (`params_from_flax`) and takes Adam steps (optax's
defaults) on the same batches, on the CPU too. Each net then writes its
prior PNGs with its own package's `generate_completion_priors`, scored as
`tools/e2e_prior_loop.py` scores them: the mean over views of the RMSE (m)
against the gt depth where both are positive (null when the prior has no
positive pixel), and the density. One JSON line per key goes to stdout and
is appended to `out`, with the loss every 50 steps.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402
import shutil  # noqa: E402


def _quality(pr_dir, gt_dir, load_image):
    import numpy as np

    errs, density = [], []
    for name in sorted(os.listdir(gt_dir)):
        gt = load_image(os.path.join(gt_dir, name)) / 256.0
        pr = load_image(os.path.join(pr_dir, name)) / 256.0
        m = (gt > 0) & (pr > 0)
        if m.any():
            errs.append(float(np.sqrt(np.mean((gt[m] - pr[m]) ** 2))))
        density.append(float((pr > 0).mean()))
    return {"prior_rmse_m": round(float(np.mean(errs)), 4) if errs else None,
            "prior_density": round(float(np.mean(density)), 4)}


def _build_data(scene, root, load_image, save_depth_u16):
    import numpy as np

    for sub in ("image", "sparse", "groundtruth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(3)
    for name in sorted(os.listdir(os.path.join(scene, "images"))):
        shutil.copyfile(os.path.join(scene, "images", name), os.path.join(root, "image", name))
        depth = load_image(os.path.join(scene, "depths_gt", name)) / 256.0
        keep = rng.uniform(size=depth.shape) < 0.05
        save_depth_u16(np.where(keep, depth, 0.0), os.path.join(root, "sparse", name))
        save_depth_u16(depth, os.path.join(root, "groundtruth", name))


def main(argv):
    fixture, kv = argv[0], dict(a.split("=", 1) for a in argv[1:])
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import optax

    from outdoor_nerf_depth_tpu.data.datasets import load_image
    from outdoor_nerf_depth_tpu.depth_priors import completion, datasets, generate
    from outdoor_nerf_depth_tpu.utils.image import save_depth_u16

    first, n_keys = int(kv.get("first_key", 0)), int(kv.get("n_keys", 8))
    steps, port = int(kv.get("steps", 400)), kv.get("port", "1") == "1"
    out = kv.get("out")
    work = os.path.join(fixture, "seed_study")
    root = os.path.join(work, "completion_data")
    _build_data(os.path.join(fixture, "dtu_format"), root, load_image, save_depth_u16)
    gt_dir = os.path.join(root, "groundtruth")

    model = completion.GuidedCompletionNet()
    tx = optax.adam(1e-3)

    def loss_fn(v, rgb, sparse, gt):
        pred = model.apply(v, rgb, sparse)
        return (completion.masked_depth_mse(pred, gt)
                + 0.01 * completion.edge_aware_smoothness(pred, rgb))

    @jax.jit
    def step(v, opt_state, *batch):
        loss, grads = jax.value_and_grad(loss_fn)(v, *batch)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(v, updates), opt_state, loss

    if port:
        import torch

        from outdoor_nerf_depth_torch import convert
        from outdoor_nerf_depth_torch.depth_priors import completion as t_completion
        from outdoor_nerf_depth_torch.depth_priors import generate as t_generate
        from outdoor_nerf_depth_torch.tools import train_prior as t_train_prior

    for key in range(first, first + n_keys):
        ds = datasets.CompletionDataset(root, crop=(64, 192))
        rgb, sparse, _ = ds.sample_batch(2)
        variables = jax.jit(model.init)(jax.random.PRNGKey(key), rgb, sparse)
        opt_state = tx.init(variables)
        runs = {"jax": {"loss_every_50": []}}
        if port:
            t_net = t_completion.GuidedCompletionNet()
            convert.params_from_flax(jax.device_get(variables), t_net)
            optimizer = t_train_prior.make_optimizer(t_net, 1e-3)
            t_loss = t_train_prior.completion_loss(t_net, 0.01)
            runs["port"] = {"loss_every_50": []}
        for i in range(steps):
            batch = ds.sample_batch(2)
            variables, opt_state, loss = step(variables, opt_state, *batch)
            losses = {"jax": float(loss)}
            if port:
                losses["port"] = float(t_train_prior.train_step(
                    optimizer, t_loss, tuple(torch.from_numpy(a) for a in batch)))
            for name, value in losses.items():
                if i % 50 == 0 or i == steps - 1:
                    runs[name]["loss_every_50"].append(round(value, 3))
                runs[name]["last_loss"] = value
        pr_dir = os.path.join(work, f"jax_key{key}")
        generate.generate_completion_priors(variables, os.path.join(root, "image"),
                                            os.path.join(root, "sparse"), pr_dir,
                                            log_fn=lambda s: None)
        runs["jax"].update(_quality(pr_dir, gt_dir, load_image))
        if port:
            pr_dir = os.path.join(work, f"port_key{key}")
            t_generate.generate_completion_priors(t_net.state_dict(), os.path.join(root, "image"),
                                                  os.path.join(root, "sparse"), pr_dir,
                                                  log_fn=lambda s: None, device="cpu")
            runs["port"].update(_quality(pr_dir, gt_dir, load_image))
        line = json.dumps({"key": key, "steps": steps, **runs})
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
