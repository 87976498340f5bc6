"""Scene-field models. Each `forward(rays, train_frac, compute_extras,
generator)` returns (renderings: list[dict], ray_history: list[dict]) with
the finest pass last, as in the reference package."""

from outdoor_nerf_depth_torch.models.mipnerf360 import ProposalModel


def build(name: str, **overrides):
    """Construct a model by name."""
    registry = {"mipnerf360": ProposalModel}
    if name not in registry:
        raise ValueError(f"unknown model {name!r}; ported so far: {sorted(registry)}")
    return registry[name](**overrides)


__all__ = ["ProposalModel", "build"]
