"""Scene-field models. Each `forward(rays, train_frac, compute_extras,
generator)` returns (renderings: list[dict], ray_history: list[dict]) with
the finest pass last, as in the reference package; `HashGridModel` also
takes the occupancy grid to march through."""

from outdoor_nerf_depth_torch.models.mipnerf360 import ProposalModel
from outdoor_nerf_depth_torch.models.nerfpp import InvertedSphereModel
from outdoor_nerf_depth_torch.models.ngp import HashGridModel


def build(name: str, **overrides):
    """Construct a model by name."""
    registry = {"mipnerf360": ProposalModel, "nerfpp": InvertedSphereModel,
                "ngp": HashGridModel}
    if name not in registry:
        raise ValueError(f"unknown model {name!r}; ported so far: {sorted(registry)}")
    return registry[name](**overrides)


__all__ = ["HashGridModel", "InvertedSphereModel", "ProposalModel", "build"]
