"""The yardstick's arithmetic: published peaks, field-MLP FLOPs from layer
shapes, the compositing and scan kernels' byte and operation bounds, and
the kernel classifier.

Copied from the repository's `chip_smoke.py` (`linear_flops`,
`KERNEL_KINDS`, the K1 and K2a bytes and operations per element) so a
change to the program cannot move them. Every count is worked out from the
configuration's shapes, never from the program's modules.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

# K1a (forward): read tau, write w and e; K1b (backward): read g, w, e, write dtau.
K1A_BYTES, K1A_OPS = 12, 5
K1B_BYTES, K1B_OPS = 16, 4
# K2a: read and write one float32 a row and lane.
K2A_BYTES, K2A_OPS = 8, 1

KERNEL_KINDS = (  # first match wins; names as the CUDA libraries and torch give them
    ("volren_weights", ("weights_fwd_kernel", "weights_bwd_kernel")),  # K1a, K1b
    ("prefix_scan", ("prefix_scan_",)),  # K2a, K2b
    ("collective", ("nccl",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "conv3d", "winograd",
                     "cudnn", "fft2d", "implicit_")),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "nvjet")),
    ("sort", ("sort", "radix")),
    ("scan", ("scan", "cumsum")),
    ("reduce", ("reduce",)),
    ("gather_scatter", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def bound_s(n_elements: int, bytes_per: int, ops_per: int) -> float:
    """Least time for an elementwise-streaming kernel: the larger of its
    bytes over HBM bandwidth and its operations over the float32 peak."""
    return max(n_elements * bytes_per / HBM_BYTES_PER_S,
               n_elements * ops_per / PEAK_FLOPS_PER_S["float32"])


def linear_flops(layers, n_points: int) -> int:
    """Multiply-add FLOPs of dense layers [(fan_in, fan_out)] on n_points inputs."""
    return sum(2 * n_points * fan_in * fan_out for fan_in, fan_out in layers)


def _basis_dirs(shape: str = "icosahedron", subdivisions: int = 2) -> int:
    """Number of directions of mip-NeRF 360's projection basis (icosahedron
    tessellated `subdivisions` times, antipodes removed)."""
    if shape != "icosahedron":
        raise ValueError(f"basis {shape!r} not counted")
    n_vertices = 10 * subdivisions**2 + 2
    return n_vertices // 2


def cone_mlp_layers(params: dict, is_prop: bool):
    """(fan_in, fan_out) of every dense layer of one mip-NeRF 360 field MLP."""
    depth = params.get("net_depth", 8)
    width = params.get("net_width", 256)
    skip = params.get("skip_layer", 4)
    deg_lo, deg_hi = params.get("min_deg_point", 0), params.get("max_deg_point", 12)
    enc = 2 * _basis_dirs(params.get("basis_shape", "icosahedron"),
                          params.get("basis_subdivisions", 2)) * (deg_hi - deg_lo)
    layers, x = [], enc
    for i in range(depth):
        layers.append((x, width))
        x = width + (enc if i % skip == 0 and i > 0 else 0)
    layers.append((x, 1))  # density head
    if is_prop:
        return layers
    bottleneck = params.get("bottleneck_width", 256)
    layers.append((x, bottleneck))
    deg_view = params.get("deg_view", 4)
    y = bottleneck + 3 + 6 * deg_view
    for i in range(params.get("net_depth_viewdirs", 1)):
        width_v = params.get("net_width_viewdirs", 128)
        layers.append((y, width_v))
        y = width_v
    layers.append((y, 3))
    return layers


def mip_train_flops(model_params: dict, batch: int) -> float:
    """Dense-layer FLOPs of one mip-NeRF 360 train step: forward on every
    level's samples, backward twice the forward for every layer but each
    MLP's first (its input, the encoding, needs no gradient)."""
    total = 0.0
    levels = model_params.get("num_levels", 3)
    for level in range(levels):
        is_prop = level < levels - 1
        samples = model_params["num_prop_samples" if is_prop else "num_nerf_samples"]
        mlp = model_params.get("prop_mlp_params" if is_prop else "nerf_mlp_params") or {}
        layers = cone_mlp_layers(mlp, is_prop)
        fwd = linear_flops(layers, batch * samples)
        first = linear_flops(layers[:1], batch * samples)
        total += 3 * fwd - first
    return total


def ngp_field_layers(field_params: dict):
    levels = field_params.get("n_levels", 16)
    feats = field_params.get("n_features", 2)
    hidden = field_params.get("hidden_width", 64)
    geo = field_params.get("geo_features", 15)
    layers = [(levels * feats, hidden), (hidden, 1 + geo)]
    y = 16 + geo
    for _ in range(field_params.get("rgb_hidden_layers", 2)):
        layers.append((y, hidden))
        y = hidden
    layers.append((y, 3))
    return layers


def ngp_train_flops(model_params: dict, batch: int, samples_per_ray: float) -> float:
    """Dense-layer FLOPs of one NGP train step on `samples_per_ray` field
    points a ray (the step's rendered samples, capped by the budget):
    forward, and backward twice the forward (the hash features take a
    gradient, so the first layer's input does too)."""
    budget = model_params.get("sample_budget", 0)
    max_samples = model_params.get("max_samples", 128)
    cap = budget if 0 < budget < max_samples else max_samples
    points = batch * min(samples_per_ray, cap)
    return 3 * linear_flops(ngp_field_layers(model_params.get("field_params") or {}), 1) * points


def mip_volren_bound_s(model_params: dict, batch: int) -> float:
    """Least time of one mip step's K1a and K1b launches: one of each a level."""
    levels = model_params.get("num_levels", 3)
    total = 0.0
    for level in range(levels):
        samples = model_params["num_prop_samples" if level < levels - 1 else "num_nerf_samples"]
        n = batch * samples
        total += bound_s(n, K1A_BYTES, K1A_OPS) + bound_s(n, K1B_BYTES, K1B_OPS)
    return total


def ngp_scan_bound_s(model_params: dict, batch: int) -> float:
    """Least time of one osplit NGP step's K2a launches: one a level over
    [field points, 8 corners x features]."""
    field = model_params.get("field_params") or {}
    budget = model_params.get("sample_budget", 0)
    max_samples = model_params.get("max_samples", 128)
    points = batch * (budget if 0 < budget < max_samples else max_samples)
    lanes = 8 * field.get("n_features", 2)
    return field.get("n_levels", 16) * bound_s(points * lanes, K2A_BYTES, K2A_OPS)


