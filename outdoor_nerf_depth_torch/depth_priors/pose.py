"""Self-supervised pose branch for depth completion (std2019-style).

Port of the reference package's `depth_priors/pose.py`, without OpenCV.
The relative pose between the current frame and a temporally nearby one is
estimated on the host by feature matching and PnP-RANSAC against the sparse
LiDAR depth; the nearby RGB frame is then inverse-warped into the current
view through the *predicted* dense depth, and an L1 photometric loss closes
the loop.

Host side (numpy, in the input pipeline):

* `rgb_to_gray_u8`, the 4x4 dilation of the sparse depth (`dilate_depth`,
  OpenCV's `dilate` with its anchor at (2, 2)) and the Rodrigues formulas
  (`rodrigues`, `rodrigues_vector`) are computed as the reference's OpenCV
  calls compute them.
* `match_features` is an ORB-style detector and matcher of the port's own,
  held to the reference's contract, not to its bits: FAST-9 corners at
  threshold 20 kept by their Harris response over a pyramid of 8 levels at
  scale 1.2, each oriented by its intensity centroid and described by 256
  steered binary tests on the blurred patch, then brute-force Hamming 2-NN
  matching with Lowe's ratio test. OpenCV's learned test pattern is not in
  the repository: the port draws its pattern once from a fixed seed.
* `solve_pnp_ransac` runs EPnP on random 5-point samples inside RANSAC at
  OpenCV's defaults (100 iterations at most, 8 px reprojection error,
  confidence 0.99), then refines on the inliers with Levenberg-Marquardt,
  as `SOLVEPNP_ITERATIVE` does. RANSAC draws from a numpy generator of its
  own, seeded per call, never from a dataset's.

Device side (torch, differentiable w.r.t. the predicted depth, on the
inputs' device): `bilinear_sample`, `inverse_warp` and `multiscale`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

# ORB's defaults (OpenCV `ORB_create`): FAST threshold, pyramid, borders.
FAST_THRESHOLD = 20
SCALE_FACTOR = 1.2
N_LEVELS = 8
EDGE_THRESHOLD = 31  # keypoints closer than this to a level's border are dropped
HALF_PATCH = 15  # the orientation patch's radius (patch size 31)
HARRIS_BLOCK, HARRIS_K = 7, 0.04
N_BITS = 256
# The binary tests: pairs of points from an isotropic normal of standard
# deviation patch / 5 (BRIEF's G II), kept within radius 13 so that a
# rotated test stays inside the patch. Drawn once from this seed.
PATTERN_SEED = 20160601
PATTERN_RADIUS = 13.0
# PnP-RANSAC: OpenCV's solvePnPRansac defaults, and the seed of its draws.
RANSAC_ITERATIONS, RANSAC_REPROJ_ERROR, RANSAC_CONFIDENCE = 100, 8.0, 0.99
RANSAC_SEED = 0
LM_ITERATIONS = 20

# FAST's Bresenham circle of radius 3, (dx, dy), in order around the circle.
_CIRCLE = np.array([(0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
                    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3)])


def _draw_pattern() -> np.ndarray:
    rng = np.random.default_rng(PATTERN_SEED)
    pts = []
    while len(pts) < 2 * N_BITS:
        p = rng.normal(0.0, 31.0 / 5.0, 2)
        if p @ p <= PATTERN_RADIUS**2:
            pts.append(p)
    return np.asarray(pts).reshape(N_BITS, 2, 2)  # [bit, point, (x, y)]


PATTERN = _draw_pattern()


# --------------------------------------------------------------------------
# Host-side pose estimation (input pipeline; numpy).
# --------------------------------------------------------------------------


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """float [0,1] or uint8 RGB -> uint8 luma (truncated, as the reference)."""
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0, 0, 255)
    return (rgb[..., :3] @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)


def dilate_depth(depth: np.ndarray) -> np.ndarray:
    """`cv2.dilate(depth, np.ones((4, 4)))`: the anchor is (2, 2), so
    out[y, x] = max of depth[y + dy, x + dx] for dy, dx in {-2, -1, 0, 1};
    cells outside the image are ignored."""
    depth = np.asarray(depth, np.float32)
    h, w = depth.shape
    padded = np.full((h + 3, w + 3), -np.inf, np.float32)
    padded[2:h + 2, 2:w + 2] = depth
    out = np.full((h, w), -np.inf, np.float32)
    for dy in range(4):
        for dx in range(4):
            np.maximum(out, padded[dy:dy + h, dx:dx + w], out=out)
    return out


def _resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resize with half-pixel centres, rounded to uint8."""
    h, w = img.shape

    def axis(n_out, n_in):
        src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (src - lo)

    y0, y1, fy = axis(height, h)
    x0, x1, fx = axis(width, w)
    f = img.astype(np.float64)
    top = f[y0][:, x0] * (1 - fx) + f[y0][:, x1] * fx
    bot = f[y1][:, x0] * (1 - fx) + f[y1][:, x1] * fx
    out = top * (1 - fy)[:, None] + bot * fy[:, None]
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def _gaussian_blur7(img: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """7x7 Gaussian blur (separable), borders reflected without the edge."""
    k = np.exp(-0.5 * (np.arange(-3, 4) / sigma) ** 2)
    k /= k.sum()
    f = np.pad(img.astype(np.float64), 3, mode="reflect")
    h, w = img.shape
    rows = sum(k[i] * f[:, i:i + w] for i in range(7))
    out = sum(k[i] * rows[i:i + h] for i in range(7))
    return np.floor(out + 0.5).astype(np.float32)


def _fast_corners(img: np.ndarray, threshold: int):
    """FAST-9 corners with 3x3 non-maximum suppression on the FAST score:
    (ys, xs, scores) of pixels with 9 contiguous circle pixels all brighter
    than centre + threshold or all darker than centre - threshold."""
    h, w = img.shape
    if h < 7 or w < 7:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)
    f = img.astype(np.int16)
    c = f[3:h - 3, 3:w - 3]

    def ring(k):
        dx, dy = _CIRCLE[k]
        return f[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] - c

    # Every arc of 9 holds two of the four compass points 0, 4, 8 and 12:
    # only pixels with two of them past the threshold can be corners.
    compass = np.stack([ring(k) for k in (0, 4, 8, 12)])
    candidate = ((compass > threshold).sum(0) >= 2) | ((compass < -threshold).sum(0) >= 2)
    ys, xs = np.nonzero(candidate)
    d = (f[ys[:, None] + 3 + _CIRCLE[None, :, 1], xs[:, None] + 3 + _CIRCLE[None, :, 0]]
         - f[ys + 3, xs + 3][:, None]).astype(np.int32)  # [n, 16]

    def arc_min(x):  # [n, 16] -> the minimum over each arc of 9, by doubling
        m = np.minimum(x, np.roll(x, -1, 1))
        m = np.minimum(m, np.roll(m, -2, 1))
        m = np.minimum(m, np.roll(m, -4, 1))
        return np.minimum(m, np.roll(x, -8, 1))

    # Score: the largest threshold at which the pixel is still a corner.
    score = np.maximum(arc_min(d), arc_min(-d)).max(-1) - 1
    corner = score >= threshold
    ys, xs, score = ys[corner], xs[corner], score[corner]
    score_map = np.zeros((h, w), np.int32)
    score_map[ys + 3, xs + 3] = score
    keep = np.ones(len(ys), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= score > score_map[ys + 3 + dy, xs + 3 + dx]
    return ys[keep] + 3, xs[keep] + 3, score[keep].astype(np.float64)


def _harris(img: np.ndarray, ys, xs) -> np.ndarray:
    """Harris response over a 7x7 block of 3x3 Sobel derivatives."""
    f = img.astype(np.int64)
    ix = np.zeros_like(f)
    iy = np.zeros_like(f)
    ix[1:-1, 1:-1] = (2 * (f[1:-1, 2:] - f[1:-1, :-2]) + (f[:-2, 2:] - f[:-2, :-2])
                      + (f[2:, 2:] - f[2:, :-2]))
    iy[1:-1, 1:-1] = (2 * (f[2:, 1:-1] - f[:-2, 1:-1]) + (f[2:, :-2] - f[:-2, :-2])
                      + (f[2:, 2:] - f[:-2, 2:]))
    r = HARRIS_BLOCK // 2
    offs = np.arange(-r, r + 1)
    yy = ys[:, None, None] + offs[None, :, None]
    xx = xs[:, None, None] + offs[None, None, :]
    gx, gy = ix[yy, xx].astype(np.float64), iy[yy, xx].astype(np.float64)
    a, b, c = (gx * gx).sum((1, 2)), (gy * gy).sum((1, 2)), (gx * gy).sum((1, 2))
    return a * b - c * c - HARRIS_K * (a + b) ** 2


_PATCH_V, _PATCH_U = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
_PATCH_DISK = _PATCH_U**2 + _PATCH_V**2 <= HALF_PATCH**2


def _ic_angle(img: np.ndarray, ys, xs) -> np.ndarray:
    """Orientation (radians) of the intensity centroid over the disk of
    radius 15 around each keypoint."""
    patch = img[ys[:, None, None] + _PATCH_V[None], xs[:, None, None] + _PATCH_U[None]]
    patch = patch.astype(np.float64) * _PATCH_DISK[None]
    m10 = (patch * _PATCH_U[None]).sum((1, 2))
    m01 = (patch * _PATCH_V[None]).sum((1, 2))
    return np.arctan2(m01, m10)


def _describe(blurred: np.ndarray, ys, xs, angles) -> np.ndarray:
    """256 steered binary tests a keypoint: [n, 256] bool."""
    a, b = np.cos(angles)[:, None, None], np.sin(angles)[:, None, None]
    px, py = PATTERN[None, :, :, 0], PATTERN[None, :, :, 1]  # [1, 256, 2]
    rx = np.floor(px * a - py * b + 0.5).astype(np.int64)
    ry = np.floor(px * b + py * a + 0.5).astype(np.int64)
    vals = blurred[ys[:, None, None] + ry, xs[:, None, None] + rx]  # [n, 256, 2]
    return vals[..., 0] < vals[..., 1]


def _features_per_level(n_features: int):
    factor = 1.0 / SCALE_FACTOR
    per = n_features * (1 - factor) / (1 - factor**N_LEVELS)
    counts = []
    for _ in range(N_LEVELS - 1):
        counts.append(int(round(per)))
        per *= factor
    counts.append(max(n_features - sum(counts), 0))
    return counts


def detect_and_describe(gray: np.ndarray, max_features: int = 1000):
    """ORB-style keypoints and descriptors of a uint8 image: (points [n, 2]
    as float (x, y) at full resolution, descriptors [n, 256] bool)."""
    counts = _features_per_level(max_features)
    level = np.asarray(gray, np.uint8)
    points, descriptors = [], []
    h0, w0 = level.shape
    for lvl in range(N_LEVELS):
        scale = SCALE_FACTOR**lvl
        if lvl > 0:
            level = _resize_linear_u8(level, int(round(w0 / scale)), int(round(h0 / scale)))
        h, w = level.shape
        if h <= 2 * EDGE_THRESHOLD or w <= 2 * EDGE_THRESHOLD or counts[lvl] == 0:
            continue
        ys, xs, score = _fast_corners(level, FAST_THRESHOLD)
        inside = ((xs >= EDGE_THRESHOLD) & (xs < w - EDGE_THRESHOLD)
                  & (ys >= EDGE_THRESHOLD) & (ys < h - EDGE_THRESHOLD))
        ys, xs, score = ys[inside], xs[inside], score[inside]
        # FAST's best 2n, then Harris's best n.
        best = np.argsort(-score, kind="stable")[:2 * counts[lvl]]
        ys, xs = ys[best], xs[best]
        best = np.argsort(-_harris(level, ys, xs), kind="stable")[:counts[lvl]]
        ys, xs = ys[best], xs[best]
        if len(ys) == 0:
            continue
        angles = _ic_angle(level, ys, xs)
        descriptors.append(_describe(_gaussian_blur7(level), ys, xs, angles))
        points.append(np.stack([xs, ys], -1).astype(np.float64) * scale)
    if not points:
        return np.zeros((0, 2)), np.zeros((0, N_BITS), bool)
    return np.concatenate(points), np.concatenate(descriptors)


def hamming_distances(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """[n1, n2] Hamming distances of bool descriptors, by a +-1 matmul."""
    s1 = np.where(d1, 1.0, -1.0)
    s2 = np.where(d2, 1.0, -1.0)
    return np.rint((N_BITS - s1 @ s2.T) / 2).astype(np.int64)


def match_features(
    gray1: np.ndarray,
    gray2: np.ndarray,
    max_features: int = 1000,
    ratio: float = 0.8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Keypoint matching with Lowe's ratio test.

    Returns (pts1 [M,2], pts2 [M,2]) integer pixel coordinates (x, y),
    truncated as the reference's `np.int32` of OpenCV keypoints.
    """
    empty = np.zeros((0, 2), np.int32), np.zeros((0, 2), np.int32)
    p1, d1 = detect_and_describe(gray1, max_features)
    p2, d2 = detect_and_describe(gray2, max_features)
    if len(p1) < 2 or len(p2) < 2:
        return empty
    dist = hamming_distances(d1, d2)
    order = np.argsort(dist, axis=1, kind="stable")[:, :2]
    rows = np.arange(len(p1))
    best, second = dist[rows, order[:, 0]], dist[rows, order[:, 1]]
    good = best < ratio * second
    if not good.any():
        return empty
    return np.int32(p1[good]), np.int32(p2[order[good, 0]])


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation vector [3] -> rotation matrix [3, 3] (float64)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    k = r / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    c, s = math.cos(theta), math.sin(theta)
    return c * np.eye(3) + (1 - c) * np.outer(k, k) + s * kx


def rodrigues_vector(R: np.ndarray) -> np.ndarray:
    """Rotation matrix [3, 3] -> rotation vector [3] (float64), after
    projecting R onto the rotations by SVD, as OpenCV does."""
    u, _, vt = np.linalg.svd(np.asarray(R, np.float64))
    R = u @ vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = math.sqrt(float(r @ r) * 0.25)
    c = min(max((np.trace(R) - 1) * 0.5, -1.0), 1.0)
    theta = math.acos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        # theta near pi: the axis from the diagonal of (R + I) / 2.
        t = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.maximum(np.diag(t), 0.0))
        if t[0, 1] < 0:
            axis[1] = -axis[1]
        if t[0, 2] < 0:
            axis[2] = -axis[2]
        if abs(axis[0]) < abs(axis[1]) and abs(axis[0]) < abs(axis[2]) \
                and (t[1, 2] > 0) != (axis[1] * axis[2] > 0):
            axis[2] = -axis[2]
        return axis / np.linalg.norm(axis) * theta
    return r * (theta / (2 * s))


def _project(X, R, t, K):
    """Pixel projections [n, 2] of world points X [n, 3] under (R, t)."""
    Xc = X @ R.T + t
    return np.stack([K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2],
                     K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]], -1)


def _sq_errors(X, uv, R, t, K):
    return ((_project(X, R, t, K) - uv) ** 2).sum(-1)


def _rigid(A, B):
    """(R, t) minimising |R A_i + t - B_i| (Umeyama without scale)."""
    ca, cb = A.mean(0), B.mean(0)
    u, _, vt = np.linalg.svd((B - cb).T @ (A - ca))
    d = np.sign(np.linalg.det(u @ vt))
    R = u @ np.diag([1.0, 1.0, d]) @ vt
    return R, cb - R @ ca


def _betas(L, rho, n_kernel):
    """Candidate kernel weights for EPnP: the linearised approximations
    with 1, 2 and 3 kernel vectors, each then refined by Gauss-Newton on
    the control-point distance constraints."""
    cands = []
    # Columns of L: b11, b12, b22, b13, b23, b33, b14, b24, b34, b44.
    b11 = L[:, 0] @ rho / max(L[:, 0] @ L[:, 0], 1e-300)
    cands.append(np.array([math.sqrt(abs(b11))]))
    if n_kernel >= 2:
        b = np.linalg.lstsq(L[:, :3], rho, rcond=None)[0]
        b1, b2 = math.sqrt(abs(b[0])), math.sqrt(abs(b[2]))
        cands.append(np.array([b1, math.copysign(b2, b[1])]))
    if n_kernel >= 3 and L.shape[0] >= 5:
        b = np.linalg.lstsq(L[:, :5], rho, rcond=None)[0]
        b1 = math.sqrt(abs(b[0]))
        b2 = math.copysign(math.sqrt(abs(b[2])), b[1])
        b3 = b[3] / b1 if b1 > 0 else 0.0
        cands.append(np.array([b1, b2, b3]))
    out = []
    pairs = [(i, j) for j in range(n_kernel) for i in range(j + 1)]
    col = {p: k for k, p in enumerate([(0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
                                       (0, 3), (1, 3), (2, 3), (3, 3)])}
    cols = [col[p] for p in pairs]
    for beta0 in cands:
        beta = np.zeros(n_kernel)
        beta[:len(beta0)] = beta0
        for _ in range(5):
            # rho_hat = sum over pairs of L[:, (i, j)] * b_i * b_j.
            prod = np.array([beta[i] * beta[j] for i, j in pairs])
            resid = L[:, cols] @ prod - rho
            J = np.zeros((L.shape[0], n_kernel))
            for c, (i, j) in zip(cols, pairs):
                J[:, i] += L[:, c] * beta[j]
                J[:, j] += L[:, c] * beta[i]
            beta = beta - np.linalg.lstsq(J, resid, rcond=None)[0]
        out.append(beta)
    return out


def _epnp_control(X, uv, K, n_ctrl):
    """EPnP with `n_ctrl` control points (4, or 3 for planar points):
    candidate (R, t) solutions."""
    n = len(X)
    c0 = X.mean(0)
    evals, evecs = np.linalg.eigh((X - c0).T @ (X - c0))
    order = np.argsort(-evals)
    axes = [math.sqrt(max(evals[i], 0.0) / n) * evecs[:, i] for i in order[:n_ctrl - 1]]
    C = np.stack([c0] + [c0 + a for a in axes])  # [n_ctrl, 3]
    alphas_rest = (X - c0) @ np.linalg.pinv(C[1:] - c0)
    alphas = np.concatenate([1 - alphas_rest.sum(1, keepdims=True), alphas_rest], 1)
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    M = np.zeros((2 * n, 3 * n_ctrl))
    M[0::2, 0::3] = alphas * fu
    M[0::2, 2::3] = alphas * (uc - uv[:, :1])
    M[1::2, 1::3] = alphas * fv
    M[1::2, 2::3] = alphas * (vc - uv[:, 1:])
    _, vecs = np.linalg.eigh(M.T @ M)
    n_kernel = min(4, n_ctrl)
    V = [vecs[:, k].reshape(n_ctrl, 3) for k in range(n_kernel)]  # smallest first
    pairs = [(a, b) for a in range(n_ctrl) for b in range(a + 1, n_ctrl)]
    rho = np.array([np.sum((C[a] - C[b]) ** 2) for a, b in pairs])
    dv = [np.stack([v[a] - v[b] for a, b in pairs]) for v in V]  # [pairs, 3] each
    L = np.zeros((len(pairs), 10))
    for c, (i, j) in enumerate([(0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
                                (0, 3), (1, 3), (2, 3), (3, 3)]):
        if j < n_kernel:
            L[:, c] = (1 if i == j else 2) * (dv[i] * dv[j]).sum(1)
    sols = []
    for beta in _betas(L, rho, n_kernel):
        Cc = sum(b * v for b, v in zip(beta, V))
        Xc = alphas @ Cc
        if Xc[:, 2].mean() < 0:
            Xc = -Xc
        if not np.isfinite(Xc).all():
            continue
        sols.append(_rigid(X, Xc))
    return sols


def epnp(X: np.ndarray, uv: np.ndarray, K: np.ndarray):
    """(R, t) of the least reprojection error among EPnP's candidates, or
    None; X [n, 3] world points, uv [n, 2] pixels, n >= 4."""
    X, uv, K = (np.asarray(a, np.float64) for a in (X, uv, K))
    evals = np.linalg.eigvalsh((X - X.mean(0)).T @ (X - X.mean(0)))
    if evals[-1] <= 0:
        return None
    sols = []
    if evals[0] > 1e-12 * evals[-1]:
        sols += _epnp_control(X, uv, K, 4)
    if evals[0] < 1e-2 * evals[-1]:  # planar or nearly so: three control points
        sols += _epnp_control(X, uv, K, 3)
    best, best_err = None, np.inf
    for R, t in sols:
        with np.errstate(all="ignore"):
            err = _sq_errors(X, uv, R, t, K).sum()
        if np.isfinite(err) and err < best_err:
            best, best_err = (R, t), err
    return best


def _skew(v):
    z = np.zeros(v.shape[:-1])
    return np.stack([np.stack([z, -v[..., 2], v[..., 1]], -1),
                     np.stack([v[..., 2], z, -v[..., 0]], -1),
                     np.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def refine_pose_lm(X, uv, K, rvec, t):
    """Levenberg-Marquardt on the summed squared reprojection error over
    (rvec, t), from the given pose; returns (rvec, t)."""
    X, uv, K = (np.asarray(a, np.float64) for a in (X, uv, K))
    rvec, t = np.asarray(rvec, np.float64).copy(), np.asarray(t, np.float64).copy()
    fx, fy = K[0, 0], K[1, 1]

    def cost(rv, tt):
        return float(_sq_errors(X, uv, rodrigues(rv), tt, K).sum())

    current, lam = cost(rvec, t), 1e-3
    for _ in range(LM_ITERATIONS):
        R = rodrigues(rvec)
        RX = X @ R.T
        Xc = RX + t
        x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
        r = np.concatenate([fx * x / z + K[0, 2] - uv[:, 0], fy * y / z + K[1, 2] - uv[:, 1]])
        Jp = np.zeros((len(X), 2, 3))
        Jp[:, 0, 0], Jp[:, 0, 2] = fx / z, -fx * x / z**2
        Jp[:, 1, 1], Jp[:, 1, 2] = fy / z, -fy * y / z**2
        # Left perturbation R <- exp([w]) R: d(R X)/dw = -[R X]_x.
        J = np.concatenate([Jp @ -_skew(RX), Jp], axis=2)  # [n, 2, 6]
        J = np.concatenate([J[:, 0], J[:, 1]])
        A, g = J.T @ J, J.T @ r
        improved = False
        for _ in range(10):
            step = np.linalg.solve(A + lam * np.diag(np.diag(A) + 1e-12), -g)
            new_r = rodrigues_vector(rodrigues(step[:3]) @ R)
            new_t = t + step[3:]
            new = cost(new_r, new_t)
            if new < current:
                rvec, t, current, lam, improved = new_r, new_t, new, lam * 0.1, True
                break
            lam *= 10.0
        if not improved or np.abs(step).max() < 1e-12:
            break
    return rvec, t


def _ransac_iterations(confidence, outlier_share, sample, current):
    """OpenCV's update of the RANSAC iteration count."""
    outlier_share = min(max(outlier_share, 0.0), 1.0)
    num = math.log(max(1.0 - confidence, np.finfo(np.float64).tiny))
    denom = 1.0 - (1.0 - outlier_share) ** sample
    if denom < np.finfo(np.float64).tiny:
        return 0
    denom = math.log(denom)
    if denom >= 0 or -num >= current * -denom:
        return current
    return int(round(num / denom))


def solve_pnp_ransac(X, uv, K):
    """Pose (rvec, t, inlier mask) mapping world points X [n, 3] onto the
    pixels uv [n, 2], or None when no model is found (n < 4 included).
    EPnP on random 5-point samples, then LM on the inliers."""
    X, uv, K = (np.asarray(a, np.float64) for a in (X, uv, K))
    n = len(X)
    if n < 4:
        return None
    sample = min(5, n)
    rng = np.random.default_rng(RANSAC_SEED)
    thresh = RANSAC_REPROJ_ERROR**2
    best, best_count, best_mask = None, sample - 1, None
    niters, it = RANSAC_ITERATIONS, 0
    while it < niters:
        it += 1
        idx = rng.choice(n, sample, replace=False) if n > sample else np.arange(n)
        model = epnp(X[idx], uv[idx], K)
        if model is None:
            continue
        with np.errstate(all="ignore"):
            mask = _sq_errors(X, uv, *model, K) <= thresh
        count = int(mask.sum())
        if count > best_count:
            best, best_count, best_mask = model, count, mask
            niters = _ransac_iterations(RANSAC_CONFIDENCE, (n - count) / n, sample, niters)
        if n == sample:
            break
    if best is None:
        return None
    rvec, t = refine_pose_lm(X[best_mask], uv[best_mask], K, rodrigues_vector(best[0]), best[1])
    return rvec, t, best_mask


def estimate_pose_pnp(
    rgb_curr: np.ndarray,
    rgb_near: np.ndarray,
    depth_curr: np.ndarray,
    K: np.ndarray,
    min_points: int = 4,
) -> Tuple[bool, Optional[np.ndarray], Optional[np.ndarray]]:
    """Relative pose (near <- curr) from matched features + sparse depth.

    Features in the current frame are back-projected with the dilated
    sparse depth to 3D; PnP-RANSAC against their 2D matches in the nearby
    frame yields (R, t) mapping current-camera points into the nearby
    camera. Returns (success, R [3,3] float32, t [3] float32), or
    (False, None, None).
    """
    pts2d_curr, pts2d_near = match_features(rgb_to_gray_u8(rgb_curr), rgb_to_gray_u8(rgb_near))
    return pose_from_matches(pts2d_curr, pts2d_near, depth_curr, K, min_points)


def pose_from_matches(pts2d_curr, pts2d_near, depth_curr, K, min_points: int = 4):
    """The PnP half of `estimate_pose_pnp`, from its matches."""
    if len(pts2d_curr) < min_points:
        return False, None, None
    # Dilate sparse depth so features a few pixels off a return still get z.
    depth_dilated = dilate_depth(depth_curr)
    h, w = depth_dilated.shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = np.clip(pts2d_curr[:, 0], 0, w - 1)
    v = np.clip(pts2d_curr[:, 1], 0, h - 1)
    z = depth_dilated[v, u]
    keep = z > 0
    if keep.sum() < min_points:
        return False, None, None
    z = z[keep]
    pts3d = np.stack([(u[keep] - cx) * z / fx, (v[keep] - cy) * z / fy, z],
                     axis=-1).astype(np.float32)
    pts2d = pts2d_near[keep].astype(np.float32)
    found = solve_pnp_ransac(pts3d, pts2d, np.asarray(K, np.float64))
    if found is None:
        return False, None, None
    rvec, tvec, _ = found
    return True, rodrigues(rvec).astype(np.float32), tvec.reshape(3).astype(np.float32)


# --------------------------------------------------------------------------
# Device-side differentiable warp (torch; inside the train step).
# --------------------------------------------------------------------------


def bilinear_sample(img, x, y):
    """Sample img [H, W, C] (or [B, H, W, C]) at float pixel coords x, y
    ([...] or [B, ...]); out of bounds -> 0. Differentiable w.r.t. (x, y),
    the path through which photometric gradients reach the predicted depth."""
    batched = img.dim() == 4
    if not batched:
        img, x, y = img[None], x[None], y[None]
    b, h, w, c = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = img.reshape(b, h * w, c)

    def gather(yy, xx):
        inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xi = torch.clamp(xx, 0, w - 1).long()
        yi = torch.clamp(yy, 0, h - 1).long()
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(*xx.shape, c)
        return vals * inside[..., None].to(vals.dtype)

    out = (gather(y0, x0) * (wx0 * wy0)[..., None]
           + gather(y0, x1) * (wx1 * wy0)[..., None]
           + gather(y1, x0) * (wx0 * wy1)[..., None]
           + gather(y1, x1) * (wx1 * wy1)[..., None])
    return out if batched else out[0]


def inverse_warp(rgb_near, depth_curr, R, t, K):
    """Warp the nearby RGB frame into the current view via predicted depth.

    Args:
      rgb_near: [H, W, 3] nearby frame, or [B, H, W, 3].
      depth_curr: [H, W] predicted dense depth of the current frame, or [B, H, W].
      R, t: rotation [3,3] / translation [3] (or [B, 3, 3] / [B, 3]) mapping
        current-camera points to the nearby camera (from `estimate_pose_pnp`).
      K: [3,3] intrinsics, shared by the batch.
    Returns (warped [..., H, W, 3], valid [..., H, W] bool); valid is False
    where the reprojection leaves the nearby image or lands behind the camera.
    """
    h, w = depth_curr.shape[-2:]
    dev, dt = depth_curr.device, depth_curr.dtype
    K = torch.as_tensor(K, dtype=dt, device=dev)
    R = torch.as_tensor(R, dtype=dt, device=dev)
    t = torch.as_tensor(t, dtype=dt, device=dev)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=dt),
                          torch.arange(w, device=dev, dtype=dt), indexing="ij")
    x = (u - cx) / fx * depth_curr
    y = (v - cy) / fy * depth_curr
    pts = torch.stack([x, y, depth_curr], dim=-1)  # [..., H, W, 3] current cam
    if R.dim() == 3:  # per-item poses against [B, H, W] depth
        R, t = R[:, None], t[:, None, None]
    pts_near = pts @ R.transpose(-1, -2) + t
    z = torch.clamp(pts_near[..., 2], min=1e-3)
    u_p = fx * pts_near[..., 0] / z + cx
    v_p = fy * pts_near[..., 1] / z + cy
    warped = bilinear_sample(rgb_near, u_p, v_p)
    valid = ((u_p >= 0) & (u_p <= w - 1) & (v_p >= 0) & (v_p <= h - 1)
             & (pts_near[..., 2] > 1e-3) & (depth_curr > 1e-3))
    return warped, valid


def multiscale(img, n_scales: int = 5):
    """Average-pool pyramid [full, 1/2, 1/4, ...]; [H,W,C] or [H,W]."""
    out = [img]
    cur = img if img.dim() == 3 else img[..., None]
    for _ in range(n_scales - 1):
        h, w = cur.shape[0] // 2 * 2, cur.shape[1] // 2 * 2
        c = cur[:h, :w]
        cur = 0.25 * (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2])
        out.append(cur if img.dim() == 3 else cur[..., 0])
    return out
