"""Raw-image utilities (RawNeRF): Bayer mosaics, demosaicing, DNG reading,
exposure bookkeeping, raw post-processing and affine colour matching.

Port of the reference package's `utils/raw.py`, in numpy (its three array
calls of `postprocess_raw` are numpy here too, in float32 as the reference
computes them) with the port's own `utils/image.py` for `downsample` and
`linear_to_srgb`. The DNG/TIFF reader is pure Python: it walks the IFD chain
with its EXIF and SubIFD branches for the exposure tags, and decodes the
uncompressed (Compression=1) 8- and 16-bit strip and tile layouts, with the
mosaic brought to RGGB phase from its CFAPattern.
"""

from __future__ import annotations

import struct
from typing import Mapping, Sequence, Tuple

import numpy as np

from outdoor_nerf_depth_torch.utils import image as image_lib


def pixels_to_bayer_mask(pix_x, pix_y):
    """[..., 3] binary mask of which RGGB channel each pixel observes.

    R at (even, even); G at the two mixed-parity sites; B at (odd, odd) —
    the per-ray lossmult for training on mosaicked raw frames.
    """
    x_even = (pix_x % 2 == 0).astype(np.float32)
    y_even = (pix_y % 2 == 0).astype(np.float32)
    r = x_even * y_even
    g = x_even + y_even - 2.0 * x_even * y_even
    b = (1.0 - x_even) * (1.0 - y_even)
    return np.stack([r, g, b], axis=-1)


def bilinear_demosaic(bayer: np.ndarray) -> np.ndarray:
    """Demosaic an RGGB Bayer plane [H, W] -> [H, W, 3] by bilinear interp."""
    h, w = bayer.shape

    def grid_interp(vals_yx):
        ys, xs, vals = vals_yx
        out = np.zeros((h, w), np.float32)
        known = np.zeros((h, w), np.float32)
        out[ys, xs] = vals
        known[ys, xs] = 1.0
        # Two passes of 3x3 normalized box filling recover bilinear weights
        # for the regular Bayer lattice.
        for _ in range(2):
            pad_v = np.pad(out, 1)
            pad_k = np.pad(known, 1)
            acc_v = np.zeros_like(out)
            acc_k = np.zeros_like(known)
            for dy in range(3):
                for dx in range(3):
                    wgt = 1.0 / (1 + abs(dy - 1) + abs(dx - 1))
                    acc_v += wgt * pad_v[dy : dy + h, dx : dx + w]
                    acc_k += wgt * pad_k[dy : dy + h, dx : dx + w]
            fill = acc_v / np.maximum(acc_k, 1e-8)
            out = np.where(known > 0, out, fill)
            known = np.where(acc_k > 0, 1.0, known)
        return out

    yy, xx = np.mgrid[0:h, 0:w]
    r_mask = (yy % 2 == 0) & (xx % 2 == 0)
    g_mask = (yy % 2) != (xx % 2)
    b_mask = (yy % 2 == 1) & (xx % 2 == 1)
    channels = []
    for mask in (r_mask, g_mask, b_mask):
        ys, xs = np.nonzero(mask)
        channels.append(grid_interp((ys, xs, bayer[ys, xs])))
    return np.stack(channels, axis=-1)


_TAG_NAMES = {
    0x829A: "ExposureTime",
    0x8827: "ISOSpeedRatings",
    0x9201: "ShutterSpeedValue",
    0xC61A: "BlackLevel",
    0xC61D: "WhiteLevel",
    0x0100: "ImageWidth",
    0x0101: "ImageLength",
    0x0112: "Orientation",
    0xC621: "ColorMatrix1",
    0xC622: "ColorMatrix2",
    0xC628: "AsShotNeutral",
}
_EXIF_IFD = 0x8769
_SUB_IFDS = 0x014A
# TIFF field types -> (struct code, size)
_FIELD_TYPES = {
    1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
}


def read_dng_metadata(path: str) -> dict:
    """The exposure and colour tags of a DNG/TIFF file (ExposureTime,
    ISOSpeedRatings, ShutterSpeedValue, BlackLevel, WhiteLevel,
    AsShotNeutral, ColorMatrix1/2, the image size and orientation), read
    from the IFD chain and its EXIF and SubIFD branches; pixels are not
    decoded (`read_dng` does that)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"II":
        e = "<"
    elif data[:2] == b"MM":
        e = ">"
    else:
        raise ValueError(f"{path!r} is not a TIFF/DNG file")
    if struct.unpack(e + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path!r}: bad TIFF magic")

    out = {}

    def read_ifd(offset, depth=0):
        if depth > 4 or offset <= 0 or offset + 2 > len(data):
            return
        (n,) = struct.unpack(e + "H", data[offset : offset + 2])
        for i in range(n):
            base = offset + 2 + 12 * i
            if base + 12 > len(data):
                return
            tag, ftype, count = struct.unpack(
                e + "HHI", data[base : base + 8]
            )
            if ftype not in _FIELD_TYPES:
                continue
            code, size = _FIELD_TYPES[ftype]
            total = size * count
            if total <= 4:
                raw = data[base + 8 : base + 8 + total]
            else:
                (ptr,) = struct.unpack(e + "I", data[base + 8 : base + 12])
                raw = data[ptr : ptr + total]
            if len(raw) < total:
                continue
            if code in ("II", "ii"):  # rationals
                ints = struct.unpack(
                    e + code[0] * (2 * count), raw
                )
                vals = [
                    ints[2 * j] / ints[2 * j + 1] if ints[2 * j + 1] else 0.0
                    for j in range(count)
                ]
            else:
                vals = list(struct.unpack(e + code * count, raw))
            if tag == _EXIF_IFD:
                read_ifd(int(vals[0]), depth + 1)
            elif tag == _SUB_IFDS:
                for v in vals:
                    read_ifd(int(v), depth + 1)
            elif tag in _TAG_NAMES:
                name = _TAG_NAMES[tag]
                out.setdefault(
                    name, vals[0] if count == 1 else vals
                )
        (nxt,) = struct.unpack(
            e + "I", data[offset + 2 + 12 * n : offset + 6 + 12 * n]
        )
        if nxt:
            read_ifd(nxt, depth + 1)

    (ifd0,) = struct.unpack(e + "I", data[4:8])
    read_ifd(ifd0)
    return out


# Pixel-layout tags for the raw decode (strip- and tile-organized TIFF).
_PIX_TAGS = {
    0x0100: "ImageWidth", 0x0101: "ImageLength",
    0x0102: "BitsPerSample", 0x0103: "Compression",
    0x0106: "PhotometricInterpretation", 0x0111: "StripOffsets",
    0x0115: "SamplesPerPixel", 0x0116: "RowsPerStrip",
    0x0117: "StripByteCounts", 0x0142: "TileWidth", 0x0143: "TileLength",
    0x0144: "TileOffsets", 0x0145: "TileByteCounts",
    0x828E: "CFAPattern", 0xC61A: "BlackLevel", 0xC61D: "WhiteLevel",
    0x00FE: "NewSubfileType",
}
_CFA_PHOTOMETRIC = 32803


def _parse_ifds(data: bytes):
    """All IFDs in a TIFF/DNG (chain + SubIFDs), as a list of tag dicts."""
    if data[:2] == b"II":
        e = "<"
    elif data[:2] == b"MM":
        e = ">"
    else:
        raise ValueError("not a TIFF/DNG byte stream")
    if struct.unpack(e + "H", data[2:4])[0] != 42:
        raise ValueError("bad TIFF magic")

    ifds = []

    def read_ifd(offset, depth=0):
        if depth > 4 or offset <= 0 or offset + 2 > len(data):
            return
        (n,) = struct.unpack(e + "H", data[offset : offset + 2])
        tags = {}
        subs = []
        for i in range(n):
            base = offset + 2 + 12 * i
            if base + 12 > len(data):
                return
            tag, ftype, count = struct.unpack(e + "HHI", data[base : base + 8])
            if ftype not in _FIELD_TYPES:
                continue
            code, size = _FIELD_TYPES[ftype]
            total = size * count
            if total <= 4:
                raw = data[base + 8 : base + 8 + total]
            else:
                (ptr,) = struct.unpack(e + "I", data[base + 8 : base + 12])
                raw = data[ptr : ptr + total]
            if len(raw) < total:
                continue
            if code in ("II", "ii"):
                ints = struct.unpack(e + code[0] * (2 * count), raw)
                vals = [
                    ints[2 * j] / ints[2 * j + 1] if ints[2 * j + 1] else 0.0
                    for j in range(count)
                ]
            else:
                vals = list(struct.unpack(e + code * count, raw))
            if tag == _SUB_IFDS:
                subs.extend(int(v) for v in vals)
            elif tag in _PIX_TAGS:
                tags[_PIX_TAGS[tag]] = vals
        ifds.append(tags)
        for s in subs:
            read_ifd(s, depth + 1)
        (nxt,) = struct.unpack(
            e + "I", data[offset + 2 + 12 * n : offset + 6 + 12 * n]
        )
        if nxt:
            read_ifd(nxt, depth + 1)

    (ifd0,) = struct.unpack(e + "I", data[4:8])
    read_ifd(ifd0)
    return ifds, e


def _pick_raw_ifd(ifds):
    """The raw mosaic IFD: CFA photometric if present, else the largest
    single-sample uncompressed image."""
    cfa = [
        t for t in ifds
        if t.get("PhotometricInterpretation", [None])[0] == _CFA_PHOTOMETRIC
    ]
    if cfa:
        return cfa[0]
    candidates = [
        t for t in ifds
        if ("ImageWidth" in t and "ImageLength" in t
            and ("StripOffsets" in t or "TileOffsets" in t))
    ]
    if not candidates:
        raise ValueError("no decodable image IFD found")
    return max(
        candidates, key=lambda t: t["ImageWidth"][0] * t["ImageLength"][0]
    )


def read_dng(path: str) -> Tuple[np.ndarray, dict]:
    """Decode an UNCOMPRESSED DNG/TIFF raw mosaic.

    Supports the uncompressed (Compression=1) single-sample strip- or
    tile-organized layouts at 8/16 bits per sample — the layout
    `dng_validate -dng -u` and most camera "uncompressed DNG" exports
    produce. Lossless-JPEG DNGs (Compression=7) need a JPEG-LS codec and
    are rejected loudly. The mosaic is normalized to RGGB phase using the
    CFAPattern tag (cropping at most one row/column).

    Returns (mosaic uint16 [H, W] in RGGB phase, metadata dict from
    `read_dng_metadata`).
    """
    with open(path, "rb") as f:
        data = f.read()
    ifds, e = _parse_ifds(data)
    t = _pick_raw_ifd(ifds)

    comp = int(t.get("Compression", [1])[0])
    if comp != 1:
        raise ValueError(
            f"{path!r}: compression {comp} is not supported (only "
            "uncompressed DNG/TIFF, Compression=1; convert with "
            "`dng_validate` first)"
        )
    spp = int(t.get("SamplesPerPixel", [1])[0])
    if spp != 1:
        raise ValueError(f"{path!r}: expected 1 sample/pixel raw, got {spp}")
    bits = int(t.get("BitsPerSample", [16])[0])
    if bits not in (8, 16):
        raise ValueError(
            f"{path!r}: {bits}-bit packing not supported (8/16 only)"
        )
    width = int(t["ImageWidth"][0])
    height = int(t["ImageLength"][0])
    dtype = np.dtype(("<u2" if e == "<" else ">u2") if bits == 16 else "u1")

    mosaic = np.zeros((height, width), np.uint16)
    if "TileOffsets" in t:
        tw = int(t["TileWidth"][0])
        th = int(t["TileLength"][0])
        tiles_x = -(-width // tw)
        offsets = t["TileOffsets"]
        counts = t["TileByteCounts"]
        for k, (off, cnt) in enumerate(zip(offsets, counts)):
            tile = np.frombuffer(
                data, dtype, count=tw * th, offset=int(off)
            ).reshape(th, tw)
            y0 = (k // tiles_x) * th
            x0 = (k % tiles_x) * tw
            ys = min(th, height - y0)
            xs = min(tw, width - x0)
            mosaic[y0 : y0 + ys, x0 : x0 + xs] = tile[:ys, :xs]
    else:
        rps = int(t.get("RowsPerStrip", [height])[0])
        offsets = t["StripOffsets"]
        y = 0
        for off in offsets:
            rows = min(rps, height - y)
            strip = np.frombuffer(
                data, dtype, count=rows * width, offset=int(off)
            ).reshape(rows, width)
            mosaic[y : y + rows] = strip
            y += rows

    # Normalize the CFA phase to RGGB (values: 0=R, 1=G, 2=B; row-major
    # 2x2). A pattern like GRBG differs from RGGB by a 1-pixel shift.
    cfa = t.get("CFAPattern")
    if cfa is not None and len(cfa) >= 4:
        pat = [int(v) for v in cfa[:4]]
        shifts = {
            (0, 1, 1, 2): (0, 0),  # RGGB
            (1, 0, 2, 1): (0, 1),  # GRBG
            (1, 2, 0, 1): (1, 0),  # GBRG
            (2, 1, 1, 0): (1, 1),  # BGGR
        }
        dy, dx = shifts.get(tuple(pat), (0, 0))
        mosaic = mosaic[dy:, dx:]
        if dy or dx:  # keep even dims for downstream 2x2 logic
            mosaic = mosaic[: (mosaic.shape[0] // 2) * 2,
                            : (mosaic.shape[1] // 2) * 2]

    return mosaic.astype(np.uint16), read_dng_metadata(path)


def load_raw_dataset_from_dngs(paths: Sequence[str],
                               exposure_percentile: float = 97.0,
                               n_downsample: int = 1):
    """End-to-end raw ingestion from uncompressed DNG files on disk:
    decode mosaics + metadata, then run `assemble_raw_dataset` (demosaic,
    exposure bookkeeping, postprocess closure)."""
    mosaics, metas = [], []
    for p in paths:
        m, meta = read_dng(p)
        mosaics.append(m)
        metas.append(meta)
    raws = np.stack(mosaics).astype(np.float32)
    return assemble_raw_dataset(
        raws, metas, exposure_percentile=exposure_percentile,
        n_downsample=n_downsample,
    )


def exposure_values(metadata: Sequence[Mapping]) -> np.ndarray:
    """shutter * ISO / 1000 per frame (the reference's exposure unit)."""
    return np.array(
        [float(m["ExposureTime"]) * float(m["ISOSpeedRatings"]) / 1000.0
         for m in metadata]
    )


# sRGB (D65) -> XYZ primaries, the standard matrix cam2rgb is built from.
_RGB2XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)


def _shutter_seconds(m: Mapping) -> float:
    """Seconds of exposure from whichever tag the frame carries:
    ExposureTime (seconds), 'ShutterSpeed' as a '1/x' string (the
    RawNeRF EXIF JSON convention), or the DNG
    APEX ShutterSpeedValue (log2 of 1/seconds)."""
    if "ExposureTime" in m:
        return float(m["ExposureTime"])
    if "ShutterSpeed" in m:
        v = m["ShutterSpeed"]
        if isinstance(v, str) and "/" in v:
            num, den = v.split("/")
            return float(num or 1.0) / float(den)
        return float(v)
    if "ShutterSpeedValue" in m:
        return float(2.0 ** -float(m["ShutterSpeedValue"]))
    raise KeyError("no shutter tag (ExposureTime/ShutterSpeed) in metadata")


def process_metadata(metas: Sequence[Mapping]) -> dict:
    """Per-frame color pipeline constants from DNG/EXIF metadata dicts.

    RawNeRF's `process_exif`: builds the
    cam-space -> linear-sRGB transform as
      cam2camwb = diag(1 / AsShotNeutral)        (white balance)
      rgb2camwb = normalize_rows(ColorMatrix2 @ RGB2XYZ)
      cam2rgb   = inv(rgb2camwb) @ cam2camwb
    plus stacked shutter speeds and black/white levels. Input dicts come
    from `read_dng_metadata` or an EXIF JSON sidecar.
    """
    shutters = np.array([_shutter_seconds(m) for m in metas])
    # Frames lacking the color tags (e.g. JPEG-derived sidecars) fall back
    # to an identity color pipeline — RawNeRF's process_exif simply
    # skips missing EXIF keys, which implies the same no-op transform.
    wb = np.array(
        [np.asarray(m.get("AsShotNeutral", np.ones(3)), float) for m in metas]
    )
    cam2camwb = np.stack([np.diag(1.0 / x) for x in wb])
    # Identity cam-space: ColorMatrix2 = XYZ2RGB so rgb2camwb = I after
    # row normalization.
    xyz2rgb = np.linalg.inv(_RGB2XYZ)
    xyz2camwb = np.array(
        [
            np.asarray(m.get("ColorMatrix2", xyz2rgb), float).reshape(3, 3)
            for m in metas
        ]
    )
    rgb2camwb = xyz2camwb @ _RGB2XYZ
    rgb2camwb /= rgb2camwb.sum(axis=-1, keepdims=True)
    cam2rgb = np.linalg.inv(rgb2camwb) @ cam2camwb
    meta = {
        "ShutterSpeed": shutters,
        "cam2rgb": cam2rgb,
        "BlackLevel": np.array(
            [np.mean(np.asarray(m.get("BlackLevel", 0.0), float)) for m in metas]
        ),
        "WhiteLevel": np.array(
            [np.mean(np.asarray(m.get("WhiteLevel", 1.0), float)) for m in metas]
        ),
    }
    return meta


# Brightness percentiles swept for training-log visualization (RawNeRF's
# _PERCENTILE_LIST).
_PERCENTILE_LIST = (80, 90, 97, 99, 100)


def assemble_raw_dataset(
    raws: np.ndarray,
    metas: Sequence[Mapping],
    exposure_percentile: float = 97.0,
    n_downsample: int = 1,
):
    """Raw mosaics + metadata -> demosaicked images + exposure bookkeeping.

    The decode-free core of RawNeRF's `load_raw_dataset`: `raws` are
    decoded Bayer planes [N, H, W] (`read_dng` decodes uncompressed DNGs):

    * black/white-level normalization to [0, 1];
    * unique shutter speeds sorted brightest-first, per-image
      `exposure_idx` and relative `exposure_values` (brightest == 1) — the
      per-ray exposure inputs for a RawNeRF-style model;
    * scene exposure at `exposure_percentile` of image 0 (after cam2rgb),
      plus the percentile sweep for logging;
    * a `postprocess_fn` closing over cam2rgb/exposure;
    * bilinear demosaic (+ optional area downsample).

    Returns (images [N, H/d, W/d, 3], meta dict).
    """
    meta = process_metadata(metas)
    shutters = meta["ShutterSpeed"]
    unique_shutters = np.sort(np.unique(shutters))[::-1]
    exposure_idx = np.zeros_like(shutters, dtype=np.int32)
    for i, shutter in enumerate(unique_shutters):
        exposure_idx[shutters == shutter] = i
    meta["exposure_idx"] = exposure_idx
    meta["unique_shutters"] = unique_shutters
    meta["exposure_values"] = shutters / unique_shutters[0]

    black = meta["BlackLevel"].reshape(-1, 1, 1)
    white = meta["WhiteLevel"].reshape(-1, 1, 1)
    images = (np.asarray(raws, np.float32) - black) / np.maximum(
        white - black, 1e-8
    )

    image0_rgb = bilinear_demosaic(images[0]) @ meta["cam2rgb"][0].T
    meta["exposure"] = float(
        np.percentile(image0_rgb, exposure_percentile)
    )
    meta["exposure_levels"] = {
        p: float(np.percentile(image0_rgb, p)) for p in _PERCENTILE_LIST
    }
    cam2rgb0 = meta["cam2rgb"][0]
    meta["postprocess_fn"] = lambda z, x=meta["exposure"]: postprocess_raw(
        z, cam2rgb=cam2rgb0, exposure=x
    )

    out = []
    for im in images:
        rgb = bilinear_demosaic(im)
        if n_downsample > 1:
            rgb = np.asarray(image_lib.downsample(rgb, n_downsample))
        out.append(rgb)
    return np.stack(out), meta


def normalize_exposure(
    images: np.ndarray, percentile: float = 97.0
) -> Tuple[np.ndarray, float]:
    """Scale linear images so `percentile` of intensities hits 1.0."""
    level = float(np.percentile(images, percentile))
    return images / max(level, 1e-8), level


def postprocess_raw(raw, cam2rgb=None, exposure=None):
    """Demosaicked raw -> sRGB, the reference's minimal pipeline: camera
    space -> linear sRGB through `cam2rgb` (identity when None), `exposure`
    (default: the 97th percentile) mapped to white, clipped, then the sRGB
    curve. Computes in float32; returns a float32 array."""
    x = np.asarray(raw, dtype=np.float32)
    if x.shape[-1] != 3:
        raise ValueError(f"raw.shape[-1] is {x.shape[-1]}, expected 3")
    if cam2rgb is not None:
        cam2rgb = np.asarray(cam2rgb, dtype=np.float32)
        if cam2rgb.shape != (3, 3):
            raise ValueError(f"cam2rgb.shape is {cam2rgb.shape}, expected (3, 3)")
        x = x @ cam2rgb.T
    if exposure is None:
        exposure = np.percentile(x, 97)
    x = np.clip(x / np.float32(exposure), 0.0, 1.0).astype(np.float32)
    return image_lib.linear_to_srgb(x).numpy()


def match_affine_color(img: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Least-squares 3x4 color transform of `img` onto `ref` (the raw
    evaluation trick: compare up to an affine color shift)."""
    flat = img.reshape(-1, 3)
    feats = np.concatenate([flat, np.ones_like(flat[:, :1])], axis=-1)
    coeff, *_ = np.linalg.lstsq(feats, ref.reshape(-1, 3), rcond=None)
    return (feats @ coeff).reshape(img.shape)


def best_fit_affine(x, y, axis):
    """Per-channel least-squares (a, b) with a * x + b ~= y."""
    x = np.asarray(x)
    y = np.asarray(y)
    x_m = x.mean(axis=axis)
    y_m = y.mean(axis=axis)
    xy_m = (x * y).mean(axis=axis)
    xx_m = (x * x).mean(axis=axis)
    a = (xy_m - x_m * y_m) / (xx_m - x_m * x_m)
    b = y_m - a * x_m
    return a, b


def match_images_affine(est, gt, axis=(0, 1)):
    """Affine-match a (noisy) estimate to ground truth for raw metrics:
    fit gt->est, then invert so metrics live in the gt color space."""
    a, b = best_fit_affine(gt, est, axis=axis)
    return (np.asarray(est) - b) / a
