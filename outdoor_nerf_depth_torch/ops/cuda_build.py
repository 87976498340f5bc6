"""Build, bind, launch and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/torch_kernels/lib<name>-<hash>.so` at the repository root, where
`<hash>` is taken from the source and the flags, so an edited source always
rebuilds. Nothing is compiled at import time: the first launch builds, or a
caller builds every source at once with `build()`, one nvcc process per
source, all started together. A failed build raises.

Every export has the form `extern "C" int symbol(..., cudaStream_t stream)`
and returns a cudaError. A wrapper module declares each kernel once, beside
the function that launches it, as a `Kernel`: its id ("K4"), its source, its
symbol and its argument ctypes without the stream. Calling the `Kernel`
binds the symbol on first use, launches on the current stream of the given
device, raises on a nonzero code and counts the launch under the id.

The launch record is this module's: `launches()` counts by id since the last
`reset_launches()`, whatever thread launched (autograd runs the backward's
kernels on its device thread), and `recording()` collects, by id, the launch
key each wrapper supplies while it is open. `keys_json` and `merge_keys`
carry keys across processes. `use_kernel` is the device policy of every
entry that has a kernel: the plain twin on the CPU, the kernel on CUDA, and
no fallback between devices.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Set

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, concurrently.

    Returns {name: ptxas resource report} for the sources compiled now.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = "\n".join(
            line for line in log.splitlines() if "registers" in line or "spill" in line
        )
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]


# Argument ctypes of the exports: pointers (and ctypes arrays passed by
# value), `int` and `long long`.
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_KERNELS: Dict[str, "Kernel"] = {}
# Open recordings by id(): a launch adds its key to each.
_RECORDINGS: Dict[int, Dict[str, Set[tuple]]] = {}


class Kernel:
    """One export of `csrc/<source>.cu`, launched and counted under `kid`.

    Two ids may share a symbol (K2a is K2b's batch of 1). Each launch of a
    kernel comes from one thread at a time, so its count takes no lock.
    """

    def __init__(self, kid: str, source: str, symbol: str, *argtypes):
        if kid in _KERNELS:
            raise ValueError(f"kernel id {kid} is declared twice")
        self.kid, self.source, self.symbol, self.argtypes = kid, source, symbol, argtypes
        self.count = 0
        self._fn = None
        _KERNELS[kid] = self

    def _bind(self):
        fn = getattr(load(self.source), self.symbol)
        fn.argtypes = [*self.argtypes, PTR]
        fn.restype = I32
        self._fn = fn
        return fn

    def __call__(self, device: torch.device, *args, key: Callable[[], tuple]):
        """Launch with `args` on `device`'s current stream. `key()` is the
        launch's key, built only while a recording is open."""
        fn = self._fn if self._fn is not None else self._bind()
        with torch.cuda.device(device):
            code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if code != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {code}")
        self.count += 1
        if _RECORDINGS:
            launch_key = key()
            for keys in list(_RECORDINGS.values()):
                keys.setdefault(self.kid, set()).add(launch_key)


def kernels() -> Dict[str, Kernel]:
    """Every declared kernel by id, in id order."""
    return dict(sorted(_KERNELS.items()))


def launches() -> Dict[str, int]:
    """The launches of each declared kernel since the last reset, by id."""
    return {kid: k.count for kid, k in kernels().items()}


def reset_launches():
    for k in _KERNELS.values():
        k.count = 0


@contextlib.contextmanager
def recording(keys: Optional[Dict[str, Set[tuple]]] = None):
    """Collect into `keys` (a new dict if None), a set by kernel id, the key
    of every launch made while the context is open; yields `keys`."""
    keys = {} if keys is None else keys
    _RECORDINGS[id(keys)] = keys
    try:
        yield keys
    finally:
        del _RECORDINGS[id(keys)]


def keys_json(keys: Dict[str, Set[tuple]]) -> Dict[str, list]:
    """Recorded keys as JSON lists, sorted."""
    return {kid: sorted(_lists(k) for k in ks) for kid, ks in keys.items()}


def merge_keys(keys: Dict[str, Set[tuple]], loaded: Dict[str, list]):
    """Add keys that `keys_json` wrote (and JSON read back) to `keys`."""
    for kid, ks in loaded.items():
        keys.setdefault(kid, set()).update(_tuples(k) for k in ks)


def _lists(key):
    return [_lists(v) for v in key] if isinstance(key, tuple) else key


def _tuples(key):
    return tuple(_tuples(v) for v in key) if isinstance(key, list) else key


def use_kernel(x: torch.Tensor, op: str) -> bool:
    """The device policy of every entry with a kernel: False (run the plain
    twin) for a CPU tensor, True (launch the kernel) for a CUDA tensor, and
    ValueError for any other device: never a fallback between devices."""
    if x.device.type == "cpu":
        return False
    if x.is_cuda:
        return True
    raise ValueError(f"no {op} implementation on {x.device}")
