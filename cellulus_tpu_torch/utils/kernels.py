"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, at first use, and
loaded with ``ctypes``. Libraries land in ``build/cellulus_tpu_torch/`` at
the root of the checkout, named by a hash of the source, of every shared
header ``csrc/*.cuh`` and of the flags, so an edited source or header
rebuilds and an unchanged one is reused. All sources build
together, one ``nvcc`` process each, the first time any kernel is needed.

Nothing here runs at import time: the CPU tests import every module of the
port on machines with no ``nvcc``.
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
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cellulus_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# per-source extra flags: the ball statistics compare a distance against an
# inclusive boundary, so no multiply-add may be contracted into an FMA
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"ball_stats": ("--fmad=false",)}

# name -> ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
# the bookkeeping a thread defers while it captures a CUDA graph
_deferred = threading.local()
# one CUDA graph capture at a time in the process: the pipelined path
# captures in its predict thread (``predict.py``) and in its detect workers
# (``ops/greedy_cluster.py``)
CAPTURE_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "cellulus_tpu_torch are compiled on first use"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet, all at once; raise
    with the compiler's output if any build fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _library_path(name) for name in names}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return targets


def load(name: str, signatures: Dict[str, Tuple[Sequence, object]]) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu`` with ``argtypes`` and
    ``restype`` set from ``signatures`` (function -> (argtypes, restype))."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches;
    a lock makes it safe in the pipelined path's worker threads."""
    with _count_lock:
        wrapper.launches += 1


def account(fn, *args) -> None:
    """Call ``fn(*args)``, the host's bookkeeping of one launch (a launch
    count, profiler counters), or, while this thread captures a CUDA graph
    under :func:`deferred_accounts`, keep the call for the graph's replays:
    a capture launches nothing, each replay launches what it recorded."""
    log = getattr(_deferred, "log", None)
    if log is None:
        fn(*args)
    else:
        log.append((fn, args))


@contextlib.contextmanager
def deferred_accounts():
    """Collect the :func:`account` calls this thread makes inside the block
    into the list it yields, instead of making them; a caller that replays a
    graph captured in the block makes them after each replay."""
    log = []
    _deferred.log = log
    try:
        yield log
    finally:
        _deferred.log = None


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
