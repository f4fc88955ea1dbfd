"""Build ``tod_tpu_torch/csrc/*.cu`` with nvcc and load them with ctypes.

Each source becomes one shared library with a plain C interface, compiled for
Hopper (``sm_90a``) into ``build/tod_tpu_torch/`` at the repository root.  The
file name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  A build writes to a temporary
name and renames it into place, so concurrent builders need no lock file.
Several sources build in parallel, one nvcc process each.  ``build_host``
takes the same route with g++ for the host's C++ (the native planner).
``set_build_dir`` points both at another directory before the first build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Iterable, Mapping

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "tod_tpu_torch"
# No --use_fast_math: the crop compares and divisions must round as torch's do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
SMEM_LIMIT = 232_448  # the most dynamic shared memory a Hopper block can opt into

_loaded: dict[str, ctypes.CDLL] = {}
built: list[str] = []  # the sources this process compiled with nvcc, in order
_host_built = False  # a host library's path has been handed out (its loader caches it)
_lock = threading.Lock()


def set_build_dir(path: str | os.PathLike) -> pathlib.Path:
    """Build and load every library in ``path`` from now on, nvcc's and
    g++'s alike (a boot measured from a cold build points it at an empty
    directory, a warm boot at the one the cold boot filled).  Raises once a
    library has been loaded or a host library built: their callers cache
    them.  Returns the directory."""
    global BUILD_DIR
    with _lock:
        if _loaded or _host_built:
            raise RuntimeError(f"set_build_dir({str(path)!r}) after a library was loaded "
                               f"from {BUILD_DIR}")
        BUILD_DIR = pathlib.Path(path).resolve()
        return BUILD_DIR


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = pathlib.Path(home) / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    raise RuntimeError(
        f"nvcc not found on PATH or under {home}/bin (set CUDA_HOME): the CUDA "
        "toolkit is needed to build the kernels in tod_tpu_torch/csrc"
    )


def _hashed_path(src: pathlib.Path, flags: tuple[str, ...],
                 headers: Iterable[pathlib.Path] = ()) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for header in headers:
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> pathlib.Path:
    """The library of ``csrc/<name>.cu``; its hash covers every ``csrc/*.cuh``
    header too, so an edited header rebuilds the sources."""
    return _hashed_path(CSRC / f"{name}.cu", NVCC_FLAGS, sorted(CSRC.glob("*.cuh")))


def _start(cmd: list[str], src: pathlib.Path, out: pathlib.Path):
    """Start compiling ``src`` into a temporary file beside ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen([*cmd, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(proc, tmp: pathlib.Path, out: pathlib.Path) -> tuple[str, bool]:
    """Wait for a compile; rename its output into place -> (log, ok)."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return log, False
    os.replace(tmp, out)
    return log, True


def build(names: Iterable[str]) -> dict[str, str]:
    """Compile every named source whose library is missing, all at once.

    Returns nvcc's output (ptxas register and shared-memory report) by name;
    raises with that output if a compile fails.
    """
    jobs = []
    for name in names:
        out = library_path(name)
        if not out.exists():
            jobs.append((name, *_start([find_nvcc(), *NVCC_FLAGS], CSRC / f"{name}.cu", out), out))
            built.append(name)
    logs, failed = {}, []
    for name, proc, tmp, out in jobs:
        logs[name], ok = _finish(proc, tmp, out)
        if not ok:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def host_library_path(src: pathlib.Path) -> pathlib.Path:
    """The library a host C++ source builds into."""
    return _hashed_path(src, GXX_FLAGS)


def build_host(src: pathlib.Path) -> pathlib.Path:
    """Compile a host C++ source with g++ (``$CXX`` if set) into a shared
    library in ``BUILD_DIR`` unless it is there; returns its path, raises
    with g++'s output if the compile fails."""
    global _host_built
    out = host_library_path(src)
    if not out.exists():
        log, ok = _finish(*_start([os.environ.get("CXX", "g++"), *GXX_FLAGS], src, out), out)
        if not ok:
            raise RuntimeError(f"g++ failed for {src.name}:\n{log}")
    _host_built = True
    return out


def load(name: str, signatures: Mapping[str, tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C entry point to its ``(argtypes, restype)``;
    they are set once, when the library is first loaded."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.tod_error_string.argtypes = [ctypes.c_int]
            lib.tod_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.tod_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
