"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/`` at the repo
root.  The library's file name carries a hash of the source, the headers
it shares (``HEADERS``) and the flags, so an edited kernel is rebuilt and a
stale one is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("decode_attention", "flash_attention", "ssd_scan")
#: headers in ``csrc`` that every source includes
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: each launch function: the source (library) that holds it, and its C
#: signature
ENTRIES = {
    "flash_decode_launch": ("decode_attention",
                            [_P] * 7 + [_I] * 7 + [ctypes.c_float]
                            + [_I] * 2 + [_P]),
    "flash_decode_int8_launch": ("decode_attention",
                                 [_P] * 9 + [_I] * 7 + [ctypes.c_float]
                                 + [_I] * 2 + [_P]),
    "flash_attention_launch": ("flash_attention",
                               [_P] * 4 + [_I] * 9 + [ctypes.c_float, _P]),
    "flash_attention_last_body": ("flash_attention", []),
    "flash_attention_row_tiles": ("flash_attention", [_I]),
    "ssd_scan_launch": ("ssd_scan", [_P] * 7 + [_I] * 7 + [_P]),
    "ssd_scan_last_body": ("ssd_scan", []),
    "ssd_scan_last_kernels": ("ssd_scan", []),
}

#: launch functions already loaded, by name
_loaded: Dict[str, object] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels can only be built on a machine with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` on one source; it writes to a temporary file that
    :func:`_finish` moves into place only if the build succeeds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp)


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> None:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, library_path(name))


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source in parallel."""
    started = {n: _start(n) for n in names if not library_path(n).exists()}
    errors = []
    for n, (proc, tmp) in started.items():
        try:
            _finish(n, proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) from the last build of ``name``, or ''."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(entry: str):
    """The launch function ``entry`` (a key of :data:`ENTRIES`), its
    library built from ``csrc`` on first use."""
    if entry not in _loaded:
        name, argtypes = ENTRIES[entry]
        if not library_path(name).exists():
            _finish(name, *_start(name))
        fn = getattr(ctypes.CDLL(str(library_path(name))), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[entry] = fn
    return _loaded[entry]
