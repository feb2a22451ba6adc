"""Build the package's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by
a hash of its source and of the shared headers (`csrc/*.cuh`) so that an
edited source never loads a stale build.
All sources build in parallel, one nvcc each.  The libraries go to
`build/of_dis_tpu_torch/` at the root of the checkout, which .gitignore
lists.  Nothing from outside the package's `csrc/` is compiled.

`--fmad=false` keeps each multiply and add separately rounded, as in the
plain PyTorch versions the kernels are held against; the kernels are
bound by latency, not by arithmetic.

The host codecs (`csrc/<name>.cpp`, native.py) build the same way with the
host compiler (`$CXX`, else `g++`) through `build_host`, at first use, into
the same directory; a `.cpp` is never given to nvcc.  A failed build of
either kind raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "of_dis_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # loaded libraries, by source name
build_log: Dict[str, str] = {}  # the compiler's output (nvcc: ptxas register/smem report)


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    found = shutil.which("nvcc")
    if found:
        cands.insert(0, found)
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _lib_path(src: Path) -> Path:
    """The library of a .cu (named by its source, the shared headers and the
    flags) or of a .cpp (its source, the host compiler and the flags)."""
    if src.suffix == ".cu":
        key = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))) \
            + " ".join(NVCC_FLAGS).encode()
    else:
        key = _cxx().encode() + " ".join(CXX_FLAGS).encode()
    digest = hashlib.sha256(src.read_bytes() + key).hexdigest()
    return BUILD_DIR / f"lib{src.stem}_{digest[:16]}.so"


def _command(src: Path, out: Path) -> list:
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_cxx(), *CXX_FLAGS, str(src), "-o", str(out)]


def _build(srcs) -> Dict[str, ctypes.CDLL]:
    """Compile each of srcs whose library is not on disk (all in parallel),
    load each not yet loaded, and return them by source name.  Holds
    _lock."""
    outs = {src: _lib_path(src) for src in srcs}
    todo = [s for s, out in outs.items() if s.stem not in _libs and not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            tmp = outs[src].with_suffix(f".{os.getpid()}.tmp")
            cmd = _command(src, tmp)
            procs.append((src, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, tmp, cmd, proc in procs:
            log, _ = proc.communicate()
            build_log[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}:\n{log}")
            else:
                os.replace(tmp, outs[src])  # atomic: concurrent builders never see half a file
        if failed:
            raise RuntimeError("build failed:\n" + "\n".join(failed))
    for src, out in outs.items():
        if src.stem not in _libs:
            _libs[src.stem] = ctypes.CDLL(str(out))
    return {src.stem: _libs[src.stem] for src in srcs}


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every csrc/*.cu not yet built (in parallel) and load all."""
    with _lock:
        return _build(sorted(CSRC.glob("*.cu")))


def build_host(name: str) -> ctypes.CDLL:
    """csrc/<name>.cpp compiled with the host compiler ($CXX, else g++),
    built at first use and loaded once."""
    with _lock:
        return _build([CSRC / f"{name}.cpp"])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib
