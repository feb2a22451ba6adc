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

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # nvcc's output (ptxas register/smem report) per source


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


def _lib_path(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}_{digest[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every csrc/*.cu not yet built (in parallel) and load all."""
    with _lock:
        srcs = sorted(CSRC.glob("*.cu"))
        todo = [s for s in srcs if s.stem not in _libs and not _lib_path(s).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = nvcc_path()
            procs = []
            for src in todo:
                out = _lib_path(src)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            failed = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                build_log[src.stem] = log
                if proc.returncode != 0:
                    failed.append(f"{src.name}:\n{log}")
                else:
                    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src in srcs:
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(_lib_path(src)))
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib
