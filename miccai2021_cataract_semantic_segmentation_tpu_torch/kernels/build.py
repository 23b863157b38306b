"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/kernels/<name>-<hash>.so` under the checkout
root (a directory .gitignore lists), then loaded with ctypes. The hash
covers the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header is rebuilt at its next use. Nothing is built at import: a library is built at the first call
of its wrapper, or ahead of time by `build()`, which starts one `nvcc` per
source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("fu_hist", "fu_grad", "bucket_hist", "bucket_grad", "nchw_hist",
           "nchw_grad", "fused_upsample")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on the machine with the card")
    return str(path)


def lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Build every library of `names` that is missing, one nvcc process per
    source started together; returns {name: seconds} for those built.
    The compiler's register/shared-memory report lands beside each
    library as `<name>-<hash>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `name`'s library, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    return lib.cuda_error_string(code).decode()
