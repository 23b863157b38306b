"""Build and load the port's hand-written CUDA kernels and its host (CPU)
C++ libraries.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/kernels/<name>-<hash>.so` under the checkout
root (a directory .gitignore lists), then loaded with ctypes. The hash
covers the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header is rebuilt at its next use. Nothing is built at import: a library is built at the first call
of its wrapper, or ahead of time by `build()`, which starts one `nvcc` per
source, all at once. `load_host` builds a host library (the PNG unfilter,
native/cadis_io.cpp) the same way with the host C++ compiler (`g++`, the
compiler nvcc drives) into `build/<subdir>/`. Every library is compiled to
a temporary file that `os.replace` puts in place and is loaded once, under
one lock (`load` keeps a kernel's handle by name, `load_host` a host
library's by its arguments); a host library that does not build or load raises the same
error at every later call without building again.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("fu_hist", "fu_grad", "bucket_hist", "bucket_grad", "nchw_hist",
           "nchw_grad", "fused_upsample")

_lock = threading.RLock()
_kernels: dict[str, ctypes.CDLL] = {}       # load()'s handles by name
_hosts: dict[tuple, ctypes.CDLL] = {}       # load_host()'s by its arguments
_failed: dict[tuple, str] = {}              # and why one did not load


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


def _compile(jobs) -> dict[str, float]:
    """Start every (name, command, out) of `jobs` at once, `command(tmp)`
    giving the command line that writes the temporary file `tmp`, which
    replaces `out` where it succeeds. The compiler's output lands beside
    each library as `<name>-<hash>.log`. Returns {name: seconds}; raises
    RuntimeError with the output of every failure."""
    procs = {}
    t0 = time.perf_counter()
    for name, command, out in jobs:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = command(tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       cmd, tmp, out)
    seconds, failed = {}, []
    for name, (proc, cmd, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: {' '.join(cmd)} exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return seconds


def build(names=SOURCES) -> dict[str, float]:
    """Build every library of `names` that is missing, one nvcc process per
    source started together; returns {name: seconds} for those built.
    The compiler's register/shared-memory report lands beside each
    library as `<name>-<hash>.log`."""
    missing = [(name, lib_path(name)) for name in names]
    missing = [(name, out) for name, out in missing if not out.exists()]
    if not missing:
        return {}
    nvcc = _nvcc()
    with _lock:
        return _compile([(name, lambda tmp, name=name: [
            nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")], out)
            for name, out in missing])


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `name`'s library, built first if missing."""
    lib = _kernels.get(name)
    if lib is None:
        with _lock:
            build((name,))
            lib = _kernels[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def host_compiler() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (g++) on PATH")
    return cxx


def host_lib_path(name: str, sources, flags, libs=(), subdir: str = "host"
                  ) -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(pathlib.Path(src).read_bytes())
    h.update(" ".join([*flags, *libs]).encode())
    return BUILD_ROOT / subdir / f"{name}-{h.hexdigest()[:16]}.so"


def load_host(name: str, sources, flags, libs=(), subdir: str = "host",
              declare=None) -> ctypes.CDLL:
    """The ctypes handle of host library `name`, compiled from `sources`
    with `flags` and linked with `libs` where it is missing; `declare(lib)`
    sets its functions' types once, when it is first loaded. Raises
    RuntimeError, with the compiler's or the loader's output, where it does
    not build or load, and again at every later call."""
    key = (name, tuple(map(str, sources)), tuple(flags), tuple(libs), subdir)
    lib = _hosts.get(key)
    if lib is not None:
        return lib
    with _lock:
        if key in _failed:
            raise RuntimeError(_failed[key])
        if key in _hosts:
            return _hosts[key]
        try:
            out = host_lib_path(name, sources, flags, libs, subdir)
            if not out.exists():
                cxx = host_compiler()
                _compile([(name, lambda tmp: [
                    cxx, *flags, "-shared", "-o", str(tmp), *map(str, sources),
                    *libs], out)])
            lib = ctypes.CDLL(str(out))
            if declare is not None:
                declare(lib)
        except (RuntimeError, OSError) as exc:
            _failed[key] = f"{name}: {exc}"
            raise RuntimeError(_failed[key]) from None
        _hosts[key] = lib
        return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    return lib.cuda_error_string(code).decode()
