"""First-use builder for the port's native sources in `csrc/`.

Each source compiles to its own shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds):

- `gf2_matmul.cu` with `nvcc` for `sm_90a` (Hopper), the GF(2^8) codec
  kernel behind ops/rs_cuda.py;
- `clay_fused.cu` with `nvcc` for `sm_90a`, the fused Clay encode and
  repair kernels behind ops/clay_cuda.py;
- `crc32c.cpp` with the host `g++`, the needle checksum behind
  storage/crc.py.

Libraries go to `seaweedfs_tpu_torch/build/` (git-ignored), named by a hash
of the source, the headers it may include (`csrc/*.cuh`, e.g. the
bit-slicing helpers both CUDA sources share) and the command, so an edited
source or header rebuilds and an unchanged one loads from the previous
build.  `build()` starts every compiler it needs at once and waits for all
of them.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

SOURCES = {"gf2_matmul": "gf2_matmul.cu", "clay_fused": "clay_fused.cu",
           "crc32c": "crc32c.cpp"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler stderr of the last build of each library (ptxas register and
# shared-memory report for the CUDA kernel)
build_logs: dict[str, str] = {}


class BuildError(RuntimeError):
    pass


def _nvcc() -> "str | None":
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cuda if os.path.exists(cuda) else None


def _command(name: str, src: str, out: str) -> list[str]:
    if src.endswith(".cu"):
        nvcc = _nvcc()
        if nvcc is None:
            raise BuildError(f"nvcc not found: the CUDA toolkit is needed to "
                             f"build {SOURCES[name]}")
        return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                "-Xcompiler", "-fPIC", "-o", out, src]
    gxx = shutil.which("g++")
    if gxx is None:
        raise BuildError("g++ not found")
    return [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", out, src]


def _target(name: str) -> tuple[str, list[str]]:
    """(library path, compile command) for one source; the path carries a
    hash of the source bytes, of every header `csrc/*.cuh` a CUDA source
    may include, and of the command."""
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    if src.endswith(".cu"):
        for header in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(header, "rb") as f:
                digest.update(os.path.basename(header).encode() + b"\0"
                              + f.read())
    cmd = _command(name, src, "{out}")
    digest.update(" ".join(os.path.basename(c) for c in cmd).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    return so, cmd


def build(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile every named library that is not built yet, all compilers
    running at once.  Returns {name: library path}; raises BuildError
    naming the compiler's last output for any that failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, running = {}, {}
    for name in names:
        so, cmd = _target(name)
        paths[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        argv = [tmp if c == "{out}" else c for c in cmd]
        running[name] = (subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, so)
    errors = []
    for name, (proc, tmp, so) in running.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        build_logs[name] = log.decode(errors="replace")
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            errors.append(f"{name}: exit {proc.returncode}: "
                          f"{build_logs[name][-2000:]}")
    if errors:
        raise BuildError("; ".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build((name,))[name])
            _libs[name] = lib
        return lib
