"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``tactile_gan_torch/_build/`` (listed in .gitignore) as a
shared library for Hopper (``sm_90a``). The file name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs at import time: the CPU tests import every
module on a host without nvcc.

    python -m tactile_gan_torch.ops.kernels.build SRC.cu [SRC.cu ...]

compiles each source with the same flags into a temporary directory and prints
ptxas's registers and spills for each kernel in it (to compare two versions
of a source).
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# Every source builds with these flags. ptxas of CUDA 12.9 segfaults on the
# wgmma sources when their fence.proxy.async (which they need: without it
# the products read stale shared memory) is inlined, at -O3 and at -O1 too:
# both keep the fence in a __noinline__ function, which builds at every
# level with no spills, and -O3 ran faster than -O1.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) and the nvcc seconds of
# each build this process made, by kernel source name.
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def build_all(names: Iterable[str]) -> None:
    """Build several kernels at once: one nvcc process per source."""
    names = list(names)
    with cf.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()


def ptxas_report(log: str) -> Dict[str, str]:
    """Kernel -> "N registers, S B spill stores, L B spill loads" from
    ptxas's -v report; names demangled where c++filt is on PATH."""
    regs, spills, cur = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            cur = m.group(1)
        elif cur and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            spills[cur] = f"{st} B spill stores, {ld} B spill loads"
        elif cur and "registers" in line:
            regs[cur] = re.search(r"Used (\d+) registers", line).group(1)
    names = list(regs)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    return {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", p):
            f"{regs[n]} registers, {spills.get(n, 'spills not reported')}"
            for n, p in zip(names, plain)}


def compile_report(src: str) -> Dict[str, str]:
    """ptxas's report for one source compiled with NVCC_FLAGS into a
    temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(tmp, "k.so"), src],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return ptxas_report(proc.stderr)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


if __name__ == "__main__":
    paths = sys.argv[1:]
    with cf.ThreadPoolExecutor(max_workers=max(1, len(paths))) as pool:
        reports = list(pool.map(compile_report, paths))
    for path, report in zip(paths, reports):
        for kernel, line in sorted(report.items()):
            print(f"{path}: {kernel}: {line}")
