"""Build and bind the port's CUDA kernels: ``nvcc`` by hand into a shared
library with a plain C interface, loaded with ``ctypes``.

Every source under ``ipex_llm_tpu_torch/csrc`` is compiled for ``sm_90a``
at first use into ``ipex_llm_tpu_torch/_build`` (a directory git ignores),
under a name that hashes the source and the flags, so an edited source never
loads a stale library.  :func:`build` starts one ``nvcc`` per source, all at
once, and waits for all of them.  Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class Counts:
    """Launch accounting of one kernel wrapper: ``launches`` counts kernel
    launches (the wrapper adds one for each kernel it launches, where it
    launches them, nowhere else);
    ``plain_calls`` counts calls of the plain PyTorch version, so a run on
    the card can show the plain path was never taken; ``by_head_dim``
    splits the launches of a kernel with more than one head-dim instance."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = 0
        self.plain_calls = 0
        self.by_head_dim = collections.Counter()


def through(counts: Counts, inner: Counts, call):
    """A sharded wrapper's accounting: run ``call`` (one call of the
    unsharded wrapper whose counts are ``inner``) and add the launches and
    plain calls it made to ``counts``; returns its result."""
    launches, plain = inner.launches, inner.plain_calls
    out = call()
    counts.launches += inner.launches - launches
    counts.plain_calls += inner.plain_calls - plain
    return out


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers too: a library is stale when one of them changes
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names) -> float:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the wall seconds
    spent; raises with the compiler's output on a failed build."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = open(BUILD_DIR / f"{name}.log", "w", encoding="utf-8")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + (BUILD_DIR / f"{name}.log").read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use;
    ``declare(lib)`` sets its functions' ``argtypes``/``restype``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            declare(lib)
            _libs[name] = lib
        return lib


def sources(mods) -> list[str]:
    """The ``csrc`` sources of kernel wrapper modules: a module's
    ``SOURCES`` (one for each instance) where it has them, else its
    ``NAME``."""
    return [src for m in mods
            for src in getattr(m, "SOURCES", {m.NAME: m.NAME}).values()]


def sass_counts(name: str, opcode: str = "HMMA") -> dict[str, int]:
    """Instructions whose text holds ``opcode`` in each kernel of the built
    library for ``csrc/<name>.cu`` (``cuobjdump -sass``), by mangled kernel
    name: shows which instances run on the tensor cores."""
    tool = Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path(name))],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    counts: dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def check(err: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_handle(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a ctypes pointer (the
    engine thread launches on its own current stream)."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
