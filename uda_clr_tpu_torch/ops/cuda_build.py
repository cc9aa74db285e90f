"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at first use
and loaded with ctypes. The library's name carries a digest of its source
and of the headers in ``csrc/``, so an edit rebuilds it. :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

P, I64, U64, U32, F32, INT = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                              ctypes.c_uint, ctypes.c_float, ctypes.c_int)


class KernelLibrary:
    """One ``csrc/<name>.cu`` (or a source at another path, which finds
    the headers of ``csrc/`` too); ``signatures`` maps each ``extern "C"``
    entry to its ctypes argument types (every entry returns an int, the
    CUDA error of its launch)."""

    def __init__(self, source_name: str, signatures: dict[str, list]):
        self.source = CSRC / source_name
        self.signatures = signatures
        self.lib = None
        self.log = ""

    def so_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        # the headers beside the source come first on nvcc's include path
        for header in sorted({*self.source.parent.glob("*.cuh"), *CSRC.glob("*.cuh")}):
            h.update(header.read_bytes())
        return BUILD_DIR / f"libuda_{self.source.stem}_{h.hexdigest()[:16]}.so"

    def start(self):
        """Start nvcc if the library is neither loaded nor built; returns
        the process (or None) for :meth:`finish`."""
        so = self.so_path()
        if self.lib is not None or so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC), "-o", str(tmp),
             str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self, proc) -> None:
        if proc is None:
            return
        self.log, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{self.log}")
        os.replace(tmp, self.so_path())

    def load(self):
        """Build if needed, load, and return the ctypes library."""
        if self.lib is None:
            self.finish(self.start())
            lib = ctypes.CDLL(str(self.so_path()))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self.lib = lib
        return self.lib


def build_all(libraries) -> None:
    """Compile every library not built yet, all nvcc processes at once,
    then load them all."""
    procs = [lib.start() for lib in libraries]
    for lib, proc in zip(libraries, procs):
        lib.finish(proc)
    for lib in libraries:
        lib.load()


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
