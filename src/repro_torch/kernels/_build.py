"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each kernel is one `.cu` source with a plain C entry point, so nvcc
compiles it in seconds (a source that includes PyTorch's headers takes
minutes). The shared library goes under the checkout's `build/kernels/`
(listed in `.gitignore`) at first use. Its file name carries a hash of
the source, the shared headers (`*.cuh` beside this module), the flags
and the compiler, so an edited source builds anew and an unchanged one
is loaded as it is. Building needs the CUDA toolkit
and happens only when a kernel is first launched, never at import.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

#: sm_90a, not sm_90: later kernels need wgmma and setmaxnreg. No
#: --use_fast_math (its __expf/__powf miss the kernels' tolerances).
#: -Xptxas=-v reports registers and spills in the log. A kernel adds its
#: own flags (`CudaKernel.flags`), e.g. --fmad=false where each float op
#: must round as in the plain PyTorch version.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else the one on PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the port's CUDA kernels build with it")
    return found


class CudaKernel:
    """One hand-written CUDA kernel: its source, its C entry point and
    the count of its launches.

    `launches` is a plain integer that the kernel's wrapper raises by one
    at each launch and nowhere else, so a run can show that it went
    through the kernel. `variant_launches` counts, by name, the launches
    of a variant among them where the wrapper tells its variants apart
    (flash_attention's "noncausal").
    """

    def __init__(self, name: str, source: Path, entry: str, argtypes,
                 flags=()):
        self.name = name
        self.source = Path(source)
        self.entry = entry
        self.argtypes = list(argtypes)
        self.flags = tuple(flags)
        self.launches = 0
        self.variant_launches = collections.Counter()
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(KERNELS_DIR.glob("*.cuh")):    # shared helpers
            h.update(header.read_bytes())
        h.update(" ".join(self.command_flags()).encode())
        h.update(nvcc_path().encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def command_flags(self) -> tuple[str, ...]:
        return NVCC_FLAGS + self.flags

    def function(self):
        """The bound C entry point, building the library if needed."""
        if self._fn is None:
            lib = self.library_path()
            if not lib.exists():
                self._finish(lib, self._start(lib))
            fn = getattr(ctypes.CDLL(str(lib)), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    @staticmethod
    def _tmp(lib: Path) -> Path:
        return lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")

    def _start(self, lib: Path) -> subprocess.Popen:
        """Start nvcc on the source, writing a temporary next to `lib`."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return subprocess.Popen(
            [nvcc_path(), *self.command_flags(), "-o", str(self._tmp(lib)),
             str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def _finish(self, lib: Path, proc: subprocess.Popen) -> None:
        """Wait for nvcc; raises RuntimeError with its output if the
        build failed, else moves the library into place."""
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed: {self.name} "
                               f"(nvcc exit {proc.returncode}):\n"
                               f"{self.build_log}")
        # atomic: a concurrent build of the same source is harmless
        os.replace(self._tmp(lib), lib)


def build_all(kernels) -> None:
    """Build every kernel of `kernels` that is not built yet, one nvcc
    per source, all started together; then bind each."""
    started, failures = [], []
    try:
        for k in kernels:
            lib = k.library_path()
            if k._fn is None and not lib.exists():
                started.append((k, lib, k._start(lib)))
    finally:            # wait for every nvcc that did start
        for k, lib, proc in started:
            try:
                k._finish(lib, proc)
            except RuntimeError as err:
                failures.append(str(err))
    if failures:
        raise RuntimeError("\n".join(failures))
    for k in kernels:
        k.function()
