"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each kernel is one `.cu` source with a plain C entry point, so nvcc
compiles it in seconds (a source that includes PyTorch's headers takes
minutes). The shared library goes under the checkout's `build/kernels/`
(listed in `.gitignore`) at first use. Its file name carries a hash of
the source, the flags and the compiler, so an edited source builds anew
and an unchanged one is loaded as it is. Building needs the CUDA toolkit
and happens only when a kernel is first launched, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

#: sm_90a, not sm_90: later kernels need wgmma and setmaxnreg. No
#: --use_fast_math (its __expf/__powf miss the kernels' tolerances) and
#: no fused multiply-add, so each float op rounds as in the plain
#: PyTorch version. -Xptxas=-v reports registers and spills in the log.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


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
    through the kernel.
    """

    def __init__(self, name: str, source: Path, entry: str, argtypes):
        self.name = name
        self.source = Path(source)
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        h.update(nvcc_path().encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def function(self):
        """The bound C entry point, building the library if needed."""
        if self._fn is None:
            lib = self.library_path()
            if not lib.exists():
                self._build(lib)
            fn = getattr(ctypes.CDLL(str(lib)), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _build(self, lib: Path) -> None:
        """Compile the source into `lib`; raises RuntimeError with nvcc's
        output if the build fails."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed: {self.name} "
                               f"(nvcc exit {proc.returncode}):\n"
                               f"{self.build_log}")
        # atomic: a concurrent build of the same source is harmless
        os.replace(tmp, lib)
