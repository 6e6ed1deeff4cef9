"""Build and load the port's CUDA kernels.

On first use, ``nvcc`` compiles every ``clover_tpu_torch/csrc/*.cu`` (one
process per source, all at once) and links them into one shared library
with a plain C interface (``sm_90a``), which is loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused. The build directory
(``clover_tpu_torch/_build/``) is git-ignored.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
:func:`launch` raises when that is not 0, so a refused launch (too much
shared memory, a bad argument) never passes silently. :func:`launch` takes
the device buffers as tensors and turns them into pointers itself.

``python3 -m clover_tpu_torch.ops._build`` compiles each source once more
with ``-Xptxas -v`` and prints every kernel's registers and spills.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each C entry point; pointers and the stream are c_void_p
_SIGNATURES = {
    "clover_layer_norm": (_P,) * 4 + (_I,) * 6 + (_F, _P),
    "clover_ln_mlp_residual": (_P,) * 13 + (_I,) * 4 + (_F, _I, _P),
    "clover_mlp_postln": (_P,) * 11 + (_I,) * 4 + (_F, _P),
    "clover_window_attention": (_P,) * 4 + (_I,) * 7 + (_F, _P),
    "clover_window_attention_bwd": (_P,) * 9 + (_I,) * 8 + (_F, _P),
    "clover_attn_block_qkv": (_P,) * 7 + (_I, _I, _F, _P),
    "clover_attn_block_attention": (_P,) * 4 + (_I,) * 4 + (_F, _P),
    "clover_attn_block_proj": (_P,) * 6 + (_I,) * 3 + (_P,),
    "clover_mlp_bwd_passes": (_P,) * 22 + (_I,) * 8 + (_F, _I, _P),
    "clover_window_attention_heads": (_P,) * 6 + (_I,) * 6 + (_F, _P),
    "clover_window_attention_spatial": (_P,) * 4 + (_I,) * 10 + (_F, _P),
    "clover_flash_heads": (_P,) * 6 + (_I,) * 4 + (_F, _P),
    "clover_flash_flat": (_P,) * 4 + (_I,) * 4 + (_F, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build this process ran, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")
    return str(path)


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libclover_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the stderr of the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{err}")
    if failed:
        raise RuntimeError("kernel build failed (" + "\n".join(failed) + ")")


def _compile(target: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    units = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in units]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    try:
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                  for p, o in zip(units, objs)])
        _run_all([[_nvcc(), "-shared", "-o", str(tmp), *(str(o) for o in objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, target)   # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.clover_error_string.argtypes = (ctypes.c_int,)
            lib.clover_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def entry(name: str):
    """C entry ``name`` of the loaded library (built first if its sources
    changed), for a wrapper that calls it with the pointers of tensors it
    holds through the call and hands the return code to :func:`check`."""
    return getattr(library(), name)


def check(name: str, rc: int) -> None:
    """Raise if C entry ``name`` returned a CUDA error."""
    if rc != 0:
        msg = library().clover_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def launch(name: str, *args) -> None:
    """Call C entry ``name``; raise if its launch reported a CUDA error.

    Device buffers are passed as tensors, not as raw pointers, so each one
    is alive until its kernel is queued: a temporary freed before that
    could be handed by the caching allocator to a buffer the kernel
    writes, and the kernel would overwrite its own input."""
    check(name, entry(name)(*(a.data_ptr() if hasattr(a, "data_ptr") else a for a in args)))


def require(t, name: str, dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    on ``device`` (and of ``shape``, when given): what the kernels assume."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it, without
    making a Stream object (a few microseconds of host time a call)."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def sms(device) -> int:
    """The card's SM count, which the wrappers size their grids by."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def ptxas_report() -> str:
    """Each kernel's registers, shared memory and spills as ptxas reports
    them (the sources compiled with -Xptxas -v into a scratch directory)."""
    import tempfile

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in (p for p in _sources() if p.suffix == ".cu"):
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                                   str(Path(tmp) / f"{src.stem}.o"), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{src.name}: build failed:\n{proc.stderr}")
            lines += [f"{src.name}: {ln.split(':', 1)[-1].strip()}"
                      for ln in proc.stderr.splitlines()
                      if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return "\n".join(lines)


if __name__ == "__main__":
    print(ptxas_report())
