"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled once,
at first use, into ``build/kernels/`` at the root of the checkout (a
directory git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

The file name carries a hash of the source, of every header under
``csrc/`` (``*.cuh``, ``*.h``: what a source can include) and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. ``build_all`` starts one ``nvcc`` per source, all at once.
``ptxas``'s report (registers, shared memory, spills per kernel) is kept
beside the library as ``.log``. Nothing here runs when the package is
imported: the CPU tests import every module on a machine without ``nvcc``.

Each ops module declares the C entry points it calls (``load``), and
launches them with the helpers at the end of this file: ``on_cpu`` (the
dispatch rule every wrapper follows), ``ptr``, ``stream`` and
``on_device``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Mapping, Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_DEFAULT = pathlib.Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_declared = set()


def nvcc() -> str:
    """Path of the CUDA compiler; raises where there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of this package cannot be built")


def _headers() -> Sequence[pathlib.Path]:
    return sorted(p for p in CSRC.rglob("*") if p.suffix in (".cuh", ".h"))


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` is built to (hash of the source, the
    headers it can include and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in _headers():
        h.update(str(header.relative_to(CSRC)).encode() + b"\0")
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, pathlib.Path]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` process per source, all running at once; raise if any fails."""
    outs = {name: library_path(name) for name in names}
    todo = [name for name, out in outs.items() if not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
    procs = {}
    for name in todo:
        tmp = outs[name].with_name(f"{outs[name].name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{stderr}")
            continue
        outs[name].with_suffix(".log").write_text(stdout + stderr)
        # atomic: concurrent builders never see half a file
        os.replace(tmp, outs[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_all([name])[name]


def load(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare every entry
    point of ``signatures`` (C name -> argtypes) with an ``int`` result,
    the ``cudaError_t`` that the entry point returns. Modules that call
    different entry points of one library each declare their own."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.tmx_error_string.argtypes = [ctypes.c_int]
            lib.tmx_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        for fn, argtypes in signatures.items():
            if (name, fn) not in _declared:
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
                _declared.add((name, fn))
        return lib


def check(lib: ctypes.CDLL, fn: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.tmx_error_string(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")


def on_cpu(x: torch.Tensor) -> bool:
    """The dispatch rule of every wrapper: a CPU tensor → the plain
    version; a CUDA tensor → the kernel; anything else raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise RuntimeError(f"the port's kernels run on cuda or cpu tensors, "
                       f"not {x.device}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def stream(device) -> int:
    """The current CUDA stream of ``device``, as a ``cudaStream_t``: read
    with the raw accessor that PyTorch's own generated kernels launch with,
    since ``torch.cuda.current_stream`` builds a ``Stream`` object, several
    microseconds per launch."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def on_device(device):
    """``torch.cuda.device(device)``, or a no-op where ``device`` is already
    the current one: entering that context costs several microseconds,
    which a wrapper whose kernel runs for a few tens of them feels."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
