"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled once,
at first use, into ``build/kernels/`` at the root of the checkout (a
directory git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

The file name carries a hash of the source, of every header under
``csrc/`` (``*.cuh``, ``*.h``: what a source can include) and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. A library of more than one source (``PARTS``) compiles each to an
object with ``-c`` and links them into the one library. ``build_all``
starts one ``nvcc`` per source, all at once.
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

# libraries built from more than one source: attn_block's bf16-storage
# instances (the same kernels on bf16 tensors: the attention's, the GEMM's)
# compile beside its fp32 ones, in parallel: as one translation unit the
# three sources build far slower (scripts/time_build.py times both layouts)
PARTS = {"attn_block": ("attn_block_s16", "gemm_s16")}

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


def sources(name: str) -> Sequence[str]:
    """The sources (``csrc/<source>.cu``) of library ``name``."""
    return (name, *PARTS.get(name, ()))


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` is built to (hash of its sources, the
    headers they can include and the flags)."""
    h = hashlib.sha256()
    for source in sources(name):
        h.update((CSRC / f"{source}.cu").read_bytes())
    for header in _headers():
        h.update(str(header.relative_to(CSRC)).encode() + b"\0")
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _run_all(cmds: Mapping[str, Sequence[str]]) -> Dict[str, tuple]:
    """Run every command at once; (returncode, stdout + stderr) by key."""
    procs = {key: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for key, cmd in cmds.items()}
    done = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate()
        done[key] = (proc.returncode, stdout + stderr)
    return done


def build_all(names: Sequence[str]) -> Dict[str, pathlib.Path]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` process per source, all running at once (then the link of a
    library of several sources); raise if any fails."""
    outs = {name: library_path(name) for name in names}
    todo = [name for name, out in outs.items() if not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
    tmps = {name: outs[name].with_name(f"{outs[name].name}.{os.getpid()}.tmp")
            for name in todo}
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    cmds = {}
    for name in todo:
        parts = sources(name)
        for source in parts:
            cu = str(CSRC / f"{source}.cu")
            if len(parts) == 1:
                cmds[name, source] = [compiler, *NVCC_FLAGS, "-o",
                                      str(tmps[name]), cu]
            else:
                obj = tmps[name].with_suffix(f".{source}.o")
                cmds[name, source] = [compiler, *compile_flags, "-c", "-o",
                                      str(obj), cu]
    errors, failed, logs = [], set(), {name: "" for name in todo}
    for (name, source), (code, log) in _run_all(cmds).items():
        logs[name] += log
        if code != 0:
            failed.add(name)
            errors.append(f"nvcc failed for {source}.cu (exit {code}):\n{log}")
    links = {name: [compiler, "-shared", "-o", str(tmps[name]),
                    *(str(tmps[name].with_suffix(f".{source}.o"))
                      for source in sources(name))]
             for name in todo if len(sources(name)) > 1 and name not in failed}
    for name, (code, log) in _run_all(links).items():
        if code != 0:
            failed.add(name)
            errors.append(f"nvcc failed to link {name} (exit {code}):\n{log}")
    for name in todo:
        for source in sources(name):
            tmps[name].with_suffix(f".{source}.o").unlink(missing_ok=True)
        if name in failed:
            tmps[name].unlink(missing_ok=True)
            continue
        outs[name].with_suffix(".log").write_text(logs[name])
        # atomic: concurrent builders never see half a file
        os.replace(tmps[name], outs[name])
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
