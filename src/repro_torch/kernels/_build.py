"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Each ``kernels/**/csrc/*.cu`` source is compiled on first use into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) under ``build/repro_torch/`` at the root of the checkout.
A library's file name carries a digest of its source and of the headers
beside it, so an edited kernel is rebuilt and an unchanged one is loaded
as it is. Sources that need building are compiled by concurrent ``nvcc``
processes. A failed build or load raises :class:`KernelError` with the
command and the compiler's output; nothing falls back to the plain versions.
Each build and each load counts once on ``obs.compile``'s monitor, under
the library's name: the port's "trace" of a hot path, which a no-retrace
contract holds at zero.

Nothing here runs at import time: importing the port needs neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc seconds per library, summed over its builds in this process.
BUILD_SECONDS: dict[str, float] = {}


class KernelError(RuntimeError):
    """A kernel did not build, load or launch. It marks a fault of the port,
    never a load condition: callers let it through instead of serving the
    plain version in its place."""


def sources() -> dict[str, Path]:
    """Every kernel source of the port, by library name (the file stem)."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("**/csrc/*.cu"))}


def nvcc() -> str:
    """Path of the CUDA compiler: ``PATH``, then ``$CUDA_HOME``, then the
    toolkit's default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    """Path of library ``name`` as built from its current source."""
    return _target(sources()[name])


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (all by default) that are not built yet.

    All ``nvcc`` processes start together and are waited for. The
    compiler's ``-Xptxas -v`` report is kept beside each library
    (:func:`ptxas_report`). Each library built adds its ``nvcc`` seconds to
    :data:`BUILD_SECONDS` and counts one build on ``obs.compile``'s monitor.
    Returns the library path of every name.
    """
    from repro_torch.obs import compile as obs_compile

    srcs = sources()
    names = list(srcs) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        src = srcs[name]
        lib = _target(src)
        out[name] = lib
        if lib.is_file():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        started = time.perf_counter()
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, cmd, proc, tmp, lib, started))
    failures, built = [], []
    for name, cmd, proc, tmp, lib, started in running:
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = BUILD_SECONDS.get(name, 0.0) + time.perf_counter() - started
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        built.append(name)
    if failures:
        raise KernelError("nvcc failed:\n" + "\n".join(failures))
    for name in built:
        obs_compile.mark(name)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"cannot load {path}: {e}") from e
        _LIBS[name] = lib
        from repro_torch.obs import compile as obs_compile

        obs_compile.mark(name)
    return lib


def bind(name: str, symbol: str, argtypes: list, *, errors: str):
    """Entry point ``symbol`` of library ``name`` with its argument types set,
    and a ``check(status)`` that raises :class:`KernelError` with the message
    the library's ``errors`` function gives for a non-zero status."""
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = getattr(lib, errors)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p

    def check(status: int) -> None:
        if status != 0:
            raise KernelError(
                f"{symbol} launch failed: {err(status).decode()} (status {status})"
            )

    return fn, check


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(name: str) -> list[dict]:
    """Registers, static shared memory and spills of each kernel entry, as
    ``nvcc -Xptxas -v`` reported them when ``name`` was built."""
    log = _target(sources()[name]).with_suffix(".log").read_text()
    rows, cur = [], None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            cur = {"entry": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := _SPILL.search(line)):
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
            smem = _SMEM.search(line)  # absent when all of it is dynamic
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows
