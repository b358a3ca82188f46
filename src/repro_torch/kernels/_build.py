"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source in ``kernels/csrc/*.cu`` becomes one shared library with a
plain C interface, compiled for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
         -shared -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so \
         kernels/csrc/<name>.cu

The library name carries a hash of the source, so an edited kernel is
never served from a stale build.  Libraries land in ``build/repro_torch/``
at the root of the checkout (listed in ``.gitignore``); the first use
builds them, so a fresh checkout needs nothing but ``nvcc``.  All
sources are compiled in parallel, one ``nvcc`` process each.
``--use_fast_math`` is never passed: the kernels rely on IEEE division.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py -> the checkout root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict = {}


def sources():
    """Every kernel source of the port, by name."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``,
    or ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def lib_path(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None, verbose: bool = False) -> dict:
    """Compile every (or each named) kernel whose library is missing, all
    ``nvcc`` processes started together; returns ``{name: path}``.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: lib_path(n) for n in names if not lib_path(n).is_file()}
    procs = {}
    if todo:
        nvcc = find_nvcc()
        for n, out in todo.items():
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(tmp), str(srcs[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (rc {proc.returncode}):\n"
                          f"{log}")
            continue
        if verbose and log:
            print(log, end="")
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: lib_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def build_variants(name, variants, names):
    """Compile variants of kernel ``name`` for the tune scripts: variant
    ``v`` is the source with the text substitutions ``variants[v][1]``
    (``((old, new), ...)``), written and built with ``NVCC_FLAGS`` into
    ``build/repro_torch/variants/`` (all ``nvcc`` processes started
    together); returns ``{v: ctypes.CDLL}``."""
    src = sources()[name].read_text()
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for v in names:
        text = src
        for old, new in variants[v][1]:
            if old not in text:
                raise ValueError(f"variant {v}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}_{v}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}_{v}.so"
        procs[v] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for v, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        libs[v] = ctypes.CDLL(str(lib))
    return libs
