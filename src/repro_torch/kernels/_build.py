"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` for ``sm_90a``. The hash covers the source
and the flags, so an edited source builds anew and an unchanged one is
loaded as it is. ``build()`` starts one ``nvcc`` per source, all at once.
Building happens at first use, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float            # 0.0 when an earlier build was reused
    ptxas: list[str]          # the "Used N registers ..." lines


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if nvcc is None and (toolkit / "bin" / "nvcc").exists():
        nvcc = str(toolkit / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines() if "Used" in ln]


def build(names: list[str] | None = None) -> dict[str, Built]:
    """Build every named kernel source (default: all) whose library is
    missing or stale, with one ``nvcc`` process per source running at once.
    Raises with the compiler's output if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: dict[str, Built] = {}
    running: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    try:
        for name in names:
            out = library_path(name)
            log = out.with_suffix(".ptxas.txt")
            if out.exists():
                text = log.read_text() if log.exists() else ""
                done[name] = Built(name, out, 0.0, _ptxas_lines(text))
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in running.items():
            text, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"== {name} (rc {proc.returncode})\n{text}")
                continue
            out.with_suffix(".ptxas.txt").write_text(text)
            # lint: ok(durability-rename) — a build output, rebuilt from source if lost
            os.replace(tmp, out)
            done[name] = Built(name, out, seconds, _ptxas_lines(text))
    finally:
        for proc, _, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return done


def load(name: str, fn: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    ``argtypes`` declared on its launch function ``fn`` (which returns the
    ``cudaGetLastError()`` code after its launches)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# -- helpers shared by the wrappers ------------------------------------------
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    """The ``dtype`` argument of every launch function: 0 f32, 1 bf16."""
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
