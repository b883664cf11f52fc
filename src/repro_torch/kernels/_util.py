"""Shared helpers for the port's kernels: padding, the device rule, the build.

Device rule (the counterpart of ``repro.kernels._util.on_tpu`` /
``default_interpret``): a wrapper decides by the tensor it is given.  A CUDA
tensor launches the hand-written kernel (or the wrapper raises); a CPU
tensor runs the kernel's plain PyTorch version.  There is no fallback from
one to the other.

Build: each ``csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc -shared`` into its own library under ``_build/`` (listed in
``.gitignore``) at first use, then loaded with ``ctypes``.  Sources are
compiled in parallel, one ``nvcc`` process each; the library name carries a
hash of its source, so an edited kernel is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("hamming", "cim_matmul", "cim_planes")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pad_axis_to(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to ``size`` (no-op if already there)."""
    axis = axis % x.ndim
    cur = x.shape[axis]
    if cur == size:
        return x
    pads = [0, 0] * (x.ndim - axis - 1) + [0, size - cur]
    return F.pad(x, pads)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Entry-point device: CUDA unless the caller asks for the CPU.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    card: the port never runs silently on the CPU in place of the card.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}; expected cuda or cpu")


def check_cuda_operand(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate what a kernel takes: a contiguous CUDA tensor of ``dtype`` and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every missing kernel library, all ``nvcc`` processes at once.

    Returns ``{name: compiler output}`` for the sources built now (ptxas
    register/spill report); raises with the compiler's output on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load_kernel_lib(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_kernels((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_launch(err: int, kernel: str) -> None:
    """Raise if the C launcher reported a CUDA error (refused launch, bad config)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")



def full_f32_matmuls() -> None:
    """Run float32 matmuls and convolutions in full float32 (TF32 off).

    The port's f32 results are compared with the reference and with the
    kernels' plain versions, which TF32's 10-bit mantissa would swamp.
    Entry points (the serve CLI, ``chip_smoke.py``) call this once.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
