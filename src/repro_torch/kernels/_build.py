"""Build and load the CUDA C++ kernels of ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/repro_torch_kernels/``
at the repository root, keyed by a hash of the sources and flags; a library
is built at its first use and reused after.  ``build_all`` starts one
``nvcc`` per source at once, which is how a fresh checkout builds everything.
Libraries are loaded with ``ctypes``: pointers and the stream travel as
``c_void_p``, and every C entry returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("rmsnorm", "swiglu", "flash_attention", "flash_attention_bwd",
           "cross_entropy", "layernorm", "gelu_mlp", "grouped_mlp", "ssd_scan",
           "wkv_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda``,
    then ``PATH``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine that has the card")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Build every library that is missing, one ``nvcc`` per source, all at
    once.  Returns ``{name: {"seconds", "log", "cached"}}``; ``log`` holds
    what ``nvcc``/``ptxas`` printed (registers, shared memory, spills)."""
    t0 = time.monotonic()
    started = {}
    report = {}
    for name in names:
        if lib_path(name).exists():
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
        else:
            started[name] = _start(name)
    errors = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.monotonic() - t0, "log": log,
                        "cached": False}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the current stream's raw handle with no Stream object made (what Triton's
# launcher reads); CPU-only builds of torch lack it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def dtype_code(t) -> int:
    """The ``DTYPE_*`` code of ``csrc/common.cuh`` for a tensor's dtype;
    the kernels take bf16 and fp32 and nothing else."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return code


def stream_of(t) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t, nbytes: int = 16):
    """``t`` contiguous with a ``nbytes``-aligned base pointer (a copy only
    when a view starts mid-vector); the vector loads need both."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def int_triples(entry, *args) -> list[tuple[int, ...]]:
    """The (a, b, c) triples a plan entry of a kernel source writes: called
    with no room, it returns their count (negative: arguments refused); then
    again with room for all of them."""
    n = entry(*args, None, 0)
    if n < 0:
        raise ValueError(f"{entry.__name__}{args}: refused")
    buf = (ctypes.c_int * (3 * n))()
    entry(*args, buf, n)
    return [tuple(buf[3 * i:3 * i + 3]) for i in range(n)]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
