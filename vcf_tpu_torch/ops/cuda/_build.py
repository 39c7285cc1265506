"""Build and load the port's CUDA kernels (no JAX counterpart).

`load()` compiles every `vcf_tpu_torch/csrc/*.cu` with nvcc for sm_90a,
one nvcc process per source, all started together, links the objects
into one shared library with a plain C interface, and loads it with
ctypes.  The library lands in `vcf_tpu_torch/_build/` (listed in
.gitignore) under a name that carries a hash of the sources, so an edit
to any source builds anew and a stale library is never loaded.  A build
takes seconds: no source includes PyTorch's headers.

Each C entry returns `cudaGetLastError()` after its launch; `check`
raises on a non-zero code.  The build needs nvcc (PATH, or
/usr/local/cuda/bin); without one, `load` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _FP = ctypes.c_float, ctypes.POINTER(ctypes.c_float)
# both DCT entries take the DCT matrix on the host (they pass it to their
# kernels by value)
_DCT = [_P, _P, _FP, _P, _FP, _I, _I, _I, _I, _I, _F, _I, _I, _P]
# C entry -> argtypes; every pointer and the stream are c_void_p so
# ctypes never narrows them to a 32-bit int
_SIGNATURES = {
    "vcf_rans_encode_grouped": [_P, _P, _P, _P, _I, _I, _I, _P],
    "vcf_rans_encode_tile": [],
    "vcf_rans_encode_plan": [_I, _I, _I],
    "vcf_rans_compact_tile": [],
    "vcf_rans_compact": [_P, _LL, _I, _I, _P, _P, _P, _P],
    "vcf_rans_compact_rows": [_P, _I, _I, _P, _P, _P],
    "vcf_rans_decode_threads": [],
    "vcf_rans_decode_grouped": [_P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vcf_rans_encode_ctx": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vcf_rans_decode_ctx_smem": [_I, _I],
    "vcf_rans_decode_ctx": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P],
    "vcf_rans_decode_lookback_lanes": [],
    "vcf_rans_decode_lookback_smem": [_I, _I, _I],
    "vcf_rans_decode_lookback": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _P],
    "vcf_rans_decode_grid": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vcf_rans_decode_ctx_grid": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vcf_rans_decode_grid_plan": [_I, _I, _I, _P],
    "vcf_dct_forward": _DCT,
    "vcf_dct_inverse": _DCT,
    "vcf_sad_smem": [_I, _I],
    "vcf_sad_mode": [_I, _I],
    "vcf_sad_search": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vcf_mc_mode": [_P, _P, _I, _I, _I],
    "vcf_mc_apply": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvcf_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Start every command at once, wait for all; raise with the output
    of the first that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                      f"{out}\n{err}")
    if failed:
        raise RuntimeError(failed)


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile into a private directory, then rename: a concurrent process
    # never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(SRC_DIR.glob("*.cu"))
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, f"-I{SRC_DIR}", "-c", str(src), "-o", obj]
                  for src, obj in zip(srcs, objs)])
        out = os.path.join(tmp, lib.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]])
        os.replace(out, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; cached per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def runs_plain(tensor) -> bool:
    """True for a CPU tensor (a wrapper then runs its plain version),
    False for a CUDA tensor (it launches its kernel); raise for any other
    device."""
    return plain_on(tensor.device)


def plain_on(device) -> bool:
    """`runs_plain` for a tensor on `device`."""
    device = torch.device(device)
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def stream_of(tensor) -> int:
    """The raw handle of PyTorch's current stream on `tensor`'s device."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
