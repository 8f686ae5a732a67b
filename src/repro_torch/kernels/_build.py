"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C function (no PyTorch headers), is
compiled for Hopper into ``build/torch_kernels/lib<name>-<hash>.so`` at the
root of the checkout, and is loaded once per process.  The file name carries
a hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  A library of ``DEFINES`` is built from
another's source with a macro defined (``matmul_z``: the matmul kernel's
instances that also write the pre-activation, compiled beside the others
and not in their build).  ``build()`` starts one ``nvcc`` per library, all
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("matmul", "matmul_z", "matmul_int8", "flash_attention",
           "flash_attention_train", "flash_attention_bwd", "ssd_scan",
           "ssd_scan_bwd", "rmsnorm", "act_bwd")
#: libraries built from another library's source: (source, extra flags)
DEFINES = {"matmul_z": ("matmul", ("-DREPRO_MATMUL_ZOUT",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: each C entry point: (source library, symbol, argtypes)
SIGNATURES = {
    "matmul": ("matmul", "repro_matmul_bf16", [_P] * 7 + [_I] * 10 + [_P]),
    "matmul_z": ("matmul_z", "repro_matmul_z_bf16",
                 [_P] * 7 + [_I] * 10 + [_P]),
    "matmul_int8": ("matmul_int8", "repro_matmul_int8",
                    [_P] * 4 + [_I] * 3 + [_F] + [_I] * 3 + [_P]),
    "flash_attention": ("flash_attention", "repro_flash_attention_bf16",
                        [_P] * 10 + [_I] * 8 + [_F] + [_I] * 3 + [_P]),
    "flash_attention_dv": ("flash_attention", "repro_flash_attention_dv_bf16",
                           [_P] * 7 + [_I] * 10 + [_P]),
    "flash_attention_train": ("flash_attention_train",
                              "repro_flash_attention_train_bf16",
                              [_P] * 8 + [_I] * 8 + [_F] + [_I] + [_P]),
    "flash_attention_train_dv": ("flash_attention_train",
                                 "repro_flash_attention_train_dv_bf16",
                                 [_P] * 8 + [_I] * 10 + [_P]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "repro_flash_attention_bwd_bf16",
                            [_P] * 15 + [_I] * 8 + [_F] + [_I] * 2 + [_P]),
    "flash_attention_bwd_dv": ("flash_attention_bwd",
                               "repro_flash_attention_bwd_dv_bf16",
                               [_P] * 15 + [_I] * 11 + [_P]),
    "ssd_scan": ("ssd_scan", "repro_ssd_scan_bf16",
                 [_P] * 11 + [_L] + [_I] * 8 + [_L] * 10 + [_P]),
    "rmsnorm": ("rmsnorm", "repro_rmsnorm_bf16",
                [_P] * 4 + [_L] * 2 + [_I] * 3 + [_F] + [_I] * 3 + [_P]),
    "ssd_scan_bwd": ("ssd_scan_bwd", "repro_ssd_scan_bwd_bf16",
                     [_P] * 18 + [_I] * 7 + [_L] * 4 + [_P]),
    "rmsnorm_bwd": ("rmsnorm", "repro_rmsnorm_bwd_bf16",
                    [_P] * 6 + [_I] * 2 + [_F] + [_I] + [_P]),
    "group_rmsnorm_bwd": ("rmsnorm", "repro_group_rmsnorm_bwd_bf16",
                          [_P] * 8 + [_L] * 2 + [_I] * 3 + [_F] + [_I] * 3
                          + [_P]),
    "rmsnorm_ss": ("rmsnorm", "repro_rmsnorm_ss_bf16",
                   [_P] * 2 + [_I] * 5 + [_P]),
    "rmsnorm_apply": ("rmsnorm", "repro_rmsnorm_apply_bf16",
                      [_P] * 5 + [_I] * 2 + [_F] * 2 + [_I] * 3 + [_P]),
    "rmsnorm_bwd_partial": ("rmsnorm", "repro_rmsnorm_bwd_partial_bf16",
                            [_P] * 7 + [_I] * 3 + [_P]),
    "rmsnorm_bwd_apply": ("rmsnorm", "repro_rmsnorm_bwd_apply_bf16",
                          [_P] * 6 + [_I] * 2 + [_F] + [_I] + [_P]),
    "act_bwd": ("act_bwd", "repro_act_bwd_bf16",
                [_P] * 3 + [_L] + [_I] * 3 + [_P]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """Library ``name``'s source file and the flags beyond ``NVCC_FLAGS``."""
    source, flags = DEFINES.get(name, (name, ()))
    return CSRC / f"{source}.cu", flags


def library_path(name: str) -> Path:
    source, flags = _source(name)
    digest = hashlib.sha256(source.read_bytes() + " ".join(
        NVCC_FLAGS + flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc``
    each, all started together.  Returns seconds per library built;
    the compiler's report (registers, shared memory, spills) is kept next
    to each library as ``.log``.  Raises with the compiler's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        source, flags = _source(name)
        cmd = [nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, out)
    return seconds


def entry(name: str):
    """The loaded C entry point ``name`` (a key of ``SIGNATURES``), its
    library built if needed."""
    fn = _loaded.get(name)
    if fn is None:
        lib, symbol, argtypes = SIGNATURES[name]
        path = library_path(lib)
        if not path.exists():
            build((lib,))
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
