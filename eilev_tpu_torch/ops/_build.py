"""Builds the port's CUDA kernels from ``eilev_tpu_torch/csrc`` at first use.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds. Libraries go to ``build/eilev_tpu_torch/``
at the repository root, named by a hash of the source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and an unchanged one is reused. :func:`build_host` builds a host C++ source
the same way with ``g++`` (the libav video decoder, ``native/``). A build
holds a lock file beside its library, so parallel test workers build it
once, and renames the library into place when it is whole.

Nothing here runs at import time: the CPU tests import every module of the
port on hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "eilev_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-O2", "-shared", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str, csrc: Path = CSRC) -> Path:
    """Where the library built from ``csrc/<source>`` goes: named by a hash of
    the source, of every header ``csrc/*.cuh`` (any of them may be included)
    and of the flags."""
    digest = hashlib.sha256((csrc / source).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def _build_locked(lib: Path, command: list, what: str) -> Path:
    """Run ``command`` with ``-o <tmp>`` and rename its output to ``lib``,
    once: under an exclusive lock on ``lib``'s lock file, and not at all when
    ``lib`` exists (a concurrent build never sees half a file)."""
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # built by another worker while this one waited
                return lib
            tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run([*command, "-o", str(tmp)], capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{Path(command[0]).name} failed on {what}:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into ``build/eilev_tpu_torch/`` and return the
    library's path; a library already built from the same bytes is reused."""
    return _build_locked(library_path(source), [_nvcc(), *NVCC_FLAGS, str(CSRC / source)], source)


def host_library_path(source: Path, libs: tuple = ()) -> Path:
    """Where :func:`build_host` puts the library of ``source``: named by a
    hash of the source, the flags and the libraries it links."""
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join(HOST_FLAGS + tuple(libs)).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build_host(source: Path, libs: tuple = ()) -> Path:
    """Compile the host C++ file ``source`` with ``g++`` into a shared library
    in ``build/eilev_tpu_torch/``, linked against ``libs`` (``-l`` flags);
    a library already built from the same bytes is reused."""
    source = Path(source)
    return _build_locked(host_library_path(source, libs), ["g++", *HOST_FLAGS, str(source), *libs], source.name)


def ptxas_report(source: str) -> str:
    """What ``nvcc -Xptxas -v`` says of ``csrc/<source>`` built with the
    library's flags: each kernel's registers, shared memory and spills. The
    library it builds is thrown away."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{Path(source).stem}.ptxas.{os.getpid()}.so"
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / source)],
            capture_output=True, text=True,
        )
    finally:
        tmp.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def packed_attention_lib() -> ctypes.CDLL:
    """The packed-QKV attention library (K1 and K2), built and bound once."""
    lib = ctypes.CDLL(str(build("packed_attention.cu")))
    fn = lib.eilev_packed_attention_bf16
    fn.argtypes = [
        ctypes.c_void_p,  # qkv
        ctypes.c_void_p,  # mask or NULL
        ctypes.c_void_p,  # out
        ctypes.c_int,  # B
        ctypes.c_int,  # S
        ctypes.c_int,  # H
        ctypes.c_int,  # D
        ctypes.c_float,  # q_scale
        ctypes.c_float,  # s_scale
        ctypes.c_int,  # causal
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def attention_f32_lib() -> ctypes.CDLL:
    """The fp32 attention library (the fp32 body of K1, K2 and K5), built and
    bound once."""
    lib = ctypes.CDLL(str(build("attention_f32.cu")))
    fn = lib.eilev_attention_f32
    fn.argtypes = [
        ctypes.c_void_p,  # q
        ctypes.c_void_p,  # k
        ctypes.c_void_p,  # v
        ctypes.c_void_p,  # padding mask or NULL
        ctypes.c_void_p,  # bias or NULL
        ctypes.c_void_p,  # out
        ctypes.c_int,  # B
        ctypes.c_int,  # S
        ctypes.c_int,  # L
        ctypes.c_int,  # H
        ctypes.c_int,  # KVH
        ctypes.c_int,  # D
        ctypes.c_longlong,  # q batch stride
        ctypes.c_longlong,  # q row stride
        ctypes.c_longlong,  # k batch stride
        ctypes.c_longlong,  # k row stride
        ctypes.c_longlong,  # v batch stride
        ctypes.c_longlong,  # v row stride
        ctypes.c_longlong,  # out batch stride
        ctypes.c_longlong,  # out row stride
        ctypes.c_float,  # q_scale
        ctypes.c_float,  # s_scale
        ctypes.c_int,  # causal
        ctypes.c_int,  # q_offset
        ctypes.c_int,  # uniform: 1 for K1/K2's fully masked rows, 0 for K5's
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def flash_attention_lib() -> ctypes.CDLL:
    """The flash attention library (K5: the decode, Hopper and mma.sync
    bodies), built and bound once."""
    lib = ctypes.CDLL(str(build("flash_attention.cu")))
    fn = lib.eilev_flash_attention_bf16
    fn.argtypes = [
        ctypes.c_void_p,  # q
        ctypes.c_void_p,  # k
        ctypes.c_void_p,  # v
        ctypes.c_void_p,  # padding mask or NULL
        ctypes.c_longlong,  # mask batch stride
        ctypes.c_int,  # mask element bytes (1, 4 or 8)
        ctypes.c_void_p,  # bias or NULL
        ctypes.c_longlong,  # bias head stride
        ctypes.c_longlong,  # bias row stride
        ctypes.c_longlong,  # bias key stride
        ctypes.c_int,  # 1 for a bf16 bias, 0 for fp32
        ctypes.c_void_p,  # out
        ctypes.c_int,  # B
        ctypes.c_int,  # S
        ctypes.c_int,  # L
        ctypes.c_int,  # H
        ctypes.c_int,  # KVH
        ctypes.c_int,  # D
        ctypes.c_longlong,  # q batch stride
        ctypes.c_longlong,  # q row stride
        ctypes.c_longlong,  # k batch stride
        ctypes.c_longlong,  # k row stride
        ctypes.c_longlong,  # v batch stride
        ctypes.c_longlong,  # v row stride
        ctypes.c_float,  # q_scale, rounded to bf16
        ctypes.c_float,  # s_scale
        ctypes.c_int,  # causal
        ctypes.c_int,  # q_offset
        ctypes.c_void_p,  # stream
        ctypes.POINTER(ctypes.c_int),  # out: the body that ran (0 mma.sync, 1 Hopper, 2 decode)
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def decode_attention_lib() -> ctypes.CDLL:
    """The stacked-cache decode attention library (K3 and K4), built and bound once."""
    lib = ctypes.CDLL(str(build("decode_attention.cu")))
    fn = lib.eilev_decode_attention
    fn.argtypes = [
        ctypes.c_void_p,  # q
        ctypes.c_void_p,  # k_buf
        ctypes.c_void_p,  # v_buf
        ctypes.c_void_p,  # k_scale or NULL
        ctypes.c_void_p,  # v_scale or NULL
        ctypes.c_void_p,  # mask
        ctypes.c_void_p,  # out
        ctypes.c_int,  # B
        ctypes.c_int,  # S
        ctypes.c_int,  # H
        ctypes.c_int,  # KVH
        ctypes.c_int,  # D
        ctypes.c_int,  # layer
        ctypes.c_float,  # scale, in the model dtype
        ctypes.c_int,  # scale_query
        ctypes.c_int,  # int8
        ctypes.c_int,  # f32: an fp32 query (and output)
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def fused_mlp_lib() -> ctypes.CDLL:
    """The LayerNorm -> MLP library (K6: the bf16 and the fp32 body, whose
    entry points take the same arguments), built and bound once."""
    lib = ctypes.CDLL(str(build("fused_mlp.cu")))
    argtypes = [
        ctypes.c_void_p,  # x
        ctypes.c_void_p,  # ln_scale, fp32
        ctypes.c_void_p,  # ln_bias, fp32
        ctypes.c_void_p,  # w1 (D, F)
        ctypes.c_void_p,  # b1, fp32
        ctypes.c_void_p,  # w2 (F, D)
        ctypes.c_void_p,  # b2, fp32
        ctypes.c_void_p,  # scratch h (M, D)
        ctypes.c_void_p,  # scratch act (M, F)
        ctypes.c_void_p,  # out
        ctypes.c_int,  # M
        ctypes.c_int,  # D
        ctypes.c_int,  # F
        ctypes.c_float,  # eps
        ctypes.c_void_p,  # stream
    ]
    for fn in (lib.eilev_ln_mlp_bf16, lib.eilev_ln_mlp_f32):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
