"""Build and load the hand-written CUDA kernels of ``mmvid_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with
:mod:`ctypes`.  The build happens at first use, never at import, into
``mmvid_tpu_torch/_build`` under a file name keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads the
library already built.

There is no fallback: a missing ``nvcc`` or a failed build raises.  Each C
entry point returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-lineinfo')

_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME (default
    /usr/local/cuda).  Raises when there is none."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise RuntimeError(
        'nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels '
        'of mmvid_tpu_torch cannot be built')


def _sources():
    srcs = sorted(CSRC_DIR.glob('*.cu'))
    if not srcs:
        raise RuntimeError(f'no CUDA sources under {CSRC_DIR}')
    return srcs


def source_hash() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(CSRC_DIR.glob('*.cuh')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands at once; raise on the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                               f'{" ".join(cmd)}\n{out}')
    return outs


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if not built for these sources) and return the
    library path.  ``verbose`` adds ``-Xptxas -v`` and prints its report
    (registers, shared memory and spills per kernel)."""
    nvcc = find_nvcc()
    lib_path = BUILD_DIR / f'libmmvid_kernels_{source_hash()}.so'
    if lib_path.exists() and not verbose:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = _sources()
        objs = [str(Path(tmp) / f'{p.stem}.o') for p in srcs]
        ptxas = ['-Xptxas', '-v'] if verbose else []
        outs = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, f'-I{CSRC_DIR}', '-c',
                          '-o', o, str(p)] for p, o in zip(srcs, objs)])
        lib_tmp = str(Path(tmp) / lib_path.name)
        _run_all([[nvcc, *NVCC_FLAGS, '-shared', '-o', lib_tmp, *objs]])
        if verbose:
            print(''.join(outs), flush=True)
        os.replace(lib_tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.mmvid_error_string.argtypes = [ctypes.c_int]
        lib.mmvid_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().mmvid_error_string(rc).decode()
        raise RuntimeError(f'{what}: CUDA error {rc} ({msg})')


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
