"""Build and load the port's CUDA kernels.

The sources in ``lsqfitgp_torch/csrc/*.cu`` have a plain C interface.
At first use they are compiled by ``nvcc`` for ``sm_90a`` into one
shared library under ``build/lsqfitgp_torch/`` at the root of the
checkout, named by a hash of the sources and flags, and loaded with
``ctypes``.  A later process with the same sources loads the library
already built.  Nothing is downloaded and no library of finished
kernels is linked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ['lib', 'build_info', 'check']

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'lsqfitgp_torch'

_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
          '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U32 = ctypes.c_uint

# C signatures, one per dtype suffix (_f32, _f64)
_SIGNATURES = {
    'lsq_schur_update': [_P, _I64, _I64, _P, _P, _I64, _P, _I64, _P, _I64,
                         _I64, _P],
    'lsq_syrk_t': [_P, _I64, _I64, _P, _P],
    'lsq_gram': [_P, _P, _I64, _I64, _I32, _P, _I32, _U32, _I32, _I32, _I32,
                 _P, _P],
}

_state = {}


def _nvcc():
    exe = shutil.which('nvcc')
    if exe is None:
        exe = '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(exe):
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')
    return exe


def _sources():
    return sorted(_SRC.glob('*.cu'))


def _build():
    srcs = _sources()
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    for f in srcs:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    path = BUILD_DIR / f'liblsqfitgp_torch-{digest.hexdigest()[:16]}.so'
    info = {'path': str(path), 'seconds': 0.0, 'log': ''}
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build into a private name, then rename: concurrent first uses
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *_FLAGS, '-o', tmp, *map(str, srcs)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f'nvcc failed ({proc.returncode}):\n{proc.stderr}')
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        info['seconds'] = time.perf_counter() - t0
        info['log'] = proc.stderr
        path.with_suffix('.log').write_text(proc.stderr)
    library = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ('_f32', '_f64'):
            fn = getattr(library, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return library, info


def lib():
    """The loaded kernel library, built on first call."""
    if 'lib' not in _state:
        _state['lib'], _state['info'] = _build()
    return _state['lib']


def build_info():
    """``{'path', 'seconds', 'log'}`` of the build behind `lib` (seconds
    is 0 when the library was already on disk)."""
    lib()
    return dict(_state['info'])


def check(err, what):
    """Raise if a launch returned a CUDA error code."""
    if err:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')
