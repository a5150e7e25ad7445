"""Build and load the port's CUDA kernels.

The sources in ``lsqfitgp_torch/csrc/*.cu`` have a plain C interface
(``*.cuh`` are headers they share).  The tensor-core kernels' TMA
descriptors come from the driver's ``cuTensorMapEncodeTiled``, which the
library finds at run time (``cudaGetDriverEntryPoint``), so it links
only the CUDA runtime.  At first use each source is
compiled by its own ``nvcc`` process for ``sm_90a``, all started
together, and the objects are linked into one shared library under
``build/lsqfitgp_torch/`` at the root of the checkout, named by a hash
of the sources and flags, and loaded with ``ctypes``.  A later process
with the same sources loads the library already built.  Nothing is downloaded and no library of finished
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
          '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U64 = ctypes.c_ulonglong

_BOTH = ('_f32', '_f64')
# the Gram entry points of both dtypes for the closed-form evaluators
# (csrc/gram.cu) and for ZooSpecial (csrc/gram_special.cu)
_GRAM = ('_f32', '_f64', '_zs_f32', '_zs_f64')
_F32, _F64 = ('_f32',), ('_f64',)

_SCHUR = [_P, _I64, _I64, _P, _P, _I64, _P, _I64, _P, _I64, _I64]
_SCHUR_GRAM = [_P, _I32, _P, _I32, _U64, _I32, _I64, _I64, _P, _I64, _P,
               _I64, _I64]

# C signatures and the dtype suffixes each entry point has: the SIMT
# kernels of syrk.cu (float32), the TF32 tensor-core kernels of
# schur_tc.cu (float32, with a pass count) and the FP64 tensor-core
# kernels of dmma.cu (float64).  The Gram kernels take the parameter
# vector, the term count, the terms' codes and the evaluator
# (csrc/profiles.cuh).
_SIGNATURES = {
    'lsq_schur_update': ([*_SCHUR, _P], _F32),
    'lsq_schur_update_tc': ([*_SCHUR, _I32, _P], _F32),
    'lsq_schur_update_dmma': ([*_SCHUR, _P], _F64),
    'lsq_schur_gram': ([*_SCHUR_GRAM, _P], _F32),
    'lsq_schur_gram_tc': ([*_SCHUR_GRAM, _I32, _P], _F32),
    'lsq_schur_gram_dmma': ([*_SCHUR_GRAM, _P], _F64),
    'lsq_syrk_t': ([_P, _I64, _I64, _P, _P], _F32),
    'lsq_syrk_t_dmma': ([_P, _I64, _I64, _P, _P, _P], _F64),
    'lsq_gram': ([_P, _P, _I64, _I64, _I32, _P, _I32, _U64, _I32, _I32, _P,
                  _P], _GRAM),
    'lsq_gram_sym': ([_P, _I64, _I32, _P, _I32, _U64, _I32, _I32, _P, _P],
                     _GRAM),
    'lsq_gram_bwd': ([_P, _P, _P, _I64, _I64, _I32, _P, _I32, _U64, _I32,
                      _I32, _I32, _I32, _I32, _P, _P, _P, _P], _GRAM),
    'lsq_gram_sym_bwd': ([_P, _P, _I64, _I32, _I32, _P, _I32, _U64, _I32,
                          _I32, _I32, _I32, _I32, _P, _P, _P], _GRAM),
    'lsq_gram_jvp': ([_P, _P, _P, _P, _I64, _I64, _I32, _P, _P, _I32, _U64,
                      _I32, _I32, _P, _P], _GRAM),
    'lsq_gram_sym_jvp': ([_P, _P, _I64, _I32, _P, _P, _I32, _U64, _I32,
                          _I32, _P, _P], _GRAM),
    'lsq_gram_bwd_jvp': ([_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P,
                          _P, _U64, _I32, _I32, _I32, _I32, _P, _P, _P, _P],
                         _GRAM),
    'lsq_gram_sym_bwd_jvp': ([_P, _P, _P, _I64, _I32, _I32, _P, _P, _U64,
                              _I32, _I32, _I32, _I32, _P, _P, _P], _GRAM),
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


def _compile(srcs, out):
    """Compile each source with its own nvcc, all at once, and link the
    objects into the shared library ``out``; returns nvcc's messages."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f.stem + '.o') for f in srcs]
        procs = [subprocess.Popen([nvcc, *_FLAGS, '-c', str(f), '-o', o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for f, proc, text in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f'nvcc failed on {f.name} ({proc.returncode}):\n{text}')
        link = subprocess.run([nvcc, *_FLAGS[:2], '-shared', '-o', out, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f'nvcc link failed ({link.returncode}):\n{link.stderr}')
    return ''.join(logs) + link.stderr


def _build():
    srcs = _sources()
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    for f in sorted([*srcs, *_SRC.glob('*.cuh')]):
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
            info['log'] = _compile(srcs, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        info['seconds'] = time.perf_counter() - t0
        path.with_suffix('.log').write_text(info['log'])
    library = ctypes.CDLL(str(path))
    for name, (argtypes, suffixes) in _SIGNATURES.items():
        for suffix in suffixes:
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
