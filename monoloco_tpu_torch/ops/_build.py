"""Build and load the port's CUDA kernels at first use.

`nvcc` compiles `csrc/*.cu` for sm_90a into one shared library with a plain C
interface, which `ctypes` loads: no PyTorch headers, so a build takes seconds.
The library goes into `build/monoloco_tpu_torch/` at the root of the checkout
(listed in .gitignore) and is named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the existing library.
Nothing here runs at import: the CPU tests import every module on a machine
without nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / 'csrc'
_SOURCES = ('dyn8_mlp.cu',)
_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
          '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'monoloco_tpu_torch'

# What the last build or load did: library path, seconds spent, nvcc's output.
BUILD_INFO = {}
_LIB = None


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dyn8_mlp_forward.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
    lib.dyn8_mlp_forward.restype = i32
    lib.dyn8_mlp_smem_bytes.argtypes = [i32, i32]
    lib.dyn8_mlp_smem_bytes.restype = ctypes.c_size_t
    lib.dyn8_mlp_error_string.argtypes = [i32]
    lib.dyn8_mlp_error_string.restype = ctypes.c_char_p
    return lib


def load_library():
    """The kernels' shared library, built first if its sources changed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    start = time.perf_counter()
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    lib_path = BUILD_DIR / f'libmonoloco_kernels_{digest.hexdigest()[:16]}.so'
    log = ''
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *_FLAGS, '-o', str(tmp), *(str(_CSRC / n) for n in _SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    _LIB = _declare(ctypes.CDLL(str(lib_path)))
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - start,
                      nvcc_output=log)
    return _LIB
