"""Build and load the port's CUDA kernels at first use.

`nvcc` compiles each `csrc/*.cu` for sm_90a into an object file, all of them
at once in parallel, and links them into one shared library with a plain C
interface, which `ctypes` loads: no PyTorch headers, so a build takes
seconds. The library goes into `build/monoloco_tpu_torch/` at the root of the
checkout (listed in .gitignore) and is named by a hash of the sources, the
shared headers and the flags, so an edited source rebuilds and an unchanged
one loads the existing library. Nothing here runs at import: the CPU tests
import every module on a machine without nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / 'csrc'
_SOURCES = ('wgmma_layer.cu', 'wgmma_layer_kmajor.cu', 'relu_chain.cu')
_HEADERS = ('mlp_common.cuh', 'hopper_common.cuh')
_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
          '-Xcompiler', '-fPIC', '-Xptxas', '-v')
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
    ptr, i32, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    signatures = {
        'wgmma_layer_forward': [ptr] * 6 + [i32] * 3 + [ptr],
        'widen_int8_forward': [ptr, ptr, size, ptr],
        'loco_input_forward': [ptr] * 5 + [i32] * 3 + [ptr],
        'loco_input_int8_forward': [ptr] * 6 + [i32] * 3 + [ptr],
        'loco_input_f32_forward': [ptr] * 6 + [i32] * 3 + [ptr],
        'loco_heads_forward': [ptr] * 7 + [i32] * 3 + [ptr],
        'loco_heads_f32_forward': [ptr] * 7 + [i32] * 3 + [ptr],
        'tf32x3_layer_forward': [ptr] * 8 + [i32] * 3 + [ptr],
        's8_layer_forward': [ptr] * 7 + [i32] * 3 + [ptr],
        's8_static_layer_forward': [ptr] * 8 + [i32] * 3 + [ptr],
        'quantize_rows_forward': [ptr] * 3 + [i32] * 2 + [ptr],
        'transpose_int8_forward': [ptr] * 2 + [i32] * 2 + [ptr],
        'transpose_split_tf32_forward': [ptr] * 3 + [i32] * 2 + [ptr],
        'split_tf32_forward': [ptr] * 3 + [size, ptr],
        'relu_chain_layer_forward': [ptr] * 3 + [i32] * 2 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, i32
    lib.mlp_error_string.argtypes = [i32]
    lib.mlp_error_string.restype = ctypes.c_char_p
    return lib


def _compile(lib_path):
    """nvcc every source to an object in parallel, then link; returns the
    compilers' output."""
    nvcc = _nvcc()
    tmp = lib_path.with_suffix(f'.{os.getpid()}.tmp')
    objs = [tmp.with_name(f'{tmp.name}.{Path(n).stem}.o') for n in _SOURCES]
    procs = [subprocess.Popen([nvcc, *_FLAGS, '-c', '-o', str(obj), str(_CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(_SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = ''.join(f'--- {n}\n{text}' for n, text in zip(_SOURCES, logs))
    failed = [n for n, p in zip(_SOURCES, procs) if p.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, *_FLAGS[:2], '-shared', '-o', str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        failed = ['link'] if res.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, lib_path)
    return log


def load_library():
    """The kernels' shared library, built first if its sources changed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    start = time.perf_counter()
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        digest.update((_CSRC / name).read_bytes())
    lib_path = BUILD_DIR / f'libmonoloco_kernels_{digest.hexdigest()[:16]}.so'
    log = ''
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = _compile(lib_path)
    _LIB = _declare(ctypes.CDLL(str(lib_path)))
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - start,
                      nvcc_output=log)
    return _LIB
