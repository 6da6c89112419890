"""Build the package's CUDA sources into shared libraries and load them.

A library is one or more translation units under ``csrc/``
(``LIBRARIES``). Each unit compiles with its own ``nvcc`` process for Hopper
(``sm_90a``), all started together, and the objects link into
``_build/lib<name>-<hash>.so`` on first use, loaded with ctypes. The file
name carries a hash of the library's sources and of every header in
``csrc/``, so an edited source rebuilds and a stale library is never
loaded. There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
#: Translation units of each library; the first holds its C entry points.
LIBRARIES = {
    "flash_attention": ("flash_attention.cu", "flash_fwd_sm90.cu",
                        "flash_dkv_sm90.cu", "flash_dq_sm90.cu"),
}

_lock = threading.Lock()
_loaded = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; None when there is none."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    return next((c for c in candidates if c and os.access(c, os.X_OK)), None)


def sources(name):
    return [CSRC / s for s in LIBRARIES[name]]


def library_path(name):
    digest = hashlib.sha256()
    for path in sources(name) + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _run(procs):
    """Waits for ``{key: Popen}``; returns ``{key: output}`` and the keys
    that failed."""
    logs, failed = {}, []
    for key, proc in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(key)
    return logs, failed


def build(names):
    """Compile every named library that has no current one: one nvcc per
    translation unit, all started together, then one link per library.
    Returns ``{source or library name: compiler output}`` for what it
    built. Raises RuntimeError if a compile or a link fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "horovod_tpu_torch: nvcc not found (set CUDA_HOME or put nvcc on "
            "PATH); the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects, procs = {}, {}
    for name in todo:
        for src in sources(name):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            objects.setdefault(name, []).append(obj)
            procs[src.name] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, failed = _run(procs)
    if not failed:
        links = {}
        for name in todo:
            tmp = library_path(name).with_suffix(f".{tag}")
            links[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objects[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp)
        link_logs, failed = _run({n: p for n, (p, _) in links.items()})
        logs.update(link_logs)
        for name, (_, tmp) in links.items():
            if name in failed:
                tmp.unlink(missing_ok=True)
            else:
                # atomic: a reader never sees half a file
                os.replace(tmp, library_path(name))
    for objs in objects.values():
        for obj in objs:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(
            f"{key}:\n{logs[key]}" for key in failed))
    return logs


def load(name):
    """The ctypes library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
