"""Build the port's CUDA kernels from the repo's sources, at first use.

Each source under `ops/csrc/` compiles with `nvcc` for `sm_90a` into a
shared library with a plain C interface, loaded with `ctypes`.  The
library lands in `build/torch_kernels/` at the repository root, named by
a hash of its source and flags, so an edited source never loads a stale
build.  `build_all` starts one `nvcc` per missing library and waits for
all of them, so the sources compile in parallel.  A library with
`PARTS` compiles as that many objects at once, each with `-D<macro>=i`
selecting the entry points (and so the kernel instantiations) of part
i, linked into the one library: the flash-attention source instantiates
each of its four entry points at two dtypes and four head dims, one
part an entry point at one dtype, and one `nvcc` over all of it took
49-55 s of a cold build on the card's host.

Nothing here runs at import: the CPU tests import every module, and the
CPU path never needs a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# library name -> source file under ops/csrc
SOURCES = {"flash_attention": "flash_attention.cu",
           "fingerprint": "fingerprint.cu",
           "certified_reduce": "certified_reduce.cu",
           "secure_mask": "secure_mask.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library -> (macro, parts): compiled as parts objects in parallel
PARTS = {"flash_attention": ("BFLC_FA_PART", 8)}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build only where the "
            "CUDA toolkit is installed (PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    flags = " ".join(NVCC_FLAGS) + repr(PARTS.get(name))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named library that is not built yet, all at once.

    Returns {name: {"path", "seconds", "parts_s", "log"}} — `log` holds
    nvcc's `-Xptxas -v` report (registers, shared memory, spills per
    kernel); seconds is 0.0 for a library that was already built, and
    `parts_s` the seconds at which each part's compile was seen done.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    running = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "parts_s": [],
                         "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        src = str(_CSRC / SOURCES[name])
        if name in PARTS:
            macro, n = PARTS[name]
            objs = [path.with_suffix(f".{os.getpid()}.{i}.o")
                    for i in range(n)]
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            cmds = [[_nvcc(), *flags, f"-D{macro}={i}", "-c", "-o",
                     str(obj), src] for i, obj in enumerate(objs)]
        else:
            objs = []
            cmds = [[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        running[name] = (procs, objs, tmp, path, time.perf_counter())
    for name, (procs, objs, tmp, path, t0) in running.items():
        logs, parts_s = [], []
        for proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            parts_s.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                                   f"(exit {proc.returncode}):\n{log}")
        if objs:
            link = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            for obj in objs:
                obj.unlink()
            if link.returncode != 0:
                raise RuntimeError(f"linking {SOURCES[name]} failed "
                                   f"(exit {link.returncode}):\n"
                                   f"{link.stdout}{link.stderr}")
        os.replace(tmp, path)     # atomic: a reader never sees half a file
        # seconds until each compile was seen done (in start order)
        out[name] = {"path": str(path),
                     "seconds": time.perf_counter() - t0,
                     "parts_s": parts_s, "log": "".join(logs)}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name]["path"])
        _loaded[name] = lib
    return lib
