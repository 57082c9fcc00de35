"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Builds happen at first use, all
sources in parallel (one ``nvcc`` each), into ``_build/`` beside this
file; a library's name carries a hash of its source and flags, so an
edited source rebuilds. Nothing here runs at import: this module is
imported on CPU-only machines too, where no kernel is ever built.

Every C entry point takes device pointers plus the CUDA stream, launches
on that stream without synchronising, and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero code into an exception.

A kernel that cannot be built, loaded or launched raises
:class:`KernelError`. It is not a ``RuntimeError``, so the scheduler's
solver ladder does not mistake it for a solver fault and fall through to
a tier that computes the same scores in plain PyTorch: a broken kernel
stops the cycle.

``LAUNCHES`` counts the launches each wrapper made (a wrapper adds one
where it launches its kernel, and nowhere else), so a run can show that
its main path went through the kernels. A launch made while a CUDA graph
is being captured (the device round loop, ``ops/device_loop.py``) is not
a launch yet: inside :func:`counting_on_device` the wrapper's count
becomes a one-element add on a device counter, captured beside the
kernel, so every replay of the graph counts its launches on the card;
:func:`collect` reads those counters back (one sync) into ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: library -> (source, extra nvcc flags, {C function: argtypes})
LIBRARIES = {
    # -fmad=false: the pair must be bit-identical to the plain version, so
    # no multiply-add may contract into an FMA (the source also spells
    # every step with an explicit round-to-nearest intrinsic)
    "fused_pair": ("fused_pair.cu", ["-fmad=false"], {
        "ktt_fused_pair_normalize": [_P, _P, _P, _P, _I, _I, _F, _F, _P],
        "ktt_fused_pair_normalize_wide": [_P, _P, _P, _P, _I, _I, _F, _F,
                                          _P],
    }),
    "sinkhorn": ("sinkhorn.cu", [], {
        # the int before the stream: 0 = the Pallas rule, 1 = the jnp rule
        "ktt_sinkhorn_u": [_P, _P, _P, _P, _I, _I, _I, _P],
        "ktt_sinkhorn_v": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P],
    }),
    # the round loop's conditional WHILE graph (ops/device_loop.py)
    "graph_loop": ("graph_loop.cu", [], {
        "ktt_loop_build": [_P, _P, _P, _I, _P],
        "ktt_loop_launch": [_P, _P],
        "ktt_loop_destroy": [_P],
    }),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: kernel wrapper name -> launches since the last reset
#: (``fused_pair_normalize`` counts both of its paths,
#: ``fused_pair_normalize_wide`` the wide path's share of them)
LAUNCHES: Dict[str, int] = {
    "fused_pair_normalize": 0,
    "fused_pair_normalize_wide": 0,
    "sinkhorn_u": 0,
    "sinkhorn_v": 0,
    "round_loop": 0,
}

#: kernel wrapper name -> {shape: launches at that shape} since the last
#: reset, shapes in the order of their first launch (a run reads off the
#: shapes its main path launched; bounded by the distinct shapes, which
#: the padded buckets keep few)
SHAPES: Dict[str, Dict[Tuple[int, ...], int]] = {k: {} for k in LAUNCHES}


class KernelError(Exception):
    """A hand-written kernel failed to build, load or launch."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


#: (wrapper name, shape) -> slot of the device counters, in the order of
#: their first capture
_DEVICE_SLOTS: Dict[Tuple[str, Tuple[int, ...]], int] = {}
#: (device type, index) -> int64 counters, one per slot (made outside any
#: capture)
_DEVICE_COUNTS: Dict[Tuple[str, int], object] = {}
#: the counters a capture in progress adds to (None: count on the host)
_capture_counts = None
_DEVICE_SLOTS_MAX = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SHAPES[k].clear()
    for counts in _DEVICE_COUNTS.values():
        counts.zero_()


def count_launch(name: str, shape) -> None:
    """Called by a wrapper right after its kernel launched (or, inside
    :func:`counting_on_device`, was captured)."""
    shape = tuple(shape)
    if _capture_counts is not None:
        slot = _DEVICE_SLOTS.setdefault((name, shape), len(_DEVICE_SLOTS))
        if slot >= _DEVICE_SLOTS_MAX:
            raise KernelError("too many distinct kernel shapes captured")
        _capture_counts[slot:slot + 1].add_(1)
        return
    LAUNCHES[name] += 1
    SHAPES[name][shape] = SHAPES[name].get(shape, 0) + 1


@contextmanager
def counting_on_device(device):
    """Count the launches captured inside the block on ``device``'s
    counters (so a graph replay counts them), not on the host."""
    global _capture_counts
    import torch

    dev = torch.device(device)
    key = (dev.type, dev.index or 0)
    counts = _DEVICE_COUNTS.get(key)
    if counts is None:
        counts = torch.zeros((_DEVICE_SLOTS_MAX,), dtype=torch.int64,
                             device=device)
        _DEVICE_COUNTS[key] = counts
    prev, _capture_counts = _capture_counts, counts
    try:
        yield
    finally:
        _capture_counts = prev


def collect() -> None:
    """Fold the device counters into ``LAUNCHES`` / ``SHAPES`` and zero
    them: one device-to-host read per card that ever captured a launch.
    Call it outside any timed or sync-checked region."""
    for counts in _DEVICE_COUNTS.values():
        got = counts.tolist()
        counts.zero_()
        for (name, shape), slot in _DEVICE_SLOTS.items():
            if got[slot]:
                LAUNCHES[name] += got[slot]
                SHAPES[name][shape] = SHAPES[name].get(shape, 0) + got[slot]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (CUDA toolkit "
                           "needed)")
    return found


def _target(name: str) -> str:
    src, flags, _ = LIBRARIES[name]
    with open(os.path.join(CSRC, src), "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(NVCC_FLAGS + flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every library in ``names`` (default: all) that is not
    built yet, one ``nvcc`` process per source, all started together.
    Returns ``{name: ptxas report}`` for the libraries built by this
    call. Raises with the compiler's output when a build fails."""
    names = list(LIBRARIES) if names is None else names
    with _lock:
        todo = [n for n in names if not os.path.exists(_target(n))]
        if not todo:
            return {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            src, flags, _ = LIBRARIES[n]
            tmp = f"{_target(n)}.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *flags, "-o", tmp,
                 os.path.join(CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports, failed = {}, []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}:\n{out}")
                continue
            os.replace(tmp, _target(n))
            reports[n] = out
        if failed:
            raise KernelError("nvcc failed:\n" + "\n".join(failed))
        return reports


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    got = _libs.get(name)
    if got is not None:
        return got
    build([name])
    with _lock:
        if name not in _libs:
            try:
                cdll = ctypes.CDLL(_target(name))
            except OSError as e:
                raise KernelError(f"cannot load {_target(name)}: {e}") \
                    from e
            for fn, argtypes in LIBRARIES[name][2].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = cdll
        return _libs[name]


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code} at launch")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None) -> None:
    """The checks every wrapper makes before handing ``t`` to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t) -> int:
    """Streaming multiprocessors of the card that holds ``t``."""
    return _sm_count(t.device.index if t.device.index is not None else 0)


def require_vec4(n: int, what: str, *ts) -> None:
    """The pair and u kernels read rows as 16-byte vectors: the row length
    must be a multiple of four and every pointer aligned to its vector's size (the
    main path's rows are ``bucket_size`` long, a power of two >= 8)."""
    if n % 4:
        raise ValueError(f"{what}: row length {n} is not a multiple of 4")
    for t in ts:
        align = 4 * t.element_size()
        if t.data_ptr() % align:
            raise ValueError(f"{what}: a {t.dtype} pointer is not "
                             f"{align}-byte aligned")
