"""ctypes binding of the native host data runtime (native/fl_host.cc).

Counterpart: `defending_against_backdoors_with_robust_learning_rate_tpu/
data/native.py` (`distribute_data`, `pack_shards`, `pack_uneven`), this
package's own copy: the same C ABI, the same argument checks, the same
outputs as the numpy twins (data/partition.py, data/arrays.py;
tests/test_torch_native.py holds them equal on JAX tests/test_native.py's
cases). The library covers the host setup the reference runs in Python
loops: the label-sorted partitioner and the padded [K, max_n, ...] packs,
threaded C++ behind a C ABI.

Built on demand with g++ from `native/fl_host.cc` (the one source file,
shared with the JAX package) into this package's own build directory,
`build/torch_native/` at the repo root (listed in .gitignore); the JAX
package builds into `native/build/`, which this module never touches.
`FL_NATIVE_BUILD_DIR` (or `set_build_dir`) moves it, so tests build into
their tmp_path. `FL_NATIVE_HOST=0` takes the numpy twins, as in JAX.

No silent switch: when the library cannot be built or loaded, the first
call prints one `[native]` line saying why, and `status()` names the path
taken, which the run banner prints (train.py). Inputs the native path does
not take (mixed shard dtypes, an index past the dataset, mismatched
lengths) go to the numpy twin, which casts or raises, as in JAX: that is
the function's contract, not a fallback from a failed build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data import (
    arrays, partition)

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
SRC = os.path.join(_REPO_ROOT, "native", "fl_host.cc")
DEFAULT_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
LIB_NAME = "libfl_host.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_why_not: Optional[str] = None      # set once a build or load failed
_build_dir: Optional[str] = None


def set_build_dir(path: Optional[str]) -> None:
    """Build and load the library under `path` (None: FL_NATIVE_BUILD_DIR
    or build/torch_native/); forgets a library or failure already seen."""
    global _lib, _why_not, _build_dir
    with _lock:
        _lib, _why_not, _build_dir = None, None, path


def lib_path() -> str:
    root = (_build_dir or os.environ.get("FL_NATIVE_BUILD_DIR")
            or DEFAULT_BUILD_DIR)
    return os.path.join(root, LIB_NAME)


def _build(lib: str) -> Optional[str]:
    """Compile SRC into `lib`; None on success, else why it failed. The
    output goes to a temporary name and is renamed into place, so a
    rebuild never truncates a library another process has loaded."""
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", SRC, "-shared",
           "-pthread", "-o", tmp]
    try:
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            tail = (proc.stderr.strip().splitlines() or ["no output"])[-1]
            return f"g++ exited {proc.returncode}: {tail}"
        os.replace(tmp, lib)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return None


def _declare(lib: ctypes.CDLL) -> None:
    i8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fl_distribute_data.restype = ctypes.c_int32
    lib.fl_distribute_data.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32, i32p,
                                       i32p, i64p]
    lib.fl_pack_shards.restype = ctypes.c_int32
    lib.fl_pack_shards.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64, i32p,
                                   i64p, i32p, ctypes.c_int32, ctypes.c_int64,
                                   i8p, i32p]
    lib.fl_pack_uneven.restype = ctypes.c_int32
    lib.fl_pack_uneven.argtypes = [ctypes.POINTER(i8p),
                                   ctypes.POINTER(i32p), i32p,
                                   ctypes.c_int32, ctypes.c_int64,
                                   ctypes.c_int64, i8p, i32p]


def _load() -> Optional[ctypes.CDLL]:
    """The library (built if missing or older than SRC), or None with the
    reason printed once."""
    global _lib, _why_not
    if _lib is not None:
        return _lib
    if os.environ.get("FL_NATIVE_HOST", "1") == "0" or _why_not is not None:
        return None
    with _lock:
        if _lib is not None or _why_not is not None:
            return _lib
        lib = lib_path()
        why = None
        if not os.path.exists(SRC):
            why = f"no source at {SRC}"
        elif (not os.path.exists(lib)
              or os.path.getmtime(SRC) > os.path.getmtime(lib)):
            why = _build(lib)
        if why is None:
            try:
                handle = ctypes.CDLL(lib)
                _declare(handle)
                _lib = handle
            except (OSError, AttributeError) as e:
                why = f"cannot load {lib}: {e}"
        if why is not None:
            _why_not = why
            print(f"[native] host runtime unavailable ({why}); the numpy "
                  f"partitioner and packers run instead")
    return _lib


def available() -> bool:
    return _load() is not None


def status() -> str:
    """The path the host setup takes, for the run banner."""
    if os.environ.get("FL_NATIVE_HOST", "1") == "0":
        return "numpy (FL_NATIVE_HOST=0)"
    if _load() is not None:
        return f"native ({lib_path()})"
    return f"numpy (native unavailable: {_why_not})"


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def distribute_data(labels: np.ndarray, num_agents: int,
                    n_classes: int = 10,
                    class_per_agent: int = 10) -> Dict[int, List[int]]:
    """The label-sorted partitioner (data/partition.distribute_data)."""
    lib = _load()
    if lib is None:
        return partition.distribute_data(labels, num_agents, n_classes,
                                         class_per_agent)
    n = len(labels)
    lbl = np.ascontiguousarray(labels, dtype=np.int32)
    counts = np.zeros(num_agents, dtype=np.int32)
    chunks = np.zeros(num_agents, dtype=np.int32)
    indices = np.zeros(max(n, 1), dtype=np.int64)
    rc = lib.fl_distribute_data(_ptr(lbl, ctypes.c_int32), n, num_agents,
                                n_classes, class_per_agent,
                                _ptr(counts, ctypes.c_int32),
                                _ptr(chunks, ctypes.c_int32),
                                _ptr(indices, ctypes.c_int64))
    if rc != 0:
        # bad arguments (a dataset too small to deal): the numpy twin
        # raises its own error
        return partition.distribute_data(labels, num_agents, n_classes,
                                         class_per_agent)
    # an agent has a key iff it was dealt >= 1 chunk, even an empty one
    out: Dict[int, List[int]] = {}
    pos = 0
    for a in range(num_agents):
        c = int(counts[a])
        if chunks[a] > 0:
            out[a] = indices[pos:pos + c].tolist()
        pos += c
    return out


def pack_shards(images: np.ndarray, labels: np.ndarray,
                user_groups: Dict[int, Sequence[int]], num_agents: int,
                pad_multiple: int = 1) -> arrays.AgentShards:
    """The padded gather into [K, max_n, ...] (arrays.stack_agent_shards)."""
    lib = _load()
    if (lib is None or not images.flags.c_contiguous
            or len(labels) != images.shape[0]):
        return arrays.stack_agent_shards(images, labels, user_groups,
                                         num_agents, pad_multiple)
    sizes = np.array([len(user_groups.get(a, ())) for a in range(num_agents)],
                     dtype=np.int32)
    max_n = arrays.padded_max_n(sizes, pad_multiple)
    if max_n == 0:
        return arrays.stack_agent_shards(images, labels, user_groups,
                                         num_agents, pad_multiple)
    indices = (np.concatenate(
        [np.asarray(list(user_groups.get(a, ())), dtype=np.int64)
         for a in range(num_agents)]) if sizes.sum()
        else np.zeros(1, np.int64))
    item_bytes = int(np.prod(images.shape[1:])) * images.dtype.itemsize
    out_img = np.zeros((num_agents, max_n) + images.shape[1:],
                       dtype=images.dtype)
    out_lbl = np.zeros((num_agents, max_n), dtype=np.int32)
    lbl32 = np.ascontiguousarray(labels, dtype=np.int32)
    rc = lib.fl_pack_shards(
        _ptr(images, ctypes.c_uint8), images.shape[0], item_bytes,
        _ptr(lbl32, ctypes.c_int32), _ptr(indices, ctypes.c_int64),
        _ptr(sizes, ctypes.c_int32), num_agents, max_n,
        _ptr(out_img, ctypes.c_uint8), _ptr(out_lbl, ctypes.c_int32))
    if rc != 0:
        # an index past the dataset: the numpy twin raises IndexError
        return arrays.stack_agent_shards(images, labels, user_groups,
                                         num_agents, pad_multiple)
    return arrays.AgentShards(out_img, out_lbl, sizes)


def pack_uneven(shard_images: List[np.ndarray],
                shard_labels: List[np.ndarray],
                pad_multiple: int = 1) -> arrays.AgentShards:
    """The padded stack of pre-split per-user shards
    (arrays.stack_uneven_shards)."""
    lib = _load()
    num_agents = len(shard_images)
    # the native path copies raw bytes: every shard must share the first
    # shard's dtype and item shape, and each label array its shard's
    # length; anything else takes the value-casting numpy twin
    if (lib is None or num_agents == 0
            or len(shard_labels) != num_agents
            or any(x.dtype != shard_images[0].dtype
                   or x.shape[1:] != shard_images[0].shape[1:]
                   for x in shard_images)
            or any(len(y) != len(x)
                   for x, y in zip(shard_images, shard_labels, strict=True))):
        return arrays.stack_uneven_shards(shard_images, shard_labels,
                                          pad_multiple)
    imgs = [np.ascontiguousarray(x) for x in shard_images]
    lbls = [np.ascontiguousarray(y, dtype=np.int32) for y in shard_labels]
    sizes = np.array([len(x) for x in imgs], dtype=np.int32)
    max_n = arrays.padded_max_n(sizes, pad_multiple)
    if max_n == 0:
        return arrays.stack_uneven_shards(shard_images, shard_labels,
                                          pad_multiple)
    dtype = imgs[0].dtype
    item_bytes = int(np.prod(imgs[0].shape[1:])) * dtype.itemsize
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    img_ptrs = (u8p * num_agents)(*[x.ctypes.data_as(u8p) for x in imgs])
    lbl_ptrs = (i32p * num_agents)(*[y.ctypes.data_as(i32p) for y in lbls])
    out_img = np.zeros((num_agents, max_n) + imgs[0].shape[1:], dtype=dtype)
    out_lbl = np.zeros((num_agents, max_n), dtype=np.int32)
    rc = lib.fl_pack_uneven(img_ptrs, lbl_ptrs, _ptr(sizes, ctypes.c_int32),
                            num_agents, item_bytes, max_n,
                            out_img.ctypes.data_as(u8p),
                            _ptr(out_lbl, ctypes.c_int32))
    if rc != 0:
        return arrays.stack_uneven_shards(shard_images, shard_labels,
                                          pad_multiple)
    return arrays.AgentShards(out_img, out_lbl, sizes)
