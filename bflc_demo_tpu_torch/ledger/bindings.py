"""ctypes bindings for the native committee ledger (C++, no CUDA).

Copy of `bflc_demo_tpu/ledger/bindings.py` (:135-405: `NativeLedger`,
`native_available`, `sha256_native`) over the port's own copy of the
reference's C++ (`ledger/src/`: `sha256.{h,cpp}`, `ledger.{h,cpp}`,
`capi.cpp`, unchanged).  The flat C ABI (ints, floats, char*, 32-byte
digests) needs no binding generator.  `NativeLedger` has `PyLedger`'s
synchronous surface and writes the same op bytes, chain heads, state
bytes and `BFLCWAL1` journals; `validate_op` probes a `PyLedger`
mirror replayed from the op log, and `log_base` (always 0: the native
ledger never compacts) and `head_at` are Python-level.

Where the reference's `_try_build` runs `make` inside its package, the
port builds with its own step (`build_library`): one `g++ -O2
-std=c++17 -fPIC -shared` over the three sources into `build/
native_ledger/` at the repository root, the library named by a hash of
the sources and flags, written to a temporary name and moved into place
with `os.replace`, so parallel test workers that build at once never
load half a file and an edited source never loads a stale build.  The
build runs at the first `load_library()`, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.ledger.base import (ADDR_CAP, LedgerStatus,
                                             PendingInfo, UpdateInfo)

_SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native_ledger"
SOURCES = ("sha256.cpp", "ledger.cpp", "capi.cpp")
HEADERS = ("sha256.h", "ledger.h")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def library_path() -> Path:
    """Where the library for these sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (_SRC / name).read_bytes())
    return BUILD_DIR / f"libbflc_ledger_{h.hexdigest()[:16]}.so"


def build_library() -> dict:
    """Compile the library unless it is built; {"path", "seconds"}
    (seconds 0.0 for a library that was already there).  Raises
    RuntimeError when there is no C++ compiler or it fails."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0}
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build the native "
                           "ledger")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                          *(str(_SRC / s) for s in SOURCES)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native ledger failed (exit "
                           f"{out.returncode}):\n{out.stdout}{out.stderr}")
    os.replace(tmp, path)       # atomic: a reader never sees half a file
    return {"path": str(path), "seconds": time.perf_counter() - t0}


_LIB: Optional[ctypes.CDLL] = None
_LOAD_ERROR: Optional[str] = None


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, building it first if needed; None when it
    cannot be built or loaded (`load_error()` says why).  A failure is
    remembered: the build is not retried on every construction."""
    global _LIB, _LOAD_ERROR
    if _LIB is not None or _LOAD_ERROR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(build_library()["path"])
        _declare(lib)
    except (OSError, AttributeError, RuntimeError,
            subprocess.SubprocessError) as e:
        _LOAD_ERROR = f"{type(e).__name__}: {e}"
        return None
    _LIB = lib
    return lib


def load_error() -> Optional[str]:
    """Why the library did not load (None if it did or was not tried)."""
    return _LOAD_ERROR


def _declare(lib: ctypes.CDLL) -> None:
    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    p = ctypes.c_void_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bflc_ledger_new.restype = p
    lib.bflc_ledger_new.argtypes = [i64] * 5
    lib.bflc_ledger_free.argtypes = [p]
    lib.bflc_register_node.restype = i32
    lib.bflc_register_node.argtypes = [p, ctypes.c_char_p]
    lib.bflc_query_state.argtypes = [p, ctypes.c_char_p,
                                     ctypes.POINTER(i32), ctypes.POINTER(i64)]
    lib.bflc_query_global_model.argtypes = [p, u8p, ctypes.POINTER(i64)]
    lib.bflc_upload_local_update.restype = i32
    lib.bflc_upload_local_update.argtypes = [p, ctypes.c_char_p, u8p, i64,
                                             f32, i64]
    lib.bflc_upload_scores.restype = i32
    lib.bflc_upload_scores.argtypes = [p, ctypes.c_char_p, i64,
                                       ctypes.POINTER(f32), i64]
    lib.bflc_query_all_updates.restype = i64
    lib.bflc_query_all_updates.argtypes = [p, ctypes.c_char_p, i64, u8p,
                                           ctypes.POINTER(i64),
                                           ctypes.POINTER(f32)]
    lib.bflc_aggregate_ready.restype = i32
    lib.bflc_aggregate_ready.argtypes = [p]
    lib.bflc_pending.restype = i64
    lib.bflc_pending.argtypes = [p, ctypes.POINTER(f32), ctypes.POINTER(i32),
                                 ctypes.POINTER(i32), ctypes.POINTER(f32)]
    lib.bflc_pending_selected_count.restype = i64
    lib.bflc_pending_selected_count.argtypes = [p]
    lib.bflc_commit_model.restype = i32
    lib.bflc_commit_model.argtypes = [p, u8p, i64]
    for name in ("bflc_close_round", "bflc_force_aggregate",
                 "bflc_round_closed"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [p]
    lib.bflc_reseat_committee.restype = i32
    lib.bflc_reseat_committee.argtypes = [p, ctypes.c_char_p]
    for name in ("bflc_epoch", "bflc_num_registered", "bflc_update_count",
                 "bflc_score_count", "bflc_log_size", "bflc_generation",
                 "bflc_writer_index"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [p]
    lib.bflc_promote_writer.restype = i32
    lib.bflc_promote_writer.argtypes = [p, i64, i64]
    lib.bflc_last_global_loss.restype = f32
    lib.bflc_last_global_loss.argtypes = [p]
    lib.bflc_committee.restype = i64
    lib.bflc_committee.argtypes = [p, ctypes.c_char_p, i64, i64]
    lib.bflc_log_head.argtypes = [p, u8p]
    lib.bflc_verify_log.restype = i32
    lib.bflc_verify_log.argtypes = [p]
    lib.bflc_log_op_size.restype = i64
    lib.bflc_log_op_size.argtypes = [p, i64]
    lib.bflc_log_op.restype = i32
    lib.bflc_log_op.argtypes = [p, i64, u8p, i64]
    lib.bflc_apply_op.restype = i32
    lib.bflc_apply_op.argtypes = [p, u8p, i64]
    lib.bflc_attach_wal.restype = i32
    lib.bflc_attach_wal.argtypes = [p, ctypes.c_char_p]
    lib.bflc_detach_wal.argtypes = [p]
    lib.bflc_replay_wal.restype = i64
    lib.bflc_replay_wal.argtypes = [p, ctypes.c_char_p]
    lib.bflc_encode_state.restype = i64
    lib.bflc_encode_state.argtypes = [p, u8p, i64]
    lib.bflc_state_digest.argtypes = [p, u8p]
    lib.bflc_sha256.argtypes = [u8p, i64, u8p]


def native_available() -> bool:
    return load_library() is not None


def _digest_buf(data: bytes = b"\0" * 32):
    return (ctypes.c_uint8 * 32)(*data)


def _byte_buf(data: bytes):
    """A ctypes copy of `data` (at least one byte) in one memcpy, where
    the reference unpacks it byte by byte (the replica's hot path)."""
    return (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
        data or b"\0")


def sha256_native(data: bytes) -> bytes:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native ledger unavailable: {_LOAD_ERROR}")
    out = (ctypes.c_uint8 * 32)()
    lib.bflc_sha256(_byte_buf(data), len(data), out)
    return bytes(out)


class NativeLedger:
    """Thin, GIL-serialized wrapper over the C++ CommitteeLedger."""

    backend = "native"

    def __init__(self, client_num: int, comm_count: int, aggregate_count: int,
                 needed_update_count: int, genesis_epoch: int = -999):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native ledger unavailable ({_LOAD_ERROR}); "
                               f"use ledger.make_ledger() for the python "
                               f"backend")
        self._lib = lib
        self._h = lib.bflc_ledger_new(client_num, comm_count, aggregate_count,
                                      needed_update_count, genesis_epoch)
        self._needed = needed_update_count
        # kept for validate_op's python mirror
        self._init_args = (client_num, comm_count, aggregate_count,
                           needed_update_count, genesis_epoch)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.bflc_ledger_free(h)
            self._h = None

    # --- protocol surface ---
    def register_node(self, addr: str) -> LedgerStatus:
        return LedgerStatus(self._lib.bflc_register_node(
            self._h, addr.encode()))

    def query_state(self, addr: str) -> Tuple[str, int]:
        role = ctypes.c_int32()
        ep = ctypes.c_int64()
        self._lib.bflc_query_state(self._h, addr.encode(),
                                   ctypes.byref(role), ctypes.byref(ep))
        return ("comm" if role.value == 1 else "trainer", ep.value)

    def query_global_model(self) -> Tuple[bytes, int]:
        out = (ctypes.c_uint8 * 32)()
        ep = ctypes.c_int64()
        self._lib.bflc_query_global_model(self._h, out, ctypes.byref(ep))
        return bytes(out), ep.value

    def upload_local_update(self, sender: str, payload_hash: bytes,
                            n_samples: int, avg_cost: float,
                            epoch: int) -> LedgerStatus:
        return LedgerStatus(self._lib.bflc_upload_local_update(
            self._h, sender.encode(), _digest_buf(payload_hash), n_samples,
            avg_cost, epoch))

    def upload_scores(self, sender: str, epoch: int,
                      scores: Sequence[float]) -> LedgerStatus:
        arr = (ctypes.c_float * len(scores))(*[float(s) for s in scores])
        return LedgerStatus(self._lib.bflc_upload_scores(
            self._h, sender.encode(), epoch, arr, len(scores)))

    def query_all_updates(self) -> List[UpdateInfo]:
        k = self._needed
        addr_buf = ctypes.create_string_buffer(k * ADDR_CAP)
        hashes = (ctypes.c_uint8 * (32 * k))()
        ns = (ctypes.c_int64 * k)()
        costs = (ctypes.c_float * k)()
        n = self._lib.bflc_query_all_updates(
            self._h, addr_buf, ADDR_CAP, hashes, ns, costs)
        out = []
        for i in range(n):
            addr = addr_buf.raw[i * ADDR_CAP:(i + 1) * ADDR_CAP]
            out.append(UpdateInfo(
                sender=addr.split(b"\0", 1)[0].decode(),
                payload_hash=bytes(hashes[32 * i:32 * (i + 1)]),
                n_samples=ns[i], avg_cost=costs[i]))
        return out

    # --- aggregation handshake ---
    def aggregate_ready(self) -> bool:
        return bool(self._lib.bflc_aggregate_ready(self._h))

    def pending(self) -> Optional[PendingInfo]:
        k = self._needed
        med = (ctypes.c_float * k)()
        order = (ctypes.c_int32 * k)()
        sel_n = self._lib.bflc_pending_selected_count(self._h)
        if sel_n < 0:
            return None
        sel = (ctypes.c_int32 * max(int(sel_n), 1))()
        loss = ctypes.c_float()
        n = self._lib.bflc_pending(self._h, med, order, sel,
                                   ctypes.byref(loss))
        return PendingInfo(
            medians=np.ctypeslib.as_array(med)[:n].copy(),
            order=list(order[:n]),
            selected=list(sel[:sel_n]),
            global_loss=loss.value)

    def commit_model(self, new_model_hash: bytes, epoch: int) -> LedgerStatus:
        return LedgerStatus(self._lib.bflc_commit_model(
            self._h, _digest_buf(new_model_hash), epoch))

    # --- failure-recovery extensions ---
    def close_round(self) -> LedgerStatus:
        return LedgerStatus(self._lib.bflc_close_round(self._h))

    def force_aggregate(self) -> LedgerStatus:
        return LedgerStatus(self._lib.bflc_force_aggregate(self._h))

    def reseat_committee(self, addrs: Sequence[str]) -> LedgerStatus:
        if any("," in a for a in addrs):
            return LedgerStatus.BAD_ARG
        joined = ",".join(addrs).encode()
        return LedgerStatus(self._lib.bflc_reseat_committee(self._h, joined))

    @property
    def round_closed(self) -> bool:
        return bool(self._lib.bflc_round_closed(self._h))

    # --- writer fencing ---
    def promote_writer(self, generation: int,
                       writer_index: int) -> LedgerStatus:
        return LedgerStatus(self._lib.bflc_promote_writer(
            self._h, generation, writer_index))

    @property
    def generation(self) -> int:
        return self._lib.bflc_generation(self._h)

    @property
    def writer_index(self) -> int:
        return self._lib.bflc_writer_index(self._h)

    # --- inspection ---
    @property
    def epoch(self) -> int:
        return self._lib.bflc_epoch(self._h)

    @property
    def num_registered(self) -> int:
        return self._lib.bflc_num_registered(self._h)

    @property
    def update_count(self) -> int:
        return self._lib.bflc_update_count(self._h)

    @property
    def score_count(self) -> int:
        return self._lib.bflc_score_count(self._h)

    @property
    def last_global_loss(self) -> float:
        return self._lib.bflc_last_global_loss(self._h)

    def committee(self) -> List[str]:
        cap = 64
        while True:
            buf = ctypes.create_string_buffer(cap * ADDR_CAP)
            n = self._lib.bflc_committee(self._h, buf, ADDR_CAP, cap)
            if n <= cap:
                return [buf.raw[i * ADDR_CAP:(i + 1) * ADDR_CAP]
                        .split(b"\0", 1)[0].decode() for i in range(n)]
            cap = int(n)

    # --- op log ---
    def log_size(self) -> int:
        return self._lib.bflc_log_size(self._h)

    def log_head(self) -> bytes:
        out = (ctypes.c_uint8 * 32)()
        self._lib.bflc_log_head(self._h, out)
        return bytes(out)

    def verify_log(self) -> bool:
        return bool(self._lib.bflc_verify_log(self._h))

    def log_op(self, i: int) -> bytes:
        size = self._lib.bflc_log_op_size(self._h, i)
        if size < 0:
            raise IndexError(i)
        buf = (ctypes.c_uint8 * int(size))()
        rc = self._lib.bflc_log_op(self._h, i, buf, size)
        if rc != 0:
            raise RuntimeError(f"log_op failed: {rc}")
        return bytes(buf)

    def apply_op(self, op: bytes) -> LedgerStatus:
        return LedgerStatus(self._lib.bflc_apply_op(
            self._h, _byte_buf(op), len(op)))

    def validate_op(self, op: bytes) -> LedgerStatus:
        """Would apply_op(op) succeed here, without mutating state?

        The C ABI has no state snapshot, so this replays the op log into
        a fresh PyLedger (the byte-identical mirror) and probes there:
        O(log) a call.  Validators that probe every op run the python
        backend (`comm.bft.ValidatorNode` defaults to it)."""
        from bflc_demo_tpu_torch.ledger.pyledger import PyLedger
        mirror = PyLedger(*self._init_args)
        for i in range(self.log_size()):
            st = mirror.apply_op(self.log_op(i))
            if st != LedgerStatus.OK:       # cannot happen on a valid chain
                raise RuntimeError(
                    f"native->python mirror replay rejected op {i}: "
                    f"{st.name}")
        return mirror.validate_op(op)

    # --- certified snapshots (ledger/snapshot.py) ---
    @property
    def log_base(self) -> int:
        """Always 0: the native ledger never compacts its log (no
        state-injection ABI), so a GC'd or restored replica runs the
        python backend.  It still applies snapshot ops."""
        return 0

    def head_at(self, upto: int) -> bytes:
        """Chain head after ops[0..upto), recomputed from the op bytes."""
        h = b""
        for i in range(upto):
            d = hashlib.sha256()
            if h:
                d.update(h)
            d.update(self.log_op(i))
            h = d.digest()
        return h

    def encode_state(self) -> bytes:
        size = self._lib.bflc_encode_state(self._h, None, 0)
        buf = (ctypes.c_uint8 * int(size))()
        self._lib.bflc_encode_state(self._h, buf, size)
        return bytes(buf)

    def state_digest(self) -> bytes:
        out = (ctypes.c_uint8 * 32)()
        self._lib.bflc_state_digest(self._h, out)
        return bytes(out)

    # --- write-ahead log ---
    def attach_wal(self, path: str) -> bool:
        return self._lib.bflc_attach_wal(self._h, path.encode()) == 0

    def detach_wal(self) -> None:
        self._lib.bflc_detach_wal(self._h)

    def replay_wal(self, path: str) -> int:
        """Apply a WAL file's ops; returns ops applied, raises on a corrupt
        file or an op the state machine rejects."""
        n = self._lib.bflc_replay_wal(self._h, path.encode())
        if n == -1:
            raise ValueError(f"not a bflc WAL (or unreadable): {path}")
        if n < 0:
            raise ValueError(f"WAL replay rejected op {-(n + 2)}: {path}")
        return int(n)
