"""ctypes bindings for the native host-runtime library (native/obcore.cpp).

A copy of ohm_tsd_slam_tpu/native/__init__.py for the PyTorch port, which
must not import the JAX package.  The library is built into the port's
own build directory, ohm_tsd_slam_tpu_torch/_build/.

Provides the C++ equivalents of the reference's host infrastructure:
latest-wins / newest-first channels (ThreadSLAM/ThreadLocalize/
ThreadMapping synchronization, src/ThreadSLAM.cpp, src/ThreadMapping.cpp),
monotonic Timer (src/obcore/base/Timer.cpp), leveled Logger
(src/obcore/base/Logger.cpp) and PPM/PGM serializers
(src/obcore/base/tools.cpp).

The shared library is built on demand with the system toolchain (see
native/Makefile); when no toolchain is available every class degrades to
an equivalent pure-Python implementation so the package keeps working.
`NATIVE` reports which backend is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from collections import deque
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))
_SO = os.path.join(_BUILD_DIR, "libobcore.so")
_SRC = os.path.normpath(os.path.join(_HERE, "..", "..", "native",
                                     "obcore.cpp"))

MAILBOX = 0
STACK = 1

LOG_ERROR = 0
LOG_WARN = 1
LOG_DEBUG = 2


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-Wall", "-std=c++17", "-fPIC", "-pthread",
             "-shared", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        # atomic: a concurrent importer never loads a partial file
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
        if not _build() and not os.path.exists(_SO):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.channel_new.restype = ctypes.c_void_p
    lib.channel_new.argtypes = [ctypes.c_int, ctypes.c_size_t]
    lib.channel_free.argtypes = [ctypes.c_void_p]
    lib.channel_push.restype = ctypes.c_int
    lib.channel_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_size_t]
    lib.channel_pop_wait.restype = ctypes.c_int64
    lib.channel_pop_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_size_t, ctypes.c_int64]
    lib.channel_pending.restype = ctypes.c_int64
    lib.channel_pending.argtypes = [ctypes.c_void_p]
    lib.channel_dropped.restype = ctypes.c_uint64
    lib.channel_dropped.argtypes = [ctypes.c_void_p]
    lib.channel_close.argtypes = [ctypes.c_void_p]
    lib.timer_new.restype = ctypes.c_void_p
    lib.timer_free.argtypes = [ctypes.c_void_p]
    lib.timer_reset.argtypes = [ctypes.c_void_p]
    lib.timer_elapsed.restype = ctypes.c_double
    lib.timer_elapsed.argtypes = [ctypes.c_void_p]
    lib.logger_configure.restype = ctypes.c_int
    lib.logger_configure.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_char_p]
    lib.logger_log.argtypes = [ctypes.c_int, ctypes.c_char_p,
                               ctypes.c_char_p]
    lib.serialize_ppm.restype = ctypes.c_int
    lib.serialize_ppm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int]
    lib.serialize_pgm.restype = ctypes.c_int
    lib.serialize_pgm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int]
    return lib


_LIB = _load()
NATIVE = _LIB is not None


class Channel:
    """Byte-payload channel with MAILBOX (latest-wins) or STACK
    (newest-first drain, bounded) policy."""

    def __init__(self, policy: int = MAILBOX, capacity: int = 64):
        self.policy = policy
        self.capacity = capacity
        if NATIVE:
            self._h = _LIB.channel_new(policy, capacity)
        else:
            self._items: deque = deque()
            self._dropped = 0
            self._closed = False
            self._cv = threading.Condition()

    def push(self, payload: bytes) -> bool:
        if NATIVE:
            return _LIB.channel_push(self._h, payload, len(payload)) == 0
        with self._cv:
            if self._closed:
                return False
            if self.policy == MAILBOX:
                self._dropped += len(self._items)
                self._items.clear()
            elif len(self._items) >= self.capacity:
                self._items.popleft()
                self._dropped += 1
            self._items.append(payload)
            self._cv.notify_all()
        return True

    def pop_wait(self, timeout_ms: int = 100,
                 max_bytes: int = 1 << 22) -> Optional[bytes]:
        """Newest-first pop; None on timeout or after close."""
        if NATIVE:
            buf = ctypes.create_string_buffer(max_bytes)
            n = _LIB.channel_pop_wait(self._h, buf, max_bytes, timeout_ms)
            if n == -2:
                buf = ctypes.create_string_buffer(max_bytes * 8)
                n = _LIB.channel_pop_wait(self._h, buf, max_bytes * 8,
                                          timeout_ms)
            return buf.raw[:n] if n > 0 else None
        with self._cv:
            if not self._items:
                self._cv.wait(timeout_ms / 1000.0)
            if not self._items:
                return None
            return self._items.pop()

    def pending(self) -> int:
        if NATIVE:
            return int(_LIB.channel_pending(self._h))
        with self._cv:
            return len(self._items)

    def dropped(self) -> int:
        if NATIVE:
            return int(_LIB.channel_dropped(self._h))
        with self._cv:
            return self._dropped

    def close(self) -> None:
        if NATIVE:
            _LIB.channel_close(self._h)
        else:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def __del__(self):
        if NATIVE and getattr(self, "_h", None):
            try:
                _LIB.channel_free(self._h)
            except Exception:
                pass
            self._h = None


class Timer:
    """Monotonic elapsed-seconds timer (obcore/base/Timer)."""

    def __init__(self):
        self._h = _LIB.timer_new() if NATIVE else None
        if not NATIVE:
            self._t0 = time.monotonic()

    def reset(self) -> None:
        if NATIVE:
            _LIB.timer_reset(self._h)
        else:
            self._t0 = time.monotonic()

    def elapsed(self) -> float:
        if NATIVE:
            return float(_LIB.timer_elapsed(self._h))
        return time.monotonic() - self._t0

    def __del__(self):
        if NATIVE and getattr(self, "_h", None):
            try:
                _LIB.timer_free(self._h)
            except Exception:
                pass
            self._h = None


def timestamped_log_path(base: str) -> str:
    """The reference's log-file naming: `<base>_<d>_<m>_<Y>_<H>-<M>-<S>.log`
    (Logger::configure, obcore/base/Logger.cpp:76-89)."""
    import time as _time

    t = _time.localtime()
    return (f"{base}_{t.tm_mday}_{t.tm_mon}_{t.tm_year}_"
            f"{t.tm_hour}-{t.tm_min}-{t.tm_sec}.log")


def logger_configure(screen_level: int = LOG_WARN,
                     file_level: int = -1,
                     path: str = "",
                     timestamped: bool = False) -> None:
    """Configure the global logger sinks (Logger.h:123-140).

    With `timestamped`, the file name gets the reference's
    date/time suffix (Logger.cpp:76-89)."""
    if timestamped and path:
        path = timestamped_log_path(path)
    if NATIVE:
        _LIB.logger_configure(screen_level, file_level, path.encode())
    else:
        global _PY_SCREEN_LEVEL, _PY_FILE
        _PY_SCREEN_LEVEL = screen_level
        _PY_FILE = (open(path, "a"), file_level) if file_level >= 0 and path \
            else None


_PY_SCREEN_LEVEL = LOG_WARN
_PY_FILE = None


def log(level: int, tag: str, msg: str) -> None:
    """LOGMSG equivalent."""
    if NATIVE:
        _LIB.logger_log(level, tag.encode(), msg.encode())
        return
    names = {0: "ERROR", 1: "WARN", 2: "DEBUG"}
    line = f"[{names.get(level, '?')}] {tag}: {msg}"
    if level <= _PY_SCREEN_LEVEL:
        import sys
        print(line, file=sys.stderr)
    if _PY_FILE and level <= _PY_FILE[1]:
        _PY_FILE[0].write(line + "\n")
        _PY_FILE[0].flush()


def serialize_ppm(path: str, rgb, width: int, height: int) -> bool:
    """serializePPM (obcore/base/tools.cpp) — rgb: HxWx3 uint8 buffer."""
    data = bytes(memoryview(rgb).cast("B"))
    if NATIVE:
        return _LIB.serialize_ppm(path.encode(), data, width, height) == 0
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (width, height))
        f.write(data)
    return True


def serialize_pgm(path: str, gray, width: int, height: int) -> bool:
    """serializePGM — gray: HxW uint8 buffer."""
    data = bytes(memoryview(gray).cast("B"))
    if NATIVE:
        return _LIB.serialize_pgm(path.encode(), data, width, height) == 0
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (width, height))
        f.write(data)
    return True
