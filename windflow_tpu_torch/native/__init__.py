"""ctypes bindings for the C++ native host runtime (native/wf_native.cpp).

The shared library is built on demand with ``make -C native`` (g++ only, no
third-party dependencies) and cached; if the toolchain is unavailable the
framework falls back to the pure-Python cores transparently.  Every call
into the library releases the GIL, so farm workers running native cores get
true multicore host parallelism — the FastFlow-pinned-threads property the
reference gets for free from being a C++ library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO = os.path.join(_DIR, "libwfnative.so")

_lock = threading.Lock()
_lib = None
_tried = False

i64 = ctypes.c_longlong
p_i64 = ctypes.POINTER(i64)
p_i32 = ctypes.POINTER(ctypes.c_int32)
p_int = ctypes.POINTER(ctypes.c_int)


def _build() -> bool:
    src = os.path.join(_DIR, "wf_native.cpp")
    if not os.path.exists(src):
        return False
    # always invoke make: it no-ops when up to date and rebuilds when the
    # host fingerprint changed (host.tag — a -march=native .so cached on
    # another CPU would SIGILL; mtime alone cannot see that)
    try:
        subprocess.run(["make", "-C", _DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_SO)
    except Exception:
        # no toolchain: only trust an existing .so that is not stale
        # relative to the source (the pre-host.tag safety rule)
        return (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(src))


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            return _bind(ctypes.CDLL(_SO))
        except Exception:
            # dlopen failure or missing symbol (e.g. a truncated or
            # older-ABI .so that survived a failed rebuild): fall back to
            # the pure-Python cores instead of crashing the dataflow
            return None


def _bind(lib):
    global _lib
    lib.wf_core_new.restype = ctypes.c_void_p
    lib.wf_core_new.argtypes = ([i64] * 2 + [ctypes.c_int] * 2
                                + [i64] * 11 + [ctypes.c_int])
    lib.wf_core_free.argtypes = [ctypes.c_void_p]
    lib.wf_core_process.restype = i64
    lib.wf_core_process.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    i64, i64, i64, i64, i64, i64, i64]
    lib.wf_core_eos.restype = i64
    lib.wf_core_eos.argtypes = [ctypes.c_void_p]
    lib.wf_core_force_flush.restype = i64
    lib.wf_core_force_flush.argtypes = [ctypes.c_void_p]
    lib.wf_core_set_flush_rows.restype = None
    lib.wf_core_set_flush_rows.argtypes = [ctypes.c_void_p, i64]
    lib.wf_renum_new.restype = ctypes.c_void_p
    lib.wf_renum_new.argtypes = []
    lib.wf_renum_free.argtypes = [ctypes.c_void_p]
    lib.wf_renum_run.restype = None
    lib.wf_renum_run.argtypes = [ctypes.c_void_p, p_i64, i64, p_i64]
    lib.wf_renum_next.restype = i64
    lib.wf_renum_next.argtypes = [ctypes.c_void_p, i64]
    lib.wf_keymap_new.restype = ctypes.c_void_p
    lib.wf_keymap_new.argtypes = []
    lib.wf_keymap_free.argtypes = [ctypes.c_void_p]
    lib.wf_keymap_lookup.restype = i64
    lib.wf_keymap_lookup.argtypes = [ctypes.c_void_p, p_i64, i64, p_i64]
    lib.wf_keyscan_ordered.restype = i64
    lib.wf_keyscan_ordered.argtypes = [p_i64, p_i64, i64, p_i64, p_i64,
                                       p_i64, p_i64]
    lib.wf_cores_process_mt.restype = i64
    lib.wf_cores_process_mt.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i64, ctypes.c_void_p,
        i64, i64, i64, i64, i64, i64, i64]
    lib.wf_max_fields.restype = i64
    lib.wf_max_fields.argtypes = []
    lib.wf_core_set_fields.restype = i64
    lib.wf_core_set_fields.argtypes = [ctypes.c_void_p, i64, p_int]
    lib.wf_cores_process_mt_f.restype = i64
    lib.wf_cores_process_mt_f.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i64, ctypes.c_void_p,
        i64, i64, i64, i64, i64, i64, p_i64]
    lib.wf_launch_peek_wires.restype = ctypes.c_int
    lib.wf_launch_peek_wires.argtypes = [ctypes.c_void_p, p_int]
    lib.wf_launch_take_padded_f.restype = None
    lib.wf_launch_take_padded_f.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), i64, i64,
        p_i64, p_i32, p_i32, p_i32, p_i64, p_i64, p_i64, p_i64, p_i64,
        p_i64]
    lib.wf_launch_pending.restype = i64
    lib.wf_launch_pending.argtypes = [ctypes.c_void_p]
    lib.wf_launch_peek.restype = ctypes.c_int
    lib.wf_launch_peek.argtypes = [ctypes.c_void_p, p_i64, p_i64, p_i64,
                                   p_int, p_int, p_i64, p_i64]
    lib.wf_launch_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   p_i64, p_i32, p_i32, p_i32,
                                   p_i64, p_i64, p_i64, p_i64]
    lib.wf_launch_take_padded.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64,
        p_i64, p_i32, p_i32, p_i32, p_i64, p_i64, p_i64, p_i64, p_i64,
        p_i64]
    lib.wf_launch_peek_regular.restype = ctypes.c_int
    lib.wf_launch_peek_regular.argtypes = [ctypes.c_void_p, p_i64]
    lib.wf_launch_coalesce.restype = i64
    lib.wf_launch_coalesce.argtypes = [ctypes.c_void_p, i64, i64, i64]
    lib.wf_launch_take_regular.argtypes = [ctypes.c_void_p, p_i32,
                                           p_i32, p_i32, p_i32]
    lib.wf_queue_new.restype = ctypes.c_void_p
    lib.wf_queue_new.argtypes = [i64]
    lib.wf_queue_free.argtypes = [ctypes.c_void_p]
    lib.wf_queue_push.restype = ctypes.c_int
    lib.wf_queue_push.argtypes = [ctypes.c_void_p, i64, i64]
    lib.wf_queue_pop.restype = ctypes.c_int
    lib.wf_queue_pop.argtypes = [ctypes.c_void_p, p_i64, p_i64]
    lib.wf_queue_close.argtypes = [ctypes.c_void_p]
    # overload-policy entry points (runtime/overload.py) — absent from a
    # pre-robustness .so; bind tolerantly so an old library still serves
    # every default path and only the opt-in shed/deadline knobs fall back
    # to the Python queue (engine._make_inbox gates on this flag)
    try:
        lib.wf_queue_try_push.restype = ctypes.c_int
        lib.wf_queue_try_push.argtypes = [ctypes.c_void_p, i64, i64]
        lib.wf_queue_push_timed.restype = ctypes.c_int
        lib.wf_queue_push_timed.argtypes = [ctypes.c_void_p, i64, i64, i64]
        lib.wf_queue_try_pop.restype = ctypes.c_int
        lib.wf_queue_try_pop.argtypes = [ctypes.c_void_p, p_i64, p_i64]
        lib.wf_has_overload_queue = True
    except AttributeError:
        lib.wf_has_overload_queue = False
    # state-ABI entry points (checkpoints + keyed live rescale for the
    # native core, docs/ROBUSTNESS.md "Native state ABI") — absent from a
    # pre-ABI .so; bind tolerantly so an old library still serves every
    # default execution path while snapshot/migration requests decline
    # loudly (SnapshotUnsupported / check WF215 gate on this flag)
    try:
        lib.wf_abi_version.restype = i64
        lib.wf_abi_version.argtypes = []
        lib.wf_core_state_size.restype = i64
        lib.wf_core_state_size.argtypes = [ctypes.c_void_p]
        lib.wf_core_state_export.restype = i64
        lib.wf_core_state_export.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p, i64]
        lib.wf_core_state_import.restype = i64
        lib.wf_core_state_import.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p, i64]
        lib.wf_core_key_count.restype = i64
        lib.wf_core_key_count.argtypes = [ctypes.c_void_p]
        lib.wf_core_key_list.restype = i64
        lib.wf_core_key_list.argtypes = [ctypes.c_void_p, p_i64, i64]
        lib.wf_core_key_state_size.restype = i64
        lib.wf_core_key_state_size.argtypes = [ctypes.c_void_p, i64]
        lib.wf_core_key_export.restype = i64
        lib.wf_core_key_export.argtypes = [ctypes.c_void_p, i64,
                                           ctypes.c_void_p, i64]
        lib.wf_core_key_import.restype = i64
        lib.wf_core_key_import.argtypes = [ctypes.c_void_p,
                                           ctypes.c_void_p, i64]
        lib.wf_core_key_neutralize.restype = i64
        lib.wf_core_key_neutralize.argtypes = [ctypes.c_void_p, i64]
        lib.wf_has_state_abi = True
    except AttributeError:
        lib.wf_has_state_abi = False
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def enabled():
    """The native library, or None when unavailable or opted out via
    WF_NO_NATIVE=1 — the single selection gate for every native-vs-Python
    choice (cores, engine channels)."""
    if os.environ.get("WF_NO_NATIVE", "") == "1":
        return None
    return load()
