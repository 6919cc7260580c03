"""ctypes loader for the C++ host library, with an on-demand g++ build
(counterpart of `deeplearning4j_tpu/native/loader.py`).

The library is built from the port's copy of the source
(`native/src/dl4jtpu_native.cpp`) into `deeplearning4j_tpu_torch/_build/`
(listed in `.gitignore`); its file name carries a digest of the source
and the flags, so an edited source is rebuilt and an unchanged one is
not. g++ writes to a temporary name that is then renamed into place, so
processes that build at once never load a half-written file.

If the library cannot be built or loaded, every function returns None
and its caller runs the reference's pure-Python route (the byte-split
word count of `nlp.vocab.VocabConstructor.build_vocab_from_files`, the
string-aware CSV reader). `route` is "native" after a call that the
library answered and "python" after one that returned None (no library,
or a file the native parser refuses); None before any call.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")

_SRC = Path(__file__).resolve().parent / "src" / "dl4jtpu_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
route: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libdl4jtpu_native-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.info("native build unavailable (%s); using Python routes", e)
        return False
    if proc.returncode != 0:
        logger.warning("native build failed; using Python routes:\n%s",
                       proc.stderr[-2000:])
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def native_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first call; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.warning("native library load failed (%s)", e)
            return None
        lib.dl4j_csv_parse.restype = ctypes.c_void_p
        lib.dl4j_csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_char]
        lib.dl4j_csv_ok.argtypes = [ctypes.c_void_p]
        lib.dl4j_csv_rows.restype = ctypes.c_int64
        lib.dl4j_csv_rows.argtypes = [ctypes.c_void_p]
        lib.dl4j_csv_cols.restype = ctypes.c_int64
        lib.dl4j_csv_cols.argtypes = [ctypes.c_void_p]
        lib.dl4j_csv_data.restype = ctypes.POINTER(ctypes.c_double)
        lib.dl4j_csv_data.argtypes = [ctypes.c_void_p]
        lib.dl4j_csv_free.argtypes = [ctypes.c_void_p]
        lib.dl4j_wc_create.restype = ctypes.c_void_p
        lib.dl4j_wc_add_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int]
        lib.dl4j_wc_total.restype = ctypes.c_int64
        lib.dl4j_wc_total.argtypes = [ctypes.c_void_p]
        lib.dl4j_wc_unique.restype = ctypes.c_int64
        lib.dl4j_wc_unique.argtypes = [ctypes.c_void_p]
        lib.dl4j_wc_serialize.restype = ctypes.c_int64
        lib.dl4j_wc_serialize.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_char_p)]
        lib.dl4j_buf_free.argtypes = [ctypes.c_char_p]
        lib.dl4j_wc_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return native_lib() is not None


def _took(result):
    global route
    route = "python" if result is None else "native"
    return result


def csv_parse_numeric(path, skip_lines: int = 0,
                      delimiter: str = ",") -> Optional[np.ndarray]:
    """Parse an all-numeric rectangular CSV into an (N, C) float64 array
    with the native parser. Returns None when the library is unavailable
    OR the file has string/ragged content: callers then run the Python
    route."""
    lib = native_lib()
    if lib is None or len(delimiter) != 1:
        return _took(None)
    h = lib.dl4j_csv_parse(str(path).encode(), int(skip_lines),
                           delimiter.encode())
    try:
        if not lib.dl4j_csv_ok(h):
            return _took(None)
        rows, cols = lib.dl4j_csv_rows(h), lib.dl4j_csv_cols(h)
        if rows == 0:
            return _took(np.zeros((0, 0), np.float64))
        return _took(np.ctypeslib.as_array(lib.dl4j_csv_data(h),
                                           shape=(rows, cols)).copy())
    finally:
        lib.dl4j_csv_free(h)


def count_words(paths: List, lowercase: bool = True) -> Optional[Dict[str, int]]:
    """Count whitespace-separated tokens across text files with the
    native counter (the vocabulary build's hot loop). None if unavailable.

    Case folding happens HERE, over unique words only: the C tokenizer is
    byte-oriented and its tolower would be ASCII-only, which would diverge
    from the Python route's str.lower() on non-ASCII corpora."""
    lib = native_lib()
    if lib is None:
        return _took(None)
    h = lib.dl4j_wc_create()
    try:
        for p in paths:
            if not lib.dl4j_wc_add_file(h, str(p).encode(), 0):
                return _took(None)  # IO error: the caller's route raises
        buf = ctypes.c_char_p()
        n = lib.dl4j_wc_serialize(h, ctypes.byref(buf))
        if n < 0:
            return _took(None)
        try:
            raw = ctypes.string_at(buf, n)
        finally:
            lib.dl4j_buf_free(buf)
        counts: Dict[str, int] = {}
        # records are "word\tcount\n": split on \n ONLY, since tokens may
        # hold other characters str.splitlines() breaks on (\x1c, U+2028)
        for line in raw.decode("utf-8", errors="replace").split("\n"):
            if not line:
                continue
            word, _, c = line.rpartition("\t")
            if lowercase:
                word = word.lower()
            counts[word] = counts.get(word, 0) + int(c)
        return _took(counts)
    finally:
        lib.dl4j_wc_free(h)
