"""Erlang External Term Format (ETF) codec — the bridge's wire encoding
(port of ``lasp_tpu.bridge.etf``, with this package's own ``Atom`` and
``ETFDecodeError``).

An Erlang node delegates its ``lasp_backend`` behaviour
(``src/lasp_backend.erl:26-28``: ``start/put/get``) to this package's
store. The cheapest possible BEAM
side is ``gen_tcp`` with ``{packet, 4}`` framing and
``term_to_binary``/``binary_to_term`` — which makes the Python side's job
speaking ETF. This module implements the subset of ETF the bridge
protocol uses (integers incl. bignums, floats, atoms, binaries, lists,
tuples, maps), against the published format (external term format tag
131; tag bytes per the Erlang distribution protocol docs).

Atoms decode to :class:`Atom` (interned-string wrapper) so round-trips
preserve the atom/binary/string distinction Erlang cares about.
"""

from __future__ import annotations

import hashlib
import os
import struct
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import Any

#: which codec implementation serves ("python" | "native"), or None until
#: the first encode / decode (or :func:`reselect`) runs the selection: the
#: native arm is compiled at first use, never at import — see
#: ``_try_native()`` at the bottom
IMPL = None

_VERSION = 131
_NEW_FLOAT = 70
_SMALL_INT = 97
_INT = 98
_SMALL_BIG = 110
_LARGE_BIG = 111
_ATOM_UTF8 = 118
_SMALL_ATOM_UTF8 = 119
_ATOM_OLD = 100  # ATOM_EXT (deprecated but still emitted by old nodes)
_BINARY = 109
_STRING = 107
_LIST = 108
_NIL = 106
_SMALL_TUPLE = 104
_LARGE_TUPLE = 105
_MAP = 116


class Atom(str):
    """An Erlang atom. Subclasses ``str`` so ``Atom("ok") == "ok"`` for
    ergonomic matching, while ``encode`` emits an atom, not a binary."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Atom({str.__repr__(self)})"


#: the protocol's common atoms, pre-made
OK = Atom("ok")
ERROR = Atom("error")
UNDEFINED = Atom("undefined")


class ETFDecodeError(ValueError):
    pass


def encode(term: Any) -> bytes:
    """Python term -> ``term_to_binary`` bytes."""
    out = bytearray([_VERSION])
    _enc(term, out)
    return bytes(out)


def _check_len(n: int) -> int:
    # 4-byte wire length fields; past them the native codec would
    # otherwise truncate and the struct.pack path would raise its own
    # opaque error — both codecs refuse identically instead
    if n > 0xFFFFFFFF:
        raise ValueError("term too large for ETF (4-byte length field)")
    return n


def _enc(t: Any, out: bytearray, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        # same bound as decode (and the native encoder): frames nested
        # past _MAX_DEPTH could never be decoded by either codec anyway
        raise TypeError("ETF term nesting too deep")
    if isinstance(t, Atom):
        raw = t.encode("utf-8")
        if len(raw) < 256:
            out.append(_SMALL_ATOM_UTF8)
            out.append(len(raw))
        else:
            out.append(_ATOM_UTF8)
            out += struct.pack(">H", len(raw))
        out += raw
    elif isinstance(t, bool):
        _enc(Atom("true") if t else Atom("false"), out, depth)
    elif isinstance(t, int):
        if 0 <= t <= 255:
            out.append(_SMALL_INT)
            out.append(t)
        elif -(1 << 31) <= t < (1 << 31):
            out.append(_INT)
            out += struct.pack(">i", t)
        else:
            sign = 1 if t < 0 else 0
            mag = -t if sign else t
            nbytes = (mag.bit_length() + 7) // 8
            if nbytes < 256:
                out.append(_SMALL_BIG)
                out.append(nbytes)
            else:
                out.append(_LARGE_BIG)
                out += struct.pack(">I", nbytes)
            out.append(sign)
            out += mag.to_bytes(nbytes, "little")
    elif isinstance(t, float):
        out.append(_NEW_FLOAT)
        out += struct.pack(">d", t)
    elif isinstance(t, (bytes, bytearray)):
        out.append(_BINARY)
        out += struct.pack(">I", _check_len(len(t)))
        out += t
    elif isinstance(t, str):
        # plain str crosses as a binary (Elixir convention); use Atom for
        # atoms. The Erlang side reads these with binary pattern matches.
        _enc(t.encode("utf-8"), out, depth)
    elif isinstance(t, tuple):
        if len(t) < 256:
            out.append(_SMALL_TUPLE)
            out.append(len(t))
        else:
            out.append(_LARGE_TUPLE)
            out += struct.pack(">I", _check_len(len(t)))
        for x in t:
            _enc(x, out, depth + 1)
    elif isinstance(t, list):
        if not t:
            out.append(_NIL)
        else:
            out.append(_LIST)
            out += struct.pack(">I", _check_len(len(t)))
            for x in t:
                _enc(x, out, depth + 1)
            out.append(_NIL)
    elif isinstance(t, dict):
        out.append(_MAP)
        out += struct.pack(">I", _check_len(len(t)))
        for k, v in t.items():
            _enc(k, out, depth + 1)
            _enc(v, out, depth + 1)
    elif t is None:
        _enc(UNDEFINED, out, depth)
    else:
        raise TypeError(f"cannot encode {type(t).__name__} as ETF: {t!r}")


#: decode nesting bound — the SAME constant as the native codec's
#: MAX_DEPTH (native/laspetf.cpp), so both codecs accept the identical
#: wire language; without it a hostile deeply-nested frame would escape
#: as RecursionError past the server's ETFDecodeError handler
_MAX_DEPTH = 512


def decode(data: bytes) -> Any:
    """``term_to_binary`` bytes -> Python term."""
    if not data or data[0] != _VERSION:
        raise ETFDecodeError("missing ETF version byte")
    try:
        term, off = _dec(data, 1)
    except (struct.error, IndexError, UnicodeDecodeError, RecursionError) as e:
        # malformed frames must surface as ETFDecodeError, never leak the
        # parser's internal exceptions (the server's error-term contract)
        raise ETFDecodeError(f"malformed term: {e}") from e
    if off != len(data):
        raise ETFDecodeError(f"trailing bytes after term ({len(data) - off})")
    return term


def _dec(b: bytes, off: int, depth: int = 0):
    if depth > _MAX_DEPTH:
        raise ETFDecodeError("term nesting too deep")
    try:
        tag = b[off]
    except IndexError as e:
        raise ETFDecodeError("truncated term") from e
    off += 1
    if tag == _SMALL_INT:
        return b[off], off + 1
    if tag == _INT:
        return struct.unpack_from(">i", b, off)[0], off + 4
    if tag in (_SMALL_BIG, _LARGE_BIG):
        if tag == _SMALL_BIG:
            n, off = b[off], off + 1
        else:
            (n,) = struct.unpack_from(">I", b, off)
            off += 4
        sign = b[off]
        off += 1
        mag = int.from_bytes(b[off : off + n], "little")
        return (-mag if sign else mag), off + n
    if tag == _NEW_FLOAT:
        return struct.unpack_from(">d", b, off)[0], off + 8
    if tag in (_SMALL_ATOM_UTF8, _ATOM_UTF8, _ATOM_OLD):
        if tag == _SMALL_ATOM_UTF8:
            n, off = b[off], off + 1
        else:
            (n,) = struct.unpack_from(">H", b, off)
            off += 2
        # ATOM_EXT (deprecated) is defined as Latin-1; the UTF8 tags as UTF-8
        enc = "latin-1" if tag == _ATOM_OLD else "utf-8"
        name = b[off : off + n].decode(enc)
        off += n
        if name == "undefined":
            return None, off
        if name == "true":
            return True, off
        if name == "false":
            return False, off
        return Atom(name), off
    if tag == _BINARY:
        (n,) = struct.unpack_from(">I", b, off)
        off += 4
        return b[off : off + n], off + n
    if tag == _STRING:
        # an Erlang list of bytes; surfaces as list[int] like LIST would
        (n,) = struct.unpack_from(">H", b, off)
        off += 2
        return list(b[off : off + n]), off + n
    if tag == _NIL:
        return [], off
    if tag == _LIST:
        (n,) = struct.unpack_from(">I", b, off)
        off += 4
        items = []
        for _ in range(n):
            x, off = _dec(b, off, depth + 1)
            items.append(x)
        tail, off = _dec(b, off, depth + 1)
        if tail != []:
            raise ETFDecodeError("improper list")
        return items, off
    if tag in (_SMALL_TUPLE, _LARGE_TUPLE):
        if tag == _SMALL_TUPLE:
            n, off = b[off], off + 1
        else:
            (n,) = struct.unpack_from(">I", b, off)
            off += 4
        items = []
        for _ in range(n):
            x, off = _dec(b, off, depth + 1)
            items.append(x)
        return tuple(items), off
    if tag == _MAP:
        (n,) = struct.unpack_from(">I", b, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(b, off, depth + 1)
            v, off = _dec(b, off, depth + 1)
            d[k] = v
        return d, off
    raise ETFDecodeError(f"unsupported ETF tag {tag}")


# -- native codec (BEAM does ETF in C; so does this bridge) ------------------
#
# The native arm is the unchanged ``native/laspetf.cpp``, compiled by this
# package into its own extension module (``lasp_etf_torch``) under
# ``build/lasp_tpu_torch/``. It never loads ``native/lasp_etf.so``: that
# module keeps its Atom and error classes in process-wide C globals set by
# ``set_classes``, so a second loader of the same file would retarget the
# JAX package's codec at this package's classes. A file of its own has
# globals of its own.

#: the Python implementations stay importable under these names whatever
#: codec is active — the conformance tests cross-check native against them
py_encode = encode
py_decode = decode

#: the loaded C extension module when IMPL == "native", else None
native_module = None

_REPO = Path(__file__).resolve().parents[2]
NATIVE_SOURCE = _REPO / "native" / "laspetf.cpp"
BUILD_DIR = _REPO / "build" / "lasp_tpu_torch"
_MODULE = "lasp_etf_torch"
CXX_FLAGS = (
    "-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared",
    # the module's init symbol carries this module's name
    f"-DPyInit_lasp_etf=PyInit_{_MODULE}",
)

#: self-check corpus: one term per wire shape the protocol uses. The
#: native codec ships ONLY if it byte-matches the Python encoder and
#: round-trips identically on every entry — a mismatch silently falls
#: back to Python (the bridge must keep speaking correct ETF even if the
#: .so is stale or miscompiled).
_SELFCHECK = [
    Atom("ok"),
    (Atom("error"), Atom("badarg"), b"detail"),
    None, True, False,
    0, 255, 256, -1, -(1 << 31), (1 << 31) - 1,
    (1 << 31), -(1 << 31) - 1, (1 << 62), 1 << 80, -(1 << 80),
    3.14159, -0.0,
    b"", b"bytes", "a str crosses as binary", "é中",
    [], [1, [2, [3, []]], (4, 5)], list(range(300)),
    (), (1,), tuple(range(300)),
    {Atom("n_elems"): 64, b"k": [1, 2]},
    [(b"elem0", [(0, False), (1, True)]), (b"elem1", [])],
    Atom("a" * 300),  # ATOM_UTF8 (2-byte length) path
]


def native_path() -> Path:
    """Where this package's build of the native codec lives: named by a
    hash of the source, the flags and the interpreter, so an edited source
    or another Python rebuilds."""
    include = sysconfig.get_path("include")
    digest = hashlib.sha256(
        NATIVE_SOURCE.read_bytes()
        + " ".join(CXX_FLAGS + (include, sys.version)).encode()
    ).hexdigest()
    return BUILD_DIR / f"{_MODULE}-{digest[:16]}.so"


def build_native() -> Path:
    """Compile ``native/laspetf.cpp`` with ``g++`` into :func:`native_path`
    unless it is there already; returns the path. Raises when the compiler
    fails."""
    target = native_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, f"-I{sysconfig.get_path('include')}", "-o", tmp,
         str(NATIVE_SOURCE)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{cxx} failed on {NATIVE_SOURCE} (rc={proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return target


def reselect() -> str:
    """(Re)run codec selection against the active config and return the
    resulting ``IMPL``. Runs at the first encode / decode and again
    whenever :func:`lasp_tpu_torch.config.set_config` installs a new config
    — so ``LaspConfig(etf="python")`` set programmatically takes effect,
    not just the ``LASP_ETF`` env var."""
    global IMPL, encode, decode, native_module
    IMPL, encode, decode, native_module = "python", py_encode, py_decode, None
    _try_native()
    return IMPL


def _try_native() -> None:
    global IMPL, encode, decode
    import importlib.machinery
    import importlib.util

    # selection vocabulary of LaspConfig.etf ("auto" | "python"). The
    # config is consulted through get_config() so programmatic configs
    # count; if the config itself cannot resolve (bogus unrelated LASP_*
    # env), fall back to the raw env var rather than making this raise —
    # get_config() rejects loudly at its own call sites
    try:
        from ..config import get_config

        choice = get_config().etf
    except Exception:
        choice = os.environ.get("LASP_ETF") or "auto"
    if choice == "python" or not NATIVE_SOURCE.exists():
        return
    try:
        so = str(build_native())
        loader = importlib.machinery.ExtensionFileLoader(_MODULE, so)
        spec = importlib.util.spec_from_loader(_MODULE, loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        mod.set_classes(Atom, ETFDecodeError)
        for term in _SELFCHECK:
            raw = py_encode(term)
            if mod.encode(term) != raw:
                return
            # type-exact comparison: the atom/binary/str distinction (and
            # bool vs int) must survive, which plain == would conflate
            if _type_shape(mod.decode(raw)) != _type_shape(py_decode(raw)):
                return
        # malformed input must raise the codec's error type, not segfault
        # or leak a foreign exception
        for bad in (b"", b"\x00", b"\x83", b"\x83\x6a\x6a", b"\x83\xff",
                    b"\x83\x6c\xff\xff\xff\xff\x6a"):
            try:
                mod.decode(bad)
                return  # accepted garbage: do not ship
            except ETFDecodeError:
                pass
    except Exception:
        return
    global native_module
    native_module = mod
    encode, decode = mod.encode, mod.decode
    IMPL = "native"


def _type_shape(t):
    if isinstance(t, Atom):
        return ("atom", str(t))
    if isinstance(t, tuple):
        return ("t",) + tuple(_type_shape(x) for x in t)
    if isinstance(t, list):
        return ("l",) + tuple(_type_shape(x) for x in t)
    if isinstance(t, dict):
        return ("m",) + tuple(
            (_type_shape(k), _type_shape(v)) for k, v in t.items()
        )
    return (type(t).__name__, t)


def _select_then_encode(term: Any) -> bytes:
    if IMPL is None:
        reselect()
    return encode(term)


def _select_then_decode(data: bytes) -> Any:
    if IMPL is None:
        reselect()
    return decode(data)


# until the first call selects (and builds) an arm; reselect() rebinds
# both names, so a caller reading ``etf.encode`` afterwards gets the arm
encode, decode = _select_then_encode, _select_then_decode
