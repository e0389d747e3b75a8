"""Durable host KV store: a ctypes binding to the native log-structured
store (port of ``lasp_tpu.store.host_store``).

The live lattice state lives in device memory; this is the durable host
half, the role the reference fills with native storage engines (eleveldb,
the default backend per ``include/lasp.hrl:14``; bitcask as the
alternative). ``native/laspstore.cpp`` implements a bitcask-style
append-only record log with CRC-checked records, torn-write truncation on
open, tombstone deletes and an in-memory index; this module loads the
repo's unchanged ``native/liblaspstore.so`` (built by ``make -C native``).

The contract mirrors ``lasp_backend`` (``src/lasp_backend.erl:26-28``:
``start/put/get``) plus delete / keys / compact. Where the library is not
built, a pure-Python engine with the identical on-disk format serves
(``backend`` reports which engine is active), as in the JAX package, so
either package reads the other's files."""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib

_SO_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "liblaspstore.so",
)

_FILE_MAGIC = 0x4C535354
_REC_MAGIC = 0x4C535052
_VERSION = 1
_TOMBSTONE = 0xFFFFFFFFFFFFFFFF


@functools.cache
def _native():
    """The bound native library, or None: loaded at the first store opened
    (not at import), so a library built after the import still serves."""
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        return _bind_native(lib)
    except (OSError, AttributeError) as e:
        # a stale .so (e.g. built before lasp_store_compact existed)
        # degrades to the Python engine instead of breaking the import
        import warnings

        warnings.warn(
            f"liblaspstore.so unusable ({e}); rebuild with `make -C native`."
            " Falling back to the Python log engine.",
            RuntimeWarning,
            stacklevel=2,
        )
        return None


def _bind_native(lib):
    lib.lasp_store_open.restype = ctypes.c_void_p
    lib.lasp_store_open.argtypes = [ctypes.c_char_p]
    lib.lasp_store_put.restype = ctypes.c_int
    lib.lasp_store_put.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.lasp_store_len.restype = ctypes.c_int64
    lib.lasp_store_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.lasp_store_get.restype = ctypes.c_int64
    lib.lasp_store_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_char_p,
        ctypes.c_uint64,
    ]
    lib.lasp_store_delete.restype = ctypes.c_int
    lib.lasp_store_delete.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint32,
    ]
    lib.lasp_store_count.restype = ctypes.c_uint64
    lib.lasp_store_count.argtypes = [ctypes.c_void_p]
    lib.lasp_store_wasted.restype = ctypes.c_uint64
    lib.lasp_store_wasted.argtypes = [ctypes.c_void_p]
    lib.lasp_store_keys_len.restype = ctypes.c_uint64
    lib.lasp_store_keys_len.argtypes = [ctypes.c_void_p]
    lib.lasp_store_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.lasp_store_compact.restype = ctypes.c_int
    lib.lasp_store_compact.argtypes = [ctypes.c_void_p]
    lib.lasp_store_close.argtypes = [ctypes.c_void_p]
    return lib


class HostStore:
    """Bitcask-style durable KV store (native when built, else fallback)."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _native()
        if self._lib is not None:
            self._h = self._lib.lasp_store_open(path.encode())
            if not self._h:
                raise IOError(f"laspstore: cannot open {path}")
            self.backend = "native"
        else:
            self._py = _PyLog(path)
            self.backend = "python-fallback"

    # -- lasp_backend contract (start/put/get) + delete/keys ---------------
    def put(self, key: str, value: bytes) -> None:
        k = key.encode()
        if self.backend == "native":
            rc = self._lib.lasp_store_put(self._h, k, len(k), bytes(value), len(value))
            if rc != 0:
                raise IOError(f"laspstore put failed: {rc}")
        else:
            self._py.put(k, bytes(value))

    def get(self, key: str):
        k = key.encode()
        if self.backend == "native":
            n = self._lib.lasp_store_len(self._h, k, len(k))
            if n < 0:
                return None
            buf = ctypes.create_string_buffer(int(n))
            got = self._lib.lasp_store_get(self._h, k, len(k), buf, n)
            if got != n:
                raise IOError(f"laspstore get failed: {got}")
            return buf.raw[:n]
        return self._py.get(k)

    def delete(self, key: str) -> bool:
        k = key.encode()
        if self.backend == "native":
            return self._lib.lasp_store_delete(self._h, k, len(k)) == 0
        return self._py.delete(k)

    def keys(self) -> list[str]:
        if self.backend == "native":
            n = self._lib.lasp_store_keys_len(self._h)
            if n == 0:
                return []
            buf = ctypes.create_string_buffer(int(n))
            self._lib.lasp_store_keys(self._h, buf)
            # length-prefixed wire format (u32 len | key bytes, repeated):
            # keys may contain ANY byte, including newlines
            raw = buf.raw[: int(n)]
            out, off = [], 0
            while off < len(raw):
                (klen,) = struct.unpack_from("<I", raw, off)
                off += 4
                out.append(raw[off : off + klen].decode())
                off += klen
            return out
        return sorted(k.decode() for k in self._py.index)

    def compact(self) -> None:
        """Rewrite live records into a fresh log, reclaiming superseded and
        tombstoned bytes (the reference's waste_pct compaction cue,
        ``src/lasp_orset.erl:178-191``)."""
        if self.backend == "native":
            rc = self._lib.lasp_store_compact(self._h)
            if rc != 0:
                raise IOError(f"laspstore compact failed: {rc}")
        else:
            self._py.compact()

    def stats(self) -> dict:
        if self.backend == "native":
            return {
                "keys": int(self._lib.lasp_store_count(self._h)),
                "wasted_bytes": int(self._lib.lasp_store_wasted(self._h)),
                "backend": self.backend,
            }
        return {
            "keys": len(self._py.index),
            "wasted_bytes": self._py.wasted,
            "backend": self.backend,
        }

    def close(self) -> None:
        if self.backend == "native":
            if self._h:
                self._lib.lasp_store_close(self._h)
                self._h = None
        else:
            self._py.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PyLog:
    """Same on-disk format as native/laspstore.cpp, in Python."""

    def __init__(self, path: str):
        self.path = path
        exists = os.path.exists(path)
        self.f = open(path, "r+b" if exists else "w+b")
        self.index: dict[bytes, tuple[int, int]] = {}
        self.wasted = 0
        if not exists:
            self.f.write(struct.pack("<II", _FILE_MAGIC, _VERSION))
            self.f.flush()
        else:
            self._scan()

    def _scan(self):
        hdr = self.f.read(8)
        if len(hdr) < 8 or struct.unpack("<II", hdr) != (_FILE_MAGIC, _VERSION):
            raise IOError("laspstore: bad header")
        pos = self.f.tell()
        while True:
            head = self.f.read(16)
            if len(head) < 16:
                break
            rmagic, key_len, val_len = struct.unpack("<IIQ", head)
            if rmagic != _REC_MAGIC:
                break
            tomb = val_len == _TOMBSTONE
            vlen = 0 if tomb else val_len
            if key_len > (1 << 24) or vlen > (1 << 38):
                break  # garbage header from a torn write; truncate here
            payload = self.f.read(key_len + vlen)
            crc_raw = self.f.read(4)
            if len(payload) < key_len + vlen or len(crc_raw) < 4:
                break
            if zlib.crc32(payload) & 0xFFFFFFFF != struct.unpack("<I", crc_raw)[0]:
                break
            key = payload[:key_len]
            if key in self.index:
                self.wasted += self.index[key][1]
            if tomb:
                self.index.pop(key, None)
            else:
                self.index[key] = (pos + 16 + key_len, vlen)
            pos = self.f.tell()
        self.f.seek(pos)
        self.f.truncate()

    def put(self, key: bytes, value: bytes):
        pos = self.f.tell()
        crc = zlib.crc32(key + value) & 0xFFFFFFFF
        self.f.write(struct.pack("<IIQ", _REC_MAGIC, len(key), len(value)))
        self.f.write(key)
        self.f.write(value)
        self.f.write(struct.pack("<I", crc))
        self.f.flush()
        if key in self.index:
            self.wasted += self.index[key][1]
        self.index[key] = (pos + 16 + len(key), len(value))

    def get(self, key: bytes):
        if key not in self.index:
            return None
        off, n = self.index[key]
        saved = self.f.tell()
        self.f.seek(off)
        data = self.f.read(n)
        self.f.seek(saved)
        return data

    def delete(self, key: bytes) -> bool:
        if key not in self.index:
            return False
        crc = zlib.crc32(key) & 0xFFFFFFFF
        self.f.write(struct.pack("<IIQ", _REC_MAGIC, len(key), _TOMBSTONE))
        self.f.write(key)
        self.f.write(struct.pack("<I", crc))
        self.f.flush()
        self.wasted += self.index[key][1]
        del self.index[key]
        return True

    def compact(self):
        tmp_path = self.path + ".compact"
        try:
            with open(tmp_path, "w+b") as out:
                out.write(struct.pack("<II", _FILE_MAGIC, _VERSION))
                new_index: dict[bytes, tuple[int, int]] = {}
                for key, (off, n) in self.index.items():
                    self.f.seek(off)
                    value = self.f.read(n)
                    pos = out.tell()
                    crc = zlib.crc32(key + value) & 0xFFFFFFFF
                    out.write(
                        struct.pack("<IIQ", _REC_MAGIC, len(key), len(value))
                    )
                    out.write(key)
                    out.write(value)
                    out.write(struct.pack("<I", crc))
                    new_index[key] = (pos + 16 + len(key), len(value))
                out.flush()
        except BaseException:
            # leave the store fully usable on the old log: appends must
            # land at end-of-file, and the temp file must not linger
            self.f.seek(0, os.SEEK_END)
            try:
                os.remove(tmp_path)
            except OSError:
                pass
            raise
        # keep the old handle open across the swap: if the reopen fails the
        # store keeps operating on the old (now unlinked) inode, and the
        # compacted file on disk holds the same live records
        self.f.seek(0, os.SEEK_END)
        os.replace(tmp_path, self.path)
        new_f = open(self.path, "r+b")
        new_f.seek(0, os.SEEK_END)
        self.f.close()
        self.f = new_f
        self.index = new_index
        self.wasted = 0

    def close(self):
        self.f.close()
