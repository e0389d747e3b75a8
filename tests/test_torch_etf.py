"""The port's ETF codec (``lasp_tpu_torch.bridge.etf``) against the JAX
package's: the published byte vectors and the codec properties of
``tests/bridge/test_etf.py``, the native conformance suite of
``tests/bridge/test_etf_native.py`` on the port's own build of
``native/laspetf.cpp``, and a seeded fuzz whose terms must encode to the
same bytes under JAX's codec and both of the port's arms.

The native arm is compiled by the port into ``build/lasp_tpu_torch/`` under
its own module name: loading it must leave JAX's codec (``native/
lasp_etf.so``, whose Atom class lives in a C global) returning JAX's
``Atom``."""

import random

import pytest

import lasp_tpu.bridge.etf as jetf
from lasp_tpu_torch.bridge import etf
from lasp_tpu_torch.bridge.etf import Atom, ETFDecodeError

# (term, term_to_binary bytes), the vectors of tests/bridge/test_etf.py
VECTORS = [
    (0, bytes([131, 97, 0])),
    (255, bytes([131, 97, 255])),
    (256, bytes([131, 98, 0, 0, 1, 0])),
    (-1, bytes([131, 98, 255, 255, 255, 255])),
    (Atom("ok"), bytes([131, 119, 2]) + b"ok"),
    (b"hi", bytes([131, 109, 0, 0, 0, 2]) + b"hi"),
    ((Atom("ok"), 1), bytes([131, 104, 2, 119, 2]) + b"ok" + bytes([97, 1])),
    ([], bytes([131, 106])),
    ([1, 2], bytes([131, 108, 0, 0, 0, 2, 97, 1, 97, 2, 106])),
    (1 << 40, bytes([131, 110, 6, 0, 0, 0, 0, 0, 0, 1])),
    (-(1 << 40), bytes([131, 110, 6, 1, 0, 0, 0, 0, 0, 1])),
    (1.5, bytes([131, 70, 63, 248, 0, 0, 0, 0, 0, 0])),
]


@pytest.fixture(scope="module")
def native():
    """The port's native arm, selected (and built) once."""
    assert etf.reselect() == "native", "the port's native ETF arm did not ship"
    return etf.native_module


@pytest.fixture(params=["python", "native"])
def arm(request, native):
    """(encode, decode) of one of the port's two arms."""
    if request.param == "python":
        return etf.py_encode, etf.py_decode
    return native.encode, native.decode


@pytest.mark.parametrize("term,blob", VECTORS)
def test_encode_matches_term_to_binary(term, blob, arm):
    assert arm[0](term) == blob == jetf.py_encode(_to_jax(term))


@pytest.mark.parametrize("term,blob", VECTORS)
def test_decode_matches_binary_to_term(term, blob, arm):
    assert arm[1](blob) == term


def test_atom_special_values_decode_to_python(arm):
    enc, dec = arm
    assert dec(enc(Atom("undefined"))) is None
    assert dec(enc(True)) is True
    assert dec(enc(False)) is False


def test_str_crosses_as_binary(arm):
    assert arm[1](arm[0]("hello")) == b"hello"


def test_nested_round_trip(arm):
    term = (
        Atom("update"),
        b"views",
        (Atom("increment"), 3),
        [(b"k", [(1, False), (2, True)]), (b"j", [])],
        {Atom("n_elems"): 64},
    )
    assert arm[1](arm[0](term)) == term


def test_old_atom_ext_decodes(arm):
    blob = bytes([131, 100, 0, 2]) + b"ok"
    got = arm[1](blob)
    assert got == Atom("ok") and type(got) is Atom


def test_string_ext_decodes_as_int_list(arm):
    assert arm[1](bytes([131, 107, 0, 2]) + b"hi") == [104, 105]


def test_improper_and_truncated_raise(arm):
    dec = arm[1]
    with pytest.raises(ETFDecodeError):
        dec(b"")
    with pytest.raises(ETFDecodeError):
        dec(bytes([131, 104, 2, 97, 1]))
    with pytest.raises(ETFDecodeError):
        dec(bytes([131, 108, 0, 0, 0, 1, 97, 1, 97, 2]))


def test_fuzz_roundtrip_random_nested_terms(arm):
    rng = random.Random(99)

    def gen(depth=0):
        kinds = ["int", "bigint", "bytes", "atom", "float"]
        if depth < 3:
            kinds += ["list", "tuple", "list", "tuple"]
        k = rng.choice(kinds)
        if k == "int":
            return rng.randint(-(1 << 30), 1 << 30)
        if k == "bigint":
            return rng.randint(-(1 << 200), 1 << 200)
        if k == "bytes":
            return bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 12)))
        if k == "atom":
            return Atom("".join(rng.choice("abc_xyz")
                                for _ in range(rng.randint(1, 10))))
        if k == "float":
            return rng.uniform(-1e12, 1e12)
        items = [gen(depth + 1) for _ in range(rng.randint(0, 4))]
        return items if k == "list" else tuple(items)

    for i in range(300):
        t = gen()
        assert arm[1](arm[0](t)) == t, i


# -- the native suite (tests/bridge/test_etf_native.py) on the port's arm ----


def random_term(rng: random.Random, atom=Atom, depth: int = 0):
    kinds = ["int", "big", "float", "atom", "bytes", "str", "none", "bool"]
    if depth < 4:
        kinds += ["list", "tuple", "map"] * 2
    k = rng.choice(kinds)
    if k == "int":
        return rng.randint(-(1 << 33), 1 << 33)
    if k == "big":
        return rng.randint(-(1 << 90), 1 << 90)
    if k == "float":
        return rng.uniform(-1e12, 1e12)
    if k == "atom":
        n = rng.choice([1, 3, 8, 255, 260])
        return atom("".join(rng.choice("abcXYZ_é") for _ in range(n)))
    if k == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
    if k == "str":
        return "".join(rng.choice("hello wörld 中") for _ in range(8))
    if k == "none":
        return None
    if k == "bool":
        return rng.random() < 0.5
    items = [random_term(rng, atom, depth + 1) for _ in range(rng.randrange(6))]
    if k == "list":
        return items
    if k == "tuple":
        return tuple(items)
    return {rng.choice([atom(f"k{i}"), f"k{i}".encode(), i]): v
            for i, v in enumerate(items)}


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_byte_identical_and_roundtrip(seed, native):
    rng = random.Random(seed)
    shape = etf._type_shape
    for _ in range(300):
        term = random_term(rng)
        raw_py = etf.py_encode(term)
        assert native.encode(term) == raw_py, term
        assert shape(native.decode(raw_py)) == shape(etf.py_decode(raw_py)), term


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_equal_bytes_across_packages(seed, native):
    """The same seeded terms, built with each package's Atom: JAX's codec
    and both of the port's arms emit the same bytes, and each decodes the
    other's bytes to the same shape."""
    shape_j, shape_t = jetf._type_shape, etf._type_shape
    rng_j, rng_t = random.Random(seed), random.Random(seed)
    for _ in range(300):
        tj = random_term(rng_j, jetf.Atom)
        tt = random_term(rng_t, Atom)
        raw = jetf.encode(tj)
        assert etf.py_encode(tt) == raw == native.encode(tt)
        assert shape_t(native.decode(raw)) == shape_t(etf.py_decode(raw))
        assert shape_j(jetf.decode(raw)) == shape_j(jetf.py_decode(raw))


def test_special_atoms_and_int_edges(native):
    for term in (None, True, False, 0, 255, 256, -1,
                 (1 << 31) - 1, 1 << 31, -(1 << 31), -(1 << 31) - 1,
                 (1 << 63) - 1, 1 << 63, -(1 << 63), 1 << 64, -(1 << 64),
                 1 << 2048, -(1 << 2048)):
        raw = etf.py_encode(term)
        assert native.encode(term) == raw, term
        assert etf._type_shape(native.decode(raw)) == etf._type_shape(
            etf.py_decode(raw)), term


def test_old_latin1_atom_decodes(native):
    name = "grüß".encode("latin-1")
    raw = bytes([131, 100, 0, len(name)]) + name
    assert etf._type_shape(native.decode(raw)) == etf._type_shape(
        etf.py_decode(raw))


def test_string_ext_decodes_to_byte_list(native):
    raw = bytes([131, 107, 0, 3]) + b"abc"
    assert native.decode(raw) == etf.py_decode(raw) == [97, 98, 99]


@pytest.mark.parametrize("bad", [
    b"",
    b"\x00",
    b"\x83",
    b"\x83\xff",
    b"\x83\x6c\xff\xff\xff\xff\x6a",
    b"\x83\x68\x02\x61\x01",
    b"\x83\x6d\xff\xff\xff\xff",
    b"\x83\x61\x01\x61\x02",
    b"\x83\x6c\x00\x00\x00\x01\x61\x01\x61\x02",
    b"\x83\x77\x02\xff\xfe",
])
def test_malformed_frames_raise_codec_error(bad, native):
    with pytest.raises(ETFDecodeError):
        native.decode(bad)
    with pytest.raises(ETFDecodeError):
        etf.py_decode(bad)


def test_deep_nesting_bounded_not_crash(native):
    body = b"\x6a"
    for _ in range(1000):
        body = b"\x6c\x00\x00\x00\x01" + body + b"\x6a"
    with pytest.raises(ETFDecodeError, match="deep"):
        native.decode(b"\x83" + body)
    with pytest.raises(ETFDecodeError, match="deep"):
        etf.py_decode(b"\x83" + body)
    ok_body = b"\x6a"
    for _ in range(500):
        ok_body = b"\x6c\x00\x00\x00\x01" + ok_body + b"\x6a"
    assert native.decode(b"\x83" + ok_body) == etf.py_decode(b"\x83" + ok_body)


def test_unencodable_raises_typeerror(native):
    with pytest.raises(TypeError):
        native.encode(object())
    with pytest.raises(TypeError):
        etf.py_encode(object())


def test_encode_depth_bound_matches_between_codecs(native):
    deep = []
    for _ in range(600):
        deep = [deep]
    with pytest.raises(TypeError, match="deep"):
        native.encode(deep)
    with pytest.raises(TypeError, match="deep"):
        etf.py_encode(deep)
    ok = []
    for _ in range(400):
        ok = [ok]
    assert native.encode(ok) == etf.py_encode(ok)


def test_config_etf_reselect(native):
    from lasp_tpu_torch.config import LaspConfig, get_config, set_config

    before = get_config()
    initial = etf.IMPL
    try:
        set_config(LaspConfig(etf="python"))
        assert etf.IMPL == "python"
        assert etf.decode(etf.encode((Atom("ok"), 1))) == (Atom("ok"), 1)
        set_config(LaspConfig(etf="auto"))
        assert etf.IMPL == etf.reselect() == "native"
    finally:
        set_config(before)
        assert etf.IMPL == initial


# -- the native arm is the port's own module, never JAX's .so -----------------


def test_native_arm_is_a_module_of_its_own(native):
    assert native.__file__ == str(etf.native_path())
    assert "build/lasp_tpu_torch" in native.__file__.replace("\\", "/")
    assert jetf.native_module is None or jetf.native_module is not native


def test_jax_codec_keeps_its_atom_after_the_port_loads(native):
    """The hazard of a shared load: ``set_classes`` writes C globals, so a
    second loader of ``native/lasp_etf.so`` would make JAX's decode return
    the port's classes. The port's module is another file: after it loads,
    and after a reselect, JAX's codec still decodes to JAX's ``Atom`` and
    raises JAX's error, and the port's to its own."""
    etf.reselect()
    for _ in range(2):
        got = jetf.decode(jetf.encode(jetf.Atom("x")))
        assert type(got) is jetf.Atom
        with pytest.raises(jetf.ETFDecodeError):
            jetf.decode(b"\x83\xff")
        mine = etf.decode(etf.encode(Atom("x")))
        assert type(mine) is Atom
        with pytest.raises(ETFDecodeError):
            etf.decode(b"\x83\xff")
        jetf.reselect()


def test_selection_waits_for_first_use():
    """Importing the codec builds and loads nothing; the first encode runs
    the selection (JAX selects at import)."""
    import subprocess
    import sys

    code = (
        "import lasp_tpu_torch.bridge.etf as etf\n"
        "assert etf.IMPL is None and etf.native_module is None\n"
        "assert etf.decode(etf.encode(etf.Atom('a'))) == 'a'\n"
        "print(etf.IMPL)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "native"


def _to_jax(term):
    """A port term with JAX's Atom in place of the port's."""
    if isinstance(term, Atom):
        return jetf.Atom(str(term))
    if isinstance(term, tuple):
        return tuple(_to_jax(x) for x in term)
    if isinstance(term, list):
        return [_to_jax(x) for x in term]
    return term
