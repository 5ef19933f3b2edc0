"""Parity of the port's encoding layer with the JAX package's.

The host codecs must produce identical bytes; the port's plain decode of
every resident layout (the kernel prologue's plain version) must return
exactly what the JAX decode returns, for all rows and for a gather.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horaedb_tpu.ops import encoding as ref
from horaedb_tpu_torch.convert import _tensor
from horaedb_tpu_torch.ops import encoding as port

from torch_parity import assert_bit_equal

WIDTHS = (1, 7, 8, 13, 16)
N = 4096


def _codes(rng, width: int, n: int = N) -> np.ndarray:
    return rng.integers(0, 1 << width, n).astype(np.uint32)


@pytest.mark.parametrize("width", WIDTHS)
def test_codec_bytes_identical(width):
    rng = np.random.default_rng(width)
    codes = _codes(rng, width)
    assert ref.pack_bits(codes, width).tobytes() == port.pack_bits(codes, width).tobytes()
    words = ref.pack_bits(codes, width)
    assert_bit_equal(
        port.unpack_bits_host(words, width, N), ref.unpack_bits_host(words, width, N)
    )
    # dictionary encoding of a low-cardinality f32 column
    vocab = rng.normal(0, 50, 1 << min(width, 10)).astype(np.float32)
    col = vocab[rng.integers(0, len(vocab), N)]
    a, b = ref.dict_encode(col, 4096), port.dict_encode(col, 4096)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.words.tobytes() == b.words.tobytes()
        assert a.dictionary.tobytes() == b.dictionary.tobytes()
        assert (a.width, a.encoding) == (b.width, b.encoding)
    # block frame-of-reference of a sorted-ish int32 column
    ints = np.sort(rng.integers(0, 1 << width, N)).astype(np.int32)
    da, db = ref.delta_for_encode(ints, 16), port.delta_for_encode(ints, 16)
    assert (da is None) == (db is None)
    if da is not None:
        assert da.words.tobytes() == db.words.tobytes()
        assert da.base.tobytes() == db.base.tobytes()
        assert da.width == db.width


def test_host_batch_prep_identical():
    rng = np.random.default_rng(5)
    n = 5000
    g = rng.integers(0, 9, n).astype(np.int32)
    ts = rng.integers(0, 10_000_000, n).astype(np.int64)
    b_ref, nb_ref = ref.time_buckets(ts, 0, 60_000)
    b_port, nb_port = port.time_buckets(ts, 0, 60_000)
    assert nb_ref == nb_port
    assert_bit_equal(b_port, b_ref)
    vals = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    mask = rng.random(n) < 0.5
    pa = ref.build_padded_batch(g, b_ref, mask, vals)
    pb = port.build_padded_batch(g, b_port, mask, vals)
    assert pa.n_valid == pb.n_valid
    for name in ("group_codes", "bucket_ids", "mask", "values"):
        assert getattr(pa, name).tobytes() == getattr(pb, name).tobytes(), name
    assert ref.shape_bucket(n) == port.shape_bucket(n)


def _layout_case(kind: str, width: int, rng):
    """(parts as numpy, layout) for one resident column of N rows."""
    if kind == "delta":
        arr = (np.repeat(np.arange(N // 128), 128) * 1000).astype(np.int32)
        arr += rng.integers(0, 1 << width, N).astype(np.int32)
        enc = ref.delta_for_encode(arr, 16)
        assert enc is not None and enc.width <= width
        return (enc.words, enc.base), ("delta", enc.width)
    if kind == "tsdict":
        vocab = np.sort(rng.choice(1 << 20, 1 << min(width, 12), replace=False)).astype(np.int32)
        arr = vocab[rng.integers(0, len(vocab), N)]
        enc = ref.dict_encode(arr, 1 << 16)
        return (enc.words, enc.dictionary), ("dict", enc.width)
    vocab = np.unique(rng.normal(0, 100, 1 << min(width, 12)).astype(np.float32))
    arr = vocab[rng.integers(0, len(vocab), N)]
    enc = ref.dict_encode(arr, 1 << 16)
    full = kind == "dict"
    return (enc.words, enc.dictionary), ("dict", enc.width, full)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ["delta", "tsdict", "dict", "codes"])
@pytest.mark.parametrize("gather", [False, True])
def test_decode_matches_reference(kind, width, gather):
    rng = np.random.default_rng(width * 7 + len(kind))
    parts, layout = _layout_case(kind, width, rng)
    idx = rng.integers(0, N, 777).astype(np.int32) if gather else None
    jparts = tuple(jnp.asarray(p) for p in parts)
    tparts = tuple(_tensor(p, "cpu") for p in parts)
    jidx = None if idx is None else jnp.asarray(idx)
    tidx = None if idx is None else torch.from_numpy(idx)
    if kind == "delta":
        want = ref.decode_series(jparts, layout, N, jidx)
        got = port.decode_series(tparts, layout, N, tidx)
        want_ts = ref.decode_ts(jparts, layout, N, jidx)
        got_ts = port.decode_ts(tparts, layout, N, tidx)
        assert_bit_equal(got_ts.numpy(), np.asarray(want_ts), "decode_ts delta")
    elif kind == "tsdict":
        want = ref.decode_ts(jparts, layout, N, jidx)
        got = port.decode_ts(tparts, layout, N, tidx)
    else:
        want = ref.decode_value(jparts, layout, N, jidx)
        got = port.decode_value(tparts, layout, N, tidx)
    assert_bit_equal(got.numpy(), np.asarray(want), f"{kind} w={width}")


@pytest.mark.parametrize("gather", [False, True])
def test_decode_layouts_mixed_tuple(gather):
    """decode_layouts over one mixed layout tuple: delta series, dict ts,
    and raw, bf16, dict and dict-codes value fields."""
    rng = np.random.default_rng(11)
    s_parts, s_lay = _layout_case("delta", 7, rng)
    t_parts, t_lay = _layout_case("tsdict", 8, rng)
    raw = rng.normal(size=N).astype(np.float32)
    bf = np.asarray(jnp.asarray(rng.normal(size=N).astype(np.float32)).astype(jnp.bfloat16))
    d_parts, d_lay = _layout_case("dict", 13, rng)
    c_parts, c_lay = _layout_case("codes", 1, rng)
    values = ((raw,), (bf,), d_parts, c_parts)
    layouts = (("raw",), ("bf16",), d_lay, c_lay)
    idx = rng.integers(0, N, 500).astype(np.int32) if gather else None

    def j(p):
        return tuple(jnp.asarray(x) for x in p)

    def t(p):
        return tuple(_tensor(x, "cpu") for x in p)

    want = ref.decode_layouts(
        j(s_parts), j(t_parts), tuple(j(v) for v in values), s_lay, t_lay, layouts,
        idx=None if idx is None else jnp.asarray(idx),
    )
    got = port.decode_layouts(
        t(s_parts), t(t_parts), tuple(t(v) for v in values), s_lay, t_lay, layouts,
        idx=None if idx is None else torch.from_numpy(idx),
    )
    assert_bit_equal(got[0].numpy(), np.asarray(want[0]), "series")
    assert_bit_equal(got[1].numpy(), np.asarray(want[1]), "ts")
    for f, (g, w) in enumerate(zip(got[2], want[2])):
        assert_bit_equal(g.numpy(), np.asarray(w), f"value {f}")
