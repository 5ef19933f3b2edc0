"""The port's merge-dedup sort against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``horaedb_tpu.ops.merge_dedup_permutation`` (JAX on the CPU) and
``horaedb_tpu_torch.ops.merge_dedup_permutation(..., device="cpu")`` (the
plain PyTorch versions of the kernel). ``perm`` and ``keep`` must be
BIT-equal, for every kind: ``rk`` (ranked, unique keys), ``f32`` (narrow
spans), ``f64`` (33..64 span bits) and ``gen`` (wider). The plain-call
counters show which kind ran.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from horaedb_tpu.ops import merge_dedup as ref_md
from horaedb_tpu.ops.merge_dedup import merge_dedup_permutation as ref_permutation
from horaedb_tpu_torch.ops import merge_dedup as md
from horaedb_tpu_torch.ops import merge_dedup_permutation

from torch_parity import assert_bit_equal

_U32 = 0xFFFFFFFF


def _both(tsid, ts, seq, **kw):
    """Both packages on the same arrays; returns the port's (perm, keep)
    and the kind that served it."""
    want = ref_permutation(tsid, ts, seq, **kw)
    before = dict(md.PLAIN_CALLS)
    got = merge_dedup_permutation(tsid, ts, seq, **kw, device="cpu")
    ran = [k for k in md.KINDS if md.PLAIN_CALLS[k] != before[k]]
    assert_bit_equal(got[0], want[0], "perm")
    assert_bit_equal(got[1], want[1], "keep")
    return got, ran


def _runs(rng, n_runs, per, n_series, ts_space, ts_step=1):
    """Deduped sorted runs with distinct per-file sequences, as compaction
    gets them: (tsid, ts, seq, tsid_rank, n_ranks)."""
    pool = np.unique(rng.integers(0, 2**64, 4 * n_series, dtype=np.uint64))
    pool = np.sort(rng.choice(pool, n_series, replace=False))
    cols = []
    for r in range(n_runs):
        keys = np.sort(rng.choice(n_series * ts_space, per, replace=False))
        cols.append((pool[keys // ts_space], (keys % ts_space) * ts_step,
                     np.full(per, r + 1, dtype=np.uint64)))
    tsid, ts, seq = (np.concatenate(c) for c in zip(*cols))
    uniq, rank = np.unique(tsid, return_inverse=True)
    return tsid, ts.astype(np.int64), seq, rank.astype(np.uint64), len(uniq)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("n_runs,per", [(8, 800), (3, 1500), (1, 37)])
def test_ranked_kind(dedup, n_runs, per):
    rng = np.random.default_rng(n_runs * 7 + per)
    tsid, ts, seq, rank, n_ranks = _runs(rng, n_runs, per, 7, 600, ts_step=13)
    (perm, keep), ran = _both(tsid, ts, seq, dedup=dedup, tsid_rank=rank,
                              n_ranks=n_ranks, unique=True)
    assert ran == ["rk"]
    if dedup:  # the newest run's version of each key survives
        sel = perm[keep]
        order = np.lexsort((-seq.astype(np.int64), ts, tsid))
        key = np.stack([tsid[order].astype(np.int64), ts[order]])
        first = np.ones(len(order), dtype=bool)
        first[1:] = (key[:, 1:] != key[:, :-1]).any(axis=0)
        np.testing.assert_array_equal(sel, order[first])
    else:
        assert keep.all()


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize(
    "kind,ts_scale,seq_scale",
    [("f32", 1, 1), ("f64", 2**20, 1), ("f64", 1, 2**35), ("gen", 2**52, 1),
     ("gen", 1, 2**61)],
)
def test_kind_by_span(dedup, kind, ts_scale, seq_scale):
    rng = np.random.default_rng(len(kind) + ts_scale % 97 + seq_scale % 89)
    n = 6000
    tsid = rng.integers(0, 40, n).astype(np.uint64) * np.uint64(2**58 + 3)
    ts = rng.integers(-2000, 2000, n).astype(np.int64) * ts_scale
    seq = rng.integers(0, 9, n).astype(np.uint64) * np.uint64(seq_scale)
    _, ran = _both(tsid, ts, seq, dedup=dedup)
    assert ran == [kind]


@pytest.mark.parametrize("kind", ["f32", "f64", "gen"])
def test_exact_duplicates_newest_input_wins(kind):
    """Rows equal on (tsid, ts, seq) — duplicates of ONE write batch —
    resolve to the LAST input row."""
    ts_scale = {"f32": 1, "f64": 2**31, "gen": 2**62}[kind]
    rng = np.random.default_rng(11)
    n = 5000
    tsid = rng.integers(0, 3, n).astype(np.uint64)
    ts = rng.integers(-1, 2, n).astype(np.int64) * ts_scale
    seq = rng.integers(7, 9, n).astype(np.uint64)
    (perm, keep), ran = _both(tsid, ts, seq)
    assert ran == [kind]
    sel = perm[keep]
    assert len(sel) == len({(a, b) for a, b in zip(tsid.tolist(), ts.tolist())})
    for i in sel.tolist():  # the newest seq of the key, and of those the last row
        same = (tsid == tsid[i]) & (ts == ts[i])
        newest = same & (seq == seq[same].max())
        assert i == np.flatnonzero(newest).max()


def test_all_ones_real_key_beats_the_pads():
    """A real row whose three key words are all ones ties with every pad
    and still sorts (and survives) ahead of them."""
    tsid = np.array([5, 2**64 - 1, 9, 2**64 - 1], dtype=np.uint64)
    ts = np.array([3, 2**28 - 1, 0, 7], dtype=np.int64)
    seq = np.array([15, 0, 1, 4], dtype=np.uint64)
    (perm, keep), ran = _both(tsid, ts, seq)
    assert ran == ["f32"]
    rest = ((ts - ts.min()).astype(np.uint64) << np.uint64(4)) | (np.uint64(15) - seq)
    assert int(rest[1]) == _U32  # the row's rest word is all ones too
    assert perm.tolist() == [0, 2, 3, 1] and keep.all()


@pytest.mark.parametrize("kind", md.KINDS)
@pytest.mark.parametrize("dedup", [True, False])
def test_wrappers_match_reference_kernels_below_the_bucket(kind, dedup):
    """The wrapper of each kind on CPU tensors against the reference's jitted
    kernel on the same padded words, n_valid below the bucket, words with
    the top bit set (unsigned order). The stable kinds agree over the whole
    bucket; rk (unstable in the reference) over its real rows."""
    rng = np.random.default_rng(len(kind) * 3 + dedup)
    bucket, n_valid = 4096, 3001
    n_words = {"rk": 2, "f32": 3, "f64": 4, "gen": 7}[kind]
    words = rng.integers(0, 2**32, (n_words, bucket), dtype=np.uint64).astype(np.uint32)
    words[:, :n_valid] >>= rng.integers(0, 32, (n_words, 1)).astype(np.uint32)
    words[:, 1:n_valid:3] = words[:, 0:n_valid - 1:3]  # ties on the first key words
    masks = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(np.uint32)
    if kind == "rk":
        # unique real keys: the precondition of the reference's unstable sort
        words[1, :n_valid] = rng.choice(2**32, n_valid, replace=False)
        words[:, n_valid:] = _U32
        want = ref_md._ranked_kernel(*map(jnp.asarray, words), jnp.uint32(masks[0]),
                                     jnp.uint32(masks[1]), jnp.int32(n_valid), dedup=dedup)
    elif kind == "f32":
        words[:, n_valid:] = _U32
        want = ref_md._fused32_kernel(*map(jnp.asarray, words), jnp.uint32(masks[2]),
                                      jnp.int32(n_valid), dedup=dedup)
    elif kind == "f64":
        words[:, n_valid:] = _U32
        want = ref_md._fused64_kernel(*map(jnp.asarray, words), jnp.uint32(masks[2]),
                                      jnp.uint32(masks[3]), jnp.int32(n_valid), dedup=dedup)
    else:
        words[0] = np.arange(bucket) >= n_valid
        words[1:, n_valid:] = 0
        want = ref_md._general_kernel(*map(jnp.asarray, words), dedup=dedup)
    t = [torch.from_numpy(w.view(np.int32)) for w in words]
    # the masks the reference's kernel of each kind applies
    if kind == "gen":
        used = (0, _U32, _U32, _U32, _U32, 0, 0)
    else:
        used = tuple(masks[:2]) if kind == "rk" else (_U32, _U32, *masks[2:])
    got = md.unpack(md.sort_dedup(kind, t, [int(m) for m in used], n_valid, dedup), bucket)
    cut = n_valid if kind == "rk" else bucket
    assert_bit_equal(got[0].numpy()[:cut], np.asarray(want[0])[:cut], "perm")
    assert_bit_equal(got[1].numpy()[:cut], np.asarray(want[1])[:cut], "keep")
    assert not got[1].numpy()[n_valid:].any()


def _case_merges_sorted_runs(perm_fn):
    tsid = np.array([1, 1, 2, 1, 2, 3], dtype=np.uint64)
    ts = np.array([10, 20, 10, 10, 10, 5], dtype=np.int64)
    seq = np.array([1, 1, 1, 2, 2, 2], dtype=np.uint64)
    perm, keep = perm_fn(tsid, ts, seq)
    merged_idx = perm[keep]
    out = list(zip(tsid[merged_idx].tolist(), ts[merged_idx].tolist(), seq[merged_idx].tolist()))
    assert out == [(1, 10, 2), (1, 20, 1), (2, 10, 2), (3, 5, 2)]


def _case_no_dedup_keeps_all(perm_fn):
    tsid = np.array([1, 1], dtype=np.uint64)
    ts = np.array([10, 10], dtype=np.int64)
    seq = np.array([1, 2], dtype=np.uint64)
    perm, keep = perm_fn(tsid, ts, seq, dedup=False)
    assert keep.sum() == 2
    assert seq[perm[0]] == 2  # newest still sorts first


def _case_matches_numpy_lexsort(perm_fn):
    rng = np.random.default_rng(7)
    n = 10_000
    tsid = rng.integers(0, 50, n).astype(np.uint64)
    ts = rng.integers(-1000, 1000, n).astype(np.int64)
    seq = rng.permutation(n).astype(np.uint64)
    perm, keep = perm_fn(tsid, ts, seq)
    order = np.lexsort((-(seq.astype(np.int64)), ts, tsid.astype(np.int64)))
    key = np.stack([tsid[order].astype(np.int64), ts[order]])
    first = np.ones(n, dtype=bool)
    first[1:] = (key[:, 1:] != key[:, :-1]).any(axis=0)
    np.testing.assert_array_equal(perm[keep], order[first])


def _case_empty(perm_fn):
    perm, keep = perm_fn(
        np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64)
    )
    assert len(perm) == 0 and len(keep) == 0


def _case_extreme_values(perm_fn):
    tsid = np.array([0, 2**64 - 1, 2**63], dtype=np.uint64)
    ts = np.array([-(2**62), 2**62, 0], dtype=np.int64)
    seq = np.array([1, 2, 3], dtype=np.uint64)
    perm, keep = perm_fn(tsid, ts, seq)
    assert keep.sum() == 3
    assert tsid[perm].tolist() == [0, 2**63, 2**64 - 1]


@pytest.mark.parametrize("case", [
    _case_merges_sorted_runs, _case_no_dedup_keeps_all, _case_matches_numpy_lexsort,
    _case_empty, _case_extreme_values,
], ids=lambda c: c.__name__[6:])
def test_reference_merge_dedup_cases(case):
    """tests/test_ops.py::TestMergeDedup, on the port, and bit-equal to
    the JAX package on the same inputs."""
    calls = sum(md.PLAIN_CALLS.values())
    case(lambda *a, **k: _both(*a, **k)[0])
    # the empty input runs no sort, every other case runs one
    assert sum(md.PLAIN_CALLS.values()) - calls == (case is not _case_empty)


def test_device_is_required():
    with pytest.raises(TypeError):
        merge_dedup_permutation(np.zeros(3, np.uint64), np.zeros(3, np.int64),
                                np.zeros(3, np.uint64))


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(1, 6000),
    n_tsid=st.integers(1, 60),
    ts_bits=st.integers(0, 62),
    seq_bits=st.integers(0, 63),
    dedup=st.booleans(),
    seed=st.integers(0, 2**16),
)
def test_random_sizes_and_spans(n, n_tsid, ts_bits, seq_bits, dedup, seed):
    rng = np.random.default_rng(seed)
    tsid = rng.choice(rng.integers(0, 2**64, n_tsid, dtype=np.uint64), n)
    ts = rng.integers(-(2**ts_bits), 2**ts_bits, n, dtype=np.int64) if ts_bits else np.zeros(
        n, np.int64)
    seq = rng.integers(0, 2**seq_bits, n, dtype=np.uint64) if seq_bits else np.zeros(
        n, np.uint64)
    _both(tsid, ts, seq, dedup=dedup)


_WORDS = {"rk": 2, "f32": 3, "f64": 4, "gen": 7}


def _kind_case(kind, n, rng):
    """Key word columns of ``kind`` for ``n`` real rows (no pads), with ties
    on the first words and the top bit set; rk's composites are unique (the
    reference's sort of that kind is unstable). Returns (cols, masks)."""
    words = rng.integers(0, 2**32, (_WORDS[kind], n), dtype=np.uint64).astype(np.uint32)
    words >>= rng.integers(0, 32, (_WORDS[kind], 1)).astype(np.uint32)
    words[:, 1::3] = words[:, 0:n - 1:3]
    words[:, 2::5] |= np.uint32(1 << 31)
    if kind == "rk":
        words[1] = rng.choice(2**32, n, replace=False)
    if kind == "gen":
        words[0] = 0
        masks = (0, _U32, _U32, _U32, _U32, 0, 0)
    else:
        masks = tuple(int(m) for m in rng.integers(0, 2**32, _WORDS[kind], dtype=np.uint64))
        if kind != "rk":
            masks = (_U32, _U32, *masks[2:])
    return list(words), masks


def _reference_kernel(kind, words, masks, dedup):
    """The reference's jitted kernel of ``kind`` on the same words, every
    row real."""
    w = [jnp.asarray(x) for x in words]
    n = len(words[0])
    if kind == "rk":
        return ref_md._ranked_kernel(*w, jnp.uint32(masks[0]), jnp.uint32(masks[1]),
                                     jnp.int32(n), dedup=dedup)
    if kind == "f32":
        return ref_md._fused32_kernel(*w, jnp.uint32(masks[2]), jnp.int32(n), dedup=dedup)
    if kind == "f64":
        return ref_md._fused64_kernel(*w, jnp.uint32(masks[2]), jnp.uint32(masks[3]),
                                      jnp.int32(n), dedup=dedup)
    return ref_md._general_kernel(*w, dedup=dedup)


@pytest.mark.parametrize("kind", md.KINDS)
@pytest.mark.parametrize("n", [1, 3001, 5121])
@pytest.mark.parametrize("dedup", [True, False])
def test_dispatch_stages_exactly_n_rows_and_matches_reference(kind, n, dedup, monkeypatch):
    """The dispatcher stages the key words of exactly n rows (no bucket of
    pads), and its perm and keep over n rows, not a power of two, equal the
    reference's jitted kernel of the kind on the same rows."""
    rng = np.random.default_rng(n + _WORDS[kind] + dedup)
    cols, masks = _kind_case(kind, n, rng)
    staged, orig = [], md.sort_dedup

    def spy(k, words, m, n_valid, d):
        staged.append((k, [w.shape for w in words], n_valid))
        return orig(k, words, m, n_valid, d)

    monkeypatch.setattr(md, "sort_dedup", spy)
    perm, keep = md._dispatch(kind, cols, masks, n, dedup, "cpu").get()
    assert staged == [(kind, [(n,)] * _WORDS[kind], n)]
    assert perm.shape == (n,) and keep.shape == (n,)
    want = _reference_kernel(kind, cols, masks, dedup)
    assert_bit_equal(perm, np.asarray(want[0]), "perm")
    assert_bit_equal(keep, np.asarray(want[1]), "keep")


@pytest.mark.parametrize("n", [1, 7, 4096])
def test_stage_holds_exactly_n_rows(n):
    cols = [np.arange(n, dtype=np.uint32) * np.uint32(w + 1) | np.uint32(1 << 31)
            for w in range(3)]
    host = md.stage(cols, n, pinned=False)
    assert host.shape == (3, n) and host.dtype == torch.int32
    np.testing.assert_array_equal(host.numpy().view(np.uint32), np.stack(cols))


def test_merge_handle_reads_n_rows_from_an_n_row_buffer():
    """get() splits a buffer of 5n + MAX_PASSES bytes into n-row perm and
    keep, with no bucket worked out from its length."""
    n = 5
    perm = np.array([4, 0, 3, 1, 2], np.int32)
    keep = np.array([1, 0, 1, 1, 0], np.bool_)
    buf = np.concatenate([perm.view(np.uint8), keep.view(np.uint8),
                          np.ones(md.MAX_PASSES, np.uint8)])
    got = md.MergeHandle(torch.from_numpy(buf), n, "f32").get()
    np.testing.assert_array_equal(got[0], perm)
    np.testing.assert_array_equal(got[1], keep)
    empty = md.MergeHandle(torch.zeros(md.MAX_PASSES, dtype=torch.uint8), 0).get()
    assert len(empty[0]) == 0 and len(empty[1]) == 0


@pytest.mark.parametrize("kind", md.KINDS)
@pytest.mark.parametrize("n,n_valid", [(1, 1), (5120, 5120), (5121, 17), (1 << 20, 1000003)])
def test_scratch_layout_follows_the_kinds_key_widths(kind, n, n_valid):
    """The wrapper's pass count and scratch sizes against the kind's key
    words: a pass per digit, two ping-pong copies of the words and the
    index, the zeroed region (digit counts, tile counters, the mask of the
    passes that run, a 64-bit look-back word a tile and digit) in one piece,
    256-byte aligned parts."""
    words = _WORDS[kind]
    assert md.passes_of(kind) == words * md.DIGITS_PER_WORD == words * 32 // md.DIGIT_BITS
    assert md.passes_of(kind) <= md.MAX_PASSES
    n_sort = md.sort_rows(kind, n, n_valid)
    assert n_sort == (n if kind == "gen" else n_valid)
    layout = md.scratch_layout(kind, n_sort)
    names = [name for name, _ in layout]
    assert names == [f"buf{s}.{i}" for s in range(2) for i in range(words + 1)] + [
        "ghist", "tile_ctr", "status", "bases"]
    size = dict(layout)
    assert all(s % 64 == 0 for s in size.values())  # int32 elements: 256 bytes
    assert all(size[f"buf{s}.{i}"] >= n_sort for s in range(2) for i in range(words + 1))
    assert size["ghist"] >= md.MAX_PASSES * md.RADIX <= size["bases"]
    assert size["tile_ctr"] >= md.MAX_PASSES + 1
    n_tiles = -(-n_sort // md.TILE)
    assert 2 * md.RADIX * n_tiles <= size["status"] < 2 * md.RADIX * n_tiles + 64


def test_python_constants_mirror_the_kernel_source():
    """The wrapper's copies of the kernel's constants (the card checks them
    through merge_dedup_abi at load) agree with ops/csrc/merge_dedup.cu."""
    import re

    src = open(os.path.join(os.path.dirname(md.__file__), "csrc", "merge_dedup.cu")).read()
    define = {k: v for k, v in re.findall(r"^#define (\w+) (\d+)\b", src, re.M)}
    assert int(define["MAX_WORDS"]) == md.MAX_WORDS
    assert int(define["DIGIT_BITS"]) == md.DIGIT_BITS
    assert int(define["BLOCK"]) * int(define["ITEMS"]) == md.TILE
    assert int(define["DROP_AFTER"]) == md.DROP_AFTER
    assert int(define["FIXED_LAUNCHES"]) == md.FIXED_LAUNCHES
    assert md.RADIX == int(define["BLOCK"])  # a thread of a pass owns one digit
    for kind in md.KINDS:
        assert md.launches_of(kind) == md.passes_of(kind) + md.FIXED_LAUNCHES
